"""Plain PyTorch versions of the streaming filter's arithmetic.

Counterpart of ``src/repro/kernels/ref.py``: the byte classifier of the
character pre-decoder, the per-event step of the bit-packed streaming
filter and the sparse epilogue, written with tensor ops only.  They are
the CPU path of the kernel wrappers in :mod:`.stream_filter` and
:mod:`.predecode` and the yardstick the CUDA kernels are held against on
the card; they are not fast.

Packed state words are ``torch.int32`` bit views of ``uint32`` words:
shifts are arithmetic on int32, so every extracted bit is masked with
``& 1``, and sums of shifted bits are taken in int64 and wrapped back.
"""
from __future__ import annotations

import torch

# event kinds (match repro_torch.core.events)
OPEN, CLOSE, PAD = 0, 1, 2
NO_MATCH = 2 ** 31 - 1

#: fused event word: kind in the high half, tag (uint16 view) in the low
KIND_SHIFT = 16
TAG_MASK = 0xFFFF

# byte constants
_LT, _SLASH = 60, 47


def symbol_value(b: torch.Tensor) -> torch.Tensor:
    """Byte → 64-symbol alphabet value (a-zA-Z0-9_.), -1 otherwise."""
    b = b.to(torch.int32)
    v = torch.full_like(b, -1)
    v = torch.where((b >= 97) & (b <= 122), b - 97, v)        # a-z → 0..25
    v = torch.where((b >= 65) & (b <= 90), b - 65 + 26, v)    # A-Z → 26..51
    v = torch.where((b >= 48) & (b <= 57), b - 48 + 52, v)    # 0-9 → 52..61
    v = torch.where(b == 95, torch.full_like(b, 62), v)       # '_'
    v = torch.where(b == 46, torch.full_like(b, 63), v)       # '.'
    return v


def predecode(bytes_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) uint8 → per-position (kind, tag_id) int32; PAD off tags.

    Every position is classified from its byte and the three after it;
    each row shifts on its own and reads zeros past its end, so rows never
    bleed into each other.
    """
    b = bytes_.to(torch.int32)
    n = b.shape[-1]

    def shift(k):
        out = torch.zeros_like(b)
        if k < n:
            out[..., :n - k] = b[..., k:]
        return out

    b1, b2, b3 = shift(1), shift(2), shift(3)
    is_lt = b == _LT
    is_close = is_lt & (b1 == _SLASH)
    is_open = is_lt & ~is_close
    v0 = symbol_value(torch.where(is_close, b2, b1))
    v1 = symbol_value(torch.where(is_close, b3, b2))
    ok = (v0 >= 0) & (v1 >= 0)
    kind = torch.where(is_open & ok, OPEN,
                       torch.where(is_close & ok, CLOSE, PAD)).to(torch.int32)
    tag = torch.where(kind != PAD, v0 * 64 + v1, -1).to(torch.int32)
    return kind, tag


def fuse_events(kind: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """kind/tag → one int32 event word ``(kind << 16) | (tag & 0xffff)``."""
    return ((kind.to(torch.int32) << KIND_SHIFT)
            | (tag.to(torch.int32) & TAG_MASK))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit word → its int32 bit view."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def advance(stack: torch.Tensor, depth: torch.Tensor, matched: torch.Tensor,
            first: torch.Tensor, ev: torch.Tensor, ordinal: torch.Tensor,
            tagmask: torch.Tensor, pw: torch.Tensor, pb: torch.Tensor,
            selfloop: torch.Tensor, acc_word: torch.Tensor,
            acc_bit: torch.Tensor, *, max_depth: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused event word per row through every state block.

    The per-event transition of the streaming filter, vectorised over X
    rows (documents or segments) and G blocks.  ``stack`` (X, G,
    max_depth+2, WB) int32 is updated in place; ``depth`` (X,) int64,
    ``matched`` (X, G, QB) bool, ``first`` (X, G, QB) int32, ``ev`` (X,)
    int32 fused words, ``ordinal`` (X,) int32 first-match index of this
    event.  Tables as in :func:`repro_torch.kernels.stream_filter.
    stream_filter`.  Returns the new ``(depth, matched, first)``.
    """
    x, g, _, wb = stack.shape
    n_tags = tagmask.shape[1] - 1
    rows = torch.arange(x, device=stack.device)
    k = ev >> KIND_SHIFT
    t = ev & TAG_MASK
    is_open = k == OPEN
    is_close = k == CLOSE
    row = stack[rows, :, depth]                                 # (X, G, WB)
    tclip = torch.where((t >= 0) & (t < n_tags), t, n_tags).long()
    trow = tagmask[:, tclip].permute(1, 0, 2)                   # (X, G, WB)
    par = torch.gather(row, 2, pw.reshape(1, g, wb * 32).expand(x, -1, -1)
                       .long()).reshape(x, g, wb, 32)
    bits = ((par >> pb) & 1).long()
    lane = torch.arange(32, device=stack.device)
    src = _wrap_i32((bits << lane).sum(-1))
    nxt = (src & trow) | (selfloop & row)
    widx = torch.clamp(depth + 1, max=max_depth + 1)
    old = stack[rows, :, widx]
    stack[rows, :, widx] = torch.where(is_open[:, None, None], nxt, old)
    step = torch.where(is_open, 1, torch.where(is_close, -1, 0))
    depth = torch.clamp(depth + step, 0, max_depth + 1)
    acc = torch.gather(nxt, 2, acc_word.unsqueeze(0).expand(x, -1, -1).long())
    active = is_open[:, None, None] & (((acc >> acc_bit) & 1) != 0)
    first = torch.where(active & ~matched, ordinal[:, None, None], first)
    return depth, matched | active, first


def stream_filter_words(events: torch.Tensor, tagmask: torch.Tensor,
                        pw: torch.Tensor, pb: torch.Tensor,
                        selfloop_words: torch.Tensor,
                        init_words: torch.Tensor, acc_word: torch.Tensor,
                        acc_bit: torch.Tensor, max_depth: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One word-block of the bit-packed streaming filter over one document.

    events (N,) int32 fused words; tagmask (T+1, WB), pw/pb (WB, 32),
    selfloop/init (WB,), acc_word/acc_bit (QB,), all int32.  Returns
    ``(matched (QB,) bool, first (QB,) int32)``.
    """
    wb = selfloop_words.shape[0]
    qb = acc_word.shape[0]
    dev = events.device
    stack = torch.zeros((1, 1, max_depth + 2, wb), dtype=torch.int32,
                        device=dev)
    stack[0, 0, 0] = init_words
    depth = torch.zeros(1, dtype=torch.long, device=dev)
    matched = torch.zeros((1, 1, qb), dtype=torch.bool, device=dev)
    first = torch.full((1, 1, qb), NO_MATCH, dtype=torch.int32, device=dev)
    for i in range(events.shape[0]):
        depth, matched, first = advance(
            stack, depth, matched, first, events[i:i + 1],
            torch.full((1,), i, dtype=torch.int32, device=dev),
            tagmask[None], pw[None], pb[None], selfloop_words[None],
            acc_word[None], acc_bit[None], max_depth=max_depth)
    return matched[0, 0], first[0, 0]


def compact_rows(hits: torch.Tensor, columns, fills, cap: int):
    """The first ``cap`` hits of a flat mask, in order, as row columns.

    Each hit's rank is an inclusive cumsum of ``hits`` minus one, and it
    is scattered to that slot of one ``(cap,)`` int32 buffer per entry of
    ``columns`` (flat tensors aligned with ``hits``; slots past the hits
    keep ``fills``); ranks past ``cap`` drop.  Returns the buffers and
    the true hit count as an int32 scalar tensor.
    """
    rank = torch.cumsum(hits.to(torch.int64), 0) - 1
    dest = torch.where(hits & (rank < cap), rank, cap)    # cap: dropped
    bufs = [torch.full((cap + 1,), fill, dtype=torch.int32,
                       device=hits.device)
            .scatter_(0, dest, col.reshape(-1).to(torch.int32))[:cap]
            for col, fill in zip(columns, fills)]
    return bufs, hits.sum(dtype=torch.int32)


def sparse_epilogue(matched: torch.Tensor, first: torch.Tensor,
                    lane_cls: torch.Tensor, doc_ids: torch.Tensor, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense accept lanes → the bounded ``(doc, class, first)`` buffer.

    The plain version of the fused sparse epilogue (JAX
    ``ref.sparse_epilogue``).  ``matched``/``first`` are dense kernel
    outputs, ``(B, G, QB)`` (event launch, ``doc_ids`` ``(B, 1)``) or
    ``(S, G, D, QB)`` (bytes launch, ``doc_ids`` ``(S, D)``);
    ``lane_cls`` ``(G, QB)`` names each lane's accept class (``-1`` =
    inert).  Hits are taken in the order of the TPU's sequential ``"bg"``
    grid — (row, block, slot, lane), the row-major order of the dense
    outputs — and appended while the running count is below ``cap``, so
    the rows equal the Pallas kernel's bit for bit even past overflow.
    Rows of slots with ``doc_id < 0`` are dropped.  Returns ``buf`` (cap,
    3) int32 with ``(-1, -1, NO_MATCH)`` past the rows, and ``count``
    (1,) int32, the true number of hits (``count > cap`` is overflow).
    """
    if matched.dim() == 3:                      # event launch: one slot
        matched, first = matched[:, :, None], first[:, :, None]
    s, g, d, qb = matched.shape
    doc = doc_ids.reshape(s, 1, d, 1).expand(s, g, d, qb)
    cls = lane_cls.reshape(1, g, 1, qb).expand(s, g, d, qb)
    hits = ((matched != 0) & (cls >= 0) & (doc >= 0)).reshape(-1)
    cols, count = compact_rows(hits, (doc, cls, first), (-1, -1, NO_MATCH),
                               cap)
    return torch.stack(cols, 1), count.reshape(1)
