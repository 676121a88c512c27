"""The streaming filter's megakernels: wrappers, plain versions, counts.

Counterpart of ``src/repro/kernels/stream_filter.py``:

* :func:`stream_filter` (K1) — fused event words ``(B, N)`` → accept
  lanes ``(B, G, QB)``; replaces ``stream_filter_pallas``.
* :func:`stream_filter_bytes` (K2) — raw byte segments ``(S, L)`` with
  document starts ``(S, D+1)`` → accept lanes ``(S, G, D, QB)`` in one
  launch (decode, compaction, filter, per-document resets); replaces
  ``stream_filter_bytes_pallas``.
* :func:`stream_filter_sparse` (K4) and :func:`stream_filter_bytes_sparse`
  (K3) — the same streams ending in the sparse epilogue: a bounded
  ``(cap, 3)`` buffer of ``(doc, accept class, first)`` rows and the true
  row count, with no dense lanes anywhere; replace
  ``stream_filter_pallas_sparse`` and ``stream_filter_bytes_pallas_sparse``.

Each wrapper takes its device from its inputs.  On CUDA tensors it
launches the hand-written kernel (``csrc/stream_filter.cu``, built and
loaded by :mod:`.build`) and adds one to its ``launches`` count; on CPU
tensors it runs the plain version beside it (:func:`stream_filter_plain`,
:func:`stream_filter_bytes_plain`, a Python loop over events vectorised
over (document or segment, block, word); the sparse ones are those
followed by :func:`ref.sparse_epilogue`).  There is no fallback from one
to the other.

K2 over long one-document segments runs each (segment, state block) chain
as P pieces in time, so that a launch of few documents fills the card:
:func:`pieces_for` picks P from the launch's shape and the card's
resident thread blocks, and the launch plans the pieces on the device.

Block tables are the bit-packed per-block layout of
:func:`repro_torch.kernels.blocks.state_layout`, as int32 bit views:
tagmask (G, T+1, WB), pw/pb (G, WB, 32), selfloop/init (G, WB),
acc_word/acc_bit (G, QB).  ``max_depth`` is the plan's stack bound.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import tracing
from . import ref
from .launches import count_launch
from .ref import NO_MATCH, PAD, fuse_events  # noqa: F401

#: largest dynamic shared memory one thread block may use on Hopper
SMEM_LIMIT = 232_448
#: most packed words a block may have (a chain's lane owns up to 32)
MAX_WORDS = 1024
_INT32_MAX = 2 ** 31 - 1
#: most thread blocks along a launch grid's second axis
_GRID_Y = 65535
#: byte positions of one window of the byte kernels' event ring; a piece
#: of a segment starts on a window edge
WINDOW = 256
#: the shortest piece K2 cuts a segment into, in windows: a shorter one
#: would spend on its plan and its ancestors' replay what it saves
MIN_PIECE_WINDOWS = 32
#: the most waves of resident blocks K2's pieces may take: more waves
#: bring a launch's time at most a few % nearer its chains over the card's
#: blocks, and each wave adds its pieces' set-up
MAX_WAVES = 4


def _table_dims(tables, device) -> tuple[int, int, int, int]:
    """Check the block tables; returns (G, n_tags, WB, QB)."""
    tagmask, pw, pb, selfloop, init, acc_word, acc_bit = tables
    g, t1, wb = tagmask.shape
    qb = acc_word.shape[1]
    want = {"tagmask": (g, t1, wb), "pw": (g, wb, 32), "pb": (g, wb, 32),
            "selfloop": (g, wb), "init": (g, wb), "acc_word": (g, qb),
            "acc_bit": (g, qb)}
    for (name, shape), x in zip(want.items(), tables):
        _check(x, name, torch.int32, device)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    if t1 < 1 or wb < 1 or qb < 1:
        raise ValueError(f"empty block tables: T+1={t1}, WB={wb}, QB={qb}")
    if wb > MAX_WORDS:
        raise ValueError(f"WB={wb} words per block exceeds {MAX_WORDS}")
    return g, t1 - 1, wb, qb


def _check(x: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_block_tables(tables: dict[str, np.ndarray]) -> None:
    """Reject block tables whose indices would leave the block, or whose
    tag masks the kernels' gather entries cannot hold.

    The kernels index shared memory with ``pw``/``pb`` and
    ``acc_word``/``acc_bit``.  They also turn the tag masks into one gather
    entry per state a tag can switch on, at most 32 * WB a block: every
    state's bit must be set in all T+1 rows of its block (a wildcard) or in
    at most one, as every plan the system builds has it.  Plans are
    checked once, on the host, when they are built or carried over
    (:mod:`repro_torch.convert`).
    """
    wb = tables["kb_selfloop"].shape[-1]
    for name, hi in (("kb_pw", wb), ("kb_pb", 32), ("kb_acc_word", wb),
                     ("kb_acc_bit", 32)):
        x = np.asarray(tables[name])
        if x.size and (x.min() < 0 or x.max() >= hi):
            raise ValueError(f"{name} holds values outside [0, {hi})")
    tagmask = np.ascontiguousarray(tables["kb_tagmask"]).view(np.uint32)
    rows = tagmask.shape[1]
    for g, block in enumerate(tagmask):                  # (T+1, WB) words
        bits = np.unpackbits(block.view(np.uint8), axis=1,
                             bitorder="little")          # (T+1, WB*32)
        count = bits.sum(0, dtype=np.int64)
        bad = np.nonzero((count > 1) & (count < rows))[0]
        if bad.size:
            w, j = divmod(int(bad[0]), 32)
            raise ValueError(
                f"kb_tagmask block {g} word {w} bit {j} is set in "
                f"{int(count[bad[0]])} of its {rows} tag rows; the kernels "
                f"take a state in every row (a wildcard) or in at most one")


def _smem_check(lib, n_tags: int, wb: int, qb: int, max_depth: int,
                sparse: bool = False, bytes_: bool = False) -> None:
    need = int(lib.sf_smem_bytes(n_tags, wb, qb, max_depth, int(sparse),
                                 int(bytes_)))
    if need > SMEM_LIMIT:
        lanes = 4 if sparse else 3
        raise ValueError(
            f"block needs {need} B of shared memory, over the {SMEM_LIMIT} B "
            f"limit: gather entries 32*WB*4 + (T+2)*4 = "
            f"{32 * wb * 4 + (n_tags + 2) * 4}, stack (max_depth+2)*WB*4 = "
            f"{(max_depth + 2) * wb * 4}, accept lanes {lanes}*QB*4 = "
            f"{4 * lanes * qb}" + (" (with their accept classes)"
                                   if sparse else "")
            + (" and the event ring" if bytes_ else "")
            + f" (T={n_tags}, WB={wb}, QB={qb}, max_depth={max_depth})")


def _slots_check(lib, n_docs: int) -> None:
    most = int(lib.sf_max_slots())
    if n_docs > most:
        raise ValueError(f"{n_docs} document slots per segment exceed the "
                         f"kernel's {most}")


def _scratch(lib, g: int, n_tags: int, wb: int, device: torch.device,
             extra: int = 0) -> torch.Tensor:
    """The launch's scratch: its blocks' gather entries, then ``extra``
    words (K2's piece plan).  The kernels run on the stream they were
    launched on; freed when the call returns, the buffer is reused only by
    later work on that stream, after them."""
    return torch.empty(int(lib.sf_scratch_words(g, n_tags, wb)) + extra,
                       dtype=torch.int32, device=device)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ------------------------------------------------------------------ K1
def stream_filter(events: torch.Tensor, tagmask: torch.Tensor,
                  pw: torch.Tensor, pb: torch.Tensor, selfloop: torch.Tensor,
                  init: torch.Tensor, acc_word: torch.Tensor,
                  acc_bit: torch.Tensor, *, max_depth: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every (document × state block) over fused event words.

    events (B, N) int32 ``(kind << 16) | (tag & 0xffff)``.  Returns
    matched (B, G, QB) int32 0/1 and first (B, G, QB) int32, the
    document-row index of each lane's first accepting OPEN (``NO_MATCH``
    if none).
    """
    dev = events.device
    tables = (tagmask, pw, pb, selfloop, init, acc_word, acc_bit)
    g, n_tags, wb, qb = _table_dims(tables, dev)
    _check(events, "events", torch.int32, dev)
    if events.dim() != 2:
        raise ValueError(f"events must be (B, N), got {tuple(events.shape)}")
    if dev.type == "cpu":
        return stream_filter_plain(events, *tables, max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    from . import build

    lib = build.load("stream_filter")
    _smem_check(lib, n_tags, wb, qb, max_depth)
    b, n = events.shape
    if b > 65535:
        raise ValueError(f"batch of {b} documents exceeds the grid's 65535")
    matched = torch.empty((b, g, qb), dtype=torch.int32, device=dev)
    first = torch.empty((b, g, qb), dtype=torch.int32, device=dev)
    if b == 0 or g == 0:
        return matched, first
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_events(
            _ptr(events), b, n, *map(_ptr, tables), g, n_tags, wb, qb,
            int(max_depth), _ptr(matched), _ptr(first),
            _ptr(_scratch(lib, g, n_tags, wb, dev)), ctypes.c_void_p(stream))
    _raise_on(err, "stream_filter")
    count_launch(stream_filter)
    return matched, first


stream_filter.launches = 0


def stream_filter_plain(events: torch.Tensor, tagmask: torch.Tensor,
                        pw: torch.Tensor, pb: torch.Tensor,
                        selfloop: torch.Tensor, init: torch.Tensor,
                        acc_word: torch.Tensor, acc_bit: torch.Tensor, *,
                        max_depth: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_filter`: one :func:`ref.advance` per
    event column, vectorised over documents and blocks."""
    b, n = events.shape
    g, wb = selfloop.shape
    qb = acc_word.shape[1]
    dev = events.device
    stack = torch.zeros((b, g, max_depth + 2, wb), dtype=torch.int32,
                        device=dev)
    stack[:, :, 0] = init
    depth = torch.zeros(b, dtype=torch.long, device=dev)
    matched = torch.zeros((b, g, qb), dtype=torch.bool, device=dev)
    first = torch.full((b, g, qb), NO_MATCH, dtype=torch.int32, device=dev)
    for i in range(n):
        depth, matched, first = ref.advance(
            stack, depth, matched, first, events[:, i],
            torch.full((b,), i, dtype=torch.int32, device=dev),
            tagmask, pw, pb, selfloop, acc_word, acc_bit,
            max_depth=max_depth)
    return matched.to(torch.int32), first


# ------------------------------------------------------------------ K2
def stream_filter_bytes(data: torch.Tensor, starts: torch.Tensor,
                        tagmask: torch.Tensor, pw: torch.Tensor,
                        pb: torch.Tensor, selfloop: torch.Tensor,
                        init: torch.Tensor, acc_word: torch.Tensor,
                        acc_bit: torch.Tensor, *, max_depth: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch raw bytes → per-document accept lanes.

    data (S, L) uint8 segments; starts (S, D+1) int32 document start
    offsets per segment, ``INT32_MAX`` past the last real document (an
    unpacked batch is D = 1 with starts ``[[0, INT32_MAX]] * S``).  Every
    position is classified from its byte and the three after it in the
    segment row (zeros past L), so a tag that ends a document decodes
    with the next document's bytes, as on the TPU.  An event at byte
    ``pos >= starts[d+1]`` first flushes document d's lanes, re-roots the
    stack and restarts the event ordinal.  Returns matched/first (S, G,
    D, QB) int32; empty document slots hold 0 and ``NO_MATCH``.  On the
    card a launch of few long one-document segments runs each chain in
    pieces (:func:`pieces_for`), with the same result.  While a profiler
    runs, each launch adds its chains, G·S·P, to the open request's
    ``k2_chains`` counter.
    """
    dev = data.device
    tables = (tagmask, pw, pb, selfloop, init, acc_word, acc_bit)
    _table_dims(tables, dev)
    _check(data, "data", torch.uint8, dev)
    _check(starts, "starts", torch.int32, dev)
    if data.dim() != 2 or starts.dim() != 2 \
            or starts.shape[0] != data.shape[0] or starts.shape[1] < 2:
        raise ValueError(f"data (S, L) and starts (S, D+1) disagree: "
                         f"{tuple(data.shape)} vs {tuple(starts.shape)}")
    if dev.type == "cpu":
        return stream_filter_bytes_plain(data, starts, *tables,
                                         max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_bytes(data, starts, tables, max_depth=max_depth)


stream_filter_bytes.launches = 0


def _launch_bytes(data: torch.Tensor, starts: torch.Tensor, tables,
                  *, max_depth: int, pieces: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on checked card tensors, each segment's chain in ``pieces``
    pieces (by default :func:`pieces_for`'s; the tests name their own)."""
    from . import build

    dev = data.device
    g, n_tags, wb, qb = _table_dims(tables, dev)
    lib = build.load("stream_filter")
    _smem_check(lib, n_tags, wb, qb, max_depth, bytes_=True)
    s, length = data.shape
    d = starts.shape[1] - 1
    _slots_check(lib, d)
    if s > _GRID_Y:
        raise ValueError(f"{s} segments exceed the grid's {_GRID_Y}")
    matched = torch.empty((s, g, d, qb), dtype=torch.int32, device=dev)
    first = torch.empty((s, g, d, qb), dtype=torch.int32, device=dev)
    if s == 0 or g == 0:
        return matched, first
    if pieces is None:
        pieces = pieces_for(g, s, d, length, _resident_blocks(
            dev.index, n_tags, wb, qb, int(max_depth)))
    if pieces < 1 or (pieces > 1 and (d != 1 or length == 0
                                      or s * pieces > _GRID_Y)):
        raise ValueError(f"{pieces} pieces of {s} segments of {length} "
                         f"bytes and {d} document slots: pieces need one "
                         f"document a segment, bytes, and {_GRID_Y} rows")
    extra = 0 if pieces == 1 else int(
        lib.sf_piece_words(s, pieces, length, int(max_depth)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_bytes(
            _ptr(data), s, length, _ptr(starts), d, *map(_ptr, tables), g,
            n_tags, wb, qb, int(max_depth), _ptr(matched), _ptr(first),
            _ptr(_scratch(lib, g, n_tags, wb, dev, extra)), pieces,
            ctypes.c_void_p(stream))
    _raise_on(err, "stream_filter_bytes")
    count_launch(stream_filter_bytes)
    tracing.count("k2_chains", g * s * pieces)
    return matched, first


def pieces_for(n_blocks: int, n_segments: int, n_docs: int, length: int,
               resident: int) -> int:
    """Pieces in time of each (segment, block) chain of a dense byte launch
    (K2).  A launch of C = ``n_blocks * n_segments`` chains in P pieces
    runs in ceil(C·P / ``resident``) waves of the card's resident thread
    blocks, each a piece long, so it takes about ceil(C·P / resident) / P
    of the one-piece time: the P with the least of that, up to
    :data:`MAX_WAVES` waves, the fewest pieces on a tie.  1 when the
    segments are packed (``n_docs > 1``) or the chains already fill the
    card; never a piece shorter than :data:`MIN_PIECE_WINDOWS` windows of
    a ``length``-byte segment."""
    chains = n_blocks * n_segments
    if n_docs > 1 or chains <= 0 or chains >= resident:
        return 1
    most = min(MAX_WAVES * resident // chains,
               -(-length // WINDOW) // MIN_PIECE_WINDOWS,
               _GRID_Y // n_segments)
    best, best_waves = 1, 1
    for p in range(2, most + 1):
        waves = -(-chains * p // resident)
        if waves * best < best_waves * p:
            best, best_waves = p, waves
    return best


@functools.lru_cache(maxsize=64)
def _resident_blocks(device_index: int, n_tags: int, wb: int, qb: int,
                     max_depth: int) -> int:
    """K2's thread blocks that card ``device_index`` holds at once for a
    plan of this size (the occupancy API: blocks an SM times the SMs)."""
    from . import build

    lib = build.load("stream_filter")
    with torch.cuda.device(device_index):
        n = int(lib.sf_bytes_resident(n_tags, wb, qb, max_depth))
    if n < 0:
        raise RuntimeError("stream_filter_bytes: the residency query of "
                           f"device {device_index} failed")
    return n


def compact_events(data: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, L) bytes → per-row events in byte order: fused words (S, M),
    byte positions (S, M) and counts (S,); the tail past each count is
    PAD words at position -1."""
    kind, tag = ref.predecode(data)
    keep = kind != PAD
    counts = keep.sum(1)
    m = int(counts.max()) if counts.numel() else 0
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :m]
    valid = torch.arange(m, device=data.device)[None, :] < counts[:, None]
    words = torch.where(valid, fuse_events(kind, tag).gather(1, order),
                        (PAD << ref.KIND_SHIFT) | ref.TAG_MASK)
    pos = torch.where(valid, order.to(torch.int32), -1)
    return words, pos, counts


def stream_filter_bytes_plain(data: torch.Tensor, starts: torch.Tensor,
                              tagmask: torch.Tensor, pw: torch.Tensor,
                              pb: torch.Tensor, selfloop: torch.Tensor,
                              init: torch.Tensor, acc_word: torch.Tensor,
                              acc_bit: torch.Tensor, *, max_depth: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_filter_bytes`: decode and compact
    every segment's events, then one :func:`ref.advance` per event column
    with the boundary flushes applied per segment."""
    s = data.shape[0]
    n_docs = starts.shape[1] - 1
    g, wb = selfloop.shape
    qb = acc_word.shape[1]
    dev = data.device
    words, pos, counts = compact_events(data)
    rows = torch.arange(s, device=dev)
    out_m = torch.zeros((s, g, n_docs, qb), dtype=torch.int32, device=dev)
    out_f = torch.full((s, g, n_docs, qb), NO_MATCH, dtype=torch.int32,
                       device=dev)
    stack = torch.zeros((s, g, max_depth + 2, wb), dtype=torch.int32,
                        device=dev)
    stack[:, :, 0] = init
    depth = torch.zeros(s, dtype=torch.long, device=dev)
    matched = torch.zeros((s, g, qb), dtype=torch.bool, device=dev)
    first = torch.full((s, g, qb), NO_MATCH, dtype=torch.int32, device=dev)
    ordinal = torch.zeros(s, dtype=torch.int32, device=dev)
    d = torch.zeros(s, dtype=torch.long, device=dev)

    def bound_of(d):
        # slot d ends where slot d + 1 starts; the last slot never ends early
        nxt = starts.gather(1, torch.clamp(d + 1, max=n_docs)[:, None])[:, 0]
        return torch.where(d + 1 < n_docs, nxt, _INT32_MAX)

    bound = bound_of(d)
    for j in range(words.shape[1]):
        p = pos[:, j]
        while True:
            cross = p >= bound
            if not bool(cross.any()):
                break
            c = rows[cross]
            out_m[c, :, d[c]] = matched[c].to(torch.int32)
            out_f[c, :, d[c]] = first[c]
            stack[c, :, 0] = init
            depth[c] = 0
            matched[c] = False
            first[c] = NO_MATCH
            ordinal[c] = 0
            d[c] += 1
            bound = bound_of(d)
        depth, matched, first = ref.advance(
            stack, depth, matched, first, words[:, j], ordinal,
            tagmask, pw, pb, selfloop, acc_word, acc_bit,
            max_depth=max_depth)
        ordinal = ordinal + (j < counts).to(torch.int32)
    out_m[rows, :, d] = matched.to(torch.int32)
    out_f[rows, :, d] = first
    return out_m, out_f


# ------------------------------------------------------------- K4 and K3
def epilogue_window(qb: int, ep_tile: int) -> int:
    """Rows of the TPU epilogue's emission window: ``qb`` lanes can all
    hit, tiled by ``ep_tile``.  The CUDA epilogue has no window; the
    engine's choice between the fused epilogue and lane compaction reads
    it, as the JAX package's does."""
    tile = max(8, int(ep_tile))
    return max(tile, -(-int(qb) // tile) * tile)


def _sparse_args(doc_ids: torch.Tensor, lane_cls: torch.Tensor, cap: int,
                 rows: int, slots: int, g: int, qb: int,
                 device: torch.device) -> int:
    _check(doc_ids, "doc_ids", torch.int32, device)
    _check(lane_cls, "lane_cls", torch.int32, device)
    if tuple(doc_ids.shape) != (rows, slots):
        raise ValueError(f"doc_ids has shape {tuple(doc_ids.shape)}, "
                         f"expected {(rows, slots)}")
    if tuple(lane_cls.shape) != (g, qb):
        raise ValueError(f"lane_cls has shape {tuple(lane_cls.shape)}, "
                         f"expected {(g, qb)}")
    cap = int(cap)
    if not 1 <= cap < _INT32_MAX:
        raise ValueError(f"cap={cap} must lie in [1, 2**31 - 1)")
    return cap


def _empty_rows(cap: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cap, 3) rows of ``(-1, -1, NO_MATCH)`` and a zero counter, made on
    the current stream, where the kernel then runs."""
    buf = torch.empty((cap, 3), dtype=torch.int32, device=device)
    buf[:, :2] = -1
    buf[:, 2] = NO_MATCH
    return buf, torch.zeros(1, dtype=torch.int32, device=device)


def stream_filter_sparse(events: torch.Tensor, doc_ids: torch.Tensor,
                         tagmask: torch.Tensor, pw: torch.Tensor,
                         pb: torch.Tensor, selfloop: torch.Tensor,
                         init: torch.Tensor, acc_word: torch.Tensor,
                         acc_bit: torch.Tensor, lane_cls: torch.Tensor, *,
                         cap: int, max_depth: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's stream ending in the sparse epilogue (K4).

    ``doc_ids`` (B, 1) int32 names each batch row (``< 0`` emits
    nothing); ``lane_cls`` (G, QB) int32 names each lane's accept class
    (``-1`` = inert).  Returns ``buf`` (cap, 3) int32 rows ``(doc,
    class, first)`` and ``count`` (1,) int32, the true number of rows:
    only ``buf[:min(count, cap)]`` is valid, ``count > cap`` is overflow,
    and on the card the row order is not fixed.
    """
    dev = events.device
    tables = (tagmask, pw, pb, selfloop, init, acc_word, acc_bit)
    g, n_tags, wb, qb = _table_dims(tables, dev)
    _check(events, "events", torch.int32, dev)
    if events.dim() != 2:
        raise ValueError(f"events must be (B, N), got {tuple(events.shape)}")
    b, n = events.shape
    cap = _sparse_args(doc_ids, lane_cls, cap, b, 1, g, qb, dev)
    if dev.type == "cpu":
        return stream_filter_sparse_plain(events, doc_ids, *tables, lane_cls,
                                          cap=cap, max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    from . import build

    lib = build.load("stream_filter")
    _smem_check(lib, n_tags, wb, qb, max_depth, sparse=True)
    if b > 65535:
        raise ValueError(f"batch of {b} documents exceeds the grid's 65535")
    buf, count = _empty_rows(cap, dev)
    if b == 0 or g == 0:
        return buf, count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_events_sparse(
            _ptr(events), b, n, _ptr(doc_ids), *map(_ptr, tables), g, n_tags,
            wb, qb, int(max_depth), _ptr(lane_cls), cap, _ptr(buf),
            _ptr(count), _ptr(_scratch(lib, g, n_tags, wb, dev)),
            ctypes.c_void_p(stream))
    _raise_on(err, "stream_filter_sparse")
    count_launch(stream_filter_sparse)
    return buf, count


stream_filter_sparse.launches = 0


def stream_filter_sparse_plain(events: torch.Tensor, doc_ids: torch.Tensor,
                               tagmask: torch.Tensor, pw: torch.Tensor,
                               pb: torch.Tensor, selfloop: torch.Tensor,
                               init: torch.Tensor, acc_word: torch.Tensor,
                               acc_bit: torch.Tensor, lane_cls: torch.Tensor,
                               *, cap: int, max_depth: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_filter_sparse`: K1's plain version,
    then :func:`ref.sparse_epilogue` (rows in the TPU grid's order)."""
    matched, first = stream_filter_plain(
        events, tagmask, pw, pb, selfloop, init, acc_word, acc_bit,
        max_depth=max_depth)
    return ref.sparse_epilogue(matched, first, lane_cls, doc_ids, cap)


def stream_filter_bytes_sparse(data: torch.Tensor, starts: torch.Tensor,
                               doc_map: torch.Tensor, tagmask: torch.Tensor,
                               pw: torch.Tensor, pb: torch.Tensor,
                               selfloop: torch.Tensor, init: torch.Tensor,
                               acc_word: torch.Tensor, acc_bit: torch.Tensor,
                               lane_cls: torch.Tensor, *, cap: int,
                               max_depth: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's stream ending in the sparse epilogue (K3): one launch from raw
    bytes to the bounded match list.

    ``doc_map`` (S, D) int32 names each segment slot's batch row (``-1``
    = unused slot, emits nothing; ``SegmentPack.doc_ids``, or
    ``arange(B)[:, None]`` unpacked).  Other inputs as for
    :func:`stream_filter_bytes` and :func:`stream_filter_sparse`; the
    result contract is :func:`stream_filter_sparse`'s.
    """
    dev = data.device
    tables = (tagmask, pw, pb, selfloop, init, acc_word, acc_bit)
    g, n_tags, wb, qb = _table_dims(tables, dev)
    _check(data, "data", torch.uint8, dev)
    _check(starts, "starts", torch.int32, dev)
    if data.dim() != 2 or starts.dim() != 2 \
            or starts.shape[0] != data.shape[0] or starts.shape[1] < 2:
        raise ValueError(f"data (S, L) and starts (S, D+1) disagree: "
                         f"{tuple(data.shape)} vs {tuple(starts.shape)}")
    s, length = data.shape
    d = starts.shape[1] - 1
    cap = _sparse_args(doc_map, lane_cls, cap, s, d, g, qb, dev)
    if dev.type == "cpu":
        return stream_filter_bytes_sparse_plain(
            data, starts, doc_map, *tables, lane_cls, cap=cap,
            max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    from . import build

    lib = build.load("stream_filter")
    _smem_check(lib, n_tags, wb, qb, max_depth, sparse=True, bytes_=True)
    _slots_check(lib, d)
    if s > 65535:
        raise ValueError(f"{s} segments exceed the grid's 65535")
    buf, count = _empty_rows(cap, dev)
    if s == 0 or g == 0:
        return buf, count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_bytes_sparse(
            _ptr(data), s, length, _ptr(starts), d, _ptr(doc_map),
            *map(_ptr, tables), g, n_tags, wb, qb, int(max_depth),
            _ptr(lane_cls), cap, _ptr(buf), _ptr(count),
            _ptr(_scratch(lib, g, n_tags, wb, dev)), ctypes.c_void_p(stream))
    _raise_on(err, "stream_filter_bytes_sparse")
    count_launch(stream_filter_bytes_sparse)
    return buf, count


stream_filter_bytes_sparse.launches = 0


def stream_filter_bytes_sparse_plain(
        data: torch.Tensor, starts: torch.Tensor, doc_map: torch.Tensor,
        tagmask: torch.Tensor, pw: torch.Tensor, pb: torch.Tensor,
        selfloop: torch.Tensor, init: torch.Tensor, acc_word: torch.Tensor,
        acc_bit: torch.Tensor, lane_cls: torch.Tensor, *, cap: int,
        max_depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_filter_bytes_sparse`: K2's plain
    version, then :func:`ref.sparse_epilogue`."""
    matched, first = stream_filter_bytes_plain(
        data, starts, tagmask, pw, pb, selfloop, init, acc_word, acc_bit,
        max_depth=max_depth)
    return ref.sparse_epilogue(matched, first, lane_cls, doc_map, cap)
