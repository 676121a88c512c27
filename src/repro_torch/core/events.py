# Subset of src/repro/core/events.py (the port imports nothing of the JAX
# package): event streams, event/byte batches, segment packing, the byte
# codec, the document error taxonomy and the serve loop's pre-admission
# check (validate_payload) and the tree view (Node, to_trees,
# from_trees); batches hold numpy arrays or, once parsed on a device,
# torch tensors.
"""Document event streams and the fixed-width byte codec.

A document is represented as a balanced sequence of *events*:

  * ``OPEN``  — an element starts (carries the dictionary tag id)
  * ``CLOSE`` — the most recent open element ends
  * ``PAD``   — no-op filler so batched documents share a static length

This is exactly the view the paper's hardware sees after its tag-filter
block: the SAX-level structure of the document with tags already
dictionary-replaced (§3.1).  Text content does not influence structural
XPath matching, so the codec optionally interleaves filler text bytes (to
exercise the byte-level decoder) but the event stream drops it.

The byte format is the paper's: open tags are 4 bytes ``<xy>`` and close
tags 5 bytes ``</xy>`` where ``x``/``y`` come from the 64-symbol alphabet in
:mod:`repro.core.dictionary`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from .dictionary import (
    CLOSE_NBYTES,
    LT,
    OPEN_NBYTES,
    SLASH,
    TagDictionary,
)

OPEN, CLOSE, PAD = 0, 1, 2


# ------------------------------------------------------------ error taxonomy
class DocumentError(ValueError):
    """A *document* is bad — not the pipeline.

    The typed error contract the fault-tolerant serve loop is built on
    (:mod:`repro.serve.loop`): anything raised because of the *content*
    of specific documents derives from this class and carries the batch
    indices of the offending documents in ``doc_indices``, so a batch
    failure can be attributed — and quarantined — per document instead
    of poisoning the whole loop.  Subclassing :class:`ValueError` keeps
    every pre-existing ``except ValueError`` / ``pytest.raises``
    contract intact.
    """

    def __init__(self, message: str, doc_indices: Sequence[int] = ()):
        super().__init__(message)
        #: batch rows of the offending documents (empty when unknown —
        #: e.g. a single-document host-side validation failure)
        self.doc_indices: tuple[int, ...] = tuple(int(i) for i in doc_indices)


class MalformedDocument(DocumentError):
    """Bytes/events that do not form a balanced paper-format document
    (mismatched or unclosed tags, undecodable tag markers)."""


class DepthOverflow(DocumentError):
    """Document nesting exceeds the engine/parser ``max_depth`` bound —
    parent pointers past the bound would be silently wrong, so the
    document is rejected instead."""


class KernelFault(DocumentError):
    """A device program failed while filtering specific documents and
    bisection attributed the fault to them (the residual category: the
    batch works without these documents, fails with them)."""


#: parser/engine nesting-depth bound (the streaming engine's bounded
#: stack and the parse kernel's parent-pointer scan share it —
#: re-exported as :data:`repro.kernels.parse.DEFAULT_MAX_DEPTH`)
DEFAULT_MAX_DEPTH = 64


_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(bool): torch.bool}


def _as_field(x, dtype):
    """Coerce a batch field without moving a tensor off its device.

    Torch tensors keep their placement (cast to the field's type), so a
    batch parsed on the card flows to an engine there with no host round
    trip; anything else becomes a numpy array of ``dtype``.
    """
    if isinstance(x, torch.Tensor):
        return x.to(_TORCH_DTYPES[np.dtype(dtype)])
    return np.asarray(x, dtype)


@dataclass
class EventStream:
    """Structure-of-arrays event stream for one document."""

    kind: np.ndarray     # (N,) int8 — OPEN / CLOSE / PAD
    tag_id: np.ndarray   # (N,) int32 — dictionary id for OPEN/CLOSE, -1 for PAD

    def __post_init__(self) -> None:
        self.kind = np.asarray(self.kind, dtype=np.int8)
        self.tag_id = np.asarray(self.tag_id, dtype=np.int32)
        assert self.kind.shape == self.tag_id.shape

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_nodes(self) -> int:
        return int((self.kind == OPEN).sum())

    # ------------------------------------------------------------ building
    @classmethod
    def from_pairs(cls, pairs) -> "EventStream":
        """pairs: iterable of (kind, tag_id)."""
        ks, ts = [], []
        for k, t in pairs:
            ks.append(k)
            ts.append(t)
        return cls(np.array(ks, dtype=np.int8), np.array(ts, dtype=np.int32))

    def padded(self, n: int) -> "EventStream":
        if n < len(self):
            raise ValueError(f"cannot pad {len(self)} events into {n}")
        k = np.full(n, PAD, dtype=np.int8)
        t = np.full(n, -1, dtype=np.int32)
        k[: len(self)] = self.kind
        t[: len(self)] = self.tag_id
        return EventStream(k, t)

    # ---------------------------------------------------------- validation
    def check_balanced(self) -> None:
        depth = 0
        stack: list[int] = []
        for k, t in zip(self.kind, self.tag_id):
            if k == OPEN:
                stack.append(int(t))
                depth += 1
            elif k == CLOSE:
                if not stack or stack[-1] != int(t):
                    raise MalformedDocument("unbalanced or mismatched close tag")
                stack.pop()
                depth -= 1
        if stack:
            raise MalformedDocument(f"{len(stack)} unclosed elements")

    def max_depth(self) -> int:
        delta = np.where(self.kind == OPEN, 1, np.where(self.kind == CLOSE, -1, 0))
        if len(delta) == 0:
            return 0
        return int(np.cumsum(delta).max(initial=0))

    # ------------------------------------------------------------ structure
    def structure(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-event (depth, parent_event_index).

        ``depth[i]`` — for OPEN events, the node's depth (top-level = 1);
        for CLOSE/PAD, the depth after the event (unused by engines).
        ``parent[i]`` — for OPEN events, the event index of the parent OPEN,
        or -1 for top-level nodes.  CLOSE/PAD get -1.

        This is the host-side oracle for the jax implementations in
        :mod:`repro.core.engines.levelwise`.
        """
        n = len(self)
        depth = np.zeros(n, dtype=np.int32)
        parent = np.full(n, -1, dtype=np.int32)
        stack: list[int] = []
        for i in range(n):
            k = self.kind[i]
            if k == OPEN:
                parent[i] = stack[-1] if stack else -1
                stack.append(i)
                depth[i] = len(stack)
            elif k == CLOSE:
                if stack:
                    stack.pop()
                depth[i] = len(stack)
            else:
                depth[i] = len(stack)
        return depth, parent


# -------------------------------------------------------------- batch format
def bucket_length(n: int, bucket: int | None) -> int:
    """Round ``n`` up to a padding bucket boundary.

    Bucketed padding keeps the number of distinct (B, N) shapes — and
    therefore the number of XLA compilations — bounded: every batch is
    padded to the next multiple of ``bucket`` instead of its exact max
    length.  ``bucket=None`` disables bucketing (exact max-length pad).
    """
    if bucket is None or bucket <= 1:
        return max(1, n)
    return max(bucket, -(-n // bucket) * bucket)


@dataclass
class EventBatch:
    """Padded, device-ready batch of event streams — THE document format.

    Every filtering engine consumes this one structure (see
    :mod:`repro.core.engines.base`): a dense ``(B, N)`` structure-of-arrays
    view of ``B`` documents padded to a common event count ``N``, with the
    per-event structure (depth, parent pointer) that the levelwise engines
    need precomputed in the same host pass that pads.

    ``kind``/``tag_id`` are the raw SAX-level stream (what the streaming
    and matscan engines scan); ``depth``/``parent`` virtualize the
    document stack (what the levelwise engines bucket by); ``valid`` masks
    the padding tail; ``n_events[b]`` is the true length of document b.

    Fields are numpy arrays for a batch built on the host
    (:meth:`from_streams`) or torch tensors for one parsed on a device
    (:func:`repro_torch.kernels.parse.parse_batch`), which stay there:
    engines on that device take them as they are, and :meth:`to_host`
    brings them back.
    """

    kind: np.ndarray      # (B, N) int8  — OPEN / CLOSE / PAD
    tag_id: np.ndarray    # (B, N) int32 — dictionary id, -1 for PAD
    depth: np.ndarray     # (B, N) int32 — node depth for OPEN events
    parent: np.ndarray    # (B, N) int32 — event idx of parent OPEN, -1 root
    valid: np.ndarray     # (B, N) bool  — kind != PAD
    n_events: np.ndarray  # (B,)   int32 — true per-document lengths

    def __post_init__(self) -> None:
        self.kind = _as_field(self.kind, np.int8)
        self.tag_id = _as_field(self.tag_id, np.int32)
        self.depth = _as_field(self.depth, np.int32)
        self.parent = _as_field(self.parent, np.int32)
        self.valid = _as_field(self.valid, bool)
        self.n_events = _as_field(self.n_events, np.int32)
        assert self.kind.ndim == 2
        assert self.kind.shape == self.tag_id.shape == self.depth.shape \
            == self.parent.shape == self.valid.shape
        assert tuple(self.n_events.shape) == (self.kind.shape[0],)

    @property
    def is_device(self) -> bool:
        """True when the fields are torch tensors, not numpy arrays."""
        return isinstance(self.kind, torch.Tensor)

    def to_host(self) -> "EventBatch":
        """The same batch in numpy (no-op for a host batch)."""
        if not self.is_device:
            return self
        return EventBatch(*(a.cpu().numpy() for a in
                            (self.kind, self.tag_id, self.depth,
                             self.parent, self.valid, self.n_events)))

    # ----------------------------------------------------------- properties
    @property
    def batch_size(self) -> int:
        return int(self.kind.shape[0])

    @property
    def length(self) -> int:
        return int(self.kind.shape[1])

    def __len__(self) -> int:
        return self.batch_size

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_streams(cls, docs: Sequence["EventStream"],
                     bucket: int | None = None) -> "EventBatch":
        """Pad ``docs`` to a common (bucketed) length and stack.

        One linear host pass per document computes (depth, parent)
        alongside the pad — the batch analogue of
        :meth:`EventStream.structure`.
        """
        if len(docs) == 0:
            raise ValueError("empty batch")
        n = bucket_length(max((len(d) for d in docs), default=1), bucket)
        b = len(docs)
        kind = np.full((b, n), PAD, dtype=np.int8)
        tag = np.full((b, n), -1, dtype=np.int32)
        depth = np.zeros((b, n), dtype=np.int32)
        parent = np.full((b, n), -1, dtype=np.int32)
        valid = np.zeros((b, n), dtype=bool)
        lengths = np.zeros(b, dtype=np.int32)
        for i, doc in enumerate(docs):
            m = len(doc)
            kind[i, :m] = doc.kind
            tag[i, :m] = doc.tag_id
            d, p = doc.structure()
            depth[i, :m] = d
            parent[i, :m] = p
            valid[i, :m] = doc.kind != PAD
            lengths[i] = m
        return cls(kind, tag, depth, parent, valid, lengths)

    def pad_to(self, n: int) -> "EventBatch":
        """Grow the event axis to ``n`` (no-op when already that long)."""
        cur = self.length
        if n < cur:
            raise ValueError(f"cannot pad {cur} events into {n}")
        if n == cur:
            return self
        b, extra = self.batch_size, n - cur
        return EventBatch(
            np.concatenate([self.kind, np.full((b, extra), PAD, np.int8)], 1),
            np.concatenate([self.tag_id, np.full((b, extra), -1, np.int32)], 1),
            np.concatenate([self.depth, np.zeros((b, extra), np.int32)], 1),
            np.concatenate([self.parent, np.full((b, extra), -1, np.int32)], 1),
            np.concatenate([self.valid, np.zeros((b, extra), bool)], 1),
            self.n_events,
        )

    # ------------------------------------------------------------ recovery
    def stream(self, i: int) -> "EventStream":
        """Document ``i`` of a host batch as an un-padded :class:`EventStream`."""
        m = int(self.n_events[i])
        return EventStream(self.kind[i, :m].copy(), self.tag_id[i, :m].copy())

    def streams(self) -> Iterator["EventStream"]:
        for i in range(self.batch_size):
            yield self.stream(i)

    # ------------------------------------------------------------- metrics
    def nbytes(self, text_fill: int = 0) -> np.ndarray:
        """(B,) byte sizes in the paper's wire format (for MB/s stats)."""
        n_open = (self.kind == OPEN).sum(axis=1)
        n_close = (self.kind == CLOSE).sum(axis=1)
        return (n_open * (OPEN_NBYTES + text_fill)
                + n_close * CLOSE_NBYTES).astype(np.int64)


# ------------------------------------------------------------- byte batches
@dataclass
class ByteBatch:
    """Padded ``(B, L)`` uint8 batch of raw paper-format byte streams.

    The ingestion mirror of :class:`EventBatch`: where ``EventBatch`` is
    the *parsed* document format every engine consumes, ``ByteBatch`` is
    the *wire* format the device parser consumes —
    :func:`repro.kernels.parse.parse_batch` turns one into the other
    entirely on device (the paper's same-chip parser+filter, §1/§3.4).

    ``data`` is zero-padded: byte 0 is neither ``<`` nor a dictionary
    symbol, so padding decodes to no events by construction.  ``bucket``
    rounds ``L`` up to a boundary (see :func:`bucket_length`) to bound
    the number of compiled shapes, exactly like ``EventBatch`` padding.
    """

    data: np.ndarray     # (B, L) uint8 — raw bytes, zero-padded
    n_bytes: np.ndarray  # (B,)   int32 — true per-document byte counts

    def __post_init__(self) -> None:
        self.data = _as_field(self.data, np.uint8)
        self.n_bytes = _as_field(self.n_bytes, np.int32)
        assert self.data.ndim == 2
        assert self.n_bytes.shape == (self.data.shape[0],)

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])

    @property
    def length(self) -> int:
        return int(self.data.shape[1])

    def __len__(self) -> int:
        return self.batch_size

    @property
    def max_events(self) -> int:
        """Static upper bound on events per document.

        The fixed-width codec (§3.1) guarantees every event occupies at
        least ``OPEN_NBYTES`` bytes, so ``L // OPEN_NBYTES`` bounds the
        compacted event count — this is what makes the device parser's
        output shape static.
        """
        return max(1, self.length // OPEN_NBYTES)

    def event_bound(self, bucket: int | None = None) -> int:
        """Tight static bound on events per document: the max per-doc
        count of ``<`` markers (every event starts with one).

        One vectorized host pass over the byte tensor — batch *metadata*,
        like the length scan in :meth:`from_buffers`; the per-event
        validate/compact work stays on the device.  Much tighter than
        :attr:`max_events` when documents carry text content, so the
        filter scan does not step through phantom padding events.
        """
        data = np.asarray(self.data)
        n = int((data == LT).sum(axis=1).max()) if data.size else 1
        return bucket_length(max(1, n), bucket)

    # ----------------------------------------------------------- building
    @classmethod
    def from_buffers(cls, bufs: Sequence[bytes],
                     bucket: int | None = None) -> "ByteBatch":
        """Stack raw byte payloads, zero-padded to a bucketed length."""
        if len(bufs) == 0:
            raise ValueError("empty batch")
        n = bucket_length(max((len(b) for b in bufs), default=1), bucket)
        data = np.zeros((len(bufs), n), dtype=np.uint8)
        lengths = np.zeros(len(bufs), dtype=np.int32)
        for i, buf in enumerate(bufs):
            arr = np.frombuffer(buf, dtype=np.uint8)
            data[i, : len(arr)] = arr
            lengths[i] = len(arr)
        return cls(data, lengths)

    @classmethod
    def from_streams(cls, docs: Sequence["EventStream"], text_fill: int = 0,
                     bucket: int | None = None) -> "ByteBatch":
        """Serialize event streams to the wire format and stack."""
        return cls.from_buffers(
            [encode_bytes(d, text_fill=text_fill) for d in docs],
            bucket=bucket)

    # ----------------------------------------------------------- recovery
    def buffer(self, i: int) -> bytes:
        """Document ``i`` as its un-padded byte string."""
        data = np.asarray(self.data)
        return bytes(data[i, : int(self.n_bytes[i])])

    def buffers(self) -> Iterator[bytes]:
        for i in range(self.batch_size):
            yield self.buffer(i)

    # ------------------------------------------------------------ metrics
    def nbytes_total(self) -> int:
        """True payload bytes across the batch (MB/s accounting)."""
        return int(np.asarray(self.n_bytes).sum())


# ------------------------------------------------------------ segment packing
#: ``starts`` sentinel past a segment's last real document.  The bytes
#: megakernel flushes document ``d`` when an event lands at or past
#: ``starts[d+1]``; event positions are always < 2³¹-1, so sentinel
#: boundaries are simply never crossed — no per-document count scalar.
SEG_SENTINEL = np.iinfo(np.int32).max


@dataclass
class SegmentPack:
    """Dense multi-document segments for the one-launch bytes megakernel.

    The padding-free counterpart of a ragged :class:`ByteBatch`: instead
    of every document padding to the longest, documents are concatenated
    back to back into ``(S, L)`` byte segments (first-fit decreasing, so
    short documents share a grid slot) with two per-segment tables:

    * ``starts`` ``(S, D+1)`` int32 — byte offset where each document
      begins; entries past the last real document are
      :data:`SEG_SENTINEL`.  The kernel resets its stack and flushes the
      finished document's accept lanes whenever the event stream crosses
      ``starts[d+1]``.
    * ``doc_ids`` ``(S, D)`` int32 — original batch row of each packed
      document, ``-1`` for unused slots; :meth:`scatter` uses it to map
      per-(segment, slot) verdicts back to ``(B, Q)`` batch order.

    Zero-byte documents are never packed (no bytes ⇒ no events ⇒ no
    match); scatter fills their rows with the no-match defaults.
    """

    data: np.ndarray      # (S, L) uint8 — concatenated docs, zero-padded
    starts: np.ndarray    # (S, D+1) int32 — doc start offsets + sentinels
    doc_ids: np.ndarray   # (S, D) int32 — original batch row, -1 unused
    batch_size: int       # B of the ByteBatch this was packed from
    n_bytes: np.ndarray   # (S,) int32 — live (non-pad) bytes per segment

    def __post_init__(self) -> None:
        self.data = _as_field(self.data, np.uint8)
        self.starts = _as_field(self.starts, np.int32)
        self.doc_ids = _as_field(self.doc_ids, np.int32)
        self.n_bytes = _as_field(self.n_bytes, np.int32)
        assert self.data.ndim == 2
        assert self.starts.shape[0] == self.data.shape[0]
        assert self.starts.shape[1] == self.doc_ids.shape[1] + 1
        assert self.n_bytes.shape == (self.data.shape[0],)

    @property
    def n_segments(self) -> int:
        return int(self.data.shape[0])

    @property
    def seg_len(self) -> int:
        return int(self.data.shape[1])

    @property
    def docs_per_segment(self) -> int:
        return int(self.doc_ids.shape[1])

    def scatter(self, matched, first, no_match: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """(S, D, Q) per-slot verdicts → (B, Q) batch-order results.

        ``no_match`` is the caller's first-event fill (the engine layer's
        ``NO_MATCH``) — passed in so this module stays engine-agnostic.
        Slots with ``doc_ids == -1`` (and dropped zero-byte documents)
        contribute nothing; their batch rows keep the no-match defaults.
        """
        q = matched.shape[-1]
        ids = np.asarray(self.doc_ids).ravel()
        live = ids >= 0
        m = np.zeros((self.batch_size, q), dtype=bool)
        f = np.full((self.batch_size, q), no_match, np.int32)
        m[ids[live]] = np.asarray(matched).reshape(-1, q)[live] != 0
        f[ids[live]] = np.asarray(first).reshape(-1, q)[live]
        return m, f

    def fill_fraction(self) -> float:
        """Live bytes / total segment bytes — the packing efficiency the
        ``events_per_slot`` benchmark metric builds on."""
        total = self.data.size
        if total == 0:
            return 0.0
        return float(np.asarray(self.n_bytes).sum()) / float(total)


def pack_segments(bb: "ByteBatch", *, target_len: int = 4096,
                  doc_bucket: int = 8) -> SegmentPack:
    """First-fit-decreasing pack of a :class:`ByteBatch` into segments.

    ``target_len`` is both the segment capacity target and the length
    bucket (the actual ``L`` is the smallest multiple of ``target_len``
    that fits the longest document, so one oversized document widens —
    never breaks — the pack).  ``doc_bucket`` buckets the per-segment
    document-slot count for shape stability across batches.
    """
    data = np.asarray(bb.data)
    lengths = np.asarray(bb.n_bytes).astype(np.int64)
    seg_len = bucket_length(max(1, int(lengths.max(initial=1))),
                            max(1, int(target_len)))
    order = np.argsort(-lengths, kind="stable")
    segs: list[list[int]] = []    # doc ids per segment
    used: list[int] = []          # bytes used per segment
    for i in order:
        n = int(lengths[i])
        if n == 0:
            continue              # no bytes ⇒ no events ⇒ never matches
        for s, u in enumerate(used):
            if u + n <= seg_len:
                segs[s].append(int(i))
                used[s] += n
                break
        else:
            segs.append([int(i)])
            used.append(n)
    if not segs:                  # all-empty batch: one inert segment
        segs, used = [[]], [0]
    d = bucket_length(max(len(s) for s in segs), max(1, int(doc_bucket)))
    out = np.zeros((len(segs), seg_len), np.uint8)
    starts = np.full((len(segs), d + 1), SEG_SENTINEL, np.int32)
    doc_ids = np.full((len(segs), d), -1, np.int32)
    for s, docs in enumerate(segs):
        off = 0
        for j, i in enumerate(docs):
            n = int(lengths[i])
            out[s, off:off + n] = data[i, :n]
            starts[s, j] = off
            doc_ids[s, j] = i
            off += n
        if not docs:
            starts[s, 0] = 0
    return SegmentPack(out, starts, doc_ids, bb.batch_size,
                       np.asarray(used, np.int32))


# ----------------------------------------------------------------- byte codec
def encode_bytes(ev: EventStream, text_fill: int = 0) -> bytes:
    """Event stream → paper-format byte stream.

    ``text_fill`` inserts that many filler text bytes (``'x'``) after each
    open tag, emulating element text content (consumed by the paper's
    ``[\\w\\s]+`` regex blocks, structurally irrelevant).
    """
    out = bytearray()
    for k, t in zip(ev.kind, ev.tag_id):
        if k == OPEN:
            out += b"<" + TagDictionary.symbols_of(int(t)).encode() + b">"
            out += b"x" * text_fill
        elif k == CLOSE:
            out += b"</" + TagDictionary.symbols_of(int(t)).encode() + b">"
    return bytes(out)


def decode_bytes(buf: bytes, sym_table: np.ndarray) -> EventStream:
    """Byte stream → event stream (host reference for the predecode kernel).

    Vectorised with numpy the same way the Pallas kernel does it on-device:
    classify each byte position, then decode the two symbol bytes that follow
    each ``<`` / ``</`` marker.  Fixed-length tags (the paper's dictionary
    replacement) are what make this embarrassingly parallel.

    A ``<`` / ``</`` marker whose symbol bytes are not both in the
    64-symbol alphabet is *rejected* (no event emitted) — identical to
    the kernel's ``ok = (v0 >= 0) & (v1 >= 0)`` validation in
    :mod:`repro.kernels.predecode`, so host and device agree on
    malformed input.
    """
    b = np.frombuffer(buf, dtype=np.uint8)
    n = b.shape[0]
    if n == 0:
        return EventStream(np.zeros(0, np.int8), np.zeros(0, np.int32))
    is_lt = b == LT
    nxt = np.concatenate([b[1:], np.zeros(1, np.uint8)])
    is_close = is_lt & (nxt == SLASH)
    is_open = is_lt & ~is_close
    # symbol positions: open '<' at i → symbols at i+1, i+2 ; close at i+2, i+3
    idx = np.arange(n)
    s0 = np.where(is_close, idx + 2, idx + 1)
    s1 = s0 + 1
    # the kernel shifts zeros in past the end; byte 0 is not in the
    # alphabet, so out-of-range symbol positions are invalid there too
    v0 = np.where(s0 < n, sym_table[b[np.clip(s0, 0, n - 1)]], -1)
    v1 = np.where(s1 < n, sym_table[b[np.clip(s1, 0, n - 1)]], -1)
    ok = (v0 >= 0) & (v1 >= 0)
    tag = (v0 << 6) | v1
    keep = (is_open | is_close) & ok
    kind = np.where(is_close[keep], CLOSE, OPEN).astype(np.int8)
    return EventStream(kind, tag[keep].astype(np.int32))


_SYM_TABLE: np.ndarray | None = None


def _sym_table() -> np.ndarray:
    """The (256,) byte→symbol-value table (alphabet is fixed, §3.1)."""
    global _SYM_TABLE
    if _SYM_TABLE is None:
        _SYM_TABLE = TagDictionary().symbol_value_table()
    return _SYM_TABLE


def validate_payload(buf: bytes, *, max_depth: int = DEFAULT_MAX_DEPTH,
                     doc_index: int | None = None) -> None:
    """Cheap host-side pre-admission check for one wire payload.

    The serve loop's first failure domain (:meth:`repro.serve.loop.
    ServeLoop.submit`): known-bad bytes are rejected with a typed
    :class:`DocumentError` *before* they are batched with healthy
    documents or reach a kernel.  Vectorized numpy only — a handful of
    cumsums over the byte buffer, no per-event Python:

    * a ``<`` / ``</`` marker whose symbol bytes are outside the
      64-symbol alphabet (the kernel would silently drop it, skewing
      structure) → :class:`MalformedDocument`;
    * close-without-open or unclosed elements (depth scan goes negative
      / ends above zero) → :class:`MalformedDocument`;
    * nesting beyond ``max_depth`` (parent pointers past the parser's
      bounded stack would be wrong) → :class:`DepthOverflow`.

    An empty payload is *valid*: zero bytes decode to zero events, the
    inert document every batch-padding path already relies on.  Checks
    mirror kernel semantics exactly (cf. :func:`decode_bytes`): anything
    this function admits, the device parser handles deterministically.
    """
    idx = () if doc_index is None else (doc_index,)
    b = np.frombuffer(buf, dtype=np.uint8)
    n = b.shape[0]
    if n == 0:
        return
    sym = _sym_table()
    is_lt = b == LT
    nxt = np.concatenate([b[1:], np.zeros(1, np.uint8)])
    is_close = is_lt & (nxt == SLASH)
    is_open = is_lt & ~is_close
    pos = np.arange(n)
    s0 = np.where(is_close, pos + 2, pos + 1)
    s1 = s0 + 1
    v0 = np.where(s0 < n, sym[b[np.clip(s0, 0, n - 1)]], -1)
    v1 = np.where(s1 < n, sym[b[np.clip(s1, 0, n - 1)]], -1)
    ok = (v0 >= 0) & (v1 >= 0)
    marker = is_open | is_close
    bad = marker & ~ok
    if bad.any():
        where = int(np.flatnonzero(bad)[0])
        raise MalformedDocument(
            f"undecodable tag marker at byte {where}", idx)
    delta = np.where(is_open & ok, 1, 0) - np.where(is_close & ok, 1, 0)
    depth = np.cumsum(delta)
    if depth.min(initial=0) < 0:
        raise MalformedDocument("close tag without matching open", idx)
    if depth.size and depth[-1] != 0:
        raise MalformedDocument(f"{int(depth[-1])} unclosed elements", idx)
    dmax = int(depth.max(initial=0))
    if dmax > max_depth:
        raise DepthOverflow(
            f"document nesting depth {dmax} exceeds max_depth={max_depth}",
            idx)


def event_stream_nbytes(ev: EventStream, text_fill: int = 0) -> int:
    n_open = int((ev.kind == OPEN).sum())
    n_close = int((ev.kind == CLOSE).sum())
    return n_open * (OPEN_NBYTES + text_fill) + n_close * CLOSE_NBYTES


# ----------------------------------------------------------------- tree view
@dataclass
class Node:
    tag_id: int
    children: list["Node"]


def to_trees(ev: EventStream) -> list[Node]:
    """Event stream → forest of nodes (oracle engine input)."""
    roots: list[Node] = []
    stack: list[Node] = []
    for k, t in zip(ev.kind, ev.tag_id):
        if k == OPEN:
            node = Node(int(t), [])
            (stack[-1].children if stack else roots).append(node)
            stack.append(node)
        elif k == CLOSE:
            stack.pop()
    return roots


def from_trees(roots: list[Node]) -> EventStream:
    pairs: list[tuple[int, int]] = []

    def walk(n: Node) -> None:
        pairs.append((OPEN, n.tag_id))
        for c in n.children:
            walk(c)
        pairs.append((CLOSE, n.tag_id))

    for r in roots:
        walk(r)
    return EventStream.from_pairs(pairs)
