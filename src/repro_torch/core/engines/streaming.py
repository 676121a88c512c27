"""Streaming engine of the port: the megakernels behind one engine.

Counterpart of ``src/repro/core/engines/streaming.py``.  Every NFA state
is one bit of a packed 32-bit word; each event advances every state at
once; a bounded stack of packed words realises the paper's tag stack.
The plan lays the states out in word-aligned blocks closed under parent
pointers (:func:`repro_torch.kernels.blocks.state_layout`), and
hand-written kernels run them (:mod:`repro_torch.kernels.stream_filter`):

* :meth:`StreamingEngine.filter_batch` — events (host-parsed, or parsed
  on the device) through K1, one thread block per (document, state
  block);
* :meth:`StreamingEngine.filter_bytes` — raw wire bytes through K2, one
  launch from bytes to accept lanes, either one document per segment or
  segment-packed (``pack=True``) so short documents share a slot; with
  ``fuse=False``, K5's parse and then K1;
* :meth:`StreamingEngine.filter_batch_sparse` and
  :meth:`StreamingEngine.filter_bytes_sparse` — the same streams ending
  in a bounded ``(doc, accept class, first)`` match list, emitted by the
  kernel itself (K4, K3: ``path="kernel-fused"``) or, for caps past the
  epilogue rule, compacted from K1's lanes (``"lane-compact"``); a
  saturated buffer is recomputed densely (``"dense-overflow"``).

The accept-lane → query gather (the paper's priority encoder), the
scatter of packed slots back to batch order and the expansion of accept
classes to subscribers follow each launch.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...kernels import blocks as blocks_mod
from ...kernels import parse as parse_mod
from ...kernels import stream_filter as sf
from ...kernels.predecode import predecode
from ..events import (DEFAULT_MAX_DEPTH, SEG_SENTINEL, ByteBatch, EventBatch,
                      SegmentPack, pack_segments)
from ..nfa import NFA, pad_states
from . import base
from .result import NO_MATCH, FilterResult, SparseResult

#: the segment packer's capacity target, as the JAX package sets it
DEFAULT_SEGMENT_TARGET = 4096

#: the JAX package's choice between the fused sparse epilogue and lane
#: compaction, kept as it is so both packages take the same path for
#: every cap: the TPU epilogue's emission window is tiled by ``ep_tile``,
#: and ``sparse_epilogue="auto"`` fuses while the ``(cap + window, 3)``
#: buffer, padded to 512 B a row, fits a 4 MiB VMEM budget.  It is that
#: package's rule, not a limit of this card (an H100 policy is ROADMAP
#: queue 1 item 11).
DEFAULT_EP_TILE = 8
DEFAULT_EPILOGUE_VMEM = 4 * 1024 * 1024
SPARSE_EPILOGUE_MODES = ("auto", "on", "off")

#: TPU grid iteration orders; accepted so the option matches, ignored here
GRID_ORDERS = ("bg", "gb")

#: launch-shape options; ``grid_order`` orders the TPU's sequential grid
#: and is kept in the plan's metadata only, the CUDA grid has no order
TUNABLE_KEYS = ("blk", "grid_order", "segment_target", "ep_tile")

#: options read at call time
CALL_KEYS = ("pack", "fuse", "event_bucket", "match_cap", "sparse_epilogue")


def _device_rows(buf: torch.Tensor, count: torch.Tensor, cap: int
                 ) -> tuple[tuple[np.ndarray, ...], int]:
    """A sparse kernel's ``(cap, 3)`` buffer and count → host rows: only
    the first ``min(count, cap)`` rows cross to the host.  Returns
    ``((docs, classes, first), count)``."""
    n = int(count.reshape(-1)[0])
    rows = buf[:min(n, cap)].cpu().numpy()
    return (rows[:, 0], rows[:, 1], rows[:, 2]), n


def _lane_classes(plan: base.FilterPlan) -> tuple[np.ndarray, np.ndarray]:
    """Accept-class tables of one plan, on the host.

    Returns ``(class_of, lane_cls)``: ``class_of[q]`` is the accept class
    of query column q (``-1`` for inert pad columns) and ``lane_cls[g,
    qb]`` names each kernel lane's class (``-1`` for lanes no query
    accepts on, including every block's reserved inert lane).  Classes
    are numbered by first query occurrence, so member lists come out in
    ascending column order.  Derived from the many-to-one
    ``kb_acc_block``/``kb_acc_slot`` mapping.
    """
    ab = plan["kb_acc_block"].cpu().numpy()
    sl = plan["kb_acc_slot"].cpu().numpy()
    g, qb = plan["kb_acc_word"].shape[-2:]
    inert = sl >= qb - 1          # the reserved inert lane
    key = ab.astype(np.int64) * qb + sl
    kv = key[~inert]
    uniq, inv = np.unique(kv, return_inverse=True)
    first_idx = np.full(uniq.shape, kv.shape[0], np.int64)
    np.minimum.at(first_idx, inv, np.arange(kv.shape[0]))
    rank = np.empty(uniq.shape, np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(uniq.shape[0])
    class_of = np.full(key.shape, -1, np.int32)
    class_of[~inert] = rank[inv]
    lane_cls = np.full((g, qb), -1, np.int32)
    lane_cls[uniq // qb, uniq % qb] = rank
    return class_of, lane_cls


@base.register("streaming")
class StreamingEngine(base.FilterEngine):
    """Compile once (``plan``), filter many documents on ``device``.

    Engine options (the JAX engine's, where ported):

    * ``blk=`` / ``grid_order=`` / ``segment_target=`` — launch shape;
      defaults follow the JAX package's static policy so the layouts
      are equal.
    * ``pack=`` — segment-pack byte batches by default in
      :meth:`filter_bytes`.
    * ``fuse=`` — ``True`` (default): bytes run the one-launch kernel;
      ``False``: K5's parse, the compaction, then K1 (no depth check:
      documents deeper than ``max_depth`` clip, as in K1).
    * ``event_bucket=`` — event-axis padding bucket of the byte paths.
    * ``match_cap=`` — bounded match-buffer size of sparse calls;
      ``sparse_epilogue=`` — ``"auto"`` / ``"on"`` / ``"off"``, whether
      sparse calls end in the kernel's own epilogue; ``ep_tile=`` — the
      tile of the JAX package's epilogue window, which ``"auto"`` reads.
    """

    #: packed-word layout: the state axis must tile into 32-bit words
    state_multiple = 32
    device_sharded = True

    def __init__(self, nfa: NFA, dictionary=None,
                 max_depth: int = DEFAULT_MAX_DEPTH, *,
                 device: str | torch.device = "cuda", **options) -> None:
        self.max_depth = int(max_depth)
        self._memo_lock = threading.Lock()
        self._lane_cache: dict = {}
        known = set(TUNABLE_KEYS) | set(CALL_KEYS)
        unknown = sorted(set(options) - known - set(base.NOT_PORTED))
        if unknown:
            raise TypeError(f"unknown streaming engine options {unknown}")
        super().__init__(nfa, dictionary, device=device, **options)

    def kernel_config(self, n_states: int, n_tags: int) -> dict:
        """Launch shape: the static policy, then explicit options."""
        cfg = self.autotune_blocks(n_states, self.max_depth, n_tags=n_tags)
        cfg.update(grid_order="bg", segment_target=DEFAULT_SEGMENT_TARGET,
                   ep_tile=DEFAULT_EP_TILE)
        cfg.update({k: self.options[k] for k in TUNABLE_KEYS
                    if k in self.options})
        if cfg["grid_order"] not in GRID_ORDERS:
            raise ValueError(f"grid_order={cfg['grid_order']!r} is not one "
                             f"of {GRID_ORDERS}")
        return {"blk": int(cfg["blk"]), "grid_order": cfg["grid_order"],
                "segment_target": max(1, int(cfg["segment_target"])),
                "ep_tile": max(1, int(cfg["ep_tile"]))}

    def plan(self, nfa: NFA) -> base.FilterPlan:
        from ...convert import plan_from_numpy  # convert imports this package

        nfa = pad_states(nfa, self.state_multiple)
        cfg = self.kernel_config(nfa.n_states, nfa.n_tags)
        mk = blocks_mod.state_layout(nfa, blk=cfg["blk"])
        tables = dict(kb_tagmask=mk.tagmask, kb_pw=mk.pw, kb_pb=mk.pb,
                      kb_selfloop=mk.selfloop_words, kb_init=mk.init_words,
                      kb_acc_word=mk.acc_word, kb_acc_bit=mk.acc_bit,
                      kb_acc_block=mk.acc_block, kb_acc_slot=mk.acc_slot)
        meta = dict(cfg, n_states=nfa.n_states, max_depth=self.max_depth,
                    state_multiple=self.state_multiple, blk=mk.blk,
                    n_blocks=mk.n_blocks, block_queries=mk.block_queries)
        return plan_from_numpy(tables, meta, self.device)

    # ----------------------------------------------------------- launches
    def _block_tables(self) -> tuple[torch.Tensor, ...]:
        p = self.plan_
        return (p["kb_tagmask"], p["kb_pw"], p["kb_pb"], p["kb_selfloop"],
                p["kb_init"], p["kb_acc_word"], p["kb_acc_bit"])

    def _lanes_to_queries(self, mb: torch.Tensor, fb: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., G, QB) accept lanes → (..., Q) verdicts, on the device."""
        ab, sl = self.plan_["kb_acc_block"], self.plan_["kb_acc_slot"]
        return mb[..., ab, sl] != 0, fb[..., ab, sl]

    def _events(self, batch: EventBatch) -> torch.Tensor:
        """(B, N) fused event words on this engine's device: a batch
        parsed on the device is fused there, a host batch is staged."""
        if batch.is_device:
            return sf.fuse_events(batch.kind.to(self.device),
                                  batch.tag_id.to(self.device))
        events = sf.fuse_events(torch.from_numpy(batch.kind),
                                torch.from_numpy(batch.tag_id))
        return self.to_device(events.numpy())

    def device_verdicts(self, batch: EventBatch
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Events → ``(B, Q)`` verdicts through K1, left on the device."""
        mb, fb = sf.stream_filter(self._events(batch), *self._block_tables(),
                                  max_depth=self.plan_.meta["max_depth"])
        return self._lanes_to_queries(mb, fb)

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        """Events → ``(B, Q)`` verdicts through K1."""
        m, f = self.device_verdicts(batch)
        return FilterResult(m.cpu().numpy(), f.cpu().numpy())

    def _bytes_prep(self, bb: ByteBatch, pack: bool | None
                    ) -> tuple[np.ndarray, np.ndarray, SegmentPack | None]:
        """(data, starts, pack-or-None) for the one-launch kernel: the
        host segment packer, or one degenerate segment per document whose
        only boundary is the sentinel."""
        if pack is None:
            pack = bool(self.options.get("pack", False))
        if pack:
            sp = pack_segments(
                bb, target_len=int(self.plan_.meta["segment_target"]))
            return sp.data, sp.starts, sp
        starts = np.full((bb.batch_size, 2), SEG_SENTINEL, np.int32)
        starts[:, 0] = 0
        return bb.data, starts, None

    def _fused_bytes_on(self) -> bool:
        """One-launch bytes kernel, or parse then K1 (``fuse=False``)?"""
        return bool(self.options.get("fuse", True))

    def filter_bytes(self, bb: ByteBatch, *, bucket: int | None = None,
                     pack: bool | None = None) -> FilterResult:
        """Raw wire bytes → ``(B, Q)`` verdicts in one K2 launch, or, with
        ``fuse=False``, K5's parse and K1 (:meth:`_parse_then_filter`)."""
        if not self._fused_bytes_on():
            m, f = self._lanes_to_queries(*self._parse_then_filter(bb, bucket))
            return FilterResult(m.cpu().numpy(), f.cpu().numpy())
        data, starts, sp = self._bytes_prep(bb, pack)
        mb, fb = sf.stream_filter_bytes(
            self.to_device(data), self.to_device(starts),
            *self._block_tables(), max_depth=self.plan_.meta["max_depth"])
        # (S, G, D, QB) → (S, D, G, QB) → (S, D, Q)
        m, f = (x.cpu().numpy() for x in self._lanes_to_queries(
            mb.transpose(1, 2), fb.transpose(1, 2)))
        if sp is None:
            return FilterResult(m[:, 0], f[:, 0])
        return FilterResult(*sp.scatter(m, f, NO_MATCH))

    def _parse_then_filter(self, bb: ByteBatch, bucket: int | None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """The two-stage bytes program: K5, the compaction to the event
        bound, then K1 → (B, G, QB) lanes.  Only the events reach K1, as
        only they survive in the JAX package's fused program, and there is
        no depth check: deeper documents clip, as in K1."""
        n_events = bb.event_bound(bucket=self._event_bucket(bucket))
        kind_pos, tag_pos = predecode(self.to_device(bb.data))
        kind, tag, _ = parse_mod.compact_events(kind_pos, tag_pos, n_events)
        return sf.stream_filter(sf.fuse_events(kind, tag),
                                *self._block_tables(),
                                max_depth=self.plan_.meta["max_depth"])

    # --------------------------------------------- lane-space sparse path
    def _lane_memo(self, obj, build):
        """Tiny identity-keyed memo for per-plan lane-class tables (plans
        are frozen, so identity is validity; bounded so replaced plans do
        not pin memory).

        The serve loop's workers call it at the same time: a miss builds
        outside the lock and inserts under it (a racing build of the same
        plan is equal and dropped).  ``build`` returns ``(tensor, host
        tables...)``; the tensor is made on the builder's stream, so each
        reader's stream waits for it and is recorded as a user of it, and
        its memory is not reused while a reader's kernels may still read
        it."""
        with self._memo_lock:
            hit = self._lane_cache.get(id(obj))
        if hit is None or hit[0] is not obj:
            val = build()
            hit = (obj, val, base._record_event(val[0].device))
            with self._memo_lock:
                cache = self._lane_cache
                old = cache.get(id(obj))
                if old is not None and old[0] is obj:
                    hit = old
                else:
                    if len(cache) >= 8:
                        cache.pop(next(iter(cache)))
                    cache[id(obj)] = hit
        _, val, ready = hit
        if ready is not None:
            stream = torch.cuda.current_stream(val[0].device)
            stream.wait_event(ready)
            val[0].record_stream(stream)
        return val

    def _plain_lane_tables(self, plan: base.FilterPlan):
        """((G, QB) lane → class tensor on the plan's device, class-member
        CSR offsets and members on the host) for one plan."""

        def build():
            class_of, lane_cls = _lane_classes(plan)
            valid = class_of >= 0
            order = np.argsort(class_of[valid], kind="stable")
            members = np.flatnonzero(valid)[order].astype(np.int32)
            n_cls = int(lane_cls.max(initial=-1)) + 1
            counts = np.bincount(class_of[valid], minlength=n_cls)
            offsets = np.concatenate(([0], np.cumsum(counts)))
            return (torch.from_numpy(lane_cls).to(plan.device), offsets,
                    members)

        return self._lane_memo(plan, build)

    def _ep_tile(self, plan: base.FilterPlan) -> int:
        return int(plan.meta.get("ep_tile", DEFAULT_EP_TILE))

    def _fused_sparse_ok(self, cap: int,
                         plan: base.FilterPlan | None = None) -> bool:
        """End this cap's sparse call in the kernel's own epilogue?

        ``sparse_epilogue="on"`` / ``"off"`` force it; ``"auto"``
        (default) applies the JAX package's rule (see
        :data:`DEFAULT_EPILOGUE_VMEM`) so both take the same path.
        """
        mode = self.options.get("sparse_epilogue", "auto")
        if mode not in SPARSE_EPILOGUE_MODES:
            raise ValueError(f"sparse_epilogue={mode!r} is not one of "
                             f"{SPARSE_EPILOGUE_MODES}")
        if mode != "auto":
            return mode == "on"
        plan = self.plan_ if plan is None else plan
        win = sf.epilogue_window(int(plan.meta["block_queries"]),
                                 self._ep_tile(plan))
        return (int(cap) + win) * 512 <= DEFAULT_EPILOGUE_VMEM

    def _expand_class_hits(self, bufs, count: int, cap: int, offsets,
                           members, *, batch_size: int, meta: dict,
                           dense_fallback) -> SparseResult:
        """Class-hit rows → per-subscriber :class:`SparseResult`.

        Each row names an accept class; ``offsets``/``members`` is the
        class → subscriber CSR, expanded with one ``np.repeat``: a row
        with k subscribers becomes k (doc, id) rows, sorted by (doc, id),
        so the result does not depend on the order the card emitted the
        rows in.  Overflow (``count > cap``) is recomputed densely, exact
        but unbounded, as ``path="dense-overflow"``.
        """
        if count > cap:
            sp = dense_fallback().sparsify()
            sp.overflowed = True
            sp.meta.update(meta, match_cap=cap, device_rows=int(count),
                           attempted_path=meta.get("path"),
                           path="dense-overflow")
            return sp
        docs, cls, first = (np.asarray(b)[:count] for b in bufs)
        meta = dict(meta, match_cap=cap, device_rows=int(docs.shape[0]))
        reps = (offsets[1:] - offsets[:-1])[cls]
        total = int(reps.sum())
        hit = np.repeat(np.arange(cls.shape[0]), reps)
        within = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
        qids = members[offsets[cls][hit] + within]
        docs, first = docs[hit], first[hit]
        order = np.lexsort((qids, docs))
        return SparseResult(docs[order], qids[order], first[order],
                            batch_size=batch_size, n_queries=self.n_queries,
                            meta=meta)

    def filter_batch_sparse(self, batch: EventBatch, *,
                            match_cap: int | None = None) -> SparseResult:
        """Events → bounded match list.  K4 emits it from the kernel
        (``path="kernel-fused"``: no accept bitmap leaves the kernel);
        caps past the epilogue rule compact K1's lanes on the device
        instead (``"lane-compact"``).  Both move O(cap) rows to the host,
        not O(B·Q)."""
        events = self._events(batch)
        lane_cls, offsets, members = self._plain_lane_tables(self.plan_)
        b = batch.batch_size
        cap = self.match_cap(b, self.n_queries, match_cap)
        tables = self._block_tables()
        depth = self.plan_.meta["max_depth"]
        if self._fused_sparse_ok(cap):
            doc_ids = torch.arange(b, dtype=torch.int32,
                                   device=events.device)[:, None]
            buf, cnt = sf.stream_filter_sparse(
                events, doc_ids, *tables, lane_cls, cap=cap, max_depth=depth)
            bufs, n = _device_rows(buf, cnt, cap)
            path = "kernel-fused"
        else:
            mb, fb = sf.stream_filter(events, *tables, max_depth=depth)
            *bufs, n = base._compact_matches(
                mb.reshape(b, -1) != 0, fb.reshape(b, -1),
                lane_cls.reshape(-1), cap)
            bufs, n = [x.cpu().numpy() for x in bufs], int(n)
            path = "lane-compact"
        return self._expand_class_hits(
            bufs, n, cap, offsets, members, batch_size=b,
            meta={"path": path},
            dense_fallback=lambda: self.filter_batch(batch))

    def filter_bytes_sparse(self, bb: ByteBatch, *,
                            bucket: int | None = None,
                            match_cap: int | None = None,
                            pack: bool | None = None) -> SparseResult:
        """Raw wire bytes → bounded match list in ONE K3 launch: no event
        tensor and no accept bitmap exist outside the kernel
        (``path="kernel-fused"``, ``launch="bytes"``).  Segment-packed
        batches ride along: ``doc_map`` names each packed slot's batch
        row (``-1`` = unused, emits nothing).  ``fuse=False`` and caps
        past the epilogue rule parse on the device (K5) and take
        :meth:`filter_batch_sparse`, which records its own path.
        """
        b = bb.batch_size
        cap = self.match_cap(b, self.n_queries, match_cap)
        if not (self._fused_bytes_on() and self._fused_sparse_ok(cap)):
            return super().filter_bytes_sparse(bb, bucket=bucket,
                                               match_cap=match_cap)
        data, starts, spk = self._bytes_prep(bb, pack)
        doc_map = (spk.doc_ids if spk is not None
                   else np.arange(b, dtype=np.int32)[:, None])
        lane_cls, offsets, members = self._plain_lane_tables(self.plan_)
        buf, cnt = sf.stream_filter_bytes_sparse(
            self.to_device(data), self.to_device(starts),
            self.to_device(doc_map), *self._block_tables(), lane_cls,
            cap=cap, max_depth=self.plan_.meta["max_depth"])
        bufs, n = _device_rows(buf, cnt, cap)
        return self._expand_class_hits(
            bufs, n, cap, offsets, members, batch_size=b,
            meta={"path": "kernel-fused", "launch": "bytes"},
            dense_fallback=lambda: self.filter_bytes(bb, pack=pack))
