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
        self._layout_cache: dict = {}
        known = set(TUNABLE_KEYS) | set(CALL_KEYS) | {"minimize"}
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
        return self._plan_padded(nfa, {})

    def _plan_padded(self, nfa: NFA, pads) -> base.FilterPlan:
        """The plan, its block layout at the uniform targets of ``pads``
        (``blk``, ``n_blocks``, ``block_queries``) when a sharded part is
        compiled, so that per-part tables stack."""
        from ...convert import plan_from_numpy  # convert imports this package

        nfa = pad_states(nfa, self.state_multiple)
        cfg = self.kernel_config(nfa.n_states, nfa.n_tags)
        mk = blocks_mod.state_layout(
            nfa, blk=int(pads.get("blk", cfg["blk"])),
            n_blocks=pads.get("n_blocks"),
            block_queries=pads.get("block_queries"))
        tables = dict(kb_tagmask=mk.tagmask, kb_pw=mk.pw, kb_pb=mk.pb,
                      kb_selfloop=mk.selfloop_words, kb_init=mk.init_words,
                      kb_acc_word=mk.acc_word, kb_acc_bit=mk.acc_bit,
                      kb_acc_block=mk.acc_block, kb_acc_slot=mk.acc_slot)
        meta = dict(cfg, n_states=nfa.n_states, max_depth=self.max_depth,
                    state_multiple=self.state_multiple, blk=mk.blk,
                    n_blocks=mk.n_blocks, block_queries=mk.block_queries)
        return plan_from_numpy(tables, meta, self.device)

    # ------------------------------------------------------- sharded hooks
    def _kernel_pad_targets(self, parts, pads, *, min_blk: int = 0) -> dict:
        """Uniform block-layout targets for ``parts`` at the given
        (``n_states``, ``n_tags``) pads: one block size (the policy's,
        grown to every part's largest subtree and to ``min_blk``), then
        the block count and accept-lane width each part needs at that
        size, jointly derived, so the set is always feasible."""
        cfg = self.kernel_config(pads["n_states"], pads["n_tags"])
        n = int(pads["n_states"])
        blk = max([int(cfg["blk"]), int(min_blk)]
                  + [self._part_layout(nfa, n)[0] for nfa in parts])
        dims = [self._part_layout(nfa, n, blk) for nfa in parts]
        return {"blk": max([blk] + [lo[0] for lo in dims]),
                "n_blocks": base._round_up(max(lo[1] for lo in dims), 2),
                "block_queries": base._round_up(
                    max(lo[2] for lo in dims), 8)}

    def _part_layout(self, nfa: NFA, n_states: int, blk: int | None = None
                     ) -> tuple[int, ...]:
        """One part padded to ``n_states``: ``(min_block_size,)``, or, at
        ``blk``, its layout's ``(blk, n_blocks, block_queries)``.

        Memoised by the part's NFA object: a subscribe recompiles one
        part, and the other parts' NFAs, and so their layouts, are the
        same objects as before, so the layout work of a subscribe is one
        part's, not every part's."""
        key = (id(nfa), int(n_states), blk)
        with self._memo_lock:
            hit = self._layout_cache.get(key)
        if hit is not None and hit[0] is nfa:
            return hit[1]
        padded = pad_states(nfa, to=n_states)
        if blk is None:
            val = (blocks_mod.min_block_size(padded),)
        else:
            lo = blocks_mod.state_layout(padded, blk=blk)
            val = (lo.blk, lo.n_blocks, lo.block_queries)
        with self._memo_lock:
            if len(self._layout_cache) >= 256:
                self._layout_cache.pop(next(iter(self._layout_cache)))
            self._layout_cache[key] = (nfa, val)
        return val

    def part_pads(self, parts, *, query_bucket: int = 8):
        """Uniform pad targets, the block axes included: the per-part
        block tables stack, so all parts agree on the tag space, the
        block size, the block count and the accept-lane width; each
        target is bucketed so churn rarely forces an all-parts replan."""
        pads = super().part_pads(parts, query_bucket=query_bucket)
        pads["n_tags"] = base._round_up(
            max((nfa.n_tags for nfa in parts), default=1), 64)
        pads.update(self._kernel_pad_targets(parts, pads))
        return pads

    def merge_pads(self, old, new, parts):
        """Churn reconcile: the per-key maximum of the independent
        targets, then the block layout re-derived at the merged block
        size (a per-key maximum of layouts derived at different block
        sizes can be infeasible: bigger blocks pack more subtrees and
        need more accept lanes)."""
        merged = super().merge_pads(old, new, parts)
        if "blk" not in merged:
            return merged
        targets = self._kernel_pad_targets(
            parts, {"n_states": merged["n_states"],
                    "n_tags": merged["n_tags"]},
            min_blk=merged["blk"])
        # monotone growth against the old buckets, never below what the
        # merged block size needs
        for k, v in targets.items():
            merged[k] = max(merged.get(k, 0), v)
        return merged

    def _pad_plan_queries(self, plan: base.FilterPlan,
                          n_queries: int) -> base.FilterPlan:
        """Pad the query axis: the new columns read every block's reserved
        inert lane (``QB-1``, wired to the local root), which never
        accepts."""
        ab, sl = plan["kb_acc_block"], plan["kb_acc_slot"]
        extra = n_queries - int(ab.shape[0])
        if extra <= 0:
            return plan
        qb = int(plan.meta["block_queries"])
        tables = plan.tables
        tables["kb_acc_block"] = torch.cat([ab, ab.new_zeros(extra)])
        tables["kb_acc_slot"] = torch.cat([sl, sl.new_full((extra,),
                                                           qb - 1)])
        return base.FilterPlan(plan.engine, tables, plan.meta)

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
        return self._stage_events(batch.kind, batch.tag_id)

    def _stage_events(self, kind: np.ndarray, tag: np.ndarray
                      ) -> torch.Tensor:
        events = sf.fuse_events(torch.from_numpy(np.asarray(kind)),
                                torch.from_numpy(np.asarray(tag)))
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
                           dense_fallback, n_queries: int | None = None,
                           live_ids=None) -> SparseResult:
        """Class-hit rows → per-subscriber :class:`SparseResult`.

        Each row names an accept class; ``offsets``/``members`` is the
        class → subscriber CSR (columns, or global ids of a sharded plan
        with ``live_ids``), expanded with one ``np.repeat``: a row with k
        subscribers becomes k (doc, id) rows, sorted by (doc, id), so the
        result does not depend on the order the card emitted the rows in.
        Overflow (``count > cap``) is recomputed densely, exact but
        unbounded, as ``path="dense-overflow"``.
        """
        n_queries = self.n_queries if n_queries is None else n_queries
        if count > cap:
            sp = dense_fallback().sparsify(live_ids)
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
                            batch_size=batch_size, n_queries=n_queries,
                            live_ids=(None if live_ids is None
                                      else np.asarray(live_ids, np.int32)),
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

    # -------------------------------------------------------- sharded runs
    # A stacked plan's block tables are (P, G, ...): folded to (P·G, ...)
    # they are one plan of P·G state blocks, and the kernels put the
    # block on the grid's x axis, so every part runs in ONE launch.  The
    # lanes come back (..., P·G, QB) and the live columns are gathered by
    # their flat lane index.

    @staticmethod
    def _folded(stacked: base.FilterPlan) -> tuple[torch.Tensor, ...]:
        """The stacked block tables with the part axis folded into the
        block axis (views, no copy)."""
        return tuple(stacked[k].flatten(0, 1) for k in (
            "kb_tagmask", "kb_pw", "kb_pb", "kb_selfloop", "kb_init",
            "kb_acc_word", "kb_acc_bit"))

    def _live_lanes(self, sharded: base.ShardedPlan) -> torch.Tensor:
        """(Q_live,) flat index into the folded (P·G·QB) lanes of each
        live column, in global-id order."""

        def build():
            stacked = sharded.stacked()
            part, local = sharded.index_arrays()
            ab = stacked["kb_acc_block"].cpu().numpy().astype(np.int64)
            sl = stacked["kb_acc_slot"].cpu().numpy().astype(np.int64)
            g = int(stacked.meta["n_blocks"])
            qb = int(stacked.meta["block_queries"])
            flat = (part * g + ab[part, local]) * qb + sl[part, local]
            return torch.from_numpy(flat).to(sharded.device)

        return self._lane_memo(sharded, build, "live-lanes")

    def _sharded_lanes_to_queries(self, mb: torch.Tensor, fb: torch.Tensor,
                                  sharded: base.ShardedPlan
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., P·G, QB) folded lanes → (..., Q_live) verdicts."""
        flat = self._live_lanes(sharded)
        lead = mb.shape[:-2]
        return (mb.reshape(*lead, -1)[..., flat] != 0,
                fb.reshape(*lead, -1)[..., flat])

    def _sharded_lane_tables(self, sharded: base.ShardedPlan):
        """Lane tables of a stacked sharded plan: ((P, G, QB) lane →
        class tensor on the device, class-member CSR on the host).

        Each part's accept classes get disjoint ids (part-local id plus a
        running offset), in the folded lane order, and the members are
        **global subscriber ids** with tombstoned columns dropped, so one
        compaction over the folded lanes expands straight to (doc, gid)
        rows."""

        def build():
            gcols = sharded.gid_columns()
            lanes, member_parts, counts_parts = [], [], []
            off = 0
            for p, plan in enumerate(sharded.plans):
                class_of, lane_cls = _lane_classes(plan)
                n_cls = int(lane_cls.max(initial=-1)) + 1
                lanes.append(np.where(lane_cls >= 0, lane_cls + off, -1))
                valid = class_of >= 0
                order = np.argsort(class_of[valid], kind="stable")
                cols = np.flatnonzero(valid)[order]
                cls = class_of[valid][order]
                gids = gcols[p, cols]
                keep = gids >= 0          # drop tombstoned subscribers
                member_parts.append(gids[keep].astype(np.int32))
                counts_parts.append(np.bincount(cls[keep], minlength=n_cls))
                off += n_cls
            offsets = np.concatenate(([0], np.cumsum(
                np.concatenate(counts_parts))))
            members = np.concatenate(member_parts)
            return (torch.from_numpy(np.stack(lanes).astype(np.int32)).to(
                sharded.device), offsets, members)

        return self._lane_memo(sharded, build, "sharded-lanes")

    def filter_batch_sharded(self, batch: EventBatch, sharded, *,
                             mesh=None) -> FilterResult:
        """Events → ``(B, Q_live)`` through ONE K1 launch over the P·G
        folded blocks."""
        base._check_mesh(mesh)
        sharded.wait()
        stacked = sharded.stacked()
        mb, fb = sf.stream_filter(self._events(batch), *self._folded(stacked),
                                  max_depth=stacked.meta["max_depth"])
        m, f = self._sharded_lanes_to_queries(mb, fb, sharded)
        return FilterResult(m.cpu().numpy(), f.cpu().numpy())

    def filter_batch_sharded_sparse(self, batch: EventBatch, sharded, *,
                                    mesh=None, match_cap: int | None = None
                                    ) -> SparseResult:
        """Events → bounded match list of global ids, ONE launch: K4 over
        the folded blocks (``"kernel-fused"``), or, for caps past the
        epilogue rule, K1's folded lanes compacted on the device
        (``"lane-compact"``); an overflow recomputes densely."""
        base._check_mesh(mesh)
        sharded.wait()
        stacked = sharded.stacked()
        events = self._events(batch)
        lane_cls, offsets, members = self._sharded_lane_tables(sharded)
        live_ids = sharded.live_ids()
        b = batch.batch_size
        cap = self.match_cap(b, len(live_ids), match_cap)
        tables = self._folded(stacked)
        depth = stacked.meta["max_depth"]
        if self._fused_sparse_ok(cap, stacked):
            doc_ids = torch.arange(b, dtype=torch.int32,
                                   device=events.device)[:, None]
            buf, cnt = sf.stream_filter_sparse(
                events, doc_ids, *tables, lane_cls.flatten(0, 1), cap=cap,
                max_depth=depth)
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
            n_queries=len(live_ids), live_ids=live_ids, meta={"path": path},
            dense_fallback=lambda: self.filter_batch_sharded(batch, sharded))

    def filter_bytes_sharded(self, bb: ByteBatch, sharded, *,
                             bucket: int | None = None,
                             mesh=None) -> FilterResult:
        """Raw bytes → ``(B, Q_live)`` in ONE K2 launch over the folded
        blocks (segment-packed under the ``pack=`` option); with
        ``fuse=False``, the device parse then the folded K1."""
        base._check_mesh(mesh)
        if not self._fused_bytes_on():
            return super().filter_bytes_sharded(bb, sharded, bucket=bucket)
        sharded.wait()
        stacked = sharded.stacked()
        data, starts, sp = self._bytes_prep(bb, None)
        mb, fb = sf.stream_filter_bytes(
            self.to_device(data), self.to_device(starts),
            *self._folded(stacked), max_depth=stacked.meta["max_depth"])
        # (S, P·G, D, QB) → (S, D, P·G, QB) → (S, D, Q_live)
        m, f = (x.cpu().numpy() for x in self._sharded_lanes_to_queries(
            mb.transpose(1, 2), fb.transpose(1, 2), sharded))
        if sp is None:
            return FilterResult(m[:, 0], f[:, 0])
        return FilterResult(*sp.scatter(m, f, NO_MATCH))

    def filter_bytes_sharded_sparse(self, bb: ByteBatch, sharded, *,
                                    bucket: int | None = None, mesh=None,
                                    match_cap: int | None = None
                                    ) -> SparseResult:
        """Raw bytes → bounded match list of global ids in ONE K3 launch
        over the folded blocks; ``fuse=False`` and caps past the epilogue
        rule parse on the device and take
        :meth:`filter_batch_sharded_sparse`."""
        base._check_mesh(mesh)
        live_ids = sharded.live_ids()
        b = bb.batch_size
        cap = self.match_cap(b, len(live_ids), match_cap)
        stacked = sharded.stacked()
        if not (self._fused_bytes_on()
                and self._fused_sparse_ok(cap, stacked)):
            return super().filter_bytes_sharded_sparse(
                bb, sharded, bucket=bucket, match_cap=match_cap)
        sharded.wait()
        data, starts, spk = self._bytes_prep(bb, None)
        doc_map = (spk.doc_ids if spk is not None
                   else np.arange(b, dtype=np.int32)[:, None])
        lane_cls, offsets, members = self._sharded_lane_tables(sharded)
        buf, cnt = sf.stream_filter_bytes_sparse(
            self.to_device(data), self.to_device(starts),
            self.to_device(doc_map), *self._folded(stacked),
            lane_cls.flatten(0, 1), cap=cap,
            max_depth=stacked.meta["max_depth"])
        bufs, n = _device_rows(buf, cnt, cap)
        return self._expand_class_hits(
            bufs, n, cap, offsets, members, batch_size=b,
            n_queries=len(live_ids), live_ids=live_ids,
            meta={"path": "kernel-fused", "launch": "bytes"},
            dense_fallback=lambda: self.filter_bytes_sharded(bb, sharded))

    def filter_documents_batched(self, kind: np.ndarray,
                                 tag: np.ndarray) -> FilterResult:
        """Raw ``(B, N)`` kind and tag arrays → ``(B, Q)`` verdicts through
        K1 (the JAX package's legacy batched API; prefer
        :meth:`filter_batch`)."""
        mb, fb = sf.stream_filter(
            self._stage_events(np.asarray(kind).astype(np.int32),
                               np.asarray(tag).astype(np.int32)),
            *self._block_tables(), max_depth=self.plan_.meta["max_depth"])
        m, f = self._lanes_to_queries(mb, fb)
        return FilterResult(m.cpu().numpy(), f.cpu().numpy())
