"""Pub-sub content routing as a pipeline stage, on the port's engines.

Counterpart of ``src/repro/data/filter_stage.py``: a stream of
documents is matched against standing profiles and each document is
routed to every data shard that holds a matching subscription.
:meth:`FilterStage.route` takes host-parsed event
streams, :meth:`FilterStage.route_bytes` raw paper-format byte payloads
decoded on the device by the engine's ``filter_bytes``.  Verdicts come
back dense, or with ``sparse=True`` as bounded match lists (the engines'
``filter_*_sparse``); routing is the same either way.  Engines come from
the port's registry.

Subscriptions churn live: :meth:`FilterStage.prepare_subscribe` /
:meth:`~FilterStage.prepare_unsubscribe` build the replacement engine off
the hot path and :meth:`~FilterStage.commit` installs it atomically at a
new :class:`PlanEpoch`; a batch pinned to an epoch filters and fans out
with that epoch's engine and gid table even after a later commit, which
is what the serve loop's hot swap rests on (:mod:`repro_torch.serve`).
``query_shards > 1`` partitions the subscriptions into that many parts
(:meth:`FilterEngine.plan_sharded`), all run in one launch on one card;
a subscribe then recompiles one part, an unsubscribe only tombstones,
and :meth:`FilterStage.maybe_rebalance` evens the parts' load.
``data_shards > 1`` also spreads the documents: the stage filters
through the 2-D ``("data", "model")`` mesh
(:class:`~repro_torch.launch.mesh.FilterMesh`, built by
:func:`~repro_torch.launch.mesh.make_filter_mesh` when none is given),
one launch per mesh position, and :meth:`FilterStage.
route_bytes_pipelined` keeps up to ``pipeline_depth`` batches in flight
on it, staging batch *k+1* while batch *k* filters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from .. import tracing
from ..core import engines
from ..core.dictionary import TagDictionary
from ..core.engines import FilterResult, SparseResult
from ..core.events import (ByteBatch, EventBatch, EventStream,
                           event_stream_nbytes)
from ..core.nfa import NFA, compile_queries
from ..core.xpath import Query, parse

TEXT_FILL = 8  # filler text bytes per element in the MB/s accounting


@dataclass
class RoutedDocument:
    doc_index: int
    matched_profiles: np.ndarray       # (n_matched,) int32 profile indices
    shard: int                         # destination data shard
    nbytes: int


class StalePlanError(RuntimeError):
    """A prepared plan's base epoch no longer matches the live plan.

    Raised by :meth:`FilterStage.commit` when another commit landed
    between ``prepare_*`` and ``commit`` — the pending plan was built
    against a subscription set that no longer exists.  The caller
    re-prepares against the current plan (the synchronous churn methods
    do this automatically; the serve loop's shadow builder records it as
    a rollback)."""


@dataclass
class PlanEpoch:
    """Immutable snapshot of the live plan, taken at dispatch time.

    A batch dispatched against epoch *E* filters with *E*'s engine,
    sharded plan and gid mapping even if churn commits a replacement
    mid-flight — verdict columns and the gid axis always agree."""

    epoch: int
    eng: Any
    sharded: Any                       # ShardedPlan | None
    gids: np.ndarray


@dataclass
class PendingPlan:
    """A fully built replacement plan awaiting an atomic commit.

    Produced off the hot path by ``prepare_subscribe`` /
    ``prepare_unsubscribe`` / ``prepare_rebalance`` — the expensive work
    (NFA compile, part re-plan, rebalance migration, the tables' copy to
    the device) happens during *prepare*, against a snapshot, without
    mutating the stage; ``commit`` is a handful of reference assignments
    under the plan mutex."""

    op: str                            # "subscribe" | "unsubscribe" | "rebalance"
    base_epoch: int
    gid: int | None = None
    stats: dict | None = None          # rebalance stats
    sharded: Any = None                # replacement ShardedPlan
    eng: Any = None                    # replacement engine (unsharded)
    nfa: Any = None
    live: dict | None = None
    gids: np.ndarray | None = None
    build_s: float = 0.0


@dataclass
class FilterStage:
    """Standing-profile filter + router over a registered port engine.

    ``shard_of_profile[q]`` maps each subscription to a destination shard
    (defaults to round-robin).  A document goes to every shard that has at
    least one matching subscription; unmatched documents are dropped
    (classic pub-sub) or sent to shard 0 with ``keep_unmatched=True``.
    ``bucket`` pads each event batch to a multiple of that length (and
    reaches the engine's byte paths as its ``event_bucket=``),
    ``byte_bucket`` each byte batch; ``device`` is where the engine runs
    (``"cuda"`` unless the caller asks for ``"cpu"``).  ``sparse=True``
    delivers verdicts as bounded ``(doc, query)`` match lists, with the
    bound from ``engine_options={"match_cap": ...}``.

    ``query_shards > 1`` partitions the subscription set into that many
    balanced parts and filters through the engine's sharded path: on one
    card every part runs in one launch.  Routing is by **global query
    id** through the partition index, so documents fan out identically
    with and without query sharding.  Churn then recompiles only the
    least-loaded part (:meth:`subscribe`) or tombstones
    (:meth:`unsubscribe`); unsharded, it recompiles the whole engine.

    ``data_shards > 1`` filters through the 2-D (data × model) path
    (:meth:`FilterEngine.filter_batch_sharded2d`): documents spread over
    the mesh's ``"data"`` axis while each position keeps its slice of the
    parts, the paper's §3.5 replication in both dimensions.  ``mesh`` is
    built when sharding asks for one and none is given
    (:func:`~repro_torch.launch.mesh.make_filter_mesh` on ``device``);
    one card places a 1 × 1 mesh, and a wider grid over one device is a
    :class:`~repro_torch.launch.mesh.FilterMesh` with the device
    repeated.  The bytes path gets a pipelined route on top:
    :meth:`route_bytes_pipelined`.
    """

    profiles: Sequence[Query]
    dictionary: TagDictionary
    n_shards: int = 1
    engine: str = "streaming"
    keep_unmatched: bool = False
    batch_size: int = 32
    bucket: int = 128
    byte_bucket: int = 1024
    query_shards: int = 1
    data_shards: int = 1
    #: in-flight depth of :meth:`route_bytes_pipelined` — how many
    #: dispatched-but-unmaterialized batches it keeps (2 = the classic
    #: double buffer)
    pipeline_depth: int = 2
    mesh: Any = None
    device: str = "cuda"
    shard_of_profile: np.ndarray = field(default=None)  # type: ignore
    stats: dict = field(default_factory=dict)
    #: deliver verdicts as sparse match lists (``filter_*_sparse``)
    sparse: bool = False
    #: run :meth:`maybe_rebalance` every N churn ops (0 = manual only);
    #: ``rebalance_tolerance`` is the max/mean-1 imbalance the plan may
    #: have before trie groups migrate between query shards
    rebalance_every: int = 0
    rebalance_tolerance: float = 0.25
    #: extra engine options (e.g. ``{"pack": True}``, ``{"match_cap": n}``)
    engine_options: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if isinstance(self.profiles[0], str):
            self.profiles = [parse(p) for p in self.profiles]
        # live subscription set, keyed by stable global query id; ids are
        # never reused (monotonic counter)
        self._live: dict[int, Query] = dict(enumerate(self.profiles))
        self._next_gid = len(self.profiles)
        self._gids = np.arange(len(self.profiles), dtype=np.int32)
        self.nfa: NFA = compile_queries(list(self.profiles), self.dictionary,
                                        shared=True)
        self._eng = self._make_engine(self.nfa)
        self._churn_ops = 0
        sharding = self.query_shards > 1 or self.data_shards > 1
        if sharding and self.mesh is None:
            from ..launch.mesh import make_filter_mesh

            # n_parts caps the model axis at the part count (a monolithic
            # plan gets a 1-wide model axis, every device on "data")
            self.mesh = make_filter_mesh(max(1, self.query_shards),
                                         data_shards=self.data_shards,
                                         device=self.device)
        # the data axis needs a sharded plan even with one query part
        self.sharded_ = (self._eng.plan_sharded(max(1, self.query_shards))
                         if sharding else None)
        if self.shard_of_profile is None:
            self.shard_of_profile = (
                np.arange(len(self.profiles)) % self.n_shards).astype(np.int32)
        self.stats = {"batches": 0, "docs": 0, "bytes": 0,
                      "seconds": 0.0, "pair_matches": 0, "pairs": 0,
                      "put_seconds": 0.0, "overlapped_batches": 0,
                      "verdict_bytes": 0, "device_rows": 0, "paths": {},
                      "rebalances": 0}
        # plan epoch: bumped on every committed plan change; the mutex
        # covers only snapshot/commit (reference assignments), never a
        # compile — prepare_* does the expensive work outside it
        self._plan_mtx = threading.Lock()
        self._epoch = 0

    def _make_engine(self, nfa: NFA):
        # event_bucket threads this stage's bucket into the engine's byte
        # paths, so every ingest path pads to the same boundaries
        return engines.create(self.engine, nfa, dictionary=self.dictionary,
                              device=self.device, event_bucket=self.bucket,
                              **self.engine_options)

    # --------------------------------------------------- subscription churn
    def plan_epoch(self) -> PlanEpoch:
        """Consistent (epoch, engine, sharded plan, gids) snapshot for
        dispatch.

        A batch filtered against this snapshot and fanned out with its
        ``gids`` is correct even if a plan swap commits while the batch
        is in flight."""
        with self._plan_mtx:
            return PlanEpoch(self._epoch, self._eng, self.sharded_,
                             self._gids)

    def _prepare(self, op: str, base: int, live: dict, gid: int,
                 t0: float) -> PendingPlan:
        """Compile the full replacement engine over ``live`` (the
        unsharded stage's only way to change its subscription set)."""
        gids = sorted(live)
        nfa = compile_queries([live[g] for g in gids], self.dictionary,
                              shared=True)
        return PendingPlan(op, base, gid=gid, eng=self._make_engine(nfa),
                           nfa=nfa, live=live,
                           gids=np.asarray(gids, np.int32),
                           build_s=time.perf_counter() - t0)

    def prepare_subscribe(self, profile: Query | str) -> PendingPlan:
        """Build (but do not install) the plan that adds ``profile``.

        Pure with respect to the stage: sharded stages re-plan only the
        least-loaded part (:meth:`ShardedPlan.add_queries`, whose new
        stacked tables leave the live plan's untouched), unsharded stages
        compile the full replacement engine — either way against a
        snapshot, so a failed build (e.g. a rejected profile) leaves the
        live plan untouched with nothing to roll back."""
        q = parse(profile) if isinstance(profile, str) else profile
        t0 = time.perf_counter()
        with self._plan_mtx:
            base = self._epoch
            sharded = self.sharded_
            live = dict(self._live)
            gid = self._next_gid
        if sharded is not None:
            sp, new = sharded.add_queries([q])
            gid = new[0]
            live[gid] = q
            return PendingPlan("subscribe", base, gid=gid, sharded=sp,
                               live=live, gids=sp.live_ids(),
                               build_s=time.perf_counter() - t0)
        live[gid] = q
        return self._prepare("subscribe", base, live, gid, t0)

    def prepare_unsubscribe(self, gid: int) -> PendingPlan:
        """Build the plan that drops ``gid`` (a tombstone when sharded)."""
        if gid not in self._live:
            raise KeyError(f"query id {gid} is not subscribed")
        t0 = time.perf_counter()
        with self._plan_mtx:
            base = self._epoch
            sharded = self.sharded_
            live = dict(self._live)
        del live[gid]
        if sharded is not None:
            sp = sharded.remove_queries([gid])
            return PendingPlan("unsubscribe", base, gid=gid, sharded=sp,
                               live=live, gids=sp.live_ids(),
                               build_s=time.perf_counter() - t0)
        return self._prepare("unsubscribe", base, live, gid, t0)

    def prepare_rebalance(self, *, tolerance: float | None = None
                          ) -> PendingPlan | None:
        """Build the rebalanced plan (sharded stages only, else ``None``).

        ``pending.sharded`` is ``None`` when no trie group needed to move:
        committing such a plan changes nothing and returns the stats."""
        if self.sharded_ is None:
            return None
        tol = self.rebalance_tolerance if tolerance is None else tolerance
        t0 = time.perf_counter()
        with self._plan_mtx:
            base = self._epoch
            sharded = self.sharded_
        new, stats = sharded.rebalance(tolerance=tol)
        moved = bool(stats["moves"])
        return PendingPlan("rebalance", base, stats=stats,
                           sharded=new if moved else None,
                           gids=new.live_ids() if moved else None,
                           build_s=time.perf_counter() - t0)

    def commit(self, pending: PendingPlan, shard: int | None = None):
        """Atomically install a prepared plan at the current epoch.

        A handful of reference assignments under the plan mutex —
        batches dispatched against the previous :meth:`plan_epoch`
        snapshot keep filtering the old plan; the next snapshot sees the
        new one (whose readers wait for its tables on the device:
        :meth:`FilterEngine.wait_plan`, :meth:`ShardedPlan.wait`).  Raises
        :class:`StalePlanError` (leaving the live plan untouched) if
        another commit landed since ``prepare_*``.  Returns the gid for
        churn, the stats dict for a rebalance."""
        with self._plan_mtx:
            if pending.base_epoch != self._epoch:
                raise StalePlanError(
                    f"plan prepared against epoch {pending.base_epoch}, "
                    f"live plan is at {self._epoch}; re-prepare")
            if pending.op == "rebalance":
                if pending.sharded is not None:
                    self.sharded_ = pending.sharded
                    self._gids = pending.gids
                    self.stats["rebalances"] += 1
                    self._epoch += 1
                return pending.stats
            self._live = pending.live
            if pending.sharded is not None:
                self.sharded_ = pending.sharded
            else:
                self.nfa = pending.nfa
                self._eng = pending.eng
            self._gids = pending.gids
            self._epoch += 1
            if pending.op == "subscribe":
                self._next_gid = max(self._next_gid, pending.gid + 1)
                self._grow_shard_map(pending.gid, shard)
            return pending.gid

    def subscribe(self, profile: Query | str, shard: int | None = None) -> int:
        """Add a standing profile live; returns its global query id.

        Sharded stages recompile only the least-loaded part; unsharded
        stages pay the full recompile — the cost gap is the point of
        query sharding.  Prepare/commit under the hood: a failed build
        never touches the live plan, and a concurrent commit just means
        one re-prepare."""
        while True:
            pending = self.prepare_subscribe(profile)
            try:
                gid = self.commit(pending, shard=shard)
                break
            except StalePlanError:
                continue
        self._after_churn()
        return gid

    def unsubscribe(self, gid: int) -> None:
        """Remove a subscription by global id (a tombstone when sharded,
        else a full recompile)."""
        while True:
            pending = self.prepare_unsubscribe(gid)
            try:
                self.commit(pending)
                break
            except StalePlanError:
                continue
        self._after_churn()

    def _after_churn(self) -> None:
        self._churn_ops += 1
        if (self.rebalance_every
                and self._churn_ops >= self.rebalance_every):
            self._churn_ops = 0
            self.maybe_rebalance()

    def maybe_rebalance(self, *, tolerance: float | None = None
                        ) -> dict | None:
        """Off-hot-path shard-load repair (sharded stages only).

        Runs :meth:`ShardedPlan.rebalance` against the live plan and, if
        any trie groups moved, swaps the new frozen plan in with one
        reference assignment — batches already dispatched keep filtering
        the old plan, and verdicts and routing are identical either way.
        Returns the rebalance stats, or ``None`` when the stage is
        unsharded.
        """
        while True:
            pending = self.prepare_rebalance(tolerance=tolerance)
            if pending is None:
                return None
            try:
                return self.commit(pending)
            except StalePlanError:
                continue

    def _grow_shard_map(self, gid: int, shard: int | None) -> None:
        if gid >= len(self.shard_of_profile):
            extra = np.arange(len(self.shard_of_profile), gid + 1)
            self.shard_of_profile = np.concatenate(
                [self.shard_of_profile,
                 (extra % self.n_shards).astype(np.int32)])
        if shard is not None:
            self.shard_of_profile[gid] = shard

    # ----------------------------------------------------------------- run
    def _filter_batch(self, docs: list[EventStream], record: bool = True
                      ) -> FilterResult | SparseResult:
        """Events path: every engine gets one EventBatch.  ``record=False``
        keeps metric-only reads (:meth:`selectivity`) out of the routing
        stats."""
        with self._plan_mtx:
            eng, sharded = self._eng, self.sharded_
        batch = EventBatch.from_streams(docs, bucket=self.bucket)
        t0 = time.perf_counter()
        eng.wait_plan()
        if self.data_shards > 1:
            res = (eng.filter_batch_sharded2d_sparse if self.sparse
                   else eng.filter_batch_sharded2d)(batch, sharded,
                                                    mesh=self.mesh)
        elif sharded is not None:
            res = (eng.filter_batch_sharded_sparse if self.sparse
                   else eng.filter_batch_sharded)(batch, sharded,
                                                  mesh=self.mesh)
        else:
            res = (eng.filter_batch_sparse if self.sparse
                   else eng.filter_batch)(batch)
        if record:
            self._record(res, batch.batch_size,
                         int(batch.nbytes(TEXT_FILL).sum()),
                         time.perf_counter() - t0)
        return res

    def _filter_bytebatch(self, bufs: list[bytes], record: bool = True,
                          epoch: PlanEpoch | None = None
                          ) -> FilterResult | SparseResult:
        """Device-ingest batched path: raw wire bytes in, verdicts out,
        decoded on the device by the engine's ``filter_bytes`` (its
        sharded twin when the stage is query-sharded, its 2-D twin with a
        data axis, whose sparse form is the gathered dense result,
        sparsified: ``path="dense-2d"``).  ``epoch`` pins the
        batch to a :meth:`plan_epoch` snapshot so a concurrent plan swap
        cannot tear engine/plan/gids mid-batch; the current stream waits
        for that plan's tables first."""
        ep = self.plan_epoch() if epoch is None else epoch
        eng, sharded = ep.eng, ep.sharded
        with tracing.span("stage.pack"):
            bb = ByteBatch.from_buffers(bufs, bucket=self.byte_bucket)
        t0 = time.perf_counter()
        eng.wait_plan()
        if self.data_shards > 1:
            res = eng.filter_bytes_sharded2d(bb, sharded, bucket=self.bucket,
                                             mesh=self.mesh)
            if self.sparse:
                res = res.sparsify(sharded.live_ids())
                res.meta["path"] = "dense-2d"
        elif sharded is not None:
            res = (eng.filter_bytes_sharded_sparse if self.sparse
                   else eng.filter_bytes_sharded)(bb, sharded,
                                                  bucket=self.bucket,
                                                  mesh=self.mesh)
        else:
            res = (eng.filter_bytes_sparse if self.sparse
                   else eng.filter_bytes)(bb, bucket=self.bucket)
        if record:
            self._record(res, bb.batch_size, bb.nbytes_total(),
                         time.perf_counter() - t0)
        return res

    def _record(self, res: FilterResult | SparseResult, n_docs: int,
                n_bytes: int, dt: float) -> None:
        """One accounting path for both ingest forms and both verdict
        forms, so throughput() stays comparable between them;
        ``verdict_bytes`` is what delivery moved (12 B a match sparse,
        5 B a (doc, query) pair dense); sparse batches also count the
        rows the device emitted and the path each took."""
        self.stats["batches"] += 1
        self.stats["docs"] += n_docs
        self.stats["bytes"] += n_bytes
        self.stats["seconds"] += dt
        if isinstance(res, SparseResult):
            self.stats["pair_matches"] += res.n_matches
            self.stats["pairs"] += res.batch_size * res.n_live
            self.stats["verdict_bytes"] += res.verdict_bytes
            self.stats["device_rows"] += int(res.meta.get("device_rows", 0))
            path = res.meta.get("path")
            self.stats["paths"][path] = self.stats["paths"].get(path, 0) + 1
        else:
            self.stats["pair_matches"] += int(res.matched.sum())
            self.stats["pairs"] += res.matched.size
            self.stats["verdict_bytes"] += res.matched.size * 5

    def _chunks(self, items: Iterable) -> Iterator[list]:
        """Accumulate an (unbounded) iterable into batch_size chunks."""
        batch: list = []
        for item in items:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def route(self, docs: Iterable[EventStream]
              ) -> Iterator[list[RoutedDocument]]:
        """Yield routed batches; each doc may fan out to several shards."""
        base = 0
        for batch in self._chunks(docs):
            res = self._filter_batch(batch)
            yield self._fan_out(res, [event_stream_nbytes(d) for d in batch],
                                base)
            base += len(batch)

    def route_bytes(self, payloads: Iterable[bytes]
                    ) -> Iterator[list[RoutedDocument]]:
        """Route raw paper-format byte payloads (device-decode twin of
        :meth:`route`): each batch is decoded *and* filtered on the
        device, then fanned out to shards exactly like the event path.
        While a profiler runs, each batch is a ``stage.request`` span
        (:mod:`repro_torch.tracing`) holding ``stage.pack``, the engine's
        spans and ``stage.fan_out``."""
        base = 0
        for batch in self._chunks(payloads):
            with tracing.span("stage.request", root=True):
                res = self._filter_bytebatch(batch)
                routed = self._fan_out(res, [len(b) for b in batch], base)
            yield routed
            base += len(batch)

    # --------------------------------------------- the pipelined route
    def _stage_in(self, bufs: list[bytes]):
        """Host-side staging of one batch: pack, take the event bound (a
        host scan, done before placement so the device copies are never
        read back), then stage the rows over the mesh's ``"data"`` axis
        (:meth:`ByteBatch.device_put`: pinned, ``non_blocking`` copies on
        the positions' streams).  ``put_seconds`` times the staging's
        dispatch, not the transfer, which overlaps the batches in
        flight."""
        bb = ByteBatch.from_buffers(bufs, bucket=self.byte_bucket)
        n_events = bb.event_bound(bucket=self.bucket)
        t0 = time.perf_counter()
        placed = bb.device_put(self.mesh)
        self.stats["put_seconds"] += time.perf_counter() - t0
        return bufs, bb, placed, n_events

    def _dispatch_byte_batch(self, bufs: list[bytes]):
        """Stage one raw-byte batch (exactly once — ``put_seconds`` counts
        each batch's staging a single time) and launch the 2-D bytes
        filter on the positions of the mesh, against a :meth:`plan_epoch`
        snapshot.  Returns the in-flight entry the pipelined route
        materializes later."""
        ep = self.plan_epoch()
        bufs, bb, placed, n_events = self._stage_in(bufs)
        t0 = time.perf_counter()
        ep.eng.wait_plan()
        materialize = ep.eng.dispatch_bytes_sharded2d(
            placed, ep.sharded, mesh=self.mesh, n_events=n_events)
        return bufs, bb, materialize, t0, ep

    def _materialize_routed(self, entry, base: int) -> list[RoutedDocument]:
        """Wait for one in-flight batch's verdicts, account, fan out with
        the gids of the epoch it was filtered under."""
        bufs, bb, materialize, t0, ep = entry
        res = materialize()
        # slice off the data-axis pad rows before accounting and fan-out
        res = FilterResult(res.matched[:len(bufs)],
                           res.first_event[:len(bufs)])
        self._record(res, bb.batch_size, bb.nbytes_total(),
                     time.perf_counter() - t0)
        return self._fan_out(res, [len(b) for b in bufs], base, gids=ep.gids)

    def route_bytes_pipelined(self, payloads: Iterable[bytes], *,
                              depth: int | None = None
                              ) -> Iterator[list[RoutedDocument]]:
        """K-deep pipelined twin of :meth:`route_bytes` on the mesh: while
        batch *k* filters on the card, up to ``depth - 1`` successor
        batches are already packed, their copies queued and their launches
        dispatched.

        Per batch: (1) stage over the mesh and dispatch the 2-D bytes
        filter (:meth:`FilterEngine.dispatch_bytes_sharded2d`, which
        returns a materializer at once); (2) once ``depth`` batches are in
        flight, wait on the *oldest* one's position events and fan out
        (FIFO, so the routed order is :meth:`route_bytes`'s).  ``depth``
        defaults to :attr:`pipeline_depth`.  Each batch is staged exactly
        once, so ``put_seconds`` counts it once at any depth, and
        ``overlapped_batches`` counts the batches staged while a
        predecessor was still in flight; verdicts are dense.  Routes as
        :meth:`route_bytes` when the stage has no mesh to overlap on.
        """
        if self.mesh is None or self.sharded_ is None:
            yield from self.route_bytes(payloads)
            return
        k = max(1, self.pipeline_depth if depth is None else depth)
        # only the k batches in flight are held: an unbounded payload
        # stream yields verdicts batch by batch, as route_bytes does
        inflight: deque = deque()
        base = 0
        for bufs in self._chunks(payloads):
            if inflight:
                # a predecessor is still in flight while this batch stages:
                # the overlap the pipeline exists for
                self.stats["overlapped_batches"] += 1
            inflight.append(self._dispatch_byte_batch(bufs))
            if len(inflight) >= k:
                entry = inflight.popleft()
                yield self._materialize_routed(entry, base)
                base += len(entry[0])
        while inflight:
            entry = inflight.popleft()
            yield self._materialize_routed(entry, base)
            base += len(entry[0])

    def _fan_out(self, results: FilterResult | SparseResult,
                 nbytes: list[int], base: int = 0, *,
                 gids: np.ndarray | None = None,
                 seqs: Sequence[int] | None = None) -> list[RoutedDocument]:
        """Verdicts → routed documents, by global profile id.  ``gids``
        pins the live-column → global-id mapping to the epoch the batch
        was filtered under (defaults to the current plan); ``seqs``
        assigns explicit, possibly non-contiguous document indices (the
        serve loop's quarantine retries filter recovered subsets whose
        seqs are not ``base + i``)."""
        with tracing.span("stage.fan_out"):
            sparse = isinstance(results, SparseResult)
            live = self._gids if gids is None else gids
            out: list[RoutedDocument] = []
            for i, nb in enumerate(nbytes):
                doc = base + i if seqs is None else int(seqs[i])
                # result columns are live-query columns; route by global id so
                # churn never changes which data shard a profile delivers to.
                # Sparse producers with live_ids already speak global ids.
                if sparse:
                    qids = results.matching_queries(i)
                    if results.live_ids is None:
                        qids = live[qids]
                else:
                    qids = live[results[i].matching_queries()]
                if len(qids) == 0:
                    if self.keep_unmatched:
                        out.append(RoutedDocument(doc, qids, 0, nb))
                    continue
                for shard in np.unique(self.shard_of_profile[qids]):
                    mine = qids[self.shard_of_profile[qids] == shard]
                    out.append(RoutedDocument(doc, mine, int(shard), nb))
            return out

    # ------------------------------------------------------------- metrics
    def selectivity(self, docs: list[EventStream]) -> float:
        """Fraction of live (doc, profile) pairs that match, a workload
        statistic.  Read-only: it does not count toward
        :meth:`throughput`."""
        return self._filter_batch(list(docs), record=False).selectivity()

    def throughput(self) -> dict:
        """Cumulative filtering throughput over everything routed so far,
        with the JAX package's keys.

        Per-axis view: ``mesh_data`` / ``mesh_model`` are the *placed*
        mesh's axis sizes (a request shrinks to what the host can place,
        :func:`~repro_torch.launch.mesh.make_filter_mesh`);
        ``docs_per_s_per_data_shard`` is each data row's share of the
        stream, and ``queries_per_model_shard`` each model position's
        slice of the subscription set.
        """
        s = self.stats
        dt = max(s["seconds"], 1e-9)
        axes = dict(self.mesh.shape) if self.mesh is not None else {}
        mesh_data = axes.get("data", 1)
        mesh_model = axes.get("model", 1)
        return {
            "engine": self.engine,
            "query_shards": self.query_shards,
            "data_shards": self.data_shards,
            "mesh_data": mesh_data,
            "mesh_model": mesh_model,
            "docs": s["docs"],
            "docs_per_s": s["docs"] / dt,
            "docs_per_s_per_data_shard": s["docs"] / dt / mesh_data,
            "queries_per_model_shard": -(-len(self._gids)
                                         // max(mesh_model, 1)),
            "mb_per_s": s["bytes"] / 1e6 / dt,
            "put_s": s["put_seconds"],
            "overlapped_batches": s["overlapped_batches"],
            "selectivity": s["pair_matches"] / max(s["pairs"], 1),
        }
