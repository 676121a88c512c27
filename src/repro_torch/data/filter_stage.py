"""Pub-sub content routing as a pipeline stage, on the port's engines.

Counterpart of ``src/repro/data/filter_stage.py`` for one shard of the
subscription set: a stream of documents is matched against standing
profiles and each document is routed to every data shard that holds a
matching subscription.  :meth:`FilterStage.route` takes host-parsed event
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
Query and data sharding (``query_shards``/``data_shards > 1``) are ROADMAP
queue 1 items 7 and 13; asking for them raises.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

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

    A batch dispatched against epoch *E* filters with *E*'s engine and
    gid mapping even if churn commits a replacement mid-flight — verdict
    columns and the gid axis always agree (the JAX package's snapshot
    also holds the sharded plan: ROADMAP queue 1 item 7)."""

    epoch: int
    eng: Any
    gids: np.ndarray


@dataclass
class PendingPlan:
    """A fully built replacement plan awaiting an atomic commit.

    Produced off the hot path by ``prepare_subscribe`` /
    ``prepare_unsubscribe`` — the expensive work (NFA compile, engine
    plan, its tables' copy to the device) happens during *prepare*,
    against a snapshot, without mutating the stage; ``commit`` is a
    handful of reference assignments under the plan mutex."""

    op: str                            # "subscribe" | "unsubscribe"
    base_epoch: int
    gid: int | None = None
    eng: Any = None                    # replacement engine
    nfa: Any = None
    live: dict | None = None
    gids: np.ndarray | None = None
    build_s: float = 0.0


#: what the stage cannot do yet, and the ROADMAP items that port it
_NOT_PORTED_SHARDING = ("query_shards > 1 or data_shards > 1 is not "
                        "ported yet: sharded plans are ROADMAP queue 1 item "
                        "7, the 2-D (data x model) paths item 13")


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
    bound from ``engine_options={"match_cap": ...}``.  Unsharded, churn
    recompiles the whole engine (:meth:`subscribe`, :meth:`unsubscribe`).
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
    #: in-flight depth of :meth:`route_bytes_pipelined`, as in the JAX
    #: package (an unsharded stage routes synchronously at any depth)
    pipeline_depth: int = 2
    device: str = "cuda"
    shard_of_profile: np.ndarray = field(default=None)  # type: ignore
    stats: dict = field(default_factory=dict)
    #: deliver verdicts as sparse match lists (``filter_*_sparse``)
    sparse: bool = False
    #: run :meth:`maybe_rebalance` every N churn ops (0 = manual only);
    #: rebalancing moves trie groups between query shards, so an
    #: unsharded stage has nothing to move
    rebalance_every: int = 0
    rebalance_tolerance: float = 0.25
    #: extra engine options (e.g. ``{"pack": True}``, ``{"match_cap": n}``)
    engine_options: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.query_shards > 1 or self.data_shards > 1:
            raise NotImplementedError(_NOT_PORTED_SHARDING)
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
        if self.shard_of_profile is None:
            self.shard_of_profile = (
                np.arange(len(self.profiles)) % self.n_shards).astype(np.int32)
        self.stats = {"batches": 0, "docs": 0, "bytes": 0,
                      "seconds": 0.0, "pair_matches": 0, "pairs": 0,
                      "put_seconds": 0.0, "overlapped_batches": 0,
                      "verdict_bytes": 0, "device_rows": 0, "paths": {}}
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
        """Consistent (epoch, engine, gids) snapshot for dispatch.

        A batch filtered against this snapshot and fanned out with its
        ``gids`` is correct even if a plan swap commits while the batch
        is in flight."""
        with self._plan_mtx:
            return PlanEpoch(self._epoch, self._eng, self._gids)

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

        Pure with respect to the stage: the full replacement engine is
        compiled against a snapshot, so a failed build (e.g. a rejected
        profile) leaves the live plan untouched with nothing to roll
        back."""
        q = parse(profile) if isinstance(profile, str) else profile
        t0 = time.perf_counter()
        with self._plan_mtx:
            base = self._epoch
            live = dict(self._live)
            gid = self._next_gid
        live[gid] = q
        return self._prepare("subscribe", base, live, gid, t0)

    def prepare_unsubscribe(self, gid: int) -> PendingPlan:
        """Build the plan that drops ``gid``."""
        if gid not in self._live:
            raise KeyError(f"query id {gid} is not subscribed")
        t0 = time.perf_counter()
        with self._plan_mtx:
            base = self._epoch
            live = dict(self._live)
        del live[gid]
        return self._prepare("unsubscribe", base, live, gid, t0)

    def prepare_rebalance(self, *, tolerance: float | None = None
                          ) -> PendingPlan | None:
        """Build the rebalanced plan: sharded stages only, so ``None``
        here, as in the JAX package's unsharded stage."""
        return None

    def commit(self, pending: PendingPlan, shard: int | None = None):
        """Atomically install a prepared plan at the current epoch.

        A handful of reference assignments under the plan mutex —
        batches dispatched against the previous :meth:`plan_epoch`
        snapshot keep filtering the old plan; the next snapshot sees the
        new one (whose readers wait for its tables on the device:
        :meth:`FilterEngine.wait_plan`).  Raises :class:`StalePlanError`
        (leaving the live plan untouched) if another commit landed since
        ``prepare_*``.  Returns the gid."""
        with self._plan_mtx:
            if pending.base_epoch != self._epoch:
                raise StalePlanError(
                    f"plan prepared against epoch {pending.base_epoch}, "
                    f"live plan is at {self._epoch}; re-prepare")
            self._live = pending.live
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

        The unsharded stage pays the full recompile.  Prepare/commit
        under the hood: a failed build never touches the live plan, and
        a concurrent commit just means one re-prepare."""
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
        """Remove a subscription by global id (full recompile)."""
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
        """Shard-load repair; ``None``, since an unsharded stage has no
        shards to balance."""
        return None

    def _grow_shard_map(self, gid: int, shard: int | None) -> None:
        if gid >= len(self.shard_of_profile):
            extra = np.arange(len(self.shard_of_profile), gid + 1)
            self.shard_of_profile = np.concatenate(
                [self.shard_of_profile,
                 (extra % self.n_shards).astype(np.int32)])
        if shard is not None:
            self.shard_of_profile[gid] = shard

    # ----------------------------------------------------------------- run
    def _filter_batch(self, docs: list[EventStream]
                      ) -> FilterResult | SparseResult:
        eng = self._eng
        batch = EventBatch.from_streams(docs, bucket=self.bucket)
        t0 = time.perf_counter()
        eng.wait_plan()
        res = (eng.filter_batch_sparse if self.sparse
               else eng.filter_batch)(batch)
        self._record(res, batch.batch_size,
                     int(batch.nbytes(TEXT_FILL).sum()),
                     time.perf_counter() - t0)
        return res

    def _filter_bytebatch(self, bufs: list[bytes], record: bool = True,
                          epoch: PlanEpoch | None = None
                          ) -> FilterResult | SparseResult:
        """Device-ingest batched path: raw wire bytes in, verdicts out,
        decoded on the device by the engine's ``filter_bytes``.  ``epoch``
        pins the batch to a :meth:`plan_epoch` snapshot so a concurrent
        plan swap cannot tear engine/gids mid-batch; the current stream
        waits for that engine's tables first."""
        eng = self._eng if epoch is None else epoch.eng
        bb = ByteBatch.from_buffers(bufs, bucket=self.byte_bucket)
        t0 = time.perf_counter()
        eng.wait_plan()
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
        device, then fanned out to shards exactly like the event path."""
        base = 0
        for batch in self._chunks(payloads):
            res = self._filter_bytebatch(batch)
            yield self._fan_out(res, [len(b) for b in batch], base)
            base += len(batch)

    def route_bytes_pipelined(self, payloads: Iterable[bytes], *,
                              depth: int | None = None
                              ) -> Iterator[list[RoutedDocument]]:
        """K-deep pipelined twin of :meth:`route_bytes`.  In the JAX
        package it overlaps batches on the 2-D mesh and falls back to
        :meth:`route_bytes` when the stage has no sharded plan; an
        unsharded stage never has one, so it routes exactly as
        :meth:`route_bytes` at any ``depth``.  Batches overlap on the
        card in the serve loop (:class:`repro_torch.serve.ServeLoop`),
        one stream per worker."""
        yield from self.route_bytes(payloads)

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
    def throughput(self) -> dict:
        """Cumulative filtering throughput over everything routed so far,
        with the JAX package's keys; one device, so both mesh axes are 1
        and every query is on the one model shard."""
        s = self.stats
        dt = max(s["seconds"], 1e-9)
        return {
            "engine": self.engine,
            "query_shards": self.query_shards,
            "data_shards": self.data_shards,
            "mesh_data": 1,
            "mesh_model": 1,
            "docs": s["docs"],
            "docs_per_s": s["docs"] / dt,
            "docs_per_s_per_data_shard": s["docs"] / dt,
            "queries_per_model_shard": len(self._gids),
            "mb_per_s": s["bytes"] / 1e6 / dt,
            "put_s": s["put_seconds"],
            "overlapped_batches": s["overlapped_batches"],
            "selectivity": s["pair_matches"] / max(s["pairs"], 1),
        }
