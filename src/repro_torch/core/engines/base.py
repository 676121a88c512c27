"""The engine contract of the port: ``FilterPlan``, ``FilterEngine``, registry.

Counterpart of ``src/repro/core/engines/base.py``, for engines whose
compiled tables are torch tensors:

* :class:`FilterPlan` — a frozen dict of tables plus static metadata,
  built once per profile set by :meth:`FilterEngine.plan`: tensors on one
  device for the device engines, host structures (or nothing) for the
  host engines.
* :class:`FilterEngine` — compile once, then ``filter_batch`` (events)
  and ``filter_bytes`` (raw wire bytes) into ``(B, Q)`` results, or
  ``filter_batch_sparse`` / ``filter_bytes_sparse`` into bounded match
  lists (:class:`SparseResult`).  Device engines split a call into a
  plan-independent ``_prep`` of the batch and a ``_run_with_plan`` against
  an explicit plan (``filter_batch_with_plan``); host engines
  (``device_sharded = False``) loop documents in Python.  Every entry
  point runs on ``device`` (``"cuda"`` unless the caller asks for
  ``"cpu"``, where the kernels' plain versions run).
* :class:`ShardedPlan` — the subscription set split into parts
  (:meth:`FilterEngine.plan_sharded`), each compiled at uniform pads so
  that the per-part tables stack into ``(P, ...)`` tensors.  On one card
  the parts of a device engine run in ONE launch of its kernel (the
  streaming engine folds them into the state-block grid, the levelwise
  engines into K6's state axis, matscan into its query axis); churn
  recompiles one part (:meth:`ShardedPlan.add_queries`) or only
  tombstones (:meth:`ShardedPlan.remove_queries`), and
  :meth:`ShardedPlan.rebalance` migrates trie groups between parts.
* the mesh — ``mesh=`` (a :class:`~repro_torch.launch.mesh.FilterMesh`)
  on the ``filter_*_sharded`` methods spreads the parts over the mesh's
  ``"model"`` axis, and the ``*_sharded2d`` methods also spread the
  documents over its ``"data"`` axis: one launch per mesh **position**,
  over that position's model slice of the parts
  (:meth:`ShardedPlan.model_slice`) and data slice of the batch, on the
  position's device and stream (:class:`_Inflight`).  The results are
  gathered in live-global-id order, pad rows sliced off.  A 1 × 1 mesh on
  the engine's own device is the one-card path.
* the persistent plan cache — ``plan_cache=`` (a
  :class:`~repro_torch.checkpoint.PlanCache` or a directory): every
  compile of a device engine goes through :meth:`FilterEngine.
  _plan_cached`, keyed by :meth:`FilterEngine.plan_cache_key`, and a hit
  is rebuilt through the table checks of :mod:`repro_torch.convert`.
* the registry — the port's own :func:`register` / :func:`create` /
  :func:`names`, separate from the JAX package's.
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, ClassVar, Mapping, Sequence

import numpy as np
import torch

from ... import tracing
from ...kernels.ref import compact_rows
from ...launch.mesh import AXES, resolve_device
from ..events import (DEFAULT_MAX_DEPTH, ByteBatch, EventBatch, EventStream,
                      PlacedBytes)
from ..nfa import (NFA, MinimizeStats, QueryPartition, _prefix_key,
                   _query_weight, compile_queries, pad_states,
                   partition_queries)
from ..nfa import minimize as minimize_nfa
from ..xpath import Query
from ..xpath import parse as parse_xpath
from .result import NO_MATCH, FilterResult, SparseResult


def _round_up(n: int, multiple: int) -> int:
    multiple = max(1, int(multiple))
    return max(multiple, -(-n // multiple) * multiple)


# ------------------------------------------------- sparse verdict compaction
def _compact_matches(matched: torch.Tensor, first: torch.Tensor,
                     cols: torch.Tensor, cap: int):
    """Cumsum-compact a dense device verdict into a bounded match buffer.

    ``matched`` ``(B, K)`` bool and ``first`` ``(B, K)`` int32 on the
    device; ``cols`` ``(K,)`` int32 names each column (a query column or
    an accept-lane class; ``-1`` discards the column's hits).  The hits
    are compacted in row-major order into ``cap``-row buffers
    (:func:`~repro_torch.kernels.ref.compact_rows`), so the host reads
    ``3 × cap`` int32 and one count.  Returns ``(doc, col, first,
    count)``; ``count > cap`` means the buffers were truncated and the
    caller must recompute densely.
    """
    hits = matched & (cols >= 0)[None, :]
    doc = torch.arange(hits.shape[0], dtype=torch.int32,
                       device=hits.device)[:, None].expand(hits.shape)
    (bdoc, bcol, bfirst), count = compact_rows(
        hits.reshape(-1), (doc, cols[None, :].expand(hits.shape), first),
        (-1, -1, NO_MATCH), cap)
    return bdoc, bcol, bfirst, count


def _compact_parts(matched: torch.Tensor, first: torch.Tensor,
                   cols: torch.Tensor, cap: int):
    """:func:`_compact_matches` over a stacked ``(P, B, Qpad)`` verdict.

    ``cols`` is ``(P, Qpad)`` global ids (``-1`` = tombstoned or pad).
    The part axis folds into the column axis, so one compaction ranks the
    hits of every part: rows come back doc-major, part-interleaved within
    a document, and the host assembly sorts them.
    """
    p, b, q = matched.shape
    m = matched.permute(1, 0, 2).reshape(b, p * q)
    f = first.permute(1, 0, 2).reshape(b, p * q)
    return _compact_matches(m, f, cols.reshape(-1), cap)


#: default event-axis padding bucket of the byte-ingest paths; an engine
#: created with ``event_bucket=`` (``FilterStage`` passes its own
#: ``bucket``) overrides it
DEFAULT_EVENT_BUCKET = 128


#: the JAX package's default per-program VMEM and SMEM budgets, which
#: size its default state blocks and event chunks (its
#: ``REPRO_PALLAS_*_BUDGET`` variables unset); the ``vmem_budget=`` /
#: ``smem_budget=`` options feed the same formula
_TPU_VMEM_BUDGET = 4 << 20
_TPU_SMEM_BUDGET = 8 << 10


#: the version tag of the port's plan-cache keys, its own so that one
#: cache directory never serves an entry of one package to the other
PLAN_CACHE_VERSION = "repro_torch-plan-v1"


#: engine options the JAX package has and the port does not take, and why
NOT_PORTED = {
    "kernel": "the streaming engine has one path per device, its CUDA "
              "kernels on the card and their plain versions on the CPU, so "
              "there is no scan or Pallas mode to pick",
    "kernel_interpret": "Pallas interpret mode has no CUDA twin",
}


def _tables_digest(tables: Mapping[str, np.ndarray]) -> str:
    """sha256 over a plan's tables (names, dtypes, shapes, bytes), written
    with a cache entry and checked on a hit."""
    h = hashlib.sha256()
    for k in sorted(tables):
        a = np.ascontiguousarray(tables[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _record_event(device: torch.device):
    """An event recorded on ``device``'s current stream (``None`` off the
    card): later work on any stream can wait for what came before it."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _tensors(val) -> list[torch.Tensor]:
    """The tensors held by a memoised value (a tensor, a plan, or a tuple,
    list or dict of them)."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, FilterPlan):
        val = val.tables
    if isinstance(val, dict):
        val = list(val.values())
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return []


def _use_on_current_stream(ready, tensors) -> None:
    """Order the current stream after ``ready`` (an event of the stream
    that made ``tensors``) and mark the tensors as used by it, so their
    memory is not reused while its kernels may still read them."""
    if ready is None or not tensors:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


def to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor read to the host: one blocking copy from the device,
    counted on the open request (``readbacks``, ``d2h_bytes``)."""
    if tracing.recording():
        tracing.count("readbacks")
        tracing.count("d2h_bytes", x.numel() * x.element_size())
    return x.cpu().numpy()


# ------------------------------------------------------- mesh positions
def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card tensor, queued on the current stream."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _Inflight:
    """One dispatch's launches over mesh positions, in flight.

    :meth:`run` runs a position's body on the position's device and, on a
    card, its stream (:meth:`FilterMesh.use`); the body's output tensors
    are copied to pinned host memory on that stream and an event is
    recorded after them.  :meth:`wait` waits on those events only — never
    on the whole card, which would also wait for batches dispatched after
    this one — and returns each position's outputs as numpy arrays, in the
    order the positions ran.  The pinned buffers the dispatch staged its
    inputs from (:meth:`stage`), and what it hands to :meth:`keep`, live as
    long as the dispatch, so a later batch never reuses one mid-copy.
    """

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self._outs: list = []
        self._keep: list = []

    def keep(self, obj) -> None:
        self._keep.append(obj)

    def stage(self, eng: "FilterEngine", array, idx) -> torch.Tensor:
        """``array`` on position ``idx``'s device, copied from pinned memory
        on the position's stream."""
        return eng.to_device(array, device=self.mesh.device(idx),
                             stream=self.mesh.stream(idx), keep=self._keep)

    def run(self, idx, fn) -> None:
        dev = self.mesh.device(idx)
        with self.mesh.use(idx):
            outs = tuple(fn(dev))
            event = None
            if dev.type == "cuda":
                outs = tuple(_host_copy(t) for t in outs)
                event = torch.cuda.Event()
                event.record()
        self._outs.append((event, outs))

    def wait(self) -> list[tuple[np.ndarray, ...]]:
        for event, _ in self._outs:
            if event is not None:
                event.synchronize()
        return [tuple(t.numpy() for t in outs) for _, outs in self._outs]


@dataclasses.dataclass
class _Position:
    """What a position's body gets: its dispatch, index, ``(data, model)``
    coordinates, device, and model slice of the sharded plan (waited for
    on the position's stream)."""

    fl: _Inflight
    idx: tuple
    d: int
    m: int
    dev: torch.device
    sub: "ShardedPlan"

    def stage(self, eng: "FilterEngine", array) -> torch.Tensor:
        return self.fl.stage(eng, array, self.idx)


def _live_perm(sharded: "ShardedPlan", n_model: int) -> np.ndarray:
    """Columns gathered model position by model position (each in
    ascending global id) → the permutation into live-global-id order."""
    live = sharded.live_ids()
    part = sharded.partition.part_of[live] // (sharded.n_parts // n_model)
    order = np.concatenate([live[part == m] for m in range(n_model)])
    return np.argsort(order, kind="stable")


def _gather(outs: list, n_data: int, n_model: int, perm: np.ndarray,
            k: int) -> np.ndarray:
    """Output ``k`` of every position, ``(rows, ..., Q_m)`` each in ``(d,
    m)`` order → one array: model slices side by side, data slices one
    under another, columns in live-global-id order."""
    return np.concatenate([np.concatenate(
        [outs[d * n_model + m][k] for m in range(n_model)], -1)
        for d in range(n_data)], 0)[..., perm]


def _position_rows(outs: list, cap: int
                   ) -> tuple[tuple[np.ndarray, ...], int, bool]:
    """Each position's ``(cap, 3)`` match buffer and count (host) → the
    real rows of all, the summed count, and whether ANY position
    overflowed its buffer (each bounds ``cap`` on its own)."""
    rows = np.concatenate([buf[:min(int(cnt[0]), cap)] for buf, cnt in outs])
    counts = [int(cnt[0]) for _, cnt in outs]
    return ((rows[:, 0], rows[:, 1], rows[:, 2]), sum(counts),
            any(c > cap for c in counts))


# ----------------------------------------------------------------- the plan
class FilterPlan:
    """Frozen plan: named tables + static metadata.

    A device engine's tables are tensors on one device, which is the
    plan's ``device``.  A host engine's plan may hold host structures or
    no tables at all (``tables={}``); its ``device`` is the one passed,
    else the CPU.
    """

    __slots__ = ("engine", "device", "_tables", "_meta")

    def __init__(self, engine: str, tables: Mapping[str, Any],
                 meta: Mapping[str, Any] | None = None, *,
                 device: str | torch.device | None = None) -> None:
        devices = {t.device for t in tables.values()
                   if isinstance(t, torch.Tensor)}
        if device is not None:
            devices.add(torch.device(device))
        if len(devices) > 1:
            raise ValueError(f"plan tables span devices {sorted(map(str, devices))}")
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "device",
                           devices.pop() if devices else torch.device("cpu"))
        object.__setattr__(self, "_tables", dict(tables))
        object.__setattr__(self, "_meta", dict(meta or {}))

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("FilterPlan is frozen")

    @property
    def tables(self) -> dict[str, Any]:
        return dict(self._tables)

    @property
    def meta(self) -> dict[str, Any]:
        return dict(self._meta)

    def table(self, name: str) -> Any:
        return self._tables[name]

    def __getitem__(self, name: str) -> Any:
        return self.table(name)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FilterPlan({self.engine!r}, device={self.device}, "
                f"tables={sorted(self._tables)}, meta={self._meta})")


# ------------------------------------------------------------ sharded plans
#: guards every sharded plan's memo of model slices
_SLICE_LOCK = threading.Lock()


def _stack_tables(plans: Sequence[FilterPlan]) -> dict[str, torch.Tensor]:
    """Per-part tables of equal shapes → ``(P, ...)`` tensors."""
    return {k: torch.stack([p[k] for p in plans]) for k in plans[0].tables}


class ShardedPlan:
    """Frozen set of per-part :class:`FilterPlan`\\ s: the query axis as a
    scaling axis.

    The paper scales in the number of profiles by replicating query
    blocks across FPGA area and chips (§3.5/§4); here the subscription set
    is partitioned (:func:`repro_torch.core.nfa.partition_queries`) and
    each part compiled to its own plan at the engine's uniform pads
    (:meth:`FilterEngine.part_pads`), so the parts of a device engine
    stack into one ``(P, ...)`` plan, :meth:`stacked`, which is built
    with the plan.  Host engines keep raw per-part plans and loop them.

    Instances are immutable; churn returns a **new** plan:

    * :meth:`add_queries` appends to the least-loaded part and recompiles
      only that part; its rows of the stacked tables are replaced in new
      tensors (copy-on-write), so batches still filtering the old plan,
      on any stream, keep reading the old tables;
    * :meth:`remove_queries` is metadata: the column is tombstoned in the
      partition index and masked out of results, and reclaimed the next
      time its part recompiles.

    Global query ids are stable across churn; results are reported over
    the *live* ids in ascending order.

    Streams: the tables are made on the stream of the thread that builds
    the plan (in the serve loop, the shadow builder's).  An event
    recorded after them orders every reader: :meth:`wait` makes the
    current stream wait for it, as :meth:`FilterEngine.wait_plan` does for
    an engine's own plan.
    """

    __slots__ = ("engine", "plans", "part_cols", "part_queries",
                 "part_nfas", "pads", "n_global", "query_bucket", "shared",
                 "_engine_obj", "_stacked", "_partition", "_ready",
                 "_slices")

    def __init__(self, engine_obj: "FilterEngine",
                 plans: Sequence[FilterPlan],
                 part_cols: Sequence[Sequence[int]],
                 part_queries: Sequence[Sequence[Query | None]],
                 part_nfas: Sequence[NFA],
                 pads: Mapping[str, int],
                 n_global: int,
                 query_bucket: int,
                 shared: bool, *,
                 stacked: FilterPlan | None = None) -> None:
        object.__setattr__(self, "engine", engine_obj.name)
        object.__setattr__(self, "plans", tuple(plans))
        object.__setattr__(self, "part_cols",
                           tuple(tuple(c) for c in part_cols))
        object.__setattr__(self, "part_queries",
                           tuple(tuple(q) for q in part_queries))
        object.__setattr__(self, "part_nfas", tuple(part_nfas))
        object.__setattr__(self, "pads", dict(pads))
        object.__setattr__(self, "n_global", int(n_global))
        object.__setattr__(self, "query_bucket", int(query_bucket))
        object.__setattr__(self, "shared", bool(shared))
        object.__setattr__(self, "_engine_obj", engine_obj)
        object.__setattr__(self, "_partition", None)
        object.__setattr__(self, "_slices", {})
        if stacked is None and engine_obj.device_sharded:
            meta = dict(self.plans[0].meta, n_parts=len(self.plans))
            stacked = FilterPlan(self.engine, _stack_tables(self.plans),
                                 meta)
        object.__setattr__(self, "_stacked", stacked)
        # everything above was queued on this thread's current stream
        object.__setattr__(self, "_ready", _record_event(self.device))

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("ShardedPlan is frozen")

    # ----------------------------------------------------------- structure
    @property
    def device(self) -> torch.device:
        return self.plans[0].device

    @property
    def n_parts(self) -> int:
        return len(self.plans)

    @property
    def n_queries(self) -> int:
        """Live (subscribed) query count."""
        return sum(1 for cols in self.part_cols for g in cols if g >= 0)

    def wait(self) -> None:
        """Make the current stream wait until this plan's tables are on the
        device, and mark them as used by it (nothing to do off the
        card)."""
        if self._ready is None:
            return
        # the stacked tables are what the launches read; the per-part
        # tables are read only by memoised builders, after this wait
        _use_on_current_stream(self._ready, _tensors(self._stacked))

    @property
    def partition(self) -> QueryPartition:
        """Global id ↔ (part, local column) index of the current layout."""
        if self._partition is None:
            part_of = np.full(self.n_global, -1, np.int32)
            local_of = np.zeros(self.n_global, np.int32)
            for p, cols in enumerate(self.part_cols):
                for c, gid in enumerate(cols):
                    if gid >= 0:
                        part_of[gid] = p
                        local_of[gid] = c
            object.__setattr__(self, "_partition",
                               QueryPartition(part_of, local_of,
                                              self.n_parts))
        return self._partition

    def live_ids(self) -> np.ndarray:
        return self.partition.live_ids()

    def live_queries(self) -> tuple[Query, ...]:
        """Subscribed queries in global-id order: compiling these from
        scratch must reproduce this plan's verdicts exactly (the churn
        equivalence invariant)."""
        by_gid: dict[int, Query] = {}
        for cols, qs in zip(self.part_cols, self.part_queries):
            for gid, q in zip(cols, qs):
                if gid >= 0:
                    by_gid[gid] = q
        return tuple(by_gid[g] for g in sorted(by_gid))

    def index_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(part, local) gather index over live ids in global order."""
        part = self.partition
        live = part.live_ids()
        return part.part_of[live], part.local_of[live]

    def stacked(self) -> FilterPlan:
        """All parts as ONE plan with a leading part axis (device engines).

        Uniform padding makes every per-part table the same shape, so
        table ``k`` is ``(P, ...)``; the streaming engine folds it to
        ``(P·G, ...)`` for one launch.  Built with the plan; churn builds
        new instances, so it can never go stale.
        """
        if self._stacked is None:
            raise ValueError(f"{self.engine}: a host engine's parts do not "
                             f"stack")
        return self._stacked

    def part_sizes(self) -> np.ndarray:
        return self.partition.part_sizes()

    def model_slice(self, m: int, n_model: int,
                    device: torch.device | None = None) -> "ShardedPlan":
        """Model position ``m`` of ``n_model``'s parts, ``[m·P/M,
        (m+1)·P/M)``, as a sharded plan of their own on ``device``.

        Its stacked tables are views of this plan's rows on this plan's
        device, and one copy of them on another device (whose per-part
        plans are then views of the copy).  Memoised on this plan per
        (device, slice): churn and rebalance build a new plan, so a batch
        of the old epoch keeps its slices and a new batch never sees a
        stale one.  The whole plan on its own device is this plan.  Build
        it on the stream that reads it: the slice waits for this plan's
        tables there and records its own ready event after them.
        """
        per = self.n_parts // n_model
        lo, hi = m * per, (m + 1) * per
        dev = self.device if device is None else torch.device(device)
        if (lo, hi) == (0, self.n_parts) and dev == self.device:
            return self
        key = (lo, hi, dev)
        with _SLICE_LOCK:
            hit = self._slices.get(key)
        if hit is not None:
            return hit
        self.wait()
        plans, stacked = self.plans[lo:hi], None
        if self._stacked is not None:
            tables = {k: v[lo:hi] if dev == self.device else v[lo:hi].to(dev)
                      for k, v in self._stacked.tables.items()}
            stacked = FilterPlan(self.engine, tables,
                                 dict(self._stacked.meta, n_parts=hi - lo))
            if dev != self.device:
                plans = [FilterPlan(pl.engine,
                                    {k: t[i] for k, t in tables.items()},
                                    pl.meta)
                         for i, pl in enumerate(plans)]
        sub = ShardedPlan(self._engine_obj, plans, self.part_cols[lo:hi],
                          self.part_queries[lo:hi], self.part_nfas[lo:hi],
                          self.pads, self.n_global, self.query_bucket,
                          self.shared, stacked=stacked)
        with _SLICE_LOCK:
            return self._slices.setdefault(key, sub)

    def gid_columns(self) -> np.ndarray:
        """``(P, Qpad)`` global id per compiled plan column; ``-1`` marks
        tombstoned and pad columns, whose hits are discarded."""
        qpad = int(self.pads.get("n_queries", 0)) or max(
            (len(c) for c in self.part_cols), default=1)
        out = np.full((self.n_parts, qpad), -1, np.int32)
        for p, cols in enumerate(self.part_cols):
            if cols:
                out[p, :len(cols)] = cols
        return out

    # --------------------------------------------------------- rebalancing
    def part_weights(self) -> np.ndarray:
        """Estimated automaton load per part: Σ state weight of live
        queries (:func:`repro_torch.core.nfa._query_weight`), the measure
        :func:`partition_queries` balances at plan time."""
        w = np.zeros(self.n_parts, np.int64)
        for p, (cols, qs) in enumerate(zip(self.part_cols,
                                           self.part_queries)):
            w[p] = sum(_query_weight(q)
                       for g, q in zip(cols, qs) if g >= 0)
        return w

    def imbalance(self) -> float:
        """Relative overload of the heaviest part, ``max/mean - 1``: 0 is
        balanced, 1 means the hottest part carries twice the mean weight
        (and the stacked program wastes half its padded area)."""
        w = self.part_weights().astype(float)
        mean = float(w.mean()) if w.size else 0.0
        return float(w.max() / mean - 1.0) if mean > 0 else 0.0

    def _restacked(self, plans: Sequence[FilterPlan],
                   changed: Sequence[int]) -> FilterPlan | None:
        """The stacked plan with the rows of ``changed`` parts replaced,
        in new tensors: the old tables stay as they were for batches of
        the old plan still in flight."""
        if self._stacked is None:
            return None
        idx = torch.tensor(list(changed), dtype=torch.long,
                           device=self.device)
        tables = {k: torch.index_copy(
            v, 0, idx, torch.stack([plans[p][k] for p in changed]))
            for k, v in self._stacked.tables.items()}
        return FilterPlan(self.engine, tables, self._stacked.meta)

    def rebalance(self, *, tolerance: float = 0.25,
                  max_moves: int | None = None
                  ) -> tuple["ShardedPlan", dict]:
        """Migrate trie groups between parts until the load is about even.

        Shared-prefix groups move greedily from the heaviest part to the
        lightest while each move strictly shrinks the spread, split at
        query granularity when every group outweighs the gap.  Only the
        touched parts recompile, at the existing pads when they fit (with
        a copy-on-write restack of their rows), else everything re-pads.
        Returns ``(new_plan, stats)``; global ids, verdicts and live-id
        order are unchanged.  Within ``tolerance`` returns ``self``.
        """
        from ...kernels.blocks import PadOverflow

        eng = self._engine_obj
        imb0 = self.imbalance()
        stats = {"moves": 0, "moved_queries": 0, "recompiled_parts": 0,
                 "repadded": False, "imbalance_before": imb0,
                 "imbalance_after": imb0}
        if self.n_parts < 2 or imb0 <= tolerance:
            return self, stats

        units: list[dict[Any, list[tuple[int, Query]]]] = []
        for cols, qs in zip(self.part_cols, self.part_queries):
            d: dict[Any, list[tuple[int, Query]]] = {}
            for g, q in zip(cols, qs):
                if g >= 0:
                    d.setdefault(_prefix_key(q), []).append((g, q))
            units.append(d)
        loads = [sum(_query_weight(q) for grp in d.values() for _, q in grp)
                 for d in units]
        mean = sum(loads) / len(loads)

        moves: list[tuple[int, int, int]] = []  # (donor, recv, n_queries)
        budget = max_moves if max_moves is not None else 4 * self.n_parts
        while len(moves) < budget:
            donor = int(np.argmax(loads))
            recv = int(np.argmin(loads))
            gap = loads[donor] - loads[recv]
            if gap <= 0 or loads[donor] <= (1.0 + tolerance) * mean:
                break
            # the heaviest whole group that still strictly shrinks the
            # spread (w < gap, so it can never ping-pong back)
            best_key, best_w = None, 0
            for key, grp in units[donor].items():
                w = sum(_query_weight(q) for _, q in grp)
                if best_w < w < gap:
                    best_key, best_w = key, w
            if best_key is not None:
                grp = units[donor].pop(best_key)
                units[recv].setdefault(best_key, []).extend(grp)
                loads[donor] -= best_w
                loads[recv] += best_w
                moves.append((donor, recv, len(grp)))
                continue
            # every group outweighs the gap: split the heaviest one at
            # query granularity (co-location is a balance heuristic, not
            # a correctness invariant)
            key = max(units[donor],
                      key=lambda k: sum(_query_weight(q)
                                        for _, q in units[donor][k]),
                      default=None)
            if key is None:
                break
            grp = units[donor][key]
            take, w = 0, 0
            for g, q in grp[:-1]:  # always leave one query behind
                qw = _query_weight(q)
                if w + qw >= gap:
                    break
                take += 1
                w += qw
                if w >= gap / 2:
                    break
            if take == 0:
                break
            units[donor][key] = grp[take:]
            units[recv].setdefault(key, []).extend(grp[:take])
            loads[donor] -= w
            loads[recv] += w
            moves.append((donor, recv, take))
        if not moves:
            return self, stats

        self.wait()      # the parts kept are read on this thread's stream
        changed = sorted({p for d, r, _ in moves for p in (d, r)})
        part_cols = list(self.part_cols)
        part_queries = list(self.part_queries)
        part_nfas = list(self.part_nfas)
        for p in changed:
            entries = sorted(
                (g, q) for grp in units[p].values() for g, q in grp)
            part_cols[p] = tuple(g for g, _ in entries)
            part_queries[p] = tuple(q for _, q in entries)
            part_nfas[p] = eng._maybe_minimize(compile_queries(
                part_queries[p], eng.dictionary, shared=self.shared))

        fresh = eng.part_pads(part_nfas, query_bucket=self.query_bucket)
        pads, plans, stacked = self.pads, list(self.plans), None
        new_plans: dict[int, FilterPlan] | None = None
        if all(fresh.get(k, 0) <= pads.get(k, 0) for k in fresh):
            try:
                new_plans = {p: eng.plan_part(part_nfas[p], pads)
                             for p in changed}
            except PadOverflow:
                new_plans = None
        if new_plans is None:
            pads = eng.merge_pads(self.pads, fresh, part_nfas)
            plans = [eng.plan_part(nfa, pads) for nfa in part_nfas]
            stats["repadded"] = True
            stats["recompiled_parts"] = self.n_parts
        else:
            for p, pl in new_plans.items():
                plans[p] = pl
            stats["recompiled_parts"] = len(changed)
            stacked = self._restacked(plans, changed)

        sp = ShardedPlan(eng, plans, part_cols, part_queries, part_nfas,
                         pads, self.n_global, self.query_bucket,
                         self.shared, stacked=stacked)
        stats["moves"] = len(moves)
        stats["moved_queries"] = sum(n for _, _, n in moves)
        stats["imbalance_after"] = sp.imbalance()
        return sp, stats

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ShardedPlan({self.engine!r}, parts={self.n_parts}, "
                f"queries={self.n_queries}, pads={self.pads})")

    # ------------------------------------------------------ incremental churn
    def add_queries(self, queries: Sequence[Query | str]
                    ) -> tuple["ShardedPlan", list[int]]:
        """Subscribe new profiles; recompile only the least-loaded part.

        Returns ``(new_plan, new_global_ids)``.  The target part is
        compacted on the way (its tombstoned columns are dropped) and the
        other parts' plans are reused untouched, unless the grown part
        overflows a shared pad bucket: only then is every part re-padded
        (a table rebuild from the stored sub-NFAs).  A ``PadOverflow`` at
        the old pads, which jointly derived targets can raise even when
        every key compares ≤, falls back to that full re-pad too.
        """
        from ...kernels.blocks import PadOverflow

        eng = self._engine_obj
        new_qs = [parse_xpath(q) if isinstance(q, str) else q
                  for q in queries]
        if not new_qs:
            return self, []
        sizes = self.partition.part_sizes()
        p = int(np.argmin(sizes))
        live = [(g, q) for g, q in
                zip(self.part_cols[p], self.part_queries[p]) if g >= 0]
        new_gids = list(range(self.n_global, self.n_global + len(new_qs)))
        cols_p = tuple(g for g, _ in live) + tuple(new_gids)
        qs_p = tuple(q for _, q in live) + tuple(new_qs)
        nfa_p = eng._maybe_minimize(
            compile_queries(qs_p, eng.dictionary, shared=self.shared))
        part_nfas = list(self.part_nfas)
        part_nfas[p] = nfa_p
        fresh = eng.part_pads(part_nfas, query_bucket=self.query_bucket)
        self.wait()      # the parts kept are read on this thread's stream
        plans = list(self.plans)
        stacked = None
        one_part = None
        if all(fresh.get(k, 0) <= self.pads.get(k, 0) for k in fresh):
            try:
                one_part = eng.plan_part(nfa_p, self.pads)
            except PadOverflow:
                one_part = None
        if one_part is not None:
            pads = self.pads
            plans[p] = one_part
            # one part's rows replaced in new tensors: the device-side
            # cost of a subscribe stays O(1/P), and the old tables stay
            stacked = self._restacked(plans, [p])
        else:
            pads = eng.merge_pads(self.pads, fresh, part_nfas)
            plans = [eng.plan_part(nfa, pads) for nfa in part_nfas]
        part_cols = list(self.part_cols)
        part_queries = list(self.part_queries)
        part_cols[p] = cols_p
        part_queries[p] = qs_p
        sp = ShardedPlan(eng, plans, part_cols, part_queries, part_nfas,
                         pads, self.n_global + len(new_qs),
                         self.query_bucket, self.shared, stacked=stacked)
        return sp, new_gids

    def remove_queries(self, gids: Sequence[int]) -> "ShardedPlan":
        """Unsubscribe by global id: O(1) metadata, no recompilation.

        The columns stay in the compiled plans (tombstoned: excluded from
        the partition index and from every result) and are dropped the
        next time their part recompiles.  The plans and the stacked
        tables carry over as they are.
        """
        dead = set(int(g) for g in gids)
        part = self.partition
        for g in dead:
            if not (0 <= g < self.n_global) or part.part_of[g] < 0:
                raise KeyError(f"query id {g} is not subscribed")
        part_cols = [tuple(-1 if g in dead else g for g in cols)
                     for cols in self.part_cols]
        self.wait()
        return ShardedPlan(self._engine_obj, self.plans, part_cols,
                           self.part_queries, self.part_nfas, self.pads,
                           self.n_global, self.query_bucket, self.shared,
                           stacked=self._stacked)


# --------------------------------------------------------------- the engine
class FilterEngine(abc.ABC):
    """Uniform engine interface: compile once, filter batches forever."""

    #: registry key, set by the :func:`register` decorator
    name: ClassVar[str] = ""

    #: state-axis pad multiple of this engine's plan tables; the
    #: ``state_multiple=`` option overrides it per instance
    state_multiple: ClassVar[int] = 1

    #: True for engines that run a batch as one device program
    #: (:meth:`_prep` then :meth:`_run_with_plan`); False for host engines,
    #: which loop documents in Python
    device_sharded: ClassVar[bool] = False

    def __init__(self, nfa: NFA, dictionary=None, *,
                 device: str | torch.device = "cuda", **options: Any) -> None:
        for key in options:
            if key in NOT_PORTED:
                raise NotImplementedError(
                    f"engine option {key}= has no counterpart in the "
                    f"port: {NOT_PORTED[key]}")
        if "state_multiple" in options:
            self.state_multiple = int(options.pop("state_multiple"))
        self.dictionary = dictionary
        self.device = torch.device(device)
        self._memo_lock = threading.Lock()
        self._lane_cache: dict = {}
        # global NFA minimization (``minimize=True``): behaviour-identical
        # states merge before any plan compiles; the sharded and churn
        # paths route every new NFA through _maybe_minimize
        self._minimize = bool(options.pop("minimize", False))
        self.minimize_stats: MinimizeStats | None = None
        if self._minimize:
            nfa, self.minimize_stats = minimize_nfa(nfa)
        # persistent compiled-plan cache (``plan_cache=``: a PlanCache or
        # a directory): every compile site goes through _plan_cached, so a
        # cold start or a shadow rebuild skips the compile on a hit
        cache = options.pop("plan_cache", None)
        if isinstance(cache, (str, os.PathLike)):
            from ...checkpoint.store import PlanCache

            cache = PlanCache(os.fspath(cache))
        self.plan_cache = cache
        self.nfa = nfa
        self.options = options
        self.n_queries = nfa.n_queries
        self.plan_: FilterPlan = self._plan_cached(nfa)
        # the plan's tables were copied to the card on this thread's
        # current stream; a reader on another stream waits for this
        self._plan_ready = _record_event(self.device)

    def _maybe_minimize(self, nfa: NFA) -> NFA:
        """Minimize a new NFA when the engine was built with
        ``minimize=True``: the initial plan, sharded parts, churn and
        rebalance recompiles all shrink the same way."""
        if not self._minimize:
            return nfa
        return minimize_nfa(nfa)[0]

    def wait_plan(self) -> None:
        """Make the current stream wait until the plan's tables are on
        the device.  A serve-loop worker filters on a stream of its own,
        and an engine built by the shadow builder copied its tables on
        the builder's; the wait orders the two on the card, with no host
        synchronisation.  Nothing to wait for off the card."""
        if self._plan_ready is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._plan_ready)

    # ------------------------------------------------------------ contract
    @abc.abstractmethod
    def plan(self, nfa: NFA) -> FilterPlan:
        """Compile the NFA into this engine's device tables (once)."""

    @abc.abstractmethod
    def filter_batch(self, batch: EventBatch) -> FilterResult:
        """Filter a document batch; returns a ``(B, Q)`` result."""

    def device_verdicts(self, batch: EventBatch
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, Q)`` matched (bool) and first (int32) tensors of a batch,
        left on the device (what :meth:`filter_batch` brings back)."""
        return self._run_with_plan(self.plan_, self._prep(batch))

    # ------------------------------------------------- explicit-plan filter
    def _prep_host(self, batch: EventBatch) -> tuple:
        """Plan-independent document-side preparation (device engines):
        whatever :meth:`_run_with_plan` consumes — event words, level
        buckets, chunk layouts — as host arrays (tensors for a batch
        parsed on a device), before they are staged on a device."""
        raise NotImplementedError(
            f"{self.name}: no device prep (host engine)")

    def _prep(self, batch: EventBatch) -> tuple:
        """:meth:`_prep_host` staged on this engine's device."""
        return tuple(self.to_device(a) for a in self._prep_host(batch))

    def _parse_arrays(self, data: torch.Tensor, n_events: int,
                      max_depth: int) -> tuple:
        """Device parse of a ``(B, L)`` byte tensor into what
        :meth:`_prep_arrays` takes: ``(kind, tag, depth, parent, valid,
        n)`` (:func:`repro_torch.kernels.parse.parse_arrays`)."""
        from ...kernels.parse import parse_arrays

        return parse_arrays(data, n_events=n_events, max_depth=max_depth)

    def _prep_arrays(self, kind, tag, depth, parent, valid, n_events
                     ) -> tuple:
        """Device-side document prep straight from the parse's outputs.

        Implemented by engines whose plan metadata records ``prep ==
        "events-device"`` (streaming, matscan: their kernels consume the
        raw event stream), which is what lets the 2-D bytes route parse
        and filter on a position with no host hop.  Engines with host
        prep (the levelwise family buckets by depth in numpy) or host
        execution never get here."""
        raise NotImplementedError(
            f"{self.name}: no device parse prep "
            f"(plan meta 'prep' is not 'events-device')")

    def _run_with_plan(self, plan: FilterPlan, prep: tuple
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Explicit plan + prepped batch → ``(B, Q)`` matched and first,
        on the device."""
        raise NotImplementedError(
            f"{self.name}: no device run (host engine)")

    def filter_batch_with_plan(self, plan: FilterPlan,
                               batch: EventBatch) -> FilterResult:
        """:meth:`filter_batch` against an explicit plan (any compiled
        profile set, not just ``self.plan_``)."""
        matched, first = self._run_with_plan(plan, self._prep(batch))
        return FilterResult(matched.cpu().numpy(), first.cpu().numpy())

    def filter_bytes(self, bb: ByteBatch, *,
                     bucket: int | None = None) -> FilterResult:
        """Raw wire bytes → ``(B, Q)`` verdicts, parsed on the device.

        The batch is parsed by :func:`repro_torch.kernels.parse.
        parse_batch` and fed to :meth:`filter_batch` as an `EventBatch`
        of device tensors.  The parse honours the engine's ``max_depth``
        and raises :class:`~repro_torch.core.events.DepthOverflow` on
        documents nested deeper.  ``bucket`` pads the event axis;
        ``None`` resolves through :meth:`_event_bucket`.  Engines with a
        one-launch bytes path override this.
        """
        return self.filter_batch(self._parse(bb, bucket))

    def _parse(self, bb: ByteBatch, bucket: int | None) -> EventBatch:
        from ...kernels.parse import parse_batch

        return parse_batch(
            bb, n_events=bb.event_bound(bucket=self._event_bucket(bucket)),
            max_depth=int(getattr(self, "max_depth", DEFAULT_MAX_DEPTH)),
            device=self.device)

    def _event_bucket(self, bucket: int | None) -> int:
        """The event-axis padding bucket of the byte paths: the argument,
        else the ``event_bucket=`` option (``FilterStage`` sets it to its
        own ``bucket``), else :data:`DEFAULT_EVENT_BUCKET`."""
        if bucket is not None:
            return int(bucket)
        return int(self.options.get("event_bucket", DEFAULT_EVENT_BUCKET))

    # ------------------------------------------------- sparse verdict path
    def match_cap(self, batch_size: int, n_cols: int,
                  cap: int | None = None) -> int:
        """The bounded match-buffer size of one sparse call.

        The argument wins, then the ``match_cap=`` option; the default
        budgets 32 matches per document (at least 4096).  Clamped to the
        dense size, past which the buffer cannot overflow.
        """
        if cap is None:
            cap = self.options.get("match_cap")
        if cap is None:
            cap = max(4096, 32 * batch_size)
        return int(max(1, min(int(cap), batch_size * max(1, n_cols))))

    def _sparse_from_buffers(self, bufs, count: int, cap: int, *,
                             batch_size: int, n_queries: int,
                             live_ids=None, sort: bool = False,
                             meta: dict | None = None,
                             dense_fallback=None) -> SparseResult:
        """A :class:`SparseResult` from :func:`_compact_matches` output.

        Only the first ``count`` rows of ``bufs`` are real.  ``count >
        cap`` means the buffer overflowed: the verdicts are recomputed by
        ``dense_fallback()``, exact, flagged ``overflowed`` and named
        ``path="dense-overflow"``, with the route that was tried kept as
        ``attempted_path``.  ``live_ids`` names the columns of a sharded
        result by global id; ``sort`` restores (doc, id) order of rows
        that parts produced interleaved.
        """
        meta = dict(meta or (), match_cap=cap)
        if count > cap:
            sp = dense_fallback().sparsify(live_ids)
            sp.overflowed = True
            sp.meta.update(meta, matches=count,
                           attempted_path=meta.get("path"),
                           path="dense-overflow")
            return sp
        docs, cols, first = (b[:count].cpu().numpy() for b in bufs)
        if sort:
            order = np.lexsort((cols, docs))
            docs, cols, first = docs[order], cols[order], first[order]
        return SparseResult(
            docs, cols, first, batch_size=batch_size, n_queries=n_queries,
            live_ids=(None if live_ids is None
                      else np.asarray(live_ids, np.int32)),
            meta=meta)

    def filter_batch_sparse(self, batch: EventBatch, *,
                            match_cap: int | None = None) -> SparseResult:
        """Sparse twin of :meth:`filter_batch`: the dense verdict is
        compacted on the device (:func:`_compact_matches`), and the host
        reads a bounded ``(doc, query, first)`` list instead of the
        ``(B, Q)`` bitmap (``path="device-compact"``).
        :meth:`SparseResult.densify` gives back :meth:`filter_batch`.
        Host engines sparsify their dense result (``path="dense-host"``):
        they have no device transfer to save."""
        if not self.device_sharded:
            sp = self.filter_batch(batch).sparsify()
            sp.meta["path"] = "dense-host"
            return sp
        matched, first = self.device_verdicts(batch)
        b, q = batch.batch_size, int(matched.shape[-1])
        cap = self.match_cap(b, q, match_cap)
        *bufs, n = _compact_matches(
            matched, first,
            torch.arange(q, dtype=torch.int32, device=matched.device), cap)
        return self._sparse_from_buffers(
            bufs, int(n), cap, batch_size=b, n_queries=q,
            meta={"path": "device-compact"},
            dense_fallback=lambda: FilterResult(matched.cpu().numpy(),
                                                first.cpu().numpy()))

    def filter_bytes_sparse(self, bb: ByteBatch, *,
                            bucket: int | None = None,
                            match_cap: int | None = None) -> SparseResult:
        """Bytes in, sparse match list out: device parse (raising
        :class:`~repro_torch.core.events.DepthOverflow` past
        ``max_depth``), then :meth:`filter_batch_sparse`."""
        return self.filter_batch_sparse(self._parse(bb, bucket),
                                        match_cap=match_cap)

    # ------------------------------------------------- memoised derivations
    def _lane_memo(self, obj, build, tag: str = "lanes"):
        """Tiny identity-keyed memo of tables derived from a frozen plan
        (identity is validity; bounded, so replaced plans do not pin
        memory): the lane-class tables of the sparse paths, the folded
        tables of a sharded plan.

        The serve loop's workers call it at the same time: a miss builds
        outside the lock and inserts under it (a racing build of the same
        plan is equal and dropped).  The tensors are made on the
        builder's stream, so each reader's stream waits for them and is
        recorded as a user of them, and their memory is not reused while
        a reader's kernels may still read it."""
        key = (id(obj), tag)
        with self._memo_lock:
            hit = self._lane_cache.get(key)
        if hit is None or hit[0] is not obj:
            val = build()
            tensors = _tensors(val)
            ready = (_record_event(tensors[0].device) if tensors else None)
            hit = (obj, val, ready)
            with self._memo_lock:
                cache = self._lane_cache
                old = cache.get(key)
                if old is not None and old[0] is obj:
                    hit = old
                else:
                    if len(cache) >= 32:
                        cache.pop(next(iter(cache)))
                    cache[key] = hit
        _, val, ready = hit
        _use_on_current_stream(ready, _tensors(val))
        return val

    # ------------------------------------------------------- sharded plans
    def part_pads(self, parts: Sequence[NFA], *,
                  query_bucket: int = 8) -> dict[str, int]:
        """Uniform pad targets for a set of partition NFAs.

        Device engines pad every part to common bucket sizes so the
        per-part tables stack (state axis to the engine's
        ``state_multiple``, query axis to ``query_bucket``); engines add
        their own table axes.  Host engines return ``{}``: their parts are
        looped.  Buckets give churn headroom: an added query forces a
        global re-pad only when its part overflows a bucket.
        """
        if not self.device_sharded:
            return {}
        s = max((nfa.n_states for nfa in parts), default=1)
        q = max((nfa.n_queries for nfa in parts), default=1)
        return {"n_states": _round_up(s, self.state_multiple),
                "n_queries": _round_up(max(q, 1), query_bucket)}

    def plan_part(self, nfa: NFA, pads: Mapping[str, int]) -> FilterPlan:
        """Compile one partition's NFA at the shared pad targets, through
        the persistent plan cache when one is configured
        (:meth:`_plan_cached`).

        Every part compile of :class:`ShardedPlan` goes through this
        method, so a caller may wrap it on the instance (the chaos
        harness forces a ``PadOverflow`` here).
        """
        return self._plan_cached(nfa, pads)

    # ------------------------------------------------ persistent plan cache
    def kernel_config(self, n_states: int, n_tags: int) -> dict | None:
        """The launch shape a plan of ``n_states`` (padded) states over
        ``n_tags`` tags compiles in; ``None`` for engines without one.
        The streaming engine overrides it."""
        return None

    def _plan_shape(self, nfa: NFA, pads: Mapping[str, int] | None
                    ) -> tuple[int, int]:
        """(padded states, tags) of the plan that ``nfa`` at ``pads``
        compiles to: what :meth:`kernel_config` is asked for."""
        if pads:
            return (int(pads.get("n_states", nfa.n_states)),
                    max(int(nfa.n_tags), int(pads.get("n_tags", 0))))
        s = int(nfa.n_states)
        return s + -s % int(self.state_multiple), int(nfa.n_tags)

    def plan_cache_key(self, nfa: NFA,
                       pads: Mapping[str, int] | None = None) -> str:
        """Content hash of one compiled plan's inputs.

        It hashes :data:`PLAN_CACHE_VERSION`, the engine name, the device
        type, ``state_multiple``, the engine's ``max_depth`` (where it has
        one), the sorted options, the effective :meth:`kernel_config`, the
        pads and the NFA (its tables, tag and query counts, sharing and
        the canonical text of its queries).  Every input that can change
        the tables changes the key, so a stale hit cannot happen; the
        JAX package's Pallas switches (interpret mode, its budget
        variables) mean nothing here and are not hashed.
        """
        cfg = self.kernel_config(*self._plan_shape(nfa, pads))
        h = hashlib.sha256()
        for part in (
                PLAN_CACHE_VERSION, self.name, self.device.type,
                str(self.state_multiple),
                repr(getattr(self, "max_depth", None)),
                repr(sorted((k, repr(v)) for k, v in self.options.items())),
                repr(None if cfg is None else sorted(cfg.items())),
                repr(sorted((pads or {}).items())),
                str(int(nfa.n_tags)), str(int(nfa.n_queries)),
                "shared" if nfa.shared else "unshared",
                repr(tuple(str(q) for q in nfa.queries))):
            h.update(part.encode())
            h.update(b"\x00")
        for arr in nfa.tables:
            a = np.ascontiguousarray(arr)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()[:40]

    def _plan_from_tables(self, tables: Mapping[str, np.ndarray],
                          meta: Mapping[str, Any]) -> FilterPlan:
        """A cached entry's numpy tables → this engine's plan on its
        device, through the table checks of :mod:`repro_torch.convert`
        (raising ``ValueError`` on tables that fail them).  Each device
        engine family overrides it."""
        raise ValueError(f"{self.name}: no cached plan form")

    def _plan_hit(self, tables: dict[str, np.ndarray], manifest: dict
                  ) -> FilterPlan:
        """What :meth:`PlanCache.load` calls on a hit: refuse an entry of
        another engine, or whose tables do not hash to the digest written
        with them, then rebuild the plan through the table checks."""
        if manifest.get("engine") != self.name:
            raise ValueError(f"a {manifest.get('engine')!r} entry")
        if manifest.get("digest") != _tables_digest(tables):
            raise ValueError("tables do not match their digest")
        plan = self._plan_from_tables(tables, manifest.get("meta", {}))
        if plan.meta != manifest.get("meta"):
            raise ValueError("the rebuilt plan's metadata differs")
        return plan

    def _plan_cached(self, nfa: NFA,
                     pads: Mapping[str, int] | None = None) -> FilterPlan:
        """Compile ``nfa`` (at ``pads``, a sharded part), through the
        persistent plan cache when one is configured.

        Only device engines cache (host plans hold Python structures, and
        there is no compile to skip).  A hit rebuilds the plan from the
        stored tables with no :meth:`plan` call, through
        :meth:`_plan_from_tables`' checks, so no kernel reads a table
        that was not checked; an entry that fails them counts as a miss,
        is recompiled and overwritten.  A miss compiles and writes the
        entry through the crash-safe ``PlanCache.put``; a plan whose
        metadata does not survive a JSON round trip exactly is not
        cached.  The tables land on the calling thread's current stream,
        which the engine's and the sharded plan's ready events follow.
        """
        cache = self.plan_cache
        if cache is None or not self.device_sharded:
            return (self._plan_part_uncached(nfa, pads)
                    if pads is not None else self.plan(nfa))
        key = self.plan_cache_key(nfa, pads)
        plan = cache.load(key, self._plan_hit)
        if plan is not None:
            return plan
        plan = (self._plan_part_uncached(nfa, pads)
                if pads is not None else self.plan(nfa))
        meta = plan.meta
        try:
            exact = json.loads(json.dumps(meta)) == meta
        except (TypeError, ValueError):
            exact = False
        if exact:
            tables = {k: v.cpu().numpy() for k, v in plan.tables.items()}
            cache.put(key, tables, {"engine": plan.engine, "meta": meta,
                                    "digest": _tables_digest(tables)})
        return plan

    def _plan_part_uncached(self, nfa: NFA,
                            pads: Mapping[str, int]) -> FilterPlan:
        """The compile body of :meth:`plan_part`: the NFA padded to the
        tag space and state count of ``pads``, planned with the pads in
        hand (:meth:`_plan_padded`: the streaming engine's block layout
        reads its targets from them), then its query axis padded."""
        if not pads:
            return self.plan(nfa)
        if "n_tags" in pads and pads["n_tags"] > nfa.n_tags:
            nfa = dataclasses.replace(nfa, n_tags=pads["n_tags"])
        nfa = pad_states(nfa, to=pads["n_states"])
        plan = self._plan_padded(nfa, pads)
        return self._pad_plan_queries(plan, pads["n_queries"])

    def _plan_padded(self, nfa: NFA, pads: Mapping[str, int]) -> FilterPlan:
        """:meth:`plan` of a part at uniform pads; engines whose derived
        table shapes are not a function of the NFA alone override it."""
        return self.plan(nfa)

    def _pad_plan_queries(self, plan: FilterPlan,
                          n_queries: int) -> FilterPlan:
        """Pad the plan's query axis with never-matching columns: they
        accept at state 0, the root, which no OPEN event activates."""
        acc = plan["accept_state"]
        extra = n_queries - int(acc.shape[0])
        if extra <= 0:
            return plan
        tables = plan.tables
        tables["accept_state"] = torch.cat([acc, acc.new_zeros(extra)])
        return FilterPlan(plan.engine, tables, plan.meta)

    def merge_pads(self, old: Mapping[str, int], new: Mapping[str, int],
                   parts: Sequence[NFA]) -> dict[str, int]:
        """Reconcile churn pad targets when new queries overflow a bucket:
        the per-key maximum.  Engines whose derived shapes are joint
        functions of several targets re-derive them (streaming)."""
        return {k: max(new.get(k, 0), old.get(k, 0))
                for k in set(new) | set(old)}

    def plan_sharded(self, n_parts: int, *,
                     query_bucket: int = 8) -> ShardedPlan:
        """Partition this engine's profile set and compile per-part plans
        at uniform pads: the :class:`ShardedPlan` that the
        ``filter_*_sharded`` methods run and whose ``add_queries`` /
        ``remove_queries`` absorb churn."""
        parts, partition = partition_queries(
            list(self.nfa.queries), n_parts, self.dictionary,
            shared=self.nfa.shared)
        parts = [self._maybe_minimize(p) for p in parts]
        # local ids ascend with the global id inside each part
        part_cols: list[list[int]] = [[] for _ in range(n_parts)]
        for gid in range(len(self.nfa.queries)):
            part_cols[int(partition.part_of[gid])].append(gid)
        part_queries = [[self.nfa.queries[g] for g in cols]
                        for cols in part_cols]
        pads = self.part_pads(parts, query_bucket=query_bucket)
        plans = [self.plan_part(nfa, pads) for nfa in parts]
        return ShardedPlan(self, plans, part_cols, part_queries, parts,
                           pads, len(self.nfa.queries), query_bucket,
                           self.nfa.shared)

    def _run_parts(self, sharded: ShardedPlan, prep: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every part of a sharded plan over one prepped batch → ``(P, B,
        Qpad)`` matched and first on the device.  Engines with a folded
        form run all parts in one launch; this default runs
        :meth:`_run_with_plan` part by part."""
        outs = [self._run_with_plan(plan, prep) for plan in sharded.plans]
        return (torch.stack([m for m, _ in outs]),
                torch.stack([f for _, f in outs]))

    def _run_sharded(self, batch: EventBatch, sharded: ShardedPlan
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        sharded.wait()
        return self._run_parts(sharded, self._prep(batch))

    def _live_index(self, sharded: ShardedPlan
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(part, local) of the live ids, in global order, on the
        device."""

        def build():
            part_of, local_of = sharded.index_arrays()
            return (torch.from_numpy(part_of.astype(np.int64)).to(
                        sharded.device),
                    torch.from_numpy(local_of.astype(np.int64)).to(
                        sharded.device))

        return self._lane_memo(sharded, build, "live")

    def _live_columns(self, matched: torch.Tensor, first: torch.Tensor,
                      sharded: ShardedPlan) -> FilterResult:
        """``(P, B, Qpad)`` part verdicts → the ``(B, Q_live)`` result in
        live-global-id order, tombstones excluded."""
        part, local = self._live_index(sharded)
        return FilterResult(matched[part, :, local].T.cpu().numpy(),
                            first[part, :, local].T.cpu().numpy())

    def _position_verdicts(self, sub: ShardedPlan, prep: tuple
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """One mesh position's launch: a prepped batch slice through the
        parts of ``sub`` → ``(B, Q_live(sub))`` matched (bool) and first
        (int32) on the position's device, columns in ascending global
        id.  Engines whose kernel reads lanes (streaming) override it."""
        matched, first = self._run_parts(sub, prep)
        part, local = self._live_index(sub)
        return matched[part, :, local].T, first[part, :, local].T

    # --------------------------------------------------------- the mesh
    def _one_card(self, mesh) -> bool:
        """No mesh, or a 1 × 1 mesh on this engine's own device: the
        one-card path, every part in one launch on the current stream."""
        return mesh is None or (
            mesh.size == 1 and mesh.devices[0] == resolve_device(self.device))

    def _check_model_axis(self, sharded: ShardedPlan, mesh) -> None:
        if mesh is None:
            return
        axis = dict(mesh.shape).get("model", 1)
        if axis > 1 and sharded.n_parts % axis != 0:
            raise ValueError(
                f"n_parts={sharded.n_parts} not divisible by mesh "
                f"model axis {axis}")

    def _mesh_axes2d(self, mesh) -> tuple[int, int]:
        if mesh is None:
            raise ValueError(
                "the 2-D path needs a ('data', 'model') mesh — see "
                "repro_torch.launch.mesh.make_filter_mesh(data_shards=...)")
        shape = dict(mesh.shape)
        if "data" not in shape or "model" not in shape:
            raise ValueError(
                f"2-D filtering needs a ('data', 'model') mesh, got axes "
                f"{tuple(shape)}")
        return shape["data"], shape["model"]

    def _positions(self, sharded: ShardedPlan, mesh, body, *,
                   n_data: int | None = None) -> tuple[_Inflight, int]:
        """Run ``body(pos)`` (a :class:`_Position`) at every position of
        the mesh's ``"data"`` × ``"model"`` grid, or with ``n_data=None``
        at the model positions of its first data row (the 1-D ``mesh=``
        paths: the parts over ``"model"``, the whole batch at each).
        Returns the dispatch in flight and the model axis's size."""
        shape = dict(mesh.shape)
        n_model = shape.get("model", 1)
        fl = _Inflight(mesh)
        for d in range(1 if n_data is None else n_data):
            for m in range(n_model):
                coords = {a: c for a, c in zip(AXES, (d, m)) if a in shape}
                idx = mesh.position(**coords)

                def fn(dev, d=d, m=m, idx=idx):
                    sub = sharded.model_slice(m, n_model, dev)
                    sub.wait()
                    return body(_Position(fl, idx, d, m, dev, sub))

                fl.run(idx, fn)
        return fl, n_model

    def _model_verdicts(self, sharded: ShardedPlan, mesh, body
                        ) -> tuple[np.ndarray, np.ndarray]:
        """The 1-D ``mesh=`` run: ``body`` at each model position, then
        ``(rows, ..., Q_live)`` matched and first on the host."""
        fl, n_model = self._positions(sharded, mesh, body)
        outs, perm = fl.wait(), _live_perm(sharded, n_model)
        return _gather(outs, 1, n_model, perm, 0), _gather(
            outs, 1, n_model, perm, 1)

    def _materializer2d(self, fl: _Inflight, sharded: ShardedPlan,
                        n_data: int, n_model: int, finish):
        """Zero-arg materializer of a 2-D dispatch: calling it waits on the
        positions' events, gathers every position's ``(rows, ..., Q_m)``
        outputs in live-global-id order, and hands them to ``finish``,
        which slices off the pad rows (the deferred half of
        :meth:`dispatch_batch_sharded2d`)."""
        perm = _live_perm(sharded, n_model)

        def materialize() -> FilterResult:
            outs = fl.wait()
            return finish(_gather(outs, n_data, n_model, perm, 0),
                          _gather(outs, n_data, n_model, perm, 1))

        return materialize

    def _stage_rows(self, pos: _Position, placed, rows,
                    n_rows: int) -> torch.Tensor:
        """A position's slice of byte rows on its device: the copy a
        :meth:`ByteBatch.device_put` over the same mesh staged there, or
        ``rows[d·n:(d+1)·n]`` staged now."""
        if placed is not None and placed.mesh is pos.fl.mesh:
            return placed.take(pos.idx)
        return pos.stage(self, rows[pos.d * n_rows:(pos.d + 1) * n_rows])

    # ------------------------------------------------------- sharded runs
    def filter_batch_sharded(self, batch: EventBatch, sharded: ShardedPlan,
                             *, mesh=None) -> FilterResult:
        """Filter through a partitioned plan; ``(B, Q_live)`` result.

        Device engines run every part in one launch of their kernel on
        this card, or with ``mesh`` (:func:`repro_torch.launch.mesh.
        make_filter_mesh`) the parts spread over the mesh's ``"model"``
        axis, each position folding its slice of them into one launch;
        host engines loop parts.  Columns come back in live-global-id
        order (the original query order for an unchurned plan),
        tombstones excluded.
        """
        if self.device_sharded:
            self._check_model_axis(sharded, mesh)
            if self._one_card(mesh):
                return self._live_columns(
                    *self._run_sharded(batch, sharded), sharded)
            host = self._prep_host(batch)
            return FilterResult(*self._model_verdicts(
                sharded, mesh, lambda pos: self._position_verdicts(
                    pos.sub, tuple(pos.stage(self, a) for a in host))))
        part_of, local_of = sharded.index_arrays()
        outs = [self.filter_batch_with_plan(plan, batch)
                for plan in sharded.plans]
        b = batch.batch_size
        matched = np.zeros((b, part_of.shape[0]), bool)
        first = np.full((b, part_of.shape[0]), NO_MATCH, np.int32)
        for j, (p, c) in enumerate(zip(part_of, local_of)):
            matched[:, j] = outs[p].matched[:, c]
            first[:, j] = outs[p].first_event[:, c]
        return FilterResult(matched, first)

    def filter_batch_sharded_sparse(self, batch: EventBatch,
                                    sharded: ShardedPlan, *, mesh=None,
                                    match_cap: int | None = None
                                    ) -> SparseResult:
        """Sparse twin of :meth:`filter_batch_sharded`: one device
        compaction over the ``(P, B, Qpad)`` verdicts with columns named
        by global subscriber id (tombstoned and pad columns discarded on
        the device); ``query_ids`` are global ids and ``densify`` gives
        back :meth:`filter_batch_sharded`.  With ``mesh`` each model
        position compacts its parts into a buffer of its own; the rows
        come back whole while the summed count fits ``cap``, as the one
        compaction's would."""
        live_ids = sharded.live_ids()
        if not self.device_sharded:
            sp = self.filter_batch_sharded(batch, sharded,
                                           mesh=mesh).sparsify(live_ids)
            sp.meta["path"] = "dense-host"
            return sp
        self._check_model_axis(sharded, mesh)
        b = batch.batch_size
        cap = self.match_cap(b, len(live_ids), match_cap)
        if self._one_card(mesh):
            matched, first = self._run_sharded(batch, sharded)
            cols = torch.from_numpy(sharded.gid_columns()).to(matched.device)
            *bufs, n = _compact_parts(matched, first, cols, cap)
            return self._sparse_from_buffers(
                bufs, int(n), cap, batch_size=b, n_queries=len(live_ids),
                live_ids=live_ids, sort=True,
                meta={"path": "device-compact"},
                dense_fallback=lambda: self._live_columns(matched, first,
                                                          sharded))
        host = self._prep_host(batch)

        def body(pos):
            matched, first = self._run_parts(
                pos.sub, tuple(pos.stage(self, a) for a in host))
            cols = torch.from_numpy(pos.sub.gid_columns()).to(pos.dev)
            bdoc, bcol, bfirst, n = _compact_parts(matched, first, cols, cap)
            return bdoc, bcol, bfirst, n.reshape(1)

        fl, _ = self._positions(sharded, mesh, body)
        outs = fl.wait()
        (docs, cols, first), n, _ = _position_rows(
            [(np.stack(o[:3], 1), o[3]) for o in outs], cap)
        return self._sparse_from_buffers(
            [torch.from_numpy(x) for x in (docs, cols, first)], n, cap,
            batch_size=b, n_queries=len(live_ids), live_ids=live_ids,
            sort=True, meta={"path": "device-compact"},
            dense_fallback=lambda: self.filter_batch_sharded(
                batch, sharded, mesh=mesh))

    def filter_bytes_sharded(self, bb: ByteBatch, sharded: ShardedPlan, *,
                             bucket: int | None = None,
                             mesh=None) -> FilterResult:
        """Sharded twin of :meth:`filter_bytes`: device parse once, then
        every part in one launch (or one a model position); bytes in,
        ``(B, Q_live)`` out."""
        return self.filter_batch_sharded(self._parse(bb, bucket), sharded,
                                         mesh=mesh)

    def filter_bytes_sharded_sparse(self, bb: ByteBatch,
                                    sharded: ShardedPlan, *,
                                    bucket: int | None = None, mesh=None,
                                    match_cap: int | None = None
                                    ) -> SparseResult:
        """Sharded bytes → sparse twin: device parse, then
        :meth:`filter_batch_sharded_sparse`."""
        return self.filter_batch_sharded_sparse(
            self._parse(bb, bucket), sharded, mesh=mesh, match_cap=match_cap)

    # ------------------------------------------------ 2-D (data × model)
    def dispatch_batch_sharded2d(self, batch: EventBatch,
                                 sharded: ShardedPlan, *, mesh):
        """Launch the 2-D (data × model) filter; returns a zero-arg
        materializer — call it to wait and get the ``(B, Q_live)``
        :class:`FilterResult`.

        Both of the paper's replication axes (§3.5): the stacked per-part
        tables are split over the mesh's ``"model"`` axis (each position
        advances its slice of the subscription set, folded into one
        launch) and the batch over ``"data"`` (each row of positions sees
        its slice of the documents).  The batch is padded to a multiple
        of the data axis with inert all-PAD documents, sliced back off
        the result, so any batch size is servable.  The launches are
        queued on the positions' streams and this returns at once; the
        materializer is the synchronisation point, which the pipelined
        route overlaps the next batch's staging against.  Host engines
        compute eagerly (the part loop is the bit-equivalence oracle for
        this path) and return an already-resolved thunk.
        """
        if not self.device_sharded:
            res = self.filter_batch_sharded(batch, sharded)
            return lambda: res
        n_data, n_model = self._mesh_axes2d(mesh)
        self._check_model_axis(sharded, mesh)
        b0 = batch.batch_size
        batch = batch.pad_batch_to(_round_up(b0, n_data))
        rows = batch.batch_size // n_data
        hosts = [self._prep_host(batch.rows(d * rows, (d + 1) * rows))
                 for d in range(n_data)]
        fl, _ = self._positions(
            sharded, mesh, lambda pos: self._position_verdicts(
                pos.sub, tuple(pos.stage(self, a) for a in hosts[pos.d])),
            n_data=n_data)
        return self._materializer2d(
            fl, sharded, n_data, n_model,
            lambda m, f: FilterResult(m[:b0], f[:b0]))

    def filter_batch_sharded2d(self, batch: EventBatch,
                               sharded: ShardedPlan, *,
                               mesh) -> FilterResult:
        """Blocking convenience over :meth:`dispatch_batch_sharded2d`."""
        return self.dispatch_batch_sharded2d(batch, sharded, mesh=mesh)()

    def filter_batch_sharded2d_sparse(self, batch: EventBatch,
                                      sharded: ShardedPlan, *, mesh,
                                      match_cap: int | None = None
                                      ) -> SparseResult:
        """Sparse wire format over the 2-D path: the gathered dense
        result, sparsified on the host (``path="dense-2d"``)."""
        sp = self.filter_batch_sharded2d(
            batch, sharded, mesh=mesh).sparsify(sharded.live_ids())
        sp.meta["path"] = "dense-2d"
        return sp

    def dispatch_bytes_sharded2d(self, bb, sharded: ShardedPlan, *,
                                 bucket: int | None = None, mesh,
                                 n_events: int | None = None):
        """ByteBatch twin of :meth:`dispatch_batch_sharded2d`.

        ``bb`` is a :class:`ByteBatch`, or one already staged over the mesh
        (:meth:`ByteBatch.device_put`), whose per-position copies the
        launches then read.  Engines whose plan records ``prep ==
        "events-device"`` parse each position's slice of the wire bytes
        on its device (K5) and filter it there
        (:meth:`_parse_arrays`, :meth:`_prep_arrays`); engines with host
        prep (the levelwise family) parse each slice on its device, bucket
        it on the host and filter it on the device (the reference's
        parse-first route, :func:`~repro_torch.kernels.parse.
        parse_tensor`, raising ``DepthOverflow`` past ``max_depth``); host
        engines loop parts (the bit-equivalence oracle).

        ``n_events`` is the static compacted event bound; the pipelined
        route computes it from the host copy before staging.
        """
        from ...kernels.parse import parse_batch, parse_tensor

        placed = bb if isinstance(bb, PlacedBytes) else None
        host = placed.host if placed is not None else bb
        max_depth = int(getattr(self, "max_depth", DEFAULT_MAX_DEPTH))
        if n_events is None:
            n_events = host.event_bound(bucket=self._event_bucket(bucket))
        if not self.device_sharded:
            res = self.filter_batch_sharded(
                parse_batch(host, n_events=n_events, max_depth=max_depth,
                            device=self.device), sharded)
            return lambda: res
        n_data, n_model = self._mesh_axes2d(mesh)
        self._check_model_axis(sharded, mesh)
        b0 = host.batch_size
        padded = host.pad_batch_to(_round_up(b0, n_data))
        rows = padded.batch_size // n_data
        on_device = sharded.plans[0].meta.get("prep") == "events-device"

        def body(pos):
            data = self._stage_rows(pos, placed, padded.data, rows)
            if on_device:
                prep = self._prep_arrays(
                    *self._parse_arrays(data, n_events, max_depth))
            else:
                eb = parse_tensor(data, n_events=n_events,
                                  max_depth=max_depth, first_doc=pos.d * rows)
                prep = tuple(pos.stage(self, a) for a in self._prep_host(eb))
            return self._position_verdicts(pos.sub, prep)

        fl, _ = self._positions(sharded, mesh, body, n_data=n_data)
        fl.keep(placed)
        return self._materializer2d(
            fl, sharded, n_data, n_model,
            lambda m, f: FilterResult(m[:b0], f[:b0]))

    def filter_bytes_sharded2d(self, bb, sharded: ShardedPlan, *,
                               bucket: int | None = None, mesh,
                               n_events: int | None = None) -> FilterResult:
        """Blocking convenience over :meth:`dispatch_bytes_sharded2d`."""
        return self.dispatch_bytes_sharded2d(
            bb, sharded, bucket=bucket, mesh=mesh, n_events=n_events)()

    # --------------------------------------------------------- conveniences
    def filter_document(self, ev: EventStream) -> FilterResult:
        """Single-document convenience on top of :meth:`filter_batch`."""
        return self.filter_batch(EventBatch.from_streams([ev]))[0]

    def filter_documents(self, docs) -> FilterResult:
        return self.filter_batch(EventBatch.from_streams(list(docs)))

    def to_device(self, array, *, device: torch.device | None = None,
                  stream=None, keep: list | None = None) -> torch.Tensor:
        """Stage a host array on ``device`` (this engine's by default).

        On a card the array is copied once into pinned host memory and
        sent with a ``non_blocking`` copy on ``stream`` (the current
        stream by default), so the transfer overlaps host work until a
        kernel on that stream needs it; ``keep`` (a list) gets the pinned
        buffer, for a caller that must hold it until the copy is done.  On
        the CPU the tensor shares the array's memory.  A tensor already on
        a device is copied to ``device`` on ``stream``.
        """
        dev = self.device if device is None else torch.device(device)
        with tracing.span("engine.h2d"), \
                (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext()):
            if isinstance(array, torch.Tensor) and array.device.type != "cpu":
                return array.to(dev, non_blocking=True)
            if isinstance(array, torch.Tensor):
                t = array.contiguous()
            else:
                array = np.ascontiguousarray(array)
                t = torch.from_numpy(array if array.flags.writeable
                                     else array.copy())
            if tracing.recording():
                # on the CPU nothing moves: the bytes a card would take
                tracing.count("h2d_bytes", t.numel() * t.element_size())
            if dev.type != "cuda":
                return t.to(dev)
            pinned = t.pin_memory()
            if keep is not None:
                keep.append(pinned)
            return pinned.to(dev, non_blocking=True)

    # ---------------------------------------------- kernel autotune hook
    @staticmethod
    def autotune_blocks(n_states: int, max_depth: int, *, n_tags: int,
                        vmem_budget: int | None = None,
                        smem_budget: int | None = None,
                        chunk: int = 256) -> dict:
        """Pick a (``blk``, ``chunk``) launch shape from static bounds.

        The JAX package's static policy, copied so that a plan's block
        layout at a given budget equals the reference's: ``blk`` is the
        largest power-of-two candidate whose per-block footprint —
        packed-word stack, per-tag word masks, parent gather lanes — fits
        ``vmem_budget`` (default the TPU's 4 MiB, :data:`_TPU_VMEM_BUDGET`),
        clamped to the padded state count; ``chunk`` (events per chunk) is
        clamped to half of ``smem_budget`` (default 8 KiB) in int32.  The
        JAX package's ``REPRO_PALLAS_*_BUDGET`` variables name Pallas and
        are not read.  A policy sized for the H100's shared memory is
        ROADMAP queue 1 item 11.
        """
        if vmem_budget is None:
            vmem_budget = _TPU_VMEM_BUDGET
        if smem_budget is None:
            smem_budget = _TPU_SMEM_BUDGET
        blk = 32
        for cand in (1024, 512, 256, 128, 64, 32):
            wb = cand // 32
            need = 4 * ((max_depth + 2) * wb    # packed-word stack
                        + (n_tags + 1) * wb     # per-tag word masks
                        + 2 * 32 * wb           # parent word/bit lanes
                        + 4 * wb)               # state/work rows
            if need <= vmem_budget:
                blk = cand
                break
        blk = min(blk, _round_up(max(n_states, 1), 32))
        chunk = max(32, min(int(chunk), smem_budget // (2 * 4)))
        return {"blk": blk, "chunk": chunk}


# -------------------------------------------------------------- the registry
_REGISTRY: dict[str, type[FilterEngine]] = {}


def register(name: str):
    """Class decorator: make the engine constructible by string key."""

    def deco(cls: type[FilterEngine]) -> type[FilterEngine]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> type[FilterEngine]:
    """Engine class for ``name`` (raises with the known names on miss)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(_REGISTRY)} "
            f"(every engine of the JAX package)") from None


def create(name: str, nfa: NFA, dictionary=None,
           **options: Any) -> FilterEngine:
    """Construct a registered engine: ``create('streaming', nfa)``."""
    return get(name)(nfa, dictionary=dictionary, **options)


def names() -> tuple[str, ...]:
    """All registered engine keys, sorted."""
    return tuple(sorted(_REGISTRY))
