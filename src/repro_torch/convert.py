"""Carry a plan's numpy tables into a port :class:`FilterPlan`.

Each function takes one engine family's tables as numpy arrays — the
port's own, or those of a JAX ``FilterPlan`` after ``np.asarray`` — checks
their shapes and indices, and places them on a device, so the port can
run on exactly the tables another build produced:

* :func:`plan_from_numpy` — a streaming plan's ``kb_*`` block tables (a
  plan without them, a scan-only plan, is refused);
* :func:`level_plan_from_numpy` — a levelwise or wavefront plan's dense
  tables (:data:`LEVEL_TABLES`), which K6 reads;
* :func:`matscan_plan_from_numpy` — a matscan plan's ``step_tags`` and
  ``accept_idx``;
* :func:`sharded_plan_from_numpy` — a sharded plan: each part's tables
  through the function of its engine family, with the partition's
  bookkeeping (columns, queries, sub-NFAs, pads), into the port's
  :class:`~repro_torch.core.engines.base.ShardedPlan`.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .core.engines.base import FilterEngine, FilterPlan, ShardedPlan
from .core.nfa import NFA, NFATables
from .core.xpath import parse
from .kernels.stream_filter import check_block_tables

#: the block tables the megakernels and the lane → query gather read
BLOCK_TABLES = ("kb_tagmask", "kb_pw", "kb_pb", "kb_selfloop", "kb_init",
                "kb_acc_word", "kb_acc_bit", "kb_acc_block", "kb_acc_slot")

#: plan metadata the port reads
META_KEYS = ("max_depth", "n_states", "state_multiple", "blk", "n_blocks",
             "block_queries", "grid_order", "segment_target", "ep_tile")


def _as_int32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        return x.view(np.int32)        # packed words: a bit view, no copy
    if x.dtype.kind not in "iu" or x.size and (
            x.min() < -2 ** 31 or x.max() >= 2 ** 31):
        raise ValueError(f"table of dtype {x.dtype} does not fit int32")
    return x.astype(np.int32)


def plan_from_numpy(tables: Mapping[str, Any], meta: Mapping[str, Any],
                    device: str | torch.device) -> FilterPlan:
    """Streaming plan tables (numpy, uint32 words) → port plan on ``device``.

    ``meta`` must carry ``max_depth``; the launch-shape keys of
    :data:`META_KEYS` are kept when present.  Block tables are checked
    for shape agreement and in-block indices before they reach a kernel.
    """
    missing = [k for k in BLOCK_TABLES if k not in tables]
    if missing:
        raise ValueError(f"plan has no megakernel block tables {missing}; "
                         f"build it with the block layout (a JAX streaming "
                         f"engine with kernel='pallas')")
    if "max_depth" not in meta:
        raise ValueError("plan meta has no max_depth")
    arrays = {k: _as_int32(np.asarray(tables[k])) for k in BLOCK_TABLES}
    g, t1, wb = arrays["kb_tagmask"].shape
    qb = arrays["kb_acc_word"].shape[1]
    want = {"kb_pw": (g, wb, 32), "kb_pb": (g, wb, 32),
            "kb_selfloop": (g, wb), "kb_init": (g, wb),
            "kb_acc_word": (g, qb), "kb_acc_bit": (g, qb)}
    for k, shape in want.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, expected "
                             f"{shape}")
    ab, sl = arrays["kb_acc_block"], arrays["kb_acc_slot"]
    if ab.shape != sl.shape or ab.ndim != 1:
        raise ValueError("kb_acc_block / kb_acc_slot must be equal (Q,)")
    if ab.size and (ab.min() < 0 or ab.max() >= g or sl.min() < 0
                    or sl.max() >= qb):
        raise ValueError("accept lane → query tables leave the (G, QB) grid")
    check_block_tables(arrays)
    dev = torch.device(device)
    placed = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in arrays.items()}
    keep = {k: meta[k] for k in META_KEYS if k in meta}
    keep["max_depth"] = int(meta["max_depth"])
    return FilterPlan("streaming", placed, keep)


#: the dense tables of a levelwise-family plan, and their dtypes
LEVEL_TABLES = {"in_state": np.int32, "in_tag": np.int32,
                "selfloop": np.float32, "init": np.float32,
                "accept_state": np.int32, "req": np.float32,
                "wild": np.float32, "parent_1h": np.float32}
LEVEL_META = ("n_states", "n_tags", "state_multiple", "prep")


def _place(tables: Mapping[str, Any], dtypes: Mapping[str, Any]
           ) -> dict[str, np.ndarray]:
    missing = [k for k in dtypes if k not in tables]
    if missing:
        raise ValueError(f"plan has no tables {missing}")
    out = {}
    for k, dtype in dtypes.items():
        x = np.asarray(tables[k])
        if np.dtype(dtype).kind == "i":
            out[k] = _as_int32(x)
        elif x.dtype.kind not in "fb":
            raise ValueError(f"{k} of dtype {x.dtype} is not a float table")
        else:
            out[k] = np.ascontiguousarray(x, dtype=dtype)
    return out


def level_plan_from_numpy(engine: str, tables: Mapping[str, Any],
                          meta: Mapping[str, Any],
                          device: str | torch.device) -> FilterPlan:
    """Levelwise-family tables (numpy) → port plan of ``engine`` on
    ``device``.

    ``in_state``/``in_tag``/``selfloop``/``init``/``wild`` are (S,),
    ``accept_state`` (Q,), ``req`` (T, S) and ``parent_1h`` (S, S); S and
    T must equal ``meta["n_states"]`` and ``meta["n_tags"]``, and every
    state index must lie in [0, S), before anything reaches K6.
    """
    if engine not in ("levelwise", "wavefront"):
        raise ValueError(f"{engine!r} is not a levelwise-family engine")
    for k in ("n_states", "n_tags"):
        if k not in meta:
            raise ValueError(f"plan meta has no {k}")
    arrays = _place(tables, LEVEL_TABLES)
    s, t = int(meta["n_states"]), int(meta["n_tags"])
    if arrays["accept_state"].ndim != 1:
        raise ValueError("accept_state must be (Q,)")
    q = arrays["accept_state"].shape[0]
    want = {"in_state": (s,), "in_tag": (s,), "selfloop": (s,),
            "init": (s,), "wild": (s,), "accept_state": (q,),
            "req": (t, s), "parent_1h": (s, s)}
    for k, shape in want.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, expected "
                             f"{shape}")
    for k in ("in_state", "accept_state"):
        x = arrays[k]
        if x.size and (x.min() < 0 or x.max() >= s):
            raise ValueError(f"{k} holds states outside [0, {s})")
    dev = torch.device(device)
    placed = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in arrays.items()}
    keep = {k: meta[k] for k in LEVEL_META if k in meta}
    keep.update(n_states=s, n_tags=t)
    return FilterPlan(engine, placed, keep)


def matscan_plan_from_numpy(tables: Mapping[str, Any],
                            meta: Mapping[str, Any],
                            device: str | torch.device) -> FilterPlan:
    """Matscan tables (numpy) → port plan on ``device``: ``step_tags``
    (Q, kmax) int32 and ``accept_idx`` (Q,) int32 in [0, kmax]."""
    arrays = _place(tables, {"step_tags": np.int32, "accept_idx": np.int32})
    st, acc = arrays["step_tags"], arrays["accept_idx"]
    if st.ndim != 2 or acc.shape != (st.shape[0],):
        raise ValueError(f"step_tags {st.shape} and accept_idx {acc.shape} "
                         f"must be (Q, kmax) and (Q,)")
    kmax = st.shape[1]
    if int(meta.get("kmax", kmax)) != kmax:
        raise ValueError(f"meta kmax {meta['kmax']} != step_tags width {kmax}")
    if acc.size and (acc.min() < 0 or acc.max() > kmax):
        raise ValueError(f"accept_idx holds indices outside [0, {kmax}]")
    dev = torch.device(device)
    placed = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in arrays.items()}
    return FilterPlan("matscan", placed,
                      {"kmax": kmax, "n_queries": st.shape[0],
                       "prep": meta.get("prep", "events-device")})


def nfa_from_numpy(nfa: Any) -> NFA:
    """An NFA of either package (its tables as arrays, its queries with
    their source text) → the port's :class:`NFA`, queries re-parsed."""
    tables = NFATables(*(np.asarray(x) for x in nfa.tables))
    return NFA(tables, tuple(parse(q.raw) for q in nfa.queries),
               bool(nfa.shared), int(nfa.n_tags))


def sharded_plan_from_numpy(engine: FilterEngine,
                            part_tables: Sequence[Mapping[str, Any]],
                            part_meta: Sequence[Mapping[str, Any]], *,
                            part_cols: Sequence[Sequence[int]],
                            part_queries: Sequence[Sequence[Any]],
                            part_nfas: Sequence[Any],
                            pads: Mapping[str, int], n_global: int,
                            query_bucket: int,
                            shared: bool) -> ShardedPlan:
    """A sharded plan's per-part tables (numpy) and partition bookkeeping
    → the port's :class:`ShardedPlan`, run by ``engine`` (a port engine
    of the same family) on its device.

    Each part goes through the function of its family
    (:func:`plan_from_numpy`, :func:`level_plan_from_numpy`,
    :func:`matscan_plan_from_numpy`), so its tables are checked before
    they reach a kernel; queries and sub-NFAs may be the JAX package's
    (they are re-parsed and copied).  Host engines have no tables to
    carry.
    """
    if not engine.device_sharded:
        raise ValueError(f"{engine.name}: a host engine's plan has no "
                         f"tables to carry over")
    if len(part_tables) != len(part_meta):
        raise ValueError(f"{len(part_tables)} parts of tables but "
                         f"{len(part_meta)} of metadata")
    if engine.name == "streaming":
        plans = [plan_from_numpy(t, m, engine.device)
                 for t, m in zip(part_tables, part_meta)]
    elif engine.name in ("levelwise", "wavefront"):
        plans = [level_plan_from_numpy(engine.name, t, m, engine.device)
                 for t, m in zip(part_tables, part_meta)]
    elif engine.name == "matscan":
        plans = [matscan_plan_from_numpy(t, m, engine.device)
                 for t, m in zip(part_tables, part_meta)]
    else:
        raise ValueError(f"no table conversion for engine {engine.name!r}")
    shapes = {k: {tuple(p[k].shape) for p in plans} for k in plans[0].tables}
    ragged = sorted(k for k, v in shapes.items() if len(v) > 1)
    if ragged:
        raise ValueError(f"part tables {ragged} differ in shape: the parts "
                         f"were not compiled at uniform pads")
    queries = [[None if q is None else parse(q.raw) for q in qs]
               for qs in part_queries]
    return ShardedPlan(engine, plans, part_cols, queries,
                       [nfa_from_numpy(n) for n in part_nfas], pads,
                       n_global, query_bucket, shared)
