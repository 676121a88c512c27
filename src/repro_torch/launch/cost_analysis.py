# Counterpart of src/repro/launch/hlo_analysis.py, counted where the port's work runs (it emits no HLO).
"""FLOPs, accessed bytes and collective wire bytes of a partitioned step.

The JAX package reads these from the HLO text XLA compiles a cell to
(``launch/hlo_analysis.py``).  The port runs eagerly and writes its
collectives out, so it counts them where they run:

* :func:`collective_wire_bytes` is ``hlo_analysis.py``'s ring table of
  per-position wire bytes (:mod:`repro_torch.sharding.counters`).
* :class:`CollectiveCounter` (:mod:`repro_torch.sharding.counters`,
  where the layers report) counts them a position and a kind, from
  three places: the sums, maxima and gathers over groups of positions
  (:func:`repro_torch.models.layers._collect`: ``_psum`` and ``_pmax``
  are all-reduces, ``_all_gather`` an all-gather, each position counted
  at the group's result), and their backward passes where autograd
  takes one (a sum's gradient summed back, an all-reduce; a gather's
  summed and scattered, a reduce-scatter); the blocks a position reads
  from a placed leaf that it does not hold itself
  (:func:`repro_torch.sharding.placement.read_region`, an all-gather:
  the bytes of the foreign blocks are the ring's ``b·(g-1)/g``); the
  gradients autograd sums back into those blocks (a reduce-scatter, the
  same bytes the other way); and the gradient of a block a position
  holds with others (a replicated parameter's) as an all-reduce over its
  holders.
  Positions, not devices, are the keys: on the meta grid and on a grid
  of one repeated card every position has the same device.  With no
  counter active, each hook costs one check of a module-level flag.
* :class:`TrafficCounterMode` counts the bytes each aten op reads and
  writes, by ``hlo_analysis._op_traffic``'s rules: a view moves nothing;
  an in-place write into a slice (``copy_`` into a view, ``index_put_``,
  ``index_copy``, ``slice_scatter``), the KV-cache write, moves twice the
  update, not the buffer; a slice followed by a copy reads only the
  slice; a broadcast operand counts its distinct elements; a
  collective counts its result at each position of its group.  The
  port runs eagerly and unfused, so every intermediate is written and
  read back: the count is an upper bound on what a fused step of the
  same ops moves.  (XLA's count on its CPU backend also moves the
  float32 copies it makes of bfloat16 operands, so the ratio of the
  two, which ``PERF.md`` records for the mini cells, can fall below 1.)
* :func:`analyze_step` runs a step under both and
  ``torch.utils.flop_counter.FlopCounterMode``, and returns
  ``analyze_text``'s keys, per position (the mean over the mesh's
  positions), trip counts included: the port runs every loop.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..sharding import counters
from ..sharding.counters import (COLLECTIVES,  # noqa: F401  (re-exported)
                                 CollectiveCounter, collective_wire_bytes)


def nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a stride-0 dimension, a
    broadcast, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


# --------------------------------------------------------------- traffic
_aten = torch.ops.aten
#: an in-place write of an update into a slice: twice the update
_SLICE_WRITES = {
    _aten.index_put_.default: 2, _aten.index_put.default: 2,
    _aten._index_put_impl_.default: 2, _aten.index_copy_.default: 3,
    _aten.index_copy.default: 3, _aten.slice_scatter.default: 1,
    _aten.select_scatter.default: 1,
}
_FILLS = {_aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.lift_fresh.default, _aten._local_scalar_dense.default}


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def op_traffic(func, args, kwargs, out) -> int:
    """The bytes one aten op reads and writes (``_op_traffic``'s rules)."""
    if func.is_view or func in _FREE:
        return 0
    if func is _aten.copy_.default:
        return 2 * nbytes(args[0])
    if func in _SLICE_WRITES:
        return 2 * nbytes(args[_SLICE_WRITES[func]])
    if func in _FILLS:
        return nbytes(args[0])
    return sum(map(nbytes, _tensors((args, kwargs)))) + sum(
        map(nbytes, _tensors(out)))


class TrafficCounterMode(TorchDispatchMode):
    """Bytes read and written by every aten op run inside the ``with``:
    ``total`` and ``by_op`` (aten op name → bytes).  A collective
    (:func:`collective_traffic`) counts its result's bytes at each
    position of its group, as ``hlo_analysis`` counts a collective op,
    and not the copies and sums the port folds it from."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0
        self.by_op: dict[str, int] = {}
        self.paused = False

    def __enter__(self):
        self._prev_traffic, counters.TRAFFIC = counters.TRAFFIC, self
        return super().__enter__()

    def __exit__(self, *exc):
        counters.TRAFFIC = self._prev_traffic
        return super().__exit__(*exc)

    def note(self, name: str, b: int) -> None:
        self.total += b
        self.by_op[name] = self.by_op.get(name, 0) + b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            b = op_traffic(func, args, kwargs, out)
            if b:
                self.note(func.overloadpacket.__name__, b)
        return out


@contextlib.contextmanager
def counting() -> Iterator[tuple]:
    """``(CollectiveCounter, FlopCounterMode, TrafficCounterMode)``, all
    active for the length of a ``with``."""
    flops = FlopCounterMode(display=False)
    traffic = TrafficCounterMode()
    with CollectiveCounter() as coll, flops, traffic:
        yield coll, flops, traffic


def summary(coll: CollectiveCounter, flops: FlopCounterMode,
            traffic: TrafficCounterMode, mesh,
            factor: float = 1.0) -> dict[str, Any]:
    """``analyze_text``'s keys from counters run over ``mesh``, per
    position, each count times ``factor``."""
    pos = mesh.positions()
    n = len(pos)
    breakdown = {k: v * factor for k, v in coll.breakdown(pos).items()}
    return {
        "flops_per_device": float(flops.get_total_flops()) * factor / n,
        "traffic_bytes_per_device": traffic.total * factor / n,
        "collective_bytes_per_device": sum(breakdown.values()),
        "collective_breakdown": breakdown,
    }


def analyze_step(fn: Callable[[], Any], mesh,
                 factor: float = 1.0) -> dict[str, Any]:
    """Run ``fn()`` (a partitioned step over ``mesh``'s positions) under
    the counters and return ``flops_per_device``,
    ``traffic_bytes_per_device``, ``collective_bytes_per_device`` and
    ``collective_breakdown``: per position, as ``analyze_text``; each
    count times ``factor`` (a step of ``factor`` equal microbatches run
    as one)."""
    with counting() as (coll, flops, traffic):
        fn()
    return summary(coll, flops, traffic, mesh, factor)


def traffic_breakdown(fn: Callable[[], Any],
                      top: int = 20) -> list[tuple[str, float]]:
    """The bytes ``fn()`` accesses, grouped by aten op name, largest
    first: the counterpart of ``hlo_analysis.traffic_breakdown``."""
    with TrafficCounterMode() as mode:
        fn()
    return sorted(((k, float(v)) for k, v in mode.by_op.items()),
                  key=lambda kv: -kv[1])[:top]
