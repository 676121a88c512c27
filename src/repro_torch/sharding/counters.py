"""The collective counter's hooks, which the placed layers report into.

:mod:`repro_torch.launch.cost_analysis` runs a partitioned step under
:class:`CollectiveCounter` and its ``TrafficCounterMode``; the layers
below it (``models.layers._collect``, ``sharding.placement.read_region``,
the optimizer's folds over blocks through :func:`block_fold`) report
here, so that they import nothing of ``launch``.  With no counter
active, each hook costs one check of :data:`ACTIVE` (or :data:`TRAFFIC`).

:func:`collective_wire_bytes` is ``src/repro/launch/hlo_analysis.py``'s
ring table of per-position wire bytes (``b`` the result's bytes, ``g``
the group's size; a group of one moves nothing)::

    all-reduce          2·b·(g-1)/g
    all-gather          b·(g-1)/g
    reduce-scatter      b·(g-1)
    all-to-all          b·(g-1)/g
    collective-permute  b
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the active :class:`CollectiveCounter`, or ``None``: the hooks' one check
ACTIVE: "CollectiveCounter | None" = None
#: the active ``cost_analysis.TrafficCounterMode``, or ``None``
TRAFFIC = None
_lock = threading.Lock()


def collective_wire_bytes(kind: str, b: float, g: int) -> float:
    """Per-position ring wire bytes of one collective whose result holds
    ``b`` bytes, over a group of ``g`` positions."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if kind == "all-gather":
        return b * (g - 1) / g
    if kind == "reduce-scatter":
        return float(b) * (g - 1)
    if kind == "all-to-all":
        return b * (g - 1) / g
    if kind == "collective-permute":
        return float(b)
    raise ValueError(f"unknown collective {kind!r}")


def size(t: torch.Tensor) -> int:
    """The bytes of ``t``'s elements, as a collective moves them."""
    return t.numel() * t.element_size()


class CollectiveCounter:
    """For the length of a ``with``, the wire bytes of every collective a
    position takes part in: ``by_position[idx][kind]``.  One counter is
    active at a time; autograd's backward thread reports into it too."""

    def __init__(self) -> None:
        self.by_position: dict[tuple, dict[str, float]] = {}
        self._prev = None

    def __enter__(self) -> "CollectiveCounter":
        global ACTIVE
        self._prev, ACTIVE = ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        global ACTIVE
        ACTIVE = self._prev

    def add(self, position: tuple, kind: str, wire: float) -> None:
        with _lock:
            row = self.by_position.setdefault(tuple(position), {})
            row[kind] = row.get(kind, 0.0) + wire

    def group(self, positions, kind: str, result_bytes: int,
              g: int) -> None:
        """One collective over a group of ``g`` positions whose result
        holds ``result_bytes`` at each: the ring bytes of each of
        ``positions`` (the group's positions a mesh runs)."""
        wire = collective_wire_bytes(kind, result_bytes, g)
        for idx in positions:
            self.add(idx, kind, wire)

    def transposed(self, positions, kind: str, result: torch.Tensor,
                   g: int) -> None:
        """The backward pass of a ``kind`` collective whose result is
        ``result``, counted when autograd reaches it: a sum's gradient is
        summed back over the group (an all-reduce of the result's bytes),
        a gather's is summed and scattered to the parts' positions (a
        reduce-scatter whose result is one part)."""
        back, b = (("reduce-scatter", size(result) // g)
                   if kind == "all-gather" else ("all-reduce", size(result)))

        def hook(_grad: torch.Tensor) -> None:
            counter = ACTIVE
            if counter is not None:
                counter.group(positions, back, b, g)
        result.register_hook(hook)

    def foreign_read(self, position: tuple, t: torch.Tensor) -> None:
        """``position`` read ``t`` from a block another position holds (an
        all-gather's bytes); the gradient autograd sums back into that
        block counts as a reduce-scatter when the backward pass reaches
        it."""
        self.add(position, "all-gather", float(size(t)))
        if t.requires_grad:
            t.register_hook(_scatter_hook(tuple(position)))

    def replica_grad(self, position: tuple, t: torch.Tensor,
                     holders: int) -> None:
        """Count the gradient of ``t``, read by ``position`` from a block
        it holds with ``holders - 1`` other positions, as an all-reduce
        over the holders, when the backward pass reaches it."""
        def hook(g: torch.Tensor):
            counter = ACTIVE
            if counter is not None:
                counter.add(position, "all-reduce", collective_wire_bytes(
                    "all-reduce", size(g), holders))
        t.register_hook(hook)

    def breakdown(self, positions) -> dict[str, float]:
        """The mean over ``positions`` of each kind's bytes."""
        out: dict[str, float] = {}
        for idx in positions:
            for kind, v in self.by_position.get(tuple(idx), {}).items():
                out[kind] = out.get(kind, 0.0) + v
        return {k: v / len(positions) for k, v in out.items()}


def block_fold(sharding, ndim: int, dims: tuple, result: torch.Tensor
               ) -> None:
    """A fold (a sum) of the blocks of a leaf placed by ``sharding`` that
    split its dimensions ``dims``, whose result is ``result`` (one
    block's): at every position the mesh runs, an all-reduce over the
    group of the blocks folded, the positions whose blocks differ only
    along ``dims`` (the optimizer's sums over blocks held at other
    positions: ``train/optimizer.py``).  A fold within one block moves
    nothing and counts nothing; neither does any with no counter
    active."""
    counter = ACTIVE
    if counter is None:
        return
    parts = sharding.parts(ndim)
    g = 1
    for d in dims:
        g *= parts[d]
    if g > 1:
        counter.group(sharding.mesh.positions(), "all-reduce", size(result),
                      g)


def _scatter_hook(position: tuple):
    def hook(g: torch.Tensor):
        counter = ACTIVE
        if counter is not None:
            counter.add(position, "reduce-scatter", float(size(g)))
    return hook


@contextlib.contextmanager
def collective_traffic() -> Iterator[Callable[[int], None] | None]:
    """Inside the ``with`` the active traffic counter counts no op; the
    function it yields records a collective's bytes (its result at each
    position of the group), or it yields ``None`` with no counter
    active."""
    mode = TRAFFIC
    if mode is None or mode.paused:
        yield None
        return
    mode.paused = True
    try:
        yield lambda b: mode.note("collective", b)
    finally:
        mode.paused = False
