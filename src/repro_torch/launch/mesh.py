"""The port's meshes: the filter's 2-D ``("data", "model")`` mesh and the
LM substrate's host and production meshes.

Counterpart of ``src/repro/launch/mesh.py``.  The paper's
scaling argument (§3.5) replicates in two dimensions: profiles are
spread over chips and documents over replicas.  The JAX package runs
that as one ``shard_map`` program over a ``jax.sharding.Mesh``, from one
process.  The port does the same from one host thread: a
:class:`FilterMesh` is a grid of **positions**, each a device and (on a
card) a CUDA stream, and a sharded filter launches its kernel once per
position over that position's ``"model"`` slice of the stacked parts and
its ``"data"`` slice of the documents (:mod:`repro_torch.core.engines.
base`).

A device may appear at more than one position: the positions then share
its tables as views, each on a stream of its own.  That is how a mesh
wider than 1 × 1 runs on one card, and on the CPU, where positions run
one after another.  Positions on different cards get their slices of the
tables by ``.to(device)``, one memoised copy per table.

The LM substrate's meshes are positions of the same kind:
:func:`make_host_mesh` spans the visible cards (or the devices given),
and :func:`make_production_mesh` is the reference's 16 × 16 (or 2 × 16 ×
16) grid, as positions on the ``meta`` device: a shape to compute specs
and per-position bytes against, never to run on.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Sequence

import torch

AXES = ("data", "model")


def resolve_device(device) -> torch.device:
    """A device with its index filled in, so positions on one card compare
    equal to the tensors' own devices (``cuda`` means the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _grid(devices, ndim: int) -> tuple[list, tuple[int, ...]]:
    """A nested list of ``ndim`` levels → (flat list, shape); every level
    must be rectangular."""
    if ndim == 0:
        return [devices], ()
    if isinstance(devices, (str, torch.device)) or not isinstance(
            devices, Sequence) or len(devices) == 0:
        raise ValueError(f"devices must be a non-empty {ndim}-D nested list")
    flat, inner = [], None
    for row in devices:
        f, s = _grid(row, ndim - 1)
        if inner is not None and s != inner:
            raise ValueError("devices is not rectangular")
        inner = s
        flat.extend(f)
    return flat, (len(devices),) + inner


class FilterMesh:
    """A grid of positions over devices, with named axes.

    ``devices`` is a nested list with one level per axis name, by default
    a 2-D ``[[...], ...]`` grid indexed ``[data][model]``.  ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does.  A
    device may repeat.  On a card each position has a CUDA stream of its
    own for every thread that launches on it (:meth:`use`), so the serve
    loop's workers never share one.
    """

    def __init__(self, devices, axis_names: Sequence[str] = AXES) -> None:
        self.axis_names = tuple(axis_names)
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        flat, dims = _grid(devices, len(self.axis_names))
        self._devices = [resolve_device(d) for d in flat]
        self._dims = dims
        self._local = threading.local()
        self._pinned: dict[int, Any] | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def devices(self) -> list[torch.device]:
        """Every position's device, in row-major order."""
        return list(self._devices)

    def _flat(self, idx: Sequence[int]) -> int:
        if len(idx) != len(self._dims):
            raise ValueError(f"position {tuple(idx)} of a {len(self._dims)}"
                             f"-D mesh")
        flat = 0
        for i, n in zip(idx, self._dims):
            if not 0 <= i < n:
                raise IndexError(f"position {tuple(idx)} outside "
                                 f"{self.shape}")
            flat = flat * n + int(i)
        return flat

    def positions(self) -> list[tuple[int, ...]]:
        """Every position's index, in row-major order."""
        out = [()]
        for n in self._dims:
            out = [i + (j,) for i in out for j in range(n)]
        return out

    def position(self, **coords: int) -> tuple[int, ...]:
        """The index of the position at the named coordinates; an axis left
        out is taken at 0 (``position(model=m)`` on a 2-D mesh is the
        first data row's)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in {self.shape}")
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def device(self, idx: Sequence[int]) -> torch.device:
        return self._devices[self._flat(idx)]

    def stream(self, idx: Sequence[int]):
        """This thread's CUDA stream of a position (``None`` off the card),
        made at its first use; while :meth:`pinned_streams` holds, the
        pinning thread's, in every thread."""
        dev = self.device(idx)
        if dev.type != "cuda":
            return None
        if self._pinned is not None:
            return self._pinned[self._flat(idx)]
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        flat = self._flat(idx)
        s = streams.get(flat)
        if s is None:
            s = streams[flat] = torch.cuda.Stream(dev)
        return s

    @contextlib.contextmanager
    def pinned_streams(self) -> Iterator[None]:
        """For the length of a ``with``, every thread gets the calling
        thread's stream of each position.  A train step pins them: autograd
        runs the backward pass, and the recompute of a checkpointed layer,
        in a thread of its own, and a position's recomputed activations
        must come from the stream its backward ops run on, the forward's."""
        prev = self._pinned
        self._pinned = {self._flat(idx): self.stream(idx)
                        for idx in self.positions()}
        try:
            yield
        finally:
            self._pinned = prev

    @contextlib.contextmanager
    def use(self, idx: Sequence[int]) -> Iterator[Any]:
        """Run the body on a position: on a card its stream becomes the
        current stream, after everything the calling thread's current
        stream on that card has queued; off the card, nothing."""
        s = self.stream(idx)
        if s is None:
            yield None
            return
        s.wait_stream(torch.cuda.current_stream(s.device))
        with torch.cuda.stream(s):
            yield s

    def __repr__(self) -> str:  # pragma: no cover
        return f"FilterMesh({self.shape}, devices={self._devices})"


def mesh_shape(n_devices: int, n_parts: int | None = None, *,
               data_shards: int = 1) -> tuple[int, int]:
    """The ``(data, model)`` shape :func:`make_filter_mesh` places on
    ``n_devices`` devices, by the JAX package's rules: ``data_shards``
    shrinks to the largest divisor of the device count, the remaining
    devices form ``"model"``, and ``n_parts`` shrinks that axis to a
    divisor of the part count (6 parts on 4 devices: a 3-wide axis)."""
    if data_shards < 1:
        raise ValueError(f"data_shards must be >= 1, got {data_shards}")
    if n_parts is not None and n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    n = int(n_devices)
    data = min(int(data_shards), n)
    while n % data != 0:
        data -= 1
    model = n // data
    if n_parts is not None:
        while n_parts % model != 0:
            model -= 1
    return data, model


def make_filter_mesh(n_parts: int | None = None, *, data_shards: int = 1,
                     device: str | torch.device = "cuda") -> FilterMesh:
    """The 2-D ``("data", "model")`` mesh over this host's devices.

    ``device="cuda"`` (default) places it on the visible cards,
    ``torch.cuda.device_count()`` of them, and raises when there is none;
    ``device="cpu"`` on the one CPU device.  The shape follows
    :func:`mesh_shape`, over the first ``data × model`` devices, so any
    request is placeable (one card gives a 1 × 1 mesh).  For a wider grid
    over fewer devices, build a :class:`FilterMesh` with devices repeated.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_filter_mesh(device='cuda'): no CUDA card "
                               "is visible; pass device='cpu' to run the "
                               "mesh on the CPU")
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    data, model = mesh_shape(len(pool), n_parts, data_shards=data_shards)
    return FilterMesh([[pool[d * model + m] for m in range(model)]
                       for d in range(data)])


def make_production_mesh(*, multi_pod: bool = False) -> FilterMesh:
    """16×16 = 256 chips/pod; multi-pod adds a leading 2-pod axis.

    Axes: "data" carries DP+FSDP, "model" carries TP/EP, "pod" composes
    with "data" for hierarchical data parallelism.  Every position is on
    the ``meta`` device: the grid has the reference's shape and axis
    names, for rule specs and sizes, and runs nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")

    def grid(dims):
        return "meta" if not dims else [grid(dims[1:])
                                        for _ in range(dims[0])]
    return FilterMesh(grid(shape), axis_names=axes)


def make_host_mesh(model: int = 1, *, devices=None) -> FilterMesh:
    """``(data, model)`` mesh over this host's cards, ``model`` of them
    on the ``"model"`` axis and the rest on ``"data"``.

    ``devices`` (a flat list, a device may repeat) replaces the visible
    cards, as the tests' grids of the CPU device do.  With neither a card
    nor ``devices`` it raises: there is no fallback to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA card is visible; "
                               "pass devices= to build a mesh of other "
                               "devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if model < 1 or n % model != 0:
        # a real error, not an assert: asserts vanish under ``python -O``
        raise ValueError(
            f"cannot build host mesh: {n} devices not divisible by "
            f"model={model}")
    return FilterMesh([[devices[d * model + m] for m in range(model)]
                       for d in range(n // model)])
