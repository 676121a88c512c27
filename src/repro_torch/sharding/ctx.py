"""Mesh context of the LM substrate.

Counterpart of ``src/repro/sharding/ctx.py``.  ``mesh_context(mesh)``
makes a :class:`~repro_torch.launch.mesh.FilterMesh` the active mesh of
the calling thread, as JAX's makes a ``Mesh`` active; model code reads it
through :func:`spec` and :func:`axis_size`, and the MoE layer through
:func:`_mesh`, to pick its expert-parallel dispatch.  Outside a mesh
context every call is the single-device one.

Axis-name conventions (see launch/mesh.py):
  "dp"    → ("pod", "data") when the pod axis exists, else ("data",)
  "data"  / "model" / "pod" → themselves, if present in the mesh

A spec is a tuple with one entry per dimension, as
:class:`repro_torch.sharding.rules.PartitionSpec`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from .rules import PartitionSpec

_state = threading.local()


def _mesh():
    """The calling thread's active mesh, or ``None``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator:
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _resolve(axis, mesh):
    names = mesh.axis_names
    if axis is None:
        return None
    if axis == "dp":
        got = tuple(a for a in ("pod", "data") if a in names)
        return got if got else None
    if isinstance(axis, (tuple, list)):
        got = tuple(a for a in axis if a in names)
        return got if got else None
    return axis if axis in names else None


def spec(*axes) -> PartitionSpec:
    """The axes resolved against the active mesh (``()`` outside one)."""
    mesh = _mesh()
    if mesh is None:
        return PartitionSpec()
    return PartitionSpec(*(_resolve(a, mesh) for a in axes))


def constrain(x, axes):
    """``x`` itself.

    The JAX package hands ``axes`` to XLA's SPMD partitioner as a layout
    hint (``with_sharding_constraint``) at the activations' key points.
    The port has no partitioner: a mesh-aware layer places its values on
    the positions itself (:func:`repro_torch.models.layers.moe`), so the
    hint has nothing to steer and the value passes through unchanged."""
    del axes
    return x


def axis_size(name: str, default: int = 1) -> int:
    mesh = _mesh()
    if mesh is None:
        return default
    if name == "dp":
        return axis_size("pod") * axis_size("data")
    return mesh.shape.get(name, default)
