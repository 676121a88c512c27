"""Trees placed on a mesh of positions.

The port's counterpart of what ``jax.sharding.NamedSharding``,
``jax.device_put`` and a sharded ``jax.Array`` do for the JAX package.

* :class:`NamedSharding` is a mesh and a spec
  (:class:`~repro_torch.sharding.rules.PartitionSpec`): a dimension whose
  entry names axes is cut into equal blocks, one a coordinate along those
  axes (several axes count row-major, as JAX's do); the other dimensions
  are whole at every position.
* :class:`PlacedTensor` is a placed leaf: its global shape and dtype, its
  sharding, and one local tensor a position.  Positions that share a
  device share one copy of the leaf there, and their local tensors are
  views of it; a position alone on its device gets its slice by
  ``.to(device)``, as ``ShardedPlan.model_slice`` does.
* :func:`device_put` places a tree, :func:`gather` puts a leaf back
  together as one tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..tree import tree_leaves, tree_unflatten
from .rules import PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def _axes(self, entry) -> tuple[str, ...]:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def parts(self, ndim: int) -> tuple[int, ...]:
        """How many blocks each dimension is cut into."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for entry in spec[:ndim]:
            n = 1
            for a in self._axes(entry):
                n *= self.mesh.shape[a]
            out.append(n)
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(n == 1 for n in self.parts(len(self.spec)))

    def block(self, idx: tuple, ndim: int) -> tuple[int, ...]:
        """The block a position holds, one index a dimension."""
        coord = dict(zip(self.mesh.axis_names, idx))
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for entry in spec[:ndim]:
            b = 0
            for a in self._axes(entry):
                b = b * self.mesh.shape[a] + coord[a]
            out.append(b)
        return tuple(out)

    def shard_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        parts = self.parts(len(shape))
        for dim, n in zip(shape, parts):
            if dim % n:
                raise ValueError(f"spec {self.spec} does not divide shape "
                                 f"{shape} on mesh {self.mesh.shape}")
        return tuple(dim // n for dim, n in zip(shape, parts))

    def slices(self, shape, idx: tuple) -> tuple[slice, ...]:
        """The global index range a position holds."""
        local = self.shard_shape(shape)
        return tuple(slice(b * n, (b + 1) * n)
                     for b, n in zip(self.block(idx, len(local)), local))


class PlacedTensor:
    """A leaf placed on a mesh: ``shards[idx]`` is position ``idx``'s local
    tensor, on that position's device."""

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding,
                 shards: dict[tuple, torch.Tensor]) -> None:
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PlacedTensor({tuple(self.shape)}, {self.dtype}, "
                f"spec={self.sharding.spec}, mesh={self.sharding.mesh.shape})")


def _place(t: torch.Tensor, s: NamedSharding) -> PlacedTensor:
    mesh = s.mesh
    per_dev: dict[torch.device, int] = {}
    for idx in mesh.positions():
        dev = mesh.device(idx)
        per_dev[dev] = per_dev.get(dev, 0) + 1
    whole: dict[torch.device, torch.Tensor] = {}
    shards = {}
    for idx in mesh.positions():
        dev = mesh.device(idx)
        sl = s.slices(t.shape, idx)
        if per_dev[dev] > 1:
            # positions sharing a device: views of one copy there
            if dev not in whole:
                whole[dev] = t if t.device == dev else t.to(dev)
            shards[idx] = whole[dev][sl]
        else:
            local = t[sl]
            shards[idx] = local if local.device == dev else local.to(dev)
    return PlacedTensor(t.shape, t.dtype, s, shards)


def device_put(tree: Any, shardings: Any) -> Any:
    """``tree`` with each leaf placed by its sharding: ``shardings`` is one
    :class:`NamedSharding` for every leaf, or a tree of ``tree``'s
    structure whose leaves are shardings (or ``None``: left as it is).
    A placed leaf is gathered first, so a tree moves between layouts."""
    leaves = tree_leaves(tree)
    if isinstance(shardings, NamedSharding):
        specs = [shardings] * len(leaves)
    else:
        specs = tree_leaves(shardings, is_leaf=lambda x: x is None or
                            isinstance(x, NamedSharding))
        if len(specs) != len(leaves):
            raise ValueError(f"{len(specs)} shardings for a tree of "
                             f"{len(leaves)} leaves")
    out = []
    for leaf, s in zip(leaves, specs):
        if s is not None:
            leaf = _place(gather(leaf) if isinstance(leaf, PlacedTensor)
                          else leaf, s)
        out.append(leaf)
    return tree_unflatten(tree, out)


def gather(leaf: PlacedTensor, device=None) -> torch.Tensor:
    """The placed leaf as one tensor on ``device`` (default: the first
    position's device); each block is read from the first position that
    holds it."""
    mesh = leaf.sharding.mesh
    first = mesh.positions()[0]
    dev = torch.device(device) if device is not None else mesh.device(first)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
    seen = set()
    for idx in mesh.positions():
        b = leaf.sharding.block(idx, leaf.ndim)
        if b in seen:
            continue
        seen.add(b)
        out[leaf.sharding.slices(leaf.shape, idx)].copy_(
            leaf.shards[idx].detach())
    return out


def is_placed(tree: Any) -> bool:
    """Whether any leaf of ``tree`` is placed on a mesh."""
    return any(isinstance(x, PlacedTensor) for x in tree_leaves(tree))
