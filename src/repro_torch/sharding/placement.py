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
* :func:`read_region` and :func:`write_region` read and write a global
  index range of a placed leaf, block by block: the sharded train step's
  gathers (:mod:`repro_torch.train.sharded_step`) and its optimizer.
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


def holders(leaf: PlacedTensor) -> dict[tuple, tuple]:
    """Each block of the leaf and the first position (row-major) that
    holds it."""
    out: dict[tuple, tuple] = {}
    for idx in leaf.sharding.mesh.positions():
        out.setdefault(leaf.sharding.block(idx, leaf.ndim), idx)
    return out


def _full(sl, shape) -> tuple[slice, ...]:
    """``sl`` (slices or ints, one a leading dimension) as one slice a
    dimension, and the dimensions an int drops."""
    sl = tuple(sl) + (slice(None),) * (len(shape) - len(sl))
    out, drop = [], []
    for k, (s, n) in enumerate(zip(sl, shape)):
        if isinstance(s, int):
            out.append(slice(s, s + 1))
            drop.append(k)
        else:
            lo, hi, step = s.indices(n)
            if step != 1:
                raise ValueError(f"step {step} in a region")
            out.append(slice(lo, hi))
    return tuple(out), drop


def read_region(leaf: PlacedTensor, sl, device, by_block: dict | None = None
                ) -> torch.Tensor:
    """The leaf's global index range ``sl`` (slices or ints, one a leading
    dimension) as one tensor on ``device``, cut from the blocks that
    cover it, each from ``by_block[block]`` (default: its first holder's
    shard) and concatenated.  Differentiable when the blocks are."""
    sl, drop = _full(sl, leaf.shape)
    local = leaf.sharding.shard_shape(leaf.shape)
    if by_block is None:
        by_block = {b: leaf.shards[i] for b, i in holders(leaf).items()}

    def build(k: int, block: tuple, cut: tuple) -> torch.Tensor:
        if k == len(sl):
            t = by_block[block][cut]
            return t if t.device == device else t.to(device)
        n, s = local[k], sl[k]
        pieces = [build(k + 1, block + (j,),
                        cut + (slice(max(s.start, j * n) - j * n,
                                     min(s.stop, (j + 1) * n) - j * n),))
                  for j in range(s.start // n, -(-s.stop // n))]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=k)

    out = build(0, (), ())
    for k in reversed(drop):
        out = out.squeeze(k)
    return out


def write_region(leaf: PlacedTensor, sl, value: torch.Tensor,
                 written: set) -> None:
    """Copy ``value`` (the global range ``sl`` of the leaf, as
    :func:`read_region` gives it) into every position's shard that holds
    part of it.  Positions whose shards are views of one copy are written
    once: ``written`` keeps what this update has written."""
    sl, drop = _full(sl, leaf.shape)
    for k in drop:
        value = value.unsqueeze(k)
    for idx in leaf.sharding.mesh.positions():
        own = leaf.sharding.slices(leaf.shape, idx)
        lo = [max(a.start, b.start) for a, b in zip(own, sl)]
        hi = [min(a.stop, b.stop) for a, b in zip(own, sl)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        target = leaf.shards[idx][tuple(
            slice(a - o.start, b - o.start) for a, b, o in zip(lo, hi, own))]
        key = (target.device, target.data_ptr(), tuple(target.shape),
               target.stride())
        if key in written:
            continue
        written.add(key)
        target.copy_(value[tuple(slice(a - s.start, b - s.start)
                                 for a, b, s in zip(lo, hi, sl))])


def from_blocks(like: PlacedTensor, values: dict, dtype=None) -> PlacedTensor:
    """A leaf placed as ``like`` whose block ``b`` is ``values[b]``: every
    holder of a block gets that tensor, copied once to each other
    device."""
    on: dict = {}
    shards = {}
    for idx in like.sharding.mesh.positions():
        b = like.sharding.block(idx, like.ndim)
        dev = like.sharding.mesh.device(idx)
        if (b, dev) not in on:
            v = values[b]
            on[b, dev] = v if v.device == dev else v.to(dev)
        shards[idx] = on[b, dev]
    return PlacedTensor(like.shape, dtype or next(iter(values.values())).dtype,
                        like.sharding, shards)


def first_device(leaf: PlacedTensor) -> torch.device:
    """The device of the mesh's first position."""
    mesh = leaf.sharding.mesh
    return mesh.device(mesh.positions()[0])
