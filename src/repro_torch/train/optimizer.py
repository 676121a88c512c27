"""Optimizers as plain functions over the port's parameter trees.

Counterpart of ``src/repro/train/optimizer.py``:

* ``adamw``     — float32 moments;
* ``adafactor`` — factored second moment (Shazeer & Stern), no first
  moment: optimizer state O(rows + cols) a matrix.

Both support decoupled weight decay and update clipping.  States are
flat lists parallel to ``tree_leaves(params)`` (JAX's leaf order, see
:mod:`repro_torch.tree`), so a JAX optimizer state carries over leaf for
leaf (:func:`repro_torch.convert.opt_state_from_numpy`).  The arithmetic is
the JAX function's, in float32: the step count ``t = step + 1`` is a
float32 tensor, as are the bias corrections and Adafactor's
``beta2 = 1 - t ** -decay``.

``update`` writes the new parameters and states into the tensors it was
given, under ``torch.no_grad()`` (the JAX step donates both buffers), and
returns them, ``(params, state)``, as the JAX function returns its new
ones.

Trees placed on a mesh (:class:`~repro_torch.sharding.placement.
PlacedTensor` leaves, the sharded train step's) are updated block by
block, each block of a parameter once, from its first holder's shard, and
written to every holder; a state placed otherwise than its parameter is
read and written by global range.  The norm sums each element once, and
Adafactor's row, column and update means sum over the blocks that split
their dimensions, as XLA's partitioned step sums over the devices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..sharding.placement import (PlacedTensor, first_device, holders,
                                  read_region, write_region)
from ..tree import tree_leaves


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, state, params, step) -> (params, state), in place


def _square_sum(g) -> torch.Tensor:
    if isinstance(g, PlacedTensor):     # each block once
        dev = first_device(g)
        return sum(torch.sum(torch.square(g.shards[i].float())).to(dev)
                   for i in holders(g).values())
    return torch.sum(torch.square(g.float()))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(g) for g in tree_leaves(tree)))


def _device(leaf) -> torch.device:
    return first_device(leaf) if isinstance(leaf, PlacedTensor) \
        else leaf.device


def _blocks(p: PlacedTensor):
    """``(global slices, device)`` of each block of a placed parameter,
    at its first holder."""
    for b, idx in holders(p).items():
        yield (p.sharding.slices(p.shape, idx), p.sharding.mesh.device(idx))


def _t(step, device) -> torch.Tensor:
    """``step + 1`` as a float32 tensor (the JAX update's ``t``)."""
    return torch.tensor(int(step) + 1, dtype=torch.float32, device=device)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def make_adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.1,
               clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        leaves = tree_leaves(params)
        return {"m": [_zeros(p.shape, p) for p in leaves],
                "v": [_zeros(p.shape, p) for p in leaves]}

    def leaf(g, p, m, v, scale, c1, c2):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    @torch.no_grad()
    def update(grads, state, params, step):
        leaves_g = tree_leaves(grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        t = _t(step, gnorm.device)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        written: set = set()
        for g, p, m, v in zip(leaves_g, tree_leaves(params), state["m"],
                              state["v"]):
            if not isinstance(p, PlacedTensor):
                for dst, new in zip((p, m, v), leaf(g, p, m, v, scale, c1,
                                                    c2)):
                    dst.copy_(new)
                continue
            for sl, dev in _blocks(p):
                new = leaf(*(read_region(x, sl, dev) for x in (g, p, m, v)),
                           scale.to(dev), c1.to(dev), c2.to(dev))
                for dst, x in zip((p, m, v), new):
                    write_region(dst, sl, x, written)
        return params, state

    return Optimizer("adamw", init, update)


def make_adafactor(lr: float = 1e-3, decay: float = 0.8,
                   eps: float = 1e-30, clip_threshold: float = 1.0,
                   weight_decay: float = 0.0) -> Optimizer:
    """Factored RMS scaling; β₂ anneals as 1 − t^−decay (paper schedule)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": _zeros(p.shape[:-1], p),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _zeros(p.shape, p)}
        return {"stats": [one(p) for p in tree_leaves(params)]}

    def finish(mean_sq, p, u):
        """The update clipped by its RMS and applied: the new parameter."""
        rms = torch.sqrt(mean_sq + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    def placed(g, p, s, beta2, written):
        """One placed leaf: the row and column means and the update's RMS
        summed over the blocks that split their dimensions."""
        blocks = list(_blocks(p))
        gs = [read_region(g, sl, dev).float() for sl, dev in blocks]
        g2 = [x * x + eps for x in gs]
        b2 = {dev: beta2.to(dev) for _, dev in blocks}

        def key(sl):
            return tuple((x.start, x.stop) for x in sl)

        def total(parts):               # key -> the sum of its parts
            out: dict = {}
            for k, x in parts:
                out[k] = x if k not in out else out[k] + x.to(out[k].device)
            return out

        if _factored(p.shape):
            rows, cols = p.shape[-2], p.shape[-1]
            rsum = total((key(sl[:-1]), x.sum(-1))
                         for (sl, _), x in zip(blocks, g2))
            csum = total((key(sl[:-2] + sl[-1:]), x.sum(-2))
                         for (sl, _), x in zip(blocks, g2))
            vr, vc = {}, {}
            for sl, dev in blocks:
                kr, kc = key(sl[:-1]), key(sl[:-2] + sl[-1:])
                if kr not in vr:
                    vr[kr] = (b2[dev] * read_region(s["vr"], sl[:-1], dev)
                              + (1 - b2[dev]) * rsum[kr].to(dev) / cols)
                if kc not in vc:
                    vc[kc] = (b2[dev] * read_region(s["vc"], sl[:-2]
                                                    + sl[-1:], dev)
                              + (1 - b2[dev]) * csum[kc].to(dev) / rows)
            vr_mean = total((k[:-1], x.sum(-1)) for k, x in vr.items())
            us = []
            for (sl, dev), x in zip(blocks, gs):
                kr = key(sl[:-1])
                rfac = (vr[kr] / torch.clamp(
                    vr_mean[kr[:-1]].to(dev)[..., None] / rows,
                    min=eps))[..., None]
                vc_b = vc[key(sl[:-2] + sl[-1:])]
                us.append(x * torch.rsqrt(rfac * vc_b[..., None, :] + eps))
            for k, x in vr.items():
                write_region(s["vr"], tuple(slice(*r) for r in k), x,
                             written)
            for k, x in vc.items():
                write_region(s["vc"], tuple(slice(*r) for r in k), x,
                             written)
        else:
            us = []
            for (sl, dev), x, x2 in zip(blocks, gs, g2):
                v = (b2[dev] * read_region(s["v"], sl, dev)
                     + (1 - b2[dev]) * x2)
                us.append(x * torch.rsqrt(v + eps))
                write_region(s["v"], sl, v, written)
        dev0 = blocks[0][1]
        u_sq = sum(torch.sum(u * u).to(dev0) for u in us)
        mean_sq = u_sq / math.prod(p.shape)
        for (sl, dev), u in zip(blocks, us):
            write_region(p, sl, finish(mean_sq.to(dev),
                                       read_region(p, sl, dev), u), written)

    @torch.no_grad()
    def update(grads, state, params, step):
        leaves_g = tree_leaves(grads)
        t = _t(step, _device(leaves_g[0]))
        beta2 = 1.0 - t ** (-decay)
        written: set = set()
        for g, p, s in zip(leaves_g, tree_leaves(params), state["stats"]):
            if isinstance(p, PlacedTensor):
                placed(g, p, s, beta2, written)
                continue
            g = g.float()
            g2 = g * g + eps
            if _factored(g.shape):
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                rfac = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                         min=eps))[..., None]
                u = g * torch.rsqrt(rfac * vc[..., None, :] + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            p.copy_(finish(torch.mean(u * u), p, u))
        return params, state

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(name)
