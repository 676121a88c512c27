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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..tree import tree_leaves


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, state, params, step) -> (params, state), in place


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


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

    @torch.no_grad()
    def update(grads, state, params, step):
        leaves_g = tree_leaves(grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        t = _t(step, gnorm.device)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        for g, p, m, v in zip(leaves_g, tree_leaves(params), state["m"],
                              state["v"]):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            u = u + weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
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

    @torch.no_grad()
    def update(grads, state, params, step):
        leaves_g = tree_leaves(grads)
        t = _t(step, leaves_g[0].device)
        beta2 = 1.0 - t ** (-decay)
        for g, p, s in zip(leaves_g, tree_leaves(params), state["stats"]):
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
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, state

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(name)
