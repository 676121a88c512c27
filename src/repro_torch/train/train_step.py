"""The train step: gradient accumulation into a float32 accumulator and
optional int8-compressed gradients.

Counterpart of ``src/repro/train/train_step.py``.  Where the JAX step
runs its microbatches as a ``lax.scan`` under one ``value_and_grad``,
this one runs a backward pass a microbatch and adds ``g / ga`` into a
``cfg.grad_accum_dtype`` accumulator, then takes the mean of the
microbatches' metrics.  The step runs eagerly on the parameters' device
(the first leaf's); a batch of numpy arrays is copied there.

A tree placed on a mesh (``PlacedTensor`` leaves, as an elastic restore
with ``shardings`` gives it) runs over the mesh's positions
(:mod:`.sharded_step`), as the JAX step runs under ``jit`` with the
parameters' shardings: the batch is split over the data positions, and
the step returns the placed tree, its shardings unchanged.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..sharding.placement import is_placed
from . import sharded_step
from ..tree import tree_leaves, tree_unflatten
from .optimizer import Optimizer, global_norm


def _split_micro(batch: dict, ga: int) -> dict:
    def r(x):
        b = x.shape[0]
        if b % ga:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{ga}")
        return x.reshape((ga, b // ga) + tuple(x.shape[1:]))
    return {k: r(v) for k, v in batch.items()}


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _grads(cfg: ModelConfig, leaves: list, params: Any, batch: dict):
    """One backward pass: (gradient a leaf, metrics); a leaf the loss
    does not reach gets zeros, as under ``jax.grad``."""
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = T.train_loss(cfg, tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return ([torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)],
            {k: v.detach() for k, v in metrics.items()})


def grads_and_metrics(cfg: ModelConfig, params: Any, batch: dict):
    """Accumulated float32 grads + mean metrics over the microbatches;
    on a placed tree, gradients placed as the parameters
    (:func:`.sharded_step.grads_and_metrics`)."""
    if is_placed(params):
        return sharded_step.grads_and_metrics(cfg, params, batch)
    ga = max(cfg.grad_accum, 1)
    leaves = tree_leaves(params)
    batch = _on(batch, leaves[0].device)
    if ga == 1:
        grads, metrics = _grads(cfg, leaves, params, batch)
        return tree_unflatten(params, [g.float() for g in grads]), metrics

    micro = _split_micro(batch, ga)
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for p in leaves]
    per_micro = []
    for i in range(ga):
        grads, metrics = _grads(cfg, leaves, params,
                                {k: v[i] for k, v in micro.items()})
        acc = [a + (g.float() / ga).to(acc_dt) for a, g in zip(acc, grads)]
        per_micro.append(metrics)
    metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
               for k in per_micro[0]}
    return tree_unflatten(params, [a.float() for a in acc]), metrics


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    compress: Callable | None = None):
    """Returns step(params, opt_state, batch, step_idx) → (p, s, metrics).

    ``compress``: optional gradient-compression transform (see
    :mod:`.compression`) applied between the gradients and the
    optimizer.  The optimizer updates ``params`` and ``opt_state`` in
    place (the JAX step's donated buffers) and the step returns them.

    On parameters and state placed on a mesh the step runs over its
    positions (:mod:`.sharded_step`, every family on every mesh) and
    updates the placed shards in place.
    """

    def step(params, opt_state, batch, step_idx):
        if is_placed(opt_state) and not is_placed(params):
            raise ValueError("the optimizer state is placed on a mesh and "
                             "the parameters are not")
        grads, metrics = grads_and_metrics(cfg, params, batch)
        if compress is not None:
            grads, opt_state = compress(grads, opt_state)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        new_params, new_opt = opt.update(grads, opt_state, params, step_idx)
        # carry non-optimizer state (e.g. compression error feedback)
        for k, v in opt_state.items():
            if k not in new_opt:
                new_opt[k] = v
        return new_params, new_opt, metrics

    return step
