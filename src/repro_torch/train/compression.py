"""int8 gradient compression with error feedback (pure-DP mode).

Counterpart of ``src/repro/train/compression.py``.  int8 quantization
with a per-tensor scale cuts the data-parallel gradient all-reduce 4×
against float32; the residual quantization error is carried in an
error-feedback buffer, so the expected update is unbiased (Seide et al.,
EF-SGD).  ``torch.round`` rounds half to even as ``jnp.round`` does, so
the int8 codes equal the JAX function's.

:func:`compressed_psum` is the JAX function that runs inside
``shard_map`` over the data axis.  The port drives every position from
one host thread (the reference's single controller, no
``torch.distributed``), so here it takes the list of per-position
gradients and returns each position's reduced copy.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..tree import tree_leaves, tree_unflatten


def _scale(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp(g.abs().max(), min=1e-12) / 127.0


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_error_feedback_compressor():
    """Returns (init_state_fn, compress_fn) for the train step."""

    def init(params):
        return {"ef": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                       for p in tree_leaves(params)]}

    def compress(grads, opt_state):
        efs = opt_state["compression"]["ef"]
        out, new_ef = [], []
        for g, e in zip(tree_leaves(grads), efs):
            g32 = g.float() + e
            q, scale = quantize_int8(g32)
            deq = dequantize_int8(q, scale)
            new_ef.append(g32 - deq)
            out.append(deq)
        opt_state = dict(opt_state)
        opt_state["compression"] = {"ef": new_ef}
        return tree_unflatten(grads, out), opt_state

    return init, compress


def compressed_psum(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """int8 all-reduce over the data positions: quantize → sum in int32 →
    scale.

    ``shards`` holds one gradient a position (on its device).  The
    positions' scales are maxed, so the int32 sum is exact in the shared
    scale; every position gets the same sum, on its own device.
    """
    dev = shards[0].device
    scale = torch.stack([_scale(g).to(dev) for g in shards]).max()
    total = sum(torch.clamp(torch.round(g.to(dev) / scale), -127,
                            127).to(torch.int32) for g in shards)
    out = total.float() * scale
    return [out.to(g.device) for g in shards]
