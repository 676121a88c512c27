"""Cell enumeration: (architecture × input shape) → dry-run spec.

Counterpart of ``src/repro/launch/cells.py``.  40 cells in all (10
architectures × 4 shapes).  ``long_500k`` runs only for the
sub-quadratic families (ssm, hybrid); the full-attention architectures
keep a documented skip, and are still listed, so the table shows all 40
rows.  The input stand-ins are ``meta`` tensors (shapes and dtypes, no
memory), where the JAX package uses ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs import ARCHS, get_config
from ..models.config import SHAPES, ModelConfig, ShapeSpec


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeSpec
    runnable: bool
    skip_reason: str = ""

    @property
    def name(self) -> str:
        return f"{self.arch}__{self.shape.name}"


def enumerate_cells() -> list[Cell]:
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.is_subquadratic:
                cells.append(Cell(arch, shape, False,
                                  "full quadratic attention at 524k context"
                                  " — skipped per assignment"))
            else:
                cells.append(Cell(arch, shape, True))
    return cells


def dryrun_config(arch: str, pad_heads_to: int = 16) -> ModelConfig:
    """Full config in production numerics (bf16, remat, padded heads)."""
    return get_config(arch).with_(
        param_dtype="bfloat16", activ_dtype="bfloat16",
        pad_heads_to=pad_heads_to, remat=True)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
    }
    if cfg.family == "vlm":
        out["patches"] = _meta((b, cfg.frontend_len, cfg.d_model),
                               torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.frontend_len, cfg.d_model),
                              torch.bfloat16)
    return out


def serve_batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Prefill inputs: the request batch (no labels)."""
    out = batch_struct(cfg, shape)
    out.pop("labels")
    return out


def decode_tokens_struct(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful model FLOPs for the roofline's MODEL_FLOPS row.

    train:   6·N_active·D   (fwd+bwd)
    prefill: 2·N_active·D
    decode:  2·N_active·B   (one token per sequence)
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch
