# Copy of src/repro/configs/zamba2_7b.py (the port imports nothing of the JAX package).
"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
        d_ff=14336, vocab=32000,
        ssm_state=64, ssm_headdim=64, ssm_chunk=256,
        hybrid_period=6,
        grad_accum=2,
    )
