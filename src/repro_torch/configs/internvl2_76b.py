# Copy of src/repro/configs/internvl2_76b.py (the port imports nothing of the JAX package).
"""internvl2-76b — InternViT (stub) + LLaMA-3-70B-class backbone
[arXiv:2404.16821; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab=128256,
        rope_theta=5e5,
        frontend="vision-patches", frontend_len=256,
        grad_accum=8,
    )
