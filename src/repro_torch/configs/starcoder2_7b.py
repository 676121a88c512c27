# Copy of src/repro/configs/starcoder2_7b.py (the port imports nothing of the JAX package).
"""starcoder2-7b — dense GQA + RoPE [arXiv:2402.19173; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
        d_ff=18432, vocab=49152,
        rope_theta=1e5, mlp_gelu=True,
        grad_accum=2,
    )
