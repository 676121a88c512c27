# Copy of src/repro/configs/qwen3_0_6b.py (the port imports nothing of the JAX package).
"""qwen3-0.6b — dense GQA + qk_norm [hf:Qwen/Qwen3-8B family; hf-verified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
        d_ff=3072, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    )
