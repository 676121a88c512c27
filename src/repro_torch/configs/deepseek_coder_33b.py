# Copy of src/repro/configs/deepseek_coder_33b.py (the port imports nothing of the JAX package).
"""deepseek-coder-33b — dense GQA, llama arch [arXiv:2401.14196; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=19200, vocab=32256,
        rope_theta=1e5,
        grad_accum=4,
    )
