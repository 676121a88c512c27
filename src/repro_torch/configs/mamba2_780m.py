# Copy of src/repro/configs/mamba2_780m.py (the port imports nothing of the JAX package).
"""mamba2-780m — attention-free SSD [arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_head=1,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_headdim=64, ssm_chunk=256,
        tie_embeddings=True,
    )
