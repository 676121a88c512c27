# Copy of src/repro/configs/whisper_large_v3.py (the port imports nothing of the JAX package).
"""whisper-large-v3 — enc-dec, conv frontend stubbed to precomputed
frames [arXiv:2212.04356; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
        d_ff=5120, vocab=51866,
        rope=False,
        frontend="audio-frames", frontend_len=1500,
    )
