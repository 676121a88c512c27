# Copy of src/repro/configs/qwen3_moe_30b_a3b.py (the port imports nothing of the JAX package).
"""qwen3-moe-30b-a3b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=768, vocab=151936,
        qk_norm=True, rope_theta=1e6,
        n_experts=128, moe_top_k=8, d_expert=768,
        grad_accum=2,
    )
