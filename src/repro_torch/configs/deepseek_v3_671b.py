# Copy of src/repro/configs/deepseek_v3_671b.py (the port imports nothing of the JAX package).
"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=2048, vocab=129280,
        mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=256, n_shared_experts=1, moe_top_k=8, d_expert=2048,
        router="sigmoid", dense_prefix=3, dense_d_ff=18432,
        mtp=True,
        optimizer="adafactor",
        grad_accum=16, grad_accum_dtype="bfloat16",
    )
