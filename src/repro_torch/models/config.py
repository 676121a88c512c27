# Copy of src/repro/models/config.py (the port imports nothing of the JAX package).
"""Model + shape configuration.

One frozen dataclass drives every architecture in the zoo; per-arch
constructor modules live in :mod:`repro.configs`.  The four assigned
input shapes are global constants (per-arch applicability is resolved by
:func:`repro.launch.cells.enumerate_cells`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: bool = True           # whisper uses absolute sinusoid instead
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    mlp_gelu: bool = False      # starcoder2/whisper: plain GELU MLP

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    router: str = "softmax"     # softmax | sigmoid (deepseek-v3)
    capacity_factor: float = 1.25
    dense_prefix: int = 0       # first k layers dense (deepseek-v3: 3)
    dense_d_ff: int = 0         # d_ff of those dense layers

    # SSM / Mamba2
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_groups: int = 1

    # hybrid (zamba2): shared attention block every `hybrid_period` layers
    hybrid_period: int = 0

    # encoder-decoder / VLM stubs
    n_enc_layers: int = 0
    frontend: str = ""          # 'audio-frames' | 'vision-patches'
    frontend_len: int = 0       # 1500 frames / 256 patches

    # extra heads
    mtp: bool = False           # deepseek-v3 multi-token prediction

    # numerics / training shape
    optimizer: str = "adamw"    # huge configs use adafactor (DESIGN.md §5)
    attn_chunk: int = 1024      # query-chunked attention above this length
    ce_chunk: int = 2048        # chunked cross-entropy (0 = off)
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    remat: bool = True
    grad_accum: int = 1         # microbatches per train step
    grad_accum_dtype: str = "float32"  # bf16 halves accumulator HBM (671B)

    # sharding: padded head counts (0 ⇒ unpadded); see sharding/rules.py
    pad_heads_to: int = 0
    kv_cache_mode: str = "auto"  # auto|heads|sequence|replicate

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def _head_geometry(self) -> tuple[int, int, int, int]:
        """(h_eff, kv_eff, kv_factor, group_eff) for TP head padding.

        GQA: each real KV head is replicated ``kv_factor`` times
        consecutively; each replicated KV head serves ``group_eff`` query
        slots; real query heads fill the first ``n_heads//n_kv_heads``
        slots of each real-KV group, the rest are masked (inert).
        MHA: Q and KV pad together; padded heads masked.
        """
        h, kv, tp = self.n_heads, self.n_kv_heads, self.pad_heads_to
        if not tp or (h % tp == 0 and kv % tp == 0):
            return h, kv, 1, h // max(kv, 1)
        if kv == h:  # MHA
            h_eff = -(-h // tp) * tp
            return h_eff, h_eff, 1, 1
        if kv % tp == 0:
            kv_eff = kv
        elif tp % kv == 0:
            kv_eff = tp
        else:
            raise ValueError(
                f"{self.name}: kv={kv} and tp={tp} are not divisible "
                "either way — unsupported padding geometry")
        factor = kv_eff // kv
        g = h // kv
        g_eff = -(-g // factor)
        return kv_eff * g_eff, kv_eff, factor, g_eff

    @property
    def n_heads_eff(self) -> int:
        return self._head_geometry()[0]

    @property
    def n_kv_eff(self) -> int:
        return self._head_geometry()[1]

    @property
    def vocab_eff(self) -> int:
        """Vocab padded to 128 lanes (shards over any TP degree ≤128)."""
        return -(-self.vocab // 128) * 128

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 64,
                vocab: int = 256, **kw) -> "ModelConfig":
        """Smoke-test sized version of the same family (see tests)."""
        scale = d_model / self.d_model
        upd = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=max(2, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=4 * d_model,
            vocab=vocab,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16,
            grad_accum=1,
            remat=False,
        )
        if self.n_experts:
            upd.update(n_experts=8, moe_top_k=2, d_expert=2 * d_model,
                       dense_prefix=min(self.dense_prefix, 1),
                       dense_d_ff=4 * d_model,
                       n_shared_experts=min(self.n_shared_experts, 1))
        if self.ssm_state:
            upd.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
        if self.hybrid_period:
            upd.update(hybrid_period=2, n_layers=max(n_layers, 4))
        if self.n_enc_layers:
            upd.update(n_enc_layers=2)
        if self.frontend_len:
            upd.update(frontend_len=8)
        upd.update(kw)
        return self.with_(**upd)

    # ----------------------------------------------------- analytics
    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers + head)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.family in ("dense", "vlm") or self.family == "encdec":
            if self.mla:
                per_layer += d * self.q_lora_rank
                per_layer += self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                per_layer += d * self.n_heads * self.d_head      # q
                per_layer += 2 * d * self.n_kv_heads * self.d_head
                per_layer += self.n_heads * self.d_head * d      # o
            per_layer += (2 if self.mlp_gelu else 3) * d * self.d_ff
            n += self.n_layers * per_layer
            if self.family == "encdec":
                enc = 4 * d * self.n_heads * self.d_head + 3 * d * self.d_ff
                cross = 4 * d * self.n_heads * self.d_head
                n += self.n_enc_layers * enc + self.n_layers * cross
        elif self.family == "moe":
            if self.mla:
                attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.qk_rope_dim)
                        + d * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
            else:
                attn = (d * self.n_heads * self.d_head
                        + 2 * d * self.n_kv_heads * self.d_head
                        + self.n_heads * self.d_head * d)
            moe_l = (self.n_experts + self.n_shared_experts) * 3 * d * \
                self.d_expert + d * self.n_experts
            dense_l = 3 * d * (self.dense_d_ff or self.d_ff)
            n += self.dense_prefix * (attn + dense_l)
            n += (self.n_layers - self.dense_prefix) * (attn + moe_l)
        elif self.family in ("ssm", "hybrid"):
            di, ns, h = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * di + 2 * self.ssm_groups * ns + h)
            per_layer += di * d                                   # out proj
            per_layer += self.ssm_conv * (di + 2 * self.ssm_groups * ns)
            n += self.n_layers * per_layer
            if self.hybrid_period:
                shared = (4 * d * self.n_heads * self.d_head
                          + 3 * d * self.d_ff)
                n += shared  # shared block counted once
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_all = (self.n_layers - self.dense_prefix) * \
            self.n_experts * 3 * self.d_model * self.d_expert
        moe_act = (self.n_layers - self.dense_prefix) * \
            (self.moe_top_k * 3 * self.d_model * self.d_expert)
        return full - moe_all + moe_act
