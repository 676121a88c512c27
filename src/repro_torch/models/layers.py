"""Layer primitives shared by the whole zoo, on PyTorch tensors.

Counterpart of ``src/repro/models/layers.py``: every layer is a plain
function ``(cfg, params, x, ...) -> y`` over a dict of tensors, so the
parameter tree is the JAX package's, key for key (stacked layers keep
their leading ``n_layers`` axis; the model loops over its views).
Attention logits and softmax run in float32 whatever the activation
dtype.  Mixed operands of a contraction are promoted first as JAX
promotes them (bfloat16 with float32 gives float32), since
``torch.einsum`` refuses mixed dtypes; a contraction that JAX runs in
bfloat16 (the softmax weights with a bfloat16 cache) runs in bfloat16
here too.

Caches are written in place: a layer given ``cache`` writes its new keys,
values or states into the cache's tensors (views of the stacked cache)
and returns that cache, where the JAX layer returns an updated copy.
Without a cache every layer is differentiable as written (the training
path): the MoE dispatch's ``index_put_`` and ``index_add_`` write into
fresh buffers, and the SSD chunk recurrence builds new tensors.

Under :func:`repro_torch.sharding.ctx.mesh_context` the MoE layer runs
expert-parallel over the mesh's positions (``_moe_ep_shardmap`` /
``_moe_ep_stationary``, picked as the JAX layer picks them); outside it,
:func:`moe` is the single-device path.  ``constrain`` (a sharding hint
to XLA) has no counterpart here: :func:`repro_torch.sharding.ctx.
constrain` is the identity.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.ctx import _mesh
from .config import ModelConfig

Params = dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.activ_dtype)


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on operands promoted to their common dtype, as
    ``jnp.einsum`` promotes them."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion of mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ------------------------------------------------------------------- init
# ``gen`` draws the weights on its own device; ``None`` gives tensors on
# the meta device (shapes and dtypes only, no memory)
def _dense_init(gen: torch.Generator | None, shape, dtype, scale=None,
                lead=()):
    """Normal weights of ``lead + shape`` scaled by ``shape``'s fan-in (the
    JAX initialiser's distribution; ``lead`` stacks layers)."""
    shape = tuple(lead) + tuple(shape)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[len(lead)] if len(shape) - len(lead) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def _full(gen: torch.Generator | None, shape, value: float, dtype, lead=()):
    return torch.full(tuple(lead) + tuple(shape), value, dtype=dtype,
                      device="meta" if gen is None else gen.device)


def init_norm(d: int, dtype, gen: torch.Generator, lead=()) -> Params:
    return {"scale": _full(gen, (d,), 1.0, dtype, lead)}


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(dt)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, p: Params,
                   eps: float) -> torch.Tensor:
    """Mamba2's RMSNormGated: norm(x * silu(z))."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), p, eps)


# ------------------------------------------------------------------- rope
def rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., L, H, d): rotate the two halves (llama convention, float32
    math), not interleaved pairs."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions.float()[..., None] * freqs          # (..., L, d/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def _kv_param_heads(cfg: ModelConfig) -> int:
    """KV heads as stored in params: MHA padded like Q, GQA at the real
    count (replicated to the padded count in the forward pass)."""
    if cfg.n_kv_heads == cfg.n_heads:
        return cfg.n_heads_eff
    return cfg.n_kv_heads


def init_attention(cfg: ModelConfig, gen: torch.Generator, lead=(),
                   cross: bool = False) -> Params:
    dt = pdtype_of(cfg)
    d, h, dh = cfg.d_model, cfg.n_heads_eff, cfg.d_head
    kvp = _kv_param_heads(cfg)
    p: Params = {
        "wq": _dense_init(gen, (d, h, dh), dt, lead=lead),
        "wk": _dense_init(gen, (d, kvp, dh), dt, lead=lead),
        "wv": _dense_init(gen, (d, kvp, dh), dt, lead=lead),
        "wo": _dense_init(gen, (h, dh, d), dt, scale=(h * dh) ** -0.5,
                          lead=lead),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = _full(gen, (h, dh), 0.0, dt, lead)
        p["bk"] = _full(gen, (kvp, dh), 0.0, dt, lead)
        p["bv"] = _full(gen, (kvp, dh), 0.0, dt, lead)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(dh, dt, gen, lead)
        p["k_norm"] = init_norm(dh, dt, gen, lead)
    return p


def _head_mask(cfg: ModelConfig, device) -> torch.Tensor | None:
    """Zero padded query heads so TP head padding is inert: query slots are
    grouped per real KV head, ``kv_factor * group_eff`` slots each, of
    which the first ``n_heads // n_kv_heads`` are real."""
    h_eff, kv_eff, factor, g_eff = cfg._head_geometry()
    if h_eff == cfg.n_heads:
        return None
    if cfg.n_kv_heads == cfg.n_heads:  # MHA: padded tail
        return (torch.arange(h_eff, device=device) < cfg.n_heads).float()
    g = cfg.n_heads // cfg.n_kv_heads
    per_group = factor * g_eff
    return (torch.arange(per_group, device=device) < g).repeat(
        cfg.n_kv_heads).float()


def _project_kv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """K/V projection to ``n_kv_eff`` heads; with fewer stored KV heads each
    is repeated consecutively, so query head i still reads real KV head
    ``i // (n_heads // n_kv_heads)``."""
    k = einsum("bld,dkh->blkh", x, p["wk"])
    v = einsum("bld,dkh->blkh", x, p["wv"])
    if cfg.qkv_bias and "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    kvp = k.shape[2]
    if kvp != cfg.n_kv_eff:
        if cfg.n_kv_eff % kvp:
            raise ValueError(f"n_kv_eff {cfg.n_kv_eff} is not a multiple of "
                             f"the stored {kvp} KV heads")
        factor = cfg.n_kv_eff // kvp
        k = k.repeat_interleave(factor, dim=2)
        v = v.repeat_interleave(factor, dim=2)
    return k, v


def _write(buf: torch.Tensor, new: torch.Tensor, off: int) -> torch.Tensor:
    """Write ``new`` into ``buf`` along axis 1 at ``off`` (in place: the
    JAX layer's ``dynamic_update_slice_in_dim``), and return ``buf``."""
    buf[:, off:off + new.shape[1]] = new.to(buf.dtype)
    return buf


def _chunks(l: int, chunk: int) -> int:
    """Query chunks of the flash-style branch (1: attend at once)."""
    return l // chunk if chunk and l > chunk and l % chunk == 0 else 1


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              positions: torch.Tensor, causal: bool = True,
              cache: Params | None = None, cache_pos: int | None = None,
              kv_x: torch.Tensor | None = None,
              window: int | None = None,
              head_mask: torch.Tensor | None = None):
    """GQA attention with optional KV cache and cross-attention.

    cache: {"k","v"} (B, T, KV, dh); cache_pos: the current length (a
    decode step writes its one token there, a prefill writes at 0).
    ``head_mask`` replaces ``cfg``'s padded-head mask (a tensor-parallel
    slice of the heads passes its part of the global one).
    Returns (y, cache).
    """
    b, l, d = x.shape
    h, kv, dh = cfg.n_heads_eff, cfg.n_kv_eff, cfg.d_head
    q = einsum("bld,dhk->blhk", x, p["wq"])
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"]
    is_cross = kv_x is not None
    reuse_cross = is_cross and cache is not None and cache_pos is not None
    if not reuse_cross:      # a cross decode step reads its prefill's k/v
        k, v = _project_kv(cfg, p, x if kv_x is None else kv_x)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if not reuse_cross:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not is_cross and cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and not is_cross:
        off = cache_pos if l == 1 and cache_pos is not None else 0
        k = _write(cache["k"], k, off)
        v = _write(cache["v"], v, off)
        new_cache = cache
    elif reuse_cross:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    elif cache is not None:
        # prefill: the cross cache takes the encoder output's k/v
        # (this step attends with the uncast k/v, as the JAX layer does)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        new_cache = cache

    t = k.shape[1]
    g = h // kv
    qg = q.reshape(b, l, kv, g, dh)
    scale = dh ** -0.5

    key_pos = torch.arange(t, device=x.device)
    if cache is not None and not is_cross:
        limit = (cache_pos + l) if cache_pos is not None else l
        valid = key_pos[None, :] < limit
    else:
        valid = torch.ones((1, t), dtype=torch.bool, device=x.device)

    def attend(qg_c, pos_c):
        """(b, lc, kv, g, dh) queries → (b, lc, kv, g, dh) context, one
        (lc, t) score tile at a time."""
        lc = qg_c.shape[1]
        scores = einsum("blkgh,btkh->bklgt", qg_c, k).float() * scale
        if causal and not is_cross:
            cmask = key_pos[None, None, :] <= pos_c[..., None]  # (b, lc, t)
            mask = cmask & valid[:, None, :]
        else:
            mask = valid[:, None, :].expand(b, lc, t)
        if window is not None and causal and not is_cross:
            mask = mask & (key_pos[None, None, :]
                           > (pos_c[..., None] - window))
        scores = torch.where(mask[:, None, :, None, :], scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        return einsum("bklgt,btkh->blkgh", w, v)

    nc = _chunks(l, cfg.attn_chunk)
    if nc > 1:
        ctx = torch.cat([attend(qc, pc) for qc, pc in zip(
            qg.chunk(nc, dim=1), positions.chunk(nc, dim=1))], dim=1)
    else:
        ctx = attend(qg, positions)
    ctx = ctx.reshape(b, l, h, dh)
    hm = _head_mask(cfg, x.device) if head_mask is None else head_mask
    if hm is not None:
        ctx = ctx * hm[None, None, :, None].to(ctx.dtype)
    y = einsum("blhk,hkd->bld", ctx, p["wo"])
    return y, new_cache


# ------------------------------------------------------------ MLA (DSv3)
def init_mla(cfg: ModelConfig, gen: torch.Generator, lead=()) -> Params:
    dt = pdtype_of(cfg)
    d, h = cfg.d_model, cfg.n_heads_eff
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": _dense_init(gen, (d, qr), dt, lead=lead),
        "q_norm": init_norm(qr, dt, gen, lead),
        "w_uq": _dense_init(gen, (qr, h, dn + dr), dt, lead=lead),
        "w_dkv": _dense_init(gen, (d, kr + dr), dt, lead=lead),
        "kv_norm": init_norm(kr, dt, gen, lead),
        "w_uk": _dense_init(gen, (kr, h, dn), dt, lead=lead),
        "w_uv": _dense_init(gen, (kr, h, dv), dt, lead=lead),
        "wo": _dense_init(gen, (h, dv, d), dt, scale=(h * dv) ** -0.5,
                          lead=lead),
    }


def mla_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                  positions: torch.Tensor, cache: Params | None = None,
                  cache_pos: int | None = None,
                  absorbed: bool | None = None,
                  head_mask: torch.Tensor | None = None):
    """DeepSeek-V3 Multi-head Latent Attention.

    The cache holds the compressed kv latent (B, T, kv_rank) and the shared
    rope key (B, T, rope_dim).  ``absorbed`` folds w_uk into the query and
    w_uv into the output (the decode form); it defaults to True for a
    one-token step with a cache, False otherwise.  ``head_mask`` as in
    :func:`attention`.
    """
    b, l, d = x.shape
    h = cfg.n_heads_eff
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if absorbed is None:
        absorbed = l == 1 and cache is not None
    scale = (dn + dr) ** -0.5

    cq = rms_norm(matmul(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = einsum("blr,rhk->blhk", cq, p["w_uq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = matmul(x, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0]          # (b, l, dr)

    new_cache = None
    if cache is not None:
        off = cache_pos if l == 1 and cache_pos is not None else 0
        c_kv = _write(cache["c_kv"], c_kv, off)
        k_rope = _write(cache["k_rope"], k_rope, off)
        new_cache = cache
    t = c_kv.shape[1]

    key_pos = torch.arange(t, device=x.device)
    limit = (cache_pos + l) if (cache is not None and cache_pos is not None) \
        else l if cache is not None else t
    valid = key_pos[None, :] < limit

    if not absorbed:
        k_nope = einsum("btr,rhk->bthk", c_kv, p["w_uk"])
        v_full = einsum("btr,rhv->bthv", c_kv, p["w_uv"])
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].to(
            k_nope.dtype).expand(b, t, h, dr)], dim=-1)

    def attend(qn_c, qr_c, pos_c):
        """Query-chunked MLA attention: (b, lc, h, ·) → (b, lc, h, dv)."""
        mask = ((key_pos[None, None, :] <= pos_c[..., None])
                & valid[:, None, :])[:, None, :, :]        # (b,1,lc,t)
        if absorbed:
            q_lat = einsum("blhk,rhk->blhr", qn_c, p["w_uk"])
            scores = (einsum("blhr,btr->bhlt", q_lat, c_kv)
                      + einsum("blhk,btk->bhlt", qr_c, k_rope)
                      ).float() * scale
            scores = torch.where(mask, scores, -1e30)
            w = torch.softmax(scores, dim=-1).to(c_kv.dtype)
            ctx_lat = einsum("bhlt,btr->blhr", w, c_kv)
            return einsum("blhr,rhv->blhv", ctx_lat, p["w_uv"])
        qf = torch.cat([qn_c, qr_c], dim=-1)
        scores = einsum("blhk,bthk->bhlt", qf, k_full).float() * scale
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(k_full.dtype)
        return einsum("bhlt,bthv->blhv", w, v_full)

    nc = _chunks(l, cfg.attn_chunk)
    if nc > 1:
        ctx = torch.cat([attend(*xs) for xs in zip(
            q_nope.chunk(nc, dim=1), q_rope.chunk(nc, dim=1),
            positions.chunk(nc, dim=1))], dim=1)
    else:
        ctx = attend(q_nope, q_rope, positions)
    hm = _head_mask(cfg, x.device) if head_mask is None else head_mask
    if hm is not None:
        ctx = ctx * hm[None, None, :, None].to(ctx.dtype)
    y = einsum("blhv,hvd->bld", ctx, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------- MLP/MoE
def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None,
             gelu: bool = False, lead=()) -> Params:
    dt = pdtype_of(cfg)
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {"wi": _dense_init(gen, (d, f if gelu else 2 * f), dt, lead=lead),
            "wo": _dense_init(gen, (f, d), dt, lead=lead)}


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
        gelu: bool = False) -> torch.Tensor:
    hp = matmul(x, p["wi"])
    if gelu:
        # jax.nn.gelu's default is the tanh approximation
        hp = F.gelu(hp.float(), approximate="tanh").to(x.dtype)
    else:
        gate, up = hp.chunk(2, dim=-1)
        hp = F.silu(gate.float()).to(x.dtype) * up
    return matmul(hp, p["wo"])


def init_moe(cfg: ModelConfig, gen: torch.Generator, lead=()) -> Params:
    dt = pdtype_of(cfg)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    p: Params = {
        "router": _dense_init(gen, (d, e), torch.float32, scale=d ** -0.5,
                              lead=lead),
        "wi": _dense_init(gen, (e, d, 2 * f), dt, lead=lead),
        "wo": _dense_init(gen, (e, f, d), dt, lead=lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, d_ff=cfg.n_shared_experts * f,
                               lead=lead)
    return p


def _router_weights(cfg: ModelConfig, logits: torch.Tensor):
    """Top-k routing weights (N, k) and expert ids (N, k), renormalised."""
    if cfg.router == "sigmoid":          # deepseek-v3
        scores = torch.sigmoid(logits)
    else:                                # qwen3: softmax then renormalize
        scores = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(scores, cfg.moe_top_k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w, idx


# --------------------------------------------- expert-parallel dispatches
# The JAX layer runs these under ``shard_map`` over a mesh.  Here every
# position of the active mesh (a ``FilterMesh``) runs its part from this
# thread, on its own CUDA stream (``FilterMesh.use``; off the card one
# after another), and each ``psum`` is a sum of the positions' partials
# copied to the first position of their group, then copied back to each
# position (:func:`_psum`).  The products stay ``torch.einsum``: the JAX
# package computes them outside any Pallas kernel.  Autograd runs each
# op's backward on the stream its forward ran on and orders the streams
# where gradients cross them.
def _ep_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert has for ``n_tokens`` tokens of one data shard:
    ``ceil(cf·n·k/E)`` rounded up to 8, at least 8."""
    cap = int(np.ceil(cfg.capacity_factor * n_tokens * cfg.moe_top_k
                      / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def _moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert has in the single-device path: rounded up to 128
    (the buffer's C dim shards over any dp degree), at least 128."""
    cap = int(np.ceil(cfg.capacity_factor * n_tokens * cfg.moe_top_k
                      / cfg.n_experts))
    return max(128, -(-cap // 128) * 128)


def dropped_assignments(cfg: ModelConfig, router: torch.Tensor,
                        x2: torch.Tensor, shards: int, cap: int) -> int:
    """Token-expert assignments a dispatch drops: ``x2``'s rows cut into
    ``shards`` equal data shards, each expert taking at most ``cap`` of
    a shard's (the EP paths: :func:`_ep_capacity` of a shard's rows, one
    shard for the stationary path; the single-device path:
    :func:`_moe_capacity` of all rows, one shard)."""
    with torch.no_grad():
        _, idx = _router_weights(cfg, x2.float() @ router)
        shard = torch.arange(x2.shape[0], device=x2.device) // (
            x2.shape[0] // shards)
        load = torch.zeros(shards * cfg.n_experts, dtype=torch.int64,
                           device=x2.device)
        load.index_add_(0, (shard[:, None] * cfg.n_experts + idx).reshape(-1),
                        torch.ones(idx.numel(), dtype=torch.int64,
                                   device=x2.device))
        return int((load - cap).clamp(min=0).sum())


def _ep_dispatch(cfg: ModelConfig, w: torch.Tensor, idx: torch.Tensor,
                 m_idx: int, e_loc: int, n_loc: int, cap: int):
    """Inverse map of a position's dispatch: ``(src, wgt)``, each
    ``(e_loc, cap)``, the token (``n_loc`` where empty) and router weight
    in each slot of its local experts; assignments past ``cap`` drop."""
    k = cfg.moe_top_k
    dev = w.device
    rel = idx - m_idx * e_loc
    mine = (rel >= 0) & (rel < e_loc)
    flat_le = torch.where(mine, rel, torch.full_like(rel, e_loc)).reshape(-1)
    flat_w = (w * mine).reshape(-1)
    order = torch.argsort(flat_le, stable=True)
    se = flat_le[order]
    sw = flat_w[order]
    tok = order // k
    pos = torch.arange(n_loc * k, device=dev) - torch.searchsorted(
        se, se, side="left")
    keep = (se < e_loc) & (pos < cap)
    at = (torch.where(keep, se, torch.full_like(se, e_loc)),
          torch.where(keep, pos, torch.full_like(pos, cap)))
    src = torch.full((e_loc + 1, cap + 1), n_loc, dtype=torch.int64,
                     device=dev)
    src.index_put_(at, torch.where(keep, tok, torch.full_like(tok, n_loc)))
    wgt = torch.zeros((e_loc + 1, cap + 1), dtype=torch.float32,
                      device=dev).index_put(
        at, torch.where(keep, sw, torch.zeros_like(sw)))
    return src[:e_loc, :cap], wgt[:e_loc, :cap]


def _ep_gather(x: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """The (e_loc, C, ·) capacity buffer: each slot's token, 0 if empty."""
    filled = (src < n)[..., None].to(x.dtype)
    return x[src.clamp(0, n - 1)] * filled


def _ep_combine(out: torch.Tensor, src: torch.Tensor, wgt: torch.Tensor,
                n: int, dtype: torch.dtype) -> torch.Tensor:
    """The experts' outputs weighted by the router, added back to their
    tokens: an (n, d) partial."""
    d = out.shape[-1]
    upd = (out * wgt[..., None].to(out.dtype)).reshape(-1, d)
    y = torch.zeros((n, d), dtype=dtype, device=out.device)
    return y.index_add(0, src.reshape(-1).clamp(0, n - 1), upd.to(dtype))


def _swiglu(hgate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    g, up = hgate.chunk(2, dim=-1)
    return F.silu(g.float()).to(dtype) * up


def _ep_local_compute(cfg: ModelConfig, x_loc, router, wi_loc, wo_loc,
                      e_loc: int, m_idx: int, cap: int) -> torch.Tensor:
    """Per-position MoE dispatch → grouped GEMM → weighted combine.

    Inverse-map formulation: only (e_loc, C) int maps are scattered; the
    (n·k, d) gathered-token tensor is never materialized."""
    n_loc = x_loc.shape[0]
    logits = x_loc.float() @ router
    w, idx = _router_weights(cfg, logits)              # (n_loc, k)
    src, wgt = _ep_dispatch(cfg, w, idx, m_idx, e_loc, n_loc, cap)
    hgate = einsum("ecd,edf->ecf", _ep_gather(x_loc, src, n_loc), wi_loc)
    out = einsum("ecf,efd->ecd", _swiglu(hgate, x_loc.dtype), wo_loc)
    return _ep_combine(out, src, wgt, n_loc, x_loc.dtype)


def _coord(mesh, idx: tuple, axes) -> int:
    """A position's index along ``axes`` taken together, row-major."""
    c = dict(zip(mesh.axis_names, idx))
    b = 0
    for a in axes:
        b = b * mesh.shape[a] + c[a]
    return b


def _on(mesh, idx: tuple, streams: bool):
    """Run the body on a position's stream (``FilterMesh.use``), or, with
    ``streams=False``, on the caller's current stream."""
    return mesh.use(idx) if streams else contextlib.nullcontext()


def _locals(dev: torch.device, *cuts) -> list[torch.Tensor]:
    """A position's slices ``(tensor, index)`` of the caller's tensors,
    taken on the caller's stream (where a parameter's gradient then
    accumulates): a view on the same device, else a copy."""
    return [t[sl] if t.device == dev else t[sl].to(dev) for t, sl in cuts]


def _keep(stream, tensors) -> None:
    """Keep the caller's tensors alive for a position's stream."""
    if stream is not None:
        for t in tensors:
            t.record_stream(stream)


def _groups(mesh, axes: tuple) -> list[list[tuple]]:
    """The positions in groups that differ only along ``axes``, each in
    row-major order."""
    groups: dict[tuple, list] = {}
    for idx in mesh.positions():
        key = tuple(i for a, i in zip(mesh.axis_names, idx) if a not in axes)
        groups.setdefault(key, []).append(idx)
    return list(groups.values())


def _collect(mesh, parts: dict, axes: tuple, streams: bool, combine) -> dict:
    """Each group's partials (:func:`_groups`) copied to its first position
    and folded there by ``combine(list)``; the result copied back to every
    position of the group."""
    out = {}
    for group in _groups(mesh, axes):
        root = group[0]
        dev = mesh.device(root)
        with _on(mesh, root, streams) as rs:
            got = [parts[root]]
            for m in group[1:]:
                if rs is not None:
                    rs.wait_stream(mesh.stream(m))
                    parts[m].record_stream(rs)
                got.append(parts[m].to(dev))
            total = combine(got)
        for m in group:
            with _on(mesh, m, streams) as ms:
                if ms is not None and m != root:
                    ms.wait_stream(rs)
                    total.record_stream(ms)
                out[m] = total.to(mesh.device(m))
    return out


def _psum(mesh, parts: dict, axes: tuple, streams: bool) -> dict:
    """``jax.lax.psum`` over ``axes``: the partials of each group of
    positions that differ only along ``axes`` are copied to the group's
    first position and added there in row-major order, and the sum is
    copied back to every position of the group."""
    return _collect(mesh, parts, axes, streams,
                    lambda xs: functools.reduce(torch.add, xs))


def _pmax(mesh, parts: dict, axes: tuple, streams: bool) -> dict:
    """``jax.lax.pmax`` over ``axes``, as :func:`_psum`."""
    return _collect(mesh, parts, axes, streams,
                    lambda xs: functools.reduce(torch.maximum, xs))


def _all_gather(mesh, parts: dict, axes: tuple, dim: int,
                streams: bool) -> dict:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axes``: each group's
    parts concatenated along ``dim`` in row-major order of the group."""
    return _collect(mesh, parts, axes, streams,
                    lambda xs: torch.cat(xs, dim=dim))


def _join(mesh, parts: dict, streams: bool) -> dict:
    """Order the caller's stream after the positions' work and keep their
    outputs alive for it."""
    if not streams:
        return parts
    for idx, t in parts.items():
        s = mesh.stream(idx)
        if s is not None:
            cur = torch.cuda.current_stream(s.device)
            cur.wait_stream(s)
            t.record_stream(cur)
    return parts


def _ep_shardmap_parts(cfg: ModelConfig, mesh, ins: dict, cap: int,
                       streams: bool = True) -> dict:
    """The shard-map dispatch's body a position: ``ins[idx]`` holds the
    position's ``(x_loc, router, wi_loc, wo_loc)`` (its data shard's
    tokens, the router, its experts' weights), on its device.  Returns
    each position's ``(n_loc, d)`` output, summed over ``"model"``."""
    e_loc = cfg.n_experts // mesh.shape["model"]
    parts = {}
    for idx in mesh.positions():
        m = _coord(mesh, idx, ("model",))
        with _on(mesh, idx, streams) as s:
            _keep(s, ins[idx])
            x_loc = ins[idx][0]
            parts[idx] = (_ep_local_compute(cfg, *ins[idx], e_loc, m, cap)
                          if x_loc.shape[0] else torch.zeros_like(x_loc))
    return _psum(mesh, parts, ("model",), streams)


def _moe_ep_shardmap(cfg: ModelConfig, p: Params, x2: torch.Tensor, mesh,
                     streams: bool = True) -> torch.Tensor:
    """Expert-parallel MoE dispatch, one part a position.

    * tokens stay on their data shard (activations are model-replicated,
      so no token exchange is needed at all);
    * each (data i, model m) position routes shard i's tokens to ITS
      e_loc = E/tp experts, packs them by inverse-map gather into an
      (e_loc, C, d) capacity buffer (never materializing (n·k, d)),
      runs the grouped SwiGLU GEMM, scatter-adds weighted outputs;
    * the combine is one psum over "model".

    Capacity is enforced per (expert × data shard) — the standard EP
    behaviour.  Routing/top-k math is identical to :func:`moe`.
    ``streams=False`` runs the positions one after another on the
    caller's stream."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    tp = mesh.shape["model"]
    e = cfg.n_experts
    if e % tp:
        raise ValueError(f"{e} experts on a {tp}-wide model axis")
    e_loc = e // tp
    n = x2.shape[0]
    dp_size = int(np.prod([mesh.shape[a] for a in dp_axes]))
    n_loc = n // dp_size
    ins = {}
    for idx in mesh.positions():
        i = _coord(mesh, idx, dp_axes)
        m = _coord(mesh, idx, ("model",))
        experts = (slice(m * e_loc, (m + 1) * e_loc),)
        ins[idx] = _locals(mesh.device(idx),
                           (x2, (slice(i * n_loc, (i + 1) * n_loc),)),
                           (p["router"], ()), (p["wi"], experts),
                           (p["wo"], experts))
    y = _join(mesh, _ep_shardmap_parts(cfg, mesh, ins,
                                       _ep_capacity(cfg, n_loc), streams),
              streams)
    rows = {}
    for idx in mesh.positions():            # out_specs P(dp, None)
        rows.setdefault(_coord(mesh, idx, dp_axes), y[idx])
    return torch.cat([rows[i].to(x2.device) for i in range(dp_size)])


def _ep_stationary_parts(cfg: ModelConfig, mesh, ins: dict, n: int,
                         dtype: torch.dtype, streams: bool = True) -> dict:
    """The weights-stationary dispatch's body: ``ins[idx]`` holds the
    position's ``(x_sl, wi_loc, wo_loc, router_sl)`` (every token's
    feature slice of its data coordinate, its experts' weights cut on
    that coordinate, the router's rows), on its device.  Returns each
    position's ``(n, d)`` output, summed over ``("model", "data")``."""
    tp = mesh.shape["model"]
    data_size = mesh.shape.get("data", 1)
    e_loc = cfg.n_experts // tp
    f_loc = cfg.d_expert // data_size
    cap = _ep_capacity(cfg, n)
    pos = mesh.positions()
    coords = {idx: (_coord(mesh, idx, ("model",)),
                    _coord(mesh, idx, ("data",))) for idx in pos}
    part = {}
    for idx in pos:                          # routing from feature slices
        x_sl, _, _, router_sl = ins[idx]
        with _on(mesh, idx, streams) as s:
            _keep(s, ins[idx])
            part[idx] = x_sl.float() @ router_sl
    logits = _psum(mesh, part, ("data",), streams)
    maps = {}
    for idx in pos:                          # d-partial first GEMM
        m, di = coords[idx]
        with _on(mesh, idx, streams):
            w, top = _router_weights(cfg, logits[idx])
            maps[idx] = _ep_dispatch(cfg, w, top, m, e_loc, n, cap)
            part[idx] = einsum("ecd,edf->ecf",
                               _ep_gather(ins[idx][0], maps[idx][0], n),
                               ins[idx][1])
    hgate = _psum(mesh, part, ("data",), streams)
    for idx in pos:                          # f-partial second GEMM
        m, di = coords[idx]
        with _on(mesh, idx, streams):
            hmid = _swiglu(hgate[idx], dtype)
            out = einsum("ecf,efd->ecd",
                         hmid[:, :, di * f_loc:(di + 1) * f_loc], ins[idx][2])
            part[idx] = _ep_combine(out, *maps[idx], n, dtype)
    # NOT over "pod": pod replicas compute identical partials
    return _psum(mesh, part, ("model", "data"), streams)


def _moe_ep_stationary(cfg: ModelConfig, p: Params, x2: torch.Tensor, mesh,
                       streams: bool = True) -> torch.Tensor:
    """Weights-stationary MoE for tiny token counts (decode).

    Weights never move: wi stays sharded on its d (contraction) dim and
    wo on its f dim over "data"; the tiny token batch is feature-sharded
    in, and three small activation psums (router logits and hgate over
    "data", the combined output over ("model", "data")) complete the
    contractions.  Capacity covers the whole global batch.
    ``streams=False`` runs the positions one after another on the
    caller's stream."""
    tp = mesh.shape["model"]
    data_size = mesh.shape.get("data", 1)
    e_loc = cfg.n_experts // tp
    n, d = x2.shape
    d_loc = d // data_size
    f_loc = cfg.d_expert // data_size
    ins = {}
    for idx in mesh.positions():
        m = _coord(mesh, idx, ("model",))
        di = _coord(mesh, idx, ("data",))
        feat = slice(di * d_loc, (di + 1) * d_loc)
        experts = slice(m * e_loc, (m + 1) * e_loc)
        ins[idx] = _locals(mesh.device(idx), (x2, (slice(None), feat)),
                           (p["wi"], (experts, feat)),
                           (p["wo"], (experts, slice(di * f_loc,
                                                     (di + 1) * f_loc))),
                           (p["router"], (feat,)))
    y = _join(mesh, _ep_stationary_parts(cfg, mesh, ins, n, x2.dtype,
                                         streams), streams)
    return y[mesh.positions()[0]].to(x2.device)  # out_specs P(None, None)


def moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE with sort-based capacity dispatch.

    Tokens are sorted by expert (a stable sort, as ``jnp.argsort``) and
    packed into an (E, C + 128, d) buffer; a token past its expert's
    capacity C (from ``n = b·l``, so prefill and decode differ) goes to the
    spill slot ``C + 127`` with weight 0.  The expert SwiGLU runs as a
    batched product and the outputs are added back, weighted by the
    router, with ``index_add_`` (whose order over a token's k experts is
    not fixed on a card).

    Under an active mesh context whose ``"model"`` axis divides the
    experts, the dispatch runs expert-parallel, chosen as the JAX layer
    chooses: :func:`_moe_ep_stationary` for n ≤ 2,048 tokens on a mesh
    with ``"data"`` dividing both ``d_expert`` and ``d_model``, else
    :func:`_moe_ep_shardmap` when the data-parallel size divides n, else
    the single-device path (:func:`_moe_single`).  The EP paths' capacity is per expert
    and data shard (:func:`_ep_capacity`), so they drop other tokens
    than this path does.
    """
    b, l, d = x.shape
    n = b * l
    e = cfg.n_experts
    x2 = x.reshape(n, d)

    mesh = _mesh()
    if mesh is not None and "model" in mesh.axis_names \
            and e % mesh.shape["model"] == 0:
        dp_size = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                               if a in mesh.axis_names]))
        data_size = mesh.shape.get("data", 1)
        stationary_ok = (
            n <= 2048 and "data" in mesh.axis_names
            and cfg.d_expert % data_size == 0
            and cfg.d_model % data_size == 0)
        y2 = None
        if stationary_ok:
            # decode: tokens are tiny — move activations, never weights
            y2 = _moe_ep_stationary(cfg, p, x2, mesh)
        elif n % max(dp_size, 1) == 0:
            y2 = _moe_ep_shardmap(cfg, p, x2, mesh)
        if y2 is not None:
            if cfg.n_shared_experts:
                y2 = y2 + mlp(cfg, p["shared"], x2)
            return y2.reshape(b, l, d)
    return _moe_single(cfg, p, x2).reshape(b, l, d)


def _moe_single(cfg: ModelConfig, p: Params, x2: torch.Tensor) -> torch.Tensor:
    """:func:`moe`'s single-device path on ``(n, d)`` tokens."""
    n, d = x2.shape
    k = cfg.moe_top_k
    e = cfg.n_experts
    logits = x2.float() @ p["router"]
    w, idx = _router_weights(cfg, logits)         # (n, k)

    cap = _moe_capacity(cfg, n)
    cap_pad = cap + 128

    flat_e = idx.reshape(-1)                      # (n*k,)
    flat_w = w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sw = flat_w[order]
    tok = order // k
    pos = torch.arange(n * k, device=x2.device) - torch.searchsorted(
        se, se, side="left")
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap_pad - 1))
    gathered = x2[tok] * keep[:, None].to(x2.dtype)
    buf = torch.zeros((e, cap_pad, d), dtype=x2.dtype, device=x2.device)
    buf.index_put_((se, slot), gathered, accumulate=True)
    hgate = einsum("ecd,edf->ecf", buf, p["wi"])
    g, up = hgate.chunk(2, dim=-1)
    hmid = F.silu(g.float()).to(x2.dtype) * up
    out_buf = einsum("ecf,efd->ecd", hmid, p["wo"])
    vals = out_buf[se, slot] * (sw * keep)[:, None].to(x2.dtype)
    y2 = torch.zeros((n, d), dtype=x2.dtype, device=x2.device)
    y2.index_add_(0, tok, vals.to(x2.dtype))
    if cfg.n_shared_experts:
        y2 = y2 + mlp(cfg, p["shared"], x2)
    return y2


# ----------------------------------------------------------- Mamba2 (SSD)
def init_mamba2(cfg: ModelConfig, gen: torch.Generator, lead=()) -> Params:
    """z and x share one projection, interleaved on a trailing axis of 2;
    B, C and dt are projected apart."""
    dt = pdtype_of(cfg)
    d, di = cfg.d_model, cfg.d_inner
    g, ns, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    return {
        "zx_proj": _dense_init(gen, (d, di, 2), dt, lead=lead),
        "b_proj": _dense_init(gen, (d, g * ns), dt, lead=lead),
        "c_proj": _dense_init(gen, (d, g * ns), dt, lead=lead),
        "dt_proj": _dense_init(gen, (d, h), dt, lead=lead),
        "conv_x": _dense_init(gen, (cfg.ssm_conv, di), dt, scale=0.5,
                              lead=lead),
        "conv_bc": _dense_init(gen, (cfg.ssm_conv, 2 * g * ns), dt,
                               scale=0.5, lead=lead),
        "conv_b_x": _full(gen, (di,), 0.0, dt, lead),
        "conv_b_bc": _full(gen, (2 * g * ns,), 0.0, dt, lead),
        "a_log": _full(gen, (h,), 0.0, f32, lead),
        "d_skip": _full(gen, (h,), 1.0, f32, lead),
        "dt_bias": _full(gen, (h,), 0.0, f32, lead),
        "gate_norm": init_norm(di, dt, gen, lead),
        "out_proj": _dense_init(gen, (di, d), dt, lead=lead),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d, width K.  state: (B, K-1, C) carry."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    out = sum(full[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    new_state = full[:, -(k - 1):, :]
    return F.silu((out + b).float()).to(xbc.dtype), new_state


def ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk: int, init_state=None):
    """Chunked state-space-duality scan (Mamba2 alg. 1).

    xh (B,L,H,P); dt (B,L,H) post-softplus; a_neg (H,) negative decay;
    b_in/c_in (B,L,G,N).  Returns (y (B,L,H,P), final_state (B,H,P,N)).
    Decay math runs in float32, the intra-chunk and state products in the
    input dtype; the chunk-to-chunk carry is a loop over chunks.
    """
    bsz, l, h, p = xh.shape
    g, n = b_in.shape[2], b_in.shape[3]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence {l} is not a multiple of chunk {q}")
    nc = l // q
    rep = h // g
    cdt = xh.dtype
    dev = xh.device

    def r(t):  # (B,L,...) → (B,nc,Q,...)
        return t.reshape((bsz, nc, q) + tuple(t.shape[2:]))

    xc = r(xh)
    dtc = r(dt)
    bc = r(b_in).repeat_interleave(rep, dim=3)          # (B,nc,Q,H,N)
    cc = r(c_in).repeat_interleave(rep, dim=3)
    a = dtc.float() * a_neg[None, None, None, :]        # (B,nc,Q,H) ≤ 0
    cum = torch.cumsum(a, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    ii = torch.arange(q, device=dev)[:, None]
    jj = torch.arange(q, device=dev)[None, :]
    lmask = (ii >= jj)[None, None, :, :, None]
    decay = torch.exp(torch.where(lmask, seg, -torch.inf))
    scores = einsum("bcihn,bcjhn->bcijh", cc, bc) \
        * (decay * dtc[:, :, None, :, :].float()).to(cdt)
    y_intra = einsum("bcijh,bcjhp->bcihp", scores, xc)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    s_chunk = einsum("bcjhn,bcjh,bcjhp->bchpn", bc,
                     (decay_end * dtc.float()).to(cdt), xc)  # (B,nc,H,P,N)
    a_total = torch.exp(cum[:, :, -1, :]).float()         # (B,nc,H)

    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
         if init_state is None else init_state.float())
    s_prev = []
    for c in range(nc):
        s_prev.append(s)
        s = s * a_total[:, c, :, None, None] + s_chunk[:, c].float()
    s_prev = torch.stack(s_prev, dim=1)                  # (B,nc,H,P,N)
    y_inter = einsum("bcihn,bchpn->bcihp",
                     cc * torch.exp(cum)[..., None].to(cdt),
                     s_prev.to(cdt))
    y = (y_intra + y_inter.to(y_intra.dtype)).reshape(bsz, l, h, p)
    return y, s


def mamba2(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
           cache: Params | None = None, cache_pos: int | None = None):
    """Mamba2 block.  cache: {"conv_x": (B,K-1,di), "conv_bc": (B,K-1,2GN),
    "ssd": (B,H,P,N)}, written in place."""
    bsz, l, d = x.shape
    di, g, ns, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_headdim
    zx = einsum("bld,dit->blit", x, p["zx_proj"])
    z, xs_raw = zx[..., 0], zx[..., 1]
    bc_raw = torch.cat([matmul(x, p["b_proj"]), matmul(x, p["c_proj"])],
                       dim=-1)
    dt = matmul(x, p["dt_proj"])
    xs, new_conv_x = _causal_conv(
        xs_raw, p["conv_x"], p["conv_b_x"],
        None if cache is None else cache["conv_x"])
    bc, new_conv_bc = _causal_conv(
        bc_raw, p["conv_bc"], p["conv_b_bc"],
        None if cache is None else cache["conv_bc"])
    b_in, c_in = bc.chunk(2, dim=-1)
    xh = xs.reshape(bsz, l, h, hp)
    b_in = b_in.reshape(bsz, l, g, ns)
    c_in = c_in.reshape(bsz, l, g, ns)
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))      # softplus
    a_neg = -torch.exp(p["a_log"])

    if l == 1 and cache is not None:
        # recurrent decode step
        s = cache["ssd"]
        rep = h // g
        bh = b_in[:, 0].repeat_interleave(rep, dim=1)     # (B,H,N)
        ch = c_in[:, 0].repeat_interleave(rep, dim=1)
        da = torch.exp(dt[:, 0] * a_neg[None, :])          # (B,H)
        s_new = s * da[:, :, None, None] + einsum(
            "bhn,bh,bhp->bhpn", bh, dt[:, 0], xh[:, 0].float())
        y = einsum("bhn,bhpn->bhp", ch, s_new)[:, None]
        s_final = s_new
    else:
        # a prompt longer than a chunk is padded to a multiple of it
        pad = -l % cfg.ssm_chunk if l > cfg.ssm_chunk else 0
        if pad:
            def pd(t):
                return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
            xh, dt, b_in, c_in = pd(xh), pd(dt), pd(b_in), pd(c_in)
        init_state = None if cache is None else cache["ssd"]
        y, s_final = ssd_chunked(xh, dt, a_neg, b_in, c_in,
                                 cfg.ssm_chunk, init_state)
        if pad:
            y = y[:, :l]
    y = y + xh[:, :l].to(y.dtype) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, di).to(x.dtype)
    y = rms_norm_gated(y, z, p["gate_norm"], cfg.norm_eps)
    out = matmul(y, p["out_proj"])
    if cache is not None:
        cache["conv_x"].copy_(new_conv_x)
        cache["conv_bc"].copy_(new_conv_bc)
        cache["ssd"].copy_(s_final)
    return out, cache
