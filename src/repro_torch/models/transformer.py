"""Model assembly for every family in the zoo, on PyTorch tensors.

Counterpart of the serving half of ``src/repro/models/transformer.py``:

    params            = init_model(cfg, generator)
    loss, metrics     = train_loss(cfg, params, batch)
    logits, caches    = forward_logits(cfg, params, batch)
    caches            = init_cache(cfg, batch, max_len)
    logits, caches    = prefill(cfg, params, batch, caches)
    logits, caches    = decode_step(cfg, params, tokens, caches, cache_pos)

The parameter tree is the JAX package's, key for key, with the stacked
leading layer axis; where the JAX model scans over that axis, this one
loops over its views, and the hybrid's ``lax.cond`` is an ``if``.  The
caches are written in place (see :mod:`.layers`), and prefill and
decode return the caches they were given.

Training: ``train_loss`` takes the next-token loss from the final hidden
states through :func:`chunked_ce_from_hidden` (each sequence chunk's
logits recomputed in the backward pass, so peak memory is O(B·chunk·V)
as under the JAX ``@jax.checkpoint`` scan), plus the MTP head where the
config has one.  Where ``cfg.remat`` has the JAX model wrap its scanned
layer body in ``jax.checkpoint``, each layer call of the loop here runs
under a non-reentrant ``torch.utils.checkpoint.checkpoint``, while
autograd records and no cache is given (a cached call, serving, writes
its cache in place and is never recomputed).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..sharding.ctx import _mesh, mesh_context
from . import layers as L
from .config import ModelConfig

Params = dict[str, Any]


# ---------------------------------------------------------------- helpers
def layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s parameters (or cache): views of a stacked tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def n_stacked(tree: Params) -> int:
    """The leading (layer) axis of a stacked tree."""
    leaf = next(iter(tree.values()))
    return n_stacked(leaf) if isinstance(leaf, dict) else leaf.shape[0]


_kept = threading.local()


@contextlib.contextmanager
def kept_for_recompute() -> Iterator[list]:
    """For the length of a ``with``, list the tensor arguments of every
    recomputed call: what a checkpoint keeps for its backward pass
    (autograd's ``saved_tensors_hooks`` do not see them).  The dry run's
    memory estimate reads it."""
    prev = getattr(_kept, "tensors", None)
    _kept.tensors = []
    try:
        yield _kept.tensors
    finally:
        _kept.tensors = prev


def _recomputed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward
    pass (a non-reentrant checkpoint) while autograd records.

    The recompute runs under the mesh context and the positions' streams
    its forward ran under (:func:`_as_recorded`): on a card autograd
    recomputes in a thread of its own, where neither is active, and a
    layer that reads the mesh (the MoE's expert-parallel dispatch) would
    otherwise take another path there than in its forward."""
    if torch.is_grad_enabled():
        kept = getattr(_kept, "tensors", None)
        if kept is not None:
            kept.extend(a for a in (*args, *kwargs.values())
                        if isinstance(a, torch.Tensor))
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_as_recorded(), **kwargs)
    return fn(*args, **kwargs)


def _as_recorded():
    """A checkpoint's ``context_fn``: the forward as it is, the recompute
    under the calling thread's active mesh (:func:`~repro_torch.sharding.
    ctx.mesh_context`) with the mesh's streams pinned as this thread sees
    them now."""
    mesh = _mesh()
    if mesh is None:
        return noop_context_fn
    streams = mesh.current_streams()

    @contextlib.contextmanager
    def recompute():
        with mesh_context(mesh), mesh.pinned_streams(streams):
            yield

    return lambda: (contextlib.nullcontext(), recompute())


def _remat(cfg: ModelConfig, caches, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward pass when
    ``cfg.remat`` holds and there is no cache (the JAX model's
    ``jax.checkpoint`` of its scanned body)."""
    if cfg.remat and caches is None:
        return _recomputed(fn, *args, **kwargs)
    return fn(*args, **kwargs)


def _positions(b: int, l: int, cache_pos: int | None, device):
    """A decode step's position, or 0..l-1 for every row."""
    if cache_pos is not None and l == 1:
        return torch.full((b, 1), cache_pos, dtype=torch.int32,
                          device=device)
    return torch.arange(l, dtype=torch.int32, device=device).expand(b, l)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding for arbitrary positions (b, l): sin on the even
    lanes, cos on the odd ones."""
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, None, :]
    ang = positions.float()[..., None] / (10000 ** (dim / d))
    out = torch.zeros(tuple(positions.shape) + (d,), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(L.dtype_of(cfg))


def _unembed(cfg: ModelConfig, params: Params,
             x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = L.einsum("bld,vd->blv", x, w)
    if cfg.vocab_eff != cfg.vocab:
        pad_mask = torch.arange(cfg.vocab_eff, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad_mask[None, None, :], -1e30)
    return logits


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of each label, in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(cfg: ModelConfig, params: Params, hc: torch.Tensor,
               lc: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """One sequence chunk's masked negative log-likelihood sum."""
    return (_nll(_unembed(cfg, params, hc), lc) * mc).sum()


def chunked_ce_from_hidden(cfg: ModelConfig, params: Params,
                           h: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy without materialising (B, S, V) logits.

    The unembedding product and logsumexp run one sequence chunk of
    ``cfg.ce_chunk`` at a time, each under a non-reentrant checkpoint
    (while autograd records), so the backward pass recomputes a chunk's
    logits instead of keeping them: peak memory O(B·chunk·V).  A
    sequence no longer than a chunk, or not a multiple of it, takes the
    whole logits at once, as in the JAX function.
    """
    b, s, _ = h.shape
    chunk = cfg.ce_chunk
    if not chunk or s % chunk != 0 or s <= chunk:
        return cross_entropy(_unembed(cfg, params, h), labels, mask)
    ms = (torch.ones((b, s), dtype=torch.float32, device=h.device)
          if mask is None else mask.float())
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, chunk):
        mc = ms[:, c:c + chunk]
        tot = tot + _recomputed(_chunk_nll, cfg, params, h[:, c:c + chunk],
                                labels[:, c:c + chunk], mc)
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------- decoder layer(s)
def _init_decoder_layers(cfg: ModelConfig, gen, n: int, ffn: str,
                         d_ff: int, lead=None) -> Params:
    lead = (n,) if lead is None else lead
    dt = L.pdtype_of(cfg)
    p = {"ln1": L.init_norm(cfg.d_model, dt, gen, lead),
         "ln2": L.init_norm(cfg.d_model, dt, gen, lead)}
    p["attn"] = (L.init_mla(cfg, gen, lead) if cfg.mla
                 else L.init_attention(cfg, gen, lead))
    if ffn == "moe":
        p["moe"] = L.init_moe(cfg, gen, lead)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, d_ff=d_ff, gelu=cfg.mlp_gelu,
                              lead=lead)
    return p


def _decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                   positions, cache, cache_pos, ffn: str):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, _ = L.mla_attention(cfg, lp["attn"], h, positions=positions,
                               cache=cache, cache_pos=cache_pos)
    else:
        a, _ = L.attention(cfg, lp["attn"], h, positions=positions,
                           causal=True, cache=cache, cache_pos=cache_pos)
    x = x + a
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    f = L.moe(cfg, lp["moe"], h2) if ffn == "moe" \
        else L.mlp(cfg, lp["mlp"], h2, gelu=cfg.mlp_gelu)
    return x + f


def _run_stack(cfg: ModelConfig, stacked: Params, x: torch.Tensor, *,
               positions, caches, cache_pos, ffn: str) -> torch.Tensor:
    for i in range(n_stacked(stacked)):
        x = _remat(cfg, caches, _decoder_layer, cfg, layer(stacked, i), x,
                   positions=positions,
                   cache=None if caches is None else layer(caches, i),
                   cache_pos=cache_pos, ffn=ffn)
    return x


# ===================================================== dense / moe / vlm
def _init_decoder_lm(cfg: ModelConfig, gen) -> Params:
    dt = L.pdtype_of(cfg)
    p: Params = {
        "embed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                               scale=0.02),
        "final_norm": L.init_norm(cfg.d_model, dt, gen),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                                     scale=0.02)
    n_main = cfg.n_layers - cfg.dense_prefix
    if cfg.dense_prefix:
        p["prefix_layers"] = _init_decoder_layers(
            cfg, gen, cfg.dense_prefix, "mlp", cfg.dense_d_ff or cfg.d_ff)
    ffn = "moe" if cfg.n_experts else "mlp"
    p["layers"] = _init_decoder_layers(cfg, gen, n_main, ffn, cfg.d_ff)
    if cfg.family == "vlm":
        p["patch_proj"] = L._dense_init(gen, (cfg.d_model, cfg.d_model), dt)
    if cfg.mtp:
        p["mtp"] = {
            "proj": L._dense_init(gen, (2 * cfg.d_model, cfg.d_model), dt),
            "norm": L.init_norm(cfg.d_model, dt, gen),
            "layer": _init_decoder_layers(cfg, gen, 1, "mlp",
                                          cfg.dense_d_ff or cfg.d_ff,
                                          lead=()),
            "final_norm": L.init_norm(cfg.d_model, dt, gen),
        }
    return p


def _decoder_lm_apply(cfg: ModelConfig, params: Params,
                      tokens: torch.Tensor, *, patches=None, caches=None,
                      cache_pos=None, return_hidden: bool = False):
    x = _embed(cfg, params, tokens)
    if cfg.family == "vlm" and patches is not None:
        pe = L.matmul(patches.to(x.dtype), params["patch_proj"])
        x = torch.cat([pe, x], dim=1)
    b, l, _ = x.shape
    decoding = cache_pos is not None and tokens.shape[1] == 1
    positions = _positions(b, 1 if decoding else l,
                           cache_pos if decoding else None, x.device)
    if cfg.dense_prefix:
        x = _run_stack(cfg, params["prefix_layers"], x, positions=positions,
                       caches=caches.get("prefix") if caches else None,
                       cache_pos=cache_pos, ffn="mlp")
    ffn = "moe" if cfg.n_experts else "mlp"
    x = _run_stack(cfg, params["layers"], x, positions=positions,
                   caches=caches.get("main") if caches else None,
                   cache_pos=cache_pos, ffn=ffn)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_c = caches if caches else None
    if return_hidden:
        return h, out_c
    return _unembed(cfg, params, h), out_c


# ================================================================ ssm lm
def _init_mamba_layers(cfg: ModelConfig, gen) -> Params:
    lead = (cfg.n_layers,)
    return {"ln": L.init_norm(cfg.d_model, L.pdtype_of(cfg), gen, lead),
            "mamba": L.init_mamba2(cfg, gen, lead)}


def _init_ssm_lm(cfg: ModelConfig, gen) -> Params:
    dt = L.pdtype_of(cfg)
    p: Params = {
        "embed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                               scale=0.02),
        "layers": _init_mamba_layers(cfg, gen),
        "final_norm": L.init_norm(cfg.d_model, dt, gen),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                                     scale=0.02)
    return p


def _ssm_layer(cfg, lp, x, cache, cache_pos):
    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    y, _ = L.mamba2(cfg, lp["mamba"], h, cache=cache, cache_pos=cache_pos)
    return x + y


def _ssm_lm_apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  *, caches=None, cache_pos=None,
                  return_hidden: bool = False):
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        x = _remat(cfg, caches, _ssm_layer, cfg, layer(params["layers"], i),
                   x, None if caches is None else layer(caches["main"], i),
                   cache_pos)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, caches
    return _unembed(cfg, params, h), caches


# ============================================================= hybrid lm
def _n_attn_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


def _init_hybrid_lm(cfg: ModelConfig, gen) -> Params:
    dt = L.pdtype_of(cfg)
    return {
        "embed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                               scale=0.02),
        "layers": _init_mamba_layers(cfg, gen),
        # the shared attention block (Zamba2): one set of weights, invoked
        # every `hybrid_period` layers
        "shared_attn": {"ln": L.init_norm(cfg.d_model, dt, gen),
                        "attn": L.init_attention(cfg, gen),
                        "ln2": L.init_norm(cfg.d_model, dt, gen),
                        "mlp": L.init_mlp(cfg, gen)},
        "final_norm": L.init_norm(cfg.d_model, dt, gen),
        "unembed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                                 scale=0.02),
    }


def _shared_attn_block(cfg, sp, x, positions, cache, cache_pos):
    h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
    a, _ = L.attention(cfg, sp["attn"], h, positions=positions, causal=True,
                       cache=cache, cache_pos=cache_pos)
    x = x + a
    h2 = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp(cfg, sp["mlp"], h2)


def _hybrid_lm_apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     *, caches=None, cache_pos=None,
                     return_hidden: bool = False):
    x = _embed(cfg, params, tokens)
    b, l, _ = x.shape
    positions = _positions(b, l, cache_pos, x.device)
    period = cfg.hybrid_period
    n_inv = _n_attn_invocations(cfg)
    has_cache = caches is not None

    def body(x, idx):
        x = _ssm_layer(cfg, layer(params["layers"], idx), x,
                       layer(caches["main"], idx) if has_cache else None,
                       cache_pos)
        if idx % period == period - 1:
            # the shared block's cache is indexed by invocation
            inv = min(idx // period, n_inv - 1)
            x = _shared_attn_block(
                cfg, params["shared_attn"], x, positions,
                layer(caches["attn"], inv) if has_cache else None, cache_pos)
        return x

    for idx in range(cfg.n_layers):
        x = _remat(cfg, caches, body, x, idx)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, caches
    return _unembed(cfg, params, h), caches


# ================================================================ encdec
def _init_encdec(cfg: ModelConfig, gen) -> Params:
    dt = L.pdtype_of(cfg)
    enc, dec = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                               scale=0.02),
        "enc_layers": {"ln1": L.init_norm(cfg.d_model, dt, gen, enc),
                       "attn": L.init_attention(cfg, gen, enc),
                       "ln2": L.init_norm(cfg.d_model, dt, gen, enc),
                       "mlp": L.init_mlp(cfg, gen, gelu=True, lead=enc)},
        "enc_norm": L.init_norm(cfg.d_model, dt, gen),
        "dec_layers": {"ln1": L.init_norm(cfg.d_model, dt, gen, dec),
                       "self_attn": L.init_attention(cfg, gen, dec),
                       "ln_x": L.init_norm(cfg.d_model, dt, gen, dec),
                       "cross_attn": L.init_attention(cfg, gen, dec,
                                                      cross=True),
                       "ln2": L.init_norm(cfg.d_model, dt, gen, dec),
                       "mlp": L.init_mlp(cfg, gen, gelu=True, lead=dec)},
        "final_norm": L.init_norm(cfg.d_model, dt, gen),
        "unembed": L._dense_init(gen, (cfg.vocab_eff, cfg.d_model), dt,
                                 scale=0.02),
    }


def _encode(cfg: ModelConfig, params: Params,
            frames: torch.Tensor) -> torch.Tensor:
    """Encoder over precomputed frame embeddings (conv frontend stub)."""
    b, t, _ = frames.shape
    positions = _positions(b, t, None, frames.device)
    dt = L.dtype_of(cfg)
    x = frames.to(dt) + _sinusoid(positions, cfg.d_model).to(dt)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.attention(cfg, lp["attn"], h, positions=positions,
                           causal=False)
        x = x + a
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + L.mlp(cfg, lp["mlp"], h2, gelu=True)

    for i in range(cfg.n_enc_layers):
        x = _remat(cfg, None, body, x, layer(params["enc_layers"], i))
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(cfg, lp, x, enc_out, positions, cache, cache_pos):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _ = L.attention(cfg, lp["self_attn"], h, positions=positions,
                       causal=True, cache=cache["self"] if cache else None,
                       cache_pos=cache_pos)
    x = x + a
    hx = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    ca, _ = L.attention(cfg, lp["cross_attn"], hx, positions=positions,
                        causal=False, kv_x=enc_out,
                        cache=cache["cross"] if cache else None,
                        cache_pos=cache_pos)
    x = x + ca
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(cfg, lp["mlp"], h2, gelu=True)


def _encdec_apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  frames=None, enc_out=None, caches=None, cache_pos=None,
                  return_hidden: bool = False):
    if enc_out is None and frames is not None:
        enc_out = _encode(cfg, params, frames)
    b, l = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions(b, l, cache_pos, x.device)
    x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    has_cache = caches is not None
    for i in range(cfg.n_layers):
        x = _remat(cfg, caches, _dec_layer, cfg,
                   layer(params["dec_layers"], i), x, enc_out, positions,
                   layer(caches["dec"], i) if has_cache else None, cache_pos)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_c = {"dec": caches["dec"], "enc_out": enc_out} if has_cache else None
    if return_hidden:
        return h, out_c
    return _unembed(cfg, params, h), out_c


# ============================================================== public API
def init_model(cfg: ModelConfig,
               generator: torch.Generator | None) -> Params:
    """Random parameters with the JAX initialiser's distributions and
    scales, drawn from ``generator`` onto its device (not the JAX draw);
    ``None`` gives the tree's shapes and dtypes as meta tensors."""
    if cfg.family in ("dense", "moe", "vlm"):
        return _init_decoder_lm(cfg, generator)
    if cfg.family == "ssm":
        return _init_ssm_lm(cfg, generator)
    if cfg.family == "hybrid":
        return _init_hybrid_lm(cfg, generator)
    if cfg.family == "encdec":
        return _init_encdec(cfg, generator)
    raise ValueError(cfg.family)


def forward_logits(cfg: ModelConfig, params: Params, batch: dict,
                   caches=None, cache_pos=None, return_hidden: bool = False):
    """Prefill/decode logits (the caches pass through when given)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_lm_apply(cfg, params, batch["tokens"],
                                 patches=batch.get("patches"),
                                 caches=caches, cache_pos=cache_pos,
                                 return_hidden=return_hidden)
    if cfg.family == "ssm":
        return _ssm_lm_apply(cfg, params, batch["tokens"], caches=caches,
                             cache_pos=cache_pos,
                             return_hidden=return_hidden)
    if cfg.family == "hybrid":
        return _hybrid_lm_apply(cfg, params, batch["tokens"], caches=caches,
                                cache_pos=cache_pos,
                                return_hidden=return_hidden)
    if cfg.family == "encdec":
        return _encdec_apply(cfg, params, batch["tokens"],
                             frames=batch.get("frames"),
                             enc_out=(caches or {}).get("enc_out"),
                             caches=caches, cache_pos=cache_pos,
                             return_hidden=return_hidden)
    raise ValueError(cfg.family)


def train_loss(cfg: ModelConfig, params: Params, batch: dict):
    """Next-token loss (+ the MTP auxiliary where configured), from the
    final hidden states through the chunked cross-entropy, so the
    (B, S, vocab) logits are never materialised whole.  Returns
    ``(loss, metrics)`` as 0-d float32 tensors."""
    h, _ = forward_logits(cfg, params, batch, return_hidden=True)
    h_tok = h[:, batch["patches"].shape[1]:, :] if cfg.family == "vlm" \
        else h
    labels = batch["labels"]
    loss = chunked_ce_from_hidden(cfg, params, h_tok, labels,
                                  batch.get("loss_mask"))
    metrics = {"loss": loss}
    if cfg.mtp:
        mp = params["mtp"]
        emb_next = _embed(cfg, params, labels)
        cat = torch.cat([L.rms_norm(h, mp["norm"], cfg.norm_eps), emb_next],
                        dim=-1)
        x2 = L.matmul(cat, mp["proj"])
        b, l, _ = x2.shape
        x2 = _decoder_layer(cfg, mp["layer"], x2,
                            positions=_positions(b, l, None, x2.device),
                            cache=None, cache_pos=None, ffn="mlp")
        h2 = L.rms_norm(x2, mp["final_norm"], cfg.norm_eps)
        # position t predicts token t+2: pair h2[:, t] with labels[:, t+1];
        # pad and mask the last slot so the chunked CE keeps full length
        bsz, s = labels.shape
        labels_mtp = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        mask_mtp = torch.cat(
            [torch.ones((bsz, s - 1), dtype=torch.float32, device=h.device),
             torch.zeros((bsz, 1), dtype=torch.float32, device=h.device)],
            dim=1)
        mtp_loss = chunked_ce_from_hidden(cfg, params, h2, labels_mtp,
                                          mask_mtp)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
        metrics["loss"] = loss
    return loss, metrics


# ------------------------------------------------------------ KV caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int | None = None,
               device="cpu") -> Params:
    """Cache tree matching forward_logits(caches=...); the SSD state is
    float32 whatever ``dtype`` is."""
    kv, dh = cfg.n_kv_eff, cfg.d_head

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(n_layers, length):
        return {"k": zeros(n_layers, batch, length, kv, dh),
                "v": zeros(n_layers, batch, length, kv, dh)}

    def mla_cache(n_layers, length):
        return {"c_kv": zeros(n_layers, batch, length, cfg.kv_lora_rank),
                "k_rope": zeros(n_layers, batch, length, cfg.qk_rope_dim)}

    def ssm_cache(n_layers):
        return {
            "conv_x": zeros(n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner),
            "conv_bc": zeros(n_layers, batch, cfg.ssm_conv - 1,
                             2 * cfg.ssm_groups * cfg.ssm_state),
            "ssd": zeros(n_layers, batch, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state, dt=torch.float32),
        }

    if cfg.family in ("dense", "moe", "vlm"):
        total = max_len + (cfg.frontend_len if cfg.family == "vlm" else 0)
        n_main = cfg.n_layers - cfg.dense_prefix
        per = mla_cache if cfg.mla else attn_cache
        caches: Params = {"main": per(n_main, total)}
        if cfg.dense_prefix:
            caches["prefix"] = per(cfg.dense_prefix, total)
        return caches
    if cfg.family == "ssm":
        return {"main": ssm_cache(cfg.n_layers)}
    if cfg.family == "hybrid":
        return {"main": ssm_cache(cfg.n_layers),
                "attn": attn_cache(_n_attn_invocations(cfg), max_len)}
    if cfg.family == "encdec":
        el = enc_len or cfg.frontend_len
        return {"dec": {"self": attn_cache(cfg.n_layers, max_len),
                        "cross": attn_cache(cfg.n_layers, el)},
                "enc_out": zeros(batch, el, cfg.d_model)}
    raise ValueError(cfg.family)


def prefill(cfg: ModelConfig, params: Params, batch: dict, caches: Params):
    """Process the full prompt, return (last-position logits, caches)."""
    if cfg.family == "encdec":
        caches = dict(caches)
        caches["enc_out"] = _encode(cfg, params, batch["frames"])
    logits, caches = forward_logits(cfg, params, batch, caches=caches,
                                    cache_pos=None)
    return logits[:, -1:, :], caches


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                caches: Params, cache_pos: int):
    """One-token decode with a populated cache at position cache_pos."""
    return forward_logits(cfg, params, {"tokens": tokens}, caches=caches,
                          cache_pos=cache_pos)
