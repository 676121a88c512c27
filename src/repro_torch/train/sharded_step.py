"""The train step's gradients over a mesh of positions.

Counterpart of what ``jax.jit(step, in_shardings=(psh, osh, bsh, repl),
out_shardings=(psh, osh, None))`` makes of ``src/repro/train/
train_step.py`` on a mesh (``src/repro/launch/dryrun.py:90-103``): XLA
partitions the JAX step by the parameters' specs.  The port has no
partitioner, so this module writes the partitioned step out, for every
family (dense, moe, vlm, ssm, hybrid, encdec), and drives every position
from the calling thread, each on a CUDA stream of its own (off the card
one after another), as the expert-parallel MoE does
(:mod:`repro_torch.models.layers`).

Storage follows the specs; compute follows the layer kind:

* each position computes its rows of the batch (``"data"``, and
  ``"pod"`` where the mesh has it; an encoder-decoder's ``frames`` too)
  and its ``"model"`` slice of every layer: the heads of attention and
  MLA (with the KV heads its query heads read; self-, cross- and the
  encoder's non-causal attention alike), ``d_ff`` of the MLP, the
  vocabulary of the embedding and the unembedding, the experts through
  the expert-parallel dispatches, the output columns of ``patch_proj``,
  and Mamba2's SSM heads with the ``d_inner`` channels they own (B and C
  whole at every position); a layer whose dimension does not divide the
  model axis computes whole at every position, unsummed;
* it gathers those slices from the placed leaves by global range
  (:func:`~repro_torch.sharding.placement.read_region`): each block from
  its first holder, whose shard is a leaf of its own for autograd, so
  every use of a block adds to that leaf's gradient, at the block's
  shape: the reduction over ``"data"`` and the reduce-scatter are
  autograd's own sums;
* row-parallel products, the vocab-parallel lookup and the gated norm's
  sum of squares over the split ``d_inner`` end in a sum over
  ``"model"`` (:func:`~repro_torch.models.layers._psum`);
* the losses are global: masked NLL sums over mask counts, summed over
  the data positions; the vocab-parallel log-sum-exp combines the
  positions' maxima and exp-sums, the gold logit comes from the position
  that owns the label, and the padded vocabulary is masked by global
  index.

Microbatches (``cfg.grad_accum``) are the one-device rows ``[i·b/ga,
(i+1)·b/ga)``, split over the data positions as ``torch.tensor_split``
splits them (a share that does not divide leaves some positions fewer
rows, or none).  ``cfg.remat`` recomputes each layer, and each CE chunk,
over all positions, sums included (the hybrid's unit is a Mamba2 layer
with the shared attention block that may follow it, as in the JAX
model); the positions' streams are pinned for the step
(:meth:`~repro_torch.launch.mesh.FilterMesh.pinned_streams`), so a
recompute in autograd's thread runs on the streams its forward ran on.
The products, the convolutions and the SSD scan stay ``torch`` ops: the
JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers as L
from ..models import transformer as T
from ..models.config import ModelConfig
from ..sharding.ctx import mesh_context
from ..sharding.placement import (PlacedTensor, from_blocks, holders,
                                  read_region)
from ..tree import tree_leaves, tree_map, tree_unflatten

class _Positions:
    """One microbatch's forward over the positions of ``mesh``."""

    def __init__(self, cfg: ModelConfig, mesh, live: dict, streams: bool,
                 every: bool = False):
        self.cfg, self.mesh, self.live, self.streams = cfg, mesh, live, streams
        # every data position holds every row, not rows of its own (a
        # context-parallel serving step)
        self.every = every
        self.pos = mesh.positions()
        names = mesh.axis_names
        self.dp = tuple(a for a in ("pod", "data") if a in names)
        self.dp_size = int(np.prod([mesh.shape[a] for a in self.dp]))
        self.tp = mesh.shape.get("model", 1)
        h, kv = cfg.n_heads_eff, cfg.n_kv_eff
        self.heads = None                 # (local q heads, local kv heads)
        if h % self.tp == 0:
            hl, g = h // self.tp, h // kv
            if hl % g == 0:
                self.heads = (hl, hl // g)
            elif g % hl == 0:
                self.heads = (hl, 1)
        self.vocab_split = cfg.vocab_eff % self.tp == 0
        self.ssm = None                   # local Mamba2 heads
        if cfg.ssm_state and cfg.ssm_heads % self.tp == 0:
            hl = cfg.ssm_heads // self.tp
            per = cfg.ssm_heads // cfg.ssm_groups     # heads a group
            if hl % per == 0 or per % hl == 0:        # whole groups
                self.ssm = hl

    # ----------------------------------------------------------- plumbing
    def m(self, idx) -> int:
        return L._coord(self.mesh, idx, ("model",)) \
            if "model" in self.mesh.axis_names else 0

    def d(self, idx) -> int:
        return L._coord(self.mesh, idx, self.dp)

    def dev(self, idx) -> torch.device:
        return self.mesh.device(idx)

    @contextlib.contextmanager
    def on(self, idx, *keep):
        """Run the body on a position's stream, keeping ``keep`` (tensors
        made on the caller's stream) alive for it."""
        with L._on(self.mesh, idx, self.streams) as s:
            L._keep(s, [t for t in keep if isinstance(t, torch.Tensor)])
            yield

    def psum(self, parts: dict, axes=("model",)) -> dict:
        axes = tuple(a for a in axes if a in self.mesh.axis_names)
        return L._psum(self.mesh, parts, axes, self.streams) if axes \
            else parts

    def w(self, leaf: PlacedTensor, idx, *sl) -> torch.Tensor:
        """The global range ``sl`` of a parameter on a position's device,
        from the live leaves (differentiable), or, with no live leaves
        (serving), each block from the position's own shard where it
        holds it."""
        return read_region(leaf, sl, self.dev(idx),
                           None if self.live is None else self.live[id(leaf)],
                           position=idx)

    def whole(self, tree, idx, pre=()):
        """Every leaf of ``tree`` whole (at layer ``pre``) on a position."""
        return tree_map(lambda leaf: self.w(leaf, idx, *pre), tree)

    # ------------------------------------------------------------ layers
    def attn_weights(self, ap: dict, pre: tuple, idx, kv: bool = True):
        """(config, parameters, head mask) of a position's heads of
        attention or MLA at layer ``pre``; ``kv=False`` leaves out the key
        and value projections (a cross-attention decode step reads its
        keys and values from the cache)."""
        cfg = self.cfg
        if self.heads is None:
            return cfg, self.whole({k: v for k, v in ap.items() if kv or k
                                    not in ("wk", "wv", "bk", "bv")}, idx,
                                   pre), None
        hl, kl = self.heads
        m = self.m(idx)
        qs = slice(m * hl, (m + 1) * hl)
        hm = L._head_mask(cfg, self.dev(idx))
        hm = None if hm is None else hm[qs]
        p = {k: self.whole(v, idx, pre) for k, v in ap.items()
             if isinstance(v, dict)}
        if cfg.mla:
            for k in ("w_dq", "w_dkv"):
                p[k] = self.w(ap[k], idx, *pre)
            for k in ("w_uq", "w_uk", "w_uv"):
                p[k] = self.w(ap[k], idx, *pre, slice(None), qs)
            p["wo"] = self.w(ap["wo"], idx, *pre, qs)
            return cfg.with_(n_heads=hl, n_kv_heads=hl, pad_heads_to=0), \
                p, hm
        p["wq"] = self.w(ap["wq"], idx, *pre, slice(None), qs)
        p["wo"] = self.w(ap["wo"], idx, *pre, qs)
        if "bq" in ap:
            p["bq"] = self.w(ap["bq"], idx, *pre, qs)
        if kv:
            p.update(self.kv_weights(ap, pre, idx, *self.kv_read(idx)))
        return cfg.with_(n_heads=hl, n_kv_heads=kl, pad_heads_to=0), p, hm

    def kv_read(self, idx) -> tuple[int, int]:
        """(first, count) of the ``n_kv_eff`` heads a position's query
        heads read."""
        kv = self.cfg.n_kv_eff
        if self.heads is None:
            return 0, kv
        hl, kl = self.heads
        return self.m(idx) * hl // (self.cfg.n_heads_eff // kv), kl

    def kv_weights(self, ap: dict, pre: tuple, idx, lo: int, n: int) -> dict:
        """The key and value projections (and biases) of the ``n_kv_eff``
        heads ``[lo, lo + n)`` at layer ``pre``, stored heads repeated as
        ``layers._project_kv`` repeats them."""
        factor = self.cfg.n_kv_eff // ap["wk"].shape[-2]
        ks = slice(lo // factor, (lo + n - 1) // factor + 1)
        cut = slice(lo - ks.start * factor, lo - ks.start * factor + n)
        p = {k: self.w(ap[k], idx, *pre, slice(None), ks).repeat_interleave(
            factor, dim=1)[:, cut] for k in ("wk", "wv")}
        if "bk" in ap:
            for k in ("bk", "bv"):
                p[k] = self.w(ap[k], idx, *pre, ks).repeat_interleave(
                    factor, dim=0)[cut]
        return p

    def mlp_weights(self, mp: dict, pre: tuple, idx, gelu: bool):
        """(parameters, split) of a position's ``d_ff`` slice of an MLP."""
        f = mp["wo"].shape[-2]
        if f % self.tp:
            return self.whole(mp, idx, pre), False
        fl, m = f // self.tp, self.m(idx)
        fs = slice(m * fl, (m + 1) * fl)
        wi = self.w(mp["wi"], idx, *pre, slice(None), fs)
        if not gelu:                       # gate and up halves
            wi = torch.cat([wi, self.w(mp["wi"], idx, *pre, slice(None),
                                       slice(f + fs.start, f + fs.stop))],
                           dim=-1)
        return {"wi": wi, "wo": self.w(mp["wo"], idx, *pre, fs)}, True

    def add(self, xs: dict, ys: dict) -> dict:
        """The residual ``x + y`` at each position."""
        out = {}
        for idx in self.pos:
            with self.on(idx):
                out[idx] = xs[idx] + ys[idx]
        return out

    def attn_block(self, ap: dict, ln: dict, pre: tuple, xs: dict,
                   positions: dict, causal: bool = True,
                   kv: dict | None = None, cache: dict | None = None,
                   cache_pos: int | None = None,
                   ci: int | None = None) -> dict:
        """``x + attention(rms_norm(x, ln))`` over the positions, MLA where
        the config has it; ``kv`` holds each position's encoder output,
        which cross-attention's keys and values read.  ``cache`` (placed
        ``k``/``v`` or ``c_kv``/``k_rope`` leaves, layer ``ci``, default
        ``pre[0]``) makes it a serving step's attention
        (:meth:`cached_attention`; non-causal: cross-attention)."""
        cfg = self.cfg
        h = self.norm(ln, xs, pre)
        reads = causal or cache is None or cache_pos is None
        aw = {idx: self.attn_weights(ap, pre, idx, kv=reads)
              for idx in self.pos}
        if cache is not None:
            parts = self.cached_attention(
                ap, pre, h, aw, positions, cache, cache_pos,
                pre[0] if ci is None else ci, kv=kv, cross=not causal)
            return self.add(xs, self.psum(parts) if self.heads is not None
                            else parts)
        parts = {}
        for idx in self.pos:
            acfg, p, hm = aw[idx]
            with self.on(idx, *tree_leaves(p), hm):
                if cfg.mla:
                    parts[idx], _ = L.mla_attention(
                        acfg, p, h[idx], positions=positions[idx],
                        head_mask=hm)
                else:
                    parts[idx], _ = L.attention(
                        acfg, p, h[idx], positions=positions[idx],
                        causal=causal, head_mask=hm,
                        kv_x=None if kv is None else kv[idx])
        return self.add(xs, self.psum(parts) if self.heads is not None
                        else parts)

    def cached_attention(self, ap: dict, pre: tuple, h: dict, aw: dict,
                         positions: dict, cache: dict,
                         cache_pos: int | None, ci: int,
                         kv: dict | None = None,
                         cross: bool = False) -> dict:
        """Each position's partial of a serving step's attention with the
        weights at ``pre`` and the cache at layer ``ci``
        (``layers.attention`` and ``mla_attention`` with a cache).

        First every position computes the new entries of the cache block
        it holds (its rows, or every row where the data positions do not
        split them; the KV heads of its block, or MLA's whole latent, cut
        to its block) and writes the part that falls in its block into its
        own shard: self-attention at ``cache_pos`` (a prefill: at 0), a
        prefill's cross-attention the encoder output's keys and values
        (``kv``).  A cross-attention decode step writes nothing.  Then
        each reads the region its query heads attend to, blocks it does
        not hold from their holders, and attends with its heads.  A
        cache split over time (the context-parallel layout) is attended
        block by block: each data position over its own time block, the
        blocks' maxima, exp-sums and weighted values combined over
        ``"data"`` (:meth:`attend_blocks`), MLA's latents as ``k``/``v``.
        A prefill's cross-attention attends with the fresh float keys and
        values, as the one-device layer does."""
        cfg = self.cfg
        l = h[self.pos[0]].shape[1]
        off = cache_pos if l == 1 and cache_pos is not None else 0
        limit = None if cross else (
            (cache_pos + l) if cache_pos is not None else l)
        names = ("c_kv", "k_rope") if cfg.mla else ("k", "v")
        leaves = [cache[k] for k in names]
        split = leaves[0].sharding.parts(leaves[0].ndim)[2] > 1
        q, rows, fresh, written = {}, {}, {}, set()
        writes = not cross or cache_pos is None
        for idx in self.pos:
            acfg, p, hm = aw[idx]
            own = [x.sharding.slices(x.shape, idx) for x in leaves]
            rows[idx] = own[0][1]
            if own[0][1].stop - own[0][1].start != h[idx].shape[0]:
                raise ValueError(f"position {idx}: {h[idx].shape[0]} rows, "
                                 f"its cache block {own[0][1]}")
            src = h[idx] if kv is None else kv[idx]
            if not cfg.mla and writes:
                kl = own[0][3]
                n = kl.stop - kl.start
                kw = ({k: p[k] for k in ("wk", "wv", "bk", "bv") if k in p}
                      if (kl.start, n) == self.kv_read(idx)
                      else self.kv_weights(ap, pre, idx, kl.start, n))
                kw.update({k: v for k, v in p.items() if k == "k_norm"})
                kcfg = cfg.with_(n_heads=n, n_kv_heads=n, pad_heads_to=0)
            rope = cfg.rope and not cross
            with self.on(idx, *tree_leaves(p), hm, src):
                if cfg.mla:
                    q[idx] = L.mla_q(acfg, p, h[idx], positions[idx])
                    new = L.mla_latent(acfg, p, h[idx], positions[idx])
                    new = [t[..., o[3]] for t, o in zip(new, own)]
                else:
                    q[idx] = L.attn_q(acfg, p, h[idx], positions[idx], rope)
                    if writes:
                        new = L.attn_kv(kcfg, kw, src, positions[idx], rope)
                    if cross and writes:
                        fresh[idx] = (new if (kl.start, n) == self.kv_read(
                            idx) else L.attn_kv(acfg, p, src, positions[idx],
                                                False))
                if writes:
                    for x, t, o in zip(leaves, new, own):
                        _write_own(x, idx, (ci, o[1], slice(off, None), o[3]),
                                   t, written)
        L._join(self.mesh, {idx: x.shards[idx] for idx in self.pos
                            for x in leaves}, self.streams)
        if split:
            return self.attend_blocks(aw, q, rows, positions, leaves, ci,
                                      limit, cross)
        parts = {}
        for idx in self.pos:
            acfg, p, hm = aw[idx]
            if idx in fresh:
                k, v = fresh[idx]
                with self.on(idx, k, v):
                    parts[idx] = L.attend(acfg, p, q[idx], k, v,
                                          positions=positions[idx],
                                          causal=False, is_cross=True,
                                          head_mask=hm)
                continue
            region = (ci, rows[idx], slice(None))
            if not cfg.mla:
                lo, n = self.kv_read(idx)
                region = region + (slice(lo, lo + n),)
            kvs = [read_region(x, region, self.dev(idx), position=idx)
                   for x in leaves]
            with self.on(idx, *kvs):
                if cfg.mla:
                    parts[idx] = L.mla_attend(
                        acfg, p, *q[idx], *kvs, positions=positions[idx],
                        limit=limit, absorbed=l == 1, head_mask=hm)
                else:
                    parts[idx] = L.attend(
                        acfg, p, q[idx], *kvs, positions=positions[idx],
                        causal=not cross, is_cross=cross, limit=limit,
                        head_mask=hm)
        return parts

    def attend_blocks(self, aw: dict, q: dict, rows: dict, positions: dict,
                      leaves: list, ci: int, limit: int | None,
                      cross: bool) -> dict:
        """Attention on a cache split over time over ``"data"``: each
        position attends its queries to its own time block (its query
        heads' KV heads, or MLA's whole latent, blocks it does not hold
        from their holders), keeps the block's maxima, exp-sums and
        unnormalised weighted values (:func:`_attend_part`,
        :func:`_mla_part`), and the blocks combine over ``"data"``: a
        ``pmax`` of the maxima, then sums of the exp-sums and of the
        weighted values, each rescaled by ``exp(m - max)`` (a block with
        no valid key: ``-1e30`` against the maximum, so 0).  Then MLA's
        decode form applies ``w_uv``, and the head mask and ``wo``
        follow."""
        mla = self.cfg.mla
        parts = {}
        for idx in self.pos:
            acfg, p, hm = aw[idx]
            own = leaves[0].sharding.slices(leaves[0].shape, idx)[2]
            region = (ci, rows[idx], own)
            if not mla:
                lo, n = self.kv_read(idx)
                region = region + (slice(lo, lo + n),)
            kvs = [read_region(x, region, self.dev(idx), position=idx)
                   for x in leaves]
            with self.on(idx, *kvs, *tree_leaves(p)):
                parts[idx] = (_mla_part(acfg, p, *q[idx], *kvs,
                                        positions[idx], own.start, limit)
                              if mla else
                              _attend_part(acfg, q[idx], *kvs,
                                           positions[idx], own.start, limit,
                                           cross))
        mx = L._pmax(self.mesh, {i: t[0] for i, t in parts.items()},
                     ("data",), self.streams)
        se, wv = {}, {}
        for idx in self.pos:
            with self.on(idx):
                f = torch.exp(parts[idx][0] - mx[idx])      # (b, kv, l, g)
                se[idx] = parts[idx][1] * f
                wv[idx] = parts[idx][2] * f.permute(0, 2, 1, 3)[..., None]
        se = L._psum(self.mesh, se, ("data",), self.streams)
        wv = L._psum(self.mesh, wv, ("data",), self.streams)
        out = {}
        for idx in self.pos:
            acfg, p, hm = aw[idx]
            with self.on(idx, *tree_leaves(p), hm):
                b, l, kvh, g, dh = wv[idx].shape
                ctx = (wv[idx] / se[idx].permute(0, 2, 1, 3)[..., None]).to(
                    leaves[0 if mla else 1].dtype).reshape(b, l, kvh * g, dh)
                if mla and l == 1:
                    ctx = L.einsum("blhr,rhv->blhv", ctx, p["w_uv"])
                hm = L._head_mask(acfg, ctx.device) if hm is None else hm
                if hm is not None:
                    ctx = ctx * hm[None, None, :, None].to(ctx.dtype)
                out[idx] = L.einsum("blhk,hkd->bld", ctx, p["wo"])
        return out

    def ffn_block(self, fp: dict, ln: dict, pre: tuple, xs: dict, ffn: str,
                  gelu: bool = False) -> dict:
        """``x + f(rms_norm(x, ln))``, ``f`` the ``"moe"`` or the
        ``"mlp"`` (GELU or SwiGLU) over the positions."""
        h = self.norm(ln, xs, pre)
        return self.add(xs, self.moe(fp, pre, h) if ffn == "moe"
                        else self.mlp(fp, pre, h, gelu=gelu))

    def layer(self, lp: dict, i, xs: dict, positions: dict,
              ffn: str, cache: dict | None = None,
              cache_pos: int | None = None) -> dict:
        """One decoder layer (``_decoder_layer``) over the positions;
        ``i`` indexes a stacked layer tree (``None``: unstacked), and the
        placed ``cache`` tree's layers where one is given."""
        pre = () if i is None else (i,)
        xs = self.attn_block(lp["attn"], lp["ln1"], pre, xs, positions,
                             cache=cache, cache_pos=cache_pos)
        return self.ffn_block(lp[ffn], lp["ln2"], pre, xs, ffn,
                              gelu=self.cfg.mlp_gelu)

    def mlp(self, mp: dict, pre: tuple, hs: dict, gelu: bool = False) -> dict:
        ws = {idx: self.mlp_weights(mp, pre, idx, gelu) for idx in self.pos}
        parts = {}
        for idx in self.pos:
            with self.on(idx, *ws[idx][0].values()):
                parts[idx] = L.mlp(self.cfg, ws[idx][0], hs[idx], gelu=gelu)
        return self.psum(parts) if ws[self.pos[0]][1] else parts

    def moe(self, mp: dict, pre: tuple, hs: dict) -> dict:
        """``layers.moe`` over the positions: the branch the JAX layer
        takes at the microbatch's token count.  The shard-map dispatch
        takes each data position's own rows (or, where they do not split
        the tokens evenly, the even token share the JAX dispatch takes);
        the weights-stationary dispatch, and the single-device path where
        neither applies, take every row gathered.  Where every data
        position holds every row (``every``), the rows count once, the
        shard-map dispatch takes the position's even share of them and
        gathers the outputs, and the other branches gather nothing."""
        cfg, mesh = self.cfg, self.mesh
        first = self.pos[0]
        bl, d = hs[first].shape[1], hs[first].shape[2]
        if self.every:
            rows = dict.fromkeys(range(self.dp_size), hs[first].shape[0])
            start = dict.fromkeys(rows, 0)
            n = rows[0] * bl
        else:
            ran = {self.d(idx): hs[idx].shape[0] for idx in self.pos}
            # a data position the mesh does not run
            # (FilterMesh.first_position) has the first's rows: a meta
            # mesh is symmetric
            rows = {k: ran.get(k, ran[self.d(first)])
                    for k in range(self.dp_size)}
            n = sum(rows.values()) * bl
            start = {k: sum(rows[j] for j in range(k)) * bl for k in rows}
        own = {idx: hs[idx].reshape(-1, d) for idx in self.pos}
        names = mesh.axis_names
        data_size = mesh.shape.get("data", 1)
        branch = "single"
        if "model" in names and cfg.n_experts % self.tp == 0:
            if (n <= 2048 and "data" in names
                    and cfg.d_expert % data_size == 0
                    and cfg.d_model % data_size == 0):
                branch = "stationary"
            elif n % self.dp_size == 0:
                branch = "shardmap"
        if branch == "shardmap":
            # the JAX dispatch splits the tokens evenly over the data
            # shards; rows that do not divide are regathered to match
            n_loc = n // self.dp_size
            even = all(r * bl == n_loc for r in rows.values())
            every = own if self.every or even else L._all_gather(
                mesh, own, self.dp, 0, self.streams)
            e_loc = cfg.n_experts // self.tp
            ins = {}
            for idx in self.pos:
                ex = slice(self.m(idx) * e_loc, (self.m(idx) + 1) * e_loc)
                k = self.d(idx)
                ins[idx] = (own[idx] if even
                            else every[idx][k * n_loc:(k + 1) * n_loc],
                            self.w(mp["router"], idx, *pre),
                            self.w(mp["wi"], idx, *pre, ex),
                            self.w(mp["wo"], idx, *pre, ex))
            y = L._ep_shardmap_parts(cfg, mesh, ins,
                                     L._ep_capacity(cfg, n_loc),
                                     self.streams)
            if not even:
                full = L._all_gather(mesh, y, self.dp, 0, self.streams)
                y = {}
                for idx in self.pos:
                    with self.on(idx):
                        k = self.d(idx)
                        y[idx] = full[idx][start[k]:start[k] + rows[k] * bl]
        else:
            every = own if self.every else L._all_gather(
                mesh, own, self.dp, 0, self.streams)
            if branch == "stationary":
                e_loc = cfg.n_experts // self.tp
                d_loc = d // data_size
                f_loc = cfg.d_expert // data_size
                ins = {}
                for idx in self.pos:
                    di = L._coord(mesh, idx, ("data",))
                    ex = slice(self.m(idx) * e_loc, (self.m(idx) + 1) * e_loc)
                    feat = slice(di * d_loc, (di + 1) * d_loc)
                    ins[idx] = (every[idx][:, feat],
                                self.w(mp["wi"], idx, *pre, ex, feat),
                                self.w(mp["wo"], idx, *pre, ex,
                                       slice(di * f_loc, (di + 1) * f_loc)),
                                self.w(mp["router"], idx, *pre, feat))
                full = L._ep_stationary_parts(cfg, mesh, ins, n,
                                              every[first].dtype,
                                              self.streams)
            else:
                ps = {idx: self.whole(mp, idx, pre) for idx in self.pos}
                full = {}
                for idx in self.pos:
                    with self.on(idx, *tree_leaves(ps[idx])):
                        full[idx] = L._moe_single(cfg, ps[idx], every[idx])
            y = {}
            for idx in self.pos:
                with self.on(idx):
                    k = self.d(idx)
                    y[idx] = full[idx][start[k]:start[k] + rows[k] * bl]
        if cfg.n_shared_experts and branch != "single":
            shared = self.mlp(mp["shared"], pre, own)
            for idx in self.pos:
                with self.on(idx):
                    y[idx] = y[idx] + shared[idx]
        return {idx: y[idx].reshape(hs[idx].shape) for idx in self.pos}

    def mamba(self, mp: dict, pre: tuple, hs: dict, cache: dict | None = None,
              ci: int | None = None) -> dict:
        """``layers.mamba2`` over the positions: each its SSM heads, with
        the ``d_inner`` channels, convolution taps and per-head scalars
        they own, and B and C whole; the gated norm's sum of squares and
        the row-parallel ``out_proj`` summed over ``"model"``.  Heads that
        do not split into whole groups over the model axis compute whole
        at every position.

        ``cache`` (the placed ``conv_x``, ``conv_bc`` and ``ssd`` leaves,
        layer ``ci``) makes it a serving step's: each position reads the
        states its heads need (its rows; ``ssd`` and ``conv_x`` of its
        heads, ``conv_bc`` whole, blocks it does not hold from their
        holders), and once every position has read, writes into its own
        shard the part of the new states that falls in its block."""
        cfg = self.cfg
        states = {}
        if cache is not None:
            for idx in self.pos:
                rows = cache["ssd"].sharding.slices(cache["ssd"].shape,
                                                    idx)[1]
                if rows.stop - rows.start != hs[idx].shape[0]:
                    raise ValueError(f"position {idx}: {hs[idx].shape[0]} "
                                     f"rows, its cache block {rows}")
                heads, chans = self.ssm_range(idx)
                states[idx] = {"ssd": (ci, rows, heads),
                               "conv_x": (ci, rows, slice(None), chans),
                               "conv_bc": (ci, rows)}
        st = {idx: {k: read_region(cache[k], r, self.dev(idx), position=idx)
                    for k, r in states[idx].items()} for idx in states}
        if self.ssm is None:
            ps = {idx: self.whole(mp, idx, pre) for idx in self.pos}
            out, new = {}, {}
            for idx in self.pos:
                with self.on(idx, *tree_leaves(ps[idx]),
                             *tree_leaves(st.get(idx, {}))):
                    y, z, new[idx] = L._mamba2_mix(cfg, ps[idx], hs[idx],
                                                   cache=st.get(idx))
                    y = L.rms_norm_gated(y, z, ps[idx]["gate_norm"],
                                         cfg.norm_eps)
                    out[idx] = L.matmul(y, ps[idx]["out_proj"])
            if cache is not None:
                self.write_states(cache, states, new)
            return out
        per = cfg.ssm_heads // cfg.ssm_groups
        ws, groups = {}, {}
        for idx in self.pos:
            heads, chans = self.ssm_range(idx)
            w = {k: self.w(mp[k], idx, *pre)
                 for k in ("b_proj", "c_proj", "conv_bc", "conv_b_bc")}
            for k in ("zx_proj", "conv_x", "dt_proj"):
                w[k] = self.w(mp[k], idx, *pre, slice(None),
                              heads if k == "dt_proj" else chans)
            for k in ("a_log", "d_skip", "dt_bias"):
                w[k] = self.w(mp[k], idx, *pre, heads)
            for k, leaf in (("conv_b_x", mp["conv_b_x"]),
                            ("scale", mp["gate_norm"]["scale"]),
                            ("out_proj", mp["out_proj"])):
                w[k] = self.w(leaf, idx, *pre, chans)
            ws[idx] = w
            groups[idx] = slice(heads.start // per,
                                (heads.stop - 1) // per + 1)
        gated, ss, new = {}, {}, {}
        for idx in self.pos:
            with self.on(idx, *ws[idx].values(),
                         *tree_leaves(st.get(idx, {}))):
                y, z, new[idx] = L._mamba2_mix(cfg, ws[idx], hs[idx],
                                               cache=st.get(idx),
                                               groups=groups[idx])
                gated[idx] = (y * F.silu(z.float()).to(y.dtype)).float()
                ss[idx] = (gated[idx] * gated[idx]).sum(-1, keepdim=True)
        if cache is not None:
            self.write_states(cache, states, new)
        ss = self.psum(ss)
        parts = {}
        for idx in self.pos:
            with self.on(idx):
                y = gated[idx] * torch.rsqrt(ss[idx] / cfg.d_inner
                                             + cfg.norm_eps)
                y = (y * ws[idx]["scale"].float()).to(hs[idx].dtype)
                parts[idx] = L.matmul(y, ws[idx]["out_proj"])
        return self.psum(parts)

    def ssm_range(self, idx) -> tuple[slice, slice]:
        """(SSM heads, ``d_inner`` channels) a position's mixer computes."""
        cfg = self.cfg
        if self.ssm is None:
            return slice(0, cfg.ssm_heads), slice(0, cfg.d_inner)
        m = self.m(idx)
        heads = slice(m * self.ssm, (m + 1) * self.ssm)
        return heads, slice(heads.start * cfg.ssm_headdim,
                            heads.stop * cfg.ssm_headdim)

    def write_states(self, cache: dict, regions: dict, new: dict) -> None:
        """After every position's mixer has read its states, each writes
        the part of its new ``conv_x``, ``conv_bc`` and ``ssd`` (computed
        over ``regions[idx]``) that falls in its own blocks."""
        L._join(self.mesh, {idx: t for idx in self.pos for t in new[idx]},
                self.streams)
        written: set = set()
        for idx in self.pos:
            with self.on(idx, *new[idx]):
                for k, t in zip(("conv_x", "conv_bc", "ssd"), new[idx]):
                    _write_own(cache[k], idx, regions[idx][k], t, written)

    # ------------------------------------------------- vocabulary, losses
    def vocab_slice(self, idx) -> slice:
        v = self.cfg.vocab_eff
        if not self.vocab_split:
            return slice(0, v)
        vl = v // self.tp
        return slice(self.m(idx) * vl, (self.m(idx) + 1) * vl)

    def embed(self, table: PlacedTensor, toks: dict) -> dict:
        """``_embed``: each position looks up the tokens its vocabulary
        slice holds, summed over ``"model"``."""
        parts = {}
        ws = {idx: self.w(table, idx, self.vocab_slice(idx))
              for idx in self.pos}
        for idx in self.pos:
            with self.on(idx, ws[idx], toks[idx]):
                vs = self.vocab_slice(idx)
                loc = toks[idx].long() - vs.start
                inr = (loc >= 0) & (loc < vs.stop - vs.start)
                e = ws[idx][loc.clamp(0, vs.stop - vs.start - 1)]
                parts[idx] = e * inr[..., None].to(e.dtype)
        x = self.psum(parts) if self.vocab_split else parts
        dt = L.dtype_of(self.cfg)
        out = {}
        for idx in self.pos:
            with self.on(idx):
                out[idx] = x[idx].to(dt)
        return out

    def ce_chunk(self, ws: dict, hs: dict, ls: dict, ms: dict) -> dict:
        """A chunk's masked NLL sum at each position (equal along
        ``"model"``), the vocabulary split: ``_chunk_nll`` over the
        positions."""
        cfg = self.cfg
        lg, mx = {}, {}
        for idx in self.pos:
            with self.on(idx):
                vs = self.vocab_slice(idx)
                logits = L.einsum("bld,vd->blv", hs[idx], ws[idx])
                if cfg.vocab_eff != cfg.vocab:
                    pad = torch.arange(vs.start, vs.stop,
                                       device=logits.device) >= cfg.vocab
                    logits = logits.masked_fill(pad[None, None, :], -1e30)
                lg[idx] = logits.float()
                mx[idx] = lg[idx].detach().amax(dim=-1)
        if self.vocab_split:
            axes = tuple(a for a in ("model",) if a in self.mesh.axis_names)
            if axes:
                mx = L._pmax(self.mesh, mx, axes, self.streams)
        se, gold = {}, {}
        for idx in self.pos:
            with self.on(idx):
                vs = self.vocab_slice(idx)
                se[idx] = torch.exp(lg[idx] - mx[idx][..., None]).sum(-1)
                loc = ls[idx].long() - vs.start
                inr = (loc >= 0) & (loc < vs.stop - vs.start)
                g = torch.take_along_dim(
                    lg[idx], loc.clamp(0, vs.stop - vs.start - 1)[..., None],
                    dim=-1)[..., 0]
                gold[idx] = g * inr
        if self.vocab_split:
            se, gold = self.psum(se), self.psum(gold)
        out = {}
        for idx in self.pos:
            with self.on(idx):
                nll = mx[idx] + torch.log(se[idx]) - gold[idx]
                out[idx] = (nll * ms[idx]).sum()
        return out

    def ce(self, table: PlacedTensor, hs: dict, labels: dict,
           masks: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``chunked_ce_from_hidden`` over the positions: (the sum of every
        data position's masked NLL, the sum of its mask), on the first
        position's device."""
        cfg = self.cfg
        ws = {idx: self.w(table, idx, self.vocab_slice(idx))
              for idx in self.pos}
        s = hs[self.pos[0]].shape[1]
        chunk = cfg.ce_chunk
        spans = ([(c, c + chunk) for c in range(0, s, chunk)]
                 if chunk and s % chunk == 0 and s > chunk else [(0, s)])
        tot: dict = {}
        cnt: dict = {}
        for idx in self.pos:
            with self.on(idx):
                cnt[idx] = masks[idx].sum()
        for a, b in spans:
            cut = [{idx: t[idx][:, a:b] for idx in self.pos}
                   for t in (hs, labels, masks)]
            part = (T._recomputed(self.ce_chunk, ws, *cut) if len(spans) > 1
                    else self.ce_chunk(ws, *cut))
            for idx in self.pos:
                with self.on(idx):
                    tot[idx] = part[idx] if idx not in tot \
                        else tot[idx] + part[idx]
        return self.data_sum(tot), self.data_sum(cnt)

    def data_sum(self, parts: dict) -> torch.Tensor:
        """The sum over the data positions of a value equal along
        ``"model"`` (model coordinate 0's), on the first position's
        device, ordered after the positions' streams."""
        parts = L._join(self.mesh, {idx: v for idx, v in parts.items()
                                    if self.m(idx) == 0}, self.streams)
        dev = self.dev(self.pos[0])
        return sum(v.to(dev) for v in parts.values())

    # ------------------------------------------------------------- model
    def loss(self, params: dict, batch: dict) -> tuple:
        """``train_loss`` of one microbatch: ``batch[idx]`` holds a
        position's rows."""
        cfg = self.cfg
        xs = self.embed(params["embed"], {i: b["tokens"]
                                          for i, b in batch.items()})
        if cfg.family == "vlm" and "patches" in batch[self.pos[0]]:
            xs = self.patches(params["patch_proj"], batch, xs)
        positions = {}
        for idx in self.pos:
            with self.on(idx):
                b, l, _ = xs[idx].shape
                positions[idx] = T._positions(b, l, None, xs[idx].device)
        if cfg.family in ("ssm", "hybrid"):
            xs = self.mamba_stack(params, xs, positions)
        elif cfg.family == "encdec":
            xs = self.encdec(params, batch, xs, positions)
        else:
            if cfg.dense_prefix:
                xs = self.stack(params["prefix_layers"], xs, positions, "mlp")
            xs = self.stack(params["layers"], xs, positions,
                            "moe" if cfg.n_experts else "mlp")
        h = self.norm(params["final_norm"], xs)
        n_p = batch[self.pos[0]]["patches"].shape[1] \
            if cfg.family == "vlm" else 0
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        labels = {i: b["labels"] for i, b in batch.items()}
        masks = {}
        for idx in self.pos:
            with self.on(idx):
                lb = labels[idx]
                masks[idx] = (batch[idx]["loss_mask"].float()
                              if "loss_mask" in batch[idx] else torch.ones(
                                  lb.shape, dtype=torch.float32,
                                  device=lb.device))
        tot, cnt = self.ce(table, {i: x[:, n_p:, :] for i, x in h.items()},
                           labels, masks)
        loss = tot / torch.clamp(cnt, min=1.0)
        metrics = {"loss": loss}
        if cfg.mtp:
            mtp_loss = self.mtp(params, table, h, labels, positions)
            metrics["mtp_loss"] = mtp_loss
            loss = loss + 0.3 * mtp_loss
            metrics["loss"] = loss
        return loss, metrics

    def remat(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass where
        ``cfg.remat`` holds (the JAX model's ``jax.checkpoint``)."""
        return T._recomputed(fn, *args) if self.cfg.remat else fn(*args)

    def stack(self, tree: dict, xs: dict, positions: dict, ffn: str,
              caches: dict | None = None,
              cache_pos: int | None = None) -> dict:
        """A stacked tree of decoder layers (``_run_stack``), over the
        placed ``caches`` where given (serving: no recompute)."""
        for i in range(T.n_stacked(tree)):
            if caches is not None:
                xs = self.layer(tree, i, xs, positions, ffn, caches,
                                cache_pos)
            else:
                xs = self.remat(self.layer, tree, i, xs, positions, ffn)
        return xs

    def mamba_stack(self, params: dict, xs: dict, positions: dict,
                    caches: dict | None = None,
                    cache_pos: int | None = None) -> dict:
        """The Mamba2 layers of ``_ssm_lm_apply`` and ``_hybrid_lm_apply``:
        ``x + mamba(rms_norm(x, ln))``, and in the hybrid the shared
        attention block (one set of weights, unstacked) after every
        ``hybrid_period``-th layer, in the same recompute unit.  With the
        placed ``caches`` (serving: no recompute), layer ``i``'s Mamba2
        states are ``caches["main"]``'s layer ``i``, and the shared
        block's keys and values ``caches["attn"]``'s invocation
        ``i // hybrid_period``."""
        cfg = self.cfg
        lp = params["layers"]
        period = cfg.hybrid_period if cfg.family == "hybrid" else 0
        main = None if caches is None else caches["main"]

        def body(xs, i):
            h = self.norm(lp["ln"], xs, (i,))
            xs = self.add(xs, self.mamba(lp["mamba"], (i,), h, main, i))
            if period and i % period == period - 1:
                sp = params["shared_attn"]
                xs = self.attn_block(
                    sp["attn"], sp["ln"], (), xs, positions,
                    cache=None if caches is None else caches["attn"],
                    cache_pos=cache_pos,
                    ci=min(i // period, cfg.n_layers // period - 1))
                xs = self.ffn_block(sp["mlp"], sp["ln2"], (), xs, "mlp")
            return xs

        for i in range(cfg.n_layers):
            xs = body(xs, i) if caches is not None else self.remat(body, xs,
                                                                   i)
        return xs

    def encdec(self, params: dict, batch: dict, xs: dict, positions: dict,
               caches: dict | None = None,
               cache_pos: int | None = None) -> dict:
        """``_encdec_apply`` from the embedded tokens: the encoder over
        each position's rows of ``frames`` (``_encode``: non-causal
        attention, a GELU MLP, ``enc_norm``), whose output is whole along
        ``"model"`` after its sums; then the decoder layers
        (``_dec_layer``: causal self-attention, cross-attention on the
        encoder output, a GELU MLP) over the sinusoid-embedded tokens.

        With the placed ``caches`` (serving), a prefill writes each
        position's rows of the encoder output into ``enc_out`` and the
        cross-attention's keys and values into ``dec/cross``; a decode
        step runs no encoder and reads the cross cache."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        ep, dp = params["enc_layers"], params["dec_layers"]
        ys = {}
        for idx in self.pos:
            with self.on(idx):
                ys[idx] = xs[idx] + T._sinusoid(
                    positions[idx], cfg.d_model).to(xs[idx].dtype)
        enc = None
        if caches is None or cache_pos is None:
            x, epos = {}, {}
            for idx in self.pos:
                fr = batch[idx]["frames"]
                with self.on(idx, fr):
                    b, t, _ = fr.shape
                    epos[idx] = T._positions(b, t, None, fr.device)
                    x[idx] = fr.to(dt) + T._sinusoid(epos[idx],
                                                     cfg.d_model).to(dt)

            def enc_layer(x, i):
                x = self.attn_block(ep["attn"], ep["ln1"], (i,), x, epos,
                                    causal=False)
                return self.ffn_block(ep["mlp"], ep["ln2"], (i,), x, "mlp",
                                      gelu=True)

            for i in range(cfg.n_enc_layers):
                x = enc_layer(x, i) if caches is not None \
                    else self.remat(enc_layer, x, i)
            enc = self.norm(params["enc_norm"], x)
            if caches is not None:
                out = caches["enc_out"]
                written: set = set()
                for idx in self.pos:
                    rows = out.sharding.slices(out.shape, idx)[0]
                    with self.on(idx, enc[idx]):
                        _write_own(out, idx, (rows,), enc[idx], written)
        dc = None if caches is None else caches["dec"]

        def dec_layer(xs, i, enc):
            xs = self.attn_block(dp["self_attn"], dp["ln1"], (i,), xs,
                                 positions, cache=dc and dc["self"],
                                 cache_pos=cache_pos)
            xs = self.attn_block(dp["cross_attn"], dp["ln_x"], (i,), xs,
                                 positions, causal=False, kv=enc,
                                 cache=dc and dc["cross"],
                                 cache_pos=cache_pos)
            return self.ffn_block(dp["mlp"], dp["ln2"], (i,), xs, "mlp",
                                  gelu=True)

        for i in range(cfg.n_layers):
            ys = dec_layer(ys, i, enc) if caches is not None \
                else self.remat(dec_layer, ys, i, enc)
        return ys

    def norm(self, p: dict, xs: dict, pre: tuple = ()) -> dict:
        out = {}
        for idx in self.pos:
            scale = self.w(p["scale"], idx, *pre)
            with self.on(idx, scale):
                out[idx] = L.rms_norm(xs[idx], {"scale": scale},
                                      self.cfg.norm_eps)
        return out

    def patches(self, proj: PlacedTensor, batch: dict, xs: dict) -> dict:
        """The VLM prefix: each position computes its output columns of
        ``patch_proj``, gathered over ``"model"``."""
        d = self.cfg.d_model
        split = d % self.tp == 0
        parts = {}
        for idx in self.pos:
            cols = (slice(self.m(idx) * (d // self.tp),
                          (self.m(idx) + 1) * (d // self.tp))
                    if split else slice(None))
            w = self.w(proj, idx, slice(None), cols)
            pt = batch[idx]["patches"]
            with self.on(idx, w, pt):
                parts[idx] = L.matmul(pt.to(xs[idx].dtype), w)
        axes = tuple(a for a in ("model",) if a in self.mesh.axis_names)
        pe = L._all_gather(self.mesh, parts, axes, -1, self.streams) \
            if split and axes else parts
        out = {}
        for idx in self.pos:
            with self.on(idx):
                out[idx] = torch.cat([pe[idx], xs[idx]], dim=1)
        return out

    def mtp(self, params, table, h, labels, positions) -> torch.Tensor:
        """The multi-token-prediction loss of ``train_loss``."""
        cfg = self.cfg
        mp = params["mtp"]
        emb = self.embed(params["embed"], labels)
        hn = self.norm(mp["norm"], h)
        x2, lab2, mask2 = {}, {}, {}
        for idx in self.pos:
            proj = self.w(mp["proj"], idx)
            with self.on(idx, proj):
                x2[idx] = L.matmul(torch.cat([hn[idx], emb[idx]], dim=-1),
                                   proj)
                lb = labels[idx]
                bsz, s = lb.shape
                lab2[idx] = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
                mask2[idx] = torch.cat(
                    [torch.ones((bsz, s - 1), dtype=torch.float32,
                                device=lb.device),
                     torch.zeros((bsz, 1), dtype=torch.float32,
                                 device=lb.device)], dim=1)
        x2 = self.layer(mp["layer"], None, x2, positions, "mlp")
        tot, cnt = self.ce(table, self.norm(mp["final_norm"], x2), lab2,
                           mask2)
        return tot / torch.clamp(cnt, min=1.0)


def _write_own(leaf: PlacedTensor, idx, region: tuple, value: torch.Tensor,
               written: set) -> None:
    """Write the part of ``value`` (the global ``region`` of the leaf: an
    int drops its dimension, a slice starts where ``value`` does) that
    falls in the block position ``idx`` holds into that position's own
    shard, and nothing into another's.  Positions whose shards are views
    of one copy write it once (``written``; a meta shard every time)."""
    own = leaf.sharding.slices(leaf.shape, idx)
    region = tuple(region) + (slice(None),) * (leaf.ndim - len(region))
    dst, src, k = [], [], 0
    for o, r in zip(own, region):
        if isinstance(r, int):
            if not o.start <= r < o.stop:
                return
            dst.append(r - o.start)
            continue
        start = r.start or 0
        lo, hi = max(o.start, start), min(o.stop, start + value.shape[k])
        if lo >= hi:
            return
        dst.append(slice(lo - o.start, hi - o.start))
        src.append(slice(lo - start, hi - start))
        k += 1
    target = leaf.shards[idx][tuple(dst)]
    key = (target.device, target.data_ptr(), tuple(target.shape),
           target.stride())
    if target.device.type == "meta" or key not in written:
        written.add(key)
        target.copy_(value[tuple(src)])


def _attend_part(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor, t0: int,
                 limit: int | None, cross: bool):
    """``layers.attend``'s softmax over one time block of keys, those at
    global times ``t0, t0 + 1, ...``, unnormalised: ``(max (b, kv, l,
    g), exp-sum (b, kv, l, g), weighted values (b, l, kv, g, dh))`` in
    float32, masked keys at ``-1e30`` (a block with none valid: maximum
    ``-1e30``).  Queries run in ``cfg.attn_chunk`` chunks as there."""
    b, l, h, dh = q.shape
    kvh, t = k.shape[2], k.shape[1]
    qg = q.reshape(b, l, kvh, h // kvh, dh)
    scale = dh ** -0.5
    key_pos = torch.arange(t0, t0 + t, device=q.device)
    valid = (key_pos[None, :] < limit) if limit is not None else \
        torch.ones((1, t), dtype=torch.bool, device=q.device)

    def chunk(qg_c, pos_c):
        lc = qg_c.shape[1]
        scores = L.einsum("blkgh,btkh->bklgt", qg_c, k).float() * scale
        if cross:
            mask = valid[:, None, :].expand(b, lc, t)
        else:
            mask = (key_pos[None, None, :] <= pos_c[..., None]) \
                & valid[:, None, :]
        scores = torch.where(mask[:, None, :, None, :], scores, -1e30)
        m = scores.amax(dim=-1)
        w = torch.exp(scores - m[..., None])
        return (m, w.sum(dim=-1),
                L.einsum("bklgt,btkh->blkgh", w.to(v.dtype), v).float())

    return _by_chunks(chunk, L._chunks(l, cfg.attn_chunk), qg, positions)


def _mla_part(cfg: ModelConfig, p: dict, q_nope: torch.Tensor,
              q_rope: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
              positions: torch.Tensor, t0: int, limit: int):
    """``layers.mla_attend``'s softmax over one time block of latents,
    those at global times ``t0, t0 + 1, ...``, unnormalised, in
    :func:`_attend_part`'s layout with one KV head of every query head:
    ``(max (b, 1, l, h), exp-sum (b, 1, l, h), weighted values (b, l, 1,
    h, ·))`` in float32.  A one-token step takes the absorbed form
    (``w_uk`` folded into the query; the weighted values are latents,
    ``w_uv`` applies after the blocks combine), a prompt the expanded
    ``k_nope``/``v_full`` form.  Queries run in ``cfg.attn_chunk`` chunks
    as there."""
    b, l, h, _ = q_nope.shape
    absorbed = l == 1
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    t = c_kv.shape[1]
    key_pos = torch.arange(t0, t0 + t, device=q_nope.device)
    valid = key_pos[None, :] < limit
    if absorbed:
        vals, eq = c_kv, "bhlt,btr->blhr"
    else:
        k_nope = L.einsum("btr,rhk->bthk", c_kv, p["w_uk"])
        vals, eq = L.einsum("btr,rhv->bthv", c_kv, p["w_uv"]), \
            "bhlt,bthv->blhv"
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].to(
            k_nope.dtype).expand(b, t, h, cfg.qk_rope_dim)], dim=-1)

    def chunk(qn, qr, pos):
        mask = ((key_pos[None, None, :] <= pos[..., None])
                & valid[:, None, :])[:, None]               # (b, 1, lc, t)
        if absorbed:
            q_lat = L.einsum("blhk,rhk->blhr", qn, p["w_uk"])
            scores = (L.einsum("blhr,btr->bhlt", q_lat, c_kv)
                      + L.einsum("blhk,btk->bhlt", qr, k_rope))
        else:
            scores = L.einsum("blhk,bthk->bhlt", torch.cat([qn, qr], dim=-1),
                              k_full)
        scores = torch.where(mask, scores.float() * scale, -1e30)
        m = scores.amax(dim=-1)                             # (b, h, lc)
        w = torch.exp(scores - m[..., None])
        return (m.permute(0, 2, 1)[:, None], w.sum(dim=-1).permute(
            0, 2, 1)[:, None], L.einsum(eq, w.to(vals.dtype), vals).float()[
                :, :, None])

    return _by_chunks(chunk, L._chunks(l, cfg.attn_chunk), q_nope, q_rope,
                      positions)


def _by_chunks(chunk, nc: int, *xs: torch.Tensor):
    """``chunk`` over ``nc`` query chunks of ``xs`` (split on their query
    axis, 1), its ``(max, exp-sum, weighted values)`` put back together
    (the first two on axis 2, the last on axis 1)."""
    if nc == 1:
        return chunk(*xs)
    got = [chunk(*c) for c in zip(*(x.chunk(nc, dim=1) for x in xs))]
    return (torch.cat([x[0] for x in got], dim=2),
            torch.cat([x[1] for x in got], dim=2),
            torch.cat([x[2] for x in got], dim=1))


def _rows(batch: dict, lo: int, hi: int, pos: _Positions, device) -> dict:
    """Rows ``[lo, hi)`` of the batch split over the data positions,
    on each position's device."""
    out = {}
    for idx in pos.pos:
        out[idx] = {}
        for k, v in batch.items():
            part = torch.tensor_split(v[lo:hi], pos.dp_size)[pos.d(idx)]
            out[idx][k] = part.to(pos.dev(idx))
    return out


def grads_and_metrics(cfg: ModelConfig, params: Any, batch: dict,
                      streams: bool = True):
    """Accumulated float32 gradients of a placed parameter tree, placed
    as the parameters (one tensor a block, shared by its holders), and
    the mean metrics over the microbatches."""
    leaves = tree_leaves(params)
    if not all(isinstance(p, PlacedTensor) for p in leaves):
        raise ValueError("a sharded step needs every parameter placed on "
                         "the mesh")
    mesh = leaves[0].sharding.mesh
    owner = {id(p): holders(p) for p in leaves}
    if mesh.size == 1:
        return _one_position(cfg, params, leaves, batch)
    dev0 = mesh.device(mesh.positions()[0])
    batch = {k: torch.as_tensor(v, device=dev0) for k, v in batch.items()}
    ga = max(cfg.grad_accum, 1)
    b = next(iter(batch.values())).shape[0]
    if b % ga:
        raise ValueError(f"batch {b} is not a multiple of grad_accum {ga}")
    acc_dt = getattr(torch, cfg.grad_accum_dtype)
    acc: dict = {}
    per_micro = []
    with mesh_context(mesh), mesh.pinned_streams():
        for i in range(ga):
            live = {id(p): {blk: p.shards[idx].detach().requires_grad_()
                            for blk, idx in owner[id(p)].items()}
                    for p in leaves}
            pos = _Positions(cfg, mesh, live, streams)
            micro = _rows(batch, i * b // ga, (i + 1) * b // ga, pos, dev0)
            loss, metrics = pos.loss(params, micro)
            flat = [(id(p), blk, t) for p in leaves
                    for blk, t in live[id(p)].items()]
            gs = torch.autograd.grad(loss, [t for _, _, t in flat],
                                     allow_unused=True)
            for (key, blk, t), g in zip(flat, gs):
                g = torch.zeros_like(t) if g is None else g
                if ga == 1:
                    acc[key, blk] = g.float()
                else:
                    a = acc.get((key, blk))
                    add = (g.float() / ga).to(acc_dt)
                    acc[key, blk] = add if a is None else a + add
            per_micro.append({k: v.detach() for k, v in metrics.items()})
    grads = [from_blocks(p, {blk: acc[id(p), blk].float()
                             for blk in owner[id(p)]}, torch.float32)
             for p in leaves]
    if ga == 1:
        return tree_unflatten(params, grads), per_micro[0]
    return tree_unflatten(params, grads), {
        k: torch.stack([m[k] for m in per_micro]).mean()
        for k in per_micro[0]}


def _one_position(cfg: ModelConfig, params, leaves: list, batch: dict):
    """A 1 x 1 mesh: the one-device step on the position's tensors, for
    every family."""
    from .train_step import grads_and_metrics as plain

    only = leaves[0].sharding.mesh.positions()[0]
    local = tree_unflatten(params, [p.shards[only] for p in leaves])
    grads, metrics = plain(cfg, local, batch)
    return tree_unflatten(params, [
        from_blocks(p, {holders(p).popitem()[0]: g}, torch.float32)
        for p, g in zip(leaves, tree_leaves(grads))]), metrics
