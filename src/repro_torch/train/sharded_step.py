"""The train step's gradients over a mesh of positions.

Counterpart of what ``jax.jit(step, in_shardings=(psh, osh, bsh, repl),
out_shardings=(psh, osh, None))`` makes of ``src/repro/train/
train_step.py`` on a mesh (``src/repro/launch/dryrun.py:90-103``): XLA
partitions the JAX step by the parameters' specs.  The port has no
partitioner, so this module writes the partitioned step out, for the
decoder families (dense, moe, vlm), and drives every position from the
calling thread, each on a CUDA stream of its own (off the card one after
another), as the expert-parallel MoE does (:mod:`repro_torch.models.
layers`).

Storage follows the specs; compute follows the layer kind:

* each position computes its rows of the batch (``"data"``, and
  ``"pod"`` where the mesh has it) and its ``"model"`` slice of every
  layer: the heads of attention and MLA (with the KV heads its query
  heads read), ``d_ff`` of the MLP, the vocabulary of the embedding and
  the unembedding, the experts through the expert-parallel dispatches,
  the output columns of ``patch_proj``; a layer whose dimension does not
  divide the model axis computes whole at every position, unsummed;
* it gathers those slices from the placed leaves by global range
  (:func:`~repro_torch.sharding.placement.read_region`): each block from
  its first holder, whose shard is a leaf of its own for autograd, so
  every use of a block adds to that leaf's gradient, at the block's
  shape: the reduction over ``"data"`` and the reduce-scatter are
  autograd's own sums;
* row-parallel products and the vocab-parallel lookup end in a sum over
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
over all positions, sums included; the positions' streams are pinned
for the step (:meth:`~repro_torch.launch.mesh.FilterMesh.pinned_streams`),
so a recompute in autograd's thread runs on the streams its forward ran
on.  The products stay ``torch.einsum``
and ``matmul``: the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from ..models import layers as L
from ..models import transformer as T
from ..models.config import ModelConfig
from ..sharding.ctx import mesh_context
from ..sharding.placement import (PlacedTensor, from_blocks, holders,
                                  read_region)
from ..tree import tree_leaves, tree_map, tree_unflatten

#: the families with a partitioned step; the others run on a 1 x 1 mesh
DECODER_FAMILIES = ("dense", "moe", "vlm")


class _Positions:
    """One microbatch's forward over the positions of ``mesh``."""

    def __init__(self, cfg: ModelConfig, mesh, live: dict, streams: bool):
        self.cfg, self.mesh, self.live, self.streams = cfg, mesh, live, streams
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
        from the live leaves (differentiable)."""
        return read_region(leaf, sl, self.dev(idx), self.live[id(leaf)])

    def whole(self, tree, idx, pre=()):
        """Every leaf of ``tree`` whole (at layer ``pre``) on a position."""
        return tree_map(lambda leaf: self.w(leaf, idx, *pre), tree)

    # ------------------------------------------------------------ layers
    def attn_weights(self, ap: dict, pre: tuple, idx):
        """(config, parameters, head mask) of a position's heads of
        attention or MLA at layer ``pre``."""
        cfg = self.cfg
        if self.heads is None:
            return cfg, self.whole(ap, idx, pre), None
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
        kv = cfg.n_kv_eff
        factor = kv // ap["wk"].shape[-2]
        lo = m * hl // (cfg.n_heads_eff // kv)     # first kv_eff head read
        ks = slice(lo // factor, (lo + kl - 1) // factor + 1)
        cut = slice(lo - ks.start * factor, lo - ks.start * factor + kl)
        p["wq"] = self.w(ap["wq"], idx, *pre, slice(None), qs)
        p["wo"] = self.w(ap["wo"], idx, *pre, qs)
        for k in ("wk", "wv"):
            p[k] = self.w(ap[k], idx, *pre, slice(None), ks).repeat_interleave(
                factor, dim=1)[:, cut]
        if "bq" in ap:
            p["bq"] = self.w(ap["bq"], idx, *pre, qs)
            for k in ("bk", "bv"):
                p[k] = self.w(ap[k], idx, *pre, ks).repeat_interleave(
                    factor, dim=0)[cut]
        return cfg.with_(n_heads=hl, n_kv_heads=kl, pad_heads_to=0), p, hm

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

    def layer(self, lp: dict, i, xs: dict, positions: dict,
              ffn: str) -> dict:
        """One decoder layer (``_decoder_layer``) over the positions;
        ``i`` indexes a stacked layer tree (``None``: unstacked)."""
        cfg = self.cfg
        pre = () if i is None else (i,)
        ln = {idx: (self.w(lp["ln1"]["scale"], idx, *pre),
                    self.w(lp["ln2"]["scale"], idx, *pre))
              for idx in self.pos}
        aw = {idx: self.attn_weights(lp["attn"], pre, idx)
              for idx in self.pos}
        parts = {}
        for idx in self.pos:
            acfg, ap, hm = aw[idx]
            with self.on(idx, *ln[idx], *tree_leaves(ap), hm):
                h = L.rms_norm(xs[idx], {"scale": ln[idx][0]}, cfg.norm_eps)
                fn = L.mla_attention if cfg.mla else L.attention
                kw = {} if cfg.mla else {"causal": True}
                parts[idx], _ = fn(acfg, ap, h, positions=positions[idx],
                                   head_mask=hm, **kw)
        a = self.psum(parts) if self.heads is not None else parts
        x1, h2 = {}, {}
        for idx in self.pos:
            with self.on(idx):
                x1[idx] = xs[idx] + a[idx]
                h2[idx] = L.rms_norm(x1[idx], {"scale": ln[idx][1]},
                                     cfg.norm_eps)
        f = self.moe(lp["moe"], pre, h2) if ffn == "moe" \
            else self.mlp(lp["mlp"], pre, h2, gelu=cfg.mlp_gelu)
        out = {}
        for idx in self.pos:
            with self.on(idx):
                out[idx] = x1[idx] + f[idx]
        return out

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
        neither applies, take every row gathered."""
        cfg, mesh = self.cfg, self.mesh
        first = self.pos[0]
        bl, d = hs[first].shape[1], hs[first].shape[2]
        rows = {self.d(idx): hs[idx].shape[0] for idx in self.pos}
        n = sum(rows.values()) * bl
        own = {idx: hs[idx].reshape(-1, d) for idx in self.pos}
        start = {k: sum(rows[j] for j in range(k)) * bl for k in rows}
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
            every = None if even else L._all_gather(mesh, own, self.dp, 0,
                                                    self.streams)
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
            every = L._all_gather(mesh, own, self.dp, 0, self.streams)
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

        def stack(tree, xs, ffn):
            for i in range(T.n_stacked(tree)):
                if cfg.remat:
                    xs = T._recomputed(self.layer, tree, i, xs, positions,
                                       ffn)
                else:
                    xs = self.layer(tree, i, xs, positions, ffn)
            return xs

        if cfg.dense_prefix:
            xs = stack(params["prefix_layers"], xs, "mlp")
        xs = stack(params["layers"], xs, "moe" if cfg.n_experts else "mlp")
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

    def norm(self, p: dict, xs: dict) -> dict:
        out = {}
        for idx in self.pos:
            scale = self.w(p["scale"], idx)
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
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"the sharded train step covers the decoder families "
            f"{DECODER_FAMILIES}; {cfg.family} ({cfg.name}) on a mesh wider "
            f"than 1 x 1 is ROADMAP item 14h")
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
