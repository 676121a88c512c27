"""The prefill and decode steps over a mesh of positions.

Counterpart of what ``jax.jit`` makes of ``T.prefill`` and
``T.decode_step`` with ``in_shardings=(psh, bsh, csh)`` and ``(psh, tsh,
csh, repl)`` and ``out_shardings=(None, csh)`` on a mesh
(``src/repro/launch/dryrun.py:100-128``): XLA partitions the JAX steps
by the parameters' and the caches' specs.  The port has no partitioner,
so this module writes the partitioned steps out, for every family
(dense, moe, vlm, ssm, hybrid, encdec), over the sharded train step's
forward (:class:`repro_torch.train.sharded_step._Positions`), every
position driven from the calling thread, each on a CUDA stream of its
own (off the card one after another).

Storage follows the specs, compute follows the layer kind:

* each position computes its rows of the batch (``"data"``, and
  ``"pod"`` where the mesh has it) and its ``"model"`` slice of every
  layer: its query heads, the vocabulary of the embedding and of the
  unembedding, ``d_ff`` of the MLP, the experts through the
  expert-parallel dispatch the JAX layer picks at the step's token
  count (a decode step's few tokens: weights-stationary), Mamba2's SSM
  heads with B and C whole, and an encoder-decoder's encoder over its
  rows of ``frames``;
* a position's cache block is its rows and its ``"model"`` slice of the
  KV heads (or of MLA's latent, or of the Mamba2 states' heads and
  channels): it computes that block's new entries and writes them into
  its own shard, at the step's position (a prefill at 0; the hybrid's
  shared attention block at its invocation's cache layer; a prefill's
  cross-attention cache and ``enc_out`` once), never into a tensor
  another position reads; it reads the states it needs with
  ``read_region``, blocks it does not hold (MLA's latent, Mamba2's
  ``conv_bc``, which the specs split over ``"model"`` and every head
  reads whole) from their holders;
* row-parallel products and the vocab-parallel lookup end in a sum over
  ``"model"`` (``layers._psum``), the MoE in its dispatch's sums.

A batch the data positions do not divide (``long_500k``'s one row) takes
the context-parallel layout ``cache_specs`` gives it: no cache leaf
splits its rows, every data position computes every row, a cache split
over time on ``"data"`` (``k``/``v``, or MLA's ``c_kv``/``k_rope``) is
written at the holder of each token's time block and attended block by
block, the blocks' softmax partials combined over ``"data"``
(``_Positions.attend_blocks``), and a MoE layer counts the rows once and
takes the dispatch the JAX layer takes at that count (the shard-map
dispatch: each data position its even share of the tokens, the outputs
gathered).  Under any other layout such a batch raises ``ValueError``.

The logits of the last position come back whole, one tensor on the
first position's device, as ``out_shardings=None`` hands the caller a
whole array; the caches come back placed by their specs, written in
place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..models import layers as L
from ..models import transformer as T
from ..models.config import ModelConfig
from ..sharding.ctx import mesh_context
from ..sharding.placement import PlacedTensor
from ..train.sharded_step import _Positions
from ..tree import tree_flatten_with_path, tree_leaves


def prefill_sharded(cfg: ModelConfig, params: Any, batch: dict, caches: Any,
                    mesh) -> tuple[torch.Tensor, Any]:
    """``T.prefill`` over ``mesh``: the prompt ``batch`` (``tokens``, a
    VLM's ``patches``, an encoder-decoder's ``frames``) through
    parameters placed by ``param_specs`` and caches placed by
    ``cache_specs``.  Returns (the last position's logits, whole, on the
    first position's device; the caches)."""
    return _step(cfg, params, batch, caches, mesh, None)


def decode_step_sharded(cfg: ModelConfig, params: Any, tokens, caches: Any,
                        cache_pos: int, mesh) -> tuple[torch.Tensor, Any]:
    """``T.decode_step`` over ``mesh``: one token a row at ``cache_pos``.
    Returns (the logits, whole, on the first position's device; the
    caches)."""
    return _step(cfg, params, {"tokens": tokens}, caches, mesh,
                 int(cache_pos))


def _check(cfg: ModelConfig, params, caches, mesh, rows: int) -> bool:
    """Whether the step runs context-parallel (every data position every
    row); raises where the placement or the layout cannot run."""
    for what, tree in (("parameter", params), ("cache", caches)):
        for leaf in tree_leaves(tree):
            if not isinstance(leaf, PlacedTensor) \
                    or leaf.sharding.mesh is not mesh:
                raise ValueError(f"a sharded serving step needs every "
                                 f"{what} placed on the mesh")
    dp_size = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    if rows % dp_size == 0:
        return False
    for path, leaf in tree_flatten_with_path(caches):
        dim = 0 if path[-1] == "enc_out" else 1
        if leaf.sharding.parts(leaf.ndim)[dim] > 1:
            raise ValueError(f"{rows} rows over {dp_size} data positions, "
                             f"and the cache {'/'.join(map(str, path))} "
                             f"splits its rows ({leaf.sharding.spec})")
    return True


def _step(cfg: ModelConfig, params, batch: dict, caches, mesh,
          cache_pos: int | None):
    b = len(batch["tokens"])
    every = _check(cfg, params, caches, mesh, b)
    pos = _Positions(cfg, mesh, None, True, every)
    dev0 = pos.dev(pos.pos[0])
    batch = {k: torch.as_tensor(v, device=dev0) for k, v in batch.items()}
    rows = b if every else b // pos.dp_size
    local = {idx: {k: v[0 if every else pos.d(idx) * rows:][:rows].to(
        pos.dev(idx)) for k, v in batch.items()} for idx in pos.pos}
    with torch.no_grad(), mesh_context(mesh), mesh.pinned_streams():
        xs = pos.embed(params["embed"], {i: x["tokens"]
                                         for i, x in local.items()})
        if cfg.family == "vlm" and "patches" in batch:
            xs = pos.patches(params["patch_proj"], local, xs)
        positions = {}
        for idx in pos.pos:
            with pos.on(idx):
                bl, l, _ = xs[idx].shape
                decoding = cache_pos is not None and l == 1
                positions[idx] = T._positions(bl, l, cache_pos if decoding
                                              else None, xs[idx].device)
        if cfg.family in ("ssm", "hybrid"):
            xs = pos.mamba_stack(params, xs, positions, caches, cache_pos)
        elif cfg.family == "encdec":
            xs = pos.encdec(params, local, xs, positions, caches, cache_pos)
        else:
            if cfg.dense_prefix:
                xs = pos.stack(params["prefix_layers"], xs, positions, "mlp",
                               caches["prefix"], cache_pos)
            xs = pos.stack(params["layers"], xs, positions,
                           "moe" if cfg.n_experts else "mlp", caches["main"],
                           cache_pos)
        h = pos.norm(params["final_norm"], xs)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        logits = _logits(pos, table, {i: x[:, -1:] for i, x in h.items()},
                         every)
    return logits, caches


def _logits(pos: _Positions, table: PlacedTensor, hs: dict,
            every: bool = False) -> torch.Tensor:
    """``_unembed`` over the positions: each its rows and its vocabulary
    slice (the padded vocabulary masked by global index), put together
    on the first position's device (``every``: each data position holds
    every row, and the first's are taken)."""
    cfg = pos.cfg
    ws = {idx: pos.w(table, idx, pos.vocab_slice(idx)) for idx in pos.pos}
    part = {}
    for idx in pos.pos:
        with pos.on(idx, ws[idx]):
            vs = pos.vocab_slice(idx)
            lg = L.einsum("bld,vd->blv", hs[idx], ws[idx])
            if cfg.vocab_eff != cfg.vocab:
                pad = torch.arange(vs.start, vs.stop,
                                   device=lg.device) >= cfg.vocab
                lg = lg.masked_fill(pad[None, None, :], -1e30)
            part[idx] = lg
    part = L._join(pos.mesh, part, pos.streams)
    dev0 = pos.dev(pos.pos[0])
    blocks: dict = {}
    for idx in pos.pos:
        blocks.setdefault((0 if every else pos.d(idx),
                           pos.vocab_slice(idx).start), part[idx])
    rows = sorted({d for d, _ in blocks})
    return torch.cat([torch.cat([blocks[d, v].to(dev0) for dd, v in
                                 sorted(blocks) if dd == d], dim=-1)
                      for d in rows], dim=0)
