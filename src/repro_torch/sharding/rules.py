"""Logical-axis sharding rules: params, optimizer state, caches, batches.

Counterpart of ``src/repro/sharding/rules.py``, over the port's trees
(key names of :mod:`repro_torch.tree`; shapes from
``init_model(cfg, None)``'s meta tensors or ``init_cache(...,
device="meta")``, never from an allocation).

Strategy:

* **DP**  — batch over ``("pod", "data")``; gradients reduce hierarchically
  (ICI within a pod, DCN across pods).
* **FSDP** — parameters and optimizer state additionally shard one
  non-TP dimension over ``"data"`` (ZeRO-3-style).  Pod-replicated:
  cross-pod traffic stays gradient-only.
* **TP**  — heads / d_ff / experts / vocab over ``"model"`` (head counts
  pre-padded by the config geometry, vocab padded to 128).
* **EP**  — MoE expert dim over ``"model"``; dispatch buffers shard
  (expert → "model", capacity → "data").

Specs are *preferences*: :func:`sanitize` drops any axis that does not
divide the concrete dimension, so odd shapes (kv=8 on a 16-way axis,
group dims) degrade to replication.

A spec is a :class:`PartitionSpec`, a tuple with one entry per dimension
(``None``, an axis name, or a tuple of names), entry for entry JAX's.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..models.config import ModelConfig
from ..tree import tree_map_with_path


class PartitionSpec(tuple):
    """One entry per dimension: ``None``, an axis name, or a tuple of axis
    names.  Entries are kept as ``jax.sharding.PartitionSpec`` keeps them:
    a list becomes a tuple, an empty one ``None``, and a one-name tuple
    the name."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    """``is_leaf`` for trees of specs (a spec is a tuple)."""
    return isinstance(x, PartitionSpec)


# preferred spec for the *trailing* dims of each named parameter
_PARAM_RULES: list[tuple[str, tuple]] = [
    ("embed", ("model", "data")),
    ("unembed", ("model", "data")),
    ("patch_proj", ("data", "model")),
    # attention
    ("wq", ("data", "model", None)),
    ("wk", ("data", "model", None)),
    ("wv", ("data", "model", None)),
    ("wo", ("model", None, "data")),
    ("bq", ("model", None)),
    ("bk", ("model", None)),
    ("bv", ("model", None)),
    # MLA
    ("w_dq", ("data", "model")),
    ("w_uq", ("data", "model", None)),
    ("w_dkv", ("data", None)),
    ("w_uk", ("data", "model", None)),
    ("w_uv", ("data", "model", None)),
    # MLP / MoE
    ("wi", ("data", "model")),          # overridden for experts below
    ("router", ("data", "model")),
    # mamba2
    ("zx_proj", ("data", "model", None)),
    ("b_proj", ("data", None)),
    ("c_proj", ("data", None)),
    ("dt_proj", ("data", "model")),
    ("conv_x", (None, "model")),
    ("conv_bc", (None, None)),
    ("conv_b_x", ("model",)),
    ("conv_b_bc", (None,)),
    ("a_log", ("model",)),
    ("d_skip", ("model",)),
    ("dt_bias", ("model",)),
    ("out_proj", ("model", "data")),
    # mtp
    ("proj", ("data", "model")),
    ("scale", (None,)),
]

_EXPERT_RULES = {
    "wi": ("model", "data", None),      # (E, d, 2f)
    "wo": ("model", None, "data"),      # (E, f, d)
}


def _names(path: tuple) -> list[str]:
    """A key path's names as JAX's ``getattr(k, "key", str(k))`` spells
    them: dict keys themselves, sequence indices ``"[i]"``."""
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def _rule_for(path: tuple, shape: tuple) -> tuple:
    names = _names(path)
    leaf = names[-1]
    if leaf in _EXPERT_RULES and len(shape) >= 3 and ("moe" in names):
        return _EXPERT_RULES[leaf]
    for key, spec in _PARAM_RULES:
        if leaf == key:
            return spec
    return ()  # replicate


def sanitize(spec: tuple, shape: tuple, mesh) -> PartitionSpec:
    """Pad to rank, drop axes that don't divide the dim or the mesh."""
    shape = tuple(shape)
    spec = ((None,) * (len(shape) - len(spec))) + tuple(spec)
    spec = spec[-len(shape):] if shape else ()
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = int(np.prod([mesh.shape[a] for a in axes
                            if a in mesh.axis_names]))
        present = all(a in mesh.axis_names for a in axes)
        out.append(ax if (present and size > 0 and dim % size == 0) else None)
    return PartitionSpec(*out)


def param_specs(cfg: ModelConfig, params_shape: Any, mesh) -> Any:
    """Spec tree matching the params tree (leaves: anything with
    ``.shape``, such as ``init_model(cfg, None)``'s meta tensors)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        return sanitize(_rule_for(path, shape), shape, mesh)

    return tree_map_with_path(one, params_shape)


def param_shardings(cfg: ModelConfig, params_shape: Any, mesh) -> Any:
    """:class:`~repro_torch.sharding.placement.NamedSharding` tree of
    :func:`param_specs`, as JAX's returns ``NamedSharding``\\ s."""
    from .placement import NamedSharding

    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s),
                              param_specs(cfg, params_shape, mesh),
                              is_leaf=is_spec)


# ----------------------------------------------------------------- batches
def _dp(mesh):
    got = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return got if got else None


def batch_specs(cfg: ModelConfig, batch_shape: dict, mesh) -> dict:
    out = {}
    for k, v in batch_shape.items():
        spec = (_dp(mesh),) + (None,) * (len(v.shape) - 1)
        out[k] = sanitize(spec, v.shape, mesh)
    return out


# ------------------------------------------------------------------ caches
def cache_specs(cfg: ModelConfig, cache_shape: Any, mesh) -> Any:
    """KV/SSM cache specs: (layers, B, T, heads/rank, ...).

    Batch shards over DP when divisible; otherwise (long-context B=1)
    the *time* dim shards over "data" — context-parallel cache layout.
    """
    dp = _dp(mesh)

    def one(path, leaf):
        leaf_name = _names(path)[-1]
        shape = tuple(leaf.shape)
        if leaf_name == "enc_out":
            return sanitize((dp, None, None), shape, mesh)
        dp_size = int(np.prod([mesh.shape[a] for a in (dp or ())]))
        batch_ok = len(shape) >= 2 and shape[1] % max(dp_size, 1) == 0
        if leaf_name in ("k", "v"):          # (L, B, T, kv, dh)
            t_ax = None if batch_ok else "data"
            return sanitize((None, dp if batch_ok else None, t_ax,
                             "model", None), shape, mesh)
        if leaf_name in ("c_kv", "k_rope"):  # (L, B, T, rank)
            t_ax = None if batch_ok else "data"
            return sanitize((None, dp if batch_ok else None, t_ax,
                             "model"), shape, mesh)
        if leaf_name == "ssd":               # (L, B, H, P, N)
            return sanitize((None, dp if batch_ok else None, "model",
                             None, None), shape, mesh)
        if leaf_name in ("conv_x", "conv_bc"):
            return sanitize((None, dp if batch_ok else None, None,
                             "model"), shape, mesh)
        return sanitize((None,) * len(shape), shape, mesh)

    return tree_map_with_path(one, cache_shape)


def logits_spec(mesh) -> PartitionSpec:
    return PartitionSpec(_dp(mesh), None, "model")
