"""Dry run of every (architecture × shape × production mesh) cell on the
meta device.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell's train, prefill or decode step with XLA on 256 or 512
placeholder devices and reads ``memory_analysis()`` and
``cost_analysis()``.  The port has no compiler to ask, so for each cell
this driver:

1. builds the full-size config (bf16, padded heads, remat, grad-accum);
2. builds the parameters (``init_model(cfg, None)``), the optimizer
   state, the caches (``init_cache(..., device="meta")``) and the batch
   as ``meta`` tensors: shapes and dtypes, no memory;
3. takes their specs from :mod:`repro_torch.sharding.rules` on the
   production mesh (``make_production_mesh``, a grid of meta positions);
4. reports, for one position:

   * the argument bytes, each leaf's shard under its spec (parameters,
     optimizer state, batch, caches and the step scalar): the
     counterpart of XLA's ``argument_size_in_bytes``;
   * for a train cell, the float32 gradient shards the sharded step
     accumulates, and an estimate of the bytes autograd keeps for the
     backward pass: the tensors its ``saved_tensors_hooks`` see plus the
     inputs every recomputed layer and CE chunk keeps, counted on meta
     for one position's rows of one microbatch at the model's whole
     widths (activations split by tensor parallelism count whole, so it
     is high by up to the model axis) — the counterpart of
     ``temp_size_in_bytes``;
   * the step's FLOPs under ``torch.utils.flop_counter.FlopCounterMode``
     (products only), global and split evenly over the positions; a
     train cell counts one microbatch and multiplies by ``grad_accum``
     (``tests/test_torch_cells_dryrun.py`` holds that equal to the full
     count);
   * ``model_flops`` and ``fits_h100_80g``: the position's bytes against
     :data:`H100_80G_BYTES`;
   * the JAX dry run's ``bytes_accessed``, ``collective_bytes`` and
     ``collective_breakdown`` (global: a position's count times
     ``chips``; XLA's ``collective_breakdown`` is a device's, the port's
     ``collective_breakdown_per_position``) and their
     ``*_per_position`` twins, from the cell's partitioned step run on
     the mesh's meta positions under
     :mod:`~repro_torch.launch.cost_analysis`'s counters: for a train
     cell the whole step, the sharded train step's gradients (one
     microbatch, times ``grad_accum``), the gradient norm and the
     optimizer's update on the placed trees (its folds over blocks held
     at other positions); for a serving cell of every family
     :mod:`repro_torch.serve.sharded_step`'s prefill or decode step.  A
     train cell's accessed bytes, counted from the first position alone
     (:func:`counting_mesh`), are an approximation of the mesh's mean
     (autograd's sums into a block run at its holders: within 5% on the
     mini cells of ``tests/test_torch_cost_analysis.py``), and its
     ``collective_note`` says so.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multipod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] \\
      [--specs-only]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import transformer as T
from ..models.config import SHAPES, ModelConfig, ShapeSpec
from ..sharding import rules as R
from ..sharding.placement import NamedSharding, device_put
from ..train.optimizer import make_optimizer
from ..train.train_step import grads_and_metrics
from ..tree import tree_leaves, tree_map_with_path
from .cells import (Cell, batch_struct, decode_tokens_struct, dryrun_config,
                    enumerate_cells, model_flops, serve_batch_struct)
from .mesh import FilterMesh, make_production_mesh

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (700.00 W power limit), as ``chip_smoke.py`` phase 14 reads it
H100_80G_BYTES = 85_017_493_504
P = R.PartitionSpec


def opt_state_specs(opt_name: str, params_shape, pspecs, mesh):
    """Optimizer-state specs mirroring the param specs (ZeRO via FSDP)."""
    pleaves = tree_leaves(params_shape)
    sleaves = tree_leaves(pspecs, is_leaf=R.is_spec)
    assert len(pleaves) == len(sleaves)
    if opt_name == "adamw":
        return {"m": list(sleaves), "v": list(sleaves)}
    stats = []
    for p, s in zip(pleaves, sleaves):
        t = tuple(s) + (None,) * (len(p.shape) - len(tuple(s)))
        if len(p.shape) >= 2:
            stats.append({"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))})
        else:
            stats.append({"v": P(*t)})
    return {"stats": stats}


def build_cell(cell: Cell, mesh, cfg: ModelConfig | None = None):
    """``(cfg, args)`` of the cell's step: ``args`` maps each argument
    (``params``, ``opt_state``, ``batch``, ``caches``, ``tokens``,
    ``step``) to ``(meta tree, spec tree)``, the step's arguments as the
    JAX dry run hands them to ``jit``."""
    cfg = cfg or dryrun_config(cell.arch)
    shape = cell.shape
    params = T.init_model(cfg, None)
    args = {"params": (params, R.param_specs(cfg, params, mesh))}
    scalar = (torch.empty((), dtype=torch.int32, device="meta"), P())
    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params)
        args["opt_state"] = (state, opt_state_specs(
            cfg.optimizer, params, args["params"][1], mesh))
        batch = batch_struct(cfg, shape)
        args["batch"] = (batch, R.batch_specs(cfg, batch, mesh))
        args["step"] = scalar
        return cfg, args
    caches = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                          dtype=torch.bfloat16, device="meta")
    if shape.kind == "prefill":
        batch = serve_batch_struct(cfg, shape)
        args["batch"] = (batch, R.batch_specs(cfg, batch, mesh))
    else:
        tokens = decode_tokens_struct(shape)
        args["tokens"] = (tokens, R.batch_specs(cfg, {"tokens": tokens},
                                                mesh)["tokens"])
    args["caches"] = (caches, R.cache_specs(cfg, caches, mesh))
    if shape.kind == "decode":
        args["step"] = scalar
    return cfg, args


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one position's shards of a tree under its specs (every
    spec divides its dimension, so each position holds the same)."""
    leaves = tree_leaves(tree)
    specs = tree_leaves(specs, is_leaf=R.is_spec)
    assert len(leaves) == len(specs)
    total = 0
    for x, s in zip(leaves, specs):
        n = 1
        for dim in NamedSharding(mesh, s).shard_shape(x.shape):
            n *= dim
        total += n * x.element_size()
    return total


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def step_counts(cfg: ModelConfig, shape: ShapeSpec, rows: int, *,
                saved: bool = False) -> tuple[float, int | None]:
    """(FLOPs, saved bytes) of the cell's step on ``rows`` sequences on
    the meta device: a train step's gradients (forward, recompute and
    backward; ``grad_accum`` 1), or a prefill or a decode step.  With
    ``saved``, the bytes autograd keeps for the backward pass (distinct
    non-parameter tensors its hooks see, and the inputs the recomputed
    calls keep), else ``None``."""
    params = T.init_model(cfg, None)
    s = ShapeSpec(shape.name, shape.seq_len, rows, shape.kind)
    kept: dict[int, torch.Tensor] = {}   # held, so no id is reused

    def note(t: torch.Tensor) -> None:
        base = t if t._base is None else t._base
        if not (base.is_leaf and base.requires_grad):
            kept[id(base)] = base

    def pack(t):
        note(t)
        return t

    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        batch = batch_struct(cfg, s)
        with counter, T.kept_for_recompute() as inputs:
            if saved:
                with torch.autograd.graph.saved_tensors_hooks(pack,
                                                              lambda t: t):
                    grads_and_metrics(cfg.with_(grad_accum=1), params, batch)
            else:
                grads_and_metrics(cfg.with_(grad_accum=1), params, batch)
        for t in inputs:
            note(t)
        return float(counter.get_total_flops()), (
            sum(t.numel() * t.element_size() for t in kept.values())
            if saved else None)
    caches = T.init_cache(cfg, rows, shape.seq_len, dtype=torch.bfloat16,
                          device="meta")
    with counter, torch.no_grad():
        if shape.kind == "prefill":
            T.prefill(cfg, params, serve_batch_struct(cfg, s), caches)
        else:
            T.decode_step(cfg, params, decode_tokens_struct(s), caches,
                          shape.seq_len - 1)
    return float(counter.get_total_flops()), None


def partitioned_counts(cell: Cell, mesh, cfg: ModelConfig) -> dict:
    """``cost_analysis.analyze_step`` of the cell's partitioned step on
    ``mesh`` (meta tensors placed by the rule specs): a train cell's
    whole step (one microbatch's gradients times ``grad_accum``, then the
    gradient norm and the optimizer's update on the placed trees, once),
    a serving cell's prefill or decode step.  The step runs on
    :func:`counting_mesh`: the counts are the first position's."""
    from ..serve import sharded_step as serve_step
    from ..train import sharded_step as train_step
    from ..train.optimizer import global_norm
    from .cost_analysis import analyze_step

    shape = cell.shape
    mesh = counting_mesh(mesh)
    _, args = build_cell(cell, mesh, cfg)
    placed = {k: device_put(tree, _named(mesh, specs))
              for k, (tree, specs) in args.items()
              if k in ("params", "caches", "opt_state")}
    if shape.kind == "train":
        ga = max(cfg.grad_accum, 1)
        micro = {k: v[:v.shape[0] // ga] for k, v in args["batch"][0].items()}
        got = {}

        def grads():
            got["grads"], _ = train_step.grads_and_metrics(
                cfg.with_(grad_accum=1), placed["params"], micro)

        def update():
            global_norm(got["grads"])
            make_optimizer(cfg.optimizer).update(
                got["grads"], placed["opt_state"], placed["params"], 0)

        return _added(analyze_step(grads, mesh, factor=ga),
                      analyze_step(update, mesh))
    if shape.kind == "prefill":
        return analyze_step(lambda: serve_step.prefill_sharded(
            cfg, placed["params"], args["batch"][0], placed["caches"],
            mesh), mesh)
    return analyze_step(lambda: serve_step.decode_step_sharded(
        cfg, placed["params"], args["tokens"][0], placed["caches"],
        shape.seq_len - 1, mesh), mesh)


def _added(a: dict, b: dict) -> dict:
    """Two ``analyze_step`` counts of one step's parts, added."""
    out = {k: a[k] + b[k] for k in a if k != "collective_breakdown"}
    kinds = a["collective_breakdown"].keys() | b["collective_breakdown"]
    out["collective_breakdown"] = {
        k: a["collective_breakdown"].get(k, 0.0)
        + b["collective_breakdown"].get(k, 0.0) for k in sorted(kinds)}
    return out


def counting_mesh(mesh):
    """``mesh``'s axes and sizes on meta positions (a card grid's too),
    seen from the first position where there are several: a meta mesh
    is symmetric, so one position's counts are each position's
    (``FilterMesh.first_position``)."""
    def grid(dims):
        return "meta" if not dims else [grid(dims[1:])
                                        for _ in range(dims[0])]
    meta = FilterMesh(grid(tuple(mesh.shape.values())),
                      axis_names=mesh.axis_names)
    return meta.first_position() if meta.size > 1 else meta


def _named(mesh, specs):
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs,
                              is_leaf=R.is_spec)


def cell_bytes(cell: Cell, mesh, cfg: ModelConfig | None = None) -> dict:
    """One position's argument bytes, by argument and in all, and (train)
    its float32 gradient shards."""
    cfg, args = build_cell(cell, mesh, cfg)
    out = {k: shard_bytes(tree, specs, mesh)
           for k, (tree, specs) in args.items()}
    out["argument_B"] = sum(out.values())
    if cell.shape.kind == "train":
        params, specs = args["params"]
        out["grad_B"] = shard_bytes(
            [torch.empty(p.shape, dtype=torch.float32, device="meta")
             for p in tree_leaves(params)], specs, mesh)
    return out


def run_cell(cell: Cell, *, multi_pod: bool, measure: bool = True,
             cfg: ModelConfig | None = None, mesh=None) -> dict:
    """The cell's artifact.  ``measure=False`` reads the specs only (no
    FLOPs, no saved-bytes estimate; ``fits_h100_80g`` then judges the
    argument and gradient bytes).  ``cfg`` and ``mesh`` replace the
    production config and mesh (a host mesh for a card run)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    if cfg is not None:
        mesh_name = "x".join(str(n) for n in mesh.shape.values())
    chips = mesh.size
    art = {"cell": cell.name, "arch": cell.arch, "shape": cell.shape.name,
           "mesh": mesh_name, "chips": chips}
    if not cell.runnable:
        art["status"] = "skip"
        art["error"] = cell.skip_reason
        return art
    t0 = time.time()
    try:
        cfg = cfg or dryrun_config(cell.arch)
        art.update(cell_bytes(cell, mesh, cfg))
        total = art["argument_B"] + art.get("grad_B", 0)
        if measure:
            shape = cell.shape
            if shape.kind == "train":
                ga = max(cfg.grad_accum, 1)
                micro = shape.global_batch // ga
                dp = _dp_size(mesh)
                rows = micro // dp if micro % dp == 0 else micro
                flops, _ = step_counts(cfg, shape, micro)
                _, saved = step_counts(cfg, shape, max(rows, 1), saved=True)
                art["flops"] = flops * ga
                art["saved_B_estimate"] = saved
                total += saved
            else:
                art["flops"], _ = step_counts(cfg, shape, shape.global_batch)
            art["flops_per_position"] = art["flops"] / chips  # even split
            art.update(collective_fields(partitioned_counts(cell, mesh, cfg),
                                         chips, shape.kind == "train"))
        art.update({
            "status": "ok",
            "estimate": "specs+saved" if measure and "saved_B_estimate"
            in art else "specs",
            "per_position_B": total,
            "h100_bytes": H100_80G_BYTES,
            "fits_h100_80g": bool(total <= H100_80G_BYTES),
            "model_flops": model_flops(cfg, cell.shape),
            "seconds": round(time.time() - t0, 1),
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        art["status"] = "error"
        art["error"] = f"{type(e).__name__}: {e}"
        art["traceback"] = traceback.format_exc()[-4000:]
        art["seconds"] = round(time.time() - t0, 1)
    return art


#: a train cell's ``collective_note``
TRAIN_NOTE = ("the whole step, the optimizer update included; "
              "bytes_accessed approximates the mesh's mean from the first "
              "position")


def collective_fields(counts: dict, chips: int, train: bool = False) -> dict:
    """The artifact's accessed and collective bytes: global (a position's
    times ``chips``, as the JAX dry run reports them) and a position's."""
    per = counts["collective_breakdown"]
    note = {"collective_note": TRAIN_NOTE} if train else {}
    return note | {
        "bytes_accessed": counts["traffic_bytes_per_device"] * chips,
        "collective_bytes": counts["collective_bytes_per_device"] * chips,
        "collective_breakdown": {k: v * chips for k, v in per.items()},
        "bytes_accessed_per_position": counts["traffic_bytes_per_device"],
        "collective_bytes_per_position":
            counts["collective_bytes_per_device"],
        "collective_breakdown_per_position": per,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--specs-only", action="store_true",
                    help="argument bytes only: no FLOPs, no saved bytes")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    cells = enumerate_cells()
    if not args.all:
        cells = [c for c in cells
                 if (args.arch is None or c.arch == args.arch)
                 and (args.shape is None or c.shape.name == args.shape)]
    ok = True
    for cell in cells:
        art = run_cell(cell, multi_pod=args.multipod,
                       measure=not args.specs_only)
        mesh_name = art["mesh"]
        path = os.path.join(args.out, f"{cell.name}.{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        status = art["status"]
        extra = (f" {art['seconds']}s"
                 f" bytes/position={art['per_position_B'] / 2**30:.2f}GiB"
                 f" fits_h100_80g={art['fits_h100_80g']}"
                 if status == "ok" else f" ({art.get('error', '')[:120]})")
        print(f"[dryrun] {cell.name} @ {mesh_name}: {status}{extra}",
              flush=True)
        ok &= status in ("ok", "skip")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
