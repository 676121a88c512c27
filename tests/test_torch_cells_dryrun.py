"""The port's cell table and meta-device dry run against the JAX
package's.

* ``enumerate_cells`` (40 cells, the same skips), ``dryrun_config``
  (every field) and ``model_flops`` for every cell, and the input
  stand-ins' shapes and dtypes (``batch_struct``, ``serve_batch_struct``,
  ``decode_tokens_struct``: meta tensors here, ``ShapeDtypeStruct``\\ s
  there);
* ``opt_state_specs`` entry for entry, AdamW and Adafactor (factored
  ``vr``/``vc``), for full-size and reduced configs on a 4 x 2 and a
  2 x 2 x 2 (pod) mesh;
* the argument bytes a position of the five mini cells of
  ``tests/test_sharding_and_dryrun.py::test_mini_dryrun_lowers`` and the
  deepseek-v3 train cell, against XLA's ``argument_size_in_bytes`` of
  the JAX dry run's jitted step compiled on a 4 x 2 Auto-axes mesh:
  equal, byte for byte, but for the arguments the compiled step never
  reads, which ``jax.jit`` prunes (``keep_unused=False``) and the port
  counts: the decode position of an SSM model (mamba2's decode reads no
  position) and, in an encoder-decoder prefill, the encoder output and
  the cross-attention caches (whisper's prefill writes them before any
  read); each such term is computed from its specs and named;
* a train cell's FLOPs from one microbatch times ``grad_accum`` equal to
  ``FlopCounterMode``'s count of the whole accumulated step, on reduced
  dense and MoE configs;
* the CLI writes one JSON a cell and exits 0.

JAX's side runs once, in one subprocess with 8 forced host devices.
"""
import json
import os
import subprocess
import sys
from dataclasses import asdict

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.cells import (Cell, batch_struct,
                                      decode_tokens_struct, dryrun_config,
                                      enumerate_cells, model_flops,
                                      serve_batch_struct)
from repro_torch.launch.mesh import FilterMesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import rules as R
from repro_torch.train.train_step import grads_and_metrics
from repro_torch.tree import tree_flatten_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MINI = [("qwen3-0.6b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k"),
        ("mamba2-780m", "decode_32k"), ("whisper-large-v3", "prefill_32k"),
        ("zamba2-7b", "long_500k"), ("deepseek-v3-671b", "train_4k")]
KIND = dict(train_4k="train", prefill_32k="prefill", decode_32k="decode",
            long_500k="decode")
#: (arch, reduced) whose optimizer-state specs are compared
SPEC_ARCHS = [("qwen3-0.6b", False), ("deepseek-v3-671b", False),
              ("qwen3-moe-30b-a3b", True), ("mamba2-780m", False)]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX = r'''
import json, sys
from dataclasses import asdict
import jax
from jax.sharding import AxisType, PartitionSpec as P
jax.devices()                  # the device count, before the dry run's import
from repro.configs import get_config
from repro.launch import cells as C
from repro.launch import dryrun as D
from repro.models import transformer as T
from repro.models.config import ShapeSpec
from repro.sharding import rules as R
from repro.sharding import mesh_context

mini, spec_archs, meshes, kind = (json.loads(a) for a in sys.argv[1:5])
out = {"cells": [], "configs": {}, "specs": {}, "args": {}}

def entry(e):
    return list(e) if isinstance(e, tuple) else e

for cell in C.enumerate_cells():
    cfg = C.dryrun_config(cell.arch)
    shape = cell.shape
    structs = {"batch": C.batch_struct(cfg, shape),
               "serve": C.serve_batch_struct(cfg, shape),
               "decode": {"tokens": C.decode_tokens_struct(shape)}}
    out["cells"].append({
        "name": cell.name, "runnable": cell.runnable,
        "skip": cell.skip_reason, "model_flops": C.model_flops(cfg, shape),
        "structs": {k: {n: [list(v.shape), str(v.dtype)]
                        for n, v in s.items()} for k, s in structs.items()}})
for arch in {c.split("__")[0] for c in [x["name"] for x in out["cells"]]}:
    out["configs"][arch] = asdict(C.dryrun_config(arch))

for mname, (shape, axes) in meshes.items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))
    for arch, reduced in spec_archs:
        cfg = get_config(arch, reduced=reduced)
        params = jax.eval_shape(lambda c=cfg: T.init_model(
            c, jax.random.PRNGKey(0)))
        pspecs = R.param_specs(cfg, params, mesh)
        for opt in ("adamw", "adafactor"):
            s = D.opt_state_specs(opt, params, pspecs, mesh)
            leaves = jax.tree_util.tree_flatten_with_path(
                s, is_leaf=lambda x: isinstance(x, P))[0]
            out["specs"][f"{mname}/{arch}/{reduced}/{opt}"] = [
                ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path), [entry(e) for e in v]]
                for path, v in leaves]

def tiny_config(arch, pad_heads_to=2):
    return get_config(arch, reduced=True).with_(
        param_dtype="bfloat16", activ_dtype="bfloat16",
        pad_heads_to=pad_heads_to, remat=True, grad_accum=1,
        attn_chunk=16, ce_chunk=32)
D.dryrun_config = tiny_config
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for arch, sname in mini:
    cell = C.Cell(arch, ShapeSpec("mini", 64, 8, kind[sname]), True)
    with mesh_context(mesh):
        cfg, fn, args = D.build_cell(cell, mesh)
        mem = fn.lower(*args).compile().memory_analysis()
    out["args"][f"{arch}/{sname}"] = int(mem.argument_size_in_bytes)
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-c", _JAX, json.dumps(MINI),
         json.dumps(SPEC_ARCHS),
         json.dumps({k: [list(v[0]), list(v[1])] for k, v in
                     MESHES.items()}), json.dumps(KIND)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def meta_mesh(shape, axes) -> FilterMesh:
    def grid(dims):
        return "meta" if not dims else [grid(dims[1:])
                                        for _ in range(dims[0])]
    return FilterMesh(grid(tuple(shape)), axis_names=axes)


def test_cells_equal_jax(jax_side):
    cells = enumerate_cells()
    assert len(cells) == 40 == len(jax_side["cells"])
    assert sum(not c.runnable for c in cells) == 8
    for cell, want in zip(cells, jax_side["cells"]):
        assert cell.name == want["name"]
        assert cell.runnable == want["runnable"]
        assert cell.skip_reason == want["skip"]


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_config_and_model_flops_equal_jax(jax_side, arch):
    got = asdict(dryrun_config(arch))
    assert got == jax_side["configs"][arch]
    for cell, want in zip(enumerate_cells(), jax_side["cells"]):
        if cell.arch == arch:
            assert model_flops(dryrun_config(arch), cell.shape) \
                == want["model_flops"], cell.name


def test_input_structs_equal_jax(jax_side):
    for cell, want in zip(enumerate_cells(), jax_side["cells"]):
        cfg = dryrun_config(cell.arch)
        got = {"batch": batch_struct(cfg, cell.shape),
               "serve": serve_batch_struct(cfg, cell.shape),
               "decode": {"tokens": decode_tokens_struct(cell.shape)}}
        for k, tree in got.items():
            assert all(v.device.type == "meta" for v in tree.values())
            assert {n: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                    for n, v in tree.items()} == want["structs"][k], \
                (cell.name, k)


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch,reduced", SPEC_ARCHS)
def test_opt_state_specs_equal_jax(jax_side, arch, reduced, mname, opt):
    mesh = meta_mesh(*MESHES[mname])
    cfg = get_config(arch, reduced=reduced)
    params = T.init_model(cfg, None)
    specs = D.opt_state_specs(opt, params, R.param_specs(cfg, params, mesh),
                              mesh)
    got = [["/".join(map(str, path)), [_entry(e) for e in v]]
           for path, v in tree_flatten_with_path(specs, is_leaf=R.is_spec)]
    assert got == jax_side["specs"][f"{mname}/{arch}/{reduced}/{opt}"]


def tiny_config(arch):
    return get_config(arch, reduced=True).with_(
        param_dtype="bfloat16", activ_dtype="bfloat16", pad_heads_to=2,
        remat=True, grad_accum=1, attn_chunk=16, ce_chunk=32)


def unread_by_xla(cell, cfg) -> int:
    """Bytes a position of the arguments XLA prunes from the compiled
    step, unread: an SSM decode's position scalar; an encoder-decoder
    prefill's ``enc_out`` and cross-attention ``k``/``v``."""
    mesh = meta_mesh((4, 2), ("data", "model"))
    _, args = D.build_cell(cell, mesh, cfg)
    if cell.shape.kind == "decode" and cfg.family == "ssm":
        return D.shard_bytes(*args["step"], mesh)
    if cell.shape.kind == "prefill" and cfg.family == "encdec":
        caches, specs = args["caches"]
        return (D.shard_bytes(caches["enc_out"], specs["enc_out"], mesh)
                + D.shard_bytes(caches["dec"]["cross"],
                                specs["dec"]["cross"], mesh))
    return 0


@pytest.mark.parametrize("arch,sname", MINI)
def test_argument_bytes_equal_xla(jax_side, arch, sname):
    """One position's shards of every argument of the jitted step, as
    XLA's ``memory_analysis().argument_size_in_bytes``."""
    cell = Cell(arch, ShapeSpec("mini", 64, 8, KIND[sname]), True)
    art = D.run_cell(cell, multi_pod=False, cfg=tiny_config(arch),
                     mesh=meta_mesh((4, 2), ("data", "model")))
    assert art["status"] == "ok", art.get("traceback")
    assert art["argument_B"] - unread_by_xla(cell, tiny_config(arch)) \
        == jax_side["args"][f"{arch}/{sname}"]
    assert art["flops"] > 0 and art["flops_per_position"] == art["flops"] / 8
    if KIND[sname] == "train":
        assert art["saved_B_estimate"] > 0
        assert art["per_position_B"] == (art["argument_B"] + art["grad_B"]
                                         + art["saved_B_estimate"])
    assert art["fits_h100_80g"]


@pytest.mark.parametrize("arch,ga", [("qwen3-0.6b", 4),
                                     ("qwen3-moe-30b-a3b", 2)])
def test_train_flops_one_microbatch_times_grad_accum(arch, ga):
    cfg = tiny_config(arch).with_(grad_accum=ga)
    shape = ShapeSpec("mini", 32, 8, "train")
    art = D.run_cell(Cell(arch, shape, True), multi_pod=False, cfg=cfg,
                     mesh=meta_mesh((2, 2), ("data", "model")))
    counter = FlopCounterMode(display=False)
    with counter:
        grads_and_metrics(cfg, T.init_model(cfg, None),
                          batch_struct(cfg, shape))
    assert art["flops"] == float(counter.get_total_flops()) > 0


def test_production_meshes_specs_only():
    """Every cell at both production meshes, specs only: argument bytes a
    position for the runnable cells, the skip for the others."""
    rows = [D.run_cell(c, multi_pod=mp, measure=False)
            for c in enumerate_cells() for mp in (False, True)]
    assert len(rows) == 80
    assert {r["status"] for r in rows} == {"ok", "skip"}
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 64 and all(r["argument_B"] > 0 for r in ok)
    # a position of the 512-chip mesh holds no more than one of 256's
    by = {(r["cell"], r["chips"]): r["argument_B"] for r in ok}
    assert all(by[c, 512] <= by[c, 256] for c, n in by if n == 256)


def test_cli_writes_a_json_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "mamba2-780m", "--specs-only", "--out",
        str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        D.main()
    assert e.value.code == 0
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 4 and all(f.endswith(".pod16x16.json")
                                   for f in files)
    art = json.load(open(tmp_path / files[0]))
    assert art["status"] == "ok" and art["estimate"] == "specs"
    assert art["h100_bytes"] == D.H100_80G_BYTES


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b",
                                  "whisper-large-v3"])
def test_placed_family_bytes_equal_the_dry_run(arch):
    """The ssm, hybrid and encdec families' trees placed on a 2 x 2 grid of
    the CPU device as the sharded step places them (parameters by the
    rule shardings, AdamW's state by ``opt_state_specs``) and a batch of
    the dry run's dtypes (whisper's ``frames`` bfloat16): the bytes a
    position, the batch's rows included, equal the dry run's argument
    bytes less the step scalar."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.placement import NamedSharding, device_put
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map_with_path

    cfg = get_config(arch, reduced=True)
    mesh = make_host_mesh(2, devices=["cpu"] * 4)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    shapes = T.init_model(cfg, None)
    pspecs = R.param_specs(cfg, shapes, mesh)

    def named(specs):
        return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs,
                                  is_leaf=R.is_spec)
    opt = make_optimizer(cfg.optimizer)
    placed = (device_put(params, named(pspecs)),
              device_put(opt.init(params), named(D.opt_state_specs(
                  cfg.optimizer, shapes, pspecs, mesh))))
    first = mesh.positions()[0]
    got = sum(x.shards[first].numel() * x.shards[first].element_size()
              for x in tree_leaves(placed))
    shape = ShapeSpec("mini", 16, 4, "train")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in batch_struct(cfg, shape).items()}
    assert set(batch) == ({"tokens", "labels", "frames"}
                          if cfg.family == "encdec" else {"tokens", "labels"})
    rows = shape.global_batch // mesh.shape["data"]
    got += sum(rows * v[0].numel() * v.element_size() for v in batch.values())
    want = D.cell_bytes(Cell(arch, shape, True), mesh, cfg)
    assert want["step"] == 4
    assert got == want["argument_B"] - want["step"]
