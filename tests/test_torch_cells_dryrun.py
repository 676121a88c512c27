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
* the collective bytes of the six mini cells and of seven more serving
  cells (the decoders' and one more of each of the ssm, hybrid and
  encdec families), kind by kind, against XLA's (``analyze_text`` of the
  compiled step; a train cell's whole step, the optimizer update
  included, as the port counts it), through a ledger: one move a data
  movement, its port and XLA bytes computed from the config's widths,
  each difference named;
* the artifact's new fields (global and a position's accessed and
  collective bytes, for every cell; a train cell's note of its scope);
* a train cell's FLOPs from one microbatch times ``grad_accum`` equal to
  ``FlopCounterMode``'s count of the whole accumulated step, on reduced
  dense and MoE configs;
* the CLI writes one JSON a cell and exits 0.

JAX's side runs once, in one subprocess with 8 forced host devices.
"""
import json
import math
import os
import subprocess
import sys
from dataclasses import asdict

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.cells import (Cell, batch_struct,
                                      decode_tokens_struct, dryrun_config,
                                      enumerate_cells, model_flops,
                                      serve_batch_struct)
from repro_torch.launch.mesh import FilterMesh
from repro_torch.models import layers as Lyr
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
#: serving cells whose collectives are held against XLA's too: the
#: decoders', and one more of each of the ssm, hybrid and encdec families
SERVE_MINI = [("qwen3-0.6b", "prefill_32k"), ("qwen3-0.6b", "decode_32k"),
              ("qwen3-moe-30b-a3b", "decode_32k"),
              ("deepseek-v3-671b", "decode_32k"),
              ("mamba2-780m", "prefill_32k"), ("zamba2-7b", "prefill_32k"),
              ("whisper-large-v3", "decode_32k")]
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
from repro.launch.hlo_analysis import analyze_text
from repro.models import transformer as T
from repro.models.config import ShapeSpec
from repro.sharding import rules as R
from repro.sharding import mesh_context

mini, spec_archs, meshes, kind, serve_mini = (json.loads(a)
                                              for a in sys.argv[1:6])
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
out["hlo"] = {}
for arch, sname in mini + serve_mini:
    cell = C.Cell(arch, ShapeSpec("mini", 64, 8, kind[sname]), True)
    with mesh_context(mesh):
        cfg, fn, args = D.build_cell(cell, mesh)
        compiled = fn.lower(*args).compile()
        if [arch, sname] in mini:
            out["args"][f"{arch}/{sname}"] = int(
                compiled.memory_analysis().argument_size_in_bytes)
    # a train cell's whole step, the optimizer update included, as the
    # port's dry run counts it
    out["hlo"][f"{arch}/{sname}"] = analyze_text(compiled.as_text())
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
                     MESHES.items()}), json.dumps(KIND),
         json.dumps(SERVE_MINI)],
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


# ---------------------------------------------------------------- ledger
# Every collective of a mini cell's step, as the port's counter and XLA's
# HLO count it: one ``Move`` a data movement, its bytes a position for
# each kind computed from the config's widths on the 4 x 2 mesh.  Where the
# two differ, ``why`` names the difference; the test holds each side's
# sum, kind by kind, equal to its count.  Some differences run through
# every cell and are not repeated in ``why``: XLA's CPU backend gathers
# and sums bfloat16 in float32 (its float normalization), so its bytes of
# the port's bfloat16 weights and activations are twice the port's; a
# gradient the port reduce-scatters to a block's holder (one reduce-scatter
# of ``(DP-1)`` blocks) XLA all-reduces over data whole, in float32 (four
# times the bytes); and the port recomputes a layer, its collectives
# included, where the cell's ``remat`` has XLA recompute it.
DP, MP, B, S = 4, 2, 8, 64     # the mini mesh (data, model) and shape
F32, BF16, I32 = 4, 2, 4


def ag(b, g):
    return C.collective_wire_bytes("all-gather", b, g)


def ar(b, g):
    return C.collective_wire_bytes("all-reduce", b, g)


def a2a(b, g):
    return C.collective_wire_bytes("all-to-all", b, g)


def rs(b, g):
    return C.collective_wire_bytes("reduce-scatter", b, g)


class Move:
    def __init__(self, what: str, port: dict, xla: dict, why: str = ""):
        self.what, self.port, self.xla, self.why = what, port, xla, why

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.what}: port {self.port}, xla {self.xla}"


AG, AR, RS, A2A = "all-gather", "all-reduce", "reduce-scatter", "all-to-all"


def _lookup(cfg, T: int, train: bool, uses: int = 1) -> list:
    """The vocab-parallel embedding (the table is ``("model", "data")``),
    looked up ``uses`` times (MTP looks the shifted tokens up again)."""
    V, d = cfg.vocab_eff, cfg.d_model
    R, tab = B // DP, cfg.vocab_eff // MP * cfg.d_model
    out = [Move(
        "token embedding",
        {AG: uses * ag(tab * BF16, DP), AR: uses * ar(R * T * d * BF16, MP)},
        {AG: uses * (ag(MP * R * T * I32, MP) + ag(B * T * I32, MP)),
         AR: uses * ar(B * T * (d // DP) * F32, MP),
         A2A: uses * a2a(B * T * (d // DP) * F32, DP)},
        "the port reads the table's blocks of its vocabulary and sums its "
        "rows' lookups over model; XLA gathers the int32 token ids over "
        "model, looks up every row's d/D columns, sums them over model and "
        "moves the rows to their data positions by all-to-all")]
    if train:
        out.append(Move(
            "embedding gradient", {RS: uses * ag(tab * BF16, DP)},
            {AR: uses * ar(V * (d // DP) * F32, MP),
             A2A: uses * a2a(B * T * (d // DP) * F32, DP)},
            "XLA moves the rows' cotangents back by all-to-all and sums the "
            "whole vocabulary's gradient of its d/D columns over model"))
    return out


def _unembed(cfg, train: bool, uses: int = 1) -> list:
    """The vocab-parallel unembedding and chunked CE, ``uses`` times (the
    main loss and MTP's)."""
    tab = cfg.vocab_eff // MP * cfg.d_model
    R, C_, nc = B // DP, cfg.ce_chunk, S // cfg.ce_chunk
    if not train:
        return [Move("unembedding table gathered over data",
                     {AG: ag(tab * BF16, DP)}, {AG: ag(tab * F32, DP)})]
    return [
        Move("unembedding table gathered over data",
             {AG: uses * ag(tab * BF16, DP)},
             {AG: uses * (1 + 2 * nc) * ag(tab * F32, DP)},
             "the port reads it once for every CE chunk; XLA gathers it for "
             "the forward and again in each chunk's remat and backward"),
        Move("unembedding gradient", {RS: uses * ag(tab * BF16, DP)},
             {AR: uses * nc * ar(tab * F32, DP)}, "XLA reduces each chunk's"),
        Move("CE max over the vocabulary split, forward and remat",
             {AR: uses * 2 * nc * ar(R * C_ * F32, MP)},
             {AR: uses * 2 * nc * ar(R * C_ * F32, MP)}),
        Move("CE exp-sum and gold-logit sums over the vocabulary split",
             {AR: uses * 6 * nc * ar(R * C_ * F32, MP)},
             {AR: uses * 3 * nc * ar(R * C_ * F32, MP)},
             "the port sums both in the forward and in the remat, and their "
             "cotangents in the backward; XLA recomputes only the exp-sum "
             "and, the cotangents being equal over model, sums none"),
        Move("each CE chunk's loss summed over data", {},
             {AR: nc * ar(F32, DP) + (uses - 1) * nc * ar(2 * F32, DP)},
             "the port adds the data positions' sums on the first "
             "position's device, uncounted; XLA all-reduces them (MTP's "
             "with its mask's sum)")]


def _gqa(cfg, passes: int, train: bool, T: int) -> list:
    """q, k, v and o of every layer, heads over model, d over data."""
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    h = B // DP * T * d
    w = 2 * d * (cfg.n_heads // MP) * dh \
        + 2 * d * (cfg.n_kv_heads // MP) * dh
    out = [Move("attention weights gathered over data",
                {AG: passes * L * ag(w * BF16, DP)},
                {AG: passes * L * ag(w * F32, DP)}),
           Move("attention output summed over model",
                {AR: passes * L * ar(h * BF16, MP)},
                {AR: passes * L * ar(h * F32, MP)})]
    if train:
        out.append(Move("attention weights' gradients",
                        {RS: L * ag(w * BF16, DP)},
                        {AR: L * ar(w * F32, DP)}))
    return out


def _mlp(cfg, L: int, d_ff: int, stacked_over_model: bool, passes: int,
         train: bool, T: int) -> list:
    """SwiGLU ``wi`` (d over data, 2·d_ff over model) and ``wo``: the
    layer stack over model where ``stacked_over_model``, else d over data
    only; ``L`` layers."""
    d = cfg.d_model
    wi = d * 2 * d_ff // MP                   # a position's gate and up
    up = d // DP * (d_ff // MP)               # up half's own-data block
    wo = d_ff // MP * d                       # a layer's d_ff share of wo
    h = B // DP * T * d
    held = L // MP if stacked_over_model else L
    out = [
        Move("MLP wi gathered over data",
             {AG: passes * L * (ag(wi * BF16, DP) + up * BF16)},
             {AG: (passes + train) * L * ag(wi * F32, DP)},
             "the port reads the up half's own-data block from the other "
             "model position, where XLA swaps the halves by "
             "collective-permute, which hlo_analysis counts as 0 for want "
             "of replica groups" + ("; XLA gathers wi again for the "
                                    "backward product" if train else "")),
        Move("MLP output summed over model", {AR: L * ar(h * BF16, MP)},
             {AR: L * ar(h * F32, MP)}, "neither recomputes it")]
    if stacked_over_model:
        out.append(Move(
            "MLP wo, its layers split over model",
            {AG: passes * (held * ag(wo * BF16, DP)
                           + (L - held) * wo * BF16)},
            {AG: (1 + train) * L * ag(wo * F32, DP),
             A2A: (1 + train) * a2a(L * (d_ff // MP) * (d // DP) * F32, MP)},
            "the port reads its d_ff share of each layer from the layer's "
            "holders, the other model position's own-data block too; XLA "
            "reshards the stack to a d_ff split by all-to-all and gathers "
            "each layer over data" + (", in the forward and again for the "
                                      "backward product" if train else "")))
    else:
        out.append(Move("MLP wo gathered over data",
                        {AG: passes * L * ag(wo * BF16, DP)},
                        {AG: (1 + train) * L * ag(wo * F32, DP)},
                        "XLA gathers it for the forward and the backward "
                        "product, not in the remat" if train else ""))
    if train:
        out += [
            Move("MLP wi gradients",
                 {RS: L * (ag(wi * BF16, DP) + up * BF16)},
                 {AR: L * ar(wi * F32, DP),
                  A2A: L * _halves(d, d_ff)},
                 "XLA joins the gate and up halves' cotangents by "
                 "all-to-all; the port reduce-scatters the up half's "
                 "own-data block too"),
            Move("MLP wo gradients",
                 {RS: held * ag(wo * BF16, DP) + (L - held) * wo * BF16}
                 | ({} if stacked_over_model else
                    {AR: L * ar(d_ff // MP * (d // DP) * BF16, MP)}),
                 {AR: L * ar(wo * F32, DP),
                  AG: L * ag(d_ff * (d // DP) * F32, MP)},
                 "XLA gathers each layer's gradient over model into the "
                 "parameter's layout" + ("" if stacked_over_model else
                                         "; the port sums its own block's "
                                         "rows over the block's model "
                                         "replicas"))]
    return out


def _halves(d: int, d_ff: int) -> float:
    """XLA's all-to-alls joining a SwiGLU wi's gate and up cotangents."""
    return 2 * a2a(2 * d * (d_ff // MP) * F32, MP) \
        + a2a(2 * d * d_ff * F32, MP)


def _moe(cfg, L: int, passes: int, train: bool, T: int,
         out_remat: bool = False) -> list:
    """The weights-stationary dispatch (``n <= 2048`` tokens): router
    and ``wi`` cut on d, ``wo`` on d_expert over data, experts over
    model.  ``out_remat``: the port's remat recomputes the output's sum
    (a shared expert's sum follows it)."""
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    n = B * T
    cap = Lyr._ep_capacity(cfg, n)
    wo = E // MP * (fe // DP) * d              # a position's wo rows
    stack = E // MP * fe * (d // DP)           # a layer's wo block
    bwd = 1 if train else 0
    out = [
        Move("MoE tokens to every position's feature slice",
             {AG: passes * L * ag(n * d * BF16, DP)}
             | ({RS: L * rs(B // DP * T * d * BF16, DP)} if train else {}),
             {A2A: (passes + bwd) * L * a2a(n * (d // DP) * F32, DP)}
             | ({AG: L * ag(n * d * F32, DP)} if train else {}),
             "the port gathers every token over data and cuts its feature "
             "slice (and reduce-scatters the cotangents back); XLA moves "
             "the feature slices by all-to-all" + (
                 ", forward, remat and backward, and gathers the tokens "
                 "again for the backward products" if train else "")),
        Move("router: the other model position's experts",
             {AG: passes * L * (d // DP) * (E // MP) * F32}
             | ({RS: L * (d // DP) * (E // MP) * F32} if train else {}),
             {AG: passes * L * ag(d // DP * E * F32, MP)}
             | ({AR: L * ar(d // DP * E * F32, MP)} if train else {}),
             "float32 on both sides" + (
                 "; XLA sums the router's gradient over model" if train
                 else "")),
        Move("router logits summed over data (float32)",
             {AR: (passes + bwd) * L * ar(n * E * F32, DP)},
             {AR: (passes + bwd) * L * ar(n * E * F32, DP)}),
        Move("expert hidden (gate and up) summed over data",
             {AR: (passes + bwd) * L * ar(E // MP * cap * 2 * fe * BF16, DP)},
             {AR: (passes + bwd) * L * ar(E // MP * cap * 2 * fe * F32, DP)}),
        Move("MoE output summed over model and data",
             {AR: (1 + bwd + out_remat) * L * ar(n * d * BF16, DP * MP)},
             {AR: (1 + bwd) * L * ar(n * d * F32, DP * MP)},
             "XLA does not recompute it" + (
                 "; the port's remat does, the shared expert's sum "
                 "following it" if out_remat else "")),
        Move("MoE wo, d_expert rows over data",
             {AG: passes * L * ag(wo * BF16, DP)}
             | ({RS: L * ag(wo * BF16, DP)} if train else {}),
             {A2A: (L * a2a(stack * F32, DP) if not train
                    else 3 * a2a(L * stack * F32, DP))},
             "the port reads its d_expert rows from the blocks' holders "
             "(and reduce-scatters their gradients back); XLA reshards wo "
             "from its d split to the d_expert split by all-to-all" + (
                 ": the stack, forward and backward, and its float32 "
                 "gradient back to the parameter's layout" if train
                 else ""))]
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        wi, wo_s = d * 2 * (fs // MP), fs // MP * d
        out += [Move("shared expert wi and wo gathered over data",
                     {AG: passes * L * (ag(wi * BF16, DP)
                                        + ag(wo_s * BF16, DP))},
                     {AG: passes * L * (ag(wi * F32, DP)
                                        + ag(wo_s * F32, DP))},
                     "XLA gathers wi in the forward and the remat, wo in "
                     "the forward and the backward" if train else ""),
                Move("shared expert output summed over model",
                     {AR: L * ar(B // DP * T * d * BF16, MP)},
                     {AR: L * ar(B // DP * T * d * F32, MP)})]
        if train:
            out.append(Move(
                "shared expert gradients",
                {RS: L * (ag(wi * BF16, DP) + ag(wo_s * BF16, DP)),
                 AR: L * (ar(d // DP * 2 * (fs // MP) * BF16, MP)
                          + ar(fs // MP * (d // DP) * BF16, MP))},
                {AR: L * (ar(wi * F32, DP) + ar(wo_s * F32, DP)),
                 AG: L * (ag(d // DP * 2 * fs * F32, MP)
                          + ag(fs * (d // DP) * F32, MP)),
                 A2A: L * _halves(d, fs)},
                "both are split on d over data only: the port sums its own "
                "block's part over the block's model replicas; XLA "
                "all-reduces its model half over data, gathers it over "
                "model into the parameter's layout, and joins wi's gate "
                "and up halves by all-to-all"))
    return out


def _mla_decode(cfg, L: int) -> list:
    """Absorbed MLA decode over a 64-token cache: heads over model, the
    caches' latent widths over model, the weights' first dimension over
    data."""
    d, H, ql, kvl = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, \
        cfg.kv_lora_rank
    nope, rope, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    R, T, Tc, hm = B // DP, 1, S, cfg.n_heads // MP
    return [
        Move("MLA q down-projection",
             {AG: L * (d * ql - d // DP * (ql // MP)) * BF16},
             {AG: L * (ag(d * (ql // MP) * F32, DP)
                       + ag(R * T * ql * F32, MP))},
             "the port reads the whole of w_dq and computes the whole "
             "latent; XLA computes its model half and gathers the latent "
             "over model"),
        Move("MLA kv down-projection gathered over data",
             {AG: L * ag(d * (kvl + rope) * BF16, DP)},
             {AG: L * ag(d * (kvl + rope) // MP * F32, DP)},
             "XLA computes its model half of the kv latent's columns"),
        Move("MLA w_uq, w_uv and wo gathered over data",
             {AG: L * ag((ql * hm * (nope + rope) + kvl * hm * v
                          + hm * v * d) * BF16, DP)},
             {AG: L * ag((ql * hm * (nope + rope) + kvl * hm * v
                          + hm * v * d) * F32, DP)}),
        Move("MLA w_uk gathered over data",
             {AG: L * ag(kvl * hm * nope * BF16, DP)},
             {AG: L * ag(kvl // MP * hm * nope * F32, DP)},
             "XLA gathers its model half of the latent width"),
        Move("MLA caches: the other model position's latent columns",
             {AG: L * R * Tc * ((kvl + rope) // MP) * BF16},
             {AG: L * ag(R * Tc * (kvl + rope) * F32, MP)}),
        Move("MLA attention probabilities",
             {}, {AG: L * ag(R * H * T * Tc * F32, MP)},
             "XLA splits the scores' latent width over model and gathers "
             "every head's probabilities; the port's heads read the whole "
             "latent"),
        Move("MLA latents' norms", {},
             {AR: L * ar(2 * R * T * F32, MP),
              A2A: L * (2 * a2a(2 * R * T * F32, MP)
                        + a2a(4 * R * T * F32, MP))},
             "XLA sums the split q and kv latents' squares over model and "
             "relays the per-row sums by all-to-all"),
        Move("MLA head and latent relayouts", {},
             {A2A: L * (a2a(DP * R * T * hm * (rope // MP) * F32, DP)
                        + a2a(MP * R * T * hm * (kvl // MP) * F32, MP))},
             "XLA's all-to-alls of its q_rope by data and of the absorbed "
             "output's latent halves"),
        Move("attention output summed over model",
             {AR: L * ar(R * T * d * BF16, MP)},
             {AR: L * ar(R * T * d * F32, MP)})]


def _mla_train(cfg, stacked: int, passes: int) -> list:
    """MLA layers in training: ``stacked`` layers recomputed (``passes``
    forward passes) and one MTP layer computed once."""
    d, ql, kvl = cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    R, T, hm = B // DP, S, cfg.n_heads // MP
    h = R * T * d
    rest = d * (kvl + rope) + ql * hm * (nope + rope) + kvl * hm * nope \
        + kvl * hm * v + hm * v * d       # w_dkv, w_uq, w_uk, w_uv, wo
    dq_port = (d * ql - d // DP * (ql // MP)) * BF16
    layers = stacked + 1
    fwd = stacked * passes + 1                 # forward passes, MTP's too
    bwd_latent = stacked * (passes + 1) + 2    # q latent gathers
    return [
        Move("MLA weights gathered over data",
             {AG: fwd * (dq_port + ag(rest * BF16, DP))},
             {AG: fwd * (ag(d * (ql // MP) * F32, DP)
                         + ag(rest * F32, DP))},
             "the port reads the whole of w_dq and computes the whole q "
             "latent; XLA computes its model half"),
        Move("MLA q latent gathered over model", {},
             {AG: bwd_latent * ag(R * T * ql * F32, MP),
              AR: layers * ar(R * T * ql * F32, MP)},
             "XLA gathers its model halves of the q latent (forward, remat "
             "and backward) and sums the latent's cotangent over model"),
        Move("MLA q latent's norm", {},
             {AR: 4 * layers * ar(R * T * F32, MP)},
             "XLA sums the split q latent's squares over model, four times "
             "a layer (forward, remat and backward, as it schedules them)"),
        Move("attention output summed over model",
             {AR: fwd * ar(h * BF16, MP)}, {AR: fwd * ar(h * F32, MP)}),
        Move("MLA weights' gradients",
             {RS: layers * (dq_port + ag(rest * BF16, DP)),
              AR: layers * ar(d // DP * (kvl + rope) * BF16, MP)},
             {AR: layers * (ar(d * (ql // MP) * F32, DP)
                            + ar(rest * F32, DP))
              - ar(d // MP * (kvl + rope) * F32, DP)},
             "w_dkv is split on d over data only: the port sums its own "
             "block's gradient over the block's model replicas, XLA over "
             "data whole, but for the prefix layer's, which it keeps split "
             "over model and moves to the parameter's layout by "
             "collective-permute (counted as 0)")]


def _deepseek_train(cfg) -> list:
    """deepseek-v3's mini train step: one dense prefix layer, one MoE
    layer (recomputed), one MTP layer (MLA, dense MLP; computed once),
    the main and MTP losses."""
    d, ql, kvl, rope = cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank, \
        cfg.qk_rope_dim
    R, T = B // DP, S
    h, n = R * T * d, B * S
    nc, C_ = S // cfg.ce_chunk, cfg.ce_chunk
    ff = cfg.dense_d_ff
    wi, wo = d * 2 * ff // MP, ff // MP * d
    proj = 2 * d * d                            # mtp/proj, (data, model)
    return (
        _lookup(cfg, T, True, uses=2) + _unembed(cfg, True, uses=2)
        + _mla_train(cfg, 2, 2)
        + _mlp(cfg, 1, ff, False, 2, True, T)
        + _moe(cfg, 1, 2, True, T, out_remat=True)
        + [
            Move("MTP loss mask gathered over data", {},
                 {AG: ag(B * T * 1, DP)},
                 "XLA gathers every row's (boolean) mask"),
            Move("MTP projection",
                 {AG: (proj - 2 * d // DP * (d // MP)) * BF16,
                  RS: (proj - 2 * d // DP * (d // MP)) * BF16},
                 {AG: ag(2 * d * (d // MP) * F32, DP),
                  AR: ar(2 * d * (d // MP) * F32, DP)},
                 "the port reads the whole projection; XLA computes its "
                 "model half of the output columns"),
            Move("MTP activations gathered over model", {},
                 {AG: 6 * ag(h * F32, MP),
                  AR: ar(R * T * (kvl + rope) * F32, MP)},
                 "XLA keeps the MTP layer's activations split on d over "
                 "model after the projection and gathers them (three times "
                 "forward, three backward), summing the kv latent of the "
                 "split input over model"),
            Move("MTP MLP",
                 {AG: ag(wi * BF16, DP) + d // DP * (ff // MP) * BF16
                  + ag(wo * BF16, DP),
                  AR: ar(h * BF16, MP)},
                 {AG: 2 * ag(wi * F32, DP) + ag(ff * d * F32, DP),
                  AR: ar(h * F32, MP)},
                 "computed once; XLA gathers wi again for the backward "
                 "product and gathers the whole of wo"),
            Move("MTP MLP gradients",
                 {RS: ag(wi * BF16, DP) + d // DP * (ff // MP) * BF16
                  + ag(wo * BF16, DP),
                  AR: ar(ff // MP * (d // DP) * BF16, MP)},
                 {AR: ar(wi * F32, DP) + ar(wo * F32, DP),
                  AG: ag(ff * (d // DP) * F32, MP),
                  A2A: _halves(d, ff)}),
            _residual_cotangents(
                cfg, 8,
                2 * nc * ar(R * C_ * d * F32, MP)       # both unembeddings
                + 4 * ar(h * F32, MP)  # prefix and MTP MLPs, shared, MoE
                + ar(R * T * 2 * d * F32, MP)           # MTP projection
                + 3 * ar((h + R * T * (2 * kvl + rope)) * F32, MP)),
            Move("norm scales' gradients",
                 {AR: 7 * ar(d * BF16, DP * MP) + 2 * ar(d * BF16, DP * MP)
                  + 3 * ar(ql * BF16, DP * MP) + 3 * ar(kvl * BF16, DP * MP)},
                 {AR: 7 * ar(d * F32, DP) + 2 * ar(d // MP * F32, DP)
                  + 3 * ar(kvl * F32, DP) + 3 * ar(ql // MP * F32, DP),
                  AG: 2 * ag(d * F32, MP) + 3 * ag(ql * F32, MP)},
                 "the port sums each scale's gradient over its DP·MP "
                 "holders; XLA sums over data, the prefix layer's ln1 and "
                 "ln2 and every q-norm at their model halves, which it "
                 "gathers over model")])


def _norms(cfg) -> Move:
    """The replicated norm scales' gradients (ln1, ln2 a layer, the final
    norm, q/k-norm where the config has it)."""
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    qk = 2 * L if cfg.qk_norm else 0
    return Move(
        "norm scales' gradients",
        {AR: (2 * L + 1) * ar(d * BF16, DP * MP)
         + qk * ar(dh * BF16, DP * MP)},
        {AR: 2 * L * ar(d * F32, DP) + ar(d * F32, DP)
         + qk * (ar(dh * F32, MP) + ar(dh * F32, DP))},
        "the port sums each scale's gradient over its DP·MP holders; XLA "
        "sums ln1's, ln2's and the final norm's over data (their cotangents "
        "are summed over model already), q/k-norm's over model and then "
        "over data")


def _residual_cotangents(cfg, port_sums: int, xla: float) -> Move:
    h = B // DP * S * cfg.d_model
    return Move(
        "cotangents summed over model in the backward pass",
        {AR: port_sums * ar(h * BF16, MP)}, {AR: xla},
        "the port sums at each forward sum's transpose (the embedding "
        "rows', and each layer's sums); XLA at each column-parallel input: "
        "the unembedding's, attention's (q, k and v apart; MLA's input "
        "with its kv latent's parts), the MLP's, the MoE's and MTP's "
        "projection's")


# ------------------------------------------------------ the optimizer update
# A train cell's step ends in the gradient norm (the ``grad_norm`` metric,
# and AdamW's clip: two) and the optimizer's update, whose sums over a
# leaf's blocks fold blocks held at other positions.  The port counts a
# fold as one all-reduce of its result over the positions holding the
# blocks it folds; XLA all-reduces over each mesh axis that splits them,
# one after the other.
SIZES = {"data": DP, "model": MP}


def _leaf_axes(cfg) -> list:
    """(path, shape, the axes each dimension is split over) of every
    parameter on the mini mesh."""
    mesh = meta_mesh((DP, MP), ("data", "model"))
    params = T.init_model(cfg, None)
    specs = R.param_specs(cfg, params, mesh)
    out = []
    for (path, leaf), (_, spec) in zip(
            tree_flatten_with_path(params),
            tree_flatten_with_path(specs, is_leaf=R.is_spec)):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        axes = [() if e is None else (e if isinstance(e, tuple) else (e,))
                for e in spec]
        out.append(("/".join(map(str, path)), tuple(leaf.shape), axes))
    return out


def _fold(b: float, axes) -> tuple[float, float]:
    """(port, XLA) all-reduce bytes of a fold of ``b`` bytes over the
    blocks split along ``axes``."""
    flat = [a for ax in axes for a in ax]
    return (ar(b, math.prod(SIZES[a] for a in flat)),
            sum(ar(b, SIZES[a]) for a in flat))


def _norms_moves(cfg, norms: int) -> Move:
    port = xla = 0.0
    for _, _, axes in _leaf_axes(cfg):
        p, x = _fold(F32, axes)
        port, xla = port + norms * p, xla + norms * x
    return Move("gradient norm's square sums"
                + (" (the metric's and the clip's)" if norms == 2 else ""),
                {AR: port}, {AR: xla},
                "a float32 scalar a leaf split over the mesh (see above)")


def _ada_folds(shape, axes, vr_mean: bool = True) -> list:
    """(bytes, axes) of Adafactor's folds of a leaf whose dimensions are
    split over ``axes``: the row sums (over the last dimension), the
    column sums and the row statistic's mean (over the one before), the
    update's RMS (a scalar over every split)."""
    block = [n // math.prod(SIZES[a] for a in ax)
             for n, ax in zip(shape, axes)]
    every = tuple(a for ax in axes for a in ax)
    out = []
    if len(shape) >= 2:
        out += [(math.prod(block[:-1]) * F32, axes[-1]),
                (math.prod(block[:-2] + block[-1:]) * F32, axes[-2])]
        if vr_mean:
            out.append((math.prod(block[:-2]) * F32, axes[-2]))
    return out + [(F32, every)]


def _sides(folds) -> tuple[float, float]:
    port = xla = 0.0
    for b, axes in folds:
        p, x = _fold(b, (axes,))
        port, xla = port + p, xla + x
    return port, xla


#: deepseek-v3's leaves whose float32 gradient XLA's step keeps in another
#: layout than the parameter's (the gradient ledger names each): the axes
#: of that layout, a dimension each, with the gathers of its statistics
#: back into the optimizer state's layout
_M, _D = ("model",), ("data",)


def _adafactor(cfg) -> list:
    port = xla = 0.0
    moved = {"port": 0.0, AR: 0.0, AG: 0.0}
    E, fe, d = cfg.n_experts, cfg.d_expert, cfg.d_model
    for path, shape, axes in _leaf_axes(cfg):
        p, x = _sides(_ada_folds(shape, axes))
        xla_axes, vr_mean, gathers = None, True, 0.0
        if path in ("prefix_layers/ln1/scale", "prefix_layers/ln2/scale",
                    "prefix_layers/attn/q_norm/scale",
                    "layers/attn/q_norm/scale",
                    "mtp/layer/attn/q_norm/scale"):
            xla_axes = [()] * (len(shape) - 1) + [_M]
            gathers = ag(shape[-1] * F32, MP)
        elif path == "layers/moe/shared/wi":
            xla_axes, gathers = [(), _D, _M], ag(shape[-1] * F32, MP)
        elif path in ("layers/moe/shared/wo", "prefix_layers/mlp/wo"):
            xla_axes, vr_mean = [(), _M, _D], False
            gathers = ag(shape[-2] * F32, MP)
        elif path == "mtp/layer/mlp/wo":
            xla_axes, gathers = [_M, _D], ag(shape[-2] * F32, MP)
        elif path == "layers/moe/wo":
            xla_axes = [(), _M, _D, ()]
            gathers = ag(E // MP * fe * F32, DP) + ag(E // MP * d * F32, DP)
        if xla_axes is None:
            port, xla = port + p, xla + x
            continue
        _, x = _sides(_ada_folds(shape, xla_axes, vr_mean))
        # the norm's square sum too: in that layout, not the parameter's
        moved["port"] += p
        moved[AR] += x + _fold(F32, xla_axes)[1] - _fold(F32, axes)[1]
        moved[AG] += gathers
    return [
        Move("Adafactor's row, column, row-mean and update-RMS sums",
             {AR: port}, {AR: xla}, "each a fold over the blocks that "
             "split a leaf's dimensions (see above)"),
        Move("Adafactor's sums of the gradients XLA keeps in another "
             "layout", {AR: moved["port"]}, {AR: moved[AR], AG: moved[AG]},
             "the norm scales at their model halves, the shared expert's "
             "and the MLPs' wo with d_ff over model, the MoE wo with "
             "d_expert over data: XLA sums their statistics (and their "
             "square sums for the norm) in that layout, takes the stacked "
             "wo's row mean after gathering the statistic, and gathers "
             "the statistics into the optimizer state's layout")]


# ------------------------------------------------ ssm, hybrid, encdec serving
# A decode step's row-parallel products (attention's and the MLP's ``wo``,
# Mamba2's ``out_proj``) part the two sides: the port reads its rows of the
# weight from their holders and sums its partial output over model, where
# XLA, at one token a row, keeps the weight's blocks in place, gathers every
# row's input over data, sums its d/D columns over model and moves the rows
# back to their data positions by all-to-all.  A prefill's XLA gathers the
# weight too.  XLA's scan over the hybrid's layers counts the shared
# attention block's ``lax.cond`` at every layer (``hlo_analysis`` takes a
# conditional's costlier branch once a trip); the block runs after every
# ``hybrid_period``-th.


def _mask(T: int) -> Move:
    return Move("the lookup's in-range mask", {},
                {AG: ag(B * T * 1, DP)},
                "XLA gathers every row's boolean mask over data")


def _row_parallel(what: str, cfg, L_port: int, L_xla: int, k: int, T: int,
                  stacked: bool = False) -> Move:
    """A product whose input is split over model, ``k`` columns a
    position, and whose weight ``(k, d)`` a position is split on d over
    data (``stacked``: the layer stack over model, so the port reads the
    other model position's layers from their holders whole)."""
    d, R = cfg.d_model, B // DP
    w = k * d
    held = L_port // MP if stacked else L_port
    port = {AG: held * ag(w * BF16, DP) + (L_port - held) * w * BF16,
            AR: L_port * ar(R * T * d * BF16, MP)}
    if T == 1:
        xla = {AG: L_xla * ag(B * T * k * F32, DP),
               AR: L_xla * ar(B * T * (d // DP) * F32, MP),
               A2A: L_xla * a2a(B * T * (d // DP) * F32, DP)}
    else:
        xla = {AG: L_xla * ag(w * F32, DP),
               AR: L_xla * ar(R * T * d * F32, MP)}
    if stacked:
        xla[A2A] = xla.get(A2A, 0) + a2a(L_port * k * (d // DP) * F32, MP)
    return Move(what, port, xla, "a row-parallel product (see above)" + (
        "; its layers split over model: XLA reshards the stack to a d_ff "
        "split by all-to-all" if stacked else ""))


def _attn_serve(cfg, L_port: int, L_xla: int, T: int, what: str,
                kv: bool = True) -> list:
    """q (and k, v) of its heads gathered over data, and ``wo``."""
    d, dh = cfg.d_model, cfg.d_head
    w = d * (cfg.n_heads // MP) * dh \
        + (2 * d * (cfg.n_kv_heads // MP) * dh if kv else 0)
    return [Move(f"{what}: q" + (", k, v" if kv else "")
                 + " gathered over data",
                 {AG: L_port * ag(w * BF16, DP)},
                 {AG: L_xla * ag(w * F32, DP)},
                 "" if kv else "a decode step reads the keys and values the "
                 "prefill cached: neither side projects them"),
            _row_parallel(f"{what}: wo", cfg, L_port, L_xla,
                          (cfg.n_heads // MP) * dh, T)]


def _mlp_serve(cfg, L_port: int, L_xla: int, T: int, what: str,
               gelu: bool, stacked: bool = False) -> list:
    d, f = cfg.d_model, cfg.d_ff
    if gelu:
        wi = Move(f"{what}: wi gathered over data",
                  {AG: L_port * ag(d * (f // MP) * BF16, DP)},
                  {AG: L_xla * ag(d * (f // MP) * F32, DP)})
    else:
        wi = Move(f"{what}: wi gathered over data",
                  {AG: L_port * (ag(d * 2 * (f // MP) * BF16, DP)
                                 + d // DP * (f // MP) * BF16)},
                  {AG: L_xla * ag(d * 2 * (f // MP) * F32, DP)},
                  "the port reads the up half's own-data block from the "
                  "other model position, where XLA swaps the halves by "
                  "collective-permute (counted as 0)")
    return [wi, _row_parallel(f"{what}: wo", cfg, L_port, L_xla, f // MP,
                              T, stacked)]


def _mamba_serve(cfg, L: int, T: int) -> list:
    """Mamba2's layers: SSM heads and d_inner over model, B and C whole."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN, R, K = cfg.ssm_groups * cfg.ssm_state, B // DP, cfg.ssm_conv
    zx_dt = d * (di // MP) * 2 + d * (H // MP)
    return [
        Move("Mamba2 B and C projections",
             {AG: 2 * L * ag(d * GN * BF16, DP)},
             {AG: 2 * L * ag(d * (GN // MP) * F32, DP)},
             "the port reads them whole (every head reads B and C whole); "
             "XLA computes its model half of their columns"),
        Move("Mamba2 z/x and dt projections gathered over data",
             {AG: L * ag(zx_dt * BF16, DP)}, {AG: L * ag(zx_dt * F32, DP)}),
        Move("Mamba2 B and C at every head", {},
             {AG: 2 * L * ag(R * T * GN * F32, MP),
              A2A: L * (2 * a2a(R * T * (GN // MP) * F32, MP)
                        + a2a(R * T * GN * F32, MP))},
             "XLA gathers its halves of B and C over model, and relays them "
             "into conv_bc's channel split by all-to-all"),
        Move("Mamba2 conv_bc state: the other model position's channels",
             {AG: L * R * (K - 1) * (2 * GN // MP) * BF16}, {},
             "cache_specs split conv_bc's channels over model and the port "
             "convolves B and C whole; XLA convolves in its own layout"),
        Move("Mamba2 gated norm's sum of squares over model",
             {AR: L * ar(R * T * F32, MP)}, {AR: L * ar(R * T * F32, MP)}),
        _row_parallel("Mamba2 out_proj", cfg, L, L, di // MP, T)]


def _family_serve(arch: str, sname: str, cfg) -> list:
    """A serving step of the ssm, hybrid or encdec family."""
    T = 1 if KIND[sname] == "decode" else S
    out = _lookup(cfg, T, False) + [_mask(T)] + _unembed(cfg, False)
    if cfg.family in ("ssm", "hybrid"):
        out += _mamba_serve(cfg, cfg.n_layers, T)
    if cfg.family == "hybrid":
        inv = cfg.n_layers // cfg.hybrid_period
        out += (_attn_serve(cfg, inv, cfg.n_layers, T, "shared attention")
                + _mlp_serve(cfg, inv, cfg.n_layers, T, "shared MLP",
                             gelu=False))
    if cfg.family == "encdec":
        L, Le, Tenc = cfg.n_layers, cfg.n_enc_layers, cfg.frontend_len
        if T > 1:
            out += (_attn_serve(cfg, Le, Le, Tenc, "encoder attention")
                    + _mlp_serve(cfg, Le, Le, Tenc, "encoder MLP", gelu=True,
                                 stacked=True))
        out += (_attn_serve(cfg, L, L, T, "self-attention")
                + _attn_serve(cfg, L, L, T, "cross-attention", kv=T > 1)
                + _mlp_serve(cfg, L, L, T, "decoder MLP", gelu=True,
                             stacked=True))
    return out


def ledger(arch: str, sname: str, cfg) -> list:
    """Every collective of the mini cell's step (see above); a train
    cell's is the whole step's, the gradient norm and the optimizer's
    update after ``grads_and_metrics``, XLA's too."""
    L, d = cfg.n_layers, cfg.d_model
    h = B // DP * S * d
    nc, C_ = S // cfg.ce_chunk, cfg.ce_chunk
    kind = KIND[sname]
    train = kind == "train"
    T = 1 if kind == "decode" else S
    passes = 2 if train else 1                 # forward and remat
    if arch == "qwen3-0.6b":
        out = (_lookup(cfg, T, train) + _unembed(cfg, train)
               + _gqa(cfg, passes, train, T)
               + _mlp(cfg, L, cfg.d_ff, True, passes, train, T))
        if train:
            out += [_residual_cotangents(
                        cfg, 2 * L + 1,
                        3 * L * ar(h * F32, MP) + L * ar(h * F32, MP)
                        + nc * ar(B // DP * C_ * d * F32, MP)),
                    _norms(cfg), _norms_moves(cfg, 2)]
        return out
    if arch == "qwen3-moe-30b-a3b":
        out = (_lookup(cfg, T, train) + _unembed(cfg, train)
               + _gqa(cfg, passes, train, T)
               + _moe(cfg, L, passes, train, T))
        if train:
            stack = cfg.n_experts // MP * cfg.d_expert * (d // DP)
            out += [_residual_cotangents(
                        cfg, L + 1,
                        3 * L * ar(h * F32, MP)
                        + L * ar(B * S * (d // DP) * F32, MP)
                        + nc * ar(B // DP * C_ * d * F32, MP)),
                    _norms(cfg), _norms_moves(cfg, 2),
                    Move("MoE wo gradient back for the update", {},
                         {A2A: a2a(L * stack * F32, DP)},
                         "XLA reshards the float32 gradient of its d_expert "
                         "split to the parameter's d split once more, for "
                         "the update")]
        return out
    if arch == "deepseek-v3-671b" and train:
        return (_deepseek_train(cfg) + [_norms_moves(cfg, 1)]
                + _adafactor(cfg))
    if arch == "deepseek-v3-671b":
        k = cfg.dense_prefix
        return (_lookup(cfg, T, False) + _unembed(cfg, False)
                + _mla_decode(cfg, L)
                + _mlp(cfg, k, cfg.dense_d_ff, False, 1, False, T)
                + _moe(cfg, L - k, 1, False, T))
    if cfg.family in ("ssm", "hybrid", "encdec") and not train:
        return _family_serve(arch, sname, cfg)
    raise KeyError(f"no ledger for {arch}/{sname}")


def mini_art(arch, sname):
    cell = Cell(arch, ShapeSpec("mini", 64, 8, KIND[sname]), True)
    return D.run_cell(cell, multi_pod=False, cfg=tiny_config(arch),
                      mesh=meta_mesh((4, 2), ("data", "model")))


@pytest.mark.parametrize("arch,sname", MINI + SERVE_MINI)
def test_collective_bytes_against_xla(jax_side, arch, sname):
    """The cell's :func:`ledger`: its moves' port bytes sum, kind by kind,
    to the port's count a position, and their XLA bytes to XLA's count a
    device (``analyze_text`` of the compiled step; a train cell's whole
    step, the optimizer update included), so that each difference is a
    named move."""
    art = mini_art(arch, sname)
    assert art["status"] == "ok", art.get("traceback")
    xla = jax_side["hlo"][f"{arch}/{sname}"]["collective_breakdown"]
    port = art["collective_breakdown_per_position"]
    moves = ledger(arch, sname, tiny_config(arch))
    for kind in C.COLLECTIVES:
        assert sum(m.port.get(kind, 0) for m in moves) \
            == port.get(kind, 0.0), (kind, port, moves)
        assert sum(m.xla.get(kind, 0) for m in moves) \
            == xla.get(kind, 0.0), (kind, xla, moves)
    assert art["collective_bytes_per_position"] == sum(port.values())


@pytest.mark.parametrize("arch,sname", MINI + SERVE_MINI)
def test_new_artifact_fields(arch, sname):
    """Every cell, train or serving of every family, carries the accessed
    and collective bytes, global (a position's times the chips) and a
    position's; the accessed bytes are at least the position's argument
    shards."""
    art = mini_art(arch, sname)
    if KIND[sname] == "train":
        assert art["collective_note"] == D.TRAIN_NOTE
    else:
        assert "collective_note" not in art
    assert art["bytes_accessed"] == 8 * art["bytes_accessed_per_position"]
    assert art["collective_bytes"] == 8 * art["collective_bytes_per_position"]
    assert art["collective_breakdown"] == {
        k: 8 * v for k, v in art["collective_breakdown_per_position"].items()}
    assert art["collective_bytes_per_position"] > 0
    assert art["bytes_accessed_per_position"] >= art["argument_B"]


def test_cli_counts_a_decoder_serving_cell(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
    decode_32k`` on the production mesh (256 meta positions, counted as
    the first position's view) writes the accessed and collective bytes;
    so do mamba2's decode cell and zamba2's ``long_500k`` (one row: the
    context-parallel layout, its attention's partials combined over
    data)."""
    for arch, shape in (("qwen3-0.6b", "decode_32k"),
                        ("mamba2-780m", "decode_32k"),
                        ("zamba2-7b", "long_500k")):
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", arch, "--shape", shape, "--out",
            str(tmp_path)])
        with pytest.raises(SystemExit) as e:
            D.main()
        assert e.value.code == 0
        art = json.load(open(tmp_path / f"{arch}__{shape}.pod16x16.json"))
        assert art["status"] == "ok" and art["chips"] == 256
        assert art["collective_bytes"] > 0 and art["bytes_accessed"] > 0
        assert set(art["collective_breakdown"]) >= {"all-gather",
                                                    "all-reduce"}
        assert "collective_note" not in art
