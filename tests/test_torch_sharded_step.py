"""The port's sharded train step (``make_train_step`` on a tree placed on
a mesh) against its one-device step and against the JAX package's step
jitted with shardings.

Reduced qwen3-0.6b, qwen1.5-110b (biases), starcoder2-7b (GELU),
qwen3-moe (expert parallel), deepseek-v3 (MLA, a dense prefix, a shared
expert, MTP, Adafactor) and internvl2 (the VLM prefix) run on a 2 x 2
grid (``make_host_mesh(2, devices=["cpu"] * 4)``) and a (4, 1) grid of
the CPU device, parameters placed by ``param_shardings`` and the
optimizer state by the dry run's ``opt_state_specs``:

* against the port's one-device step: the loss within 1e-6 relative,
  the gathered gradients within ``rtol=1e-4, atol=1e-6``, the updates
  from the same gradients within 1.2e-7, then a second step's loss; the
  step returns the placed trees with their shardings unchanged.  The
  MoE cases are drop-free: 8 tokens take the weights-stationary
  dispatch, whose capacity (8) no expert can pass, and 2,080 tokens with
  ``capacity_factor=4`` take the shard-map dispatch, whose per-shard
  capacity equals the shard's tokens;
* against JAX's ``jit(make_train_step(cfg, opt), in_shardings=...,
  out_shardings=...)`` on an Auto-axes mesh of the same shape (two
  steps): each step's loss and gradient norm within 1e-5 relative (the
  bound of ``tests/test_torch_train.py``), the optimizer state after
  the first step (AdamW's first moment is 0.1 times the clipped
  gradient) within ``rtol=1e-4, atol=1e-7``, Adafactor's factored second
  moments within ``rtol=1e-3`` and 1e-5 of the leaf's largest (they
  square the gradient, and a gradient that is rounding noise, as the
  key bias's, squares to noise); where EP
  drops tokens (16 tokens a row at the default capacity), JAX's step is
  the only reference, with the bounds of ``tests/test_moe_ep.py``: the
  loss within 1e-4, the first moment within 1e-5 of its largest.

Also: ``grad_accum=2`` with a row share that does not divide (dense, and
the shard-map dispatch, which then takes JAX's even token share), the int8
compressor on placed gradients, the placed bytes a position equal to
the dry run's argument bytes, and ``NotImplementedError`` (ROADMAP item
14h) for mamba2, zamba2 and whisper on a grid, which run on a 1 x 1 mesh.

JAX's side runs once, in two subprocesses at a time with 8 forced host
devices; every port parameter is JAX's initialisation carried over.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import dryrun as D
from repro_torch.launch.cells import Cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import (NamedSharding, PlacedTensor,
                                            device_put, gather, holders)
from repro_torch.train import make_optimizer, make_train_step
from repro_torch.train.compression import make_error_feedback_compressor
from repro_torch.train.train_step import grads_and_metrics
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                               tree_map_with_path)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LOSS_RTOL, GRAD_TOL, UPDATE_TOL = 1e-6, dict(rtol=1e-4, atol=1e-6), 1.2e-7
JAX_LOSS_RTOL = 1e-5
GRIDS = {"2x2": (2, 2), "4x1": (4, 1)}
#: name -> (arch, overrides, batch rows, tokens a row); drop-free
CASES = {
    "qwen3-0.6b": ("qwen3-0.6b", {}, 4, 16),
    "qwen1.5-110b": ("qwen1.5-110b", {}, 4, 16),
    "starcoder2-7b": ("starcoder2-7b", {}, 4, 16),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}, 2, 4),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}, 2, 4),
    "internvl2-76b": ("internvl2-76b", {}, 4, 16),
    "qwen3-moe-shardmap": ("qwen3-moe-30b-a3b", {"capacity_factor": 4.0},
                           4, 520),
}
BRANCH = {"qwen3-moe-30b-a3b": "stationary", "deepseek-v3-671b": "stationary",
          "qwen3-moe-shardmap": "shardmap"}
#: EP drops tokens here: held against JAX's sharded step only
DROPS = {"qwen3-moe-drops": ("qwen3-moe-30b-a3b", {}, 4, 16)}
ALL = {**CASES, **DROPS}
#: (case, grid) pairs JAX runs, in two groups run side by side
JAX_GROUPS = (
    [("qwen3-0.6b", "2x2"), ("qwen3-0.6b", "4x1"), ("qwen1.5-110b", "2x2"),
     ("starcoder2-7b", "2x2"), ("internvl2-76b", "2x2")],
    [("qwen3-moe-30b-a3b", "2x2"), ("deepseek-v3-671b", "2x2"),
     ("qwen3-moe-shardmap", "2x2"), ("qwen3-moe-drops", "2x2")],
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: on a loaded machine
    (the suite's other workers) a parallel region waits on its slowest
    thread, which can stretch each small op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(name: str) -> list[dict]:
    arch, over, b, s = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


_JAX_STEP = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
jax.devices()                  # the device count, before the dry run's import
from repro.configs import get_config
from repro.launch.dryrun import opt_state_specs
from repro.models import transformer as T
from repro.sharding import mesh_context
from repro.sharding import rules as R
from repro.train.optimizer import make_optimizer
from repro.train.train_step import make_train_step

cases, grids, in_npz, out_npz = (json.loads(sys.argv[1]), json.loads(
    sys.argv[2]), sys.argv[3], sys.argv[4])
inp = np.load(in_npz)
out = {}

def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

for name, grid in cases:
    arch, over = json.loads(sys.argv[5])[name]
    cfg = get_config(arch, reduced=True, **over)
    mesh = jax.make_mesh(tuple(grids[grid]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    params = jax.jit(T.init_model, static_argnums=0)(cfg,
                                                     jax.random.PRNGKey(0))
    out.update(flat(params, f"{name}/params/"))
    opt = make_optimizer(cfg.optimizer)
    pspecs = R.param_specs(cfg, params, mesh)

    def named(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    bs = [{k.split("/")[-1]: jnp.asarray(inp[k]) for k in inp.files
           if k.startswith(f"{name}/b{i}/")} for i in range(2)]
    osh = named(opt_state_specs(cfg.optimizer, params, pspecs, mesh))
    step = jax.jit(make_train_step(cfg, opt),
                   in_shardings=(named(pspecs), osh,
                                 named(R.batch_specs(cfg, bs[0], mesh)),
                                 NamedSharding(mesh, P())),
                   out_shardings=(named(pspecs), osh, None))
    state = opt.init(params)
    tag = f"{name}@{grid}"
    with mesh_context(mesh):
        for i in range(2):
            params, state, m = step(params, state, bs[i], jnp.int32(i))
            for k, v in m.items():
                out[f"{tag}/metrics{i}/{k}"] = np.asarray(v)
            if i == 0:
                out.update(flat(state, f"{tag}/state0/"))
np.savez(out_npz, **out)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's parameters of each case and its sharded step's results."""
    tmp = tmp_path_factory.mktemp("sharded_step")
    inp = {f"{name}/b{i}/{k}": v for name in ALL
           for i, b in enumerate(batches(name)) for k, v in b.items()}
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    spec = json.dumps({k: [v[0], v[1]] for k, v in ALL.items()})
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_STEP, json.dumps(group),
         json.dumps(GRIDS), str(tmp / "in.npz"), str(tmp / f"out{g}.npz"),
         spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for g, group in enumerate(JAX_GROUPS)]
    out = {}
    for g, p in enumerate(procs):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        with np.load(tmp / f"out{g}.npz") as z:
            out.update({k: z[k] for k in z.files})
    return out


def nested(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def build(jax_side, name: str):
    """(cfg, a fresh copy of the case's parameters on the CPU)."""
    arch, over, _, _ = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    return cfg, model_params_from_numpy(
        cfg, nested(jax_side, f"{name}/params/"), "cpu")


def grid(shape) -> object:
    data, model = shape
    return make_host_mesh(model, devices=["cpu"] * (data * model))


def named(mesh, specs):
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs,
                              is_leaf=R.is_spec)


def place(cfg, params, state, mesh, opt_name):
    """The parameters by ``param_shardings``, the state by
    ``opt_state_specs`` (its ``compression`` part as the parameters)."""
    pspecs = R.param_specs(cfg, T.init_model(cfg, None), mesh)
    osh = named(mesh, D.opt_state_specs(opt_name, params, pspecs, mesh))
    if "compression" in state:
        osh["compression"] = {"ef": tree_leaves(named(mesh, pspecs),
                                                is_leaf=lambda x: isinstance(
                                                    x, NamedSharding))}
    return device_put(params, named(mesh, pspecs)), device_put(state, osh)


def clone(tree):
    return tree_map_with_path(lambda _, x: x.clone(), tree)


def max_diff(placed, plain) -> float:
    return max(float((gather(a) - b).abs().max())
               for a, b in zip(tree_leaves(placed), tree_leaves(plain)))


def same_layout(before: list, after) -> None:
    """Every leaf still placed with its sharding, and every holder of a
    block holding the same values."""
    leaves = tree_leaves(after)
    assert len(leaves) == len(before)
    for (shape, sharding), leaf in zip(before, leaves):
        assert isinstance(leaf, PlacedTensor)
        assert leaf.sharding == sharding and tuple(leaf.shape) == shape
        ref = gather(leaf)
        for idx in sharding.mesh.positions():
            assert torch.equal(
                leaf.shards[idx], ref[sharding.slices(leaf.shape, idx)])


def layout(tree) -> list:
    return [(tuple(x.shape), x.sharding) for x in tree_leaves(tree)]


@pytest.mark.parametrize("gname", list(GRIDS))
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device(jax_side, monkeypatch, name, gname):
    cfg, params = build(jax_side, name)
    mesh = grid(GRIDS[gname])
    opt = make_optimizer(cfg.optimizer)
    b0, b1 = batches(name)
    taken = []
    for fn in ("_ep_stationary_parts", "_ep_shardmap_parts"):
        def wrap(*a, _f=getattr(L, fn), _n=fn, **k):
            taken.append(_n.split("_")[2])
            return _f(*a, **k)
        monkeypatch.setattr(L, fn, wrap)

    one, one_state = clone(params), opt.init(params)
    pl, pl_state = place(cfg, clone(params), opt.init(params), mesh,
                         cfg.optimizer)
    before = layout((pl, pl_state))
    g1, m1 = grads_and_metrics(cfg, one, b0)
    g2, m2 = grads_and_metrics(cfg, pl, b0)
    assert set(taken) <= {BRANCH.get(name)}
    if name in BRANCH:
        assert taken and set(taken) == {BRANCH[name]}
    for k in m1:
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=LOSS_RTOL)
    for (path, want), got in zip(tree_flatten_with_path(g1),
                                 tree_leaves(g2)):
        np.testing.assert_allclose(gather(got).numpy(), want.numpy(),
                                   err_msg=str(path), **GRAD_TOL)
    # the updates from the same (gathered) gradients
    opt.update(tree_map_with_path(lambda _, g: gather(g), g2), one_state,
               one, 0)
    opt.update(g2, pl_state, pl, 0)
    assert max_diff(pl, one) <= UPDATE_TOL
    assert max_diff(pl_state, one_state) <= UPDATE_TOL
    same_layout(before, (pl, pl_state))
    # a second step through the step function itself
    _, _, s1 = make_train_step(cfg, opt)(one, one_state, b1, np.int32(1))
    out = make_train_step(cfg, opt)(pl, pl_state, b1, np.int32(1))
    assert out[0] is pl and out[1] is pl_state
    same_layout(before, out[:2])
    for k in s1:
        assert float(out[2][k]) == pytest.approx(float(s1[k]),
                                                 rel=10 * LOSS_RTOL)


JAX_CASES = [c for group in JAX_GROUPS for c in group]


@pytest.mark.parametrize("name,gname", JAX_CASES)
def test_sharded_step_matches_jax(jax_side, name, gname):
    cfg, params = build(jax_side, name)
    mesh = grid(GRIDS[gname])
    opt = make_optimizer(cfg.optimizer)
    pl, state = place(cfg, params, opt.init(params), mesh, cfg.optimizer)
    step = make_train_step(cfg, opt)
    tag = f"{name}@{gname}"
    drops = name in DROPS
    for i, b in enumerate(batches(name)):
        pl, state, m = step(pl, state, b, np.int32(i))
        for k, v in m.items():
            want = float(jax_side[f"{tag}/metrics{i}/{k}"])
            if drops and k != "grad_norm":
                assert abs(float(v) - want) <= 1e-4, (k, i)
            elif not drops:
                assert float(v) == pytest.approx(want, rel=JAX_LOSS_RTOL), \
                    (k, i)
        if i:
            continue
        want = nested(jax_side, f"{tag}/state0/")
        got = {key: gather(x).numpy() for key, x in (
            ("/".join(map(str, p)), x) for p, x in tree_flatten_with_path(
                state))}
        for key, w in ((k, v) for k, v in _flat(want).items()):
            if drops:
                if key.startswith("m/"):
                    assert np.abs(got[key] - w).max() <= 1e-5 * max(
                        np.abs(w).max(), 1e-30), key
            elif key.startswith("m/"):
                np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-7,
                                           err_msg=key)
            elif key.startswith("stats/"):
                np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=key)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


UNEVEN = {"qwen3-0.6b": ("qwen3-0.6b", 17),
          # 3 rows of 1,040 tokens a microbatch: the shard-map dispatch,
          # its tokens split evenly over the data shards as JAX's are
          "qwen3-moe-shardmap": ("qwen3-moe-shardmap", 1041)}


@pytest.mark.parametrize("gname", list(GRIDS))
@pytest.mark.parametrize("name", list(UNEVEN))
def test_grad_accum_with_an_uneven_row_share(jax_side, name, gname):
    """6 rows in 2 microbatches: 3 rows each over 2 data positions (2 and
    1) or over 4 (1, 1, 1, 0)."""
    cfg, params = build(jax_side, UNEVEN[name][0])
    cfg = cfg.with_(grad_accum=2)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab, (6, UNEVEN[name][1])).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mesh = grid(GRIDS[gname])
    g1, m1 = grads_and_metrics(cfg, clone(params), batch)
    pl, _ = place(cfg, clone(params), make_optimizer("adamw").init(params),
                  mesh, "adamw")
    g2, m2 = grads_and_metrics(cfg, pl, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                              rel=LOSS_RTOL)
    for want, got in zip(tree_leaves(g1), tree_leaves(g2)):
        np.testing.assert_allclose(gather(got).numpy(), want.numpy(),
                                   **GRAD_TOL)


def test_int8_compressor_on_placed_gradients(jax_side):
    """The per-tensor scale is the maximum over the leaf's blocks: the
    codes and the error feedback equal the one-device compressor's on
    the gathered gradients; the steps' losses agree."""
    cfg, params = build(jax_side, "qwen3-0.6b")
    mesh = grid(GRIDS["2x2"])
    opt = make_optimizer("adamw")
    init, compress = make_error_feedback_compressor()
    b0, b1 = batches("qwen3-0.6b")
    one = clone(params)
    one_state = {**opt.init(one), "compression": init(one)}
    pl, pl_state = place(cfg, clone(params), {**opt.init(params),
                                              "compression": init(params)},
                         mesh, "adamw")
    g2, _ = grads_and_metrics(cfg, pl, b0)
    plain = tree_map_with_path(lambda _, g: gather(g), g2)
    want, want_state = compress(plain, {"compression": {
        "ef": [e.clone() for e in one_state["compression"]["ef"]]}})
    got, got_state = compress(g2, pl_state)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(gather(a), b)
    for a, b in zip(got_state["compression"]["ef"],
                    want_state["compression"]["ef"]):
        assert torch.equal(gather(a), b)
    step = make_train_step(cfg, opt, compress)
    pl, pl_state = place(cfg, clone(params), {**opt.init(params),
                                              "compression": init(params)},
                         mesh, "adamw")
    for i, b in enumerate((b0, b1)):
        one, one_state, m1 = step(one, one_state, b, np.int32(i))
        pl, pl_state, m2 = step(pl, pl_state, b, np.int32(i))
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                                  rel=10 * LOSS_RTOL)
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves(pl_state))


@pytest.mark.parametrize("gname", list(GRIDS))
def test_placed_bytes_equal_the_dry_run(jax_side, gname):
    """The placed tree's bytes a position (parameters, AdamW state, the
    batch's rows) equal the dry run's argument bytes for the mesh and
    shape, less the step scalar."""
    cfg, params = build(jax_side, "qwen3-0.6b")
    mesh = grid(GRIDS[gname])
    pl, state = place(cfg, params, make_optimizer("adamw").init(params),
                      mesh, "adamw")
    b0 = batches("qwen3-0.6b")[0]
    rows = b0["tokens"].shape[0] // (GRIDS[gname][0])
    first = mesh.positions()[0]
    got = sum(x.shards[first].numel() * x.shards[first].element_size()
              for x in tree_leaves((pl, state)))
    got += sum(rows * v[0].nbytes for v in b0.values())
    shape = ShapeSpec("mini", b0["tokens"].shape[1], b0["tokens"].shape[0],
                      "train")
    want = D.cell_bytes(Cell("qwen3-0.6b", shape, True), mesh, cfg)
    assert got == want["argument_B"] - want["step"]
    assert want["step"] == 4


OTHERS = ("mamba2-780m", "zamba2-7b", "whisper-large-v3")


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_raise_on_a_grid_and_run_on_1x1(arch):
    cfg = get_config(arch, reduced=True)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(cfg, opt)
    pl, st = place(cfg, clone(params), opt.init(params), grid((2, 2)),
                   cfg.optimizer)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14h"):
        step(pl, st, batch, np.int32(0))
    one = clone(params)
    _, _, want = step(one, opt.init(one), batch, np.int32(0))
    pl, st = place(cfg, clone(params), opt.init(params), grid((1, 1)),
                   cfg.optimizer)
    pl, st, got = step(pl, st, batch, np.int32(0))
    assert float(got["loss"]) == float(want["loss"])
    assert max_diff(pl, one) == 0.0
    assert all(len(holders(x)) == 1 for x in tree_leaves(pl))
