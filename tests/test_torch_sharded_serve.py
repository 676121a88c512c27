"""The port's partitioned prefill and decode steps
(``repro_torch.serve.sharded_step``) against its one-device steps and
against the JAX package's steps jitted with shardings.

Reduced qwen3-0.6b (dense), qwen3-moe-30b-a3b (expert parallel: a
64-token prefill and every decode step take the weights-stationary
dispatch, a 2,080-token prefill the shard-map dispatch),
deepseek-v3-671b (MLA's ``c_kv``/``k_rope`` cache, a dense prefix, a
shared expert) and internvl2-76b (the VLM's patches), float32, 2
layers, parameters placed by ``param_specs`` and float32 caches by
``cache_specs``:

* on 2 x 2, (4, 1) and (2, 2, 2)-with-``"pod"`` grids of the CPU
  device, a prefill and 4 decode steps against the port's one-device
  ``prefill``/``decode_step`` on the same tokens: each step's logits
  within 1e-5 of the largest, and the gathered caches within 1e-5 of
  theirs after each step.  The MoE cases take ``capacity_factor`` 4, so
  neither dispatch drops an assignment, as the one-device path's larger
  capacity drops none;
* on a 2 x 2 grid, against the JAX dry run's jitted steps
  (``src/repro/launch/dryrun.py:build_cell``'s prefill and decode
  functions with their ``in_shardings``, executed on real arrays on an
  Auto-axes 2 x 2 mesh of forced host devices): logits within 1e-4,
  caches within 1e-5; ``qwen3-moe-drops`` (the published capacity, a
  128-token prefill whose dispatch drops assignments, so that its logits
  part from the one-device step's) is held to JAX only, whose
  expert-parallel dispatch drops the same ones.

The ssm, hybrid and encdec families and the context-parallel layout:
``tests/test_torch_sharded_serve_families.py``.

JAX's side runs once, in one subprocess with 8 forced host devices.
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
from repro_torch.launch.mesh import FilterMesh, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.sharded_step import (decode_step_sharded,
                                            prefill_sharded)
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import (NamedSharding, PlacedTensor,
                                            device_put, gather)
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_map_with_path)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ONE_TOL, JAX_LOGIT_TOL, JAX_CACHE_TOL = 1e-5, 1e-4, 1e-5
DECODE_STEPS = 4
#: name -> (arch, overrides, rows, prompt tokens, the prefill's dispatch)
CASES = {
    "qwen3-0.6b": ("qwen3-0.6b", {}, 4, 16, None),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {"capacity_factor": 4.0},
                          4, 16, "stationary"),
    "qwen3-moe-shardmap": ("qwen3-moe-30b-a3b", {"capacity_factor": 4.0},
                           4, 520, "shardmap"),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"capacity_factor": 4.0},
                         4, 16, "stationary"),
    "internvl2-76b": ("internvl2-76b", {}, 4, 16, None),
}
#: the published capacity: the 128-token prefill drops assignments
DROPS = {"qwen3-moe-drops": ("qwen3-moe-30b-a3b", {}, 4, 32, "stationary")}
ALL = {**CASES, **DROPS}
GRIDS = ("2x2", "4x1", "pod")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(name: str) -> dict:
    """The prompt (and a VLM's patches) and the decode steps' tokens."""
    arch, over, b, s, _ = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (DECODE_STEPS, b, 1)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def max_len(name: str) -> int:
    return ALL[name][3] + DECODE_STEPS


_JAX = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
jax.devices()                  # the device count, before the dry run's import
from repro.configs import get_config
from repro.launch import cells as C
from repro.launch import dryrun as D
from repro.models import transformer as T
from repro.models.config import ShapeSpec
from repro.sharding import mesh_context

cases, in_npz, out_npz, steps = (json.loads(sys.argv[1]), sys.argv[2],
                                 sys.argv[3], int(sys.argv[4]))
inp = np.load(in_npz)
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)

def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

for name, (arch, over, b, s, max_len) in cases.items():
    cfg = get_config(arch, reduced=True, **over)
    D.dryrun_config = lambda _a, c=cfg: c
    params = jax.jit(T.init_model, static_argnums=0)(cfg,
                                                     jax.random.PRNGKey(0))
    out.update(flat(params, f"{name}/params/"))
    batch = {k: jnp.asarray(inp[f"{name}/{k}"]) for k in ("tokens", "patches")
             if f"{name}/{k}" in inp.files}
    with mesh_context(mesh):
        _, prefill, _ = D.build_cell(
            C.Cell(arch, ShapeSpec("mini", max_len, b, "prefill"), True), mesh)
        _, decode, _ = D.build_cell(
            C.Cell(arch, ShapeSpec("mini", max_len, b, "decode"), True), mesh)
        caches = T.init_cache(cfg, b, max_len, dtype=jnp.float32)
        logits, caches = prefill(params, batch, caches)
        out[f"{name}/logits0"] = np.asarray(logits)
        out.update(flat(caches, f"{name}/caches0/"))
        off = cfg.frontend_len if cfg.family == "vlm" else 0
        for i in range(steps):
            tok = jnp.asarray(inp[f"{name}/steps"][i])
            logits, caches = decode(params, tok, caches,
                                    jnp.int32(off + s + i))
            out[f"{name}/logits{i + 1}"] = np.asarray(logits)
            out.update(flat(caches, f"{name}/caches{i + 1}/"))
np.savez(out_npz, **out)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's parameters of each case and its jitted sharded steps'
    logits and caches."""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    np.savez(tmp / "in.npz", **{f"{name}/{k}": v for name in ALL
                                for k, v in inputs(name).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    spec = {name: [a, over, b, s, max_len(name)]
            for name, (a, over, b, s, _) in ALL.items()}
    r = subprocess.run([sys.executable, "-c", _JAX, json.dumps(spec),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        str(DECODE_STEPS)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


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


def make_grid(gname: str) -> FilterMesh:
    if gname == "pod":
        return FilterMesh([[["cpu"] * 2] * 2] * 2,
                          axis_names=("pod", "data", "model"))
    data, model = map(int, gname.split("x"))
    return make_host_mesh(model, devices=["cpu"] * (data * model))


def named(mesh, specs):
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs,
                              is_leaf=R.is_spec)


def rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(want)
    return float((got - want).abs().max() / want.abs().max())


def run_sharded(cfg, params, name: str, mesh, taken: list | None = None):
    """The prompt's prefill and the decode steps on ``mesh``: each step's
    logits and gathered caches."""
    x = inputs(name)
    b = x["tokens"].shape[0]
    caches = T.init_cache(cfg, b, max_len(name), dtype=torch.float32)
    pl = device_put(params, named(mesh, R.param_specs(
        cfg, T.init_model(cfg, None), mesh)))
    pc = device_put(caches, named(mesh, R.cache_specs(cfg, caches, mesh)))
    layout = [x.sharding for x in tree_leaves(pc)]
    batch = {k: x[k] for k in ("tokens", "patches") if k in x}
    logits, out = prefill_sharded(cfg, pl, batch, pc, mesh)
    assert out is pc
    got = [(logits, [gather(c) for c in tree_leaves(pc)])]
    off = cfg.frontend_len if cfg.family == "vlm" else 0
    s = x["tokens"].shape[1]
    for i in range(DECODE_STEPS):
        logits, out = decode_step_sharded(cfg, pl, x["steps"][i], pc,
                                          off + s + i, mesh)
        got.append((logits, [gather(c) for c in tree_leaves(pc)]))
    assert [x.sharding for x in tree_leaves(out)] == layout
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves(out))
    return got


def run_one_device(cfg, params, name: str):
    x = inputs(name)
    b = x["tokens"].shape[0]
    caches = T.init_cache(cfg, b, max_len(name), dtype=torch.float32)
    batch = {k: torch.as_tensor(x[k]) for k in ("tokens", "patches")
             if k in x}
    with torch.no_grad():
        logits, caches = T.prefill(cfg, params, batch, caches)
        got = [(logits, [c.clone() for c in tree_leaves(caches)])]
        off = cfg.frontend_len if cfg.family == "vlm" else 0
        s = x["tokens"].shape[1]
        for i in range(DECODE_STEPS):
            logits, caches = T.decode_step(
                cfg, params, torch.as_tensor(x["steps"][i]), caches,
                off + s + i)
            got.append((logits, [c.clone() for c in tree_leaves(caches)]))
    return got


def build(jax_side, name: str):
    arch, over, *_ = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    return cfg, model_params_from_numpy(
        cfg, nested(jax_side, f"{name}/params/"), "cpu")


def branches(monkeypatch) -> list:
    taken = []
    for fn in ("_ep_stationary_parts", "_ep_shardmap_parts"):
        def wrap(*a, _f=getattr(L, fn), _n=fn, **k):
            taken.append(_n.split("_")[2])
            return _f(*a, **k)
        monkeypatch.setattr(L, fn, wrap)
    return taken


@pytest.mark.parametrize("gname", GRIDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_one_device(jax_side, monkeypatch, name,
                                            gname):
    cfg, params = build(jax_side, name)
    want = run_one_device(cfg, params, name)
    taken = branches(monkeypatch)
    got = run_sharded(cfg, params, name, make_grid(gname))
    for i, ((lg, caches), (wl, wc)) in enumerate(zip(got, want)):
        assert lg.shape == wl.shape
        assert rel(lg, wl) <= ONE_TOL, (i, rel(lg, wl))
        for c, w in zip(caches, wc):
            assert rel(c, w) <= ONE_TOL, i
    dispatch = ALL[name][4]
    if dispatch is not None:
        layers = T.n_stacked(params["layers"])
        assert taken[:layers] == [dispatch] * layers
        assert set(taken[layers:]) == {"stationary"}   # the decode steps


@pytest.mark.parametrize("name", list(ALL))
def test_sharded_serving_matches_jax(jax_side, name):
    cfg, params = build(jax_side, name)
    got = run_sharded(cfg, params, name, make_grid("2x2"))
    names = ["/".join(map(str, p)) for p, _ in tree_flatten_with_path(
        T.init_cache(cfg, 1, 1, device="meta"))]
    for i, (lg, caches) in enumerate(got):
        want = jax_side[f"{name}/logits{i}"]
        assert rel(lg, want) <= JAX_LOGIT_TOL, (i, rel(lg, want))
        for key, c in zip(names, caches):
            w = jax_side[f"{name}/caches{i}/{key}"]
            assert rel(c, w) <= JAX_CACHE_TOL, (i, key, rel(c, w))


def test_the_drops_case_drops(jax_side):
    """The published capacity drops assignments in the prefill's
    dispatch: the logits part from the one-device step's, whose capacity
    (128 slots an expert) drops none."""
    cfg, params = build(jax_side, "qwen3-moe-drops")
    got = run_sharded(cfg, params, "qwen3-moe-drops", make_grid("2x2"))
    want = run_one_device(cfg, params, "qwen3-moe-drops")
    assert rel(got[0][0], want[0][0]) > 1e-3
