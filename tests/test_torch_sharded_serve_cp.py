"""The port's partitioned prefill and decode steps under the
context-parallel layout with MLA and MoE layers
(``repro_torch.serve.sharded_step``): one row, which the data positions
do not divide, so ``cache_specs`` splits the caches' time axis over
``"data"`` and every data position computes every row.

Reduced deepseek-v3-671b (its dense MLA prefix layer, then an MLA layer
with a MoE feed-forward and a shared expert; ``c_kv``/``k_rope`` caches
of 16 split into time blocks of 8) and reduced qwen3-moe-30b-a3b (two
MoE layers; ``k``/``v`` caches split over time), float32, parameters
placed by ``param_specs`` and float32 caches by ``cache_specs``:

* deepseek: decode steps in the first time block after a 3-token prompt
  (the second holds no valid key), and in the second after a 10-token
  prompt that filled both: MLA attended block by block, the prefill in
  the expanded ``k_nope``/``v_full`` form, the decode steps in the
  absorbed form (``w_uv`` after the blocks combine);
* qwen3-moe: a 4-token prompt, whose MoE layers take the
  weights-stationary dispatch, and a 2,176-token prompt (more than the
  2,048 tokens of the stationary dispatch, even over the data
  positions), whose layers take the shard-map dispatch, each data
  position its even share of the row's tokens; the decode steps take the
  stationary one.  ``capacity_factor`` 4 drops no assignment on either
  side, so the steps hold to the one-device steps;
* the same 2,176-token prompt at the published ``capacity_factor``
  (1.25), whose shard-map dispatch drops assignments: held to JAX's
  jitted step alone, as the one-device path has another capacity.

Each step's logits are held within 1e-5 of the largest to the port's
one-device ``prefill``/``decode_step`` (and the gathered caches within
1e-5) on 2 x 2, (4, 1) and (2, 2, 2)-with-``"pod"`` grids of the CPU
device, and to the JAX dry run's jitted steps (``build_cell``'s prefill
and decode functions on an Auto-axes 2 x 2 mesh of forced host devices)
within 1e-4 (caches 1e-5).  Writes stay local: a decode step changes
the caches at its own time step only, the other time block not at all.

JAX's side runs once, in one subprocess with 8 forced host devices;
every port parameter is JAX's initialisation carried over.
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
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.sharded_step import (decode_step_sharded,
                                            prefill_sharded)
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import PlacedTensor, device_put, gather
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from test_torch_sharded_serve import branches, make_grid, named, nested, rel
from test_torch_sharded_serve_families import _JAX, _times_but

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ONE_TOL, JAX_LOGIT_TOL, JAX_CACHE_TOL = 1e-5, 1e-4, 1e-5
DECODE_STEPS = 4
#: name -> (arch, overrides, rows, prompt tokens, cache length, the
#: prefill's MoE dispatch)
CASES = {
    "deepseek-cp-first": ("deepseek-v3-671b", {}, 1, 3, 16, "stationary"),
    "deepseek-cp-second": ("deepseek-v3-671b", {}, 1, 10, 16, "stationary"),
    "qwen3-moe-cp-stationary": ("qwen3-moe-30b-a3b",
                                {"capacity_factor": 4.0}, 1, 4, 16,
                                "stationary"),
    "qwen3-moe-cp-shardmap": ("qwen3-moe-30b-a3b", {"capacity_factor": 4.0},
                              1, 2176, 2304, "shardmap"),
}
#: the published capacity: the shard-map prefill drops assignments
DROPS = {"qwen3-moe-cp-drops": ("qwen3-moe-30b-a3b", {}, 1, 2176, 2304,
                                "shardmap")}
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
    """The prompt and the decode steps' tokens."""
    arch, over, b, s, *_ = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "steps": rng.integers(0, cfg.vocab, (DECODE_STEPS, b, 1)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's parameters of each case and its jitted sharded steps' logits
    and caches."""
    tmp = tmp_path_factory.mktemp("sharded_serve_cp")
    np.savez(tmp / "in.npz", **{f"{name}/{k}": v for name in ALL
                                for k, v in inputs(name).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    spec = {name: [a, over, b, s, t] for name, (a, over, b, s, t, _)
            in ALL.items()}
    r = subprocess.run([sys.executable, "-c", _JAX, json.dumps(spec),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        str(DECODE_STEPS)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def build(jax_side, name: str):
    arch, over, *_ = ALL[name]
    cfg = get_config(arch, reduced=True, **over)
    return cfg, model_params_from_numpy(
        cfg, nested(jax_side, f"{name}/params/"), "cpu")


def place(cfg, params, name: str, mesh):
    """The parameters and fresh float32 caches placed on ``mesh``."""
    _, _, b, _, max_len, _ = ALL[name]
    caches = T.init_cache(cfg, b, max_len, dtype=torch.float32)
    pl = device_put(params, named(mesh, R.param_specs(
        cfg, T.init_model(cfg, None), mesh)))
    pc = device_put(caches, named(mesh, R.cache_specs(cfg, caches, mesh)))
    return pl, pc


def run_sharded(cfg, params, name: str, mesh, after=None):
    """The prompt's prefill and the decode steps on ``mesh``: each step's
    logits and gathered caches; ``after(i, pc)`` runs after step ``i``
    (0: the prefill)."""
    x = inputs(name)
    pl, pc = place(cfg, params, name, mesh)
    layout = [c.sharding for c in tree_leaves(pc)]
    logits, out = prefill_sharded(cfg, pl, {"tokens": x["tokens"]}, pc, mesh)
    assert out is pc
    got = [(logits, [gather(c) for c in tree_leaves(pc)])]
    if after:
        after(0, pc)
    s = x["tokens"].shape[1]
    for i in range(DECODE_STEPS):
        logits, out = decode_step_sharded(cfg, pl, x["steps"][i], pc, s + i,
                                          mesh)
        got.append((logits, [gather(c) for c in tree_leaves(pc)]))
        if after:
            after(i + 1, pc)
    assert [c.sharding for c in tree_leaves(out)] == layout
    assert all(isinstance(c, PlacedTensor) for c in tree_leaves(out))
    return got


def run_one_device(cfg, params, name: str):
    x = inputs(name)
    _, _, b, s, max_len, _ = ALL[name]
    caches = T.init_cache(cfg, b, max_len, dtype=torch.float32)
    with torch.no_grad():
        logits, caches = T.prefill(cfg, params,
                                   {"tokens": torch.as_tensor(x["tokens"])},
                                   caches)
        got = [(logits, [c.clone() for c in tree_leaves(caches)])]
        for i in range(DECODE_STEPS):
            logits, caches = T.decode_step(
                cfg, params, torch.as_tensor(x["steps"][i]), caches, s + i)
            got.append((logits, [c.clone() for c in tree_leaves(caches)]))
    return got


@pytest.mark.parametrize("gname", GRIDS)
@pytest.mark.parametrize("name", list(CASES))
def test_cp_serving_matches_one_device(jax_side, monkeypatch, name, gname):
    """Each step's logits and caches against the one-device steps'; every
    MoE layer of the prefill takes the case's dispatch, every decode
    step's the stationary one."""
    cfg, params = build(jax_side, name)
    want = run_one_device(cfg, params, name)
    taken = branches(monkeypatch)
    got = run_sharded(cfg, params, name, make_grid(gname))
    for i, ((lg, caches), (wl, wc)) in enumerate(zip(got, want)):
        assert lg.shape == wl.shape
        assert rel(lg, wl) <= ONE_TOL, (i, rel(lg, wl))
        for c, w in zip(caches, wc):
            assert rel(c, w) <= ONE_TOL, i
    layers = T.n_stacked(params["layers"])
    assert taken[:layers] == [ALL[name][5]] * layers
    assert taken[layers:] == ["stationary"] * layers * DECODE_STEPS


@pytest.mark.parametrize("name", list(ALL))
def test_cp_serving_matches_jax(jax_side, name):
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


@pytest.mark.parametrize("name", list(ALL))
def test_cp_layout(jax_side, name):
    """One row over two data positions: every cache splits its time axis
    over ``"data"`` (MLA's rank, and the KV heads, over ``"model"``); the
    decode steps write in the first time block or the second."""
    cfg, params = build(jax_side, name)
    _, pc = place(cfg, params, name, make_grid("2x2"))
    specs = {"/".join(map(str, p)): tuple(x.sharding.spec)
             for p, x in tree_flatten_with_path(pc)}
    want = ((None, None, "data", "model") if cfg.mla
            else (None, None, "data", "model", None))
    assert specs and set(specs.values()) == {want}, specs
    _, _, _, s, max_len, _ = ALL[name]
    block = max_len // 2
    first = s + DECODE_STEPS <= block
    assert first == (name in ("deepseek-cp-first",
                              "qwen3-moe-cp-stationary"))
    assert first or s > block


def test_the_drops_case_drops(jax_side, monkeypatch):
    """The published capacity drops assignments in the prefill's
    shard-map dispatch (each data position's 1,088 tokens have 344 slots
    an expert), and the logits part from the one-device step's, whose
    capacity is 768 slots an expert of the 2,176 tokens."""
    cfg, params = build(jax_side, "qwen3-moe-cp-drops")
    dropped = []
    orig = L._ep_shardmap_parts

    def counting(cfg_, mesh, ins, cap, streams=True):
        dropped.append(sum(
            L.dropped_assignments(cfg_, ins[idx][1], ins[idx][0], 1, cap)
            for idx in mesh.positions() if idx[-1] == 0))
        return orig(cfg_, mesh, ins, cap, streams)

    monkeypatch.setattr(L, "_ep_shardmap_parts", counting)
    got = run_sharded(cfg, params, "qwen3-moe-cp-drops", make_grid("2x2"))
    assert len(dropped) == T.n_stacked(params["layers"])
    assert all(d > 0 for d in dropped), dropped
    assert L._ep_capacity(cfg, 1088) == 344
    assert L._moe_capacity(cfg, 2176) == 768
    want = run_one_device(cfg, params, "qwen3-moe-cp-drops")
    assert rel(got[0][0], want[0][0]) > 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_cp_decode_writes_stay_local(jax_side, name):
    """Each decode step changes the caches at its own time step only: the
    other time block, and every other step of its own, stay byte for
    byte as they were."""
    cfg, params = build(jax_side, name)
    s = ALL[name][3]
    seen = {}

    def after(i, pc):
        now = {"/".join(map(str, p)): gather(x).clone()
               for p, x in tree_flatten_with_path(pc)}
        if i:
            for key, t in now.items():
                before = seen[key]
                assert torch.equal(_times_but(t, s + i - 1),
                                   _times_but(before, s + i - 1)), key
                assert not torch.equal(t, before), key
        seen.update(now)

    run_sharded(cfg, params, name, make_grid("2x2"), after=after)
