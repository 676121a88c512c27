"""The port's partitioned prefill and decode steps for the ssm, hybrid and
encdec families (``repro_torch.serve.sharded_step``), and the
context-parallel cache, against its one-device steps and against the JAX
package's steps jitted with shardings.

Reduced mamba2-780m (8 SSM heads in one group, SSD chunks of 8; and 3
heads of 32 channels, which do not split over a model axis of 2, so
every position computes the whole mixer), zamba2-7b (4 Mamba2 layers,
the shared attention block after layers 1 and 3: its cache's two
invocations) and whisper-large-v3 (2 encoder and 2 decoder layers, 8
frames a row), float32, parameters placed by ``param_specs`` and float32
caches by ``cache_specs``:

* on 2 x 2, (4, 1) and (2, 2, 2)-with-``"pod"`` grids of the CPU device,
  a prefill and 4 decode steps against the port's one-device
  ``prefill``/``decode_step`` on the same tokens: each step's logits
  within 1e-5 of the largest, and the gathered caches within 1e-5 of
  theirs after each step;
* on a 2 x 2 grid, against the JAX dry run's jitted steps
  (``src/repro/launch/dryrun.py:build_cell``'s prefill and decode
  functions with their ``in_shardings``, executed on an Auto-axes 2 x 2
  mesh of forced host devices): logits within 1e-4, caches within 1e-5;
* the context-parallel layout (one row, which the data positions do not
  divide): zamba2's ``k``/``v`` cache split over time on ``"data"``,
  decoding in the first time block (the second fully masked) and, after
  a prompt that fills both blocks, in the second; mamba2 on one row,
  whose states every data position repeats;
* writes stay local: a decode step leaves every time step of the
  attention caches but its own byte for byte unchanged (under the
  context-parallel layout: the other time block whole), whisper's
  decode leaves the cross-attention cache and ``enc_out`` unchanged bit
  for bit, and on caches whose every position holds a copy of its own
  block, each copy ends equal to the one-device cache's block.

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
from repro_torch.models import transformer as T
from repro_torch.serve.sharded_step import (decode_step_sharded,
                                            prefill_sharded)
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import PlacedTensor, device_put, gather
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_map_with_path)

from test_torch_sharded_serve import make_grid, named, nested, rel

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ONE_TOL, JAX_LOGIT_TOL, JAX_CACHE_TOL = 1e-5, 1e-4, 1e-5
DECODE_STEPS = 4
#: name -> (arch, overrides, rows, prompt tokens, cache length)
CASES = {
    "mamba2-780m": ("mamba2-780m", {}, 4, 16, 20),
    "zamba2-7b": ("zamba2-7b", {}, 4, 16, 20),
    "whisper-large-v3": ("whisper-large-v3", {}, 4, 16, 20),
    # 3 heads of 32 channels: they do not split over a model axis of 2,
    # and every position computes the whole mixer
    "mamba2-whole": ("mamba2-780m", {"d_model": 48, "ssm_headdim": 32},
                     4, 16, 20),
    # one row over 2 data positions: time blocks [0, 8) and [8, 16)
    "zamba2-cp-first": ("zamba2-7b", {}, 1, 3, 16),
    "zamba2-cp-second": ("zamba2-7b", {}, 1, 10, 16),
    "mamba2-one-row": ("mamba2-780m", {}, 1, 16, 20),
}
GRIDS = ("2x2", "4x1", "pod")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(name: str) -> dict:
    """The prompt (and an encoder-decoder's frames) and the decode steps'
    tokens."""
    arch, over, b, s, _ = CASES[name]
    cfg = get_config(arch, reduced=True, **over)
    rng = np.random.default_rng(5)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (DECODE_STEPS, b, 1)).astype(
               np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


_JAX = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
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
    batch = {k: jnp.asarray(inp[f"{name}/{k}"]) for k in ("tokens", "frames")
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
        for i in range(steps):
            tok = jnp.asarray(inp[f"{name}/steps"][i])
            logits, caches = decode(params, tok, caches, jnp.int32(s + i))
            out[f"{name}/logits{i + 1}"] = np.asarray(logits)
            out.update(flat(caches, f"{name}/caches{i + 1}/"))
np.savez(out_npz, **out)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's parameters of each case and its jitted sharded steps' logits
    and caches."""
    tmp = tmp_path_factory.mktemp("sharded_serve_families")
    np.savez(tmp / "in.npz", **{f"{name}/{k}": v for name in CASES
                                for k, v in inputs(name).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _JAX, json.dumps(CASES),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        str(DECODE_STEPS)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def build(jax_side, name: str):
    arch, over, *_ = CASES[name]
    cfg = get_config(arch, reduced=True, **over)
    return cfg, model_params_from_numpy(
        cfg, nested(jax_side, f"{name}/params/"), "cpu")


def place(cfg, params, name: str, mesh):
    """The parameters and fresh float32 caches placed on ``mesh``."""
    *_, b, _, max_len = CASES[name]
    caches = T.init_cache(cfg, b, max_len, dtype=torch.float32)
    pl = device_put(params, named(mesh, R.param_specs(
        cfg, T.init_model(cfg, None), mesh)))
    pc = device_put(caches, named(mesh, R.cache_specs(cfg, caches, mesh)))
    return pl, pc


def run_sharded(cfg, params, name: str, mesh, after=None, caches=None):
    """The prompt's prefill and the decode steps on ``mesh``: each step's
    logits and gathered caches; ``after(i, pc)`` runs after step ``i``
    (0: the prefill)."""
    x = inputs(name)
    pl, pc = place(cfg, params, name, mesh)
    pc = pc if caches is None else caches(pc)
    layout = [c.sharding for c in tree_leaves(pc)]
    batch = {k: x[k] for k in ("tokens", "frames") if k in x}
    logits, out = prefill_sharded(cfg, pl, batch, pc, mesh)
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
    *_, b, s, max_len = CASES[name]
    caches = T.init_cache(cfg, b, max_len, dtype=torch.float32)
    batch = {k: torch.as_tensor(x[k]) for k in ("tokens", "frames")
             if k in x}
    with torch.no_grad():
        logits, caches = T.prefill(cfg, params, batch, caches)
        got = [(logits, [c.clone() for c in tree_leaves(caches)])]
        for i in range(DECODE_STEPS):
            logits, caches = T.decode_step(
                cfg, params, torch.as_tensor(x["steps"][i]), caches, s + i)
            got.append((logits, [c.clone() for c in tree_leaves(caches)]))
    return got


def close(got, want, tol: float) -> None:
    for i, ((lg, caches), (wl, wc)) in enumerate(zip(got, want)):
        assert lg.shape == wl.shape
        assert rel(lg, wl) <= tol, (i, rel(lg, wl))
        for c, w in zip(caches, wc):
            assert rel(c, w) <= tol, i


@pytest.mark.parametrize("gname", GRIDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_one_device(jax_side, name, gname):
    cfg, params = build(jax_side, name)
    close(run_sharded(cfg, params, name, make_grid(gname)),
          run_one_device(cfg, params, name), ONE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_jax(jax_side, name):
    cfg, params = build(jax_side, name)
    got = run_sharded(cfg, params, name, make_grid("2x2"))
    *_, b, _, max_len = CASES[name]
    names = ["/".join(map(str, p)) for p, _ in tree_flatten_with_path(
        T.init_cache(cfg, b, max_len, device="meta"))]
    for i, (lg, caches) in enumerate(got):
        want = jax_side[f"{name}/logits{i}"]
        assert rel(lg, want) <= JAX_LOGIT_TOL, (i, rel(lg, want))
        for key, c in zip(names, caches):
            w = jax_side[f"{name}/caches{i}/{key}"]
            assert rel(c, w) <= JAX_CACHE_TOL, (i, key, rel(c, w))


@pytest.mark.parametrize("name", ["zamba2-cp-first", "zamba2-cp-second"])
def test_context_parallel_layout(jax_side, name):
    """One row on a 2 x 2 grid: attention's caches split over time on
    ``"data"``, the Mamba2 states repeated over it; the decode steps in
    the first time block (the second holds no valid key) or the second
    (the prompt filled both)."""
    cfg, params = build(jax_side, name)
    mesh = make_grid("2x2")
    _, pc = place(cfg, params, name, mesh)
    specs = {"/".join(map(str, p)): tuple(x.sharding.spec)
             for p, x in tree_flatten_with_path(pc)}
    assert specs["attn/k"][:3] == (None, None, "data")
    assert specs["main/ssd"][:3] == (None, None, "model")
    *_, s, max_len = CASES[name]
    block = max_len // 2
    first = s + DECODE_STEPS <= block
    assert first == (name == "zamba2-cp-first")
    assert first or s > block
    close(run_sharded(cfg, params, name, mesh),
          run_one_device(cfg, params, name), ONE_TOL)


def _times_but(t: torch.Tensor, pos: int) -> torch.Tensor:
    """A ``(layers, rows, time, ...)`` cache without time step ``pos``."""
    return torch.cat([t[:, :, :pos], t[:, :, pos + 1:]], dim=2)


@pytest.mark.parametrize("name", ["zamba2-7b", "zamba2-cp-first",
                                  "zamba2-cp-second", "whisper-large-v3"])
def test_decode_writes_stay_local(jax_side, name):
    """Each decode step changes the attention caches at its own time step
    only (the context-parallel layout: the other time block not at all);
    whisper's leaves the cross-attention cache and ``enc_out`` as the
    prefill wrote them, bit for bit."""
    cfg, params = build(jax_side, name)
    s = CASES[name][3]
    seen = {}

    def after(i, pc):
        now = {"/".join(map(str, p)): gather(x).clone()
               for p, x in tree_flatten_with_path(pc)}
        if i:
            for key, t in now.items():
                before = seen[key]
                if key.endswith(("self/k", "self/v", "attn/k", "attn/v")):
                    assert torch.equal(_times_but(t, s + i - 1),
                                       _times_but(before, s + i - 1)), key
                    assert not torch.equal(t, before), key
                if key.startswith(("dec/cross", "enc_out")):
                    assert torch.equal(t, before), key
        seen.update(now)

    run_sharded(cfg, params, name, make_grid("2x2"), after=after)


def _own_copies(pc):
    """The placed caches with every position holding a tensor of its own
    (a block's holders on one device share one copy by default)."""
    def one(_, x):
        whole = gather(x)
        return PlacedTensor(x.shape, x.dtype, x.sharding, {
            idx: whole[x.sharding.slices(x.shape, idx)].clone()
            for idx in x.sharding.mesh.positions()})
    return tree_map_with_path(one, pc)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-cp-second",
                                  "whisper-large-v3"])
def test_every_holder_writes_its_own_copy(jax_side, name):
    """Caches whose every position holds a copy of its own block: after the
    prefill and each decode step, each position's copy equals the
    one-device cache's block."""
    cfg, params = build(jax_side, name)
    want = run_one_device(cfg, params, name)

    def after(i, pc):
        for x, w in zip(tree_leaves(pc), want[i][1]):
            for idx, shard in x.shards.items():
                blk = w[x.sharding.slices(x.shape, idx)]
                assert rel(shard, blk) <= ONE_TOL if blk.abs().max() > 0 \
                    else torch.equal(shard, blk), (i, idx)

    run_sharded(cfg, params, name, make_grid("2x2"), after=after,
                caches=_own_copies)


def test_a_batch_the_data_positions_do_not_divide_raises_elsewhere():
    """Three rows over two data positions: ``cache_specs`` keeps the rows
    whole (the context-parallel layout), and the steps run; the same
    caches placed with their rows split over ``"data"`` (one row a
    block, four rows) are refused for a three-row batch."""
    cfg = get_config("zamba2-7b", reduced=True)
    mesh = make_grid("2x2")
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    pl = device_put(params, named(mesh, R.param_specs(
        cfg, T.init_model(cfg, None), mesh)))
    tok = np.zeros((3, 4), np.int32)
    caches = T.init_cache(cfg, 3, 8, dtype=torch.float32)
    pc = device_put(caches, named(mesh, R.cache_specs(cfg, caches, mesh)))
    logits, _ = prefill_sharded(cfg, pl, {"tokens": tok}, pc, mesh)
    assert logits.shape == (3, 1, cfg.vocab_eff)
    four = T.init_cache(cfg, 4, 8, dtype=torch.float32)
    pc = device_put(four, named(mesh, R.cache_specs(cfg, four, mesh)))
    with pytest.raises(ValueError, match="splits its rows"):
        prefill_sharded(cfg, pl, {"tokens": tok}, pc, mesh)
