"""The port's sharded train step for the ssm, hybrid and encdec families
(``make_train_step`` on a tree placed on a mesh) against its one-device
step and against the JAX package's step jitted with shardings.

Reduced mamba2-780m (8 SSM heads, two SSD chunks of 8), zamba2-7b (4
Mamba2 layers, the shared attention block after layers 1 and 3) and
whisper-large-v3 (2 encoder and 2 decoder layers, 8 frames a row), 4 rows
of 16 tokens, on a 2 x 2 grid (``make_host_mesh(2, devices=["cpu"] *
4)``) and a (4, 1) grid of the CPU device, placed as in
``tests/test_torch_sharded_step.py`` (whose helpers this file imports):

* against the port's one-device step, with that file's bounds
  (:func:`check_one_device`): the loss within 1e-6 relative, the
  gathered gradients within ``rtol=1e-4, atol=1e-6`` (or, for a leaf the
  float32 one-device step itself holds farther than that from a float64
  one-device step, as zamba2's embedding gradient, whose terms cancel,
  no farther from the float64 step than 1.5 times the float32 one), the
  updates from the same gradients within 1.2e-7, a second step's loss,
  the shardings kept;
* against JAX's ``jit(make_train_step(cfg, opt), in_shardings=...,
  out_shardings=...)`` on an Auto-axes 2 x 2 mesh (two steps): each
  step's loss and gradient norm within 1e-5 relative, AdamW's first
  moment after the first step within ``rtol=1e-4, atol=1e-7``.

Also: mamba2 with ``remat``, with 2 and 8 groups (the heads of a model
position read whole groups, or one group), and with heads that do not
split over the model axis (3 heads of 32 channels: the block computes
whole at every position); zamba2 with ``grad_accum=2`` and 3 rows a
microbatch over 2 or 4 data positions; whisper's ``frames`` split
unevenly (3 rows).

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
from repro_torch.sharding.placement import gather
from repro_torch.train import make_optimizer, make_train_step
from repro_torch.train.sharded_step import _Positions
from repro_torch.tree import tree_flatten_with_path

from test_torch_sharded_step import (GRIDS, JAX_LOSS_RTOL, ROOT, _JAX_STEP,
                                     _flat, check_one_device, grid, nested,
                                     place)

#: name -> (arch, overrides, batch rows, tokens a row)
CASES = {
    "mamba2-780m": ("mamba2-780m", {}, 4, 16),
    "zamba2-7b": ("zamba2-7b", {}, 4, 16),
    "whisper-large-v3": ("whisper-large-v3", {}, 4, 16),
    # 3 heads of 32 channels: they do not split over a model axis of 2
    "mamba2-whole": ("mamba2-780m", {"d_model": 48, "ssm_headdim": 32},
                     4, 16),
}
#: variants on a case's parameters: name -> (case, overrides, rows)
VARIANTS = {
    "mamba2-remat": ("mamba2-780m", {"remat": True}, 4),
    "zamba2-accum": ("zamba2-7b", {"grad_accum": 2, "remat": True}, 6),
    "whisper-uneven": ("whisper-large-v3", {"remat": True}, 3),
}
#: (case, grid) pairs JAX runs
JAX_CASES = [(name, "2x2") for name in CASES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: on a loaded machine
    (the suite's other workers) a parallel region waits on its slowest
    thread, which can stretch each small op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(cfg, rows: int, seq: int, seed: int = 1) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (rows, seq + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def case_config(name: str):
    arch, over, _, _ = CASES[name]
    return get_config(arch, reduced=True, **over)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's parameters of each case and its sharded step's results."""
    tmp = tmp_path_factory.mktemp("sharded_step_families")
    inp = {f"{name}/b{i}/{k}": v for name, (_, _, rows, seq) in CASES.items()
           for i, b in enumerate(batches(case_config(name), rows, seq))
           for k, v in b.items()}
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    spec = json.dumps({k: [v[0], v[1]] for k, v in CASES.items()})
    r = subprocess.run(
        [sys.executable, "-c", _JAX_STEP, json.dumps(JAX_CASES),
         json.dumps(GRIDS), str(tmp / "in.npz"), str(tmp / "out.npz"),
         spec], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def params_of(jax_side, name: str, cfg):
    return model_params_from_numpy(cfg, nested(jax_side, f"{name}/params/"),
                                   "cpu")


@pytest.mark.parametrize("gname", list(GRIDS))
@pytest.mark.parametrize("name", list(CASES))
def test_family_step_matches_one_device(jax_side, name, gname):
    cfg = case_config(name)
    _, _, rows, seq = CASES[name]
    check_one_device(cfg, params_of(jax_side, name, cfg), grid(GRIDS[gname]),
                     *batches(cfg, rows, seq), f64=True)


@pytest.mark.parametrize("gname", list(GRIDS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_family_variant_matches_one_device(jax_side, name, gname):
    base, over, rows = VARIANTS[name]
    cfg = case_config(base).with_(**over)
    check_one_device(cfg, params_of(jax_side, base, cfg), grid(GRIDS[gname]),
                     *batches(cfg, rows, CASES[base][3], seed=2), f64=True)


@pytest.mark.parametrize("groups", [2, 8])
@pytest.mark.parametrize("gname", list(GRIDS))
def test_mamba2_groups_match_one_device(gname, groups):
    """8 heads in 2 groups (a model position of 2 holds whole groups, one
    of 4 half a group) or in 8: each position's heads read their groups'
    B and C."""
    from repro_torch.models import transformer as T

    cfg = case_config("mamba2-780m").with_(ssm_groups=groups)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    check_one_device(cfg, params, grid(GRIDS[gname]),
                     *batches(cfg, 4, 16, seed=3), f64=True)


@pytest.mark.parametrize("name,tp,split", [
    ("mamba2-780m", 2, True), ("mamba2-780m", 4, True),
    ("mamba2-whole", 2, False), ("mamba2-whole", 1, True)])
def test_mamba2_heads_split_only_when_they_divide(name, tp, split):
    cfg = case_config(name)
    mesh = grid((4 // tp, tp))
    assert (_Positions(cfg, mesh, {}, False).ssm is not None) == split


@pytest.mark.parametrize("name,gname", JAX_CASES)
def test_family_step_matches_jax(jax_side, name, gname):
    cfg = case_config(name)
    _, _, rows, seq = CASES[name]
    mesh = grid(GRIDS[gname])
    opt = make_optimizer(cfg.optimizer)
    pl, state = place(cfg, params_of(jax_side, name, cfg), opt.init(
        params_of(jax_side, name, cfg)), mesh, cfg.optimizer)
    step = make_train_step(cfg, opt)
    tag = f"{name}@{gname}"
    for i, b in enumerate(batches(cfg, rows, seq)):
        pl, state, m = step(pl, state, b, np.int32(i))
        for k, v in m.items():
            want = float(jax_side[f"{tag}/metrics{i}/{k}"])
            assert float(v) == pytest.approx(want, rel=JAX_LOSS_RTOL), (k, i)
        if i:
            continue
        want = _flat(nested(jax_side, f"{tag}/state0/"))
        got = {"/".join(map(str, p)): gather(x).numpy()
               for p, x in tree_flatten_with_path(state)}
        for key, w in want.items():
            if key.startswith("m/"):
                np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-7,
                                           err_msg=key)
