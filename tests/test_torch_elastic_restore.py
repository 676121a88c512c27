"""Elastic checkpoint restore and bfloat16 checkpoints, the port against
the JAX package's store.

The flow of ``tests/test_elastic_restore.py`` on repeated CPU devices: save
from one device; restore onto a 2 x 2 mesh with the rule shardings (equal
values, at least one leaf split); save from that placed layout; restore
replicated.  Each step is held bit for bit, in float32 and in bfloat16,
and across the two stores in both directions: JAX restores the port's
steps (onto its own 2 x 2 mesh, and replicated), and the port restores
JAX's, including a step JAX saved from a 2 x 2 layout, onto its 2 x 2
grid.  A bfloat16 leaf is stored as JAX stores it (``|V2`` in the npz,
``"bfloat16"`` in the manifest); the JAX store's own ``restore`` hands
back those ``|V2`` arrays, which is pinned here, not copied.  The JAX
side that needs 4 devices runs once, in one subprocess with Auto axes.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import (NamedSharding, PlacedTensor,
                                            device_put, gather)
from repro_torch.train import make_optimizer, make_train_step
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.tree import (key_of, tree_flatten_with_path, tree_leaves,
                               tree_map)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DTYPES = ("float32", "bfloat16")

_JAX_SIDE = r'''
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.checkpoint.store import CheckpointStore
from repro.configs import get_config
from repro.models import transformer as T
from repro.sharding import rules as R

port_dir, jax_dir, out_npz = sys.argv[1:4]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out, summary = {}, {}

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]

for dt in ("float32", "bfloat16"):
    cfg = get_config("qwen3-0.6b", reduced=True).with_(
        n_layers=2, param_dtype=dt)
    shapes = jax.eval_shape(lambda: T.init_model(cfg, jax.random.PRNGKey(0)))
    shardings = R.param_shardings(cfg, shapes, mesh)
    # the port's steps: 3 saved from one device, 4 from its 2 x 2 grid
    ps = CheckpointStore(os.path.join(port_dir, dt))
    for step in (3, 4):
        if dt == "float32":
            tree, man = ps.restore(step, shapes, shardings)
            split = sum(len(l.sharding.device_set) > 1
                        for l in jax.tree.leaves(tree))
            summary[f"{dt}:{step}:split"] = int(split)
            for p, l in leaves(tree):
                out[f"{dt}/{step}/placed/{key(p)}"] = np.asarray(l)
        tree, man = ps.restore(step, shapes)
        summary[f"{dt}:{step}:manifest"] = man
        for p, l in leaves(tree):
            summary[f"{dt}:{step}:dtype:{key(p)}"] = l.dtype.str
            out[f"{dt}/{step}/replicated/{key(p)}"] = (
                l.view(np.uint16) if l.dtype.kind == "V" else l)
    # JAX's step 3 (saved from one device) onto its 2 x 2 mesh, then
    # saved again from there as step 4
    js = CheckpointStore(os.path.join(jax_dir, dt))
    tree, _ = js.restore(3, shapes)
    tree = jax.tree.map(lambda a, s: jnp.asarray(a.view(s.dtype)
                                                 if a.dtype.kind == "V"
                                                 else a), tree, shapes)
    placed = jax.device_put(tree, shardings)
    summary[f"jax:{dt}:split"] = int(sum(
        len(l.sharding.device_set) > 1 for l in jax.tree.leaves(placed)))
    js.save(4, placed, {"mesh": "2x2"})
np.savez(out_npz, **out)
print(json.dumps(summary))
'''


def cfg_of(dtype):
    return get_config("qwen3-0.6b", reduced=True).with_(n_layers=2,
                                                        param_dtype=dtype)


def bits(t):
    """A tensor's (or array's) raw bits, for bit-for-bit comparison."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return a.view(np.int16)
    return a


def same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        if isinstance(x, PlacedTensor):
            x = gather(x)
        if isinstance(y, PlacedTensor):
            y = gather(y)
        np.testing.assert_array_equal(bits(x), bits(y))


def grid():
    return make_host_mesh(2, devices=["cpu"] * 4)


def n_split(tree):
    return sum(not leaf.sharding.is_fully_replicated
               for leaf in tree_leaves(tree)
               if isinstance(leaf, PlacedTensor))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The port's steps 3 (one device) and 4 (its 2 x 2 grid) and JAX's
    step 3 (one device), both dtypes; then the JAX subprocess: it restores
    the port's steps and saves JAX's step 4 from a 2 x 2 mesh."""
    root = tmp_path_factory.mktemp("elastic")
    port_dir, jax_dir = root / "port", root / "jax"
    params = {}
    for dt in DTYPES:
        jcfg = jax_get_config("qwen3-0.6b", reduced=True).with_(
            n_layers=2, param_dtype=dt)
        jp = JT.init_model(jcfg, jax.random.PRNGKey(0))
        JaxStore(str(jax_dir / dt)).save(3, jp, {"config": jcfg.name,
                                                  "mesh": "none"})
        cfg = cfg_of(dt)
        p = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
        params[dt] = p
        store = CheckpointStore(str(port_dir / dt))
        store.save(3, p, {"config": cfg.name, "mesh": "none"})
        sh = R.param_shardings(cfg, T.init_model(cfg, None), grid())
        _, placed, _ = store.restore_latest(p, sh)
        store.save(4, placed, {"mesh": "2x2"})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    npz = root / "jax_read.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(port_dir),
                        str(jax_dir), str(npz)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(npz) as z:
        read = {k: z[k] for k in z.files}
    return {"params": params, "port": port_dir, "jax": jax_dir,
            "summary": json.loads(r.stdout.strip().splitlines()[-1]),
            "read": read}


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_elastic_flow(tmp_path, sides, dtype):
    """Save from one device → restore onto 2 x 2 (equal, some leaves split,
    positions sharing the device hold views of one copy) → save from the
    placed layout → restore replicated (equal)."""
    cfg, params = cfg_of(dtype), sides["params"][dtype]
    store = CheckpointStore(str(tmp_path))
    store.save(3, params, {"config": cfg.name, "mesh": "none"})
    sh = R.param_shardings(cfg, T.init_model(cfg, None), grid())
    step, placed, manifest = store.restore_latest(params, sh)
    assert step == 3 and manifest["config"] == cfg.name
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves(placed))
    same(params, placed)
    assert n_split(placed) > 0
    emb = placed["embed"]
    assert emb.sharding.spec == ("model", "data") and emb.dtype == getattr(
        torch, dtype)
    shards = [emb.shards[i] for i in grid().positions()]
    assert {s.untyped_storage().data_ptr() for s in shards} == {
        shards[0].untyped_storage().data_ptr()}
    assert tuple(shards[0].shape) == (emb.shape[0] // 2, emb.shape[1] // 2)
    store.save(4, placed, {"mesh": "2x2"})
    step2, back, _ = store.restore_latest(params, None)
    assert step2 == 4
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(back))
    same(params, back)
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as z, \
            np.load(tmp_path / "step_00000003" / "arrays.npz") as y:
        assert sorted(z.files) == sorted(y.files)
        for k in z.files:
            assert z[k].dtype == y[k].dtype
            np.testing.assert_array_equal(z[k].view(np.uint8),
                                          y[k].view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_manifests_and_npz_equal_jax_stores(sides, dtype):
    """The port's step 3 and JAX's step 3 of the same tree: equal manifest
    keys, shapes and dtypes (``"bfloat16"``), equal npz dtypes (``|V2``
    for bfloat16) and bytes."""
    def read(d):
        with open(d / "step_00000003" / "manifest.json") as f:
            man = json.load(f)
        with np.load(d / "step_00000003" / "arrays.npz") as z:
            return man, {k: z[k] for k in z.files}
    pm, pa = read(sides["port"] / dtype)
    jm, ja = read(sides["jax"] / dtype)
    assert pm == jm
    assert set(pm["dtypes"].values()) == {dtype}
    assert sorted(pa) == sorted(ja)
    for k in pa:
        assert pa[k].dtype == ja[k].dtype
        assert pa[k].dtype.str == ("|V2" if dtype == "bfloat16" else "<f4")
        np.testing.assert_array_equal(pa[k].view(np.uint8),
                                      ja[k].view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step", [3, 4])
def test_jax_restores_the_port_steps(sides, dtype, step):
    """JAX's store reads the port's step saved from one device (3) and
    from the placed 2 x 2 layout (4): replicated always, onto JAX's 2 x 2
    mesh in float32 (JAX cannot place its own ``|V2`` arrays)."""
    want = {key_of(p): bits(x)
            for p, x in tree_flatten_with_path(sides["params"][dtype])}
    read, summary = sides["read"], sides["summary"]
    for k, v in want.items():
        np.testing.assert_array_equal(
            read[f"{dtype}/{step}/replicated/{k}"].view(v.dtype), v)
        if dtype == "float32":
            np.testing.assert_array_equal(read[f"{dtype}/{step}/placed/{k}"],
                                          v)
        # the reference's quirk, pinned: its restore gives raw |V2 bytes
        assert summary[f"{dtype}:{step}:dtype:{k}"] == (
            "|V2" if dtype == "bfloat16" else "<f4")
    if dtype == "float32":
        assert summary[f"{dtype}:{step}:split"] > 0
    assert summary[f"{dtype}:{step}:manifest"]["step"] == step


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step", [3, 4])
def test_port_restores_jax_steps_onto_2x2(sides, dtype, step):
    """JAX's step 3 (saved from one device) and step 4 (saved from its 2 x
    2 mesh) restore in the port onto the 2 x 2 grid and replicated, bit
    for bit."""
    cfg, params = cfg_of(dtype), sides["params"][dtype]
    assert sides["summary"][f"jax:{dtype}:split"] > 0
    store = CheckpointStore(str(sides["jax"] / dtype))
    assert store.latest_step() == 4
    sh = R.param_shardings(cfg, T.init_model(cfg, None), grid())
    placed, manifest = store.restore(step, params, sh)
    assert manifest["mesh"] == ("2x2" if step == 4 else "none")
    assert n_split(placed) > 0
    same(params, placed)
    flat, _ = store.restore(step, params)
    assert tree_leaves(flat)[0].dtype == getattr(torch, dtype)
    same(params, flat)


def test_jax_restore_returns_raw_bytes_for_bfloat16(sides):
    """Pinned quirk of the reference: JAX's own ``restore`` of a bfloat16
    step hands back ``|V2`` arrays (numpy has no bfloat16), not bfloat16;
    the port's restore gives bfloat16 tensors of the same bits."""
    jcfg = jax_get_config("qwen3-0.6b", reduced=True).with_(
        n_layers=2, param_dtype="bfloat16")
    shapes = jax.eval_shape(lambda: JT.init_model(jcfg,
                                                  jax.random.PRNGKey(0)))
    tree, _ = JaxStore(str(sides["jax"] / "bfloat16")).restore(3, shapes)
    got = jax.tree.leaves(tree)
    assert {a.dtype.str for a in got} == {"|V2"}
    port = tree_leaves(sides["params"]["bfloat16"])
    for a, b in zip(got, port):
        np.testing.assert_array_equal(a.view(np.int16), bits(b))


def test_bfloat16_roundtrip_alone_and_as_uint16(tmp_path):
    """A bfloat16 tree of every special value round-trips bit for bit;
    ``|V2`` and uint16 arrays both read back as bfloat16 where ``like``
    is bfloat16, and stay themselves where it is not."""
    raw = np.array([0, 1, 0x7F80, 0xFF80, 0x7FC1, 0x8000, 0x3F80, 0xC2F7,
                    0x0001, 0xFFFF], np.uint16)
    t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
    tree = {"a": t, "b": [t.reshape(2, 5), torch.ones(3)]}
    store = CheckpointStore(str(tmp_path))
    store.save(1, tree)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["a"].dtype.str == "|V2" and z["b/1"].dtype == np.float32
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == {"a": "bfloat16",
                                          "b/0": "bfloat16",
                                          "b/1": "float32"}
    back, _ = store.restore(1, tree)
    assert back["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["a"].view(torch.uint16).numpy(), raw)
    same(tree, back)
    from repro_torch.checkpoint.store import _tree_like
    got = _tree_like({"x": t, "y": torch.zeros(10, dtype=torch.int16)},
                     {"x": raw, "y": raw.view(np.int16)}, "cpu")
    assert got["x"].dtype == torch.bfloat16 and got["y"].dtype == torch.int16
    np.testing.assert_array_equal(bits(got["x"]), raw.view(np.int16))


def test_placement_layouts_and_gather():
    """``device_put`` by one sharding or a tree of them (``None`` leaves a
    leaf as it is), moving a placed tree to another layout, the shard
    shapes of a tuple axis, and a spec that does not divide."""
    x = torch.arange(48.0).reshape(4, 12)
    m22, m41 = grid(), make_host_mesh(1, devices=["cpu"] * 4)
    a = device_put({"x": x, "y": x}, {"x": NamedSharding(
        m22, R.P("data", "model")), "y": None})
    assert isinstance(a["x"], PlacedTensor) and a["y"] is x
    assert torch.equal(a["x"].shards[(1, 0)], x[2:4, 0:6])
    b = device_put(a, NamedSharding(m41, R.P(None, ("data", "model"))))
    assert b["x"].sharding.parts(2) == (1, 4)
    assert torch.equal(b["x"].shards[(2, 0)], x[:, 6:9])
    assert torch.equal(gather(b["x"]), x) and torch.equal(gather(b["y"]), x)
    assert NamedSharding(m22, R.P(None, None)).is_fully_replicated
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.ones(3, 3), NamedSharding(m22, R.P("data", None)))


def test_run_training_restores_through_the_shardings(tmp_path, sides):
    """``run_training(shardings=)`` hands them to the store: the step gets
    the restored tree placed on the grid.  The port's train step then
    trains on the placed tree (the sharded step), as the same run on the
    restored one-device tree does."""
    cfg, params = cfg_of("float32"), sides["params"]["float32"]
    opt = make_optimizer("adamw")
    state = opt.init(params)
    CheckpointStore(str(tmp_path)).save(2, (params, state), {"mesh": "none"})
    mesh = grid()
    sh = R.param_shardings(cfg, T.init_model(cfg, None), mesh)
    state_sh = tree_map(lambda _: NamedSharding(mesh, R.P()), state)
    seen = []

    def step_fn(p, s, batch, i):
        seen.append((p, s))
        return p, s, {"loss": 0.0}

    loop = LoopConfig(total_steps=3, ckpt_every=0, ckpt_dir=str(tmp_path),
                      log_every=0)
    r = run_training(cfg, loop, params=params, opt_state=state,
                     step_fn=step_fn, batch_fn=lambda i: {},
                     shardings=(sh, state_sh), log=lambda _: None)
    assert r.resumed_from == 2 and r.final_step == 3 and len(seen) == 1
    p, s = seen[0]
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves((p, s)))
    assert n_split(p) > 0
    same((params, state), (p, s))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (2, 9))

    def run(shardings):
        out = []
        step = make_train_step(cfg, opt)

        def keep(*args):
            out.append(step(*args))
            return out[-1]

        res = run_training(cfg, LoopConfig(total_steps=4, ckpt_every=0,
                                           ckpt_dir=str(tmp_path),
                                           log_every=0),
                           params=params, opt_state=state, step_fn=keep,
                           batch_fn=lambda i: {"tokens": tok[:, :-1],
                                               "labels": tok[:, 1:]},
                           shardings=shardings, log=lambda _: None)
        return res, out

    placed, got = run((sh, state_sh))
    plain, want = run(None)
    assert placed.resumed_from == plain.resumed_from == 2
    np.testing.assert_allclose(placed.losses, plain.losses, rtol=1e-6)
    p, s, _ = got[-1]
    assert all(isinstance(x, PlacedTensor) for x in tree_leaves((p, s)))
    assert [x.sharding for x in tree_leaves(p)] == tree_leaves(
        sh, is_leaf=lambda x: isinstance(x, NamedSharding))
    # after full steps an element whose gradient is rounding noise can
    # move by up to the learning rate a step (AdamW's g / (|g| + eps));
    # tests/test_torch_sharded_step.py holds updates from the same
    # gradients within 1.2e-7
    for a, b in zip(tree_leaves(p), tree_leaves(want[-1][0])):
        np.testing.assert_allclose(gather(a).numpy(), b.numpy(), rtol=0,
                                   atol=2 * 3e-4)
