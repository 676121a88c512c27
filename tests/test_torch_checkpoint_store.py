"""The port's ``CheckpointStore`` against the JAX package's, on the CPU.

The store keeps ``(params, opt_state)`` trees of tensors in the JAX
store's format: a round trip with ``keep`` GC, the walk-back past a
corrupt step, the asynchronous save's host snapshot taken before the
next in-place optimizer step, and a step written by either package
restoring in the other with equal leaves (and equal manifests when both
write the same tree).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import CheckpointStore, PlanCache
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train import make_optimizer, make_train_step
from repro_torch.tree import tree_leaves


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jax_get_config("qwen3-0.6b", reduced=True).with_(n_layers=2)
    jp = jax.jit(JT.init_model, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("adamw")
    return jcfg, jp, jopt, jopt.init(jp)


@pytest.fixture
def tiny(jax_side):
    """(cfg, params, optimizer, state): the JAX tree carried over (a fresh
    copy each test)."""
    jcfg, jp, _, jstate = jax_side
    cfg = get_config("qwen3-0.6b", reduced=True).with_(n_layers=2)
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     "cpu")
    opt = make_optimizer("adamw")
    state = opt_state_from_numpy(opt, params,
                                 jax.tree.map(np.asarray, jstate), "cpu")
    return cfg, params, opt, state


def assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_latest_and_keep(tmp_path, tiny):
    cfg, params, _, state = tiny
    store = CheckpointStore(str(tmp_path), keep=2)
    store.save(5, (params, state), {"config": cfg.name})
    store.save(10, (params, state))
    assert store.latest_step() == 10
    (p2, s2), manifest = store.restore(10, (params, state))
    assert_same((p2, s2), (params, state))
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(p2))
    assert list(p2) == list(params)           # like's structure
    assert manifest["step"] == 10
    store.save(15, (params, state))
    assert store.latest_step() == 15
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000010",
                                            "step_00000015"]
    assert (tmp_path / "LATEST").read_text() == "step_00000015"
    step, _, manifest = store.restore_latest((params, state))
    assert step == 15 and "config" not in manifest
    with open(tmp_path / "step_00000015" / "manifest.json") as f:
        assert json.load(f)["keys"][:2] == ["0/embed", "0/final_norm/scale"]


def test_corruption_walks_back(tmp_path, tiny):
    _, params, _, _ = tiny
    store = CheckpointStore(str(tmp_path))
    assert store.restore_latest(params) is None
    store.save(1, params)
    store.save(2, params)
    with open(tmp_path / "step_00000002" / "arrays.npz", "wb") as f:
        f.write(b"garbage")
    assert store.latest_step() == 1
    step, restored, _ = store.restore_latest(params)
    assert step == 1
    assert_same(restored, params)


def test_restore_checks_shapes_and_places(tmp_path, tiny):
    _, params, _, _ = tiny
    store = CheckpointStore(str(tmp_path))
    store.save(1, params)
    bad = dict(params, embed=params["embed"][:, :3])
    with pytest.raises(ValueError, match=r"^embed: shape"):
        store.restore(1, bad)
    meta = {k: v for k, v in params.items() if k != "layers"}
    got, _ = store.restore(1, meta, device="cpu")
    assert got["embed"].device.type == "cpu"
    assert torch.equal(got["embed"], params["embed"])


def test_async_snapshot_precedes_the_next_in_place_step(tmp_path, tiny):
    """The loop calls ``save_async`` and then steps, and the step writes
    the parameters in place: the checkpoint must hold the values at the
    call, not after the step."""
    cfg, params, opt, state = tiny
    step = make_train_step(cfg, opt)
    batch = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=16,
                          seed=1).batch_at(0)
    before = [x.clone() for x in tree_leaves((params, state))]
    store = CheckpointStore(str(tmp_path))
    store.save_async(7, (params, state))
    params, state, _ = step(params, state, batch, np.int32(0))
    assert not torch.equal(tree_leaves(params)[0], before[0])
    store.wait()
    assert store.latest_step() == 7
    (p2, s2), _ = store.restore(7, (params, state))
    for got, want in zip(tree_leaves((p2, s2)), before):
        assert torch.equal(got, want)


def test_jax_step_restores_in_the_port(tmp_path, tiny, jax_side):
    jcfg, jp, jopt, jstate = jax_side
    _, params, _, state = tiny
    JaxStore(str(tmp_path)).save(3, (jp, jstate), {"config": jcfg.name,
                                                  "mesh": "none"})
    store = CheckpointStore(str(tmp_path))
    step, (p2, s2), manifest = store.restore_latest((params, state))
    assert step == 3 and manifest["config"] == jcfg.name
    assert_same(p2, jp)
    assert_same(s2, jstate)


def test_port_step_restores_in_jax(tmp_path, tiny, jax_side):
    cfg, params, opt, state = tiny
    _, jp, _, jstate = jax_side
    step = make_train_step(cfg, opt)
    params, state, _ = step(params, state, TokenPipeline(
        vocab=cfg.vocab, batch=4, seq_len=16, seed=1).batch_at(0),
        np.int32(0))
    CheckpointStore(str(tmp_path)).save(4, (params, state),
                                        {"config": cfg.name})
    jstore = JaxStore(str(tmp_path))
    got, manifest = jstore.restore(4, (jp, jstate))
    assert manifest["config"] == cfg.name
    assert_same(got, (params, state))


def test_manifests_equal_the_jax_stores(tmp_path, tiny, jax_side):
    """The same tree written by both stores: the same keys, shapes,
    dtypes and arrays, so the formats are one."""
    _, params, _, state = tiny
    _, jp, _, jstate = jax_side
    JaxStore(str(tmp_path / "jax")).save(1, (jp, jstate), {"config": "x"})
    CheckpointStore(str(tmp_path / "port")).save(1, (params, state),
                                                 {"config": "x"})
    docs = []
    for which in ("jax", "port"):
        d = tmp_path / which / "step_00000001"
        with open(d / "manifest.json") as f:
            docs.append(json.load(f))
        with np.load(d / "arrays.npz") as z:
            docs.append({k: z[k] for k in z.files})
    assert docs[0] == docs[2]
    assert docs[1].keys() == docs[3].keys()
    for k in docs[1]:
        np.testing.assert_array_equal(docs[1][k], docs[3][k])


def test_plan_cache_is_still_exported(tmp_path):
    cache = PlanCache(str(tmp_path))
    cache.put("k", {"t": np.arange(3)})
    assert cache.get("k")[0]["t"].tolist() == [0, 1, 2]


def test_numpy_and_scalar_leaves(tmp_path):
    """Leaves that are not tensors are saved as numpy arrays and come back
    as tensors of the ``like`` tree's structure."""
    tree = {"a": np.arange(4, dtype=np.int32), "b": [np.float32(2.5)]}
    store = CheckpointStore(str(tmp_path))
    store.save(1, tree)
    got, manifest = store.restore(1, tree)
    assert manifest["dtypes"] == {"a": "int32", "b/0": "float32"}
    assert got["a"].tolist() == [0, 1, 2, 3] and float(got["b"][0]) == 2.5
