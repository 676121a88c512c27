"""The port's training math (``repro_torch.train``, ``train_loss``)
against the JAX package's, on the CPU.

Same inputs (numpy, seeded) and carried-over parameters
(``convert.model_params_from_numpy``, ``opt_state_from_numpy``) go
through both packages, in float32:

* the pytree helper's leaf order and key paths equal JAX's;
* ``cross_entropy`` and ``chunked_ce_from_hidden`` (chunked, whole,
  ragged; with and without a mask), values and gradients;
* ``train_loss`` and every gradient leaf for each family's reduced
  config at 2 layers (the MTP head on a reduced deepseek-v3, the VLM
  patch slice on internvl2): loss within 1e-5 relative, gradients
  within ``rtol=1e-4, atol=1e-6``; remat on and off give equal
  gradients;
* one AdamW and one Adafactor step from identical gradients within
  1e-6, and a 5-step trajectory's losses within 1e-4 relative;
* gradient accumulation 4 against 1 (and against JAX's 4);
* int8 codes and error feedback equal, and ``compressed_psum`` over 2
  and 4 positions equal to the JAX function under ``shard_map`` (run in
  a subprocess with 4 forced host devices, as
  ``tests/test_elastic_restore.py`` runs its mesh).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train import compression as JC
from repro.train.optimizer import global_norm as jax_global_norm
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro.train.train_step import grads_and_metrics as jax_grads
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.train import compression as C
from repro_torch import tree
from repro_torch.train.optimizer import global_norm, make_optimizer
from repro_torch.train.train_step import grads_and_metrics, make_train_step

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
BATCH, SEQ = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# one family each, and deepseek-v3 for MLA, MoE with a dense prefix and MTP
FAMILIES = ["qwen3-0.6b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-7b",
            "whisper-large-v3", "internvl2-76b", "deepseek-v3-671b"]


def make_batch(cfg, seq=SEQ, batch=BATCH, key=0):
    rng = np.random.default_rng(key)
    tok = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    b = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if key:
        b[key] = rng.normal(
            size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return b


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def numpy_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: on a loaded machine
    (the suite's other workers) a parallel region waits on its slowest
    thread, which can stretch each small op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    """name (and overrides) → (JAX cfg, port cfg, JAX params, port
    params as a fresh copy each call: the port's optimizer updates in
    place)."""
    cache = {}

    def build(name, **over):
        jcfg = jax_get_config(name, reduced=True, **over)
        cfg = get_config(name, reduced=True, **over)
        if name not in cache:
            cache[name] = jax.jit(JT.init_model, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        jp = cache[name]
        return jcfg, cfg, jp, model_params_from_numpy(cfg, numpy_tree(jp),
                                                      "cpu")

    return build


def assert_leaves_close(port_tree, jax_tree, **tol):
    got = [np.asarray(x) for x in tree.tree_leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


# ------------------------------------------------------------------ trees
def test_tree_order_and_paths_equal_jax():
    """Dict keys sorted, then list and tuple order; ``None`` is an empty
    subtree; keys as the JAX store builds them."""
    t = ({"b": [np.zeros(1), (np.ones(2), None)],
          "a": {"z": np.zeros(3), "c": np.ones(1)}},
         {"m": [np.full(2, 5.0), np.full(1, 6.0)]})
    jpaths = jax.tree_util.tree_flatten_with_path(t)[0]
    paths = list(tree.tree_flatten_with_path(t))
    assert [tree.key_of(p) for p, _ in paths] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jpaths]
    assert [tree.key_of(p) for p, _ in paths][:2] == ["0/a/c", "0/a/z"]
    for (_, a), (_, b) in zip(paths, jpaths):
        assert a is b
    doubled = tree.tree_map(lambda x: 2 * x, t)
    assert list(doubled[0]) == ["b", "a"] and doubled[0]["b"][1][1] is None
    assert isinstance(doubled[0]["b"][1], tuple)
    again = tree.tree_unflatten(t, tree.tree_leaves(doubled))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(doubled)):
        assert a is b
    with pytest.raises(ValueError, match="1 leaves for a tree of 6"):
        tree.tree_unflatten(t, [np.zeros(1)])


def test_port_param_leaves_are_in_jax_order(built):
    """The port's ``init_model`` inserts keys unsorted; its leaves still
    come in the JAX tree's order."""
    _, cfg, jp, p = built("deepseek-v3-671b")
    assert list(p) != sorted(p)
    for a, b in zip(tree.tree_leaves(p), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
    assert [tree.key_of(k) for k, _ in tree.tree_flatten_with_path(p)] == [
        "/".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]


# -------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_cross_entropy_equals_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = T.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cross_entropy_all_masked_is_zero():
    got = T.cross_entropy(torch.ones(1, 3, 4),
                          torch.zeros(1, 3, dtype=torch.int32),
                          torch.zeros(1, 3))
    assert float(got) == 0.0


@pytest.mark.parametrize("chunk", [8, 0, 16, 6],
                         ids=["chunked", "off", "whole", "ragged"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_chunked_ce_equals_jax(built, chunk, masked):
    """Two chunks of 8 over 16 positions, and the whole-logits fallback
    (off, a sequence no longer than a chunk, not a multiple of it):
    value, and gradients to the hidden states and the (tied)
    embedding."""
    jcfg, cfg, jp, p = built("qwen3-0.6b", ce_chunk=chunk)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    mask = (rng.random((BATCH, SEQ)) > 0.3).astype(np.float32) \
        if masked else None

    def jloss(embed, hh):
        return JT.chunked_ce_from_hidden(
            jcfg, {**jp, "embed": embed}, hh, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))

    want, (jg_e, jg_h) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp["embed"], jnp.asarray(h))
    embed = p["embed"].requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    got = T.chunked_ce_from_hidden(
        cfg, {**p, "embed": embed}, ht, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    g_e, g_h = torch.autograd.grad(got, (embed, ht))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(g_e.numpy(), np.asarray(jg_e), **GRAD_TOL)
    np.testing.assert_allclose(g_h.numpy(), np.asarray(jg_h), **GRAD_TOL)


# ------------------------------------------------------------- train_loss
def port_loss_and_grads(cfg, p, batch):
    leaves = [x.detach().requires_grad_() for x in tree.tree_leaves(p)]
    loss, metrics = T.train_loss(cfg, tree.tree_unflatten(p, leaves),
                                 tensors(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, [torch.zeros_like(x) if g is None else g
                           for g, x in zip(grads, leaves)]


@pytest.mark.parametrize("name", FAMILIES)
def test_train_loss_and_grads_equal_jax(name, built):
    jcfg, cfg, jp, p = built(name)
    batch = make_batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda pp, b: JT.train_loss(jcfg, pp, b), has_aux=True))(jp, batch)
    loss, metrics, grads = port_loss_and_grads(cfg, p, batch)
    assert set(metrics) == set(jmetrics)
    if cfg.mtp:
        assert "mtp_loss" in metrics
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("name", FAMILIES + ["deepseek-coder-33b",
                                             "qwen1.5-110b", "starcoder2-7b"])
def test_remat_gives_the_same_gradients(name):
    """``remat=True`` recomputes every layer in the backward pass (the
    reduced configs turn it off); the gradients are the same."""
    cfg = get_config(name, reduced=True)
    p = T.init_model(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg)
    off = port_loss_and_grads(cfg.with_(remat=False), p, batch)
    on = port_loss_and_grads(cfg.with_(remat=True), p, batch)
    assert on[0].item() == off[0].item()
    for a, b in zip(on[2], off[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_serving_forward_is_unchanged_under_remat(built):
    """Under ``inference_mode`` (serving) remat wraps nothing: the
    forward and the cached prefill give what they give without it."""
    _, cfg, _, p = built("qwen3-0.6b")
    batch = tensors({"tokens": make_batch(cfg)["tokens"]})
    with torch.inference_mode():
        a, _ = T.forward_logits(cfg.with_(remat=True), p, batch)
        b, _ = T.forward_logits(cfg, p, batch)
        caches = T.init_cache(cfg, BATCH, SEQ, dtype=torch.float32)
        c, _ = T.prefill(cfg.with_(remat=True), p, batch, caches)
    assert torch.equal(a, b) and torch.equal(c, b[:, -1:])


# ------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_step_from_identical_grads_equals_jax(name, built):
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    rng = np.random.default_rng(2)
    jgrads = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                              * 1e-2), jp)
    grads = model_params_from_numpy(cfg, numpy_tree(jgrads), "cpu")
    jopt, opt = jax_make_optimizer(name), make_optimizer(name)
    jstate = jopt.init(jp)
    state = opt_state_from_numpy(opt, p, numpy_tree(jstate), "cpu")
    jupdate = jax.jit(jopt.update)
    for step in (0, 1):                 # a zero state, then a warm one
        jp2, jstate = jupdate(jgrads, jstate, jp, jnp.int32(step))
        p2, state = opt.update(grads, state, p, np.int32(step))
        assert p2 is p                  # in place (the JAX step donates)
        assert_leaves_close(p2, jp2, rtol=1e-6, atol=1e-6)
        assert_leaves_close(state, jstate, rtol=1e-6, atol=1e-6)
        jp = jp2
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jax_global_norm(jgrads)), rtol=1e-6)


def test_adafactor_state_is_factored(built):
    _, _, _, p = built("qwen3-0.6b")
    state = make_optimizer("adafactor").init(p)
    n_param = sum(x.numel() for x in tree.tree_leaves(p))
    n_state = sum(x.numel() for x in tree.tree_leaves(state))
    assert n_state < 0.2 * n_param
    assert make_optimizer("adamw").init(p)["m"][0].dtype == torch.float32
    with pytest.raises(ValueError):
        make_optimizer("sgd")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_five_step_trajectory_equals_jax(name, built):
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    jopt, opt = jax_make_optimizer(name), make_optimizer(name)
    jstate = jopt.init(jp)
    state = opt_state_from_numpy(opt, p, numpy_tree(jstate), "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=SEQ, seed=1)
    jl, tl = [], []
    for i in range(5):
        jp, jstate, jm = jstep(jp, jstate, pipe.batch_at(i), jnp.int32(i))
        p, state, m = step(p, state, pipe.batch_at(i), np.int32(i))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_grad_accum_4_equals_1_and_jax(built):
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    batch = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=SEQ,
                          seed=1).batch_at(3)
    g1, m1 = grads_and_metrics(cfg.with_(grad_accum=1), p, batch)
    g4, m4 = grads_and_metrics(cfg.with_(grad_accum=4), p, batch)
    jg4, jm4 = jax_grads(jcfg.with_(grad_accum=4), jp, batch)
    for a, b in zip(tree.tree_leaves(g1), tree.tree_leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    assert_leaves_close(g4, jg4, **GRAD_TOL)
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of grad_accum 3"):
        grads_and_metrics(cfg.with_(grad_accum=3), p, batch)


def test_opt_state_from_numpy_refuses_a_wrong_leaf(built):
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    opt = make_optimizer("adamw")
    state = numpy_tree(jax_make_optimizer("adamw").init(jp))
    state["m"][3] = state["m"][3][..., :1]
    with pytest.raises(ValueError, match=r"^m/3: float32"):
        opt_state_from_numpy(opt, p, state, "cpu")
    state["m"].pop()
    with pytest.raises(ValueError, match=r"missing leaves \['m/"):
        opt_state_from_numpy(opt, p, state, "cpu")
    fact = numpy_tree(jax_make_optimizer("adafactor").init(jp))
    with pytest.raises(ValueError, match="unexpected leaves"):
        opt_state_from_numpy(opt, p, fact, "cpu")


# ------------------------------------------------------------ compression
def test_int8_codes_equal_jax():
    """Random values and exact halves of the scale (rounded half to
    even by both packages)."""
    rng = np.random.default_rng(0)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                      np.float32)
    for g in (rng.normal(size=(257,)).astype(np.float32), halves,
              np.zeros(4, np.float32)):
        jq, js = JC.quantize_int8(jnp.asarray(g))
        q, s = C.quantize_int8(torch.from_numpy(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            C.dequantize_int8(q, s).numpy(),
            np.asarray(JC.dequantize_int8(jq, js)))
    q, _ = C.quantize_int8(torch.from_numpy(halves))
    assert q[1:4].tolist() == [0, 2, 2]


def test_error_feedback_equals_jax(built):
    """Two compressions in a row: the dequantized gradients and the
    carried residuals equal the JAX function's (run op by op) bit for
    bit."""
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    rng = np.random.default_rng(3)
    jinit, jcompress = JC.make_error_feedback_compressor()
    init, compress = C.make_error_feedback_compressor()
    # op by op: under jit XLA fuses ``g32 - q * scale`` and the residuals
    # move by an ulp
    jstate, state = {"compression": jinit(jp)}, {"compression": init(p)}
    for _ in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), jp)
        jout, jstate = jcompress(g, jstate)
        out, state = compress(
            model_params_from_numpy(cfg, numpy_tree(g), "cpu"), state)
        assert_leaves_close(out, jout, rtol=0, atol=0)
        assert_leaves_close(state, jstate, rtol=0, atol=0)
    assert max(float(e.abs().max())
               for e in state["compression"]["ef"]) > 0


def test_compressed_train_step_equals_jax(built):
    jcfg, cfg, jp, p = built("qwen3-0.6b")
    jinit, jcompress = JC.make_error_feedback_compressor()
    init, compress = C.make_error_feedback_compressor()
    jopt, opt = jax_make_optimizer("adamw", lr=5e-3), \
        make_optimizer("adamw", lr=5e-3)
    jstate = {**jopt.init(jp), "compression": jinit(jp)}
    state = {**opt.init(p), "compression": init(p)}
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, compress=jcompress))
    step = make_train_step(cfg, opt, compress=compress)
    batch = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=SEQ,
                          seed=1).batch_at(0)
    for i in range(3):
        jp, jstate, jm = jstep(jp, jstate, batch, jnp.int32(i))
        p, state, m = step(p, state, batch, np.int32(i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    # the parameters are not compared: gradients equal to float32
    # rounding may still straddle a half step of the int8 scale and
    # quantize one code apart (test_error_feedback_equals_jax holds the
    # codes to JAX's on identical gradients)
    assert set(state) == set(jstate) == {"m", "v", "compression"}


PSUM_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys; sys.path.insert(0, %r)
import jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.train.compression import compressed_psum

g = np.load(sys.argv[1])
out = {}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    f = shard_map(lambda x: compressed_psum(x, "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"))
    out[str(n)] = np.asarray(f(g[:n * 2]))
np.savez(sys.argv[2], **out)
print("PSUM_OK")
"""


def test_compressed_psum_equals_jax_shard_map(tmp_path):
    """2 and 4 data positions, two rows each: every position's reduced
    copy equals the JAX function's under ``shard_map``."""
    rng = np.random.default_rng(1)
    g = (rng.normal(size=(8, 16)) * rng.uniform(0.1, 3, (8, 1))).astype(
        np.float32)
    np.save(tmp_path / "g.npy", g)
    r = subprocess.run(
        [sys.executable, "-c", PSUM_SCRIPT % SRC, str(tmp_path / "g.npy"),
         str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-3000:])
    want = np.load(tmp_path / "out.npz")
    for n in (2, 4):
        shards = [torch.from_numpy(g[2 * i:2 * i + 2]) for i in range(n)]
        got = C.compressed_psum(shards)
        assert len(got) == n
        np.testing.assert_array_equal(torch.cat(got).numpy(), want[str(n)])
        # exact in the shared scale: the sum of the positions within one
        # quantization step a position
        total = sum(s.numpy() for s in shards)
        scale = max(np.abs(s.numpy()).max() for s in shards) / 127.0
        assert np.abs(got[0].numpy() - total).max() <= n * scale / 2 + 1e-6
