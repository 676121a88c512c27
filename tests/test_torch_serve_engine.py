"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

For a dense, an MoE, an SSM and a hybrid architecture (reduced), the
JAX parameters are carried over; then ``generate`` at a float32 cache
gives the JAX engine's tokens exactly, and at the default bfloat16 cache
each step's logits (prefill, then decode steps fed the same tokens) are
within ``BF16_TOL`` of the JAX engine's steps (the largest difference
seen at these shapes is 4.2e-5; a float32 key or value that the two
packages round to neighbouring bfloat16 values, 8 bits of mantissa,
moves a logit by up to about 1e-3).  The first generated
token is the argmax of the full forward (the twin of
``tests/test_train_substrate.py::TestServeEngine``).  Asking for the card
where there is none raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine

ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-7b")
BATCH, PROMPT, N_NEW = 4, 8, 6
MAX_LEN = PROMPT + N_NEW + 2
BF16_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def built():
    """name → (JAX cfg, port cfg, JAX params, port params, prompts, JAX
    tokens at a float32 cache)."""
    cache = {}

    def build(name):
        if name not in cache:
            jcfg = jax_get_config(name, reduced=True)
            cfg = get_config(name, reduced=True)
            jp = jax.jit(JT.init_model, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
            tp = model_params_from_numpy(
                cfg, jax.tree.map(np.asarray, jp), "cpu")
            prompts = np.random.default_rng(1).integers(
                0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
            toks = JaxServeEngine(jcfg, jp, batch=BATCH, max_len=MAX_LEN,
                                  cache_dtype=jnp.float32).generate(
                {"tokens": prompts}, N_NEW)
            cache[name] = (jcfg, cfg, jp, tp, prompts, toks)
        return cache[name]

    return build


@pytest.mark.parametrize("name", ARCHS)
def test_generate_float32_cache_equals_jax_tokens(name, built):
    _, cfg, _, tp, prompts, want = built(name)
    eng = ServeEngine(cfg, tp, batch=BATCH, max_len=MAX_LEN,
                      cache_dtype=torch.float32, device="cpu")
    got = eng.generate({"tokens": prompts}, N_NEW)
    assert got.shape == (BATCH, N_NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a tensor batch gives the same tokens
    np.testing.assert_array_equal(
        eng.generate({"tokens": torch.from_numpy(prompts)}, N_NEW), want)


@pytest.mark.parametrize("name", ARCHS)
def test_bfloat16_cache_step_logits_near_jax(name, built):
    """The default bfloat16 cache: prefill, then each decode step fed the
    JAX engine's float32 tokens, against the JAX steps at a bfloat16
    cache; ``generate`` runs at that cache too."""
    jcfg, cfg, jp, tp, prompts, toks = built(name)
    jcaches = JT.init_cache(jcfg, BATCH, MAX_LEN, dtype=jnp.bfloat16)
    caches = T.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.bfloat16)
    want, jcaches = JT.prefill(jcfg, jp, {"tokens": prompts}, jcaches)
    got, caches = T.prefill(cfg, tp, {"tokens": torch.from_numpy(prompts)},
                            caches)
    steps = [(got, want)]
    for i in range(N_NEW - 1):
        tok = toks[:, i:i + 1]
        want, jcaches = JT.decode_step(jcfg, jp, jnp.asarray(tok), jcaches,
                                       jnp.int32(PROMPT + i))
        got, caches = T.decode_step(cfg, tp, torch.from_numpy(tok), caches,
                                    PROMPT + i)
        steps.append((got, want))
    for i, (g, w) in enumerate(steps):
        np.testing.assert_allclose(
            g[..., :cfg.vocab].float().numpy(),
            np.asarray(w, dtype=np.float32)[..., :cfg.vocab], **BF16_TOL,
            err_msg=f"{name} step {i}")
    out = ServeEngine(cfg, tp, batch=BATCH, max_len=MAX_LEN,
                      device="cpu").generate({"tokens": prompts}, N_NEW)
    assert out.shape == (BATCH, N_NEW)
    assert ((out >= 0) & (out < cfg.vocab)).all()


def test_first_token_is_argmax_of_full_forward(built):
    _, cfg, _, tp, prompts, _ = built("qwen3-0.6b")
    eng = ServeEngine(cfg, tp, batch=BATCH, max_len=32,
                      cache_dtype=torch.float32, device="cpu")
    out = eng.generate({"tokens": prompts}, n_new=4)
    assert out.shape == (BATCH, 4)
    logits, _ = T.forward_logits(cfg, tp,
                                 {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_array_equal(
        out[:, 0], logits[:, -1, :cfg.vocab].argmax(-1).numpy())


def test_vlm_positions_start_after_the_patch_slots(built):
    """A VLM engine offsets decode positions by ``frontend_len`` even with
    no patches given, as the JAX engine does."""
    name = "internvl2-76b"
    jcfg, cfg = jax_get_config(name, reduced=True), get_config(
        name, reduced=True)
    jp = jax.jit(JT.init_model, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(0))
    tp = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    want = JaxServeEngine(jcfg, jp, batch=2, max_len=MAX_LEN,
                          cache_dtype=jnp.float32).generate(
        {"tokens": prompts}, 3)
    got = ServeEngine(cfg, tp, batch=2, max_len=MAX_LEN,
                      cache_dtype=torch.float32, device="cpu").generate(
        {"tokens": prompts}, 3)
    np.testing.assert_array_equal(got, want)


def test_cuda_device_without_a_card_raises(monkeypatch):
    """``device="cuda"`` (the default) with no card visible raises; the
    engine never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServeEngine(cfg, params, batch=2, max_len=8)
