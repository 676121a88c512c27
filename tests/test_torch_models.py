"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU.

The config registry equals the JAX one field for field, full and
reduced.  For every architecture (reduced, float32) the JAX parameters
are carried over with ``convert.model_params_from_numpy``; then the
port's ``forward_logits`` equals JAX's within ``rtol=atol=1e-4``, and
prefill on S-1 tokens then ``decode_step`` equals the full forward at S,
in the port and against JAX's decode logits, within ``2e-4`` (the JAX
smoke test's own tolerance).  Edge cases, each against JAX: TP head
padding (the head mask), the query-chunked attention branch, a Mamba2
prompt padded to whole chunks, an MoE whose capacity drops tokens, and
MLA's absorbed decode.  Each architecture's JAX side is built once per
module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

BATCH, SEQ = 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)


def make_batch(cfg, seq=SEQ, key=0):
    """The JAX smoke test's batch: tokens, and patches or frames."""
    rng = np.random.default_rng(key)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            size=(BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(
            size=(BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return b


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def carry(cfg, jparams):
    return model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                   "cpu")


def vocab_slice(x, cfg):
    return np.asarray(x, dtype=np.float32)[..., :cfg.vocab]


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
    """name (and overrides) → (JAX cfg, port cfg, JAX params, port params).

    Overrides that leave the parameter shapes alone reuse the
    architecture's parameters (``pad_heads_to`` changes them)."""
    cache = {}

    def build(name, **over):
        shaping = over.get("pad_heads_to", 0)
        jcfg = jax_get_config(name, reduced=True, **over)
        cfg = get_config(name, reduced=True, **over)
        if (name, shaping) not in cache:
            jp = jax.jit(JT.init_model, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
            cache[name, shaping] = (jp, carry(cfg, jp))
        return (jcfg, cfg) + cache[name, shaping]

    return build


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", JAX_ARCHS)
def test_config_registry_equals_jax(name, reduced):
    cfg = get_config(name, reduced=reduced)
    jcfg = jax_get_config(name, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg._head_geometry(), cfg.vocab_eff, cfg.d_inner,
            cfg.ssm_heads) == (jcfg._head_geometry(), jcfg.vocab_eff,
                               jcfg.d_inner, jcfg.ssm_heads)
    assert get_config(name, reduced=reduced, vocab=256) \
        == cfg.with_(vocab=256)


def test_registry_names_and_unknown_arch():
    assert ARCHS == JAX_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


# ---------------------------------------------------------- carried params
@pytest.mark.parametrize("fault", ["shape", "dtype", "missing", "extra",
                                   "not-a-dict"])
def test_model_params_from_numpy_refuses_a_wrong_tree(fault, built):
    jcfg, cfg, jp, _ = built("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, jp)
    attn = tree["layers"]["attn"]
    if fault == "shape":
        attn["wq"] = attn["wq"][:, :, :1]
        match = r"layers/attn/wq: float32\[2, 64, 1, 16\], expected"
    elif fault == "dtype":
        attn["wq"] = attn["wq"].astype(np.float16)
        match = "layers/attn/wq: float16"
    elif fault == "missing":
        del attn["q_norm"]
        match = r"layers/attn: missing keys \['q_norm'\]"
    elif fault == "extra":
        attn["bq"] = np.zeros((4, 16), np.float32)
        match = r"unexpected keys \['bq'\]"
    else:
        tree["final_norm"] = tree["final_norm"]["scale"]
        match = "final_norm: expected a dict"
    with pytest.raises(ValueError, match=match):
        model_params_from_numpy(cfg, tree, "cpu")


def test_carried_params_equal_the_jax_tree(built):
    """The carry-over is a copy: the same keys, shapes and values."""
    _, cfg, jp, tp = built("deepseek-v3-671b")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == 45
    for path, leaf in flat:
        got = tp
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("name", ARCHS)
def test_init_model_tree_matches_jax_layout(name, built):
    """The port's own init: the JAX tree's keys, shapes, dtypes, on the
    generator's device, with the JAX initialiser's scales."""
    jcfg, cfg, jp, _ = built(name)
    tp = T.init_model(cfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        got = tp
        for p in path:
            got = got[p.key]
        leaf = np.asarray(leaf)
        assert tuple(got.shape) == leaf.shape and got.device.type == "cpu"
        assert str(got.dtype) == f"torch.{leaf.dtype}"
        if leaf.size >= 1024 and leaf.std() > 0:
            assert got.float().std().item() == pytest.approx(leaf.std(),
                                                             rel=0.15)
        elif leaf.std() == 0:
            np.testing.assert_array_equal(got.numpy(), leaf)


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_equal_jax(name, built):
    jcfg, cfg, jp, tp = built(name)
    batch = make_batch(cfg)
    want, _ = JT.forward_logits(jcfg, jp, batch)
    got, caches = T.forward_logits(cfg, tp, tensors(batch))
    assert caches is None
    extra = cfg.frontend_len if cfg.family == "vlm" else 0
    assert tuple(got.shape) == (BATCH, SEQ + extra, cfg.vocab_eff)
    np.testing.assert_allclose(vocab_slice(got, cfg), vocab_slice(want, cfg),
                               **TOL, err_msg=name)
    # the vocab pad lanes are masked to -1e30, as in the JAX unembed
    if cfg.vocab_eff != cfg.vocab:
        assert (got[..., cfg.vocab:] == -1e30).all()


def _prefill_decode(mod, cfg, params, batch, dtype, as_input):
    """Prefill on S-1 tokens, then decode token S: its logits."""
    extra = cfg.frontend_len if cfg.family == "vlm" else 0
    caches = mod.init_cache(cfg, BATCH, SEQ + 4 + extra, dtype=dtype)
    pre = dict(batch)
    pre["tokens"] = batch["tokens"][:, :SEQ - 1]
    _, caches = mod.prefill(cfg, params, as_input(pre), caches)
    tok = as_input({"t": batch["tokens"][:, SEQ - 1:SEQ]})["t"]
    logits, _ = mod.decode_step(cfg, params, tok, caches, SEQ - 1 + extra)
    return logits


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_equals_forward_and_jax(name, built):
    """Every cache implementation: prefill on S-1 then decode S equals the
    full forward at S, in the port and against JAX's decode."""
    jcfg, cfg, jp, tp = built(name)
    batch = make_batch(cfg)
    got = _prefill_decode(T, cfg, tp, batch, torch.float32, tensors)
    want = _prefill_decode(JT, jcfg, jp, batch, jnp.float32, dict)
    full, _ = T.forward_logits(cfg, tp, tensors(batch))
    np.testing.assert_allclose(vocab_slice(got[:, -1], cfg),
                               vocab_slice(full[:, -1], cfg),
                               **DECODE_TOL, err_msg=name)
    np.testing.assert_allclose(vocab_slice(got, cfg), vocab_slice(want, cfg),
                               **DECODE_TOL, err_msg=name)


def test_init_cache_layout_equals_jax():
    """Every family's cache tree: the JAX keys and shapes; the SSD state
    is float32 whatever the cache dtype."""
    for name in ARCHS:
        cfg, jcfg = (get_config(name, reduced=True),
                     jax_get_config(name, reduced=True))
        got = T.init_cache(cfg, 3, 12)
        want = JT.init_cache(jcfg, 3, 12)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        n = 0
        for path, leaf in flat:
            t = got
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape, (name, path)
            assert str(t.dtype) == f"torch.{leaf.dtype}", (name, path)
            n += 1
        assert n == len(jax.tree.leaves(got)), name


# -------------------------------------------------------------- edge cases
def test_head_padding_mask_equals_jax(built):
    """``pad_heads_to=8`` on starcoder2 (4 heads, 2 KV): padded query slots
    are masked, and the KV heads repeat to the padded count."""
    jcfg, cfg, jp, tp = built("starcoder2-7b", pad_heads_to=8)
    assert cfg.n_heads_eff > cfg.n_heads
    mask = L._head_mask(cfg, "cpu")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(JL._head_mask(jcfg)))
    batch = make_batch(cfg)
    want, _ = JT.forward_logits(jcfg, jp, batch)
    got, _ = T.forward_logits(cfg, tp, tensors(batch))
    np.testing.assert_allclose(vocab_slice(got, cfg), vocab_slice(want, cfg),
                               **TOL)
    dec = _prefill_decode(T, cfg, tp, batch, torch.float32, tensors)
    np.testing.assert_allclose(vocab_slice(dec[:, -1], cfg),
                               vocab_slice(got[:, -1], cfg), **DECODE_TOL)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_query_chunked_attention_equals_jax(name, built):
    """``attn_chunk=8`` at SEQ 16: the query-chunked branch (GQA and MLA)
    equals JAX's and the unchunked forward."""
    jcfg, cfg, jp, tp = built(name, attn_chunk=8)
    batch = make_batch(cfg)
    want, _ = JT.forward_logits(jcfg, jp, batch)
    got, _ = T.forward_logits(cfg, tp, tensors(batch))
    np.testing.assert_allclose(vocab_slice(got, cfg), vocab_slice(want, cfg),
                               **TOL)
    plain, _ = T.forward_logits(cfg.with_(attn_chunk=1024), tp,
                                tensors(batch))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("seq", [13, 21])
def test_mamba2_padded_chunks_equal_jax(seq, built):
    """A prompt longer than ``ssm_chunk`` (8) and not a multiple of it is
    padded to whole chunks: the forward and the prefill → decode state."""
    jcfg, cfg, jp, tp = built("mamba2-780m")
    assert seq > cfg.ssm_chunk and seq % cfg.ssm_chunk
    batch = make_batch(cfg, seq=seq)
    want, _ = JT.forward_logits(jcfg, jp, batch)
    got, _ = T.forward_logits(cfg, tp, tensors(batch))
    np.testing.assert_allclose(vocab_slice(got, cfg), vocab_slice(want, cfg),
                               **TOL)
    caches = T.init_cache(cfg, BATCH, seq + 2, dtype=torch.float32)
    jcaches = JT.init_cache(jcfg, BATCH, seq + 2, dtype=jnp.float32)
    _, caches = T.prefill(cfg, tp, tensors(batch), caches)
    _, jcaches = JT.prefill(jcfg, jp, batch, jcaches)
    np.testing.assert_allclose(caches["main"]["ssd"].numpy(),
                               np.asarray(jcaches["main"]["ssd"]), **TOL)
    np.testing.assert_allclose(caches["main"]["conv_x"].numpy(),
                               np.asarray(jcaches["main"]["conv_x"]), **TOL)


def test_moe_capacity_drop_equals_jax(built):
    """512 tokens over 8 experts at ``capacity_factor=0.25`` (capacity
    128): experts past capacity drop tokens to the spill slot, weight 0,
    as the JAX dispatch does."""
    jcfg, cfg, jp, tp = built("qwen3-moe-30b-a3b", capacity_factor=0.25)
    lp = T.layer(tp["layers"], 0)["moe"]
    jlp = jax.tree.map(lambda t: t[0], jp["layers"]["moe"])
    x = np.random.default_rng(3).normal(size=(4, 128, cfg.d_model)).astype(
        np.float32)
    _, idx = L._router_weights(
        cfg, torch.from_numpy(x).reshape(-1, cfg.d_model) @ lp["router"])
    per_expert = np.bincount(idx.reshape(-1).numpy(), minlength=8)
    assert per_expert.max() > 128        # some tokens are dropped
    got = L.moe(cfg, lp, torch.from_numpy(x))
    want = JL.moe(jcfg, jlp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with room for every token the result changes
    roomy = L.moe(cfg.with_(capacity_factor=8.0), lp, torch.from_numpy(x))
    assert not torch.allclose(roomy, got, **TOL)


def test_mla_absorbed_decode_equals_jax(built):
    """MLA decode with the absorbed matmuls (the default at one token with
    a cache) equals JAX's absorbed step and the port's plain form."""
    jcfg, cfg, jp, tp = built("deepseek-v3-671b")
    lp = T.layer(tp["layers"], 0)["attn"]
    jlp = jax.tree.map(lambda t: t[0], jp["layers"]["attn"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (BATCH, 9))
    cache = {"c_kv": torch.zeros(BATCH, 12, cfg.kv_lora_rank),
             "k_rope": torch.zeros(BATCH, 12, cfg.qk_rope_dim)}
    jcache = {k: jnp.zeros(v.shape, jnp.float32) for k, v in cache.items()}
    L.mla_attention(cfg, lp, torch.from_numpy(x[:, :8]),
                    positions=torch.from_numpy(pos[:, :8].copy()),
                    cache=cache)
    jmla = jax.jit(lambda *a, **k: JL.mla_attention(jcfg, *a, **k),
                   static_argnames="absorbed")
    _, jcache = jmla(jlp, jnp.asarray(x[:, :8]),
                     positions=jnp.asarray(pos[:, :8]), cache=jcache)
    step = torch.from_numpy(x[:, 8:])
    at = torch.full((BATCH, 1), 8, dtype=torch.int32)
    outs = {}
    for absorbed in (None, False):
        c = {k: v.clone() for k, v in cache.items()}
        outs[absorbed], _ = L.mla_attention(cfg, lp, step, positions=at,
                                            cache=c, cache_pos=8,
                                            absorbed=absorbed)
    want, _ = jmla(jlp, jnp.asarray(x[:, 8:]),
                   positions=jnp.full((BATCH, 1), 8, jnp.int32),
                   cache=jcache, cache_pos=jnp.int32(8), absorbed=True)
    np.testing.assert_allclose(outs[None].numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(outs[None].numpy(), outs[False].numpy(),
                               **TOL)


# ------------------------------------------------------------------ layers
def test_primitives_equal_jax():
    """RMSNorm, the half-split RoPE, the interleaved sinusoid, the tanh
    GELU MLP and the causal conv, each against JAX's."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    scale = {"scale": rng.normal(size=(8,)).astype(np.float32)}
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), tensors(scale), 1e-6).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), scale, 1e-6)), **TOL)
    pos = np.arange(10).reshape(2, 5).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **TOL)
    np.testing.assert_allclose(
        T._sinusoid(torch.from_numpy(pos), 16).numpy(),
        np.asarray(JT._sinusoid(jnp.asarray(pos), 16)), **TOL)
    cfg = get_config("whisper-large-v3", reduced=True)
    p = {"wi": rng.normal(size=(64, 256)).astype(np.float32) / 8,
         "wo": rng.normal(size=(256, 64)).astype(np.float32) / 16}
    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        L.mlp(cfg, tensors(p), torch.from_numpy(h), gelu=True).numpy(),
        np.asarray(JL.mlp(cfg, p, jnp.asarray(h), gelu=True)), **TOL)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    xs = rng.normal(size=(2, 5, 6)).astype(np.float32)
    got = L._causal_conv(*map(torch.from_numpy, (xs, w, b, st)))
    want = JL._causal_conv(*map(jnp.asarray, (xs, w, b, st)))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **TOL)
