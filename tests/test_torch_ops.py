"""The port's public kernel wrappers against ``repro.kernels.ops``, on the CPU.

Each wrapper of ``repro_torch.kernels.ops`` (``device="cpu"``: the
kernels' plain versions) against the JAX package's wrapper of the same
name (its Pallas kernels in interpret mode) on the same seeded inputs:
``predecode`` (K5), ``nfa_transition`` (K6, given the parent one-hot, at
ragged W and S and with a one-hot from a padded plan), ``decode_document``
(K5 and the compaction) and ``StreamFilterKernelEngine`` (K1).  Exact
equality: K6's states are 0/1 floats, the rest integers.
"""
import numpy as np
import pytest
import torch

from repro.core.dictionary import TagDictionary as JaxDictionary
from repro.core.events import encode_bytes as jax_encode
from repro.core.nfa import compile_queries as jax_compile
from repro.core.nfa import pad_states as jax_pad_states
from repro.data.generator import DTD as JaxDTD
from repro.data.generator import gen_corpus as jax_corpus
from repro.data.generator import gen_profiles as jax_profiles
from repro.kernels import ops as jax_ops
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import decode_bytes, encode_bytes
from repro_torch.core.nfa import compile_queries, pad_states
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.kernels import ops


def _corpus(seed=0, n_docs=3, nodes=40):
    """(port dictionary, JAX dictionary, profiles of each, payloads): the
    same seeded workload in both packages."""
    out = []
    for dtd_cls, dict_cls, profiles, corpus, encode in (
            (DTD, TagDictionary, gen_profiles, gen_corpus, encode_bytes),
            (JaxDTD, JaxDictionary, jax_profiles, jax_corpus, jax_encode)):
        dtd = dtd_cls.generate(n_tags=14, seed=seed)
        d = dict_cls()
        dtd.register(d)
        qs = profiles(dtd, n=24, length=3, p_desc=0.5, p_wild=0.1,
                      seed=seed)
        docs = corpus(dtd, n_docs=n_docs, nodes_per_doc=nodes, seed=seed)
        out.append((d, qs, docs, [encode(x, text_fill=3) for x in docs]))
    (d, qs, docs, bufs), (jd, jqs, jdocs, jbufs) = out
    assert bufs == jbufs
    return d, qs, docs, jd, jqs, jdocs, bufs


@pytest.mark.parametrize("shape", ["row", "batch"])
def test_predecode_equals_jax(shape):
    *_, bufs = _corpus(seed=1)
    rng = np.random.default_rng(1)
    length = max(map(len, bufs)) + 5
    data = np.zeros((len(bufs) + 1, length), np.uint8)
    for i, b in enumerate(bufs):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
    data[-1] = rng.integers(0, 256, length, dtype=np.uint8)   # noise
    if shape == "row":
        data = data[0]
    kind, tag = ops.predecode(data, device="cpu")
    jkind, jtag = jax_ops.predecode(data)
    assert kind.dtype == tag.dtype == torch.int32
    np.testing.assert_array_equal(kind.numpy(), np.asarray(jkind))
    np.testing.assert_array_equal(tag.numpy(), np.asarray(jtag))
    assert (kind.numpy() != 2).any()
    # a tensor stays on its device
    kt, _ = ops.predecode(torch.from_numpy(data))
    assert kt.device.type == "cpu" and torch.equal(kt, kind)


def _k6_inputs(w, s, t, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.random((w, s)) < 0.3).astype(np.float32)
    tags = rng.integers(-1, t + 2, w).astype(np.int32)
    req = (rng.random((t, s)) < 0.2).astype(np.float32)
    wild = (rng.random(s) < 0.1).astype(np.float32)
    selfloop = (rng.random(s) < 0.2).astype(np.float32)
    onehot = np.zeros((s, s), np.float32)
    onehot[rng.integers(0, s, s), np.arange(s)] = 1
    return rows, tags, req, wild, onehot, selfloop


@pytest.mark.parametrize("w,s,t", [(1, 1, 1), (5, 37, 3), (130, 200, 9),
                                   (64, 512, 16)])
def test_nfa_transition_equals_jax_at_ragged_shapes(w, s, t):
    args = _k6_inputs(w, s, t, seed=w + s)
    got = ops.nfa_transition(*args, device="cpu")
    want = np.asarray(jax_ops.nfa_transition(*args))
    assert got.dtype == torch.float32 and got.shape == (w, s)
    np.testing.assert_array_equal(got.numpy(), want)
    # bw and bs are the TPU kernel's tiles: accepted, and nothing changes
    np.testing.assert_array_equal(
        ops.nfa_transition(*args, bw=8, bs=128, device="cpu").numpy(), want)


def test_nfa_transition_with_a_padded_plans_onehot():
    """The one-hot of a plan padded to 128 states (pad states included,
    each a column with its single 1 at state 0) gives the JAX result."""
    d, qs, docs, jd, jqs, jdocs, _ = _corpus(seed=2)
    unpadded = compile_queries(qs, d, shared=True)
    nfa = pad_states(unpadded, 128)
    jnfa = jax_pad_states(jax_compile(jqs, jd, shared=True), 128)
    onehot = nfa.parent_onehot()
    np.testing.assert_array_equal(onehot, jnfa.parent_onehot())
    s, t = onehot.shape[0], nfa.n_tags
    assert s % 128 == 0 and unpadded.n_states < s
    rows, tags, _, _, _, _ = _k6_inputs(96, s, t, seed=3)
    req, wild = nfa.req_matrix(), nfa.wild_vector()
    selfloop = nfa.tables.selfloop.astype(np.float32)
    args = (rows, tags, req, wild, onehot, selfloop)
    got = ops.nfa_transition(*args, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ops.nfa_transition(*args)))
    assert got.any()


def test_nfa_transition_refuses_a_onehot_that_is_not_one():
    rows, tags, req, wild, onehot, selfloop = _k6_inputs(4, 8, 2, seed=5)
    bad = onehot.copy()
    bad[0, 3] = bad[1, 3] = 1                       # two parents
    with pytest.raises(ValueError, match="column 3"):
        ops.nfa_transition(rows, tags, req, wild, bad, selfloop,
                           device="cpu")
    bad = onehot * 2                                # not a 1
    with pytest.raises(ValueError, match="not 1"):
        ops.nfa_transition(rows, tags, req, wild, bad, selfloop,
                           device="cpu")


def test_decode_document_equals_jax():
    d, _, docs, jd, _, _, bufs = _corpus(seed=3)
    for buf, ev in zip(bufs, docs):
        got = ops.decode_document(buf, d, device="cpu")
        want = jax_ops.decode_document(buf, jd)
        assert got.kind.dtype == want.kind.dtype == np.int8
        np.testing.assert_array_equal(got.kind, want.kind)
        np.testing.assert_array_equal(got.tag_id, want.tag_id)
        host = decode_bytes(buf, d.symbol_value_table())
        np.testing.assert_array_equal(got.kind, host.kind)
        np.testing.assert_array_equal(got.tag_id, host.tag_id)
        assert len(got) == 2 * ev.n_nodes
    # an empty payload is an empty document (the JAX wrapper's reshape of
    # a zero-length array raises there)
    assert len(ops.decode_document(b"", d, device="cpu")) == 0


@pytest.mark.parametrize("blk", [256, 32])
def test_stream_filter_kernel_engine_equals_jax(blk):
    d, qs, docs, jd, jqs, jdocs, _ = _corpus(seed=4, n_docs=4)
    eng = ops.StreamFilterKernelEngine(qs, d, blk=blk, device="cpu")
    jeng = jax_ops.StreamFilterKernelEngine(jqs, jd, blk=blk)
    assert eng.n_queries == jeng.n_queries == len(qs)
    assert eng._eng.plan_.meta["blk"] == jeng._eng.plan_.meta["blk"]
    n = 0
    for ev, jev in zip(docs, jdocs):
        got, want = eng.filter_document(ev), jeng.filter_document(jev)
        np.testing.assert_array_equal(got.matched, want.matched)
        np.testing.assert_array_equal(got.first_event, want.first_event)
        n += int(got.matched.sum())
    assert n > 0
