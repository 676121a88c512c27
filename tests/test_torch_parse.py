"""Device parse of the port (K5 and ``parse_batch``) against the JAX package.

K5's plain version against ``predecode_pallas`` in interpret mode, on
malformed bytes and tags cut by row ends; ``compact_events``,
``structure_scan`` and ``parse_batch`` against the JAX package's (its
Pallas pre-decoder interpreted), ``DepthOverflow`` with the same document
indices included; the engine's parse-then-filter route (``fuse=False``)
against the fused one and the JAX oracle, and the base class's
``filter_bytes``, which raises where ``fuse=False`` clips.  Exact
equality throughout.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stream_filter import ragged_bb, workload  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.engines import base as jax_base  # noqa: E402
from repro.core.events import (CLOSE, OPEN, ByteBatch,  # noqa: E402
                               DepthOverflow as JaxDepthOverflow,
                               EventBatch, EventStream, encode_bytes)
from repro.data.generator import gen_corpus  # noqa: E402
from repro.kernels import parse as jax_parse  # noqa: E402
from repro.kernels.predecode import predecode_pallas  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.engines import base  # noqa: E402
from repro_torch.kernels import parse  # noqa: E402
from repro_torch.kernels import predecode as pd  # noqa: E402

FIELDS = ("kind", "tag_id", "depth", "parent", "valid", "n_events")


def port_bytes(bb):
    return tev.ByteBatch(np.asarray(bb.data), np.asarray(bb.n_bytes))


def messy_bytes(seed, rows=4, length=61):
    """Random bytes over '<', '/', symbols and others, with rows that end
    inside a tag (``<a``, ``</x``, ``<``) and one all-zero row."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"<<</>abcXYZ09_.x >\x00\xff", np.uint8)
    data = rng.choice(alphabet, size=(rows, length)).astype(np.uint8)
    for r, tail in zip(range(rows), (b"<a", b"</x", b"<")):
        data[r, length - len(tail):] = np.frombuffer(tail, np.uint8)
    data[-1] = 0
    return data


def deep_doc(tag, k):
    return EventStream(np.array([OPEN] * k + [CLOSE] * k, np.int8),
                       np.full(2 * k, tag, np.int32))


# ------------------------------------------------------------------- K5
class TestPredecode:
    @pytest.mark.parametrize("seed,shape", [(0, (4, 61)), (1, (3, 200)),
                                            (2, (1, 3))])
    def test_plain_equals_pallas(self, seed, shape):
        data = messy_bytes(seed, *shape) if shape[1] > 3 else \
            np.frombuffer(b"</a", np.uint8).reshape(1, 3).copy()
        jk, jt = predecode_pallas(jnp.asarray(data), interpret=True)
        tk, tt = pd.predecode(torch.from_numpy(data))
        assert tk.dtype == tt.dtype == torch.int32
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    def test_one_row_input_and_cpu_count(self):
        data = messy_bytes(3, 1, 90)[0]
        jk, jt = predecode_pallas(jnp.asarray(data), interpret=True)
        before = pd.predecode.launches
        tk, tt = pd.predecode(torch.from_numpy(data))
        assert pd.predecode.launches == before
        assert tk.shape == (90,)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        with pytest.raises(TypeError, match="uint8"):
            pd.predecode(torch.zeros(4, dtype=torch.int32))


# ----------------------------------------------------------------- parse
class TestParse:
    def test_compact_and_structure_equal_jax(self):
        """Random kinds with unbalanced closes and PADs inside rows, and a
        compaction bound below some rows' event counts."""
        rng = np.random.default_rng(4)
        kind_pos = rng.choice([0, 1, 2, 2], size=(3, 40)).astype(np.int32)
        tag_pos = np.where(kind_pos != 2, rng.integers(0, 99, (3, 40)),
                           -1).astype(np.int32)
        for n_events in (48, 9):
            k, t, n = parse.compact_events(torch.from_numpy(kind_pos),
                                           torch.from_numpy(tag_pos),
                                           n_events)
            for row in range(3):
                jk, jt, jn = jax_parse.compact_events(
                    jnp.asarray(kind_pos[row]), jnp.asarray(tag_pos[row]),
                    n_events)
                np.testing.assert_array_equal(k[row].numpy(), np.asarray(jk))
                np.testing.assert_array_equal(t[row].numpy(), np.asarray(jt))
                assert int(n[row]) == int(jn)
            for max_depth in (2, 8):
                depth, parent = parse.structure_scan(k, max_depth)
                for row in range(3):
                    jd, jp = jax_parse.structure_scan(
                        jnp.asarray(k[row].numpy()), max_depth)
                    np.testing.assert_array_equal(depth[row].numpy(),
                                                  np.asarray(jd))
                    np.testing.assert_array_equal(parent[row].numpy(),
                                                  np.asarray(jp))

    @pytest.mark.parametrize("source", ["corpus", "messy"])
    def test_parse_batch_equals_jax(self, source):
        if source == "corpus":
            dtd, d, qs, nfa = workload(n_queries=4, seed=5)
            bb = ragged_bb(dtd, d, 5, bucket=64)
        else:
            data = messy_bytes(6, 5, 77)
            bb = ByteBatch(data, np.full(5, 77, np.int32))
        n_events = bb.event_bound(bucket=16)
        want = jax_parse.parse_batch(bb, n_events=n_events, max_depth=12,
                                     use_kernel=True, interpret=True,
                                     check_depth=False)
        got = parse.parse_batch(port_bytes(bb), n_events=n_events,
                                max_depth=12, check_depth=False,
                                device="cpu")
        assert got.is_device and got.kind.device.type == "cpu"
        host = got.to_host()
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(host, f),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
            assert getattr(host, f).dtype == np.asarray(getattr(want, f)).dtype

    def test_depth_overflow_names_the_same_documents(self):
        dtd, d, qs, nfa = workload(n_queries=4, seed=7)
        tag = d.lookup(dtd.tag_names[0])
        docs = [deep_doc(tag, k) for k in (3, 8, 9, 1, 12)]
        bb = ByteBatch.from_streams(docs, text_fill=1, bucket=64)
        with pytest.raises(JaxDepthOverflow) as want:
            jax_parse.parse_batch(bb, max_depth=8, use_kernel=True,
                                  interpret=True)
        with pytest.raises(tev.DepthOverflow) as got:
            parse.parse_batch(port_bytes(bb), max_depth=8, device="cpu")
        assert got.value.doc_indices == want.value.doc_indices == (2, 4)
        assert str(got.value) == str(want.value)
        # deep enough: no raise, and the same batch
        ok = parse.parse_batch(port_bytes(bb), max_depth=12, device="cpu")
        assert int(ok.depth.max()) == 12


# ------------------------------------------------- engine: parse, then K1
class TestParseThenFilter:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_fuse_false_equals_fused_and_jax(self, seed):
        dtd, d, qs, nfa = workload(n_queries=24, seed=seed)
        bb = ragged_bb(dtd, d, seed)
        scan = jax_engines.create("streaming", nfa, dictionary=d,
                                  kernel="scan")
        fused = engines.create("streaming", nfa, dictionary=d, device="cpu")
        split = engines.create("streaming", nfa, dictionary=d, device="cpu",
                               fuse=False, event_bucket=16)
        want = scan.filter_bytes(bb)
        assert want.matched.any()
        for res in (fused.filter_bytes(port_bytes(bb)),
                    split.filter_bytes(port_bytes(bb)),
                    split.filter_bytes(port_bytes(bb), bucket=64)):
            np.testing.assert_array_equal(res.matched, want.matched)
            np.testing.assert_array_equal(res.first_event, want.first_event)

    def test_fuse_false_clips_where_base_filter_bytes_raises(self):
        """Both behaviours of the JAX package: the two-stage program has
        no depth check (it clips as K1 does), the base class's
        ``filter_bytes`` parses with one and raises."""
        dtd, d, qs, nfa = workload(n_queries=16, seed=5, p_wild=0.0)
        tag = d.lookup(next(st.tag for q in qs for st in q.steps
                            if st.tag != "*"))
        docs = [deep_doc(tag, 9)] + gen_corpus(dtd, n_docs=2,
                                               nodes_per_doc=30, seed=5)
        bb = ByteBatch.from_streams(docs, text_fill=2, bucket=128)
        jax_split = jax_engines.create("streaming", nfa, dictionary=d,
                                       max_depth=6, fuse=False,
                                       kernel="scan")
        split = engines.create("streaming", nfa, dictionary=d, device="cpu",
                               max_depth=6, fuse=False)
        want = jax_split.filter_bytes(bb)
        got = split.filter_bytes(port_bytes(bb))
        np.testing.assert_array_equal(got.matched, want.matched)
        np.testing.assert_array_equal(got.first_event, want.first_event)
        with pytest.raises(JaxDepthOverflow) as jerr:
            jax_base.FilterEngine.filter_bytes(jax_split, bb)
        with pytest.raises(tev.DepthOverflow) as err:
            base.FilterEngine.filter_bytes(split, port_bytes(bb))
        assert err.value.doc_indices == jerr.value.doc_indices
        assert 0 in err.value.doc_indices

    def test_device_parsed_batch_filters_as_host_batch(self):
        dtd, d, qs, nfa = workload(n_queries=20, seed=9)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=40, seed=9)
        bb = ByteBatch.from_streams(docs, text_fill=3, bucket=64)
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu")
        parsed = parse.parse_batch(port_bytes(bb), device="cpu")
        host = EventBatch.from_streams(docs)
        a = eng.filter_batch(parsed)
        b = eng.filter_batch(tev.EventBatch(host.kind, host.tag_id,
                                            host.depth, host.parent,
                                            host.valid, host.n_events))
        np.testing.assert_array_equal(a.matched, b.matched)
        np.testing.assert_array_equal(a.first_event, b.first_event)
        # and the base class's filter_bytes is that parse, then K1
        c = base.FilterEngine.filter_bytes(eng, port_bytes(bb))
        np.testing.assert_array_equal(c.matched, a.matched)
        np.testing.assert_array_equal(c.first_event, a.first_event)
        assert parsed.to_host().nbytes(8).tolist() \
            == host.nbytes(8).tolist()
        assert [encode_bytes(x, text_fill=3) for x in docs] \
            == list(bb.buffers())
