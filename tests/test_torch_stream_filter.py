"""The port's streaming-filter kernels against the JAX package's, on the CPU.

Kernel level: the same converted block tables and the same inputs go
through the Pallas kernels of ``repro.kernels.stream_filter`` (interpret
mode) and through the port's wrappers, which run their plain versions on
CPU tensors.  Outputs are 0/1 lanes and int32 ordinals, so the tolerance
is exact equality.  Plan level: the port's own ``plan()`` lays out the
same tables as the JAX plan, and ``plan_from_numpy`` carries them over.
"""
import numpy as np
import pytest
import torch

from repro.core import engines as jax_engines
from repro.core.dictionary import TagDictionary
from repro.core.events import (CLOSE, OPEN, PAD, SEG_SENTINEL, ByteBatch,
                               EventBatch, EventStream, encode_bytes,
                               pack_segments)
from repro.core.nfa import compile_queries
from repro.core.xpath import parse
from repro.data.generator import DTD, gen_corpus, gen_profiles
from repro.kernels import ref as jax_ref
from repro.kernels import stream_filter as jax_sf
from repro_torch import convert
from repro_torch.core import engines
from repro_torch.kernels import ref
from repro_torch.kernels import stream_filter as sf

KB = ("kb_tagmask", "kb_pw", "kb_pb", "kb_selfloop", "kb_init",
      "kb_acc_word", "kb_acc_bit")


def workload(n_queries=32, seed=0, n_tags=14, p_wild=0.1, p_desc=0.3,
             length=4):
    dtd = DTD.generate(n_tags=n_tags, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=n_queries, length=length, p_wild=p_wild,
                      p_desc=p_desc, seed=seed)
    return dtd, d, qs, compile_queries(qs, d, shared=True)


def jax_kernel_plan(nfa, d, **kw):
    """The JAX streaming plan with megakernel block tables."""
    return jax_engines.create("streaming", nfa, dictionary=d,
                              kernel="pallas", kernel_interpret=True,
                              **kw).plan_


def port_plan(jplan):
    return convert.plan_from_numpy(
        {k: np.asarray(v) for k, v in jplan.tables.items()}, jplan.meta,
        "cpu")


def run_k1(jplan, events, max_depth):
    """(JAX, port) raw K1 outputs over the same fused events and tables."""
    plan = port_plan(jplan)
    jm, jf = jax_sf.stream_filter_pallas(
        events, *(jplan[k] for k in KB), max_depth=max_depth,
        chunk=jplan.meta["chunk"], interpret=True)
    tm, tf = sf.stream_filter(torch.from_numpy(events),
                              *(plan[k] for k in KB), max_depth=max_depth)
    return (np.asarray(jm), np.asarray(jf)), (tm.numpy(), tf.numpy())


def run_k2(jplan, data, starts, max_depth, chunk=128):
    plan = port_plan(jplan)
    jm, jf = jax_sf.stream_filter_bytes_pallas(
        data, starts, *(jplan[k] for k in KB), max_depth=max_depth,
        chunk=chunk, interpret=True)
    tm, tf = sf.stream_filter_bytes(
        torch.from_numpy(data), torch.from_numpy(starts),
        *(plan[k] for k in KB), max_depth=max_depth)
    return (np.asarray(jm), np.asarray(jf)), (tm.numpy(), tf.numpy())


def assert_lanes_equal(jax_out, port_out):
    np.testing.assert_array_equal(port_out[0], jax_out[0])
    np.testing.assert_array_equal(port_out[1], jax_out[1])


def fused(batch):
    return np.asarray(jax_sf.fuse_events(batch.kind, batch.tag_id))


def one_doc_starts(n):
    starts = np.full((n, 2), SEG_SENTINEL, np.int32)
    starts[:, 0] = 0
    return starts


def single_event_doc(d, dtd):
    tid = d.lookup(dtd.tag_names[0])
    return EventStream(np.array([OPEN], np.int8), np.array([tid], np.int32))


def ragged_bb(dtd, d, seed, bucket=128):
    """One doc longer than the segment target, tiny docs, a single-event
    doc and empty docs (the mix of tests/test_packing.py)."""
    docs = (gen_corpus(dtd, n_docs=1, nodes_per_doc=90, seed=seed)
            + gen_corpus(dtd, n_docs=4, nodes_per_doc=3, seed=seed + 1))
    bufs = ([encode_bytes(docs[0], text_fill=4)] + [b""]
            + [encode_bytes(x, text_fill=2) for x in docs[1:]]
            + [encode_bytes(single_event_doc(d, dtd)), b""])
    return ByteBatch.from_buffers(bufs, bucket=bucket)


# ------------------------------------------------------------ K1: events
class TestEventKernel:
    @pytest.mark.parametrize("n_queries,seed", [(8, 0), (40, 1), (64, 2)])
    def test_ragged_batches(self, n_queries, seed):
        dtd, d, qs, nfa = workload(n_queries=n_queries, seed=seed)
        docs = [ev for n in (4, 30, 90) for ev in
                gen_corpus(dtd, n_docs=2, nodes_per_doc=n, seed=seed + n)]
        batch = EventBatch.from_streams(docs, bucket=64)
        jplan = jax_kernel_plan(nfa, d, blk=64, chunk=64)
        assert_lanes_equal(*run_k1(jplan, fused(batch), 64))

    def test_multi_block_plan(self):
        dtd, d, qs, nfa = workload(n_queries=48, seed=3, p_desc=0.5)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=70, seed=3)
        batch = EventBatch.from_streams(docs, bucket=64)
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        assert jplan.meta["n_blocks"] > 1
        assert_lanes_equal(*run_k1(jplan, fused(batch), 64))

    def test_out_of_dictionary_tags_and_pads(self):
        """Tag codes past the dictionary (up to 4095, and PAD's -1) take
        the wild-only row; unbalanced closes pop at depth 0."""
        dtd, d, qs, nfa = workload(n_queries=24, seed=4, p_wild=0.3)
        rng = np.random.default_rng(4)
        n = 120
        kind = rng.choice([OPEN, OPEN, CLOSE, PAD], size=(3, n))
        tag = rng.integers(0, nfa.n_tags, size=(3, n))
        far = rng.random((3, n)) < 0.3
        tag[far] = rng.choice([nfa.n_tags, 200, 4095], size=int(far.sum()))
        tag[kind == PAD] = -1
        events = np.asarray(jax_sf.fuse_events(kind.astype(np.int8),
                                               tag.astype(np.int32)))
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        assert_lanes_equal(*run_k1(jplan, events, 64))

    @pytest.mark.parametrize("max_depth", [2, 3])
    def test_depth_overflow(self, max_depth):
        """Documents deeper than the stack clip identically."""
        dtd, d, qs, nfa = workload(n_queries=16, seed=5, p_wild=0.0)
        tag = d.lookup(next(st.tag for q in qs for st in q.steps
                            if st.tag != "*"))
        deep = [EventStream(np.array([OPEN] * k + [CLOSE] * k, np.int8),
                            np.full(2 * k, tag, np.int32)) for k in (5, 7)]
        docs = deep + gen_corpus(dtd, n_docs=2, nodes_per_doc=30, seed=5)
        batch = EventBatch.from_streams(docs, bucket=32)
        jplan = jax_kernel_plan(nfa, d, max_depth=max_depth, blk=32,
                                chunk=32)
        assert jplan.meta["max_depth"] == max_depth
        assert_lanes_equal(*run_k1(jplan, fused(batch), max_depth))


# ------------------------------------------------------------- K2: bytes
class TestBytesKernel:
    def test_one_doc_segments(self):
        dtd, d, qs, nfa = workload(n_queries=24, seed=6)
        docs = gen_corpus(dtd, n_docs=5, nodes_per_doc=50, seed=6)
        bb = ByteBatch.from_streams(docs, text_fill=3, bucket=256)
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        assert_lanes_equal(*run_k2(jplan, bb.data,
                                   one_doc_starts(bb.batch_size), 64))

    @pytest.mark.parametrize("seed,target", [(0, 256), (3, 128)])
    def test_packed_segments(self, seed, target):
        """Empty slots, a single-event doc and a doc longer than the
        segment target, all packed."""
        dtd, d, qs, nfa = workload(n_queries=24, seed=seed)
        sp = pack_segments(ragged_bb(dtd, d, seed), target_len=target)
        assert (sp.doc_ids < 0).any()          # empty slots exist
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        assert_lanes_equal(*run_k2(jplan, sp.data, sp.starts, 64))

    def test_tags_straddling_rows_and_documents(self):
        """A tag cut by the end of L reads zeros (no event); a tag cut by
        a document boundary inside a segment decodes with the next
        document's bytes and belongs to the document it starts in."""
        d = TagDictionary()
        qs = [parse(q) for q in ("//t0", "//t1", "//t2", "//t3", "/t0/t1",
                                 "//t2/*", "//*/t0", "/*")]
        nfa = compile_queries(qs, d, shared=True)
        sym = [d.symbols_of(d.lookup(f"t{i}")) for i in range(4)]
        doc0 = f"<{sym[0]}><{sym[1]}></{sym[1]}></{sym[0]}><{sym[2]}"
        doc1 = f"></{sym[2]}><{sym[3]}><{sym[0]}></{sym[0]}><zz>"
        row1 = f"<{sym[1]}><{sym[2]}></{sym[2]}><{sym[3]}xx</{sym[1]}><{sym[0][0]}"
        length = 37                              # not a multiple of 4 or 32
        data = np.zeros((2, length), np.uint8)
        packed = (doc0 + doc1).encode()[:length]
        data[0, :len(packed)] = np.frombuffer(packed, np.uint8)
        data[1, :len(row1)] = np.frombuffer(row1.encode()[:length], np.uint8)
        starts = np.full((2, 4), SEG_SENTINEL, np.int32)
        starts[:, 0] = 0
        starts[0, 1] = len(doc0)
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        jax_out, port_out = run_k2(jplan, data, starts, 64, chunk=32)
        hits = jax_out[0].sum(axis=(1, 3)) > 0        # (segment, slot)
        assert hits.tolist() == [[True, True, False], [True, False, False]]
        assert_lanes_equal(jax_out, port_out)


# ------------------------------------------------------- plans and steps
class TestPlans:
    @pytest.mark.parametrize("opts", [{}, {"blk": 32}, {"blk": 64,
                                                        "max_depth": 9}])
    def test_port_plan_equals_jax_plan(self, opts):
        dtd, d, qs, nfa = workload(n_queries=40, seed=8, p_desc=0.5)
        jplan = jax_kernel_plan(nfa, d, **opts)
        plan = engines.create("streaming", nfa, dictionary=d, device="cpu",
                              **opts).plan_
        for k in convert.BLOCK_TABLES:
            want = np.asarray(jplan[k])
            if want.dtype == np.uint32:
                want = want.view(np.int32)
            np.testing.assert_array_equal(plan[k].numpy(), want, err_msg=k)
        for k in convert.META_KEYS:
            assert plan.meta[k] == jplan.meta[k], k

    def test_plan_from_numpy_round_trip(self):
        dtd, d, qs, nfa = workload(n_queries=16, seed=9)
        jplan = jax_kernel_plan(nfa, d, blk=32)
        plan = port_plan(jplan)
        for k in convert.BLOCK_TABLES:
            back = plan[k].numpy()
            want = np.asarray(jplan[k])
            if want.dtype == np.uint32:
                back = back.view(np.uint32)
            assert back.dtype == want.dtype
            np.testing.assert_array_equal(back, want, err_msg=k)
        assert plan.meta["max_depth"] == jplan.meta["max_depth"]

    def test_plan_from_numpy_refuses_bad_tables(self):
        dtd, d, qs, nfa = workload(n_queries=16, seed=9)
        scan = jax_engines.create("streaming", nfa, dictionary=d,
                                  kernel="scan").plan_
        with pytest.raises(ValueError, match="block tables"):
            convert.plan_from_numpy(
                {k: np.asarray(v) for k, v in scan.tables.items()},
                scan.meta, "cpu")
        tables = {k: np.asarray(v).copy()
                  for k, v in jax_kernel_plan(nfa, d).tables.items()}
        tables["kb_pw"][0, 0, 0] = tables["kb_selfloop"].shape[-1]
        with pytest.raises(ValueError, match="kb_pw"):
            convert.plan_from_numpy(tables, {"max_depth": 64}, "cpu")

    def test_stream_filter_words_equals_jax_ref(self):
        """The one-block plain scan against the JAX package's oracle."""
        dtd, d, qs, nfa = workload(n_queries=32, seed=10, p_desc=0.5)
        jplan = jax_kernel_plan(nfa, d, blk=32)
        plan = port_plan(jplan)
        batch = EventBatch.from_streams(
            gen_corpus(dtd, n_docs=1, nodes_per_doc=40, seed=10))
        events = fused(batch)[0]
        for g in range(jplan.meta["n_blocks"]):
            jm, jfirst = jax_ref.stream_filter_words(
                events, *(jplan[k][g] for k in KB), max_depth=6)
            tm, tfirst = ref.stream_filter_words(
                torch.from_numpy(events), *(plan[k][g] for k in KB),
                max_depth=6)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))

    def test_predecode_equals_jax_ref(self):
        rng = np.random.default_rng(11)
        alphabet = np.frombuffer(b"<</>abcXYZ09_.x ", np.uint8)
        data = rng.choice(alphabet, size=(4, 97)).astype(np.uint8)
        jk, jt = jax_ref.predecode(data)
        tk, tt = ref.predecode(torch.from_numpy(data))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ------------------------------------------------------- wrapper contract
class TestWrappers:
    def _tables(self):
        dtd, d, qs, nfa = workload(n_queries=8, seed=12)
        plan = engines.create("streaming", nfa, dictionary=d,
                              device="cpu").plan_
        return tuple(plan[k] for k in KB)

    def test_rejects_wrong_dtype_shape_and_layout(self):
        tables = self._tables()
        ev = torch.zeros((2, 8), dtype=torch.int32)
        with pytest.raises(TypeError, match="int32"):
            sf.stream_filter(ev.long(), *tables, max_depth=4)
        with pytest.raises(ValueError, match="contiguous"):
            sf.stream_filter(torch.zeros((8, 2), dtype=torch.int32).t(),
                             *tables, max_depth=4)
        with pytest.raises(ValueError, match="shape"):
            sf.stream_filter(ev, tables[0], tables[1][:, :1], *tables[2:],
                             max_depth=4)
        with pytest.raises(ValueError, match="disagree"):
            sf.stream_filter_bytes(torch.zeros((2, 8), dtype=torch.uint8),
                                   torch.zeros((3, 2), dtype=torch.int32),
                                   *tables, max_depth=4)

    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        tables = self._tables()
        k1, k2 = sf.stream_filter.launches, sf.stream_filter_bytes.launches
        sf.stream_filter(torch.zeros((1, 4), dtype=torch.int32), *tables,
                         max_depth=4)
        sf.stream_filter_bytes(torch.zeros((1, 16), dtype=torch.uint8),
                               torch.from_numpy(one_doc_starts(1)), *tables,
                               max_depth=4)
        assert (sf.stream_filter.launches,
                sf.stream_filter_bytes.launches) == (k1, k2)
