"""The port's levelwise engines and K6 against the JAX package's, on the CPU.

Kernel level: K6's plain version (what the wrapper runs on CPU tensors),
the gather by ``parent_idx``, against ``nfa_transition_pallas`` in
interpret mode over several block shapes and against the product forms of
the JAX and port ``ref.nfa_transition``, with ragged widths and state
counts, padding states and tags past the tag space; ``parent_index`` and
its refusals.  Host level: the depth-major bucketing and the
chunk layout against the JAX package's numpy code.  Engine level: both
engines in every mode against the JAX engine with the same options and
against the oracle, through every entry point; plans and plans carried
over by ``convert``; the filter stage against the JAX stage.  Verdicts
are bits, ordinals int32 and K6's values sums of 0/1 products: exact
equality throughout.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stream_filter import workload  # noqa: E402
from test_torch_streaming import (assert_same, port_batch,  # noqa: E402
                                  port_bytes)

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.engines import levelwise as jax_lw  # noqa: E402
from repro.core.engines.oracle import filter_document as oracle  # noqa: E402
from repro.core.events import (CLOSE, OPEN, ByteBatch, EventBatch,  # noqa: E402
                               EventStream, encode_bytes)
from repro.core.events import DepthOverflow as JaxDepthOverflow  # noqa: E402
from repro.core.nfa import pad_states  # noqa: E402
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.data.generator import gen_corpus  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.nfa_transition import nfa_transition_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.engines import levelwise as lw  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402
from repro_torch.kernels import nfa_transition as nt  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402

LD_FIELDS = ("tags", "parent_slot", "valid", "event_idx")
CD_FIELDS = ("tags", "parent_idx", "valid", "event_idx")


def chain(tag: int, k: int) -> EventStream:
    """A document nested k deep."""
    return EventStream(np.array([OPEN] * k + [CLOSE] * k, np.int8),
                       np.full(2 * k, tag, np.int32))


def empty() -> EventStream:
    return EventStream(np.zeros(0, np.int8), np.zeros(0, np.int32))


def port_stream(ev: EventStream) -> tev.EventStream:
    return tev.EventStream(ev.kind, ev.tag_id)


def transition_inputs(nfa, w, seed):
    rng = np.random.default_rng(seed)
    parent = (rng.random((w, nfa.n_states)) < 0.2).astype(np.float32)
    tags = rng.integers(-1, nfa.n_tags + 2, size=w).astype(np.int32)
    return (parent, tags, nfa.req_matrix(), nfa.wild_vector(),
            nfa.parent_onehot(), nfa.tables.selfloop.astype(np.float32))


def port_args(args):
    """The JAX-shaped K6 arguments for the port: the parent one-hot
    becomes its ``parent_idx``."""
    out = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    out[4] = nt.parent_index(out[4])
    return out


# ------------------------------------------------------------------- K6
class TestNfaTransition:
    @pytest.mark.parametrize("w,s_mult,n_q", [(1, 1, 8), (4, 1, 8),
                                              (16, 2, 24), (130, 4, 64)])
    def test_plain_equals_pallas_and_jax_ref(self, w, s_mult, n_q):
        """The gather form (the wrapper's CPU path) against the Pallas
        kernel and the JAX and port product forms, with padding states
        from ``pad_states`` (parent 0) and tags -1 and >= T."""
        dtd, d, qs, nfa = workload(n_queries=n_q, seed=w, n_tags=16)
        nfa = pad_states(nfa, 128 * s_mult)
        args = transition_inputs(nfa, w, seed=w)
        assert (nfa.tables.in_state[-8:] == 0).all()    # padding states
        got = nt.nfa_transition(*port_args(args)).numpy()
        want = np.asarray(jax_ref.nfa_transition(*map(jnp.asarray, args)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, port_ref.nfa_transition(
            *map(torch.from_numpy, args)).numpy())
        s = nfa.n_states
        for bw, bs in [(8, 128), (128, 128), (16, s)]:
            pal = nfa_transition_pallas(*map(jnp.asarray, args), bw=bw,
                                        bs=bs, interpret=True)
            np.testing.assert_array_equal(got, np.asarray(pal),
                                          err_msg=f"bw={bw} bs={bs}")

    @pytest.mark.parametrize("w,multiple", [(3, 1), (37, 7), (65, 7)])
    def test_plain_equals_pallas_at_ragged_states(self, w, multiple):
        """States padded to 1 and 7 (S not a multiple of 4 or of the
        Pallas block), ragged W: the gather form equals the Pallas kernel
        (which pads both axes itself) and the product form."""
        dtd, d, qs, nfa = workload(n_queries=20, seed=w, n_tags=16)
        nfa = pad_states(nfa, multiple)
        args = transition_inputs(nfa, w, seed=w + 1)
        args[1][0], args[1][-1] = -1, nfa.n_tags + 1   # a pad, a tag >= T
        got = nt.nfa_transition(*port_args(args)).numpy()
        assert got.any() and not got.all()
        np.testing.assert_array_equal(got, port_ref.nfa_transition(
            *map(torch.from_numpy, args)).numpy())
        pal = nfa_transition_pallas(*map(jnp.asarray, args), bw=8, bs=128,
                                    interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pal))

    def test_tags_past_the_tag_space_match_wildcards_only(self):
        """A tag >= T is a zero one-hot row: tagmatch = wild, valid = 1;
        only tags < 0 mask the row out."""
        dtd, d, qs, nfa = workload(n_queries=24, seed=3, p_wild=0.5)
        nfa = pad_states(nfa, 128)
        parent, _, req, wild, p1h, sl = transition_inputs(nfa, 3, seed=3)
        parent[:] = nfa.tables.init.astype(np.float32)
        tags = np.array([nfa.n_tags, nfa.n_tags + 5, -1], np.int32)
        args = (parent, tags, req, wild, p1h, sl)
        got = nt.nfa_transition(*port_args(args)).numpy()
        src = parent @ p1h
        want = np.minimum(src * wild + parent * sl, 1)
        np.testing.assert_array_equal(got[:2], want[:2])
        assert got[:2].any() and not got[2].any()
        np.testing.assert_array_equal(got, np.asarray(
            jax_ref.nfa_transition(*map(jnp.asarray, args))))

    def test_parent_index_is_in_state_and_refuses_other_matrices(self):
        dtd, d, qs, nfa = workload(n_queries=16, seed=2)
        nfa = pad_states(nfa, 7)
        p1h = torch.from_numpy(nfa.parent_onehot())
        idx = nt.parent_index(p1h)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), nfa.tables.in_state)
        none = p1h.clone()
        none[:, 5] = 0                                  # a column with no 1
        with pytest.raises(ValueError, match="column 5 holds 0 nonzero"):
            nt.parent_index(none)
        two = p1h.clone()
        two[:, 3] = 0
        two[0, 3] = two[1, 3] = 1                       # a column with two
        with pytest.raises(ValueError, match="column 3 holds 2 nonzero"):
            nt.parent_index(two)
        half = p1h.clone()
        half[nfa.tables.in_state[4], 4] = 0.5           # one entry, not 1
        with pytest.raises(ValueError, match="column 4 holds 0.5"):
            nt.parent_index(half)
        with pytest.raises(ValueError, match=r"\(S, S\)"):
            nt.parent_index(p1h[:, :-1])

    def test_wrapper_checks_inputs_and_counts_nothing_on_cpu(self):
        dtd, d, qs, nfa = workload(n_queries=8, seed=1)
        args = port_args(transition_inputs(pad_states(nfa, 128), 5, seed=1))
        before = nt.nfa_transition.launches
        assert nt.nfa_transition(*args).shape == args[0].shape
        assert nt.nfa_transition.launches == before

        def call(i, x):
            bad = list(args)
            bad[i] = x
            return nt.nfa_transition(*bad)

        with pytest.raises(TypeError, match="parent_rows"):
            call(0, args[0].double())
        with pytest.raises(TypeError, match="tags"):
            call(1, args[1].long())
        with pytest.raises(ValueError, match="tags has shape"):
            call(1, args[1][:3])
        with pytest.raises(ValueError, match="parent_idx has shape"):
            call(4, args[4][:-1])
        with pytest.raises(TypeError, match="parent_idx must be torch.int32"):
            call(4, args[4].float())
        with pytest.raises(ValueError, match="contiguous"):
            call(0, args[0].t().contiguous().t())
        with pytest.raises(ValueError, match="is on meta"):
            call(1, args[1].to("meta"))
        with pytest.raises(ValueError, match="no kernel for device meta"):
            nt.nfa_transition(*(x.to("meta") for x in args))
        assert nt.nfa_transition.launches == before


# ------------------------------------------------------- host bucketing
def documents(dtd, seed):
    return (gen_corpus(dtd, n_docs=3, nodes_per_doc=60, seed=seed)
            + [empty(), chain(2, 25)])


class TestHostBucketing:
    def test_levelize_and_padded_equal_jax(self):
        dtd, d, qs, nfa = workload(seed=4)
        for ev in documents(dtd, 4):
            want, got = jax_lw.levelize(ev), lw.levelize(port_stream(ev))
            for f in LD_FIELDS:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.n_events == want.n_events
            for dd, dw in ((0, 0), (2, 3)):
                wp = want.padded(want.depth + dd, want.width + dw)
                gp = got.padded(got.depth + dd, got.width + dw)
                for f in LD_FIELDS:
                    np.testing.assert_array_equal(getattr(gp, f),
                                                  getattr(wp, f))
        with pytest.raises(ValueError, match="shrink"):
            got.padded(got.depth - 1, got.width)

    def test_levelize_from_arrays_equals_jax_and_levelize(self):
        """The batch fast path, the empty document's (1, 1) case included,
        and the stacked layout both engines' prep builds."""
        dtd, d, qs, nfa = workload(seed=5)
        docs = documents(dtd, 5)
        batch = EventBatch.from_streams(docs, bucket=32)
        want = jax_lw._leveldocs_of_batch(batch)
        got = lw._leveldocs_of_batch(port_batch(batch))
        assert got[3].tags.shape == (1, 1) and not got[3].valid.any()
        for g, w, ev in zip(got, want, docs):
            for f in LD_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            if len(ev):
                walk = lw.levelize(port_stream(ev))
                for f in LD_FIELDS:
                    np.testing.assert_array_equal(getattr(g, f),
                                                  getattr(walk, f))
        sw, sg = jax_lw._stack_leveldocs(want), lw._stack_leveldocs(got)
        for f in LD_FIELDS:
            np.testing.assert_array_equal(getattr(sg, f), getattr(sw, f))

    @pytest.mark.parametrize("chunk", [4, 16, 128])
    def test_chunkize_level_equals_jax(self, chunk):
        dtd, d, qs, nfa = workload(seed=6)
        for ev in documents(dtd, 6):
            want = jax_lw.chunkize(ev, chunk)
            got = lw.chunkize(port_stream(ev), chunk)
            for f in CD_FIELDS:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.n_chunks == want.n_chunks and got.chunk == chunk


# ---------------------------------------------------------------- engines
MODES = [
    ("levelwise", {}),
    ("levelwise", {"use_matmul": False}),
    ("levelwise", {"use_kernel": True}),
    ("wavefront", {"chunk": 16}),
    ("wavefront", {"chunk": 32}),
    ("wavefront", {"chunk": 128}),
    ("wavefront", {"chunk": 16, "use_kernel": True}),
    ("wavefront", {"chunk": 32, "use_kernel": True}),
    ("wavefront", {"chunk": 128, "use_kernel": True}),
]


def mode_id(mode):
    name, opts = mode
    return name + "".join(f"-{k}={v}" for k, v in opts.items())


def level_workload(seed, n_docs=4):
    dtd, d, qs, nfa = workload(n_queries=24, seed=seed, p_desc=0.4,
                               p_wild=0.15)
    docs = gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=70, seed=seed) \
        + [chain(1, 12)]
    return dtd, d, qs, nfa, docs


def pair(name, nfa, d, **opts):
    return (jax_engines.create(name, nfa, dictionary=d, **opts),
            engines.create(name, nfa, dictionary=d, device="cpu", **opts))


class TestEngines:
    @pytest.mark.parametrize("mode", MODES, ids=map(mode_id, MODES))
    def test_every_entry_point_equals_jax_and_oracle(self, mode):
        name, opts = mode
        dtd, d, qs, nfa, docs = level_workload(seed=7)
        jax_eng, port = pair(name, nfa, d, **opts)
        batch = EventBatch.from_streams(docs, bucket=32)
        want = jax_eng.filter_batch(batch)
        got = port.filter_batch(port_batch(batch))
        assert want.matched.any() and not want.matched.all()
        assert_same(want, got)
        for i, ev in enumerate(docs):
            assert_same(oracle(nfa, ev, d), got[i])
        for ev in (docs[0], docs[-1]):
            assert_same(jax_eng.filter_document(ev),
                        port.filter_document(port_stream(ev)))
        per_doc = port.filter_documents_batched(list(map(port_stream, docs)))
        for i, r in enumerate(per_doc):
            assert_same(want[i], r)
        assert_same(want, port.filter_documents(map(port_stream, docs)))

    @pytest.mark.parametrize("name", ["levelwise", "wavefront"])
    @pytest.mark.parametrize("cap", [None, 3])
    def test_filter_batch_sparse_equals_jax(self, name, cap):
        """``device-compact`` within the cap, ``dense-overflow`` past it."""
        dtd, d, qs, nfa, docs = level_workload(seed=8)
        jax_eng, port = pair(name, nfa, d)
        batch = EventBatch.from_streams(docs, bucket=32)
        want = jax_eng.filter_batch_sparse(batch, match_cap=cap)
        got = port.filter_batch_sparse(port_batch(batch), match_cap=cap)
        assert got.meta == want.meta
        assert got.meta["path"] == ("device-compact" if cap is None
                                    else "dense-overflow")
        assert got.overflowed == want.overflowed
        for k in ("doc_ids", "query_ids", "first_event"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert_same(port.filter_batch(port_batch(batch)), got.densify())

    @pytest.mark.parametrize("mode", [MODES[0], MODES[2], MODES[3],
                                      MODES[6]], ids=mode_id)
    def test_filter_bytes_equals_jax(self, mode):
        name, opts = mode
        dtd, d, qs, nfa, docs = level_workload(seed=9)
        jax_eng, port = pair(name, nfa, d, **opts)
        bb = ByteBatch.from_streams(docs + [empty()], text_fill=4,
                                    bucket=256)
        want = jax_eng.filter_bytes(bb)
        assert want.matched.any()
        assert_same(want, port.filter_bytes(port_bytes(bb)))

    @pytest.mark.parametrize("name", ["levelwise", "wavefront"])
    def test_filter_bytes_depth_overflow_like_jax(self, name):
        dtd, d, qs, nfa, docs = level_workload(seed=10, n_docs=2)
        jax_eng, port = pair(name, nfa, d)
        bb = ByteBatch.from_streams([docs[0], chain(1, 70), docs[1]])
        with pytest.raises(JaxDepthOverflow) as want:
            jax_eng.filter_bytes(bb)
        with pytest.raises(tev.DepthOverflow) as got:
            port.filter_bytes(port_bytes(bb))
        assert got.value.doc_indices == want.value.doc_indices == (1,)

    def test_options_reach_the_engines(self):
        """``event_bucket`` (what the stage passes) and ``minimize`` are
        taken, not refused; unported options are refused as on every
        engine."""
        dtd, d, qs, nfa, docs = level_workload(seed=11, n_docs=2)
        for name in ("levelwise", "wavefront"):
            eng = engines.create(name, nfa, dictionary=d, device="cpu",
                                 event_bucket=64)
            assert eng._event_bucket(None) == 64
            eng = engines.create(name, nfa, dictionary=d, device="cpu",
                                 minimize=True)
            assert eng.minimize_stats is not None
            with pytest.raises(NotImplementedError, match="plan_cache"):
                engines.create(name, nfa, dictionary=d, device="cpu",
                               plan_cache="cache")
        eng = engines.create("wavefront", nfa, dictionary=d, device="cpu")
        assert (eng.chunk, eng.use_kernel, eng.device.type) \
            == (128, False, "cpu")
        eng = engines.create("levelwise", nfa, dictionary=d, device="cpu")
        assert (eng.use_matmul, eng.use_kernel) == (True, False)
        assert engines.get("levelwise").device_sharded


# ------------------------------------------------------------------ plans
class TestPlans:
    @pytest.mark.parametrize("name,opts", [("levelwise", {}),
                                           ("wavefront", {}),
                                           ("levelwise",
                                            {"state_multiple": 32})])
    def test_plan_equals_jax_and_carried_plan_filters_the_same(self, name,
                                                               opts):
        dtd, d, qs, nfa, docs = level_workload(seed=12)
        jax_eng, port = pair(name, nfa, d, **opts)
        jplan = jax_eng.plan_
        assert port.plan_.meta == jplan.meta
        assert set(port.plan_.tables) == set(jplan.tables) \
            == set(convert.LEVEL_TABLES)
        for k in convert.LEVEL_TABLES:
            want = np.asarray(jplan[k])
            got = port.plan_[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        carried = convert.level_plan_from_numpy(
            name, {k: np.asarray(v) for k, v in jplan.tables.items()},
            jplan.meta, "cpu")
        batch = port_batch(EventBatch.from_streams(docs, bucket=32))
        assert_same(port.filter_batch(batch),
                    port.filter_batch_with_plan(carried, batch))

    def test_level_converter_refuses_bad_tables(self):
        dtd, d, qs, nfa, docs = level_workload(seed=13, n_docs=1)
        jplan = jax_engines.create("wavefront", nfa, dictionary=d).plan_
        tables = {k: np.asarray(v) for k, v in jplan.tables.items()}
        s = jplan.meta["n_states"]

        def carry(**change):
            return convert.level_plan_from_numpy(
                "wavefront", {**tables, **change}, jplan.meta, "cpu")

        with pytest.raises(ValueError, match="parent_1h has shape"):
            carry(parent_1h=tables["parent_1h"][:, :-1])
        with pytest.raises(ValueError, match="req has shape"):
            carry(req=tables["req"][:-1])
        with pytest.raises(ValueError, match="in_state holds states"):
            carry(in_state=np.full(s, s, np.int32))
        with pytest.raises(ValueError, match="accept_state holds states"):
            carry(accept_state=tables["accept_state"] - 1000)
        with pytest.raises(ValueError, match="no tables"):
            convert.level_plan_from_numpy(
                "wavefront", {k: v for k, v in tables.items() if k != "req"},
                jplan.meta, "cpu")
        with pytest.raises(ValueError, match="not a levelwise"):
            convert.level_plan_from_numpy("streaming", tables, jplan.meta,
                                          "cpu")


# ------------------------------------------------------------------ stage
class TestFilterStage:
    @pytest.mark.parametrize("name,opts", [
        ("wavefront", {"use_kernel": True, "chunk": 32}),
        ("wavefront", {}),
        ("levelwise", {"use_kernel": True}),
        ("levelwise", {"use_matmul": False}),
    ])
    def test_route_and_route_bytes_equal_jax_stage(self, name, opts):
        dtd, d, qs, nfa, docs = level_workload(seed=14, n_docs=6)
        payloads = [encode_bytes(x, text_fill=8) for x in docs] + [b""]
        common = dict(profiles=list(qs), dictionary=d, n_shards=3,
                      batch_size=3, engine=name, engine_options=opts)
        jax_stage = JaxStage(**common)
        stage = FilterStage(device="cpu", **common)
        for want, got in (
                (list(jax_stage.route_bytes(payloads)),
                 list(stage.route_bytes(payloads))),
                (list(jax_stage.route(docs)),
                 list(stage.route(map(port_stream, docs))))):
            flat = [[(r.doc_index, r.shard, r.nbytes,
                      tuple(r.matched_profiles)) for b in routed for r in b]
                    for routed in (want, got)]
            assert flat[0] and flat[0] == flat[1]
        assert stage.throughput()["selectivity"] \
            == jax_stage.throughput()["selectivity"]
