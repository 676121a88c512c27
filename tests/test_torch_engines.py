"""The port's matscan, oracle and yfilter engines and its whole registry.

``matscan``, ``oracle`` and ``yfilter`` against the JAX package's on the
same profiles and documents, matscan's refusals and its pinned divergence
from tree semantics included; the registry against the JAX package's;
and, as ``tests/test_unified_pipeline.py`` holds the JAX engines, every
port engine on one ``EventBatch`` against the oracle, with padding inert
and routing the same whatever the engine.  Exact equality throughout.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_streaming import assert_same, port_batch  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.dictionary import TagDictionary  # noqa: E402
from repro.core.engines.matscan import \
    MatscanUnsupported as JaxUnsupported  # noqa: E402
from repro.core.engines.matscan import exact_class as jax_exact  # noqa: E402
from repro.core.events import (CLOSE, OPEN, EventBatch,  # noqa: E402
                               EventStream, bucket_length)
from repro.core.nfa import compile_queries  # noqa: E402
from repro.core.xpath import parse  # noqa: E402
from repro.data.generator import (DTD, gen_corpus, gen_document,  # noqa: E402
                                  gen_profiles)
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.engines import matscan  # noqa: E402
from repro_torch.core.nfa import NFA as PortNFA  # noqa: E402
from repro_torch.core.nfa import compile_queries as port_compile  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402

ALL_ENGINES = ("levelwise", "matscan", "oracle", "streaming", "wavefront",
               "yfilter")


def port_stream(ev):
    return tev.EventStream(ev.kind, ev.tag_id)


def nested(spec) -> EventStream:
    """spec: nested lists of (tag, [children])."""
    ks, ts = [], []

    def walk(node):
        tag, kids = node
        ks.append(OPEN)
        ts.append(tag)
        for k in kids:
            walk(k)
        ks.append(CLOSE)
        ts.append(tag)

    for n in spec:
        walk(n)
    return EventStream(np.array(ks, np.int8), np.array(ts, np.int32))


def fresh_dict(n=30):
    return TagDictionary.build([f"t{i}" for i in range(n)])


def pipeline_workload(engine, seed=0, n_docs=6, n_queries=16):
    """Profiles and documents valid for ``engine``: matscan takes
    descendant chains of concrete tags, exact on documents without a tag
    nested in itself (the workload of tests/test_unified_pipeline.py)."""
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    if engine == "matscan":
        profiles = gen_profiles(dtd, n=n_queries, length=3, p_desc=1.0,
                                p_wild=0.0, seed=seed)
        docs = [doc for i in range(40 * n_docs)
                if jax_exact(doc := gen_document(dtd, target_nodes=20,
                                                 max_depth=4,
                                                 seed=seed + i))][:n_docs]
        assert len(docs) == n_docs
    else:
        profiles = gen_profiles(dtd, n=n_queries, length=3, p_desc=0.4,
                                p_wild=0.15, seed=seed)
        docs = gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=60, seed=seed)
    return profiles, docs, d


def port_engine(name, nfa, d, **opts):
    """The port's engine over the JAX NFA's tables; matscan, which takes
    only the port's NFA type, over the same profiles compiled by the port."""
    if name == "matscan" and not isinstance(nfa, PortNFA):
        nfa = port_compile(list(nfa.queries), d, shared=True)
    return engines.create(name, nfa, dictionary=d, device="cpu", **opts)


def pair(name, nfa, d, **opts):
    return (jax_engines.create(name, nfa, dictionary=d, **opts),
            port_engine(name, nfa, d, **opts))


# --------------------------------------------------- engines against JAX
class TestAgainstJax:
    @pytest.mark.parametrize("name", ["matscan", "oracle", "yfilter"])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_filter_batch_and_document_equal_jax(self, name, seed):
        profiles, docs, d = pipeline_workload(name, seed=seed)
        nfa = compile_queries(profiles, d, shared=True)
        jax_eng, port = pair(name, nfa, d)
        batch = EventBatch.from_streams(docs, bucket=32)
        want = jax_eng.filter_batch(batch)
        assert want.matched.any()
        assert_same(want, port.filter_batch(port_batch(batch)))
        for ev in docs[:3]:
            assert_same(jax_eng.filter_document(ev),
                        port.filter_document(port_stream(ev)))

    @pytest.mark.parametrize("name", ["matscan", "oracle", "yfilter"])
    @pytest.mark.parametrize("cap", [None, 2])
    def test_filter_batch_sparse_equals_jax(self, name, cap):
        """Host engines sparsify their dense result (``dense-host``);
        matscan compacts on the device, overflowing past a small cap."""
        profiles, docs, d = pipeline_workload(name, seed=1)
        nfa = compile_queries(profiles, d, shared=True)
        jax_eng, port = pair(name, nfa, d)
        batch = EventBatch.from_streams(docs, bucket=32)
        want = jax_eng.filter_batch_sparse(batch, match_cap=cap)
        got = port.filter_batch_sparse(port_batch(batch), match_cap=cap)
        assert got.meta == want.meta
        assert got.overflowed == want.overflowed
        for k in ("doc_ids", "query_ids", "first_event"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))

    def test_matscan_plan_equals_jax_and_converts(self):
        from repro_torch import convert

        profiles, docs, d = pipeline_workload("matscan", seed=2)
        nfa = compile_queries(profiles, d, shared=True)
        jax_eng, port = pair("matscan", nfa, d)
        for k in ("step_tags", "accept_idx"):
            np.testing.assert_array_equal(port.plan_[k].numpy(),
                                          np.asarray(jax_eng.plan_[k]))
        assert port.plan_.meta == jax_eng.plan_.meta
        jplan = jax_eng.plan_
        tables = {k: np.asarray(v) for k, v in jplan.tables.items()}
        carried = convert.matscan_plan_from_numpy(tables, jplan.meta, "cpu")
        batch = port_batch(EventBatch.from_streams(docs))
        assert_same(port.filter_batch(batch),
                    port.filter_batch_with_plan(carried, batch))
        with pytest.raises(ValueError, match="accept_idx holds"):
            convert.matscan_plan_from_numpy(
                {**tables, "accept_idx": tables["accept_idx"] + 9},
                jplan.meta, "cpu")
        with pytest.raises(ValueError, match="must be"):
            convert.matscan_plan_from_numpy(
                {**tables, "accept_idx": tables["accept_idx"][:-1]},
                jplan.meta, "cpu")

    def test_matscan_exact_on_its_class_and_pinned_divergence(self):
        """On a tag nested in itself the negation block kills outer
        progress: the port diverges from tree semantics exactly as the
        JAX engine does."""
        d = fresh_dict()
        exact = nested([(0, [(1, [(2, [])]), (3, [])])])
        assert matscan.exact_class(port_stream(exact)) and jax_exact(exact)
        profiles = [parse(p) for p in
                    ["t0//t2", "t0//t3", "t3//t1", "//t1//t2", "t0//t1//t2"]]
        nfa = compile_queries(profiles, d)
        jax_eng, port = pair("matscan", nfa, d)
        oracle = engines.create("oracle", nfa, dictionary=d, device="cpu")
        assert_same(oracle.filter_document(port_stream(exact)),
                    port.filter_document(port_stream(exact)))
        # <t0> <t0></t0> <t1/> </t0>: tree semantics says t0//t1 matches
        inner = nested([(0, [(0, []), (1, [])])])
        assert not matscan.exact_class(port_stream(inner))
        nfa = compile_queries([parse("t0//t1")], d)
        jax_eng, port = pair("matscan", nfa, d)
        got = port.filter_document(port_stream(inner))
        assert_same(jax_eng.filter_document(inner), got)
        assert not got.matched[0]
        oracle = engines.create("oracle", nfa, dictionary=d, device="cpu")
        assert oracle.filter_document(port_stream(inner)).matched[0]

    @pytest.mark.parametrize("profile", ["t0/t1", "//*", "/t0//t1",
                                         "t0//*//t1"])
    def test_matscan_refuses_what_jax_refuses(self, profile):
        d = fresh_dict()
        nfa = compile_queries([parse(profile)], d)
        with pytest.raises(JaxUnsupported):
            jax_engines.create("matscan", nfa, dictionary=d)
        with pytest.raises(matscan.MatscanUnsupported):
            port_engine("matscan", nfa, d)
        with pytest.raises(matscan.MatscanUnsupported):
            matscan.MatscanEngine([parse(profile)], d, device="cpu")

    @pytest.mark.parametrize("name", ["matscan", "oracle"])
    def test_dictionary_is_required(self, name):
        d = fresh_dict()
        nfa = compile_queries([parse("t0//t1")], d)
        with pytest.raises(ValueError, match="dictionary"):
            engines.create(name, port_compile([parse("t0//t1")], d),
                           device="cpu")


# ---------------------------------------------------------- the registry
class TestRegistry:
    def test_names_equal_the_jax_registry(self):
        assert engines.names() == jax_engines.names() == ALL_ENGINES
        for name in ALL_ENGINES:
            cls = engines.get(name)
            assert issubclass(cls, engines.FilterEngine)
            assert cls.name == name
            assert cls.device_sharded \
                == jax_engines.get(name).device_sharded

    def test_unknown_name_lists_the_registry(self):
        with pytest.raises(ValueError, match="registered"):
            engines.get("nosuch")

    def test_host_plan_takes_the_engine_device(self):
        d = fresh_dict()
        nfa = compile_queries([parse("t0//t1")], d)
        for name in ("oracle", "yfilter"):
            eng = engines.create(name, nfa, dictionary=d, device="meta")
            assert eng.plan_.device.type == "meta"
            assert eng.plan_.meta["prep"] == "host"


# ----------------------------------------- every engine, one EventBatch
class TestBatchedEquivalence:
    @pytest.mark.parametrize("name", ALL_ENGINES)
    @pytest.mark.parametrize("seed", [0, 3])
    def test_filter_batch_equals_oracle(self, name, seed):
        profiles, docs, d = pipeline_workload(name, seed=seed)
        nfa = compile_queries(profiles, d, shared=True)
        eng = port_engine(name, nfa, d)
        oracle = port_engine("oracle", nfa, d)
        res = eng.filter_batch(port_batch(EventBatch.from_streams(
            docs, bucket=32)))
        assert res.batch_shape == (len(docs),)
        assert res.n_queries == len(profiles)
        for i, doc in enumerate(docs):
            assert_same(oracle.filter_document(port_stream(doc)), res[i])

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_padding_is_inert(self, name):
        profiles, docs, d = pipeline_workload(name, seed=5, n_docs=3)
        nfa = compile_queries(profiles, d, shared=True)
        eng = port_engine(name, nfa, d)
        tight = EventBatch.from_streams(docs)
        padded = tight.pad_to(bucket_length(max(len(x) for x in docs) + 37,
                                            64))
        assert_same(eng.filter_batch(port_batch(tight)),
                    eng.filter_batch(port_batch(padded)))

    def test_routing_identical_across_all_engines(self):
        profiles, docs, d = pipeline_workload("matscan", seed=2, n_docs=8,
                                              n_queries=24)
        routes = {}
        for name in ALL_ENGINES:
            stage = FilterStage(profiles, d, n_shards=4, engine=name,
                                batch_size=3, device="cpu")
            routes[name] = {(r.doc_index, r.shard): tuple(r.matched_profiles)
                            for batch in stage.route(map(port_stream, docs))
                            for r in batch}
        assert routes["oracle"]
        for name, r in routes.items():
            assert r == routes["oracle"], f"routing diverged for {name}"
