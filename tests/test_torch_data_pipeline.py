"""The port's filter-stage routing and token pipelines against the JAX
package's, on the CPU.

The counterparts of the 5 tests of ``tests/test_data_pipeline.py`` —
routing consistent across engines and with the ground truth, selectivity,
the deterministic shard-disjoint token stream, the XML byte pipeline —
each held against the JAX package on the same seeded inputs; then
``XMLBytePipeline.from_filtered_bytes`` through the port's stage (dense,
sparse and query-sharded) against the JAX one.  Exact equality.
"""
import numpy as np
import pytest

from repro.core.dictionary import TagDictionary as JaxDictionary
from repro.core.events import encode_bytes as jax_encode
from repro.data.filter_stage import FilterStage as JaxStage
from repro.data.generator import DTD as JaxDTD
from repro.data.generator import gen_corpus as jax_corpus
from repro.data.generator import gen_profiles as jax_profiles
from repro.data.tokens import TokenPipeline as JaxTokens
from repro.data.tokens import XMLBytePipeline as JaxXMLPipeline
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.engines.yfilter import YFilterEngine
from repro_torch.core.events import encode_bytes
from repro_torch.core.nfa import compile_queries
from repro_torch.data.filter_stage import FilterStage
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.data.tokens import TokenPipeline, XMLBytePipeline


def _routes(batches):
    return {(r.doc_index, r.shard): tuple(int(x) for x in r.matched_profiles)
            for batch in batches for r in batch}


class TestFilterStage:
    def _setup(self, engine):
        dtd = DTD.generate(n_tags=16, seed=1)
        d = TagDictionary()
        dtd.register(d)
        profiles = gen_profiles(dtd, n=24, length=3, seed=1)
        docs = gen_corpus(dtd, n_docs=10, nodes_per_doc=80, seed=1)
        stage = FilterStage(profiles, d, n_shards=4, engine=engine,
                            batch_size=4, device="cpu")
        return stage, docs, profiles, d

    def _jax_setup(self, engine):
        dtd = JaxDTD.generate(n_tags=16, seed=1)
        d = JaxDictionary()
        dtd.register(d)
        profiles = jax_profiles(dtd, n=24, length=3, seed=1)
        docs = jax_corpus(dtd, n_docs=10, nodes_per_doc=80, seed=1)
        return JaxStage(profiles, d, n_shards=4, engine=engine,
                        batch_size=4), docs

    def test_routing_consistent_across_engines(self):
        routes = {}
        for engine in ("levelwise", "yfilter", "streaming"):
            stage, docs, _, _ = self._setup(engine)
            routes[engine] = _routes(stage.route(docs))
        assert routes["levelwise"] == routes["yfilter"] \
            == routes["streaming"]
        jstage, jdocs = self._jax_setup("levelwise")
        assert routes["levelwise"] == _routes(jstage.route(jdocs))
        assert routes["levelwise"]

    def test_routing_matches_ground_truth(self):
        stage, docs, profiles, d = self._setup("yfilter")
        eng = YFilterEngine(compile_queries(profiles, d), device="cpu")
        got = [r for batch in stage.route(docs) for r in batch]
        assert got
        for r in got:
            res = eng.filter_document(docs[r.doc_index])
            want = set(np.nonzero(res.matched)[0])
            assert set(r.matched_profiles) <= want
            for q in r.matched_profiles:
                assert stage.shard_of_profile[q] == r.shard

    def test_selectivity(self):
        stage, docs, _, _ = self._setup("levelwise")
        s = stage.selectivity(docs)
        assert 0.0 <= s <= 1.0
        jstage, jdocs = self._jax_setup("levelwise")
        assert s == jstage.selectivity(jdocs)


class TestTokenPipelines:
    def test_deterministic_and_shard_disjoint(self):
        p0 = TokenPipeline(vocab=100, batch=2, seq_len=16, seed=7, shard=0)
        p0b = TokenPipeline(vocab=100, batch=2, seq_len=16, seed=7, shard=0)
        p1 = TokenPipeline(vocab=100, batch=2, seq_len=16, seed=7, shard=1)
        a, b, c = p0.batch_at(3), p0b.batch_at(3), p1.batch_at(3)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert not np.array_equal(a["tokens"], c["tokens"])
        # next-token alignment
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
        # the JAX package's stream, step for step
        jp = JaxTokens(vocab=100, batch=2, seq_len=16, seed=7, shard=1)
        for step, (got, want) in enumerate(zip(p1, jp)):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
            if step == 3:
                break

    def test_xml_byte_pipeline(self):
        dtd = DTD.generate(n_tags=8, seed=2)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=50, seed=2)
        p = XMLBytePipeline(docs, batch=2, seq_len=32)
        b = p.batch_at(0)
        assert b["tokens"].shape == (2, 32)
        assert b["tokens"].max() < 256
        np.testing.assert_array_equal(p.batch_at(1)["tokens"],
                                      p.batch_at(1)["tokens"])
        jdocs = jax_corpus(JaxDTD.generate(n_tags=8, seed=2), n_docs=4,
                           nodes_per_doc=50, seed=2)
        jp = JaxXMLPipeline(jdocs, batch=2, seq_len=32)
        for step in range(3):
            np.testing.assert_array_equal(p.batch_at(step)["tokens"],
                                          jp.batch_at(step)["tokens"])
        with pytest.raises(ValueError, match="exactly one"):
            XMLBytePipeline(docs, batch=2, seq_len=32, payloads=[b""])


# ------------------------------------------------- from_filtered_bytes
@pytest.mark.parametrize("kw", [{}, {"sparse": True}, {"query_shards": 2}],
                         ids=["dense", "sparse", "qshards2"])
def test_from_filtered_bytes_equals_jax(kw):
    """The payloads the port's stage routes, and only they, are kept and
    tokenized as the JAX pipeline over the JAX stage keeps them."""
    dtd, jdtd = DTD.generate(n_tags=16, seed=4), JaxDTD.generate(
        n_tags=16, seed=4)
    d, jd = TagDictionary(), JaxDictionary()
    dtd.register(d)
    jdtd.register(jd)
    payloads = [encode_bytes(x, text_fill=4) for x in
                gen_corpus(dtd, n_docs=12, nodes_per_doc=40, seed=4)]
    jpayloads = [jax_encode(x, text_fill=4) for x in
                 jax_corpus(jdtd, n_docs=12, nodes_per_doc=40, seed=4)]
    assert payloads == jpayloads
    profiles = gen_profiles(dtd, n=6, length=3, seed=4)
    stage = FilterStage(profiles, d, batch_size=4, device="cpu", **kw)
    jstage = JaxStage(jax_profiles(jdtd, n=6, length=3, seed=4), jd,
                      batch_size=4, **{k: v for k, v in kw.items()
                                       if k != "sparse"})
    keep = sorted({doc for doc, _ in _routes(stage.route_bytes(payloads))})
    assert 0 < len(keep) < len(payloads)
    p = XMLBytePipeline.from_filtered_bytes(payloads, stage, batch=2,
                                            seq_len=48)
    p2 = XMLBytePipeline.from_filtered_bytes(payloads, stage, batch=2,
                                             seq_len=48)
    jp = JaxXMLPipeline.from_filtered_bytes(jpayloads, jstage, batch=2,
                                            seq_len=48)
    assert p.payloads == [payloads[i] for i in keep] == jp.payloads
    for step in range(4):
        got = p.batch_at(step)
        np.testing.assert_array_equal(got["tokens"],
                                      p2.batch_at(step)["tokens"])
        np.testing.assert_array_equal(got["tokens"],
                                      jp.batch_at(step)["tokens"])
        np.testing.assert_array_equal(got["labels"],
                                      jp.batch_at(step)["labels"])


def test_from_filtered_bytes_refuses_when_nothing_matches():
    dtd = DTD.generate(n_tags=16, seed=4)
    d = TagDictionary()
    dtd.register(d)
    stage = FilterStage(["/nosuchtag"], d, batch_size=4, device="cpu")
    payloads = [encode_bytes(x, text_fill=4) for x in
                gen_corpus(dtd, n_docs=3, nodes_per_doc=20, seed=4)]
    with pytest.raises(ValueError, match="no payloads matched"):
        XMLBytePipeline.from_filtered_bytes(payloads, stage, batch=2,
                                            seq_len=16)
