"""The port's answers where it used to have no such name, against the JAX
package's.

``FilterStage.selectivity(docs)`` and ``_filter_batch(record=False)``,
``StreamingEngine.filter_documents_batched(kind, tag)``,
``FilterPlan.table(name)``, and ``core.events.Node`` / ``to_trees`` /
``from_trees``: the same seeded inputs through both packages, on the
CPU.  Exact equality throughout.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_streaming import assert_same, port_batch  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core.dictionary import TagDictionary as JaxDictionary  # noqa: E402
from repro.core.events import EventBatch  # noqa: E402
from repro.core.nfa import compile_queries as jax_compile  # noqa: E402
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.data.generator import DTD as JaxDTD  # noqa: E402
from repro.data.generator import gen_corpus as jax_corpus  # noqa: E402
from repro.data.generator import gen_profiles as jax_profiles  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.dictionary import TagDictionary  # noqa: E402
from repro_torch.core.nfa import compile_queries  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles  # noqa: E402


def _workload(seed=0, n_queries=16, n_docs=6):
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=n_queries, length=3, p_desc=0.4, p_wild=0.15,
                      seed=seed)
    docs = gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=50, seed=seed)
    return qs, docs, d


def _jax_workload(seed=0, n_queries=16, n_docs=6):
    dtd = JaxDTD.generate(n_tags=24, seed=seed)
    d = JaxDictionary()
    dtd.register(d)
    qs = jax_profiles(dtd, n=n_queries, length=3, p_desc=0.4, p_wild=0.15,
                      seed=seed)
    docs = jax_corpus(dtd, n_docs=n_docs, nodes_per_doc=50, seed=seed)
    return qs, docs, d


# ------------------------------------------------------- stage selectivity
STAGES = [({}, "streaming"), ({"sparse": True}, "streaming"),
          ({"query_shards": 2}, "streaming"), ({}, "levelwise"),
          ({"query_shards": 3, "sparse": True}, "oracle")]
STAGE_IDS = ["dense", "sparse", "sharded", "levelwise", "oracle-sharded"]


@pytest.mark.parametrize("kw,engine", STAGES, ids=STAGE_IDS)
def test_selectivity_equals_jax_and_records_nothing(kw, engine):
    """``selectivity(docs)`` answers the JAX stage's number, and it is a
    read: the routing stats do not move."""
    qs, docs, d = _workload(seed=1)
    jqs, jdocs, jd = _jax_workload(seed=1)
    stage = FilterStage(qs, d, engine=engine, device="cpu", batch_size=4,
                        **kw)
    want = JaxStage(jqs, jd, engine=engine, batch_size=4).selectivity(jdocs)
    before = dict(stage.stats)
    got = stage.selectivity(docs)
    assert 0 < got < 1
    assert got == want
    assert stage.stats == before


@pytest.mark.parametrize("record", [False, True])
def test_filter_batch_record_flag(record):
    """``_filter_batch(record=False)`` leaves the stats alone;
    ``record=True`` (the default) counts the batch, as in the JAX
    package."""
    qs, docs, d = _workload(seed=2)
    stage = FilterStage(qs, d, device="cpu")
    res = stage._filter_batch(docs, record=record)
    assert res.matched.shape == (len(docs), len(qs))
    assert stage.stats["docs"] == (len(docs) if record else 0)
    assert stage.stats["batches"] == int(record)


# ------------------------------------------------- legacy batched arrays
@pytest.mark.parametrize("seed", [0, 4])
def test_filter_documents_batched_equals_jax(seed):
    """Raw (B, N) kind/tag arrays → the JAX streaming engine's verdicts
    and first-match ordinals."""
    qs, docs, d = _workload(seed=seed)
    jqs, jdocs, jd = _jax_workload(seed=seed)
    batch = EventBatch.from_streams(jdocs, bucket=32)
    jeng = jax_engines.create("streaming", jax_compile(jqs, jd, shared=True),
                              dictionary=jd, kernel="scan")
    want = jeng.filter_documents_batched(batch.kind, batch.tag_id)
    eng = engines.create("streaming", compile_queries(
        qs, d, shared=True), dictionary=d, device="cpu")
    got = eng.filter_documents_batched(batch.kind, batch.tag_id)
    assert want.matched.any()
    assert_same(want, got)
    assert_same(eng.filter_batch(port_batch(batch)), got)


# ------------------------------------------------------------ plan tables
@pytest.mark.parametrize("name", ["streaming", "levelwise", "matscan"])
def test_plan_table_is_getitem(name):
    """``FilterPlan.table(name)`` is the table ``plan[name]`` gives, and
    an unknown name raises ``KeyError``."""
    qs, docs, d = _workload(seed=3)
    if name == "matscan":   # descendant chains of concrete tags
        qs = gen_profiles(DTD.generate(n_tags=24, seed=3), n=6, length=3,
                          p_desc=1.0, p_wild=0.0, seed=3)
    eng = engines.create(name, compile_queries(
        qs, d, shared=True), dictionary=d, device="cpu")
    plan = eng.plan_
    for k in plan.tables:
        assert plan.table(k) is plan[k]
    with pytest.raises(KeyError):
        plan.table("no_such_table")


def test_plan_table_equals_jax():
    """The block tables read through ``table`` equal the JAX plan's."""
    qs, docs, d = _workload(seed=5)
    jqs, jdocs, jd = _jax_workload(seed=5)
    jeng = jax_engines.create("streaming", jax_compile(jqs, jd, shared=True),
                              dictionary=jd, kernel="pallas",
                              kernel_interpret=True, blk=64)
    eng = engines.create("streaming", compile_queries(
        qs, d, shared=True), dictionary=d, device="cpu", blk=64)
    for k in ("kb_tagmask", "kb_acc_block", "kb_acc_slot", "kb_init"):
        want = np.asarray(jeng.plan_.table(k))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(eng.plan_.table(k).numpy(), want)


# -------------------------------------------------------------- tree view
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_view_equals_jax(seed):
    """``to_trees`` builds the JAX package's forest on the same stream,
    and ``from_trees`` gives the stream back."""
    _, docs, _ = _workload(seed=seed, n_docs=3)
    _, jdocs, _ = _jax_workload(seed=seed, n_docs=3)

    def shape(nodes):
        return [(n.tag_id, shape(n.children)) for n in nodes]

    for ev, jv in zip(docs, jdocs):
        trees = tev.to_trees(ev)
        assert trees and all(isinstance(n, tev.Node) for n in trees)
        assert shape(trees) == shape(jev.to_trees(jv))
        back = tev.from_trees(trees)
        np.testing.assert_array_equal(back.kind, ev.kind)
        np.testing.assert_array_equal(back.tag_id, ev.tag_id)


def test_tree_view_of_a_forest():
    """Several top-level elements are several roots; an empty stream is
    an empty forest."""
    ev = tev.EventStream.from_pairs([(tev.OPEN, 1), (tev.OPEN, 2),
                                     (tev.CLOSE, 2), (tev.CLOSE, 1),
                                     (tev.OPEN, 3), (tev.CLOSE, 3)])
    roots = tev.to_trees(ev)
    assert [r.tag_id for r in roots] == [1, 3]
    assert [c.tag_id for c in roots[0].children] == [2]
    assert tev.to_trees(tev.EventStream.from_pairs([])) == []
    assert len(tev.from_trees([])) == 0
