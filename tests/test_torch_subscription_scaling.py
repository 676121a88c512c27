"""Subscription-axis scale-up in the port, against the JAX package's.

The counterparts of ``tests/test_subscription_scaling.py``'s cases
without a mesh: global NFA minimization (``minimize=True``) invisible in
the verdicts on every path, sparse verdicts that densify back exactly
(with churn, tombstones and an overflow to dense), the live-mask
accounting, and rebalancing that evens the parts' load and changes no
verdict and no id — engine-level and in a stage under 50 ops of churn.
Exact equality throughout.  The JAX package's sharded sparse *stage*
routes through a mesh whose compaction raises ``ShardingTypeError`` in
some JAX installations, so the stage cases hold the port against the
JAX oracle on the final live set (which the churn invariant makes equal)
and against the JAX stage's plan after the same churn.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_sharded import JAX, PORT, _gen, pair  # noqa: E402
from test_torch_streaming import assert_same, port_bytes  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.events import ByteBatch, EventBatch  # noqa: E402
from repro.core.events import encode_bytes as jax_encode  # noqa: E402
from repro.core.nfa import compile_queries as jax_compile  # noqa: E402
from repro.core.nfa import minimize as jax_minimize  # noqa: E402
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core.engines.result import (NO_MATCH, FilterResult,  # noqa: E402
                                             SparseResult)
from repro_torch.core.nfa import compile_queries, minimize  # noqa: E402
from repro_torch.core.xpath import parse  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402

ALL_ENGINES = ("levelwise", "matscan", "oracle", "streaming", "wavefront",
               "yfilter")
DEVICE_ENGINES = ("levelwise", "matscan", "streaming", "wavefront")


def jax_oracle(jqs, jd, batch):
    """Ground truth: the JAX package's UNminimized oracle."""
    return jax_engines.create("oracle", jax_compile(list(jqs), jd,
                                                    shared=True),
                              dictionary=jd).filter_batch(batch)


# ---------------------------------------------------- global minimization
class TestMinimize:
    @pytest.mark.parametrize("dup", [False, True])
    def test_stats_equal_jax(self, dup):
        qs, _, d = _gen(PORT, "streaming", 0, 1, 24)
        jqs, _, jd = _gen(JAX, "streaming", 0, 1, 24)
        if dup:
            qs, jqs = qs + qs, jqs + jqs
        m, stats = minimize(compile_queries(qs, d, shared=True))
        jm, jstats = jax_minimize(jax_compile(jqs, jd, shared=True))
        assert tuple(stats) == tuple(jstats)
        for x, y in zip(m.tables, jm.tables):
            np.testing.assert_array_equal(x, y)
        if dup:
            assert stats.accept_classes <= len(qs) // 2

    def test_engine_option_records_stats(self):
        eng, jeng, *_ = pair("streaming", seed=0, minimize=True)
        assert eng.minimize_stats is not None
        assert tuple(eng.minimize_stats) == tuple(jeng.minimize_stats)
        assert eng.nfa.n_states == eng.minimize_stats.states_after
        off, *_ = pair("streaming", seed=0)
        assert off.minimize_stats is None

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_plain(self, name):
        eng, jeng, pb, batch, _, _ = pair(name, minimize=True)
        want = jeng.filter_batch(batch)
        assert_same(want, eng.filter_batch(pb))
        jqs, _, jd = _gen(JAX, name, 0, 5, 18)
        assert_same(jax_oracle(jqs, jd, batch), want)

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_sharded(self, name):
        eng, jeng, pb, batch, _, _ = pair(name, minimize=True)
        got = eng.filter_batch_sharded(pb, eng.plan_sharded(3))
        jqs, _, jd = _gen(JAX, name, 0, 5, 18)
        assert_same(jax_oracle(jqs, jd, batch), got)
        assert_same(jeng.filter_batch_sharded(batch, jeng.plan_sharded(3)),
                    got)

    def test_bytes(self):
        eng, _, _, batch, _, _ = pair("streaming", minimize=True)
        jdocs = [batch.stream(i) for i in range(batch.batch_size)]
        bb = ByteBatch.from_streams(jdocs, bucket=256)
        jqs, _, jd = _gen(JAX, "streaming", 0, 5, 18)
        want = jax_oracle(jqs, jd, batch)
        assert_same(want, eng.filter_bytes(port_bytes(bb)))
        assert_same(want, eng.filter_bytes_sharded(port_bytes(bb),
                                                   eng.plan_sharded(2)))


# ------------------------------------------------- sparse verdict delivery
class TestSparseVerdicts:
    @pytest.mark.parametrize("name", ALL_ENGINES)
    @pytest.mark.parametrize("minimized", (False, True))
    def test_plain_round_trip(self, name, minimized):
        eng, jeng, pb, batch, _, _ = pair(name, minimize=minimized)
        dense = eng.filter_batch(pb)
        sp = eng.filter_batch_sparse(pb)
        assert isinstance(sp, SparseResult) and not sp.overflowed
        assert_same(dense, sp.densify())
        assert sp.verdict_bytes == 12 * sp.n_matches <= sp.dense_bytes
        assert sp.selectivity() == dense.selectivity()
        assert_same(jeng.filter_batch_sparse(batch).densify(), sp.densify())

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_sharded_round_trip_with_churn(self, name):
        """Global ids survive the sparse wire format across a churned
        (tombstoned) sharded plan, as in the JAX package."""
        eng, jeng, pb, batch, _, _ = pair(name, minimize=True)
        sharded = eng.plan_sharded(3).remove_queries([1, 4])
        jsharded = jeng.plan_sharded(3).remove_queries([1, 4])
        dense = eng.filter_batch_sharded(pb, sharded)
        sp = eng.filter_batch_sharded_sparse(pb, sharded)
        assert np.array_equal(sp.live_ids, sharded.live_ids())
        assert_same(dense, sp.densify())
        assert set(map(int, sp.query_ids)) <= set(map(int, sp.live_ids))
        want = jeng.filter_batch_sharded_sparse(batch, jsharded)
        for k in ("doc_ids", "query_ids", "first_event", "live_ids"):
            np.testing.assert_array_equal(getattr(sp, k), getattr(want, k))

    @pytest.mark.parametrize("name", DEVICE_ENGINES)
    def test_overflow_falls_back_to_dense(self, name):
        eng, _, pb, _, _, _ = pair(name)
        dense = eng.filter_batch(pb)
        assert int(dense.matched.sum()) > 1, "workload must match"
        sp = eng.filter_batch_sparse(pb, match_cap=1)
        assert sp.overflowed and sp.meta["path"] == "dense-overflow"
        assert_same(dense, sp.densify())
        ssp = eng.filter_batch_sharded_sparse(pb, eng.plan_sharded(2),
                                              match_cap=1)
        assert ssp.overflowed and ssp.meta["path"] == "dense-overflow"
        assert_same(dense, ssp.densify())

    def test_match_cap_resolution(self):
        eng, *_ = pair("streaming", match_cap=64)
        assert eng.match_cap(8, 100) == 64          # engine option
        assert eng.match_cap(8, 100, cap=7) == 7    # explicit wins
        assert eng.match_cap(2, 3, cap=10**9) == 6  # clamped to dense
        no_opt, *_ = pair("streaming")
        assert no_opt.match_cap(8, 10_000) == 4096  # floor default
        assert no_opt.match_cap(8, 100) == 800      # dense clamp again

    @pytest.mark.parametrize("epilogue,path", [("auto", "kernel-fused"),
                                               ("off", "lane-compact")])
    def test_kernel_sparse_is_many_to_one(self, epilogue, path):
        """With duplicated subscriptions the device emits fewer rows
        than the expanded match list, on both kernel routes, unsharded
        and sharded."""
        qs, _, d = _gen(PORT, "streaming", 0, 5, 9)
        _, _, pb, _, _, _ = pair("streaming", n_queries=9)
        eng = engines.create("streaming", compile_queries(qs + qs, d,
                                                          shared=True),
                             dictionary=d, device="cpu", minimize=True,
                             sparse_epilogue=epilogue)
        dense = eng.filter_batch(pb)
        for sp in (eng.filter_batch_sparse(pb),
                   eng.filter_batch_sharded_sparse(pb, eng.plan_sharded(3))):
            assert sp.meta["path"] == path
            assert_same(dense, sp.densify())
            assert 0 < sp.meta["device_rows"] < sp.n_matches


# ------------------------------------------------------ live-mask accounting
class TestLiveMaskAccounting:
    def test_selectivity_excludes_tombstones(self):
        matched = np.array([[True, False, True, False]])
        first = np.where(matched, 3, NO_MATCH).astype(np.int32)
        res = FilterResult(matched, first,
                           live=np.array([True, True, False, False]))
        assert res.n_live == 2
        assert res.selectivity() == 0.5
        assert list(res[0].matching_queries()) == [0]

    def test_sparsify_round_trip_keeps_live_mask(self):
        matched = np.array([[True, False, True]])
        first = np.where(matched, 1, NO_MATCH).astype(np.int32)
        res = FilterResult(matched, first,
                           live=np.array([True, True, False]))
        sp = res.sparsify()
        assert sp.n_matches == 1 and sp.selectivity() == res.selectivity()
        back = sp.densify()
        assert back.matched[0, 0] and not back.matched[0, 2]

    def test_stage_selectivity_excludes_tombstones(self):
        """An unsubscribed profile's column stays in the compiled plan;
        the stage's selectivity counts only live pairs, as a fresh stage
        on the live set does."""
        qs, docs, d = _gen(PORT, "streaming", 1, 5, 18)
        stage = FilterStage(qs, d, query_shards=3, sparse=True,
                            device="cpu")
        hit = stage._filter_batch(docs, record=False)
        g = int(hit.query_ids[0])
        stage.unsubscribe(g)
        live = [q for i, q in enumerate(qs) if i != g]
        want = FilterStage(live, d, device="cpu").selectivity(docs)
        assert stage.selectivity(docs) == want


# ------------------------------------------------------- shard rebalancing
def _skewed(engine="streaming", seed=3, pkg=PORT, **opts):
    """A 4-part plan churned until part 0 holds all the weight."""
    if pkg is PORT:
        eng, _, pb, _, _, _ = pair(engine, seed=seed, n_queries=24,
                                   minimize=True, **opts)
        batch = pb
    else:
        _, eng, _, batch, _, _ = pair(engine, seed=seed, n_queries=24,
                                      minimize=True, **opts)
    sp = eng.plan_sharded(4)
    drop = [int(g) for g in sp.live_ids()
            if int(sp.partition.part_of[g]) != 0]
    if len(drop) == len(sp.live_ids()):
        drop = drop[:-1]
    return eng, sp.remove_queries(drop), batch


class TestRebalance:
    def test_rebalance_reduces_imbalance_as_jax(self):
        eng, sp, _ = _skewed()
        _, jsp, _ = _skewed(pkg=JAX)
        before = sp.imbalance()
        assert before > 0.25, "setup must be skewed"
        new, stats = sp.rebalance(tolerance=0.25)
        jnew, jstats = jsp.rebalance(tolerance=0.25)
        assert stats == jstats
        assert stats["moves"] > 0 and stats["moved_queries"] > 0
        assert new.imbalance() < before
        assert new.part_cols == jnew.part_cols
        w = new.part_weights()
        assert w.max() > 0 and (w > 0).sum() > 1, "load must spread"

    @pytest.mark.parametrize("engine", ("streaming", "oracle", "levelwise"))
    def test_rebalance_preserves_verdicts_and_ids(self, engine):
        eng, sp, pb = _skewed(engine)
        _, jsp, batch = _skewed(engine, pkg=JAX)
        want = eng.filter_batch_sharded(pb, sp)
        new, stats = sp.rebalance()
        assert np.array_equal(new.live_ids(), sp.live_ids())
        assert_same(want, eng.filter_batch_sharded(pb, new))
        # the old plan stays usable: the swap is atomic, not in place
        assert_same(want, eng.filter_batch_sharded(pb, sp))
        assert_same(want, eng.filter_batch_sharded_sparse(pb, new).densify())
        jeng = jsp._engine_obj
        assert_same(jeng.filter_batch_sharded(batch, jsp.rebalance()[0]),
                    want)

    def test_rebalance_splits_monolithic_groups(self):
        """One trie group outweighing the gap is split at query
        granularity, as in the JAX package."""
        from repro_torch.core.dictionary import TagDictionary
        from repro_torch.data.generator import DTD

        dtd = DTD.generate(n_tags=24, seed=0)
        d = TagDictionary()
        dtd.register(d)
        tag = dtd.tag_names[0]
        qs = [parse(f"/{tag}/{dtd.tag_names[1 + i % 6]}"
                    + ("//" + dtd.tag_names[2 + i % 5] if i % 2 else ""))
              for i in range(16)]
        eng = engines.create("streaming", compile_queries(qs, d,
                                                          shared=True),
                             dictionary=d, device="cpu")
        sp = eng.plan_sharded(4)
        new, stats = sp.rebalance(tolerance=0.25)
        assert sp.imbalance() > 0.25
        assert new.imbalance() < sp.imbalance()
        assert stats["moved_queries"] > 0

    def test_balanced_plan_is_a_noop(self):
        eng, *_ = pair("streaming")
        sp = eng.plan_sharded(3)
        new, stats = sp.rebalance(tolerance=10.0)
        assert stats["moves"] == 0 and new is sp


# ----------------------------------------- churn + rebalance, stage-level
class TestStageChurnRebalance:
    @pytest.mark.parametrize("engine", ("streaming", "oracle"))
    def test_fifty_op_churn_with_auto_rebalance(self, engine):
        """50 random ops with auto-rebalance every 10 and sparse delivery:
        the same plan as the JAX stage after the same ops, and verdicts
        equal to the JAX oracle on the surviving set."""
        from repro.data.generator import DTD as JaxDTD
        from repro.data.generator import gen_corpus as jax_corpus
        from repro.data.generator import gen_profiles as jax_profiles
        from repro_torch.data.generator import DTD, gen_corpus, gen_profiles

        stages = []
        for dtd_cls, dict_cls, profiles, corpus, stage_cls, extra in (
                (DTD, PORT[1], gen_profiles, gen_corpus, FilterStage,
                 {"device": "cpu"}),
                (JaxDTD, JAX[1], jax_profiles, jax_corpus, JaxStage, {})):
            dtd = dtd_cls.generate(n_tags=24, seed=7)
            d = dict_cls()
            dtd.register(d)
            base_qs = profiles(dtd, n=20, length=3, seed=7)
            pool = profiles(dtd, n=40, length=3, seed=99)
            docs = corpus(dtd, n_docs=4, nodes_per_doc=50, seed=7)
            stage = stage_cls(list(base_qs), d, n_shards=2, engine=engine,
                              query_shards=3, sparse=True,
                              rebalance_every=10,
                              engine_options={"minimize": True}, **extra)
            rng = np.random.default_rng(11)
            live = list(stage.sharded_.live_ids())
            for k in range(50):
                if live and rng.random() < 0.5:
                    stage.unsubscribe(int(live.pop(rng.integers(len(live)))))
                else:
                    live.append(stage.subscribe(pool[k % len(pool)]))
            stages.append((stage, docs, d))
        (stage, docs, _), (jstage, jdocs, jd) = stages
        assert stage.stats["rebalances"] == jstage.stats["rebalances"] > 0
        assert stage.sharded_.part_cols == jstage.sharded_.part_cols
        res = stage._filter_batch(docs)
        assert isinstance(res, SparseResult)
        batch = EventBatch.from_streams(jdocs, bucket=stage.bucket)
        want = jax_oracle(jstage.sharded_.live_queries(), jd, batch)
        assert_same(want, res.densify())
        assert stage.stats["verdict_bytes"] > 0

    def test_sparse_routing_matches_dense_routing(self):
        """The router's fan-out is identical with sparse delivery on and
        off, events and bytes alike, and equal to the JAX package's dense
        sharded stage."""
        qs, docs, d = _gen(PORT, "streaming", 4, 6, 16)
        jqs, jdocs, jd = _gen(JAX, "streaming", 4, 6, 16)
        payloads = [jax_encode(doc) for doc in jdocs]

        def destinations(stage, docs):
            ev = sorted((r.shard, r.doc_index) for b in stage.route(docs)
                        for r in b)
            by = sorted((r.shard, r.doc_index)
                        for b in stage.route_bytes(payloads) for r in b)
            return ev, by

        dense = destinations(FilterStage(list(qs), d, n_shards=3,
                                         batch_size=3, query_shards=2,
                                         device="cpu"), docs)
        sparse = destinations(FilterStage(
            list(qs), d, n_shards=3, batch_size=3, query_shards=2,
            sparse=True, device="cpu", engine_options={"minimize": True}),
            docs)
        want = destinations(JaxStage(list(jqs), jd, n_shards=3,
                                     engine="streaming", batch_size=3,
                                     query_shards=2), jdocs)
        assert dense[0] and dense == sparse == want
