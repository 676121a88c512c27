"""The port's query-sharded plans against the JAX package's, on the CPU.

The counterparts of ``tests/test_sharded.py``'s cases without a mesh:
every engine over {1, 2, 4} parts equal to its unsharded run and to the
JAX package's sharded run, the bytes path, churn that recompiles one part,
tombstones and their reclaim, a 50-op churn equal to a fresh compile, the
sharded stage with gids never reused, and the area model.  Then what the
port adds: equal plan layouts (pads, ``gid_columns``, ``part_cols`` and
the stacked tables) after the same churn and rebalance, plans carried
across by ``convert.sharded_plan_from_numpy``, copy-on-write restacks, K6
folded over the parts equal to K6 part by part, and ONE launch of a
kernel per sharded request whatever the part count.  The JAX streaming
engine runs its scan for verdicts and its Pallas plan (``blk`` pinned,
interpret mode) for layouts.  Exact equality throughout.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_streaming import assert_same, port_batch, port_bytes  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.area import SCENARIOS  # noqa: E402
from repro.core.area import area_report_sharded as jax_area  # noqa: E402
from repro.core.dictionary import TagDictionary as JaxDictionary  # noqa: E402
from repro.core.engines.matscan import exact_class as jax_exact  # noqa: E402
from repro.core.events import ByteBatch, EventBatch  # noqa: E402
from repro.core.events import encode_bytes as jax_encode  # noqa: E402
from repro.core.nfa import compile_queries as jax_compile  # noqa: E402
from repro.core.nfa import partition_queries as jax_partition  # noqa: E402
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.data.generator import DTD as JaxDTD  # noqa: E402
from repro.data.generator import gen_corpus as jax_corpus  # noqa: E402
from repro.data.generator import gen_document as jax_document  # noqa: E402
from repro.data.generator import gen_profiles as jax_profiles  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core.area import area_report, area_report_sharded  # noqa: E402
from repro_torch.core.dictionary import TagDictionary  # noqa: E402
from repro_torch.core.engines.base import ShardedPlan  # noqa: E402
from repro_torch.core.engines.matscan import exact_class  # noqa: E402
from repro_torch.core.nfa import compile_queries, partition_queries  # noqa: E402
from repro_torch.core.xpath import parse  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402
from repro_torch.data.generator import (DTD, gen_corpus,  # noqa: E402
                                        gen_document, gen_profiles)
from repro_torch.kernels import nfa_transition as nt  # noqa: E402
from repro_torch.kernels import stream_filter as sf  # noqa: E402

ALL_ENGINES = ("levelwise", "matscan", "oracle", "streaming", "wavefront",
               "yfilter")
DEVICE_ENGINES = ("levelwise", "matscan", "streaming", "wavefront")


# ---------------------------------------------------------------- workloads
def _gen(pkg, engine, seed, n_docs, n_queries):
    """(profiles, docs, dictionary) of one package: matscan gets
    descendant chains of concrete tags on exact-class documents."""
    dtd_cls, dict_cls, profiles, corpus, document, exact = pkg
    dtd = dtd_cls.generate(n_tags=24, seed=seed)
    d = dict_cls()
    dtd.register(d)
    if engine == "matscan":
        qs = profiles(dtd, n=n_queries, length=3, p_desc=1.0, p_wild=0.0,
                      seed=seed)
        docs = [doc for i in range(40 * n_docs)
                if exact(doc := document(dtd, target_nodes=20, max_depth=4,
                                         seed=seed + i))][:n_docs]
        assert len(docs) == n_docs
    else:
        qs = profiles(dtd, n=n_queries, length=3, p_desc=0.4, p_wild=0.15,
                      seed=seed)
        docs = corpus(dtd, n_docs=n_docs, nodes_per_doc=60, seed=seed)
    return qs, docs, d


PORT = (DTD, TagDictionary, gen_profiles, gen_corpus, gen_document,
        exact_class)
JAX = (JaxDTD, JaxDictionary, jax_profiles, jax_corpus, jax_document,
       jax_exact)


def pair(engine, seed=0, n_docs=5, n_queries=18, **opts):
    """The same seeded workload through both packages: (port engine, JAX
    engine, port batch, JAX batch, port profiles, port dictionary)."""
    qs, _, d = _gen(PORT, engine, seed, n_docs, n_queries)
    jqs, jdocs, jd = _gen(JAX, engine, seed, n_docs, n_queries)
    batch = EventBatch.from_streams(jdocs, bucket=32)
    eng = engines.create(engine, compile_queries(qs, d, shared=True),
                         dictionary=d, device="cpu", **opts)
    jeng = jax_engines.create(engine, jax_compile(jqs, jd, shared=True),
                              dictionary=jd, **opts)
    return eng, jeng, port_batch(batch), batch, qs, d


def pool(seed, n=40, p_desc=0.4, p_wild=0.15, pkg=PORT):
    return pkg[2](pkg[0].generate(n_tags=24, seed=seed), n=n, length=3,
                  p_desc=p_desc, p_wild=p_wild, seed=seed + 31)


def fresh(engine, queries, d, batch, **opts):
    eng = engines.create(engine, compile_queries(list(queries), d,
                                                 shared=True),
                         dictionary=d, device="cpu", **opts)
    return eng.filter_batch(batch)


def np_table(x):
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# -------------------------------------------------------------- partitioning
class TestPartition:
    @pytest.mark.parametrize("n_parts", [1, 3, 4])
    def test_partition_equals_jax(self, n_parts):
        """The same split, index and per-part NFAs as the JAX package."""
        qs, _, d = _gen(PORT, "streaming", 0, 1, 20)
        jqs, _, jd = _gen(JAX, "streaming", 0, 1, 20)
        parts, part = partition_queries(qs, n_parts, d)
        jparts, jpart = jax_partition(jqs, n_parts, jd)
        np.testing.assert_array_equal(part.part_of, jpart.part_of)
        np.testing.assert_array_equal(part.local_of, jpart.local_of)
        for a, b in zip(parts, jparts):
            for x, y in zip(a.tables, b.tables):
                np.testing.assert_array_equal(x, y)
            assert a.n_tags == b.n_tags

    def test_more_parts_than_groups_leaves_empty_parts_working(self):
        d = TagDictionary.build(["a", "b", "c"])
        qs = [parse("a//b"), parse("a/c")]  # one prefix group
        parts, part = partition_queries(qs, 3, d)
        assert sum(nfa.n_queries == 0 for nfa in parts) == 2
        eng = engines.create("streaming", compile_queries(qs, d),
                             dictionary=d, device="cpu")
        sp = eng.plan_sharded(3)
        assert sp.n_parts == 3 and sp.n_queries == 2


# ------------------------------------------- sharded-vs-unsharded equivalence
class TestShardedEquivalence:
    @pytest.mark.parametrize("name", ALL_ENGINES)
    @pytest.mark.parametrize("n_parts", [1, 2, 4])
    def test_sharded_equals_unsharded_and_jax(self, name, n_parts):
        eng, jeng, pb, batch, _, _ = pair(name, seed=1)
        want = eng.filter_batch(pb)
        sp = eng.plan_sharded(n_parts)
        got = eng.filter_batch_sharded(pb, sp)
        assert_same(want, got)
        jsp = jeng.plan_sharded(n_parts)
        assert_same(jeng.filter_batch_sharded(batch, jsp), got)
        assert sp.part_cols == jsp.part_cols
        assert got.matched.any()

    @pytest.mark.parametrize("pack", [False, True])
    def test_sharded_bytes_path(self, pack):
        eng, jeng, pb, batch, _, _ = pair("streaming", seed=3,
                                          segment_target=256)
        jdocs = [batch.stream(i) for i in range(batch.batch_size)]
        bb = ByteBatch.from_buffers([jax_encode(x, text_fill=8)
                                     for x in jdocs], bucket=1024)
        eng.options["pack"] = pack
        sp, jsp = eng.plan_sharded(2), jeng.plan_sharded(2)
        got = eng.filter_bytes_sharded(port_bytes(bb), sp)
        assert_same(jeng.filter_bytes_sharded(bb, jsp), got)
        assert_same(eng.filter_batch(pb), got)

    @pytest.mark.parametrize("opts,path", [
        ({}, "kernel-fused"), ({"sparse_epilogue": "off"}, "lane-compact"),
        ({"match_cap": 1}, "dense-overflow")])
    @pytest.mark.parametrize("ingest", ["events", "bytes"])
    def test_sharded_sparse_routes_equal_jax(self, opts, path, ingest):
        """The three routes of the sharded sparse entry points, with
        global ids as ``query_ids``, against the JAX package's sharded
        sparse result, over a tombstoned plan."""
        eng, jeng, pb, batch, _, _ = pair("streaming", seed=2, **opts)
        sp = eng.plan_sharded(3).remove_queries([1, 4])
        jsp = jeng.plan_sharded(3).remove_queries([1, 4])
        if ingest == "events":
            got = eng.filter_batch_sharded_sparse(pb, sp)
            want = jeng.filter_batch_sharded_sparse(batch, jsp)
        else:
            jdocs = [batch.stream(i) for i in range(batch.batch_size)]
            bb = ByteBatch.from_buffers([jax_encode(x) for x in jdocs],
                                        bucket=512)
            got = eng.filter_bytes_sharded_sparse(port_bytes(bb), sp)
            want = jeng.filter_bytes_sharded_sparse(bb, jsp)
        assert got.meta["path"] == path
        assert got.n_matches > 1
        for k in ("doc_ids", "query_ids", "first_event", "live_ids"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert_same(want.densify(), got.densify())

    @pytest.mark.parametrize("method", [
        "filter_batch_sharded", "filter_batch_sharded_sparse",
        "filter_bytes_sharded", "filter_bytes_sharded_sparse"])
    def test_a_mesh_raises_naming_item_13(self, method):
        eng, _, pb, batch, _, _ = pair("streaming", seed=0)
        sp = eng.plan_sharded(2)
        arg = pb if "batch" in method else port_bytes(
            ByteBatch.from_streams([batch.stream(0)]))
        with pytest.raises(NotImplementedError, match="item 13"):
            getattr(eng, method)(arg, sp, mesh=object())


# ----------------------------------------------------------- churn semantics
class TestChurn:
    def _setup(self, engine="streaming", seed=0, n=16):
        eng, jeng, pb, batch, _, d = pair(engine, seed=seed, n_queries=n)
        return (eng, eng.plan_sharded(4), jeng, jeng.plan_sharded(4),
                pool(seed), pool(seed, pkg=JAX), d, pb, batch)

    def test_add_recompiles_one_part(self):
        eng, sp, jeng, jsp, qs, jqs, d, pb, batch = self._setup()
        sp2, gids = sp.add_queries(qs[:2])
        jsp2, jgids = jsp.add_queries(jqs[:2])
        assert gids == jgids and sp2.part_cols == jsp2.part_cols
        changed = [i for i, (a, b) in enumerate(zip(sp.plans, sp2.plans))
                   if a is not b]
        if sp2.pads == sp.pads:
            assert len(changed) == 1
        res = eng.filter_batch_sharded(pb, sp2)
        assert_same(fresh("streaming", sp2.live_queries(), d, pb), res)
        assert_same(jeng.filter_batch_sharded(batch, jsp2), res)

    def test_churn_restacks_copy_on_write(self):
        """An add that fits the pads replaces one part's rows of the
        stacked tables in NEW tensors; a removal carries them over."""
        eng, sp, _, _, qs, _, d, pb, _ = self._setup()
        old = {k: v.clone() for k, v in sp.stacked().tables.items()}
        sp2, _ = sp.add_queries(qs[:1])
        if sp2.pads == sp.pads:
            for k, v in sp2.stacked().tables.items():
                assert v.data_ptr() != sp.stacked()[k].data_ptr()
        for k, v in sp.stacked().tables.items():
            assert torch.equal(v, old[k]), f"{k} changed in place"
        res = eng.filter_batch_sharded(pb, sp2)
        assert_same(fresh("streaming", sp2.live_queries(), d, pb), res)
        sp3 = sp2.remove_queries([int(sp2.live_ids()[0])])
        assert sp3.stacked() is sp2.stacked(), "remove must not restack"
        res3 = eng.filter_batch_sharded(pb, sp3)
        assert_same(fresh("streaming", sp3.live_queries(), d, pb), res3)

    def test_subscribe_lays_out_one_part(self, monkeypatch):
        """A subscribe that fits the pads lays out only the part it
        recompiles (for the pads, then for its plan): the other parts'
        layouts are memoised by their unchanged NFAs."""
        from repro_torch.kernels import blocks

        eng, sp, _, _, qs, _, d, pb, _ = self._setup()
        sp1, _ = sp.add_queries(qs[:1])      # may grow a bucket
        calls = []
        orig = blocks.state_layout

        def counted(nfa, *args, **kw):
            calls.append(nfa.n_states)
            return orig(nfa, *args, **kw)

        monkeypatch.setattr(blocks, "state_layout", counted)
        sp2, _ = sp1.add_queries(qs[1:2])
        if sp2.pads == sp1.pads:
            assert len(calls) == 2
        assert_same(fresh("streaming", sp2.live_queries(), d, pb),
                    eng.filter_batch_sharded(pb, sp2))

    def test_remove_is_metadata_only(self):
        eng, sp, jeng, jsp, _, _, d, pb, batch = self._setup()
        sp2 = sp.remove_queries([3, 7])
        assert all(a is b for a, b in zip(sp.plans, sp2.plans))
        assert sp2.n_queries == sp.n_queries - 2
        res = eng.filter_batch_sharded(pb, sp2)
        assert_same(fresh("streaming", sp2.live_queries(), d, pb), res)
        assert_same(jeng.filter_batch_sharded(batch,
                                              jsp.remove_queries([3, 7])),
                    res)

    def test_remove_unknown_raises(self):
        _, sp, *_ = self._setup()
        with pytest.raises(KeyError):
            sp.remove_queries([999])
        sp2 = sp.remove_queries([0])
        with pytest.raises(KeyError):
            sp2.remove_queries([0])  # double-unsubscribe

    def test_tombstone_reclaimed_on_next_add(self):
        _, sp, _, _, qs, _, _, _, _ = self._setup()
        p = int(np.argmin(sp.part_sizes()))
        gid = next(int(g) for g in sp.live_ids()
                   if int(sp.partition.part_of[g]) == p)
        sp2 = sp.remove_queries([gid])
        assert -1 in sp2.part_cols[p]
        sp3, _ = sp2.add_queries([qs[0]])
        assert -1 not in sp3.part_cols[p], "tombstone not reclaimed"

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_fifty_op_churn_equals_fresh_compile_and_jax(self, name):
        """50 random subscribe/unsubscribe ops ≡ a from-scratch compile of
        the final set, and ≡ the JAX package after the same ops."""
        eng, jeng, pb, batch, _, d = pair(name, seed=2, n_docs=4,
                                          n_queries=12)
        desc = 1.0 if name == "matscan" else 0.4
        wild = 0.0 if name == "matscan" else 0.15
        qs = pool(2, n=60, p_desc=desc, p_wild=wild)
        jqs = pool(2, n=60, p_desc=desc, p_wild=wild, pkg=JAX)
        sp, jsp = eng.plan_sharded(4), jeng.plan_sharded(4)
        rng = np.random.default_rng(7)
        live = list(sp.live_ids())
        k = 0
        for _ in range(50):
            if live and rng.random() < 0.45:
                g = live.pop(rng.integers(len(live)))
                sp, jsp = sp.remove_queries([g]), jsp.remove_queries([g])
            else:
                sp, gids = sp.add_queries([qs[k % len(qs)]])
                jsp, _ = jsp.add_queries([jqs[k % len(jqs)]])
                k += 1
                live += gids
        assert sp.part_cols == jsp.part_cols
        res = eng.filter_batch_sharded(pb, sp)
        assert_same(fresh(name, sp.live_queries(), d, pb), res)
        assert_same(jeng.filter_batch_sharded(batch, jsp), res)

    @pytest.mark.parametrize("ops,seed", [
        ([0, 1, 3, 5, 2, 7, 9, 4], 0), ([1, 1, 1, 0, 0, 3], 1),
        ([2, 4, 6, 8, 10, 1, 3, 5, 7, 9, 11, 13], 2), ([99, 98, 0, 1], 3)])
    def test_random_churn_equals_fresh_compile(self, ops, seed):
        """Fixed add/remove sequences (odd op: remove, even: add) keep
        sharded verdicts equal to a compile of the surviving set."""
        eng, _, pb, _, _, d = pair("streaming", seed=seed, n_docs=3,
                                   n_queries=8)
        qs = pool(seed, n=50)
        sp = eng.plan_sharded(2)
        live = list(sp.live_ids())
        k = 0
        for op in ops:
            if live and op % 2:
                sp = sp.remove_queries([live.pop(op % len(live))])
            else:
                sp, gids = sp.add_queries([qs[k % len(qs)]])
                k += 1
                live += gids
        assert_same(fresh("streaming", sp.live_queries(), d, pb),
                    eng.filter_batch_sharded(pb, sp))


# ----------------------------------------------------- layouts equal JAX's
def _churned(sp, qs, removes, k0=0):
    sp = sp.remove_queries(removes)
    for i in range(3):
        sp, _ = sp.add_queries([qs[k0 + i]])
    return sp


class TestLayoutEqualsJax:
    """The same churn and rebalance give the same plan in both packages:
    pads, ``gid_columns``, ``part_cols`` and every stacked table."""

    @pytest.mark.parametrize("name", DEVICE_ENGINES)
    def test_pads_columns_and_stacked_tables(self, name):
        opts = {"blk": 32} if name == "streaming" else {}
        eng, _, _, _, _, d = pair(name, seed=5, n_queries=24, **opts)
        jqs, _, jd = _gen(JAX, name, 5, 1, 24)
        jopts = dict(opts, kernel="pallas",
                     kernel_interpret=True) if name == "streaming" else {}
        jeng = jax_engines.create(name, jax_compile(jqs, jd, shared=True),
                                  dictionary=jd, **jopts)
        desc = 1.0 if name == "matscan" else 0.4
        wild = 0.0 if name == "matscan" else 0.15
        qs = pool(5, p_desc=desc, p_wild=wild)
        pq = pool(5, p_desc=desc, p_wild=wild, pkg=JAX)
        sp = _churned(eng.plan_sharded(3), qs, [0, 1, 2, 3, 5, 8])
        jsp = _churned(jeng.plan_sharded(3), pq, [0, 1, 2, 3, 5, 8])
        sp, st = sp.rebalance(tolerance=0.05)
        jsp, jst = jsp.rebalance(tolerance=0.05)
        assert st == jst
        assert sp.pads == jsp.pads
        assert sp.part_cols == jsp.part_cols
        np.testing.assert_array_equal(sp.gid_columns(), jsp.gid_columns())
        want = jsp.stacked()
        got = sp.stacked()
        for k in got.tables:
            np.testing.assert_array_equal(np_table(got[k]),
                                          np_table(want[k]), err_msg=k)

    @pytest.mark.parametrize("name", ("streaming", "levelwise", "matscan"))
    def test_carried_plan_filters_as_jax(self, name):
        """A JAX sharded plan carried across by
        ``convert.sharded_plan_from_numpy`` equals the port's own plan
        and filters as the JAX package does."""
        opts = {"blk": 32} if name == "streaming" else {}
        eng, _, pb, batch, _, _ = pair(name, seed=6, **opts)
        jqs, jdocs, jd = _gen(JAX, name, 6, 5, 18)
        jopts = dict(opts, kernel="pallas",
                     kernel_interpret=True) if name == "streaming" else {}
        jeng = jax_engines.create(name, jax_compile(jqs, jd, shared=True),
                                  dictionary=jd, **jopts)
        jsp = jeng.plan_sharded(3).remove_queries([2])
        carried = convert.sharded_plan_from_numpy(
            eng, [{k: np.asarray(v) for k, v in p.tables.items()}
                  for p in jsp.plans], [p.meta for p in jsp.plans],
            part_cols=jsp.part_cols, part_queries=jsp.part_queries,
            part_nfas=jsp.part_nfas, pads=jsp.pads, n_global=jsp.n_global,
            query_bucket=jsp.query_bucket, shared=jsp.shared)
        assert isinstance(carried, ShardedPlan)
        own = eng.plan_sharded(3).remove_queries([2])
        for k in own.stacked().tables:
            np.testing.assert_array_equal(np_table(carried.stacked()[k]),
                                          np_table(own.stacked()[k]))
        got = eng.filter_batch_sharded(pb, carried)
        if name == "streaming":   # the JAX side runs its scan for verdicts
            jeng = jax_engines.create(name, jax_compile(jqs, jd,
                                                        shared=True),
                                      dictionary=jd)
            jsp = jeng.plan_sharded(3).remove_queries([2])
        assert_same(jeng.filter_batch_sharded(batch, jsp), got)
        assert_same(eng.filter_batch_sharded(pb, own), got)

    def test_carried_plan_refuses_ragged_parts(self):
        eng, jeng, *_ = pair("levelwise", seed=6)
        jsp = jeng.plan_sharded(2)
        tables = [{k: np.asarray(v) for k, v in p.tables.items()}
                  for p in jsp.plans]
        tables[1]["accept_state"] = tables[1]["accept_state"][:-1]
        with pytest.raises(ValueError, match="uniform pads"):
            convert.sharded_plan_from_numpy(
                eng, tables, [p.meta for p in jsp.plans],
                part_cols=jsp.part_cols, part_queries=jsp.part_queries,
                part_nfas=jsp.part_nfas, pads=jsp.pads,
                n_global=jsp.n_global, query_bucket=jsp.query_bucket,
                shared=jsp.shared)


# ------------------------------------------------------- folded K6 and launches
class TestFoldedRuns:
    @pytest.mark.parametrize("name", ("levelwise", "wavefront"))
    @pytest.mark.parametrize("n_parts", [2, 3])
    def test_folded_k6_equals_per_part(self, name, n_parts):
        """K6 over the parts folded into its state axis equals K6 run part
        by part, at the engine and at the kernel's plain version."""
        eng, _, pb, _, _, _ = pair(name, seed=4, use_kernel=True)
        sp = eng.plan_sharded(n_parts).remove_queries([0])
        prep = eng._prep(pb)
        m, f = eng._run_parts(sp, prep)
        for p, plan in enumerate(sp.plans):
            mp, fp = eng._run_with_plan(plan, prep)
            assert torch.equal(m[p], mp) and torch.equal(f[p], fp)
        folded = eng._folded_plan(sp)
        s = int(sp.stacked().meta["n_states"])
        g = torch.Generator().manual_seed(n_parts)
        rows = torch.bernoulli(torch.full((9, n_parts * s), 0.1),
                               generator=g)
        tags = torch.randint(-1, int(folded["req"].shape[0]) + 1, (9,),
                             generator=g, dtype=torch.int32)
        whole = nt.nfa_transition(rows, tags, folded["req"], folded["wild"],
                                  folded["in_state"], folded["selfloop"])
        for p, plan in enumerate(sp.plans):
            part = nt.nfa_transition(rows[:, p * s:(p + 1) * s].contiguous(),
                                     tags, plan["req"], plan["wild"],
                                     plan["in_state"], plan["selfloop"])
            assert torch.equal(whole[:, p * s:(p + 1) * s], part)

    @pytest.mark.parametrize("n_parts", [2, 4])
    @pytest.mark.parametrize("call,kernel", [
        ("filter_batch_sharded", "stream_filter"),
        ("filter_bytes_sharded", "stream_filter_bytes"),
        ("filter_bytes_sharded_sparse", "stream_filter_bytes_sparse"),
        ("filter_batch_sharded_sparse", "stream_filter_sparse")])
    def test_one_launch_per_sharded_request(self, monkeypatch, n_parts, call,
                                            kernel):
        """Each sharded request calls its kernel's wrapper once, over all
        P·G folded blocks, whatever P is (counted on the CPU's plain
        path, where the wrappers themselves count nothing)."""
        eng, _, pb, batch, _, _ = pair("streaming", seed=1, blk=32)
        sp = eng.plan_sharded(n_parts)
        calls = []
        # where each wrapper takes its tagmask, whose axis 0 is the block
        for name, at in (("stream_filter", 1), ("stream_filter_bytes", 2),
                         ("stream_filter_sparse", 2),
                         ("stream_filter_bytes_sparse", 3)):
            def counted(*args, _orig=getattr(sf, name), _name=name, _at=at,
                        **kw):
                calls.append((_name, args[_at].shape[0]))
                return _orig(*args, **kw)

            monkeypatch.setattr(sf, name, counted)
        if "bytes" in call:
            jdocs = [batch.stream(i) for i in range(batch.batch_size)]
            arg = port_bytes(ByteBatch.from_buffers(
                [jax_encode(x) for x in jdocs], bucket=512))
        else:
            arg = pb
        getattr(eng, call)(arg, sp)
        g = int(sp.stacked().meta["n_blocks"])
        assert calls == [(kernel, n_parts * g)]

    @pytest.mark.parametrize("name", ("levelwise", "wavefront"))
    def test_k6_launches_as_unsharded(self, monkeypatch, name):
        """A folded sharded request launches K6 once per level or chunk
        step, as many times as the unsharded request, not P times."""
        eng, _, pb, _, _, _ = pair(name, seed=3, use_kernel=True)
        widths = []
        orig = nt.nfa_transition

        def counted(parent_rows, *args):
            widths.append(parent_rows.shape[1])
            return orig(parent_rows, *args)

        monkeypatch.setattr(nt, "nfa_transition", counted)
        eng.filter_batch(pb)
        unsharded = len(widths)
        widths.clear()
        sp = eng.plan_sharded(4)
        eng.filter_batch_sharded(pb, sp)
        assert len(widths) == unsharded > 0
        assert set(widths) == {4 * int(sp.stacked().meta["n_states"])}


# --------------------------------------------------------- stage integration
def _routes(stage, docs):
    return {(r.doc_index, r.shard): tuple(int(x) for x in r.matched_profiles)
            for b in stage.route(docs) for r in b}


class TestShardedFilterStage:
    @pytest.mark.parametrize("kw", [{}, {"sparse": True}],
                             ids=["dense", "sparse"])
    def test_routing_identical_with_and_without_query_shards(self, kw):
        qs, docs, d = _gen(PORT, "streaming", 5, 8, 18)
        jqs, jdocs, jd = _gen(JAX, "streaming", 5, 8, 18)
        mono = FilterStage(qs, d, n_shards=3, batch_size=3,
                           device="cpu")
        shard = FilterStage(qs, d, n_shards=3, batch_size=3,
                            query_shards=4, device="cpu", **kw)
        want = _routes(JaxStage(jqs, jd, n_shards=3,
                                engine="streaming", batch_size=3,
                                query_shards=4), jdocs)
        assert want and _routes(mono, docs) == _routes(shard, docs) == want

    def test_live_subscribe_unsubscribe_route_parity(self):
        qs, docs, d = _gen(PORT, "streaming", 6, 6, 18)
        jqs, jdocs, jd = _gen(JAX, "streaming", 6, 6, 18)
        extra = gen_profiles(DTD.generate(n_tags=24, seed=6), n=3,
                             length=3, seed=77)
        jextra = jax_profiles(JaxDTD.generate(n_tags=24, seed=6), n=3,
                              length=3, seed=77)
        mono = FilterStage(qs, d, n_shards=2, batch_size=3,
                           device="cpu")
        shard = FilterStage(qs, d, n_shards=2, batch_size=3,
                            query_shards=2, device="cpu")
        jax_stage = JaxStage(jqs, jd, n_shards=2,
                             engine="streaming", batch_size=3,
                             query_shards=2)
        for stage, ex in ((mono, extra), (shard, extra), (jax_stage, jextra)):
            gids = [stage.subscribe(q) for q in ex]
            assert gids == sorted(gids)
            stage.unsubscribe(gids[0])
            stage.unsubscribe(1)
        assert shard.sharded_.part_cols == jax_stage.sharded_.part_cols
        want = _routes(jax_stage, jdocs)
        assert want and _routes(mono, docs) == _routes(shard, docs) == want

    @pytest.mark.parametrize("query_shards", [1, 2])
    def test_gids_never_reused(self, query_shards):
        qs, _, d = _gen(PORT, "streaming", 0, 1, 6)
        extra = gen_profiles(DTD.generate(n_tags=24, seed=0), n=2,
                             length=3, seed=55)
        stage = FilterStage(qs, d, engine="streaming",
                            query_shards=query_shards, device="cpu")
        stage.unsubscribe(5)
        assert stage.subscribe(extra[0]) == 6, "freed id must not be reused"
        assert stage.subscribe(extra[1]) == 7

    def test_unsubscribe_unknown_raises(self):
        qs, _, d = _gen(PORT, "streaming", 0, 1, 18)
        stage = FilterStage(qs, d, query_shards=2,
                            engine="streaming", device="cpu")
        with pytest.raises(KeyError):
            stage.unsubscribe(10**6)

    @pytest.mark.parametrize("engine", ("levelwise", "wavefront", "matscan",
                                        "yfilter"))
    def test_every_engine_stage_routes_as_jax(self, engine):
        """The sharded stage of every other engine routes as the JAX
        package's sharded stage on the same documents."""
        qs, docs, d = _gen(PORT, engine, 1, 5, 18)
        jqs, jdocs, jd = _gen(JAX, engine, 1, 5, 18)
        opts = {"use_kernel": True} if engine == "wavefront" else {}
        stage = FilterStage(qs, d, n_shards=2, batch_size=2,
                            engine=engine, query_shards=2, device="cpu",
                            engine_options=opts)
        want = _routes(JaxStage(jqs, jd, n_shards=2,
                                batch_size=2, engine=engine,
                                query_shards=2), jdocs)
        assert want and _routes(stage, docs) == want


# --------------------------------------------------------------- area model
class TestShardedArea:
    @pytest.mark.parametrize("scenario", SCENARIOS)
    def test_rows_equal_jax(self, scenario):
        """One row per part, each equal to the JAX package's, with the
        part totals bounded as the reference test bounds them."""
        qs, _, _ = _gen(PORT, "streaming", 0, 1, 32)
        jqs, _, _ = _gen(JAX, "streaming", 0, 1, 32)
        rows = area_report_sharded(qs, TagDictionary(), scenario, 4)
        want = jax_area(jqs, JaxDictionary(), scenario, 4)
        assert [r.part for r in rows] == [0, 1, 2, 3]
        assert sum(r.n_queries for r in rows) == 32
        assert [vars(r) for r in rows] == [vars(r) for r in want]
        whole = area_report(qs, TagDictionary(), scenario)
        assert all(r.bit_cost < 2 * whole.bit_cost for r in rows)
