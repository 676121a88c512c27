"""The port's streaming engine and filter stage against the JAX package's.

Engine level: ``repro_torch``'s ``StreamingEngine(device="cpu")`` (the
kernels' plain versions) against JAX's ``StreamingEngine(kernel="scan")``
on the same profiles and documents — ``filter_batch``, ``filter_bytes``
and ``filter_bytes(pack=True)``.  Slice level: ``FilterStage.route_bytes``
of both packages routes the same payloads to the same shards.  Exact
equality throughout.  Package hygiene: nothing in the port imports JAX or
the JAX package.
"""
import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stream_filter import ragged_bb, workload  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.events import (CLOSE, OPEN, ByteBatch, EventBatch,  # noqa: E402
                               EventStream, encode_bytes)
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.data.generator import gen_corpus  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def engine_pair(nfa, d, **kw):
    """JAX's scan oracle and the port's engine over the same profiles."""
    scan = jax_engines.create("streaming", nfa, dictionary=d, kernel="scan",
                              **{k: v for k, v in kw.items()
                                 if k == "max_depth"})
    port = engines.create("streaming", nfa, dictionary=d, device="cpu", **kw)
    return scan, port


def port_batch(batch: EventBatch) -> tev.EventBatch:
    return tev.EventBatch(batch.kind, batch.tag_id, batch.depth,
                          batch.parent, batch.valid, batch.n_events)


def port_bytes(bb: ByteBatch) -> tev.ByteBatch:
    return tev.ByteBatch(np.asarray(bb.data), np.asarray(bb.n_bytes))


def assert_same(a, b):
    np.testing.assert_array_equal(b.matched, a.matched)
    np.testing.assert_array_equal(b.first_event, a.first_event)


# ----------------------------------------------------------------- engine
class TestEngineAgainstScan:
    @pytest.mark.parametrize("n_queries,seed,blk", [(8, 0, None),
                                                    (40, 1, 32),
                                                    (64, 2, 64)])
    def test_filter_batch(self, n_queries, seed, blk):
        dtd, d, qs, nfa = workload(n_queries=n_queries, seed=seed)
        docs = [ev for n in (4, 30, 90) for ev in
                gen_corpus(dtd, n_docs=2, nodes_per_doc=n, seed=seed + n)]
        batch = EventBatch.from_streams(docs, bucket=64)
        kw = {} if blk is None else {"blk": blk}
        scan, port = engine_pair(nfa, d, **kw)
        res = port.filter_batch(port_batch(batch))
        assert res.matched.any()
        assert_same(scan.filter_batch(batch), res)

    def test_filter_batch_depth_overflow(self):
        dtd, d, qs, nfa = workload(n_queries=16, seed=5, p_wild=0.0)
        tag = d.lookup(next(st.tag for q in qs for st in q.steps
                            if st.tag != "*"))
        deep = [EventStream(np.array([OPEN] * k + [CLOSE] * k, np.int8),
                            np.full(2 * k, tag, np.int32)) for k in (6, 12)]
        batch = EventBatch.from_streams(
            deep + gen_corpus(dtd, n_docs=2, nodes_per_doc=30, seed=5),
            bucket=32)
        scan, port = engine_pair(nfa, d, max_depth=6, blk=32)
        assert_same(scan.filter_batch(batch),
                    port.filter_batch(port_batch(batch)))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_filter_bytes_unpacked_and_packed(self, seed):
        dtd, d, qs, nfa = workload(n_queries=24, seed=seed)
        bb = ragged_bb(dtd, d, seed)
        scan, port = engine_pair(nfa, d, blk=32, segment_target=256)
        oracle = scan.filter_bytes(bb)
        assert oracle.matched.any()
        assert_same(oracle, port.filter_bytes(port_bytes(bb)))
        assert_same(oracle, port.filter_bytes(port_bytes(bb), pack=True))

    def test_pack_option_is_the_default_route(self):
        dtd, d, qs, nfa = workload(n_queries=12, seed=1)
        bb = ragged_bb(dtd, d, 1)
        scan, port = engine_pair(nfa, d, pack=True, segment_target=128)
        assert_same(scan.filter_bytes(bb), port.filter_bytes(port_bytes(bb)))


class TestEngineOptions:
    @pytest.mark.parametrize("opts,exc", [
        ({"plan_cache": "plans"}, None),
        ({"smem_budget": 1 << 10}, None),
        ({"vmem_budget": 1 << 20}, None),
        ({"autotune": "measured"}, None),
        ({"kernel": "scan"}, NotImplementedError),
        ({"grid_order": "xy"}, ValueError),
        ({"no_such_option": 1}, TypeError),
    ])
    def test_unported_and_unknown_options_raise(self, opts, exc, tmp_path,
                                                monkeypatch):
        """Options with no counterpart in the port (``kernel=``), bad
        values and unknown names raise; the plan cache, the budgets and
        the measured overlay (``exc`` None) are taken and route as the
        engine without them."""
        dtd, d, qs, nfa = workload(n_queries=24, seed=2)
        if exc is not None:
            with pytest.raises(exc):
                engines.create("streaming", nfa, dictionary=d, device="cpu",
                               **opts)
            return
        from repro_torch.kernels import autotune

        monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "at.json"))
        if "plan_cache" in opts:
            opts = {"plan_cache": str(tmp_path / opts["plan_cache"])}
        bb = port_bytes(ragged_bb(dtd, d, 2))
        want = engines.create("streaming", nfa, dictionary=d,
                              device="cpu").filter_bytes(bb)
        assert want.matched.any()
        for _ in range(2):      # with the plan cache: a miss, then a hit
            eng = engines.create("streaming", nfa, dictionary=d,
                                 device="cpu", **opts)
            assert_same(want, eng.filter_bytes(bb))
        if "plan_cache" in opts:
            assert (eng.plan_cache.hits, eng.plan_cache.misses) == (1, 0)

    @pytest.mark.parametrize("opts", [{"fuse": False},
                                      {"sparse_epilogue": "on"},
                                      {"match_cap": 9, "ep_tile": 16}])
    def test_sparse_and_parse_options_work(self, opts):
        """Options ported with sparse delivery and device parse: the
        dense verdicts do not change, and the sparse ones densify to
        them."""
        dtd, d, qs, nfa = workload(n_queries=24, seed=3)
        bb = port_bytes(ragged_bb(dtd, d, 3))
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                             **opts)
        plain = engines.create("streaming", nfa, dictionary=d, device="cpu")
        want = plain.filter_bytes(bb)
        assert want.matched.any()
        assert_same(want, eng.filter_bytes(bb))
        sp = eng.filter_bytes_sparse(bb)
        assert sp.meta["match_cap"] == eng.match_cap(bb.batch_size,
                                                     eng.n_queries)
        assert_same(want, sp.densify())

    def test_unported_engine_name_raises(self):
        """Every engine of the JAX package is registered now; a name
        outside the registry raises, naming the registered ones."""
        dtd, d, qs, nfa = workload(n_queries=4, seed=2)
        assert engines.names() == jax_engines.names()
        with pytest.raises(ValueError, match="unknown engine 'nosuch'"):
            engines.create("nosuch", nfa, dictionary=d, device="cpu")
        with pytest.raises(ValueError, match="registered: .*'yfilter'"):
            FilterStage(profiles=list(qs), dictionary=d, engine="nosuch",
                        device="cpu")

    def test_grid_order_is_kept_in_meta_and_changes_nothing(self):
        dtd, d, qs, nfa = workload(n_queries=12, seed=3)
        bb = port_bytes(ragged_bb(dtd, d, 3))
        a = engines.create("streaming", nfa, dictionary=d, device="cpu",
                           grid_order="gb")
        b = engines.create("streaming", nfa, dictionary=d, device="cpu")
        assert a.plan_.meta["grid_order"] == "gb"
        assert_same(a.filter_bytes(bb), b.filter_bytes(bb))


# ------------------------------------------------------------------ slice
class TestFilterStageSlice:
    def _payloads(self, dtd, d, seed):
        docs = gen_corpus(dtd, n_docs=7, nodes_per_doc=40, seed=seed)
        return docs, ([encode_bytes(x, text_fill=8) for x in docs]
                      + [b""] + [encode_bytes(docs[0], text_fill=1)])

    @pytest.mark.parametrize("keep_unmatched,pack", [(False, False),
                                                     (True, True)])
    def test_route_bytes_matches_jax_stage(self, keep_unmatched, pack):
        dtd, d, qs, nfa = workload(n_queries=32, seed=4)
        docs, payloads = self._payloads(dtd, d, 4)
        common = dict(profiles=list(qs), dictionary=d, n_shards=3,
                      keep_unmatched=keep_unmatched, batch_size=4,
                      engine="streaming")
        jax_stage = JaxStage(**common)
        stage = FilterStage(device="cpu", engine_options={"pack": pack},
                            **common)
        want = list(jax_stage.route_bytes(payloads))
        got = list(stage.route_bytes(payloads))
        assert len(got) == len(want) == 3
        assert sum(len(b) for b in want) > 0
        for gb, wb in zip(got, want):
            assert [(r.doc_index, r.shard, r.nbytes) for r in gb] \
                == [(r.doc_index, r.shard, r.nbytes) for r in wb]
            for r, w in zip(gb, wb):
                np.testing.assert_array_equal(r.matched_profiles,
                                              w.matched_profiles)
                assert r.matched_profiles.dtype == w.matched_profiles.dtype
        assert stage.throughput()["docs"] == len(payloads)
        assert stage.throughput()["selectivity"] \
            == jax_stage.throughput()["selectivity"]

    def test_route_events_matches_route_bytes(self):
        dtd, d, qs, nfa = workload(n_queries=20, seed=6)
        docs, _ = self._payloads(dtd, d, 6)
        stage = FilterStage(profiles=list(qs), dictionary=d, n_shards=2,
                            batch_size=3, device="cpu")
        port_docs = [tev.EventStream(x.kind, x.tag_id) for x in docs]
        by_events = list(stage.route(port_docs))
        by_bytes = list(stage.route_bytes(
            [encode_bytes(x, text_fill=8) for x in docs]))
        flat = [[(r.doc_index, r.shard, tuple(r.matched_profiles))
                 for batch in routed for r in batch]
                for routed in (by_events, by_bytes)]
        assert len(by_events) == len(by_bytes) == 3
        assert flat[0] and flat[0] == flat[1]


# ---------------------------------------------------------------- hygiene
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:                 # relative: inside repro_torch
                continue
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"
