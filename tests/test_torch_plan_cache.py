"""The port's persistent plan cache against the JAX package's, on the CPU.

The counterparts of ``tests/test_faults.py::TestPlanCache`` and
``::TestStoreCrashSafety`` (each run on both packages' cache, with the
same observable results), then what the port adds: a hit equals a
compile, table for table, on every device engine, unsharded and as a
2-part sharded plan, and filters as the JAX engine does; an entry that
fails the table checks is a miss and is rewritten; churn, rebalance and
the serve loop's shadow build go through the cache; the key changes with
each of its inputs and with nothing else.  Exact equality throughout.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stage_churn import (BATCH, N_QUERIES, _jax_stage,  # noqa: E402
                                    _jax_workload, _routes, _stage,
                                    _stage_routes, _workload)
from test_torch_streaming import assert_same  # noqa: E402

from repro.checkpoint.store import PlanCache as JaxPlanCache  # noqa: E402
from repro.checkpoint.store import _valid_entry as jax_valid  # noqa: E402
from repro.checkpoint.store import _write_entry as jax_write  # noqa: E402
from repro.core import engines as jax_engines  # noqa: E402
from repro.core.dictionary import TagDictionary as JaxDictionary  # noqa: E402
from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.nfa import compile_queries as jax_compile  # noqa: E402
from repro.data.generator import DTD as JaxDTD  # noqa: E402
from repro.data.generator import gen_corpus as jax_corpus  # noqa: E402
from repro.data.generator import gen_profiles as jax_profiles  # noqa: E402
from repro.serve.loop import ServeLoop as JaxLoop  # noqa: E402
from repro_torch.checkpoint import PlanCache  # noqa: E402
from repro_torch.checkpoint.store import (_valid_entry,  # noqa: E402
                                          _write_entry, _write_pointer)
from repro_torch.core import engines  # noqa: E402
from repro_torch.core.dictionary import TagDictionary  # noqa: E402
from repro_torch.core.engines import base  # noqa: E402
from repro_torch.core.engines import levelwise as lw  # noqa: E402
from repro_torch.core.events import EventBatch  # noqa: E402
from repro_torch.core.nfa import compile_queries  # noqa: E402
from repro_torch.core.xpath import DESC  # noqa: E402
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles  # noqa: E402
from repro_torch.serve.loop import ServeLoop  # noqa: E402

CACHES = [pytest.param(PlanCache, id="port"),
          pytest.param(JaxPlanCache, id="jax")]
ENGINES = ["streaming", "levelwise", "wavefront", "matscan"]


def _engine_workload(name, seed=3):
    """The same seeded profiles and documents in both packages:
    ``[(nfa, dictionary, batch) of the port, (…) of the JAX package]``;
    matscan's profiles are the descendant-only, concrete-tag ones."""
    out = []
    for dtd_cls, dict_cls, profiles, corpus, compile_, batch_cls in (
            (DTD, TagDictionary, gen_profiles, gen_corpus, compile_queries,
             EventBatch),
            (JaxDTD, JaxDictionary, jax_profiles, jax_corpus, jax_compile,
             JaxEventBatch)):
        dtd = dtd_cls.generate(n_tags=14, seed=seed)
        d = dict_cls()
        dtd.register(d)
        qs = profiles(dtd, n=32, length=3, p_desc=0.5, p_wild=0.1, seed=seed)
        if name == "matscan":
            qs = [q for q in qs if all(st.axis == DESC and st.tag != "*"
                                       for st in q.steps)]
        docs = corpus(dtd, n_docs=6, nodes_per_doc=40, seed=seed)
        out.append((compile_(qs, d, shared=True), d,
                    batch_cls.from_streams(docs)))
    return out


def _read_entry(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        tables = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        return tables, json.load(f)


def _assert_same_plan(a, b):
    assert a.engine == b.engine and a.meta == b.meta
    assert sorted(a.tables) == sorted(b.tables)
    for k in a.tables:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------- twins of TestPlanCache
class TestPlanCache:
    @pytest.mark.parametrize("cache_cls", CACHES)
    def test_put_get_roundtrip(self, cache_cls, tmp_path):
        cache = cache_cls(str(tmp_path))
        tables = {"a": np.arange(6).reshape(2, 3),
                  "b": np.ones(4, np.float32)}
        cache.put("k1", tables, {"meta": 1})
        hit = cache.get("k1")
        assert hit is not None
        got, manifest = hit
        assert np.array_equal(got["a"], tables["a"])
        assert got["b"].dtype == np.float32
        assert manifest["meta"] == 1
        assert cache.hits == 1 and cache.misses == 0
        assert cache.keys() == ["k1"]

    @pytest.mark.parametrize("cache_cls", CACHES)
    def test_miss_and_corrupt_entry(self, cache_cls, tmp_path):
        cache = cache_cls(str(tmp_path))
        assert cache.get("nope") is None and cache.misses == 1
        cache.put("k", {"a": np.zeros(2)})
        os.remove(os.path.join(cache._path("k"), "manifest.json"))
        assert cache.get("k") is None       # torn entry reads as a miss
        assert "k" not in cache
        cache.put("k", {"a": np.ones(2)})   # and is overwritten cleanly
        assert np.array_equal(cache.get("k")[0]["a"], np.ones(2))
        assert (cache.hits, cache.misses) == (1, 2)

    def test_warm_cache_skips_recompilation(self, tmp_path):
        """A rebuilt engine against a warm cache is all hits, no misses,
        and plans identically; the cold build misses as often as the JAX
        package's does."""
        misses = []
        for pkg, (nfa, d, _) in zip(("port", "jax"),
                                    _engine_workload("streaming")):
            directory = str(tmp_path / pkg)
            if pkg == "port":
                cold = PlanCache(directory)
                eng = engines.create("streaming", nfa, dictionary=d,
                                     device="cpu", plan_cache=cold)
                sp = eng.plan_sharded(2)
                warm = PlanCache(directory)
                eng2 = engines.create("streaming", nfa, dictionary=d,
                                      device="cpu", plan_cache=warm)
                sp2 = eng2.plan_sharded(2)
                assert warm.misses == 0 and warm.hits == cold.misses
                assert dict(sp.pads) == dict(sp2.pads)
            else:
                cold = JaxPlanCache(directory)
                jax_engines.create("streaming", nfa, dictionary=d,
                                   plan_cache=cold).plan_sharded(2)
            misses.append(cold.misses)
        assert misses[0] == misses[1] == 3

    def test_cached_stage_verdict_parity(self, tmp_path):
        """Cached-plan routing equals compiled routing and the JAX
        package's sharded stage, end to end through the stage."""
        profiles, d, dtd, raw = _workload(n_docs=8)
        jp, jd, _, jraw = _jax_workload(n_docs=8)
        opts = {"plan_cache": str(tmp_path)}
        list(_stage(profiles, d, query_shards=2,
                    engine_options=opts).route_bytes(raw))  # populate
        cache = PlanCache(str(tmp_path))
        got = _stage_routes(_stage(profiles, d, query_shards=2,
                                   engine_options={"plan_cache": cache}),
                            raw)
        assert (cache.hits, cache.misses) == (3, 0)
        assert got == _stage_routes(_stage(profiles, d, query_shards=2), raw)
        assert got == _stage_routes(_jax_stage(jp, jd, query_shards=2), jraw)

    def test_key_covers_nfa_and_pads(self):
        (nfa, d, _), _ = _engine_workload("streaming")
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu")
        k1 = eng.plan_cache_key(nfa)
        k2 = eng.plan_cache_key(nfa, {"n_queries": 32, "n_states": 64})
        assert k1 != k2
        assert eng.plan_cache_key(nfa) == k1    # deterministic


# ---------------------------------------- twins of TestStoreCrashSafety
WRITERS = [pytest.param((_write_entry, _valid_entry), id="port"),
           pytest.param((jax_write, jax_valid), id="jax")]


class TestStoreCrashSafety:
    @pytest.mark.parametrize("pair", WRITERS)
    def test_write_entry_is_atomic(self, pair, tmp_path):
        write, valid = pair
        d = str(tmp_path)
        final = write(d, "e1", {"x": np.arange(3)}, {"keys": ["x"]})
        assert valid(final)
        assert not os.path.exists(os.path.join(d, "e1.tmp"))

    @pytest.mark.parametrize("pair", WRITERS)
    def test_stale_tmp_dir_is_replaced(self, pair, tmp_path):
        """A crash mid-write leaves ``<name>.tmp``: the next write clears
        it, and the torn directory never reads as an entry."""
        write, valid = pair
        d = str(tmp_path)
        os.makedirs(os.path.join(d, "e1.tmp"))
        with open(os.path.join(d, "e1.tmp", "garbage"), "w") as f:
            f.write("torn")
        assert not valid(os.path.join(d, "e1.tmp"))
        final = write(d, "e1", {"x": np.zeros(2)}, {"keys": ["x"]})
        assert valid(final)
        assert not os.path.exists(os.path.join(d, "e1.tmp"))

    def test_pointer_update_is_atomic(self, tmp_path):
        d = str(tmp_path)
        _write_pointer(d, "LATEST", "plan_00000001")
        _write_pointer(d, "LATEST", "plan_00000002")
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == "plan_00000002"
        assert not os.path.exists(os.path.join(d, "LATEST.tmp"))

    def test_torn_newest_entry_leaves_the_others(self, tmp_path):
        """The plan cache's form of the checkpoint store's walk-back (the
        store itself serves only training, ROADMAP item 14): a torn newest
        entry is a miss in both packages, the older one stays a hit, and
        each package reads the other's entry format as intact."""
        for cache_cls in (PlanCache, JaxPlanCache):
            cache = cache_cls(str(tmp_path / cache_cls.__module__))
            cache.put("old", {"w": np.arange(4, dtype=np.float32)})
            cache.put("new", {"w": np.arange(4, dtype=np.float32) * 2})
            os.remove(os.path.join(cache._path("new"), "manifest.json"))
            assert cache.get("new") is None
            assert np.array_equal(cache.get("old")[0]["w"],
                                  np.arange(4, dtype=np.float32))
            assert cache.keys() == ["new", "old"]
        for write, valid in ((_write_entry, jax_valid),
                             (jax_write, _valid_entry)):
            final = write(str(tmp_path), "x", {"a": np.ones(3)},
                          {"keys": ["a"]})
            assert valid(final)


# ------------------------------------------------- what the port adds
@pytest.mark.parametrize("parts", [1, 2], ids=["unsharded", "sharded2"])
@pytest.mark.parametrize("name", ENGINES)
def test_hit_equals_compile(name, parts, tmp_path):
    """A warm build's plans equal the cold build's table for table (the
    stacked tables of a sharded plan too), and filter as the JAX engine
    at the same profiles."""
    (nfa, d, batch), (jnfa, jd, jbatch) = _engine_workload(name)

    def build():
        cache = PlanCache(str(tmp_path))
        eng = engines.create(name, nfa, dictionary=d, device="cpu",
                             plan_cache=cache)
        return cache, eng, (eng.plan_sharded(parts) if parts > 1 else None)

    cold, eng, sp = build()
    warm, eng2, sp2 = build()
    assert (cold.hits, cold.misses) == (0, 1 + (parts if parts > 1 else 0))
    assert (warm.hits, warm.misses) == (cold.misses, 0)
    pairs = [(eng.plan_, eng2.plan_)]
    if sp is not None:
        assert sp.pads == sp2.pads
        pairs += list(zip(sp.plans, sp2.plans)) + [(sp.stacked(),
                                                     sp2.stacked())]
    for a, b in pairs:
        _assert_same_plan(a, b)
    jeng = jax_engines.create(name, jnfa, dictionary=jd)
    if sp is None:
        want, got = jeng.filter_batch(jbatch), eng2.filter_batch(batch)
    else:
        want = jeng.filter_batch_sharded(jbatch, jeng.plan_sharded(parts))
        got = eng2.filter_batch_sharded(batch, sp2)
    assert got.matched.any()
    assert_same(want, got)


@pytest.mark.parametrize("how", ["table", "index", "engine", "torn"])
def test_tampered_entry_is_a_miss_and_rewritten(how, tmp_path):
    """An entry whose tables changed (the digest), whose tables fail the
    block-table checks (an index past its block, digest rewritten to
    match), that names another engine, or that is torn: the next build
    counts a miss, compiles, filters as the JAX engine, and rewrites the
    entry, which the build after reads as a hit."""
    (nfa, d, batch), (jnfa, jd, jbatch) = _engine_workload("streaming")
    eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                         plan_cache=str(tmp_path))
    key = eng.plan_cache_key(nfa)
    path = eng.plan_cache._path(key)
    tables, manifest = _read_entry(path)
    if how == "torn":
        os.remove(os.path.join(path, "manifest.json"))
    else:
        if how == "table":
            tables["kb_tagmask"] = tables["kb_tagmask"] ^ 1
        elif how == "index":
            tables["kb_pw"] = tables["kb_pw"].copy()
            tables["kb_pw"][0, 0, 0] = tables["kb_selfloop"].shape[-1]
            manifest["digest"] = base._tables_digest(tables)
        else:
            manifest["engine"] = "levelwise"
        _write_entry(str(tmp_path), f"plan_{key}", tables, manifest)
    want = jax_engines.create("streaming", jnfa, dictionary=jd
                              ).filter_batch(jbatch)
    for hits in (0, 1):
        cache = PlanCache(str(tmp_path))
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                             plan_cache=cache)
        assert (cache.hits, cache.misses) == (hits, 1 - hits)
        assert_same(want, eng.filter_batch(batch))


@pytest.mark.parametrize("query_shards", [1, 2])
def test_churn_and_rebalance_go_through_the_cache(query_shards, tmp_path):
    """Subscribe, unsubscribe and (sharded) a rebalance, twice on one
    cache directory: the second run recompiles nothing, and both route as
    the JAX stage after the same churn."""
    profiles, d, dtd, raw = _workload(n_docs=8)
    jp, jd, jdtd, jraw = _jax_workload(n_docs=8)
    q = gen_profiles(dtd, n=1, length=3, seed=50)[0]
    jq = jax_profiles(jdtd, n=1, length=3, seed=50)[0]

    def churn(stage, new):
        stage.subscribe(new)
        stage.unsubscribe(0)
        if query_shards > 1:
            stage.maybe_rebalance(tolerance=0.0)
        return _stage_routes(stage, raw if new is q else jraw)

    caches, routes = [], []
    for _ in range(2):
        cache = PlanCache(str(tmp_path))
        stage = _stage(profiles, d, query_shards=query_shards,
                       engine_options={"plan_cache": cache})
        routes.append(churn(stage, q))
        caches.append(cache)
    cold, warm = caches
    assert cold.misses >= (3 if query_shards == 1 else 4)
    assert (warm.hits, warm.misses) == (cold.misses, 0)
    want = churn(_jax_stage(jp, jd, query_shards=query_shards), jq)
    assert routes[0] == routes[1] == want


def test_loop_swap_rebuild_hits_the_cache(tmp_path):
    """The serve loop's shadow build carries the stage's engine options,
    so a swap whose plan was compiled before reads it from the cache; the
    requests after the swap route as the JAX loop's through the same
    swap."""
    profiles, d, dtd, raw = _workload(n_docs=12)
    jp, jd, jdtd, jraw = _jax_workload(n_docs=12)
    q = gen_profiles(dtd, n=1, length=3, seed=50)[0]
    _stage(profiles, d, engine_options={"plan_cache": str(tmp_path)}
           ).subscribe(q)                      # the swap's plan, compiled
    cache = PlanCache(str(tmp_path))
    outs = []
    for stage, new in ((_stage(profiles, d,
                               engine_options={"plan_cache": cache}), q),
                       (_jax_stage(jp, jd), jax_profiles(
                           jdtd, n=1, length=3, seed=50)[0])):
        port = stage.__class__.__module__.startswith("repro_torch")
        loop = (ServeLoop if port else JaxLoop)(
            stage, max_batch=BATCH, deadline_ms=60_000, queue_cap=64)
        with loop:
            pre = [loop.submit(p) for p in (raw if port else jraw)[:BATCH]]
            tk = loop.subscribe(new)
            assert tk.done.wait(timeout=120)
            post = [loop.submit(p) for p in (raw if port else jraw)[BATCH:]]
        assert tk.error is None and tk.gid == N_QUERIES
        assert all(not t.failed for t in pre + post)
        # the requests before the swap may be filtered under either epoch
        # (the swap commits at a batch boundary); those after it may not
        outs.append(_routes(post))
    assert (cache.hits, cache.misses) == (2, 0)
    assert outs[0] == outs[1]
    assert any(N_QUERIES in m for m in outs[0].values())


def test_meta_that_does_not_survive_json_is_not_cached(tmp_path,
                                                       monkeypatch):
    """Plan metadata must round-trip through JSON exactly; a plan whose
    metadata does not (a tuple) is compiled and used, never written."""
    (nfa, d, batch), _ = _engine_workload("levelwise")
    orig = lw._LevelEngine.plan

    def plan(self, nfa):
        p = orig(self, nfa)
        return base.FilterPlan(p.engine, p.tables, dict(p.meta, dims=(1, 2)))

    monkeypatch.setattr(lw._LevelEngine, "plan", plan)
    cache = PlanCache(str(tmp_path))
    eng = engines.create("levelwise", nfa, dictionary=d, device="cpu",
                         plan_cache=cache)
    assert cache.misses == 1 and cache.keys() == []
    assert eng.filter_batch(batch).matched.any()


def test_host_engines_do_not_cache(tmp_path):
    (nfa, d, _), _ = _engine_workload("streaming")
    for name in ("oracle", "yfilter"):
        cache = PlanCache(str(tmp_path))
        engines.create(name, nfa, dictionary=d, device="cpu",
                       plan_cache=cache)
        assert (cache.hits, cache.misses, cache.keys()) == (0, 0, [])


# --------------------------------------------------------------- the key
KEY_INPUTS = ["version", "engine", "device", "state_multiple", "max_depth",
              "options", "kernel_config", "pads", "nfa_tables", "queries"]


@pytest.mark.parametrize("change", KEY_INPUTS)
def test_key_changes_with_each_input(change, monkeypatch):
    (nfa, d, _), _ = _engine_workload("streaming")

    def create(**kw):
        return engines.create("streaming", nfa, dictionary=d, device="cpu",
                              **kw)

    eng = create()
    k0 = eng.plan_cache_key(nfa)
    if change == "version":
        monkeypatch.setattr(base, "PLAN_CACHE_VERSION", "repro_torch-plan-x")
    elif change == "engine":
        monkeypatch.setattr(eng, "name", "streaming2")
    elif change == "device":
        monkeypatch.setattr(eng, "device", torch.device("cuda"))
    elif change == "state_multiple":
        monkeypatch.setattr(eng, "state_multiple", 64)
    elif change == "max_depth":
        eng = create(max_depth=9)
    elif change == "options":
        eng = create(event_bucket=64)
    elif change == "kernel_config":
        cfg = eng.kernel_config(*eng._plan_shape(nfa, None))
        monkeypatch.setattr(eng, "kernel_config",
                            lambda s, t: dict(cfg, segment_target=1))
    t = nfa.tables
    if change == "nfa_tables":
        nfa = dataclasses.replace(nfa, tables=t._replace(
            selfloop=np.logical_not(t.selfloop).astype(t.selfloop.dtype)))
    elif change == "queries":
        nfa = dataclasses.replace(nfa, queries=nfa.queries[::-1])
    pads = ({"n_states": 4096, "n_queries": 64} if change == "pads"
            else None)
    assert eng.plan_cache_key(nfa, pads) != k0


def test_key_does_not_change_otherwise(tmp_path):
    """Equal inputs give equal keys: a second engine, another cache
    object or directory, a copy of the NFA, the engine's device index;
    and the port's key is never the JAX package's."""
    (nfa, d, _), (jnfa, jd, _) = _engine_workload("streaming")
    keys = {engines.create("streaming", nfa, dictionary=d, device=dev,
                           plan_cache=PlanCache(str(tmp_path / str(i)))
                           ).plan_cache_key(dataclasses.replace(nfa))
            for i, dev in enumerate(("cpu", "cpu", torch.device("cpu")))}
    assert len(keys) == 1
    jkey = jax_engines.create("streaming", jnfa,
                              dictionary=jd).plan_cache_key(jnfa)
    assert jkey not in keys
