"""The port's budget options and measured autotune against the JAX package.

The counterparts of the autotune cases of ``tests/test_megakernel.py``
(``TestKernelSelection``: the static policy's budgets, explicit options
over the policy) and ``tests/test_packing.py::TestMeasuredAutotune`` (the
config cache, a search that persists a winner an engine then reads).
``test_budget_env_overrides`` has no twin: the JAX package's
``REPRO_PALLAS_*_BUDGET`` variables name Pallas, and the port does not
read them (the ``vmem_budget=`` / ``smem_budget=`` options remain).  Then
what the port adds: its ``kernel_config`` equals the JAX engine's over a
sweep of budgets, and so do the plans laid out at them; a search on the
CPU times each distinct effective launch shape once, skips only layout
refusals, and lets an error raised by a launch propagate.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stream_filter import (jax_kernel_plan,  # noqa: E402
                                      ragged_bb, workload)
from test_torch_streaming import assert_same, port_bytes  # noqa: E402

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.engines.base import FilterEngine as JaxEngine  # noqa: E402
from repro.kernels import autotune as jax_at  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core.engines.base import FilterEngine  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import stream_filter as sf  # noqa: E402

BUDGET_ENV = ("REPRO_PALLAS_VMEM_BUDGET", "REPRO_PALLAS_SMEM_BUDGET")


@pytest.fixture(autouse=True)
def _no_pallas_budget_env(monkeypatch):
    """The JAX policy reads its budget variables when a budget is None;
    with them unset both packages start from the same defaults."""
    for var in BUDGET_ENV:
        monkeypatch.delenv(var, raising=False)


# ----------------------------------------- twins of TestKernelSelection
class TestKernelSelection:
    def test_autotune_blocks_respects_budgets(self):
        cases = [((4096, 64), {"n_tags": 64}),
                 ((40, 64), {"n_tags": 64}),
                 ((4096, 64), {"n_tags": 4096, "vmem_budget": 128 << 10}),
                 ((256, 64), {"n_tags": 16, "smem_budget": 512})]
        cfg, small, tight, smem = (FilterEngine.autotune_blocks(*a, **kw)
                                   for a, kw in cases)
        for (a, kw), got in zip(cases, (cfg, small, tight, smem)):
            assert got == JaxEngine.autotune_blocks(*a, **kw)
        assert cfg["blk"] % 32 == 0 and cfg["chunk"] >= 32
        # a tiny NFA never gets a block wider than its padded state count
        assert small["blk"] == 64
        # a huge tag space shrinks the block until the masks fit the budget
        assert tight["blk"] == 128 < cfg["blk"]
        # the SMEM budget caps the event chunk (double-buffered int32)
        assert smem["chunk"] == 64

    def test_engine_options_override_autotune(self):
        dtd, d, qs, nfa = workload(n_queries=24, seed=10)
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                             blk=64, chunk=96)
        meta = eng.plan_.meta
        assert meta["blk"] % 32 == 0 and meta["blk"] >= 64
        assert meta["chunk"] == 96
        jmeta = jax_kernel_plan(nfa, d, blk=64, chunk=96).meta
        for k in convert.META_KEYS:
            assert meta[k] == jmeta[k], k


# -------------------------------------- twins of TestMeasuredAutotune
class TestMeasuredAutotune:
    def test_cache_round_trip(self, tmp_path):
        cfg = {"blk": 32, "byte_chunk": 64, "grid_order": "gb",
               "segment_target": 256}
        for mod in (at, jax_at):
            path = str(tmp_path / f"{mod.__name__}.json")
            key = mod.plan_key("cpu", 64, 14, 64, 32)
            mod.save_cache({key: {"config": cfg, "seconds": 0.5,
                                  "trials": 1, "timestamp": 0}}, path)
            assert mod.cached_config(key, path) == cfg
            assert mod.cached_config("missing:key", path) is None
            # corrupt files degrade to a miss, never an error
            with open(path, "w") as fh:
                fh.write("not json")
            assert mod.load_cache(path) == {}
        # one plan shape, two packages: the keys never collide
        assert at.plan_key("cpu", 64, 14, 64, 32) \
            != jax_at.plan_key("cpu", 64, 14, 64, 32)

    def test_search_persists_and_engine_consumes(self, tmp_path,
                                                 monkeypatch):
        from repro.core.events import ByteBatch
        from repro.data.generator import gen_corpus

        cache = str(tmp_path / "cache.json")
        dtd, d, qs, nfa = workload(n_queries=8, seed=6)
        docs = gen_corpus(dtd, n_docs=3, nodes_per_doc=8, seed=6)
        bb = port_bytes(ByteBatch.from_streams(docs, text_fill=2, bucket=64))
        best, rows = at.search(
            nfa, d, bb, blks=(32,), byte_chunks=(64,), grid_orders=("gb",),
            segment_targets=(256,), trials=1, device="cpu",
            cache_file=cache)
        assert best["grid_order"] == "gb" and best["seconds"] > 0
        assert [r for r in rows if "seconds" in r]
        # an engine with autotune="measured" overlays the cached winner
        monkeypatch.setenv(at.CACHE_ENV, cache)
        eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                             autotune="measured")
        meta = eng.plan_.meta
        assert (meta["byte_chunk"], meta["grid_order"],
                meta["segment_target"]) == (64, "gb", 256)
        # explicit engine options still beat the measured overlay
        eng2 = engines.create("streaming", nfa, dictionary=d, device="cpu",
                              autotune="measured", byte_chunk=128)
        assert eng2.plan_.meta["byte_chunk"] == 128
        # the JAX engine overlays the same winner the same way
        jkey = jax_at.plan_key("interpret", eng.plan_.meta["n_states"],
                               nfa.n_tags, 64, 32)
        jcache = str(tmp_path / "jax.json")
        jax_at.save_cache({jkey: {"config": best}}, jcache)
        monkeypatch.setenv(jax_at.CACHE_ENV, jcache)
        for opts, port in (({}, eng), ({"byte_chunk": 128}, eng2)):
            jmeta = jax_kernel_plan(nfa, d, autotune="measured",
                                    **opts).meta
            for k in convert.META_KEYS:
                assert port.plan_.meta[k] == jmeta[k], k


# ------------------------------------------------- what the port adds
BUDGETS = [(vb, sb) for vb in (None, 24 << 10, 64 << 10, 128 << 10, 1 << 20)
           for sb in (None, 512, 1 << 10)]


@pytest.mark.parametrize("vb,sb", BUDGETS)
def test_kernel_config_equals_jax_over_budgets(vb, sb):
    """The budget options feed the same formula in both packages: the
    same ``blk`` and ``chunk`` at every plan shape, and, at the workload's
    own shape, the same plan tables."""
    opts = {k: v for k, v in (("vmem_budget", vb), ("smem_budget", sb))
            if v is not None}
    dtd, d, qs, nfa = workload(n_queries=40, seed=8, p_desc=0.5)
    eng = engines.create("streaming", nfa, dictionary=d, device="cpu",
                         **opts)
    jeng = jax_engines.create("streaming", nfa, dictionary=d,
                              kernel="pallas", kernel_interpret=True, **opts)
    for shape in ((64, 14), (4096, 64), (4096, 4096), (21_120, 129)):
        got, want = eng.kernel_config(*shape), jeng.kernel_config(*shape)
        for k in got:
            assert got[k] == want[k], (shape, k)
    plan, jplan = eng.plan_, jeng.plan_
    for k in convert.BLOCK_TABLES:
        w = np.asarray(jplan[k])
        np.testing.assert_array_equal(
            plan[k].numpy(), w.view(np.int32) if w.dtype == np.uint32 else w,
            err_msg=k)
    for k in convert.META_KEYS:
        assert plan.meta[k] == jplan.meta[k], k


def test_search_times_each_distinct_shape_once(tmp_path, monkeypatch):
    """Candidates that lay out the same effective launch shape fall
    together: only the first is timed, every row names the effective
    block size and count, and the winner is cached under the device's
    key."""
    dtd, d, qs, nfa = workload(n_queries=24, seed=3, p_desc=0.5)
    bb = port_bytes(ragged_bb(dtd, d, 3))
    cache = str(tmp_path / "at.json")
    calls = []
    orig = at._time_engine

    def counted(eng, bb, trials):
        calls.append(eng.plan_.meta["blk"])
        return orig(eng, bb, trials)

    monkeypatch.setattr(at, "_time_engine", counted)
    best, rows = at.search(
        nfa, d, bb, blks=(32, 64, 1024), byte_chunks=(128, 512),
        grid_orders=("bg", "gb"), segment_targets=(256,), trials=1,
        device="cpu", cache_file=cache)
    monkeypatch.undo()
    assert len(rows) == 3 * 2 * 2
    effective = {(r["blk_eff"], r["n_blocks"]) for r in rows}
    assert len(calls) == len(effective) < len(rows)
    for i, r in enumerate(rows):
        if "same_as" in r:
            first = rows[r["same_as"]]
            assert "same_as" not in first and r["same_as"] < i
            assert (first["blk_eff"], first["n_blocks"], first["seconds"]) \
                == (r["blk_eff"], r["n_blocks"], r["seconds"])
    assert all(r["blk_eff"] >= r["blk"] for r in rows)   # grown, never cut
    key = at.plan_key("cpu", -(-nfa.n_states // 32) * 32, nfa.n_tags, 64, 32)
    assert at.cached_config(key, cache) == {k: best[k]
                                            for k in at.CONFIG_KEYS}
    measured = engines.create("streaming", nfa, dictionary=d, device="cpu",
                              autotune="measured")
    plain = engines.create("streaming", nfa, dictionary=d, device="cpu")
    assert_same(plain.filter_bytes(bb), measured.filter_bytes(bb))


def test_search_skips_only_layout_refusals(tmp_path):
    """A candidate whose plan is refused before any launch (a ValueError
    of the layout) is a skipped row; the others are timed."""
    dtd, d, qs, nfa = workload(n_queries=8, seed=6)
    bb = port_bytes(ragged_bb(dtd, d, 6))
    best, rows = at.search(
        nfa, d, bb, blks=(32,), grid_orders=("xy", "bg"),
        segment_targets=(256,), trials=1, device="cpu",
        cache_file=str(tmp_path / "at.json"))
    assert rows[0]["skipped"].startswith("ValueError")
    assert "seconds" in rows[1] and best["grid_order"] == "bg"


def test_search_propagates_a_launch_error(tmp_path, monkeypatch):
    """An error raised by a launch is a fault, not a skipped candidate:
    the search stops with it and caches nothing."""
    dtd, d, qs, nfa = workload(n_queries=8, seed=6)
    bb = port_bytes(ragged_bb(dtd, d, 6))

    def fail(*args, **kw):
        raise RuntimeError("stream_filter_bytes launch failed: CUDA error 700")

    monkeypatch.setattr(sf, "stream_filter_bytes", fail)
    cache = str(tmp_path / "at.json")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        at.search(nfa, d, bb, blks=(32, 64), segment_targets=(256,),
                  trials=1, device="cpu", cache_file=cache)
    assert not os.path.exists(cache)


def test_cli_writes_the_cache(tmp_path, capsys):
    cache = str(tmp_path / "cli.json")
    assert at.main(["--device", "cpu", "--trials", "1", "--queries", "16",
                    "--docs", "6", "--nodes", "24", "--blks", "32",
                    "--segment-targets", "256", "--cache", cache]) == 0
    out = capsys.readouterr().out
    assert '"best"' in out and at.load_cache(cache)
    assert next(iter(at.load_cache(cache))).startswith(
        f"torch-v{at.KEY_VERSION}:cpu:")


# ------------------------------------------- the option gap, repaired
OPTION_VALUES = {"blk": 64, "chunk": 64, "byte_chunk": 128,
                 "grid_order": "gb", "segment_target": 256, "ep_tile": 16,
                 "pack": True, "fuse": False, "event_bucket": 64,
                 "match_cap": 9, "sparse_epilogue": "off"}


def test_option_values_cover_both_key_sets():
    from repro.core.engines.streaming import TUNABLE_KEYS as JAX_TUNABLE
    from repro_torch.core.engines.streaming import CALL_KEYS, TUNABLE_KEYS

    assert set(JAX_TUNABLE) == set(TUNABLE_KEYS)
    assert set(OPTION_VALUES) == set(TUNABLE_KEYS) | set(CALL_KEYS)


@pytest.mark.parametrize("key", sorted(OPTION_VALUES))
def test_every_jax_option_is_taken_and_routes_as_jax(key):
    """Every launch-shape option of the JAX engine (``TUNABLE_KEYS``,
    ``chunk=`` and ``byte_chunk=`` included) and every call-time option of
    the port's (``CALL_KEYS``) is taken by the port's engine: its plan's
    metadata equals the JAX kernel plan's, and its dense and sparse
    verdicts equal the JAX engine's built with the same option."""
    opt = {key: OPTION_VALUES[key]}
    dtd, d, qs, nfa = workload(n_queries=24, seed=12, p_desc=0.5)
    bb = ragged_bb(dtd, d, 12)
    port = engines.create("streaming", nfa, dictionary=d, device="cpu",
                          **opt)
    jeng = jax_engines.create("streaming", nfa, dictionary=d, kernel="scan",
                              **opt)
    jmeta = jax_kernel_plan(nfa, d, **opt).meta
    for k in convert.META_KEYS:
        assert port.plan_.meta[k] == jmeta[k], k
    want = jeng.filter_bytes(bb)
    assert want.matched.any()
    assert_same(want, port.filter_bytes(port_bytes(bb)))
    got_sp, want_sp = (port.filter_bytes_sparse(port_bytes(bb)),
                       jeng.filter_bytes_sparse(bb))
    assert got_sp.overflowed == want_sp.overflowed
    assert_same(want_sp.densify(), got_sp.densify())
