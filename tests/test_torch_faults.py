"""Fault tolerance of the port's query-sharded stage, and its chaos harness.

The counterparts of ``tests/test_faults.py``'s cases on a query-sharded
stage (``query_shards=2``) that need neither a 2-D mesh nor the plan
cache: poison rejected at admission, quarantine by bisection, the
shadow-plan hot swap (prepare, stale prepare, epoch pinning, a swap with
no drain, a failed build rolling back, a rebalance through the loop),
and ``repro_torch.serve.faults``: the seeded chaos drill with every fault
class — the forced ``PadOverflow`` replan included — and the injector
that restores the stage.  Each route is held against the JAX package at
the same settings: its sharded stage for dense delivery, and for
``sparse=True`` the same dense routes (sparse routing equals dense, and
the JAX sharded sparse stage's mesh compaction raises
``ShardingTypeError`` in some JAX installations).  Exact equality.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stage_churn import (BATCH, N_QUERIES, ROUTE_IDS,  # noqa: E402
                                    ROUTES, _jax_stage, _jax_workload,
                                    _nested, _Poisoner, _routes, _stage,
                                    _stage_routes, _verdict_sets, _workload)

from repro.data.generator import gen_profiles as jax_profiles  # noqa: E402
from repro.serve.faults import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serve.faults import run_chaos_trace as jax_chaos  # noqa: E402
from repro.serve.loop import ServeLoop as JaxLoop  # noqa: E402
from repro_torch.core.events import (DEFAULT_MAX_DEPTH,  # noqa: E402
                                     KernelFault)
from repro_torch.data.filter_stage import (FilterStage,  # noqa: E402
                                           StalePlanError)
from repro_torch.data.generator import gen_profiles  # noqa: E402
from repro_torch.kernels.blocks import PadOverflow  # noqa: E402
from repro_torch.serve import (DEFAULT_PLAN, FaultInjector,  # noqa: E402
                               FaultPlan, ServeLoop, run_chaos_trace)

SHARDED = {"query_shards": 2}


def _jax_want(n_docs, healthy=None):
    """The JAX package's sharded dense stage's routes of the workload."""
    jp, jd, _, jraw = _jax_workload(n_docs=n_docs)
    if healthy is not None:
        jraw = [jraw[i] for i in healthy]
    return _stage_routes(_jax_stage(jp, jd, **SHARDED), jraw)


# ------------------------------------------------------- error taxonomy
@pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
def test_loop_rejects_poison_on_the_sharded_route(kw):
    """Malformed and over-depth payloads are rejected at admission with
    typed errors, and the healthy documents get the fault-free routes."""
    profiles, d, _, raw = _workload(n_docs=6)
    loop = ServeLoop(_stage(profiles, d, **SHARDED, **kw), max_batch=BATCH,
                     deadline_ms=60_000, queue_cap=64)
    with loop:
        bad_m = loop.submit(d.open_bytes(0))
        bad_d = loop.submit(_nested(d, DEFAULT_MAX_DEPTH + 1))
        tickets = [loop.submit(p) for p in raw]
    assert (type(bad_m.error).__name__, type(bad_d.error).__name__) == (
        "MalformedDocument", "DepthOverflow")
    assert bad_m.seq == -1 and bad_d.seq == -1
    assert _routes(tickets) == _jax_want(6)
    s = loop.slo_summary()
    assert (s["rejected"], s["quarantined"], s["completed"]) == (2, 2, 6)


# -------------------------------------------------- quarantine/bisection
class TestQuarantine:
    def _run(self, poison_at, kw, n_docs=8):
        profiles, d, _, raw = _workload(n_docs=n_docs)
        healthy = [i for i in range(n_docs) if i not in poison_at]
        marked = dict(enumerate(raw))
        for i in poison_at:
            marked[i] = raw[i] + d.open_bytes(1) + d.close_bytes(1)
        stage = _stage(profiles, d, **SHARDED, **kw)
        _Poisoner(stage, {marked[i] for i in poison_at})
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=60_000,
                         queue_cap=64)
        with loop:
            tickets = [loop.submit(marked[i]) for i in range(n_docs)]
        return loop, tickets, healthy

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_single_poison_quarantined_as_kernel_fault(self, kw):
        loop, tickets, _ = self._run({2}, kw)
        t = tickets[2]
        assert t.failed and isinstance(t.error, KernelFault)
        assert t.error.doc_indices == (t.seq,)
        s = loop.slo_summary()
        assert s["quarantined"] == 1 and s["failed"] == 0
        assert s["retries"] >= 1
        assert [r["error"] for r in loop.dead_letter] == ["KernelFault"]

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    @pytest.mark.parametrize("pos", [{2}, {0, 5}, {1, 4, 7}])
    def test_healthy_verdicts_survive_quarantine(self, kw, pos):
        loop, tickets, healthy = self._run(pos, kw)
        assert all(tickets[i].failed for i in pos)
        got = {(rd.doc_index, rd.shard): tuple(int(x) for x in
                                               rd.matched_profiles)
               for i in healthy for rd in tickets[i].routed}
        assert _verdict_sets(got) == _verdict_sets(_jax_want(8, healthy))
        s = loop.slo_summary()
        assert s["arrived"] == (s["completed"] + s["shed"] + s["failed"]
                                + s["quarantined"])


# ---------------------------------------------------- shadow-plan hot swap
class TestShadowSwap:
    def _pair(self, n_docs=16, **kw):
        profiles, d, dtd, raw = _workload(n_docs=n_docs)
        jp, jd, jdtd, jraw = _jax_workload(n_docs=n_docs)
        return ((_stage(profiles, d, **SHARDED, **kw), dtd, raw),
                (_jax_stage(jp, jd, **SHARDED), jdtd, jraw))

    def test_prepare_commit_subscribe(self):
        out = []
        for stage, dtd, _ in self._pair():
            port = isinstance(stage, FilterStage)
            q = (gen_profiles if port else jax_profiles)(
                dtd, n=1, length=3, seed=50)[0]
            ep0 = stage.plan_epoch()
            pending = stage.prepare_subscribe(q)
            assert stage.plan_epoch().epoch == ep0.epoch
            assert pending.sharded is not None and pending.eng is None
            gid = stage.commit(pending)
            assert gid == N_QUERIES
            assert stage.plan_epoch().epoch == ep0.epoch + 1
            out.append((list(stage.plan_epoch().gids),
                        stage.sharded_.part_cols))
        assert out[0] == out[1]

    def test_stale_prepare_raises_and_retry_succeeds(self):
        (stage, dtd, _), _ = self._pair()
        qa, qb = gen_profiles(dtd, n=2, length=3, seed=51)
        pending = stage.prepare_subscribe(qa)
        stage.subscribe(qb)
        with pytest.raises(StalePlanError):
            stage.commit(pending)
        gid = stage.commit(stage.prepare_subscribe(qa))
        assert gid in stage.sharded_.live_ids()

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_epoch_pins_inflight_batch_plan(self, kw):
        """A batch filtered against an epoch-N snapshot fans out with
        epoch N's sharded plan and gids even after swaps commit, and the
        old plan's stacked tables are untouched by the subscribe."""
        (stage, dtd, raw), _ = self._pair(n_docs=BATCH, **kw)
        want = _stage_routes(stage, raw)
        ep = stage.plan_epoch()
        tables = {k: v.clone() for k, v in ep.sharded.stacked().tables.items()}
        stage.subscribe(gen_profiles(dtd, n=1, length=3, seed=52)[0])
        stage.unsubscribe(0)
        assert stage.plan_epoch().epoch == ep.epoch + 2
        assert stage.plan_epoch().sharded is not ep.sharded
        res = stage._filter_bytebatch(raw, record=False, epoch=ep)
        got = {(r.doc_index, r.shard): tuple(int(x) for x in
                                             r.matched_profiles)
               for r in stage._fan_out(res, [len(p) for p in raw],
                                       gids=ep.gids)}
        assert got == want == _jax_want(BATCH)
        for k, v in ep.sharded.stacked().tables.items():
            assert (v == tables[k]).all(), k

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_loop_subscribe_swaps_without_drain(self, kw):
        """A live subscribe through the loop commits while it serves; the
        later documents route with the new profile as the JAX loop routes
        them."""
        outs = []
        for stage, dtd, raw in self._pair(n_docs=12, **kw):
            port = isinstance(stage, FilterStage)
            hits = np.bincount(np.concatenate(
                [m for (doc, _), m in _stage_routes(stage, raw).items()
                 if doc >= BATCH]).astype(np.int64), minlength=N_QUERIES)
            q = stage.profiles[int(np.argmax(hits))]
            loop = (ServeLoop if port else JaxLoop)(
                stage, max_batch=BATCH, deadline_ms=60_000, queue_cap=64)
            with loop:
                pre = [loop.submit(p) for p in raw[:BATCH]]
                tk = loop.subscribe(q)
                assert tk.done.wait(timeout=120)
                post = [loop.submit(p) for p in raw[BATCH:]]
            assert tk.error is None and tk.gid == N_QUERIES
            assert loop.swap_summary()["swaps"] == 1
            for t in pre:
                for rd in t.routed:
                    assert all(int(x) < N_QUERIES
                               for x in np.asarray(rd.matched_profiles))
            assert all(not t.failed for t in pre + post)
            outs.append(_routes(post))
        assert outs[0] == outs[1]
        assert any(N_QUERIES in m for m in outs[0].values())

    def test_failed_shadow_build_rolls_back(self):
        (stage, dtd, raw), _ = self._pair(n_docs=8)
        ep0 = stage.plan_epoch()
        orig = stage.prepare_subscribe
        stage.prepare_subscribe = lambda q: (_ for _ in ()).throw(
            RuntimeError("shadow build exploded"))
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=60_000,
                         queue_cap=64)
        with loop:
            tk = loop.subscribe(gen_profiles(dtd, n=1, length=3,
                                             seed=54)[0])
            assert tk.done.wait(timeout=120)
            assert "shadow build exploded" in str(tk.error)
            stage.prepare_subscribe = orig
            tickets = [loop.submit(p) for p in raw]
        assert all(not t.failed for t in tickets)
        s = loop.slo_summary()
        assert s["swap_rollbacks"] == 1 and s["swaps"] == 0
        assert stage.plan_epoch().sharded is ep0.sharded
        assert _routes(tickets) == _jax_want(8)

    def test_loop_rebalance_commits_and_routes_the_same(self):
        """A skewed plan rebalanced through the loop's shadow builder:
        the ticket carries the stats, the epoch moves, and every request
        routes as before the move."""
        (stage, dtd, raw), _ = self._pair(n_docs=8)
        sp = stage.sharded_
        for g in [int(g) for g in sp.live_ids()
                  if int(sp.partition.part_of[g]) != 0][:-1]:
            stage.unsubscribe(g)
        want = _stage_routes(stage, raw)
        assert stage.sharded_.imbalance() > 0.25
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=60_000,
                         queue_cap=64)
        with loop:
            tk = loop.rebalance(0.25)
            assert tk.done.wait(timeout=120)
            tickets = [loop.submit(p) for p in raw]
        assert tk.error is None and tk.stats["moves"] > 0
        assert stage.stats["rebalances"] == 1
        assert stage.sharded_.imbalance() < tk.stats["imbalance_before"]
        assert _routes(tickets) == want


# ------------------------------------------------------------ chaos trace
class TestChaosTrace:
    def test_default_drill_passes_every_check(self):
        """Every containment promise holds on the CPU, the forced
        ``PadOverflow`` full replan included."""
        report = run_chaos_trace(24, plan=FaultPlan(
            malformed=(3,), overdepth=(7,), kernel=(10,),
            worker_fault_batches=(2,), pad_overflow_adds=(2,)),
            device="cpu")
        assert report["ok"], report["checks"]
        assert report["checks"]["pad_overflow_forced"]
        assert report["slo"]["failed"] == 0
        errs = sorted(r["error"] for r in report["dead_letter"])
        assert errs == ["DepthOverflow", "KernelFault", "MalformedDocument"]
        assert report["swaps"]["swaps"] == 2

    def test_drill_equals_jax(self):
        """The same drill in both packages: the same checks, dead letters
        and deterministic counters."""
        kw = dict(malformed=(3,), overdepth=(7,), kernel=(10,),
                  worker_fault_batches=(2,), pad_overflow_adds=(2,))
        got = run_chaos_trace(24, plan=FaultPlan(**kw), device="cpu")
        want = jax_chaos(24, plan=JaxFaultPlan(**kw))
        assert got["checks"] == want["checks"]
        assert got["dead_letter"] == want["dead_letter"]
        for k in ("arrived", "completed", "quarantined", "rejected",
                  "failed", "swaps", "swap_rollbacks"):
            assert got["slo"][k] == want["slo"][k], k

    def test_forced_pad_overflow_takes_the_full_replan(self):
        """An armed injector raises ``PadOverflow`` at the fits-old-pads
        attempt of the next subscribe; the add then re-pads every part and
        still commits, routing as the JAX stage after the same add."""
        profiles, d, dtd, raw = _workload(n_docs=8)
        jp, jd, jdtd, jraw = _jax_workload(n_docs=8)
        stage = _stage(profiles, d, **SHARDED)
        jstage = _jax_stage(jp, jd, **SHARDED)
        extra = gen_profiles(dtd, n=2, length=3, seed=97)
        jextra = jax_profiles(jdtd, n=2, length=3, seed=97)
        stage.subscribe(extra[0])      # the first add re-pads on its own
        jstage.subscribe(jextra[0])
        inj = FaultInjector(stage, DEFAULT_PLAN, set())
        inj.arm_pad_overflow()
        plans = stage.sharded_.plans
        gid = stage.subscribe(extra[1])
        inj.remove()
        assert inj.pad_overflows_forced == 1
        assert all(a is not b for a, b in zip(plans, stage.sharded_.plans))
        assert gid == jstage.subscribe(jextra[1])
        assert _stage_routes(stage, raw) == _stage_routes(jstage, jraw)
        with pytest.raises(PadOverflow):
            inj2 = FaultInjector(stage, DEFAULT_PLAN, set())
            inj2.arm_pad_overflow()
            try:
                inj2._plan_part(stage.sharded_.part_nfas[0],
                                stage.sharded_.pads)
            finally:
                inj2.remove()

    def test_injector_restores_stage(self):
        profiles, d, dtd, raw = _workload()
        stage = _stage(profiles, d, **SHARDED)
        orig_filter = stage._filter_bytebatch
        orig_plan = stage._eng.plan_part
        inj = FaultInjector(stage, DEFAULT_PLAN, set())
        assert stage._filter_bytebatch != orig_filter
        assert stage._eng.plan_part != orig_plan
        inj.remove()
        assert stage._filter_bytebatch == orig_filter
        assert stage._eng.plan_part == orig_plan

    def test_module_main_on_the_cpu(self, capsys):
        from repro_torch.serve import faults

        assert faults.main(["--requests", "24", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "PASS pad_overflow_forced" in out and "FAIL" not in out
