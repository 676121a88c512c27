"""The port's serve loop (:mod:`repro_torch.serve.loop`) on the CPU.

The counterparts of ``tests/test_serve_loop.py``'s tests of an unsharded
stage, run on the port (``device="cpu"``, the kernels' plain versions):
the loop is *schedule*, not *semantics* — whatever the batch-close
reason, pipeline depth or overload policy, every admitted request gets
the verdict the synchronous ``route_bytes`` path computes, delivered in
admission order, and every bound binds.  Then the parity test: the same
seeded payloads and arrival trace through the JAX package's loop and the
port's, dense and sparse, at ``max_inflight`` 1 and 3, must give identical
delivery queues, dead letters and deterministic counters.  Last, the
twins of its ``data_shards=2`` tests: the loop over a 2-D stage, and the
K-deep pipelined route on a mesh of the CPU device.  Waits are
generous upper bounds; no assertion depends on tight timing.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.dictionary import TagDictionary as JaxDictionary
from repro.core.events import encode_bytes as jax_encode
from repro.data.filter_stage import FilterStage as JaxStage
from repro.data.generator import DTD as JaxDTD
from repro.data.generator import gen_corpus as jax_corpus
from repro.data.generator import gen_profiles as jax_profiles
from repro.serve.loop import ServeLoop as JaxLoop
from repro.serve.loop import replay_arrivals as jax_replay
from repro.serve.loop import run_trace as jax_run_trace
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import (DEFAULT_MAX_DEPTH, KernelFault,
                                     encode_bytes)
from repro_torch.data.filter_stage import TEXT_FILL, FilterStage
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.launch.mesh import FilterMesh
from repro_torch.serve.loop import (ServeLoop, burst_arrivals,
                                    make_arrivals, poisson_arrivals,
                                    replay_arrivals, run_trace)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_gpu import swap_with_batches_in_flight  # noqa: E402

ENGINE = "streaming"
N_QUERIES = 16
BATCH = 4


def _workload(n_docs=16, seed=0):
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    profiles = gen_profiles(dtd, n=N_QUERIES, length=3, seed=seed)
    docs = gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=40, seed=1)
    raw = [encode_bytes(x, text_fill=TEXT_FILL) for x in docs]
    return profiles, d, raw


def _stage(profiles, d, **kw):
    kw.setdefault("engine", ENGINE)
    kw.setdefault("keep_unmatched", True)
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("device", "cpu")
    return FilterStage(profiles, d, n_shards=2, **kw)


def _routes(batches):
    return {(r.doc_index, r.shard): tuple(r.matched_profiles)
            for b in batches for r in b}


def _ticket_routes(tickets):
    return {(rd.doc_index, rd.shard): tuple(rd.matched_profiles)
            for t in tickets if not t.shed for rd in t.routed}


# ------------------------------------------------------------ batch closing
class TestAdaptiveBatching:
    def test_size_close_fires_before_deadline(self):
        profiles, d, raw = _workload(n_docs=2 * BATCH)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=60_000, queue_cap=64)
        with loop:
            tickets = [loop.submit(p) for p in raw]
            for t in tickets:
                assert t.done.wait(timeout=60), "verdict never arrived"
        s = loop.slo_summary()
        # an exact multiple of max_batch under an effectively infinite
        # deadline: every close is a size close
        assert s["size_closes"] == 2
        assert s["deadline_closes"] == 0 and s["flush_closes"] == 0
        assert s["batch_fill"] == 1.0
        assert s["completed"] == len(raw) and s["shed"] == 0

    def test_deadline_close_fires_under_size(self):
        profiles, d, raw = _workload(n_docs=BATCH - 1)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=50, queue_cap=64)
        with loop:
            tickets = [loop.submit(p) for p in raw]
            # fewer than max_batch queued and nothing else arriving: only
            # the deadline can close this batch
            for t in tickets:
                assert t.done.wait(timeout=60), "deadline close never fired"
            assert loop.slo_summary()["deadline_closes"] >= 1
        s = loop.slo_summary()
        assert s["completed"] == BATCH - 1
        assert s["size_closes"] == 0

    def test_flush_close_on_exit(self):
        profiles, d, raw = _workload(n_docs=2)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=60_000, queue_cap=64)
        with loop:
            tickets = [loop.submit(p) for p in raw]
            # no wait: close() must flush the sub-deadline remainder
        assert all(t.t_verdict is not None for t in tickets)
        assert loop.slo_summary()["flush_closes"] >= 1


# --------------------------------------------------------- admission control
class TestAdmissionControl:
    def _stalled_loop(self, profiles, d, overload, queue_cap):
        """A loop whose consumer is stalled: the completer blocks in
        deliver() holding the single in-flight slot, so the queue can
        only fill — admission at the cap is what's under test."""
        release = threading.Event()
        delivered = []

        def deliver(routed):
            delivered.append(routed)
            release.wait(timeout=120)

        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=5, queue_cap=queue_cap,
                         max_inflight=1, overload=overload,
                         deliver=deliver)
        return loop, release, delivered

    def test_shed_beyond_queue_cap(self):
        profiles, d, raw = _workload(n_docs=32)
        cap = 4
        loop, release, delivered = self._stalled_loop(profiles, d,
                                                      "shed", cap)
        try:
            tickets = [loop.submit(p) for p in raw]
            shed = [t for t in tickets if t.shed]
            # the queue is bounded: with the pipeline wedged, at most
            # cap + (in flight through the batcher) requests can be
            # admitted; the rest MUST shed, immediately (no blocking)
            assert len(shed) > 0
            s = loop.slo_summary()
            assert s["shed"] == len(shed)
            assert s["max_queue_depth"] <= cap
            assert s["admitted"] + s["shed"] == len(raw)
            # shed tickets resolve instantly, with no verdict
            for t in shed:
                assert t.done.is_set() and t.t_verdict is None
                assert t.seq == -1
        finally:
            release.set()
            loop.close()
        # everything admitted (not shed) still got its verdict
        assert loop.slo_summary()["completed"] == \
            loop.slo_summary()["admitted"]

    def test_block_at_queue_cap_stalls_producer(self):
        profiles, d, raw = _workload(n_docs=12)
        loop, release, delivered = self._stalled_loop(profiles, d,
                                                      "block", 2)
        produced = threading.Event()
        tickets = []

        def producer():
            for p in raw:
                tickets.append(loop.submit(p))
            produced.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            # the producer must wedge against the bounded queue while
            # the consumer is stalled...
            assert not produced.wait(timeout=1.0), \
                "submit() never blocked at queue_cap under block policy"
        finally:
            release.set()
            # ...and drain completely once the consumer resumes
            assert produced.wait(timeout=120), "producer stayed blocked"
            t.join(timeout=120)
            loop.close()
        s = loop.slo_summary()
        assert s["shed"] == 0
        assert s["completed"] == len(raw)
        assert all(not t_.shed for t_ in tickets)

    def test_backpressure_counter_under_stalled_consumer(self):
        profiles, d, raw = _workload(n_docs=16)
        loop, release, delivered = self._stalled_loop(profiles, d,
                                                      "shed", 16)
        try:
            for p in raw:
                loop.submit(p)
            # K=1 and a stalled consumer: the batcher must report
            # waiting on an in-flight slot
            deadline = time.monotonic() + 60
            while (loop.slo_summary()["backpressure_waits"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert loop.slo_summary()["backpressure_waits"] >= 1
        finally:
            release.set()
            loop.close()


# ------------------------------------------------------ parity & ordering
class TestParity:
    @pytest.mark.parametrize("max_inflight", [1, 2, 4])
    def test_verdicts_bit_identical_to_route_bytes(self, max_inflight):
        """K-deep pipelining parity: whatever K, verdicts equal the
        synchronous path bit for bit and arrive in order."""
        profiles, d, raw = _workload(n_docs=17)  # ragged tail on purpose
        deliveries = []
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=60_000, queue_cap=64,
                         max_inflight=max_inflight,
                         deliver=deliveries.append)
        with loop:
            tickets = [loop.submit(p) for p in raw]
        want = _routes(_stage(profiles, d).route_bytes(raw))
        assert _ticket_routes(tickets) == want
        assert _routes(deliveries) == want
        # ordered delivery per subscriber: each shard sees its documents
        # in admission order
        per_shard: dict[int, list[int]] = {}
        for batch in deliveries:
            for rd in batch:
                per_shard.setdefault(rd.shard, []).append(rd.doc_index)
        for shard, seq in per_shard.items():
            assert seq == sorted(seq), f"shard {shard} out of order: {seq}"

    def test_parity_with_deadline_closed_padded_batches(self):
        """Undersized deadline-closed batches are padded back to
        max_batch (one compiled shape) — the pad rows must never leak
        into verdicts."""
        profiles, d, raw = _workload(n_docs=10)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=1, queue_cap=64)
        assert loop.pad_batches
        with loop:
            tickets = []
            for p in raw:
                tickets.append(loop.submit(p))
                time.sleep(0.01)  # let deadlines fire mid-stream
        assert loop.slo_summary()["completed"] == len(raw)
        want = _routes(_stage(profiles, d).route_bytes(raw))
        assert _ticket_routes(tickets) == want

    def test_parity_sparse_stage(self):
        """Sparse verdict delivery through the loop (pad_batches is
        auto-disabled: match lists carry real doc ids)."""
        profiles, d, raw = _workload(n_docs=9)
        loop = ServeLoop(_stage(profiles, d, sparse=True),
                         max_batch=BATCH, deadline_ms=60_000,
                         queue_cap=64)
        assert not loop.pad_batches
        with loop:
            tickets = [loop.submit(p) for p in raw]
        want = _routes(_stage(profiles, d).route_bytes(raw))
        assert _ticket_routes(tickets) == want

    def test_latencies_and_slo_summary(self):
        profiles, d, raw = _workload(n_docs=BATCH * 2)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=60_000, queue_cap=64)
        with loop:
            tickets = [loop.submit(p) for p in raw]
        lat = loop.latencies_ms()
        assert lat.shape == (len(raw),) and (lat > 0).all()
        s = loop.slo_summary()
        assert np.isfinite([s["p50_ms"], s["p99_ms"], s["p999_ms"]]).all()
        assert s["p50_ms"] <= s["p99_ms"] <= s["p999_ms"]
        assert s["served_per_s"] > 0
        for t in tickets:
            assert t.latency_s is not None and t.latency_s > 0
        hist = loop.latency_histogram(n_bins=8)
        assert sum(hist["counts"]) == len(raw)
        assert len(hist["edges_ms"]) == len(hist["counts"]) + 1

    def test_persistent_worker_error_quarantines_not_crashes(self):
        """A fault that survives retry + bisection quarantines the
        affected requests as typed ``KernelFault``s — the loop keeps
        serving and close() does NOT raise (containment, not crash)."""
        profiles, d, raw = _workload(n_docs=2)
        stage = _stage(profiles, d)

        def boom(payloads, record=True, epoch=None):
            raise RuntimeError("device fell over")

        stage._filter_bytebatch = boom
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=5,
                         queue_cap=8)
        tickets = [loop.submit(p) for p in raw]
        for t in tickets:
            assert t.done.wait(timeout=60)
        loop.close()  # must not raise: the fault was contained
        for t in tickets:
            assert t.failed and isinstance(t.error, KernelFault)
            assert "device fell over" in str(t.error)
        s = loop.slo_summary()
        assert s["quarantined"] == len(raw) and s["failed"] == 0
        assert len(loop.dead_letter) == len(raw)

    def test_worker_error_propagates_on_close_without_recovery(self):
        """``recover=False`` restores the strict contract: a worker
        error fails the affected requests and re-raises at close()."""
        profiles, d, raw = _workload(n_docs=2)
        stage = _stage(profiles, d)

        def boom(payloads, record=True, epoch=None):
            raise RuntimeError("device fell over")

        stage._filter_bytebatch = boom
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=5,
                         queue_cap=8, recover=False)
        tickets = [loop.submit(p) for p in raw]
        for t in tickets:
            assert t.done.wait(timeout=60)
        with pytest.raises(RuntimeError, match="device fell over"):
            loop.close()
        assert all(t.failed for t in tickets)
        s = loop.slo_summary()
        assert s["failed"] == len(raw) and s["quarantined"] == 0


# ------------------------------------------------------------ arrival traces
class TestArrivalTraces:
    def test_poisson_seeded_and_monotonic(self):
        a = poisson_arrivals(256, 100.0, seed=7)
        b = poisson_arrivals(256, 100.0, seed=7)
        c = poisson_arrivals(256, 100.0, seed=8)
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        assert (np.diff(a) > 0).all()
        # mean inter-arrival ~ 1/rate (loose 3-sigma-ish bound)
        assert 1 / 100.0 * 0.7 < np.diff(a).mean() < 1 / 100.0 * 1.3

    def test_burst_arrivals_live_in_on_windows(self):
        on_s, off_s = 0.02, 0.08
        a = burst_arrivals(200, 1000.0, on_s=on_s, off_s=off_s, seed=3)
        assert (np.diff(a) > 0).all()
        phase = np.mod(a, on_s + off_s)
        assert (phase <= on_s + 1e-9).all(), "arrival outside ON window"
        assert np.array_equal(
            a, burst_arrivals(200, 1000.0, on_s=on_s, off_s=off_s, seed=3))

    def test_replay_arrivals(self):
        assert np.array_equal(replay_arrivals(4), np.zeros(4))
        r = replay_arrivals(4, 100.0)
        assert np.allclose(np.diff(r), 0.01)

    def test_make_arrivals_dispatch(self):
        assert len(make_arrivals("poisson", 8, rate_hz=50.0)) == 8
        assert len(make_arrivals("burst", 8, rate_hz=500.0)) == 8
        assert len(make_arrivals("replay", 8, rate_hz=50.0)) == 8
        with pytest.raises(ValueError, match="unknown arrival"):
            make_arrivals("fractal", 8, rate_hz=50.0)

    def test_run_trace_under_seeded_burst(self):
        """The CI serve job's scenario in miniature: a seeded bursty
        trace through a bounded loop — terminates, p99 finite, the
        counters account for every arrival."""
        profiles, d, raw = _workload(n_docs=24)
        arrivals = burst_arrivals(len(raw), 2000.0, on_s=0.01,
                                  off_s=0.02, seed=11)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=10, queue_cap=16, max_inflight=2)
        with loop:
            tickets = run_trace(loop, raw, arrivals)
        assert len(tickets) == len(raw)
        s = loop.slo_summary()
        assert s["admitted"] + s["shed"] == len(raw)
        assert s["completed"] == s["admitted"]
        assert np.isfinite(s["p99_ms"])

    def test_run_trace_length_mismatch_raises(self):
        profiles, d, raw = _workload(n_docs=4)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=10, queue_cap=8)
        with loop:
            with pytest.raises(ValueError, match="payloads"):
                run_trace(loop, raw, np.zeros(3))


# ------------------------------------------------- route_bytes_pipelined
@pytest.mark.parametrize("depth", [None, 1, 3])
def test_route_bytes_pipelined_unsharded_routes_as_route_bytes(depth):
    """An unsharded stage has no sharded plan to overlap on, so, as in
    the JAX package, the pipelined route is :meth:`route_bytes`: the
    same batches, the same routes, the same accounting."""
    profiles, d, raw = _workload(n_docs=10)
    stage = _stage(profiles, d)
    got = [[(r.doc_index, r.shard, tuple(r.matched_profiles)) for r in b]
           for b in stage.route_bytes_pipelined(iter(raw), depth=depth)]
    ref = _stage(profiles, d)
    want = [[(r.doc_index, r.shard, tuple(r.matched_profiles)) for r in b]
            for b in ref.route_bytes(raw)]
    assert got == want and len(got) == 3
    assert stage.stats["batches"] == ref.stats["batches"] == 3
    assert stage.stats["overlapped_batches"] == 0


# ------------------------------------------- parity with the JAX package
#: counters that depend only on the trace and the batching, not on timing
#: (all requests arrive back to back under a 60 s deadline and a queue that
#: holds them all, so every batch closes on size but the flushed last one)
DETERMINISTIC = ("admitted", "shed", "completed", "batches", "size_closes",
                 "deadline_closes", "flush_closes", "rejected",
                 "quarantined", "failed", "retries", "swaps",
                 "swap_rollbacks", "delivery_errors")


def _poison_trace(encode, dictionary, raw):
    """The healthy payloads with, in the middle, one malformed payload
    (an unclosed element), one nested past ``max_depth`` and one valid
    payload that the poisoner makes the device call raise on."""
    deep = (b"".join(dictionary.open_bytes(0)
                     for _ in range(DEFAULT_MAX_DEPTH + 1))
            + b"".join(dictionary.close_bytes(0)
                       for _ in range(DEFAULT_MAX_DEPTH + 1)))
    marked = raw[5] + dictionary.open_bytes(1) + dictionary.close_bytes(1)
    trace = (raw[:3] + [dictionary.open_bytes(0)] + raw[3:6] + [deep]
             + [marked] + raw[6:])
    return trace, marked


def _poison(stage, marked):
    """Make the stage's batch call raise on ``marked`` (an untyped error,
    so the loop must retry and bisect to find it)."""
    orig = stage._filter_bytebatch

    def filter_(bufs, record=True, epoch=None):
        if marked in bufs:
            raise RuntimeError("poisoned batch")
        return orig(bufs, record=record, epoch=epoch)

    stage._filter_bytebatch = filter_


def _serve(loop_cls, run, replay, stage, trace, marked, max_inflight):
    _poison(stage, marked)
    delivered = []
    loop = loop_cls(stage, max_batch=BATCH, deadline_ms=60_000,
                    queue_cap=len(trace), max_inflight=max_inflight,
                    deliver=lambda routed: delivered.append(
                        [(r.doc_index, r.shard,
                          tuple(int(x) for x in r.matched_profiles))
                         for r in routed]))
    with loop:
        tickets = run(loop, trace, replay(len(trace)))
    s = loop.slo_summary()
    return {"delivered": delivered,
            "dead_letter": [(r["seq"], r["error"], r["payload"])
                            for r in loop.dead_letter],
            "tickets": [(t.seq, t.shed, type(t.error).__name__)
                        for t in tickets],
            "counters": {k: s[k] for k in DETERMINISTIC}}


@pytest.mark.parametrize("max_inflight", [1, 3])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_loop_matches_jax_loop(sparse, max_inflight):
    """The same seeded payloads and arrival trace, poison included,
    through both packages' loops: identical delivery queues (batch by
    batch: doc seq, shard, matched gids), dead letters (seq, error type,
    payload), tickets and deterministic counters."""
    jdtd = JaxDTD.generate(n_tags=24, seed=3)
    jd = JaxDictionary()
    jdtd.register(jd)
    jraw = [jax_encode(x, text_fill=TEXT_FILL)
            for x in jax_corpus(jdtd, n_docs=14, nodes_per_doc=40, seed=4)]
    dtd = DTD.generate(n_tags=24, seed=3)
    d = TagDictionary()
    dtd.register(d)
    raw = [encode_bytes(x, text_fill=TEXT_FILL)
           for x in gen_corpus(dtd, n_docs=14, nodes_per_doc=40, seed=4)]
    assert raw == jraw
    trace, marked = _poison_trace(encode_bytes, d, raw)
    jtrace, jmarked = _poison_trace(jax_encode, jd, jraw)
    assert trace == jtrace
    jstage = JaxStage(jax_profiles(jdtd, n=N_QUERIES, length=3, seed=3), jd,
                      n_shards=2, engine=ENGINE, keep_unmatched=True,
                      batch_size=BATCH, sparse=sparse)
    want = _serve(JaxLoop, jax_run_trace, jax_replay, jstage, jtrace,
                  jmarked, max_inflight)
    got = _serve(ServeLoop, run_trace, replay_arrivals,
                 _stage(gen_profiles(dtd, n=N_QUERIES, length=3, seed=3), d,
                        sparse=sparse), trace, marked, max_inflight)
    assert sum(len(b) for b in want["delivered"]) > 0
    assert [e[1] for e in want["dead_letter"]] == [
        "MalformedDocument", "DepthOverflow", "KernelFault"]
    assert got == want


# ------------------------------------------------ hot swap under load
def test_hot_swap_with_batches_in_flight():
    """The card test's scenario on the CPU: a swap commits while two
    batches filtered under the old epoch are still undelivered; each
    request's verdicts match its epoch's live set."""
    assert swap_with_batches_in_flight("cpu") == [0, 0, 0, 1]


def test_sharded_hot_swap_with_batches_in_flight():
    """The same scenario on a query-sharded stage: the subscribe
    recompiles one part and restacks it in new tensors while batches of
    the old epoch are undelivered."""
    assert swap_with_batches_in_flight("cpu", query_shards=2) == [0, 0, 0, 1]


# ------------------------------------------------ the 2-D stage in the loop
def _jax_routes(n_docs, seed=0, **kw):
    """Routes of the JAX package's stage over the same seeded payloads."""
    dtd = JaxDTD.generate(n_tags=24, seed=seed)
    d = JaxDictionary()
    dtd.register(d)
    profiles = jax_profiles(dtd, n=N_QUERIES, length=3, seed=seed)
    raw = [jax_encode(x, text_fill=TEXT_FILL)
           for x in jax_corpus(dtd, n_docs=n_docs, nodes_per_doc=40, seed=1)]
    stage = JaxStage(profiles, d, n_shards=2, engine=ENGINE,
                     keep_unmatched=True, batch_size=BATCH, **kw)
    return _routes(stage.route_bytes(raw))


def _cpu_mesh(data, model):
    return FilterMesh([["cpu"] * model for _ in range(data)])


def test_parity_2d_mesh_stage():
    """The loop over a 2-D (data × model) stage on a 2 x 2 grid of the CPU
    device: the worker launches at every position, and delivers the
    unsharded synchronous route's verdicts, the JAX package's too."""
    profiles, d, raw = _workload(n_docs=8)
    loop = ServeLoop(_stage(profiles, d, query_shards=2, data_shards=2,
                            mesh=_cpu_mesh(2, 2)),
                     max_batch=BATCH, deadline_ms=60_000, queue_cap=64)
    with loop:
        tickets = [loop.submit(p) for p in raw]
    want = _routes(_stage(profiles, d).route_bytes(raw))
    assert _ticket_routes(tickets) == want == _jax_routes(8)


def test_2d_hot_swap_with_batches_in_flight():
    """The hot-swap scenario on a 2-D stage: the subscribe builds a new
    sharded plan, so batches of the old epoch keep their model slices
    and the new epoch's batches get new ones."""
    assert swap_with_batches_in_flight(
        "cpu", query_shards=2, data_shards=2,
        mesh=_cpu_mesh(2, 2)) == [0, 0, 0, 1]


def test_swap_queued_once_a_batch_runs_commits_behind_it():
    """A subscribe queued while a worker is already filtering a batch
    commits after that batch is delivered (a batch boundary).  The
    batcher's hand-off is stretched on purpose: the subscribe is made
    just after the batch's submit, before ``_dispatch`` could record the
    batch's place in the completion order; a swap that got in front of
    the batch would commit first.  (Under load the same window once let
    the swap commit unseen, and the 2-D hot-swap test waited for it.)"""
    profiles, d, raw = _workload(n_docs=4)
    st = _stage(profiles, d)
    running = threading.Event()
    filt = st._filter_bytebatch

    def filter_bytebatch(bufs, record=True, epoch=None):
        running.set()
        return filt(bufs, record=record, epoch=epoch)

    st._filter_bytebatch = filter_bytebatch
    order, tickets = [], []
    with ServeLoop(st, max_batch=BATCH, deadline_ms=60_000, queue_cap=64,
                   max_inflight=2) as loop:
        submit, resolve, commit = (loop._pool.submit, loop._resolve,
                                   loop._commit_swap)

        def stretched_submit(fn, *args):
            future = submit(fn, *args)
            assert running.wait(timeout=30)
            tickets.append(loop.subscribe(profiles[0]))
            deadline = time.monotonic() + 1.0   # the builder's chance
            while time.monotonic() < deadline and not any(
                    item is not None and item[0] == "swap"
                    for item in list(loop._completion)):
                time.sleep(0.005)
            return future

        loop._pool.submit = stretched_submit
        loop._resolve = lambda *a: (order.append("batch"), resolve(*a))[1]
        loop._commit_swap = lambda *a: (order.append("swap"), commit(*a))[1]
        reqs = [loop.submit(p) for p in raw]
        assert all(r.done.wait(timeout=30) for r in reqs)
        assert tickets and tickets[0].done.wait(timeout=30)
    assert tickets[0].error is None and order == ["batch", "swap"]
    assert [r.epoch for r in reqs] == [0] * len(raw)


class TestRouteBytesPipelinedKDeep:
    """The K-deep pipelined route on a data-sharded stage (a 2 x 1 grid of
    the CPU device): routes as ``route_bytes`` at any depth, stages each
    batch exactly once (where ``put_seconds`` accrues), and counts the
    batches staged while a predecessor was in flight."""

    def _stage2d(self, profiles, d, **kw):
        return _stage(profiles, d, data_shards=2, mesh=_cpu_mesh(2, 1), **kw)

    @pytest.mark.parametrize("depth", [1, 2, 3, 8])
    def test_depth_parity_and_single_staging(self, depth):
        profiles, d, raw = _workload(n_docs=12, seed=5)
        stage = self._stage2d(profiles, d)
        stages_in = []
        orig = stage._stage_in
        stage._stage_in = lambda bufs: (stages_in.append(len(bufs))
                                        or orig(bufs))
        got = _routes(stage.route_bytes_pipelined(iter(raw), depth=depth))
        want = _routes(self._stage2d(profiles, d).route_bytes(raw))
        assert got == want == _jax_routes(12, seed=5, data_shards=2)
        # 12 docs / batch 4 = 3 batches, each staged exactly once
        assert stages_in == [BATCH] * 3
        assert stage.stats["batches"] == 3
        # depth 1 is synchronous; deeper overlaps every batch after the
        # first
        assert stage.stats["overlapped_batches"] == (0 if depth == 1 else 2)

    def test_default_depth_is_double_buffer(self):
        profiles, d, raw = _workload(n_docs=12, seed=5)
        stage = self._stage2d(profiles, d)
        assert stage.pipeline_depth == 2
        got = _routes(stage.route_bytes_pipelined(raw))
        assert got == _routes(self._stage2d(profiles, d).route_bytes(raw))
        assert stage.stats["overlapped_batches"] == 2

    def test_pipeline_depth_field_threads_through(self):
        profiles, d, raw = _workload(n_docs=12, seed=5)
        stage = self._stage2d(profiles, d, pipeline_depth=3)
        got = _routes(stage.route_bytes_pipelined(raw))
        assert got == _routes(self._stage2d(profiles, d).route_bytes(raw))
