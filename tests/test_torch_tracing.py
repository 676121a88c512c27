"""The port's spans and counters (:mod:`repro_torch.tracing`) on the CPU.

Nothing is recorded without a profiler.  Under ``torch.profiler`` every
``route_bytes`` batch is one ``stage.request`` root with the routing
path's spans below it and its counters on it; the serve loop links the
batcher's ``loop.dispatch`` to the worker's ``stage.request`` across
threads; the buffer drops its oldest spans past its bound; and the spans'
clock is the one the profiler's events map onto through a marker.
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import ByteBatch, encode_bytes
from repro_torch.data.filter_stage import TEXT_FILL, FilterStage
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.kernels.launches import count_launch
from repro_torch.serve import ServeLoop

#: the children of one dense ``stage.request`` on the streaming engine,
#: in the order they close (``engine.h2d`` twice: the bytes, the starts)
DENSE_CHILDREN = ["stage.pack", "engine.prep", "engine.h2d", "engine.h2d",
                  "engine.launch", "engine.readback", "engine.scatter",
                  "stage.fan_out"]


def _workload(n_docs=8, seed=0):
    dtd = DTD.generate(n_tags=14, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=16, length=3, p_desc=0.5, p_wild=0.1, seed=seed)
    raw = [encode_bytes(x, text_fill=TEXT_FILL)
           for x in gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=20, seed=1)]
    return qs, d, raw


def _stage(qs, d, **kw):
    kw.setdefault("batch_size", 2)
    return FilterStage(qs, d, n_shards=2, device="cpu", **kw)


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    qs, d, raw = _workload(n_docs=4)
    stage = _stage(qs, d, batch_size=1)
    assert not tracing.recording()
    for i in range(50):
        list(stage.route_bytes([raw[i % len(raw)]]))
    assert tracing.spans() == [] and tracing.dropped() == 0
    # the off path hands out one shared context manager and counts nothing
    assert tracing.span("a") is tracing.span("b", root=True)
    with tracing.span("a") as sp:
        tracing.count("launches")
    assert sp is None and tracing.spans() == []


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_each_request_is_one_root_with_its_children(sparse):
    qs, d, raw = _workload(n_docs=6)
    stage = _stage(qs, d, sparse=sparse)
    with _cpu_profile():
        routed = [list(stage.route_bytes(raw[i:i + 2]))
                  for i in range(0, 6, 2)]
    assert all(len(r) == 1 for r in routed)
    spans = tracing.spans()
    roots = [s for s in spans if s.name == "stage.request"]
    assert len(roots) == 3
    assert [s.parent for s in roots] == [None] * 3
    children = ([n for n in DENSE_CHILDREN if n != "engine.h2d"]
                + ["engine.h2d"] * (3 if sparse else 2))
    for k, root in enumerate(roots):
        assert root.request == root.id
        mine = [s for s in spans if s.request == root.id and s is not root]
        assert all(s.parent == root.id for s in mine)
        assert sorted(s.name for s in mine) == sorted(children)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in mine)
        bufs = raw[2 * k:2 * k + 2]
        bb = ByteBatch.from_buffers(bufs, bucket=stage.byte_bucket)
        # the payloads' packed bytes, the (B, 2) int32 document starts and,
        # sparse, the (B, 1) int32 document map
        want_h2d = bb.data.nbytes + 2 * 2 * 4 + (2 * 4 if sparse else 0)
        assert root.attrs["h2d_bytes"] == want_h2d
        assert root.attrs["readbacks"] == 2
        assert root.attrs["d2h_bytes"] > 0
        # the CPU runs the kernels' plain versions: no launch is counted
        assert "launches" not in root.attrs


def test_launches_count_on_the_open_request():
    class Wrapper:
        launches = 0

    with _cpu_profile():
        with tracing.span("stage.request", root=True):
            with tracing.span("engine.launch"):
                count_launch(Wrapper)
                count_launch(Wrapper)
        count_launch(Wrapper)                 # no request open: not counted
    (root,) = [s for s in tracing.spans() if s.name == "stage.request"]
    assert root.attrs == {"launches": 2} and Wrapper.launches == 3


def test_the_bound_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_RECORDER", tracing._Recorder(capacity=5))
    with _cpu_profile():
        for i in range(8):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == [f"s{i}" for i in range(3, 8)]
    assert tracing.dropped() == 3
    first = tracing.spans()[0]
    assert tracing.spans(first.end_ns + 1, None)[0].name == "s4"
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("validate", [False, True])
def test_serve_loop_links_batch_and_request_across_threads(validate):
    qs, d, raw = _workload(n_docs=8)
    stage = _stage(qs, d, batch_size=4)
    with _cpu_profile():
        with ServeLoop(stage, max_batch=4, deadline_ms=60_000, queue_cap=64,
                       max_inflight=2, validate=validate) as loop:
            tickets = [loop.submit(p) for p in raw]
            assert all(t.done.wait(timeout=120) for t in tickets)
    assert all(t.routed is not None for t in tickets)
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    batches = [s for s in spans if s.name == "loop.dispatch"]
    requests = [s for s in spans if s.name == "stage.request"]
    resolves = [s for s in spans if s.name == "loop.resolve"]
    assert len(batches) == len(requests) == len(resolves) == 2
    seqs = sorted(q for b in batches for q in b.attrs["seqs"])
    assert seqs == list(range(8))
    assert {b.attrs["close"] for b in batches} == {"size"}
    for b in batches:
        (req,) = [r for r in requests if r.parent == b.id]
        (res,) = [r for r in resolves if r.parent == b.id]
        assert req.thread != b.thread and res.thread != b.thread
        assert req.request == res.request == b.request == b.id
        assert len(b.attrs["seqs"]) == 4 and b.end_ns <= res.start_ns
        assert req.attrs["readbacks"] == 2 and req.attrs["d2h_bytes"] > 0
        below = {s.name for s in spans
                 if by_id.get(s.parent) is req}
        assert {"stage.pack", "engine.launch", "engine.readback"} <= below
        assert [s.name for s in spans if s.parent == res.id] \
            == ["stage.fan_out"]
    validates = [s for s in spans if s.name == "loop.validate"]
    assert len(validates) == (8 if validate else 0)
    for t in tickets:
        assert t.t_submit <= t.t_dispatch <= t.t_verdict
    waits = loop.slo_summary()["queue_wait_ms"]
    assert 0.0 <= waits["p50"] <= waits["p99"]


def test_queue_wait_is_reported_without_a_profiler():
    qs, d, raw = _workload(n_docs=4)
    with ServeLoop(_stage(qs, d, batch_size=4), max_batch=4,
                   deadline_ms=60_000, max_inflight=1) as loop:
        tickets = [loop.submit(p) for p in raw]
    assert tracing.spans() == []
    assert all(t.t_submit <= t.t_dispatch <= t.t_verdict for t in tickets)
    s = loop.slo_summary()
    assert set(s["queue_wait_ms"]) == {"p50", "p99"}
    assert s["queue_wait_ms"]["p99"] <= s["p99_ms"]


def test_spans_start_where_the_profiler_maps_them():
    """A marker offset (a ``record_function`` marker beside a
    ``perf_counter_ns`` reading) maps each span's profiler event to within
    100 us of its start.  The marker follows one ``record_function`` of
    the session: the session's first is stamped tens of microseconds to
    milliseconds late, and the benchmark's ``DeviceTrace`` takes that one
    (``portbench/test_portbench_program_spans.py`` holds its marker to
    the same test)."""
    from torch.autograd import DeviceType

    qs, d, raw = _workload(n_docs=4)
    stage = _stage(qs, d)
    with _cpu_profile() as prof:
        with torch.profiler.record_function("test.warm"):
            pass
        mark_ns = time.perf_counter_ns()
        with torch.profiler.record_function("test.mark"):
            pass
        for i in range(0, 4, 2):
            list(stage.route_bytes(raw[i:i + 2]))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    (mark,) = [e for e in events if e.name() == "test.mark"]
    offset = mark.start_ns() - mark_ns
    spans = tracing.spans()
    assert len(spans) == 2 * (len(DENSE_CHILDREN) + 1)
    for name in {s.name for s in spans}:
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(e.start_ns() - offset for e in events
                        if e.name() == name)
        assert len(theirs) == len(mine), name
        gap = np.abs(np.asarray(theirs) - np.asarray(mine))
        assert gap.max() < 100_000, (name, gap.max())
