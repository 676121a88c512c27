"""The per-layer readers of the program's own spans
(``portbench/program_spans.py``) on synthetic spans and busy intervals,
the harness's outside wrappers against the program's names, and the
harness's marker against the program's spans."""
import importlib
import sys

import numpy as np
import pytest
import torch

from portbench import program_spans, spec, trace
from repro_torch import tracing

READERS = ("pack_idle_ms", "h2d_idle_ms", "verdict_idle_ms",
           "fan_out_idle_ms", "idle_unattributed_pct",
           "wrapper_calls_per_request", "readbacks_per_request",
           "h2d_mb_per_request", "d2h_kb_per_request")


def _span(name, sid, parent, start, end, thread=1, **attrs):
    return tracing.Span(name, sid, parent, None, thread, start, end,
                        dict(attrs))


def _two_requests():
    """Two requests of 100 ns in a window [0, 220]: each packs, stages,
    launches, reads back and fans out; a serve-loop span on another
    thread overlaps the second."""
    out, sid = [], 0
    for k, t in enumerate((0, 110)):
        root = sid = sid + 1
        out.append(_span("stage.request", root, None, t, t + 100,
                         launches=1, readbacks=2, h2d_bytes=16_000_000,
                         d2h_bytes=320_000 + 1_000 * k))
        for name, a, b in (("stage.pack", 5, 20), ("engine.prep", 20, 25),
                           ("engine.h2d", 25, 35), ("engine.launch", 35, 40),
                           ("engine.readback", 40, 80),
                           ("engine.scatter", 80, 85),
                           ("stage.fan_out", 85, 98)):
            sid += 1
            out.append(_span(name, sid, root, t + a, t + b))
    # a deeper span on another thread wins where it is open
    out.append(_span("loop.batch", 90, None, 150, 200, thread=2))
    out.append(_span("loop.validate", 91, 90, 150, 160, thread=2))
    out.append(_span("loop.slot_wait", 92, 91, 152, 154, thread=2))
    return out


#: the card is busy while each request's kernel runs (50..78 after its
#: start) and briefly before the first request
BUSY = np.array([[0, 2], [50, 78], [160, 188]], np.int64)


def _record(busy=BUSY):
    return {"t_open": 0, "t_close": 220,
            "device": {"busy": busy, "busy_s": 0.0, "window_s": 0.0}}


@pytest.fixture
def program(monkeypatch):
    """The program's recorder holding ``_two_requests()``."""
    spans = _two_requests()
    monkeypatch.setattr(tracing, "spans", lambda *a: list(spans))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    return spans


def test_idle_shares_add_up_to_the_total(program):
    s = program_spans.summary(_record())
    total = 220 - int(trace.covered(BUSY, 0, 220))
    assert s["idle_total_ns"] == total
    assert sum(s["idle_ns"].values()) == total
    assert len(s["requests"]) == 2


def _by_instant(spans, busy, t0, t1):
    """The plain labelling: every idle nanosecond to the open span of
    greatest depth (then first name), one instant at a time."""
    by_id = {s.id: s for s in spans}

    def depth(s):
        return 0 if s.parent not in by_id else 1 + depth(by_id[s.parent])

    out = {}
    for t in range(t0, t1):
        if any(a <= t < b for a, b in busy):
            continue
        open_ = [s for s in spans if s.start_ns <= t < s.end_ns]
        best = min(open_, key=lambda s: (-depth(s), s.name), default=None)
        key = None if best is None else best.name
        out[key] = out.get(key, 0) + 1
    return out


def test_the_deepest_span_wins_on_any_thread(program):
    idle = program_spans.summary(_record())["idle_ns"]
    assert idle == _by_instant(program, BUSY.tolist(), 0, 220)
    # the slot wait (depth 2, thread 2) takes the second request's
    # readback time (depth 1) while it is open; the validate span, at the
    # readback's depth, loses to it by name
    assert idle["loop.slot_wait"] == 2 and "loop.validate" not in idle
    assert idle["engine.readback"] == 10 + 2 + 8 + 2


def test_readers_split_the_idle_time_of_a_request(program):
    rec = _record()
    got = {name: spec.reader(name)(rec) for name in READERS}
    want = _by_instant(program, BUSY.tolist(), 0, 220)
    for name, group in program_spans.GROUPS.items():
        ns = sum(want.get(n, 0) for n in group)
        assert got[f"{name}_idle_ms"] == pytest.approx(ns / 2 / 1e6)
    assert got["wrapper_calls_per_request"] == 1.0
    assert got["readbacks_per_request"] == 2.0
    assert got["h2d_mb_per_request"] == pytest.approx(16.0)
    assert got["d2h_kb_per_request"] == pytest.approx(320.5)
    total = program_spans.summary(rec)["idle_total_ns"]
    named = sum(got[n] for n in READERS[:4]) * 2 * 1e6
    assert named + got["idle_unattributed_pct"] / 100 * total \
        == pytest.approx(total)


def test_no_reading_without_the_recorder(program, monkeypatch):
    """A program that has no ``repro_torch.tracing`` (the parent of the
    change that brought it) gives no reading, and raises nothing."""
    import repro_torch

    assert spec.reader(READERS[0])(_record()) is not None
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for name in READERS:
        assert spec.reader(name)(_record()) is None


def test_no_reading_when_spans_were_dropped(program, monkeypatch):
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    assert all(spec.reader(n)(_record()) is None for n in READERS)


def test_no_reading_without_a_card_or_a_request(program, monkeypatch):
    assert program_spans.summary(_record(np.zeros((0, 2), np.int64))) \
        is None
    monkeypatch.setattr(tracing, "spans", lambda *a: [])
    assert all(spec.reader(n)(_record()) is None for n in READERS)


@pytest.mark.parametrize("entry", trace.INSTRUMENTED,
                         ids=[e[3] for e in trace.INSTRUMENTED])
def test_every_outside_wrapper_still_finds_its_function(entry):
    """``Spans.instrument`` skips a name the program no longer has without
    a word; the ledger's ``idle_gaps`` labels rest on these nine."""
    module, cls_name, attr, *_ = entry
    owner = importlib.import_module(module)
    if cls_name is not None:
        owner = getattr(owner, cls_name)
    assert callable(getattr(owner, attr))


@pytest.mark.xfail(reason=(
    "DeviceTrace (portbench/trace.py) takes the profiler session's first "
    "record_function as its marker, which the profiler stamps late: "
    "90-350 us on a CPU, 0.61-0.64 ms on an H100's host, so the device "
    "timeline maps that much early onto the span clock (PERF.md, open "
    "questions); the fix is the harness's"), strict=False)
def test_the_harness_marker_maps_program_spans_to_their_start():
    """The offset that ``DeviceTrace.device_events`` takes from its
    ``portbench.mark`` event maps each program span's profiler event to
    within 100 us of the span's start on the span clock."""
    tracing.clear()
    tracer = trace.DeviceTrace()
    with tracer:
        for _ in range(20):
            with tracing.span("stage.request", root=True):
                with tracing.span("engine.h2d"):
                    torch.ones(1_000).sum()
    events = tracer._prof.profiler.kineto_results.events()
    (mark,) = [e for e in events if e.name() == "portbench.mark"]
    offset = mark.start_ns() - tracer._mark_ns
    spans = tracing.spans()
    tracing.clear()
    for name in ("stage.request", "engine.h2d"):
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(e.start_ns() - offset for e in events
                        if e.name() == name)
        assert len(mine) == len(theirs) == 20, name
        gap = np.abs(np.asarray(theirs) - np.asarray(mine))
        assert gap.max() < 100_000, (name, gap.max())
