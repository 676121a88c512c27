"""The harness's own tracing: host spans, and the device's timeline from
``torch.profiler``.

Spans are ``(name, start_ns, end_ns)`` on ``time.perf_counter_ns``, kept
in memory.  The request-level spans (``stage.route_bytes``,
``loop.submit``) are the harness's calls into the program.  In a traced
run (``--trace 1``) the harness also wraps a few of the program's
methods from outside (``INSTRUMENTED``) to split a request into its
parts; an untraced run wraps nothing, so the end-to-end numbers carry no
tracing cost.

The profiler records CPU and CUDA activity over the window.  Its device
events (kernels, copies, memsets) are mapped onto the span clock by a
marker taken when the profiler starts.
"""
from __future__ import annotations

import functools
import importlib
import threading
import time
from contextlib import contextmanager

import numpy as np

#: (module, class or None for a module function, name, span name, depth);
#: deeper spans are nearer the device and win when an idle gap is labelled
INSTRUMENTED = (
    ("repro_torch.serve.loop", "ServeLoop", "_run_batch", "loop.batch", 0),
    ("repro_torch.serve.loop", "ServeLoop", "_resolve", "loop.resolve", 0),
    ("repro_torch.serve.loop", None, "validate_payload", "loop.validate", 1),
    ("repro_torch.data.filter_stage", "FilterStage", "_filter_bytebatch",
     "stage.filter", 1),
    ("repro_torch.data.filter_stage", "FilterStage", "_fan_out",
     "stage.fan_out", 1),
    ("repro_torch.core.events", "ByteBatch", "from_buffers", "stage.pack",
     2),
    ("repro_torch.core.engines.streaming", "StreamingEngine",
     "filter_bytes", "engine.filter_bytes", 2),
    ("repro_torch.core.engines.streaming", "StreamingEngine",
     "filter_bytes_sparse", "engine.filter_bytes_sparse", 2),
    ("repro_torch.core.engines.base", "FilterEngine", "to_device",
     "engine.to_device", 3),
)
#: depth of the harness's own request-level spans
REQUEST_SPANS = {"stage.route_bytes": 0, "loop.submit": 0}


class Spans:
    """Host spans of every thread, appended under a lock."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()
        self._undo: list = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def instrument(self) -> None:
        """Wrap ``INSTRUMENTED``'s functions so that each call is a span;
        one the program no longer has is skipped."""
        for module, cls_name, attr, name, _ in INSTRUMENTED:
            owner = importlib.import_module(module)
            if cls_name is not None:
                cls = getattr(owner, cls_name, None)
                owner = next((k for k in getattr(cls, "__mro__", ())
                              if attr in vars(k)), None)
            raw = vars(owner).get(attr) if owner is not None else None
            if raw is None:
                continue
            func = raw.__func__ if isinstance(raw, classmethod) else raw

            def wrapper(*args, __func=func, __name=name, **kwargs):
                with self.span(__name):
                    return __func(*args, **kwargs)

            new = functools.wraps(func)(wrapper)
            setattr(owner, attr,
                    classmethod(new) if isinstance(raw, classmethod) else new)
            self._undo.append((owner, attr, raw))

    def uninstrument(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()

    def named(self, name: str, t0: int, t1: int) -> list[tuple[int, int]]:
        """``(start, end)`` of the spans of ``name`` that lie in
        ``[t0, t1]``."""
        return [(a, b) for n, a, b in self.items
                if n == name and a >= t0 and b <= t1]


def span_depths() -> dict[str, int]:
    out = dict(REQUEST_SPANS)
    out.update({name: depth for *_, name, depth in INSTRUMENTED})
    return out


class DeviceTrace:
    """``torch.profiler`` over the window, reduced to the device's
    intervals on the span clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def __enter__(self):
        import torch

        self._prof.__enter__()
        self._mark_ns = time.perf_counter_ns()
        with torch.profiler.record_function("portbench.mark"):
            pass
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    def device_events(self) -> tuple[list[str], np.ndarray, np.ndarray]:
        """Names, starts and ends (span clock, ns) of every device event."""
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        offset = None
        names, starts, ends = [], [], []
        for e in events:
            if offset is None and e.name() == "portbench.mark":
                offset = e.start_ns() - self._mark_ns
            if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
        if offset is None:
            raise RuntimeError("the profiler lost the harness's marker")
        return (names, np.asarray(starts, np.int64) - offset,
                np.asarray(ends, np.int64) - offset)


def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Union of intervals, as an ``(n, 2)`` array sorted by start."""
    if starts.size == 0:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate(([True], s[1:] > reach[:-1]))
    idx = np.flatnonzero(new)
    return np.stack([s[idx], np.maximum.reduceat(e, idx)], axis=1)


def covered(busy: np.ndarray, t0, t1):
    """Nanoseconds of ``[t0, t1]`` that the merged intervals ``busy``
    cover; ``t0`` and ``t1`` may be arrays of the same shape."""
    t0, t1 = np.asarray(t0, np.int64), np.asarray(t1, np.int64)
    if busy.size == 0:
        return np.zeros(np.broadcast(t0, t1).shape, np.int64)
    s, e = busy[:, 0], busy[:, 1]
    before = np.concatenate(([0], np.cumsum(e - s)))

    def upto(t):
        k = np.searchsorted(s, t, side="right")
        last = np.maximum(k - 1, 0)
        part = np.where(k > 0, np.clip(t - s[last], 0, e[last] - s[last]), 0)
        return before[last] + part

    return np.maximum(upto(t1) - upto(t0), 0)


def summarize(trace: DeviceTrace, spans: Spans, t0: int, t1: int) -> dict:
    """The record's ``device`` part: the device's busy intervals in the
    window ``[t0, t1]``, time a kernel name, and the idle time by the
    host span it fell in (``_label_gaps``)."""
    names, starts, ends = trace.device_events()
    inside = (ends > t0) & (starts < t1)
    names = [n for n, k in zip(names, inside) if k]
    starts = np.clip(starts[inside], t0, t1)
    ends = np.clip(ends[inside], t0, t1)
    busy = merge(starts, ends)
    per_name: dict[str, float] = {}
    for n, a, b in zip(names, starts.tolist(), ends.tolist()):
        per_name[n] = per_name.get(n, 0.0) + (b - a) / 1e9
    gaps = np.stack([np.concatenate(([t0], busy[:, 1])),
                     np.concatenate((busy[:, 0], [t1]))], axis=1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    return {"busy": busy,
            "busy_s": sum(int(b - a) for a, b in busy) / 1e9,
            "window_s": (t1 - t0) / 1e9, "kernels": per_name,
            "idle_by_span": _label_gaps(gaps, spans)}


def _label_gaps(gaps: np.ndarray, spans: Spans) -> dict[str, float]:
    """Idle seconds by host span: each instant of a gap goes to the
    deepest span open at that instant (on any thread), the rest to "no
    span"."""
    depth = span_depths()
    by_name: dict[str, list] = {}
    for n, a, b in spans.items:
        by_name.setdefault(n, []).append((a, b))
    left = [tuple(g) for g in gaps.tolist()]
    out: dict[str, float] = {}
    for n in sorted(by_name, key=lambda n: (-depth.get(n, 0), n)):
        iv = np.asarray(by_name[n], np.int64)
        taken, left = _split(left, merge(iv[:, 0], iv[:, 1]).tolist())
        if taken:
            out[n] = taken / 1e9
    rest = sum(b - a for a, b in left)
    if rest:
        out["no span"] = rest / 1e9
    return out


def _split(left: list, cover: list) -> tuple[int, list]:
    """Nanoseconds of the disjoint sorted intervals ``left`` that the
    disjoint sorted intervals ``cover`` overlap, and what is left."""
    taken, rest, j = 0, [], 0
    for a, b in left:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(cover) and cover[k][0] < b:
            c0, c1 = max(cover[k][0], cur), min(cover[k][1], b)
            if c0 > cur:
                rest.append((cur, c0))
            if c1 > c0:
                taken += c1 - c0
                cur = c1
            k += 1
        if cur < b:
            rest.append((cur, b))
    return taken, rest


def short_name(kernel: str) -> str:
    """A device event's name; a kernel's without its argument list,
    return type and ``(anonymous namespace)::`` qualifiers."""
    name = kernel.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[len("void "):].split("(")[0].strip()
    return name or "(unnamed device event)"


def breakdown(device: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: device time by kernel or copy
    name (``short_name``), and idle time by the host span it fell in."""
    ops: dict[str, float] = {}
    for n, s in device["kernels"].items():
        short = short_name(n)
        ops[short] = ops.get(short, 0.0) + s
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in rank(ops)],
            "idle_gaps": [[n, s] for n, s in rank(device["idle_by_span"])]}
