"""The card's idle time by the program's own spans (``repro_torch.tracing``).

In a traced run the program records its spans while the harness's
profiler runs, on the clock the device trace is mapped onto.  Each idle
instant of the window (no kernel, copy or memset in
``record["device"]["busy"]``) goes to the deepest program span open at
that instant, on any thread; a span's depth is the length of its parent
chain.  The readers take their numbers from :func:`summary`.

A program without the recorder, a window in which the card ran nothing
(a run on the CPU has no card to be idle), a window with no
``stage.request`` span, or a buffer that dropped spans gives ``None``,
and so every reader does.
"""
from __future__ import annotations

import numpy as np

from portbench.trace import _split, covered, merge

#: the root span of one stage batch
REQUEST = "stage.request"
#: the spans each idle metric adds up
GROUPS = {
    "pack": ("stage.pack", "engine.prep"),
    "h2d": ("engine.h2d",),
    "verdict": ("engine.launch", "engine.readback", "engine.scatter"),
    "fan_out": ("stage.fan_out",),
}


def summary(record) -> dict | None:
    """``idle_ns`` (idle nanoseconds by span name, ``None`` for no span),
    ``idle_total_ns`` and ``requests`` (the window's ``stage.request``
    spans), computed once a record."""
    if "program_spans" not in record:
        record["program_spans"] = _summary(record)
    return record["program_spans"]


def _summary(record) -> dict | None:
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    device = record.get("device")
    if device is None or not len(device["busy"]) or tracing.dropped():
        return None
    t0, t1 = record["t_open"], record["t_close"]
    every = tracing.spans()
    inside = [s for s in every if s.end_ns > t0 and s.start_ns < t1]
    requests = [s for s in inside
                if s.name == REQUEST and s.start_ns >= t0 and s.end_ns <= t1]
    if not requests:
        return None
    return {"idle_ns": idle_by_span(inside, every, device["busy"], t0, t1),
            "idle_total_ns": int((t1 - t0) - covered(device["busy"], t0, t1)),
            "requests": requests}


def idle_by_span(inside, every, busy: np.ndarray, t0: int, t1: int
                 ) -> dict:
    """Idle nanoseconds of ``[t0, t1]`` by the deepest span of ``inside``
    open then (spans carry ``name``, ``id``, ``parent``, ``start_ns``,
    ``end_ns``; ``every`` resolves the parent chains); the rest under
    ``None``.  ``busy`` is the device's merged busy intervals."""
    parent = {s.id: s.parent for s in every}
    depth: dict[int, int] = {}

    def depth_of(sid: int) -> int:
        chain = []
        while sid in parent and sid not in depth:
            chain.append(sid)
            sid = parent[sid]
        d = depth.get(sid, -1)
        for c in reversed(chain):
            d += 1
            depth[c] = d
        return depth[chain[0]] if chain else d

    groups: dict[tuple[int, str], list] = {}
    for s in inside:
        groups.setdefault((depth_of(s.id), s.name), []).append(
            (max(s.start_ns, t0), min(s.end_ns, t1)))
    busy = np.asarray(busy, np.int64).reshape(-1, 2)
    left = np.stack([np.concatenate(([t0], busy[:, 1])),
                     np.concatenate((busy[:, 0], [t1]))], axis=1)
    left = [tuple(g) for g in left[left[:, 1] > left[:, 0]].tolist()]
    out: dict = {}
    for key in sorted(groups, key=lambda k: (-k[0], k[1])):
        name = key[1]
        iv = np.asarray(groups[key], np.int64)
        taken, left = _split(left, merge(iv[:, 0], iv[:, 1]).tolist())
        if taken:
            out[name] = out.get(name, 0) + taken
    rest = sum(b - a for a, b in left)
    if rest:
        out[None] = rest
    return out


def idle_ms(record, group: str) -> float | None:
    """Idle milliseconds a request under the spans of ``GROUPS[group]``."""
    s = summary(record)
    if s is None:
        return None
    ns = sum(s["idle_ns"].get(n, 0) for n in GROUPS[group])
    return ns / len(s["requests"]) / 1e6


def unattributed_pct(record) -> float | None:
    """Share of the window's idle time under none of ``GROUPS``'s spans
    (a ``stage.request`` alone, other spans, or no span), in percent."""
    s = summary(record)
    if s is None or s["idle_total_ns"] <= 0:
        return None
    named = sum(s["idle_ns"].get(n, 0)
                for names in GROUPS.values() for n in names)
    return 100.0 * (s["idle_total_ns"] - named) / s["idle_total_ns"]


def per_request(record, counter: str) -> float | None:
    """Mean of the counter ``counter`` over the window's requests."""
    s = summary(record)
    if s is None:
        return None
    return float(np.mean([r.attrs.get(counter, 0) for r in s["requests"]]))
