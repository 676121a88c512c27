"""Arrival processes for open-loop traffic, frozen copies of the port's
``serve/loop.py`` ``poisson_arrivals`` and ``burst_arrivals``.

Offsets are in seconds from the start of the trace.  An open loop sends
each request when it is due, whether or not the system keeps up, so a
request's latency is timed from its due time (see ``drivers.serve``).
"""
from __future__ import annotations

import numpy as np


def poisson(n: int, rate_hz: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival offsets of a Poisson process at ``rate_hz``."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def burst(n: int, rate_hz: float, rng: np.random.Generator, *,
          on_s: float, off_s: float) -> np.ndarray:
    """ON/OFF-modulated Poisson: ``rate_hz`` for ``on_s``, then silence
    for ``off_s``; the mean rate is ``rate_hz * on_s / (on_s + off_s)``."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    out: list[float] = []
    t = 0.0
    while len(out) < n:
        window_end = t + on_s
        while len(out) < n:
            t += rng.exponential(1.0 / rate_hz)
            if t >= window_end:
                break
            out.append(t)
        t = window_end + off_s
    return np.asarray(out[:n])


def offsets(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The offsets a traffic file's ``arrival`` block asks for."""
    if spec["process"] == "poisson":
        return poisson(n, spec["rate_hz"], rng)
    if spec["process"] == "burst":
        return burst(n, spec["rate_hz"], rng, on_s=spec["on_s"],
                     off_s=spec["off_s"])
    raise ValueError(f"unknown arrival process {spec['process']!r}")
