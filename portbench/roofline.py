"""The work a filtering request needs, counted from its inputs, and the
H100's published peaks.

Nothing here reads the program: the counts come from the profile
strings and the wire payloads alone, so a change to the program's plan
layout, block size or kernel leaves them as they are.

* Operations of a document: for each open tag, the states of the
  shared-prefix automaton of the profiles (YFilter's NFA, one state a
  distinct (parent, axis, tag test)) whose tag test takes the tag: the
  states that tag can enter.  Then the verdicts: one operation a
  (document, profile) verdict when delivery is dense, one a match when it
  is sparse.
* Bytes of a document: every payload byte read once, every verdict byte
  written once: one byte a (document, profile) verdict when dense, 8 a
  match (document and profile id, 4 bytes each) when sparse.
* A request's least time is the larger of its operations over the
  integer rate and its bytes over the memory bandwidth.
"""
from __future__ import annotations

import numpy as np

from .reference import automaton, wire

#: NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, and the float32 rate
#: outside the tensor cores, which stands for integer and bitwise
#: operations (the data sheet gives no int32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def states_per_tag(profiles: list[str], tag_names: list[str]) -> np.ndarray:
    """(T,) states each tag id can enter: those testing its name, plus
    every ``*`` state."""
    per_test = automaton.prefix_states(profiles)
    wild = per_test.get(automaton.WILD, 0)
    return np.array([per_test.get(n, 0) + wild for n in tag_names],
                    np.int64)


def document_work(payload: bytes, per_tag: np.ndarray, *, n_profiles: int,
                  matches: int, dense: bool) -> tuple[int, int]:
    """(operations, bytes) one document needs."""
    is_open, tag = wire.decode(payload)
    ops = int(per_tag[tag[is_open]].sum())
    if dense:
        return ops + n_profiles, len(payload) + n_profiles
    return ops + matches, len(payload) + 8 * matches


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def share_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The least time over the time taken, in percent (``None`` when
    nothing was timed or no work was done)."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * least_seconds(ops, nbytes) / seconds
