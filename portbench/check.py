"""How ``correct`` is decided: every answer the window produced against
the reference's.

An answer is what one document's subscribers receive: for each
destination shard, the global ids of the matching profiles on it.  The
reference computes each distinct payload once (``expected``); each routed
document of the window is held against the entry of its payload.  Two
numbers are compared, each with the limit 0: answers that differ
(``mismatched``) and answers that never came or ended in an error
(``unanswered``).  The guarantee is exact delivery, so any difference
fails.  The reference and the control are the profile language's
(``languages/<kind>.py``).
"""
from __future__ import annotations

import numpy as np

from . import languages
from .reference.route import deliveries

LIMITS = {"mismatched": 0, "unanswered": 0}


def expected(inputs, n_shards: int, matcher=None
             ) -> tuple[list[dict[int, np.ndarray]], list[int]]:
    """The reference's answer and match count for every payload of the
    pool.  ``matcher`` stands in for the reference's own (the control)."""
    auto = matcher or languages.get(inputs.kind).matcher(inputs.profiles,
                                                         inputs.tag_names)
    answers, counts = [], []
    for p in inputs.payloads:
        m = auto.matches(p)
        answers.append(deliveries(m, n_shards))
        counts.append(len(m))
    return answers, counts


def answer_of(routed) -> dict[int, np.ndarray] | None:
    """One document's routed entries as shard -> sorted ids; ``None``
    when a shard appears twice (a double delivery)."""
    out: dict[int, np.ndarray] = {}
    for rd in routed:
        if rd.shard in out:
            return None
        out[rd.shard] = np.sort(np.asarray(rd.matched_profiles, np.int64))
    return out


def same(got: dict[int, np.ndarray] | None,
         want: dict[int, np.ndarray]) -> bool:
    return (got is not None and got.keys() == want.keys()
            and all(np.array_equal(got[s], want[s]) for s in want))


def verdict(mismatched: int, unanswered: int) -> tuple[bool, dict]:
    checks = {"mismatched": mismatched, "unanswered": unanswered}
    ok = all(checks[k] <= LIMITS[k] for k in LIMITS)
    return ok, {k: {"value": v, "limit": LIMITS[k]}
                for k, v in checks.items()}
