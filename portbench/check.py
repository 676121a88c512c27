"""How ``correct`` is decided: every answer the window produced against
the reference's.

An answer is what one document's subscribers receive: for each
destination shard, the global ids of the matching profiles on it.  The
reference computes each distinct payload once (``expected``); each routed
document of the window is held against the entry of its payload.  Two
numbers are compared, each with the limit 0: answers that differ
(``mismatched``) and answers that never came or ended in an error
(``unanswered``).  The guarantee is exact delivery, so any difference
fails.
"""
from __future__ import annotations

import numpy as np

from .reference.automaton import Automaton
from .reference.route import deliveries

LIMITS = {"mismatched": 0, "unanswered": 0}


def expected(inputs, n_shards: int, automaton=None
             ) -> tuple[list[dict[int, np.ndarray]], list[int]]:
    """The reference's answer and match count for every payload of the
    pool.  ``automaton`` stands in for the reference's own (the control)."""
    auto = automaton or Automaton(inputs.profiles, inputs.tag_names)
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


class StacklessAutomaton(Automaton):
    """The control: the reference with the parent-child guarantee
    broken.  Every ``/`` step is taken as ``//``, the filter a design
    without the paper's tag stack would give (§3.5): faster, and wrong
    wherever a profile needs a parent, not just an ancestor."""

    def __init__(self, profiles: list[str], tag_names: list[str]):
        super().__init__([_all_descendant(p) for p in profiles], tag_names)


def _all_descendant(profile: str) -> str:
    out = profile.replace("//", "/").replace("/", "//")
    return out if out.startswith("/") else "//" + out
