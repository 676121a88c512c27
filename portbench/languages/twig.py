"""Twig profiles: linear trunks with nested-path predicates
(``//a[b//c][//d]/e``), the paper's §5 extension.  The frozen generator
(``gen.twig``), the plain reference (``reference.twig``), its control
without the join, and the work count.

The work a document needs, counted from the inputs alone:

* Operations: for each open tag, the states of the shared-prefix
  automaton of all the twigs' root-to-leaf paths (the path count's rule,
  over the decomposed paths) whose tag test takes the tag; for each close
  tag, the (twig, branching node) pairs whose tag test takes it, a
  branching node being one with two or more steps below it, where a join
  decides whether they meet at one element; one per verdict: per
  (document, twig) when delivery is dense, per match when sparse.
* Bytes: as the path count: every payload byte read once, every verdict
  byte written once.
"""
from __future__ import annotations

import numpy as np

from .. import roofline
from ..gen import twig as twig_gen
from ..reference import twig as ref_twig
from ..reference import wire
from ..reference.automaton import Automaton


def profiles(children: dict[int, list[int]], names: list[str], spec: dict,
             rng: np.random.Generator) -> list[str]:
    return twig_gen.twigs(children, names, n=spec["count"],
                          length=spec["length"], p_desc=spec["p_desc"],
                          p_wild=spec["p_wild"],
                          branches=tuple(spec["branches"]),
                          branch_length=tuple(spec["branch_length"]),
                          rng=rng)


def paths(profile: str) -> list[str]:
    """The twig's root-to-leaf paths as linear profiles:
    ``//a[b]/c`` -> ``["//a/b", "//a/c"]``."""
    anchored, root = ref_twig.parse(profile)
    out: list[str] = []

    def walk(axis: int, node: ref_twig.Node, prefix: str) -> None:
        tag, below = node
        prefix += ("/" if axis == ref_twig.CHILD else "//") + tag
        if not below:
            out.append(prefix)
        for sub_axis, sub in below:
            walk(sub_axis, sub, prefix)

    walk(ref_twig.CHILD if anchored else ref_twig.DESC, root, "")
    return out


class Joinless:
    """The control: each twig decomposed into its root-to-leaf paths, the
    paths run through the linear reference, and a twig taken to match
    when all its paths match.  That is the paper's "straightforward
    solution" (§5) without its post-processing: every answer the
    reference gives, and more wherever a twig's paths match at places
    that no one embedding joins."""

    def __init__(self, profiles: list[str], tag_names: list[str]):
        per_twig = [paths(p) for p in profiles]
        distinct = sorted({x for ps in per_twig for x in ps})
        index = {x: i for i, x in enumerate(distinct)}
        self._automaton = Automaton(distinct, tag_names)
        self._owner = np.repeat(np.arange(len(per_twig)),
                                [len(ps) for ps in per_twig])
        self._path = np.array([index[x] for ps in per_twig for x in ps],
                              np.int64)
        self._need = np.bincount(self._owner, minlength=len(per_twig))

    def matches(self, payload: bytes) -> np.ndarray:
        hit = np.zeros(self._automaton.n_profiles, bool)
        hit[self._automaton.matches(payload)] = True
        got = np.bincount(self._owner, weights=hit[self._path],
                          minlength=self._need.size)
        return np.flatnonzero(got == self._need)


matcher = ref_twig.Twigs
control = Joinless


def _branching(node: ref_twig.Node, out: dict[str, int]) -> None:
    tag, below = node
    if len(below) >= 2:
        out[tag] = out.get(tag, 0) + 1
    for _, sub in below:
        _branching(sub, out)


def work_counter(profiles: list[str], tag_names: list[str]):
    """The work of one document, ``(payload, *, matches, dense) -> (ops,
    bytes)``, with the automaton states each tag can enter and the
    branching nodes each tag closes (``*`` ones included) counted once."""
    opens = roofline.states_per_tag([x for p in profiles for x in paths(p)],
                                    tag_names)
    per_test: dict[str, int] = {}
    for p in profiles:
        _branching(ref_twig.parse(p)[1], per_test)
    wild = per_test.get(ref_twig.WILD, 0)
    closes = np.array([per_test.get(n, 0) + wild for n in tag_names],
                      np.int64)

    def work(payload: bytes, *, matches: int, dense: bool) -> tuple[int, int]:
        ops, nbytes = roofline.document_work(payload, opens,
                                             n_profiles=len(profiles),
                                             matches=matches, dense=dense)
        is_open, tag = wire.decode(payload)
        return ops + int(closes[tag[~is_open]].sum()), nbytes
    return work
