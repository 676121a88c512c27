"""The plain reference filter: which profiles a document matches.

Profiles are linear XPath over ``/`` (child), ``//`` (descendant), tag
names and ``*``; a leading ``/`` anchors the first step at a top-level
element, a leading ``//`` (or bare name) lets it match at any depth.  A
profile matches a document when some element ends a match of its last
step.

The filter is the Shift-And (bitap) automaton over root-to-element
paths.  Bit ``j * P + p`` of an element's state says "steps 0..j of
profile p match a path ending here" (``M``, the element's own matches),
or, in ``V``, that the same holds here or, where step ``j + 1`` is a
descendant step, at any ancestor.  A child's matches are its parent's
``V`` shifted one step (``<< P``) plus the first steps, masked by the
steps whose tag test takes the child's tag.  Python integers hold the
bit vectors.  Elements with the same root-to-element path have the same
state, so each distinct path is computed once (a trie keyed by parent
and tag).

Nothing here comes from the program under test: the parse, the
automaton and the wire decoding (``reference.wire``) are the
benchmark's own.
"""
from __future__ import annotations

import re

import numpy as np

from . import wire

CHILD, DESC = 0, 1
WILD = "*"
_STEP = re.compile(r"(//|/)?([A-Za-z_][-A-Za-z0-9_.]*|\*)")
# a trie of distinct paths holds two bit vectors a node; start a new one
# past this many nodes so that the reference's memory stays bounded
_TRIE_LIMIT = 20_000


def parse(profile: str) -> list[tuple[int, str]]:
    """``//a/b`` -> ``[(DESC, "a"), (CHILD, "b")]``."""
    steps, pos = [], 0
    while pos < len(profile):
        m = _STEP.match(profile, pos)
        if m is None or (m.group(1) is None and steps):
            raise ValueError(f"not a linear XPath profile: {profile!r}")
        axis = CHILD if m.group(1) == "/" else DESC
        steps.append((axis, m.group(2)))
        pos = m.end()
    if not steps:
        raise ValueError("empty profile")
    return steps


def _bits(mask: np.ndarray) -> int:
    """A flat boolean array as a Python integer, element i at bit i."""
    return int.from_bytes(np.packbits(mask, bitorder="little").tobytes(),
                          "little")


class Automaton:
    """The bit-parallel automaton of a profile set over one tag
    vocabulary (``tag_names[i]`` is tag id ``i`` on the wire)."""

    def __init__(self, profiles: list[str], tag_names: list[str]):
        parsed = [parse(p) for p in profiles]
        self.n_profiles = n = len(parsed)
        depth = max(len(s) for s in parsed)
        tag_id = {name: i for i, name in enumerate(tag_names)}
        # per (step, profile): tag id, -2 for '*', -1 past the profile
        step_tag = np.full((depth, n), -1, np.int64)
        step_axis = np.full((depth, n), -1, np.int64)
        for p, steps in enumerate(parsed):
            for j, (axis, name) in enumerate(steps):
                step_axis[j, p] = axis
                step_tag[j, p] = -2 if name == WILD else tag_id.get(name, -3)
        length = np.array([len(s) for s in parsed])
        self._wild = _bits((step_tag == -2).ravel())
        self._tag = [_bits((step_tag == t).ravel()) | self._wild
                     for t in range(len(tag_names))]
        first = np.zeros((depth, n), bool)
        first[0] = step_axis[0] == DESC
        self._start = _bits(first.ravel())
        first[0] = step_axis[0] == CHILD
        self._start_root = _bits(first.ravel())
        keep = np.zeros((depth, n), bool)
        keep[:-1] = step_axis[1:] == DESC
        self._keep = _bits(keep.ravel())
        final = np.zeros((depth, n), bool)
        final[length - 1, np.arange(n)] = True
        self._final = _bits(final.ravel())
        self._reset()

    def _reset(self) -> None:
        self._child: dict[tuple[int, int], int] = {}
        self._m = [0]
        self._v = [0]

    def _node(self, parent: int, tag: int, top_level: bool) -> int:
        v_par = self._v[parent]
        start = self._start | (self._start_root if top_level else 0)
        m = ((v_par << self.n_profiles) | start) & self._tag[tag]
        node = len(self._m)
        self._m.append(m)
        self._v.append(m | (v_par & self._keep))
        self._child[(parent, tag)] = node
        return node

    def matches(self, payload: bytes) -> np.ndarray:
        """Sorted indices of the profiles the document matches."""
        if len(self._m) > _TRIE_LIMIT:
            self._reset()
        is_open, tags = wire.decode(payload)
        child = self._child
        stack = [0]
        seen = set()
        for opening, tag in zip(is_open.tolist(), tags.tolist()):
            if opening:
                parent = stack[-1]
                node = child.get((parent, tag))
                if node is None:
                    node = self._node(parent, tag, parent == 0)
                seen.add(node)
                stack.append(node)
            else:
                stack.pop()
        acc = 0
        m = self._m
        for node in seen:
            acc |= m[node]
        acc &= self._final
        nbytes = (acc.bit_length() + 7) // 8
        bits = np.unpackbits(np.frombuffer(acc.to_bytes(nbytes, "little"),
                                           np.uint8), bitorder="little")
        return np.sort(np.flatnonzero(bits) % self.n_profiles)


def prefix_states(profiles: list[str]) -> dict[str, int]:
    """The shared-prefix automaton's states (YFilter's NFA): one state a
    distinct (parent state, axis, tag test), the start state 0 left out.
    Returns how many states carry each tag test (``"*"`` included)."""
    state: dict[tuple[int, int, str], int] = {}
    per_test: dict[str, int] = {}
    for p in profiles:
        parent = 0
        for axis, name in parse(p):
            key = (parent, axis, name)
            if key not in state:
                state[key] = len(state) + 1
                per_test[name] = per_test.get(name, 0) + 1
            parent = state[key]
    return per_test
