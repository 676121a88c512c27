"""The plain twig reference: which twig profiles a document matches.

A twig is a linear XPath trunk with predicates, in the syntax of the
port's ``core/twig.py``: ``//a[b//c][//d]/e``.  A step is a tag name or
``*`` after ``/`` (child) or ``//`` (descendant); a bracket holds a
predicate, a chain of steps (itself allowed predicates) whose bare head
is a child step; a leading ``/`` anchors the first step at a top-level
element, a leading ``//`` or bare name lets it match at any depth.

A twig matches a document when some embedding maps every twig node to an
element: each tag test holds (``*`` takes any tag), a child step maps to
a child of its node's element and a descendant step to a descendant, and
an anchored root maps to a top-level element.  Predicates are
existential and independent, so two of them may map to one element.

The filter works bottom-up.  The twigs' distinct sub-twigs (a tag test
and a set of (axis, sub-twig) requirements) are hash-consed.  Each open
element keeps one boolean vector of the requirements met below it: a
child requirement where some child satisfies the sub-twig, a descendant
one where some proper descendant does.  When an element closes, the
sub-twigs satisfied there are those whose tag test takes its tag and
whose requirements are all met; they are tested for that tag alone.  Its
parent then gains them as child and descendant requirements, and gains
its descendant ones.  A twig matches where its root sub-twig is
satisfied: at any element, or at a top-level one where it is anchored.

Nothing here comes from the program under test: the parse, the filter
and the wire decoding (``reference.wire``) are the benchmark's own.
"""
from __future__ import annotations

import re

import numpy as np

from . import wire

CHILD, DESC = 0, 1
WILD = "*"
_NAME = re.compile(r"[A-Za-z_][-A-Za-z0-9_.]*|\*")

# a node is (tag test, ((axis, node), ...)): its predicates, then the
# trunk's next step
Node = tuple


def parse(profile: str) -> tuple[bool, Node]:
    """``/a[b]//c`` -> ``(True, ("a", ((CHILD, ("b", ())),
    (DESC, ("c", ())))))``: whether the root is anchored, and the root."""
    pos = 0

    def fail(what: str):
        return ValueError(f"not a twig profile ({what} at {pos}): "
                          f"{profile!r}")

    def step(default: int | None) -> tuple[int, Node]:
        nonlocal pos
        if profile.startswith("//", pos):
            axis, pos = DESC, pos + 2
        elif profile.startswith("/", pos):
            axis, pos = CHILD, pos + 1
        elif default is None:
            raise fail("expected an axis")
        else:
            axis = default
        m = _NAME.match(profile, pos)
        if m is None:
            raise fail("expected a tag test")
        pos = m.end()
        reqs = []
        while profile.startswith("[", pos):
            pos += 1
            reqs.append(step(CHILD))
            if not profile.startswith("]", pos):
                raise fail("expected ']'")
            pos += 1
        if profile.startswith("/", pos):
            reqs.append(step(None))
        return axis, (m.group(0), tuple(reqs))

    axis, root = step(DESC)
    if pos != len(profile):
        raise fail("trailing text")
    return axis == CHILD, root


class Twigs:
    """The filter of a twig set over one tag vocabulary (``tag_names[i]``
    is tag id ``i`` on the wire)."""

    def __init__(self, profiles: list[str], tag_names: list[str]):
        tag_id = {name: i for i, name in enumerate(tag_names)}
        key_id: dict[tuple, int] = {}
        tests: list[int] = []             # tag id, -2 for '*', -1 unknown
        reqs: list[tuple[tuple[int, int], ...]] = []

        def intern(node: Node) -> int:
            tag, below = node
            req = tuple(sorted({(axis, intern(sub)) for axis, sub in below}))
            key = (tag, req)
            if key not in key_id:
                key_id[key] = len(tests)
                tests.append(-2 if tag == WILD else tag_id.get(tag, -1))
                reqs.append(req)
            return key_id[key]

        roots, anchored = [], []
        for p in profiles:
            a, root = parse(p)
            anchored.append(a)
            roots.append(intern(root))
        self.n_profiles = len(profiles)
        self.n_subtwigs = n = len(tests)
        self._roots = np.array(roots, np.int64)
        self._anchored = np.array(anchored, bool)
        test = np.array(tests, np.int64)
        n_req = np.array([len(r) for r in reqs], np.int64)
        width = max(1, int(n_req.max()))
        # requirement (axis, s) is met at position axis * n + s of an
        # element's vector; position 2n is always met and pads short rows
        table = np.full((n, width), 2 * n, np.int64)
        for s, req in enumerate(reqs):
            for j, (axis, sub) in enumerate(req):
                table[s, j] = axis * n + sub
        self._width = 2 * n + 1
        n_tags = len(tag_names)
        self._leaves: list[np.ndarray] = []
        self._cand: list[np.ndarray] = []
        self._req: list[np.ndarray] = []
        for t in range(n_tags + 1):       # the last entry: '*'
            takes = test == (t if t < n_tags else -2)
            self._leaves.append(np.flatnonzero(takes & (n_req == 0)))
            cand = np.flatnonzero(takes & (n_req > 0))
            self._cand.append(cand)
            self._req.append(table[cand].T.copy())

    def _satisfied(self, tag: int, met: np.ndarray | None) -> np.ndarray:
        """Sub-twigs satisfied at a closing element of ``tag`` whose
        requirements met below it are ``met`` (``None``: no child)."""
        wild = len(self._leaves) - 1
        out = [self._leaves[tag], self._leaves[wild]]
        if met is not None:
            for t in (tag, wild):
                req = self._req[t]
                # the first requirement (a child one where there is one)
                # rules out most candidates; the rest test the survivors
                keep = np.flatnonzero(met[req[0]])
                for col in req[1:]:
                    keep = keep[met[col[keep]]]
                out.append(self._cand[t][keep])
        return np.concatenate(out)

    def matches(self, payload: bytes) -> np.ndarray:
        """Sorted indices of the twigs the document matches."""
        is_open, tags = wire.decode(payload)
        n = self.n_subtwigs
        anywhere = np.zeros(n, bool)
        top_level = np.zeros(n, bool)
        stack: list[np.ndarray | None] = []
        for opening, tag in zip(is_open.tolist(), tags.tolist()):
            if opening:
                stack.append(None)
                continue
            met = stack.pop()
            sat = self._satisfied(tag, met)
            anywhere[sat] = True
            if not stack:
                top_level[sat] = True
                continue
            up = stack[-1]
            if up is None:
                up = stack[-1] = np.zeros(self._width, bool)
                up[-1] = True
            up[sat] = True
            up[n + sat] = True
            if met is not None:
                up[n:2 * n] |= met[n:2 * n]
        hit = np.where(self._anchored, top_level[self._roots],
                       anywhere[self._roots])
        return np.flatnonzero(hit)
