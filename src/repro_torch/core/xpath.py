# Copy of src/repro/core/xpath.py (the port imports nothing of the JAX package).
"""XPath subset parser → Query IR.

The paper (§3) supports linear XPath profiles over two navigation axes:

  * parent-child        ``/``   (requires the stack + TOS-match hardware, Fig 4)
  * ancestor-descendant ``//``  (plain regular-expression hardware, Fig 3)

plus tag names and the ``*`` wildcard.  This module parses that subset into a
tiny immutable IR used by the NFA compiler (:mod:`repro.core.nfa`).

Grammar (no predicates, no attributes — same scope as the paper)::

    query  := axis? step (axis step)*
    axis   := '/' | '//'
    step   := NAME | '*'

Leading-axis convention: a leading ``/`` anchors the first step at the
document root (it must match a top-level element); a leading ``//`` (or a bare
leading tag, which PCRE's unanchored search semantics in the paper imply)
matches the first step at any depth.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Sequence

CHILD = 0   # parent-child axis  '/'
DESC = 1    # ancestor-descendant axis '//'

_NAME_RE = re.compile(r"[A-Za-z_][-A-Za-z0-9_.]*|\*")

AXIS_NAMES = {CHILD: "/", DESC: "//"}

WILDCARD = "*"


class XPathSyntaxError(ValueError):
    """Raised when a profile string is outside the supported subset."""


@dataclass(frozen=True)
class Step:
    """One location step: an axis and a tag test."""

    axis: int       # CHILD or DESC
    tag: str        # tag name, or '*' for the wildcard node test

    def __post_init__(self) -> None:
        if self.axis not in (CHILD, DESC):
            raise XPathSyntaxError(f"bad axis {self.axis!r}")
        if not _NAME_RE.fullmatch(self.tag):
            raise XPathSyntaxError(f"bad tag test {self.tag!r}")

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"{AXIS_NAMES[self.axis]}{self.tag}"


@dataclass(frozen=True)
class Query:
    """A parsed linear XPath profile."""

    steps: tuple[Step, ...]
    raw: str

    @property
    def length(self) -> int:
        return len(self.steps)

    @property
    def has_parent_child(self) -> bool:
        """True if any *non-leading* '/' axis is present.

        The paper groups profiles into "with parent-child axes" (need the
        on-chip stack) and "without" (pure regex) — §3.5, Fig 5.  A leading
        '/' only anchors at the root which the regex engine can express, so
        the grouping looks at steps after the first.
        """
        return any(s.axis == CHILD for s in self.steps[1:])

    @property
    def anchored(self) -> bool:
        """True if the profile starts with a root-anchored '/' step."""
        return self.steps[0].axis == CHILD

    def __str__(self) -> str:
        return "".join(str(s) for s in self.steps)


def parse(profile: str) -> Query:
    """Parse one XPath profile string into a :class:`Query`."""
    s = profile.strip()
    if not s:
        raise XPathSyntaxError("empty profile")
    pos = 0
    steps: list[Step] = []
    first = True
    while pos < len(s):
        if s.startswith("//", pos):
            axis, pos = DESC, pos + 2
        elif s.startswith("/", pos):
            axis, pos = CHILD, pos + 1
        elif first:
            # bare leading tag: PCRE unanchored search ⇒ descendant semantics
            axis = DESC
        else:
            raise XPathSyntaxError(f"expected axis at {pos} in {profile!r}")
        m = _NAME_RE.match(s, pos)
        if not m:
            raise XPathSyntaxError(f"expected tag test at {pos} in {profile!r}")
        steps.append(Step(axis, m.group(0)))
        pos = m.end()
        first = False
    return Query(tuple(steps), profile)


def parse_all(profiles: Iterable[str]) -> list[Query]:
    return [parse(p) for p in profiles]


def tags_of(queries: Sequence[Query]) -> list[str]:
    """All distinct concrete tag names referenced by the profiles (sorted)."""
    tags = {st.tag for q in queries for st in q.steps if st.tag != WILDCARD}
    return sorted(tags)
