# Copy of src/repro/core/twig.py (the port imports nothing of the JAX package),
# with TwigFilter's device=: the port's engines run on the card unless "cpu".
"""Twig pattern filtering — the paper's §5 extension, implemented.

The paper closes with twig profiles as an open problem and sketches the
"straightforward solution": decompose the twig into root-to-leaf paths,
filter each path with the existing XPath architecture, and join the
results in post-processing, eliminating the two stated inefficiencies as
far as possible:

* false positives (paths matching in unrelated places) are removed by an
  exact structural verification pass, run only on the (few) documents
  whose every path matched;
* redundant common-section processing is avoided for free: all
  decomposed paths enter **one shared prefix-tree NFA** (§3.3), so the
  twig's trunk is evaluated once, by construction.

Syntax: linear steps as in :mod:`repro.core.xpath` plus branch
predicates in brackets — ``a[b//c][d]/e`` means: an ``a`` element with a
descendant chain ``b//c`` and a child... (branch axes are the branch's
leading axis), whose child ``e`` ends the output path.

Semantics: boolean filtering (does the document contain a match of the
whole twig?), same as the path engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .dictionary import TagDictionary
from .engines.result import NO_MATCH, FilterResult
from .events import EventStream, to_trees, Node
from .nfa import compile_queries
from .xpath import CHILD, DESC, Query, Step, WILDCARD, XPathSyntaxError


@dataclass(frozen=True)
class TwigNode:
    axis: int          # axis from the parent twig node
    tag: str
    branches: tuple["TwigNode", ...]   # predicate branches
    child: "TwigNode | None"           # continuation of the main path

    def all_children(self) -> tuple["TwigNode", ...]:
        return self.branches + ((self.child,) if self.child else ())


@dataclass(frozen=True)
class TwigQuery:
    root: TwigNode
    raw: str

    @property
    def is_linear(self) -> bool:
        n, linear = self.root, True
        while n is not None:
            if n.branches:
                return False
            n = n.child
        return True


# ------------------------------------------------------------------ parser
def parse_twig(s: str) -> TwigQuery:
    pos = 0
    text = s.strip()

    def parse_axis(default: int | None) -> int:
        nonlocal pos
        if text.startswith("//", pos):
            pos += 2
            return DESC
        if text.startswith("/", pos):
            pos += 1
            return CHILD
        if default is not None:
            return default
        raise XPathSyntaxError(f"expected axis at {pos} in {s!r}")

    def parse_name() -> str:
        nonlocal pos
        import re
        m = re.compile(r"[A-Za-z_][-A-Za-z0-9_.]*|\*").match(text, pos)
        if not m:
            raise XPathSyntaxError(f"expected tag at {pos} in {s!r}")
        pos = m.end()
        return m.group(0)

    def parse_node(default_axis: int | None) -> TwigNode:
        nonlocal pos
        axis = parse_axis(default_axis)
        tag = parse_name()
        branches = []
        while pos < len(text) and text[pos] == "[":
            pos += 1
            # bare branch head = child axis (XPath predicate semantics)
            branches.append(parse_node(default_axis=CHILD))
            if pos >= len(text) or text[pos] != "]":
                raise XPathSyntaxError(f"unclosed '[' in {s!r}")
            pos += 1
        child = None
        if pos < len(text) and text[pos] == "/":
            child = parse_node(default_axis=None)
        elif pos < len(text) and text[pos] not in "]":
            raise XPathSyntaxError(f"unexpected {text[pos]!r} at {pos}")
        return TwigNode(axis, tag, tuple(branches), child)

    root = parse_node(default_axis=DESC)
    if pos != len(text):
        raise XPathSyntaxError(f"trailing input at {pos} in {s!r}")
    return TwigQuery(root, s)


# ------------------------------------------------- path decomposition (§5)
def decompose(tq: TwigQuery) -> list[Query]:
    """Twig → root-to-leaf linear paths (the paper's decomposition)."""
    paths: list[list[Step]] = []

    def walk(node: TwigNode, prefix: list[Step]) -> None:
        prefix = prefix + [Step(node.axis, node.tag)]
        kids = node.all_children()
        if not kids:
            paths.append(prefix)
            return
        for k in kids:
            walk(k, prefix)

    walk(tq.root, [])
    return [Query(tuple(p), tq.raw) for p in paths]


# ----------------------------------------------------- exact verification
def _twig_matches_tree(roots: list[Node], tq: TwigQuery,
                       dictionary: TagDictionary) -> bool:
    """Ground-truth recursive twig matcher (the join/verify step)."""

    def tag_ok(node: Node, tag: str) -> bool:
        return tag == WILDCARD or dictionary.tag_to_id.get(tag, -1) == \
            node.tag_id

    def match_at(node: Node, tn: TwigNode) -> bool:
        """tn matches rooted exactly at `node` (tag already to check)."""
        if not tag_ok(node, tn.tag):
            return False
        for b in tn.all_children():
            if not any(match_from(c, b, node) for c in _candidates(node, b)):
                return False
        return True

    def _candidates(node: Node, b: TwigNode):
        if b.axis == CHILD:
            return node.children
        out = []

        def collect(n: Node):
            for c in n.children:
                out.append(c)
                collect(c)

        collect(node)
        return out

    def match_from(node: Node, tn: TwigNode, parent: Node) -> bool:
        return match_at(node, tn)

    def all_nodes():
        out = []

        def collect(n: Node):
            out.append(n)
            for c in n.children:
                collect(c)

        for r in roots:
            collect(r)
        return out

    r = tq.root
    if r.axis == CHILD:  # anchored at document root
        cands = roots
    else:
        cands = all_nodes()
    return any(match_at(c, r) for c in cands)


# ----------------------------------------------------------------- engine
class TwigFilter:
    """Two-stage twig filtering (paper §5 'straightforward solution').

    Stage 1 — all decomposed paths of all twigs share ONE prefix-tree NFA
    and run on any path engine (levelwise by default); a twig survives iff
    every one of its paths matched (necessary condition).
    Stage 2 — survivors are verified exactly on the document tree,
    eliminating the decomposition's false positives.

    ``stats`` records how much work stage 2 actually did — the measure of
    the false-positive rate the paper worries about.
    """

    def __init__(self, twigs: Sequence[str | TwigQuery],
                 dictionary: TagDictionary, engine: str = "levelwise", *,
                 device: str = "cuda"):
        self.twigs = [t if isinstance(t, TwigQuery) else parse_twig(t)
                      for t in twigs]
        self.dictionary = dictionary
        self.paths: list[Query] = []
        self.path_owner: list[int] = []
        for ti, tq in enumerate(self.twigs):
            for q in decompose(tq):
                self.paths.append(q)
                self.path_owner.append(ti)
        self.nfa = compile_queries(self.paths, dictionary, shared=True)
        from . import engines as engine_registry
        self._eng = engine_registry.create(engine, self.nfa,
                                           dictionary=dictionary,
                                           device=device)
        self.stats = {"stage2_checks": 0, "stage2_rejects": 0}

    def filter_document(self, ev: EventStream) -> FilterResult:
        path_res = self._eng.filter_document(ev)
        n_t = len(self.twigs)
        candidate = np.ones(n_t, dtype=bool)
        for pi, owner in enumerate(self.path_owner):
            candidate[owner] &= bool(path_res.matched[pi])
        matched = np.zeros(n_t, dtype=bool)
        roots = None
        for ti in np.nonzero(candidate)[0]:
            if self.twigs[ti].is_linear:
                matched[ti] = True       # single path ⇒ exact already
                continue
            if roots is None:
                roots = to_trees(ev)
            self.stats["stage2_checks"] += 1
            ok = _twig_matches_tree(roots, self.twigs[ti], self.dictionary)
            matched[ti] = ok
            if not ok:
                self.stats["stage2_rejects"] += 1
        first = np.full(n_t, NO_MATCH, np.int32)
        for pi, owner in enumerate(self.path_owner):
            if matched[owner]:
                first[owner] = min(first[owner], path_res.first_event[pi])
        return FilterResult(matched, first)
