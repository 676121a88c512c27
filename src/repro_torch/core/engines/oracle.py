# Copy of src/repro/core/engines/oracle.py (the port imports nothing of the JAX
# package), on the port's engine base; a host engine.
"""Ground-truth oracle: direct recursive XPath evaluation on the tree.

Completely independent of the NFA construction — it checks the XPath
semantics (axis chains with `/`, `//`, `*`) by dynamic programming over
each root-to-node path.  Used only by tests and tiny demos.
"""
from __future__ import annotations

import numpy as np

from ..dictionary import TagDictionary
from ..events import OPEN, EventBatch, EventStream
from ..nfa import NFA, WILD_TAG
from ..xpath import CHILD, Query, WILDCARD
from . import base
from .result import NO_MATCH, FilterResult


def _resolve_steps(q: Query, dictionary: TagDictionary) -> list[tuple[int, int]]:
    out = []
    for st in q.steps:
        tid = WILD_TAG if st.tag == WILDCARD else dictionary.tag_to_id.get(st.tag, -1)
        out.append((st.axis, tid))
    return out


def _path_matches(path: list[int], steps: list[tuple[int, int]]) -> bool:
    """steps match the full path with the last step at the last node."""
    k, d = len(steps), len(path)
    # g[i][j]: steps[:i] matches a chain ending exactly at path depth j
    g = [[False] * (d + 1) for _ in range(k + 1)]
    g[0][0] = True
    for i in range(1, k + 1):
        axis, tid = steps[i - 1]
        anyprev = [False] * (d + 1)  # anyprev[j] = OR of g[i-1][0..j-1]
        acc = False
        for j in range(d + 1):
            anyprev[j] = acc
            acc = acc or g[i - 1][j]
        for j in range(1, d + 1):
            if tid != WILD_TAG and path[j - 1] != tid:
                continue
            g[i][j] = g[i - 1][j - 1] if axis == CHILD else anyprev[j]
    return g[k][d]


def filter_document(nfa: NFA, ev: EventStream,
                    dictionary: TagDictionary) -> FilterResult:
    """Evaluate every profile against the document, recursively."""
    queries = [_resolve_steps(q, dictionary) for q in nfa.queries]
    return _filter_resolved(queries, ev)


def _filter_resolved(queries, ev: EventStream) -> FilterResult:
    """Same walk, with the name→id resolution already done."""
    matched = np.zeros(len(queries), dtype=bool)
    first = np.full(len(queries), NO_MATCH, dtype=np.int32)

    path: list[int] = []
    for i in range(len(ev)):
        k = int(ev.kind[i])
        if k == OPEN:
            path.append(int(ev.tag_id[i]))
            for qi, steps in enumerate(queries):
                if matched[qi]:
                    continue
                if _path_matches(path, steps):
                    matched[qi] = True
                    first[qi] = i
        elif k == 1:  # CLOSE
            if path:
                path.pop()
    return FilterResult(matched, first)


@base.register("oracle")
class OracleEngine(base.FilterEngine):
    """Registry adapter over the recursive ground truth.

    Needs the tag dictionary (queries carry tag *names*); "compilation"
    is just resolving names to ids once.  Host engine: documents are
    walked in Python, whatever the engine's device.
    """

    def __init__(self, nfa: NFA, dictionary: TagDictionary | None = None,
                 **options) -> None:
        if dictionary is None:
            raise ValueError("oracle engine needs the tag dictionary")
        super().__init__(nfa, dictionary, **options)
        self._steps = self.plan_.meta["steps"]

    def plan(self, nfa: NFA) -> base.FilterPlan:
        steps = tuple(tuple(_resolve_steps(q, self.dictionary))
                      for q in nfa.queries)
        return base.FilterPlan("oracle", tables={},
                               meta={"steps": steps,
                                     "n_queries": nfa.n_queries,
                                     "prep": "host"},
                               device=self.device)

    def filter_document(self, ev: EventStream) -> FilterResult:
        # resolution happened once, in plan()
        return _filter_resolved(self._steps, ev)

    def filter_batch_with_plan(self, plan: base.FilterPlan,
                               batch: EventBatch) -> FilterResult:
        steps = plan.meta["steps"]
        return FilterResult.stack(
            [_filter_resolved(steps, ev)
             for ev in batch.to_host().streams()])

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        return self.filter_batch_with_plan(self.plan_, batch)
