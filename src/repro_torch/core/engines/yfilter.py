# Copy of src/repro/core/engines/yfilter.py (the port imports nothing of the
# JAX package), on the port's engine base; a host engine.
"""YFilter-style software baseline (the paper's §4 comparison system).

Event-driven NFA execution on the CPU, the way YFilter [11] does it: a
runtime stack of active-state sets, advanced per SAX event.  Pure python
and intentionally "von Neumann" — this is the baseline the FPGA (and our
device engines) are measured against in the Fig-9 reproduction.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..events import CLOSE, OPEN, EventBatch, EventStream
from ..nfa import NFA, WILD_TAG
from . import base
from .result import NO_MATCH, FilterResult


def _adjacency(nfa: NFA):
    """NFA tables → adjacency-list execution form (host-side 'plan')."""
    t = nfa.tables
    by_src_tag: dict[int, dict[int, list[int]]] = defaultdict(dict)
    by_src_wild: dict[int, list[int]] = defaultdict(list)
    for s in range(1, t.in_state.shape[0]):
        u = int(t.in_state[s])
        tag = int(t.in_tag[s])
        if tag == WILD_TAG:
            by_src_wild[u].append(s)
        elif tag >= 0:
            by_src_tag[u].setdefault(tag, []).append(s)
    accept_of_state: dict[int, list[int]] = defaultdict(list)
    for q, s in enumerate(t.accept_state.tolist()):
        accept_of_state[s].append(q)
    return dict(
        by_src_tag=dict(by_src_tag),
        by_src_wild=dict(by_src_wild),
        selfloop=frozenset(np.nonzero(t.selfloop)[0].tolist()),
        init=frozenset(np.nonzero(t.init)[0].tolist()),
        accept_of_state=dict(accept_of_state),
    )


@base.register("yfilter")
class YFilterEngine(base.FilterEngine):
    """Precompiled adjacency-list execution of the shared NFA.

    Host engine: documents are walked in Python, whatever the engine's
    device; the software baseline doubles as a second equivalence oracle.
    """

    def plan(self, nfa: NFA) -> base.FilterPlan:
        # host tables, not device tensors
        return base.FilterPlan("yfilter", tables=_adjacency(nfa),
                               meta={"n_queries": nfa.n_queries,
                                     "prep": "host"},
                               device=self.device)

    # ------------------------------------------------------------------ run
    def filter_document(self, ev: EventStream) -> FilterResult:
        return self._run_document(self.plan_, ev)

    def _run_document(self, p: base.FilterPlan,
                      ev: EventStream) -> FilterResult:
        n_q = p.meta["n_queries"]
        matched = np.zeros(n_q, dtype=bool)
        first = np.full(n_q, NO_MATCH, dtype=np.int32)
        stack: list[frozenset[int]] = [p["init"]]
        kinds = ev.kind
        tags = ev.tag_id
        by_tag = p["by_src_tag"]
        by_wild = p["by_src_wild"]
        loops = p["selfloop"]
        accepts = p["accept_of_state"]
        for i in range(len(ev)):
            k = kinds[i]
            if k == OPEN:
                tag = int(tags[i])
                cur = stack[-1]
                nxt = set()
                for u in cur:
                    d = by_tag.get(u)
                    if d is not None:
                        nxt.update(d.get(tag, ()))
                    w = by_wild.get(u)
                    if w is not None:
                        nxt.update(w)
                    if u in loops:
                        nxt.add(u)
                for s in nxt:
                    qs = accepts.get(s)
                    if qs:
                        for q in qs:
                            if not matched[q]:
                                matched[q] = True
                                first[q] = i
                stack.append(frozenset(nxt))
            elif k == CLOSE:
                if len(stack) > 1:
                    stack.pop()
        return FilterResult(matched, first)

    def filter_batch_with_plan(self, plan: base.FilterPlan,
                               batch: EventBatch) -> FilterResult:
        return FilterResult.stack(
            [self._run_document(plan, ev)
             for ev in batch.to_host().streams()])

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        return self.filter_batch_with_plan(self.plan_, batch)
