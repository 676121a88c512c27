"""Paper-literal regex semantics as matrix-product scans, in torch.

Counterpart of ``src/repro/core/engines/matscan.py``.  §3.2 compiles
``a0//b0`` to a regex over the event alphabet with a *negation block* on
``</a0>``: progress made under an element is killed when that element
closes.  Each event is then a small 0/1 transition matrix per query and a
document is the ordered product of its event matrices.  The JAX package
evaluates the prefix products with ``jax.lax.associative_scan``; here a
log-depth scan written in torch (:func:`_prefix_products`) does: after
round r every position holds the product of the 2^r matrices ending at
it.  Entries are kept saturated at 1 after every product (the boolean
semiring), in float32, where sums of at most k+1 ones are exact.

Scope (the paper's regex-only group): profiles whose non-leading axes are
all ``//`` and with concrete tags; :class:`MatscanUnsupported` refuses the
rest.  The negation-block semantics is approximate on documents where a
tag occurs again inside itself (:func:`exact_class` says where it is
exact); the paper's hardware behaves the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dictionary import TagDictionary
from ..events import CLOSE, OPEN, EventBatch, EventStream
from ..nfa import NFA, compile_queries
from ..xpath import CHILD, Query
from . import base
from .result import NO_MATCH, FilterResult


class MatscanUnsupported(ValueError):
    pass


def _check_supported(q: Query) -> None:
    if any(st.axis == CHILD for st in q.steps[1:]):
        raise MatscanUnsupported(
            f"{q.raw!r}: parent-child axis needs the stack group (Fig 5 right)")
    if q.steps[0].axis == CHILD:
        raise MatscanUnsupported(f"{q.raw!r}: root-anchored profile")
    if any(st.tag == "*" for st in q.steps):
        raise MatscanUnsupported(f"{q.raw!r}: wildcard tag test")


def _matrices(step_tags: torch.Tensor, kind: torch.Tensor,
              tag: torch.Tensor) -> torch.Tensor:
    """(B, N) events → (B, N, Q, k+1, k+1) float32 0/1 transition matrices."""
    q, km = step_tags.shape
    dev = step_tags.device
    eye = torch.eye(km + 1, dtype=torch.float32, device=dev)
    idx = torch.arange(km, device=dev)
    # OPEN: I + advance i→i+1 where step i+1's tag equals the event tag
    adv = step_tags == tag[..., None, None]                   # (B, N, Q, km)
    open_m = torch.zeros(adv.shape[:-1] + (km + 1, km + 1),
                         dtype=torch.float32, device=dev)
    open_m[..., idx, idx + 1] = adv.to(torch.float32)
    open_m += eye
    # CLOSE </t>: negation block — progress at or beyond the first step
    # matching t collapses back to just before it; first step index j
    # (1-based) with tag t, km+1 if none
    jpos = torch.where(adv, idx + 1, km + 1).amin(-1)         # (B, N, Q)
    rows = torch.arange(km + 1, device=dev)
    # target[i] = i if i < j else j-1
    tgt = torch.where(rows < jpos[..., None], rows, jpos[..., None] - 1)
    close_m = torch.nn.functional.one_hot(tgt, km + 1).to(torch.float32)
    is_open = (kind == OPEN)[..., None, None, None]
    is_close = (kind == CLOSE)[..., None, None, None]
    return torch.where(is_open, open_m, torch.where(is_close, close_m, eye))


def _prefix_products(mats: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 over the saturated boolean
    semiring, in ⌈log2 N⌉ rounds: round r composes each position with the
    one 2^r before it (the earlier product on the left)."""
    n = mats.shape[1]
    step = 1
    while step < n:
        later = torch.clamp(torch.matmul(mats[:, :-step], mats[:, step:]),
                            max=1.0)
        mats = torch.cat([mats[:, :step], later], 1)
        step *= 2
    return mats


def _scan_batch(step_tags: torch.Tensor, accept_idx: torch.Tensor,
                kind: torch.Tensor, tag: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) batched scan → (B, Q) matched and first.  PAD events are
    identity matrices, so padded tails cannot create or destroy matches."""
    b, n = kind.shape
    prefix = _prefix_products(_matrices(step_tags, kind, tag))
    # v0 = e_0 ⇒ reached states = prefix[..., 0, :]
    reach = prefix[..., 0, :]                               # (B, N, Q, km+1)
    acc = torch.gather(reach, 3, accept_idx.long()[None, None, :, None]
                       .expand(b, n, -1, 1))[..., 0]       # (B, N, Q)
    hit = acc > 0
    pos = torch.arange(n, dtype=torch.int32, device=kind.device)
    first = torch.where(hit, pos[None, :, None],
                        torch.full_like(pos, NO_MATCH)[None, :, None])
    return hit.any(1), first.amin(1)


@base.register("matscan")
class MatscanEngine(base.FilterEngine):
    """Batched per-query (k+1)×(k+1) transition-matrix scans."""

    device_sharded = True

    def __init__(self, nfa: NFA | list[Query],
                 dictionary: TagDictionary | None = None, **options) -> None:
        if dictionary is None:
            raise ValueError("matscan engine needs the tag dictionary")
        if not isinstance(nfa, NFA):  # legacy: a raw list of queries
            nfa = compile_queries(list(nfa), dictionary, shared=True)
        for q in nfa.queries:
            _check_supported(q)
        super().__init__(nfa, dictionary, **options)

    def plan(self, nfa: NFA) -> base.FilterPlan:
        return self._build_plan(nfa, kmax=None, n_queries=None)

    def _build_plan(self, nfa: NFA, kmax: int | None,
                    n_queries: int | None) -> base.FilterPlan:
        """Plan with optional uniform pads (a sharded part's compile).

        Padding queries carry no matchable step (all ``-1``) and accept at
        index ``kmax``, unreachable without a step-``kmax`` tag match;
        padding step columns never advance or negate anything.
        """
        from ...convert import matscan_plan_from_numpy  # imports this package

        queries = list(nfa.queries)
        for q in queries:
            _check_supported(q)  # churn-added queries are checked here
        kmax = max([q.length for q in queries] + [kmax or 1])
        nq = max(n_queries or 0, len(queries))
        step_tags = np.full((nq, kmax), -1, np.int32)
        accept_idx = np.full(nq, kmax, np.int32)
        for qi, q in enumerate(queries):
            for i, st in enumerate(q.steps):
                step_tags[qi, i] = self.dictionary.add(st.tag)
            accept_idx[qi] = q.length  # accept index = its own length
        return matscan_plan_from_numpy(
            {"step_tags": step_tags, "accept_idx": accept_idx},
            {"kmax": kmax, "n_queries": nq,
             # the scan consumes the raw event stream
             "prep": "events-device"}, self.device)

    # ------------------------------------------------------- sharded hooks
    def part_pads(self, parts, *, query_bucket: int = 8):
        """Uniform (Q, kmax) table shape across parts (no state axis:
        matscan's states are per-query step indices); ``kmax`` is
        bucketed so a slightly longer new query does not re-pad all
        parts."""
        kmax = max((q.length for nfa in parts for q in nfa.queries),
                   default=1)
        nq = max((nfa.n_queries for nfa in parts), default=1)
        return {"kmax": base._round_up(kmax, 4),
                "n_queries": base._round_up(max(nq, 1), query_bucket)}

    def _plan_part_uncached(self, nfa: NFA, pads) -> base.FilterPlan:
        """A part's compile at the uniform ``(n_queries, kmax)`` pads;
        :meth:`plan_part` routes it through the plan cache."""
        if not pads:
            return self.plan(nfa)
        return self._build_plan(nfa, kmax=pads["kmax"],
                                n_queries=pads["n_queries"])

    def _plan_from_tables(self, tables, meta) -> base.FilterPlan:
        """A cached plan, rebuilt through :func:`repro_torch.convert.
        matscan_plan_from_numpy` (shapes, accept indices in [0, kmax])."""
        from ...convert import matscan_plan_from_numpy  # imports this package

        return matscan_plan_from_numpy(tables, meta, self.device)

    def _run_parts(self, sharded: base.ShardedPlan, prep: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every part in one scan: the stacked (P, Qpad, kmax) query
        tables fold into the query axis."""
        st = sharded.stacked()
        kind, tag = prep
        matched, first = _scan_batch(st["step_tags"].flatten(0, 1),
                                     st["accept_idx"].flatten(0, 1),
                                     kind, tag)
        b, p = matched.shape[0], sharded.n_parts
        return (matched.view(b, p, -1).permute(1, 0, 2),
                first.view(b, p, -1).permute(1, 0, 2))

    def _prep_host(self, batch: EventBatch) -> tuple:
        if batch.is_device:
            return batch.kind.to(torch.int32), batch.tag_id
        return batch.kind.astype(np.int32), batch.tag_id

    def _prep_arrays(self, kind, tag, depth, parent, valid, n_events
                     ) -> tuple:
        # the scan reads only (kind, tag)
        return kind.to(torch.int32), tag

    def _run_with_plan(self, plan: base.FilterPlan, prep: tuple):
        kind, tag = prep
        return _scan_batch(plan["step_tags"], plan["accept_idx"], kind, tag)

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        return self.filter_batch_with_plan(self.plan_, batch)


def exact_class(ev: EventStream) -> bool:
    """True iff no tag re-occurs inside an open element with the same tag —
    the document class where the paper's negation-block regex semantics is
    exact w.r.t. tree semantics."""
    stack: list[int] = []
    for k, t in zip(ev.kind, ev.tag_id):
        if k == OPEN:
            if int(t) in stack:
                return False
            stack.append(int(t))
        elif k == CLOSE and stack:
            stack.pop()
    return True
