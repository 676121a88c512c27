# Copy of src/repro/core/nfa.py (the port imports nothing of the JAX package).
"""Query IR → NFA with single-parent trie structure (§3.2–3.3 of the paper).

The paper implements each XPath profile as a chain of hardware blocks
(Fig 3/4): per-tag matchers, "waiting" blocks (``[<\\c\\d>]*``) for the
ancestor-descendant axis, and a shared document stack for parent-child
checks.  YFilter's software equivalent is an NFA whose states form a
prefix-shared trie.

This module compiles parsed :class:`repro.core.xpath.Query` objects into a
*vector-friendly* NFA representation designed so that the whole active-set
transition is three dense vector ops (gather, compare, mask) — the TPU
analogue of the FPGA advancing every matcher block in one clock:

    active_v[s] = (A[in_state[s]] & tagmatch[s](t))  |  (selfloop[s] & A[s])

where ``A`` is the active set in the *parent context* (the paper's
top-of-stack) and ``t`` is the tag of the node being opened.

State kinds
-----------
* ``root`` (state 0) — active only in the document-root context.
* ``match`` (M) — one per location step; its in-edge carries the step's
  tag test.  The paper's per-tag comparator block.
* ``loop`` (L) — one per ancestor-descendant step; copies the in-edge of
  the step's *source* state and self-loops, which realises the ε-closure
  of YFilter's ``//`` construction without ε-edges:

      active[L] = (A[in(src)] & match(src-edge)) | A[L]
                =  active[src] | A[L]

  i.e. L switches on exactly when src does and stays on for the whole
  subtree — the paper's ``[<\\c\\d>]*`` waiting block, with the negation
  block on ``</src>`` realised *exactly* (not approximately) because the
  parent-context stack restores A on close.

Parent-child steps need no extra state: the in-edge from the parent's M
state only fires when that M is in the parent context — the TOS-match of
Fig 4 is implicit in the stack discipline.

Sharing (§3.3): :func:`compile_queries` with ``shared=True`` dedups states
by ``(source, axis, tag)`` so common prefixes are single blocks (Com-P
scenario); ``shared=False`` builds disjoint chains per query (Unop).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np

from .dictionary import TagDictionary
from .xpath import CHILD, DESC, Query, WILDCARD

# sentinel tag ids used in in_tag
WILD_TAG = -2   # matches every tag (the '*' node test)
NEVER_TAG = -3  # matches no tag (root, init-only loop states)

K_ROOT, K_MATCH, K_LOOP = 0, 1, 2


class NFATables(NamedTuple):
    """Dense vector form of the NFA — everything the engines need."""

    in_state: np.ndarray      # (S,) int32 — single parent state
    in_tag: np.ndarray        # (S,) int32 — tag id, WILD_TAG or NEVER_TAG
    selfloop: np.ndarray      # (S,) bool  — ancestor-descendant waiting states
    init: np.ndarray          # (S,) bool  — active in the root context
    accept_state: np.ndarray  # (Q,) int32 — accept state per query
    kind: np.ndarray          # (S,) int8  — K_ROOT / K_MATCH / K_LOOP

    @property
    def n_states(self) -> int:
        return int(self.in_state.shape[0])

    @property
    def n_queries(self) -> int:
        return int(self.accept_state.shape[0])


@dataclass
class NFA:
    tables: NFATables
    queries: tuple[Query, ...]
    shared: bool
    n_tags: int  # size of the tag-id space (dictionary size)

    @property
    def n_states(self) -> int:
        return self.tables.n_states

    @property
    def n_queries(self) -> int:
        return self.tables.n_queries

    # ------------------------------------------------------- dense matrices
    def req_matrix(self, dtype=np.float32) -> np.ndarray:
        """(T, S) 0/1 matrix: REQ[t, s] = 1 iff in_tag[s] == t.

        ``onehot(tag) @ REQ`` is the per-state tag-match vector — the MXU
        form of the paper's character pre-decoder (§3.4): the one-hot
        decode happens once per symbol and every matcher consumes 1 bit.
        """
        t = self.tables
        req = np.zeros((self.n_tags, t.in_state.shape[0]), dtype=dtype)
        concrete = t.in_tag >= 0
        req[t.in_tag[concrete], np.nonzero(concrete)[0]] = 1
        return req

    def wild_vector(self, dtype=np.float32) -> np.ndarray:
        """(S,) 0/1: states whose in-edge matches any tag."""
        return (self.tables.in_tag == WILD_TAG).astype(dtype)

    def parent_onehot(self, dtype=np.float32) -> np.ndarray:
        """(S, S) 0/1 matrix P with P[in_state[s], s] = 1.

        ``A @ P`` gathers each state's parent activity — the MXU form of
        the wire from the previous matcher block on the FPGA.
        """
        t = self.tables
        s = t.in_state.shape[0]
        p = np.zeros((s, s), dtype=dtype)
        p[t.in_state, np.arange(s)] = 1
        return p

    def accept_matrix(self, dtype=np.float32) -> np.ndarray:
        """(S, Q) 0/1: ACC[s, q] = 1 iff s is query q's accept state."""
        t = self.tables
        acc = np.zeros((self.n_states, self.n_queries), dtype=dtype)
        acc[t.accept_state, np.arange(self.n_queries)] = 1
        return acc

    # ------------------------------------------------ reference transition
    def initial_active(self) -> np.ndarray:
        return self.tables.init.copy()

    def step_active(self, parent_active: np.ndarray, tag: int) -> np.ndarray:
        """One OPEN-tag transition (numpy reference used by tests/engines)."""
        t = self.tables
        tagmatch = (t.in_tag == tag) | (t.in_tag == WILD_TAG)
        src = parent_active[t.in_state]
        return (src & tagmatch) | (t.selfloop & parent_active)


class _Builder:
    def __init__(self) -> None:
        self.in_state: list[int] = [0]
        self.in_tag: list[int] = [NEVER_TAG]
        self.selfloop: list[bool] = [False]
        self.init: list[bool] = [True]
        self.kind: list[int] = [K_ROOT]
        self._memo: dict[tuple, int] = {}

    def _new(self, in_state: int, in_tag: int, selfloop: bool, init: bool,
             kind: int) -> int:
        sid = len(self.in_state)
        self.in_state.append(in_state)
        self.in_tag.append(in_tag)
        self.selfloop.append(selfloop)
        self.init.append(init)
        self.kind.append(kind)
        return sid

    def step(self, cur: int, axis: int, tag_id: int, shared: bool) -> int:
        """Extend the trie from state ``cur`` with one location step."""
        if axis == CHILD:
            key = (cur, CHILD, tag_id)
            if shared and key in self._memo:
                return self._memo[key]
            m = self._new(cur, tag_id, False, False, K_MATCH)
            if shared:
                self._memo[key] = m
            return m
        # DESC: waiting/loop state L + match state M
        lkey = (cur, "loop")
        if shared and lkey in self._memo:
            loop = self._memo[lkey]
        else:
            # L copies cur's in-edge → switches on exactly when cur does,
            # self-loop keeps it on for the whole subtree of cur.
            loop = self._new(self.in_state[cur], self.in_tag[cur],
                             True, self.init[cur], K_LOOP)
            # if cur itself self-loops (never happens for M/root sources,
            # defensive), preserve reachability
            if shared:
                self._memo[lkey] = loop
        mkey = (loop, DESC, tag_id)
        if shared and mkey in self._memo:
            return self._memo[mkey]
        m = self._new(loop, tag_id, False, False, K_MATCH)
        if shared:
            self._memo[mkey] = m
        return m


def compile_queries(
    queries: Sequence[Query],
    dictionary: TagDictionary,
    *,
    shared: bool = True,
) -> NFA:
    """Compile parsed profiles to the vector NFA.

    Tag names in the queries are resolved through ``dictionary`` (adding
    them if absent — profiles are known ahead of time in pub-sub, §1).
    ``shared=True`` is the paper's common-prefix optimization (§3.3).
    """
    b = _Builder()
    accepts: list[int] = []
    for q in queries:
        cur = 0
        for st in q.steps:
            tag_id = WILD_TAG if st.tag == WILDCARD else dictionary.add(st.tag)
            cur = b.step(cur, st.axis, tag_id, shared)
        accepts.append(cur)
    tables = NFATables(
        in_state=np.asarray(b.in_state, dtype=np.int32),
        in_tag=np.asarray(b.in_tag, dtype=np.int32),
        selfloop=np.asarray(b.selfloop, dtype=bool),
        init=np.asarray(b.init, dtype=bool),
        accept_state=np.asarray(accepts, dtype=np.int32),
        kind=np.asarray(b.kind, dtype=np.int8),
    )
    return NFA(tables=tables, queries=tuple(queries), shared=shared,
               n_tags=max(len(dictionary), 1))


def pad_states(nfa: NFA, multiple: int = 128, *, to: int | None = None) -> NFA:
    """Pad the state space to a lane-aligned multiple (TPU tiling).

    ``multiple`` comes from the engine's plan metadata
    (:attr:`repro.core.engines.base.FilterEngine.state_multiple`): the
    streaming engine packs 32-state words, the MXU engines want 128-lane
    tiles, host engines need no padding at all.  ``to`` pads to an exact
    state count instead (used by sharded plans, where every partition
    must share one padded state space so per-part tables stack along a
    leading axis).

    Padding states are inert: parent = self? No — parent 0 with NEVER tag
    and no selfloop, never active.
    """
    t = nfa.tables
    s = t.in_state.shape[0]
    if to is not None:
        if to < s:
            raise ValueError(f"cannot pad {s} states into {to}")
        padded = to - s
    else:
        padded = -s % multiple
    if padded == 0:
        return nfa
    tables = NFATables(
        in_state=np.concatenate([t.in_state, np.zeros(padded, np.int32)]),
        in_tag=np.concatenate([t.in_tag, np.full(padded, NEVER_TAG, np.int32)]),
        selfloop=np.concatenate([t.selfloop, np.zeros(padded, bool)]),
        init=np.concatenate([t.init, np.zeros(padded, bool)]),
        accept_state=t.accept_state,
        kind=np.concatenate([t.kind, np.full(padded, K_MATCH, np.int8)]),
    )
    return NFA(tables=tables, queries=nfa.queries, shared=nfa.shared,
               n_tags=nfa.n_tags)


# ---------------------------------------------------------------- minimization
class MinimizeStats(NamedTuple):
    """What :func:`minimize` achieved, for bench/telemetry columns."""

    states_before: int      # states in the input automaton
    states_after: int       # states after global merging
    accept_classes: int     # distinct accept states (≤ n_queries)
    unshared_states: int    # Unop upper bound: disjoint chains per profile

    @property
    def compression(self) -> float:
        """State compression vs the paper's Unop (per-profile blocks)
        baseline — the §3.3 Com-P-vs-Unop area ratio, measured."""
        return self.unshared_states / max(self.states_after, 1)


def unshared_state_count(queries: Sequence[Query]) -> int:
    """States of the Unop layout (disjoint chain per profile) + root."""
    return 1 + sum(_query_weight(q) for q in queries)


def minimize(nfa: NFA) -> tuple[NFA, MinimizeStats]:
    """Globally merge equivalent states across queries (beyond ``shared``).

    Partition refinement over the single-parent DAG: two states merge
    when their *entire root paths* are identical — same local row
    (in-tag, selfloop, init, kind) and equivalent parents.  Activation is
    a function of the root path alone, so merged states are
    indistinguishable to every engine and the result is bit-identical.
    This collapses ``shared=False`` (Unop) chains into the shared-prefix
    trie, dedups repeated profiles from different subscribers, and merges
    replicated ``//`` waiting states — the global form of §3.3's sharing.

    Accept lanes become many-to-one: queries whose accept states merge
    share one state (and downstream one kernel lane); ``accept_state``
    keeps its (Q,) shape so verdict semantics are unchanged — use
    :func:`accept_classes` for the distinct-lane view.

    Suffix (right-language) merging is deliberately *not* attempted:
    states of different queries always differ in their accept behaviour
    (each subscriber needs its own verdict), so bottom-up merging can
    never cross accept classes — the states it could merge are exactly
    the path-equivalent ones this pass already merges.

    Returns the minimized NFA plus :class:`MinimizeStats`.
    """
    t = nfa.tables
    s = t.in_state.shape[0]
    local = np.stack([
        t.in_tag.astype(np.int64),
        t.selfloop.astype(np.int64),
        t.init.astype(np.int64),
        t.kind.astype(np.int64),
    ])
    cls = np.zeros(s, np.int64)
    n = 1
    while True:  # refine until stable; ≤ trie depth + 1 rounds
        sig = np.concatenate([cls[t.in_state][None, :], local])
        _, new = np.unique(sig, axis=1, return_inverse=True)
        new = new.reshape(-1)  # numpy≥2 returns the pre-axis-move shape
        m = int(new.max()) + 1
        if m == n:
            cls = new
            break
        cls, n = new, m
    # renumber classes by lowest member id: root stays 0 and parents keep
    # lower ids than children (the builder invariant engines rely on)
    reps = np.full(n, s, np.int64)
    np.minimum.at(reps, cls, np.arange(s))
    order = np.argsort(reps)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    cls = rank[cls]
    reps = reps[order]
    tables = NFATables(
        in_state=cls[t.in_state[reps]].astype(np.int32),
        in_tag=t.in_tag[reps],
        selfloop=t.selfloop[reps],
        init=t.init[reps],
        accept_state=cls[t.accept_state].astype(np.int32),
        kind=t.kind[reps],
    )
    stats = MinimizeStats(
        states_before=s,
        states_after=n,
        accept_classes=int(np.unique(tables.accept_state).shape[0]),
        unshared_states=unshared_state_count(nfa.queries),
    )
    return (NFA(tables=tables, queries=nfa.queries, shared=True,
                n_tags=nfa.n_tags), stats)


def accept_classes(accept_state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Many-to-one accept view: (class_of (Q,), class_state (C,)).

    Queries sharing an accept state share an accept *class* (one kernel
    lane, one verdict bit); classes are numbered by first query using
    them, so an unminimized automaton (all accept states distinct) gets
    the identity mapping.
    """
    class_state, class_of = np.unique(accept_state, return_inverse=True)
    class_of = class_of.reshape(-1)
    # renumber by first occurrence for stable, query-ordered class ids
    first = np.full(class_state.shape[0], accept_state.shape[0], np.int64)
    np.minimum.at(first, class_of, np.arange(accept_state.shape[0]))
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return (rank[class_of].astype(np.int32),
            class_state[order].astype(np.int32))


# ---------------------------------------------------------------- partitioning
@dataclass(frozen=True)
class QueryPartition:
    """Global query id ↔ (part, local column) index of a partitioned set.

    The query axis is the paper's scaling axis (§3.5: replicate query
    blocks across FPGA area/chips); this index is the software form of
    "which chip holds which profile".  Global ids are stable across
    subscription churn — a removed query's id is never reused, its column
    is tombstoned (``part_of[gid] = -1``) until the owning part is next
    recompiled.

    ``part_of[gid]``  — owning part, or -1 for removed/dead ids.
    ``local_of[gid]`` — column inside the owning part's plan.
    """

    part_of: np.ndarray    # (Qg,) int32, -1 = dead
    local_of: np.ndarray   # (Qg,) int32
    n_parts: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "part_of",
                           np.asarray(self.part_of, np.int32))
        object.__setattr__(self, "local_of",
                           np.asarray(self.local_of, np.int32))
        assert self.part_of.shape == self.local_of.shape

    @property
    def n_global(self) -> int:
        """Total ids ever issued (alive + tombstoned)."""
        return int(self.part_of.shape[0])

    @property
    def n_live(self) -> int:
        return int((self.part_of >= 0).sum())

    def live_ids(self) -> np.ndarray:
        """Alive global ids, sorted — the canonical global query order."""
        return np.nonzero(self.part_of >= 0)[0].astype(np.int32)

    def lookup(self, gid: int) -> tuple[int, int]:
        """(part, local column) of a global id; raises on dead ids."""
        p = int(self.part_of[gid])
        if p < 0:
            raise KeyError(f"query id {gid} is not subscribed")
        return p, int(self.local_of[gid])

    def part_sizes(self) -> np.ndarray:
        """(P,) live query count per part — the load-balance view."""
        alive = self.part_of[self.part_of >= 0]
        return np.bincount(alive, minlength=self.n_parts).astype(np.int64)


def _prefix_key(q: Query) -> tuple[int, str]:
    """Trie-sharing group key: queries sharing their leading step share
    the root fan-out of the prefix trie (§3.3), so the partitioner keeps
    each group on one part instead of splitting the shared prefix."""
    st = q.steps[0]
    return (st.axis, st.tag)


def _query_weight(q: Query) -> int:
    """State-count estimate of one profile: a match state per step plus
    a waiting state per descendant step (the unshared upper bound)."""
    return q.length + sum(1 for st in q.steps if st.axis == DESC)


def partition_queries(
    queries: Sequence[Query],
    n_parts: int,
    dictionary: TagDictionary,
    *,
    shared: bool = True,
) -> tuple[list[NFA], QueryPartition]:
    """Split a subscription set into ``n_parts`` balanced sub-NFAs.

    The split respects shared-prefix trie groups: queries with the same
    leading step stay on the same part (their prefix states dedup inside
    that part's trie), and groups are greedily packed onto the least
    loaded part by estimated state weight — the multi-chip layout of
    §3.5 where each chip carries a balanced slice of the profile set.

    All tag names are registered in ``dictionary`` *before* any part is
    compiled, so every sub-NFA sees the same ``n_tags`` — a requirement
    for stacking per-part tables into one leading-axis device array.

    Returns the per-part NFAs plus the :class:`QueryPartition` index
    (global query id = position in ``queries``).
    """
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    queries = list(queries)
    # uniform tag-id space across parts (see docstring)
    for q in queries:
        for st in q.steps:
            if st.tag != WILDCARD:
                dictionary.add(st.tag)
    # group by shared prefix, heaviest groups first, least-loaded part wins
    groups: dict[tuple, list[int]] = {}
    for gid, q in enumerate(queries):
        groups.setdefault(_prefix_key(q), []).append(gid)
    weight = {k: sum(_query_weight(queries[g]) for g in gids)
              for k, gids in groups.items()}
    order = sorted(groups, key=lambda k: (-weight[k], k))
    load = [0] * n_parts
    members: list[list[int]] = [[] for _ in range(n_parts)]
    for k in order:
        p = min(range(n_parts), key=lambda i: (load[i], i))
        members[p].extend(groups[k])
        load[p] += weight[k]
    part_of = np.full(len(queries), -1, np.int32)
    local_of = np.zeros(len(queries), np.int32)
    parts: list[NFA] = []
    for p, gids in enumerate(members):
        gids.sort()  # deterministic local order = global order restricted
        for c, gid in enumerate(gids):
            part_of[gid] = p
            local_of[gid] = c
        parts.append(compile_queries([queries[g] for g in gids], dictionary,
                                     shared=shared))
    return parts, QueryPartition(part_of, local_of, n_parts)
