# Copy of src/repro/kernels/blocks.py (the port imports nothing of the JAX package).
"""State-block partitioners for the streaming filter megakernel.

The paper (§3.3) sorts the regexes alphabetically, clusters them into
common-prefix trees, and lays each cluster out as an independent hardware
region.  This module does the same at two levels:

* :func:`partition` — the original query-level flow: queries are sorted,
  greedily packed into blocks of ≤BLK NFA states (each block compiled as
  its own shared prefix trie, so parent pointers never cross a block).
  Blocks are **word-aligned** (BLK is rounded up to a multiple of 32) so
  the per-block state space always tiles into packed 32-bit words.
* :func:`state_layout` — the megakernel's layout: an already-compiled
  NFA is decomposed into its root-hanging subtrees (the prefix trie's
  natural fan-out), subtrees are first-fit-decreasing packed into
  word-aligned blocks closed under parent pointers (the root context
  state is replicated per block — it carries no dynamics, exactly like
  the FPGA replicating the stream interface per region), and every
  per-state table is emitted **bit-packed**: per-tag word masks, parent
  word/bit gather indices, self-loop/init words, and per-block accept
  lanes.  These are the tables
  :func:`repro.kernels.stream_filter.stream_filter_pallas` consumes.

Blocks never communicate — exactly the property that lets the paper tile
thousands of queries across FPGA regions and chips.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.dictionary import TagDictionary
from ..core.nfa import NFA, NEVER_TAG, WILD_TAG, compile_queries
from ..core.xpath import Query

WORD_BITS = 32


class PadOverflow(ValueError):
    """A uniform pad target (``n_blocks`` / ``block_queries``) is too
    small for the layout a plan actually needs.  Raised by
    :func:`state_layout`; the churn path (``ShardedPlan.add_queries``)
    catches it and falls back to a full replan at reconciled targets
    (``FilterEngine.merge_pads``)."""


def _round_up(n: int, multiple: int) -> int:
    multiple = max(1, int(multiple))
    return max(multiple, -(-int(n) // multiple) * multiple)


@dataclass
class BlockTables:
    in_tag: np.ndarray      # (G, BLK) int32
    wild: np.ndarray        # (G, BLK) f32
    selfloop: np.ndarray    # (G, BLK) f32
    init: np.ndarray        # (G, BLK) f32
    parent_1h: np.ndarray   # (G, BLK, BLK) f32
    accept_block: np.ndarray  # (Q,) int32 — block of each query's accept
    accept_local: np.ndarray  # (Q,) int32 — local state index
    query_order: np.ndarray   # (Q,) int32 — original index of sorted query q
    blk: int

    @property
    def n_blocks(self) -> int:
        return int(self.in_tag.shape[0])


def partition(queries: Sequence[Query], dictionary: TagDictionary,
              blk: int = 256) -> BlockTables:
    blk = _round_up(blk, WORD_BITS)  # word-aligned: BLK states = BLK/32 words
    order = sorted(range(len(queries)), key=lambda i: str(queries[i]))
    groups: list[list[int]] = []
    cur: list[int] = []
    for qi in order:
        trial = cur + [qi]
        nfa = compile_queries([queries[i] for i in trial], dictionary,
                              shared=True)
        if nfa.n_states > blk and cur:
            groups.append(cur)
            cur = [qi]
        else:
            cur = trial
    if cur:
        groups.append(cur)

    g = len(groups)
    in_tag = np.full((g, blk), NEVER_TAG, np.int32)
    wild = np.zeros((g, blk), np.float32)
    selfloop = np.zeros((g, blk), np.float32)
    init = np.zeros((g, blk), np.float32)
    p1h = np.zeros((g, blk, blk), np.float32)
    accept_block = np.zeros(len(queries), np.int32)
    accept_local = np.zeros(len(queries), np.int32)
    for gi, grp in enumerate(groups):
        nfa = compile_queries([queries[i] for i in grp], dictionary,
                              shared=True)
        if nfa.n_states > blk:
            raise ValueError(
                f"single query group exceeds block size {blk}: "
                f"{nfa.n_states} states")
        t = nfa.tables
        s = nfa.n_states
        in_tag[gi, :s] = t.in_tag
        wild[gi, :s] = (t.in_tag == WILD_TAG).astype(np.float32)
        selfloop[gi, :s] = t.selfloop
        init[gi, :s] = t.init
        p1h[gi, t.in_state, np.arange(s)] = 1.0
        for qq, acc in zip(grp, t.accept_state):
            accept_block[qq] = gi
            accept_local[qq] = acc
    return BlockTables(in_tag, wild, selfloop, init, p1h,
                       accept_block, accept_local,
                       np.asarray(order, np.int32), blk)


# -------------------------------------------------- megakernel state layout
@dataclass
class MegaBlockTables:
    """Bit-packed per-block tables for the streaming megakernel.

    ``G`` blocks of ``BLK`` states = ``WB = BLK/32`` packed words each;
    local state 0 of every block is its replica of the root context
    state.  ``QB`` accept lanes per block, the last lane of every block
    reserved and wired to the (never-activating) local root so padded
    query columns stay inert by construction.
    """

    tagmask: np.ndarray         # (G, T+1, WB) uint32 — per-tag match words;
    #                             row T is the wild-only row (out-of-range tags)
    pw: np.ndarray              # (G, WB, 32) int32 — parent *word* per state
    pb: np.ndarray              # (G, WB, 32) int32 — parent *bit* per state
    selfloop_words: np.ndarray  # (G, WB) uint32
    init_words: np.ndarray      # (G, WB) uint32
    acc_word: np.ndarray        # (G, QB) int32 — accept lane → local word
    acc_bit: np.ndarray         # (G, QB) int32 — accept lane → bit in word
    acc_block: np.ndarray       # (Q,) int32 — query → block
    acc_slot: np.ndarray        # (Q,) int32 — query → accept lane in block
    state_block: np.ndarray     # (S,) int32 — block of each NFA state (-1 =
    #                             inert pad state dropped; -2 = context
    #                             state replicated in every block)
    state_local: np.ndarray     # (S,) int32 — local index within the block
    context: np.ndarray         # (C,) int32 — replicated context states
    blk: int

    @property
    def n_blocks(self) -> int:
        return int(self.selfloop_words.shape[0])

    @property
    def words(self) -> int:
        return int(self.selfloop_words.shape[1])

    @property
    def block_queries(self) -> int:
        return int(self.acc_word.shape[1])


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(..., W*32) bool/int → (..., W) uint32 packed words."""
    shaped = bits.reshape(bits.shape[:-1] + (-1, WORD_BITS)).astype(np.uint32)
    weights = np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)
    return (shaped * weights).sum(axis=-1, dtype=np.uint32)


#: replicate at most this many context states per block — a *shared*
#: trie has ~1 (the root's `//` waiting state); an unshared (Unop) trie
#: has one per `//`-leading query, where replication would explode and
#: per-query subtrees are small anyway, so we fall back to root-only
CONTEXT_CAP = 8


def _context_states(t) -> np.ndarray:
    """Constant-on root-level waiting states, replicated like the root.

    A state with ``in_state == 0``, a NEVER in-tag, a self-loop and
    ``init`` (the compiled form of a leading ``//`` step) is active in
    *every* stack context: its transition reduces to ``nxt[s] =
    bits[s]`` and row 0 starts it on.  It carries no cross-state
    dynamics, so each block can keep its own copy — which is what lets
    the shared prefix trie (where every ``//tag`` profile hangs off ONE
    such state) split into independent blocks at all.
    """
    sid = np.arange(t.n_states)
    const_on = ((t.in_state == 0) & (t.in_tag == NEVER_TAG)
                & t.selfloop & t.init & (sid > 0))
    ctx = np.nonzero(const_on)[0].astype(np.int32)
    return ctx if len(ctx) <= CONTEXT_CAP else ctx[:0]


def _subtrees(nfa: NFA) -> tuple[np.ndarray, dict[int, list[int]]]:
    """Context-hanging subtree decomposition of the single-parent trie.

    Returns the replicated context states and the member lists per live
    subtree: a subtree root is any non-context state whose parent is the
    root or a context state (parents always precede children in the
    builder's numbering, so one forward pass suffices).  Inert padding
    singletons (NEVER tag, no self-loop, not init, no accept) are
    dropped — they can never activate, so leaving them out of the block
    layout cannot change any verdict.
    """
    t = nfa.tables
    s = t.n_states
    ctx = _context_states(t)
    in_ctx = np.zeros(s, bool)
    in_ctx[0] = True
    in_ctx[ctx] = True
    top = np.full(s, -1, np.int32)
    for i in range(1, s):
        if in_ctx[i]:
            continue
        p = int(t.in_state[i])
        top[i] = i if in_ctx[p] else top[p]
    groups: dict[int, list[int]] = {}
    for i in range(1, s):
        if top[i] >= 0:
            groups.setdefault(int(top[i]), []).append(i)
    has_accept = np.zeros(s, bool)
    acc = t.accept_state[(t.accept_state >= 0) & (t.accept_state < s)]
    has_accept[acc] = True
    live = {
        tid: members for tid, members in groups.items()
        if not (len(members) == 1 and t.in_tag[tid] == NEVER_TAG
                and not t.selfloop[tid] and not t.init[tid]
                and not has_accept[tid])
    }
    return ctx, live


def min_block_size(nfa: NFA) -> int:
    """Smallest word-aligned BLK that fits this NFA's largest subtree
    (local slots are always reserved for the block's root + context
    replicas)."""
    ctx, live = _subtrees(nfa)
    largest = max((len(m) for m in live.values()), default=0)
    return _round_up(largest + 1 + len(ctx), WORD_BITS)


def state_layout(nfa: NFA, blk: int = 256, *,
                 n_blocks: int | None = None,
                 block_queries: int | None = None) -> MegaBlockTables:
    """Decompose a compiled NFA into word-aligned parent-closed blocks.

    ``blk`` is rounded up to a multiple of 32 and auto-grown when a
    single subtree does not fit; ``n_blocks``/``block_queries`` pad the
    block and accept-lane axes to uniform targets (sharded plans stack
    per-part tables along a leading axis, so every part must agree on
    ``(G, QB)`` — see ``StreamingEngine.part_pads``).
    """
    t = nfa.tables
    s = t.n_states
    ctx, live = _subtrees(nfa)
    largest = max((len(m) for m in live.values()), default=0)
    blk = max(_round_up(blk, WORD_BITS),
              _round_up(largest + 1 + len(ctx), WORD_BITS))
    cap = blk - 1 - len(ctx)  # slot 0 = root replica, then context replicas

    # first-fit decreasing, deterministic: heaviest subtrees first,
    # ties broken by subtree-root state id
    order = sorted(live.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    bins: list[list[int]] = []
    loads: list[int] = []
    for _tid, members in order:
        for bi in range(len(bins)):
            if loads[bi] + len(members) <= cap:
                bins[bi].extend(members)
                loads[bi] += len(members)
                break
        else:
            bins.append(list(members))
            loads.append(len(members))
    g = max(1, len(bins))
    if n_blocks is not None:
        if len(bins) > n_blocks:
            raise PadOverflow(
                f"layout needs {len(bins)} blocks but n_blocks="
                f"{n_blocks} was requested")
        g = max(g, int(n_blocks))
    wb = blk // WORD_BITS

    # local per-block tables: slot 0 = root replica, slots 1..C = context
    # replicas (identical in every block — they carry no cross-state
    # dynamics), then the block's subtrees; unused slots stay inert
    state_block = np.full(s, -1, np.int32)
    state_local = np.zeros(s, np.int32)
    l_in_state = np.zeros((g, blk), np.int32)
    l_in_tag = np.full((g, blk), NEVER_TAG, np.int32)
    l_selfloop = np.zeros((g, blk), bool)
    l_init = np.zeros((g, blk), bool)
    l_init[:, 0] = bool(t.init[0])  # the root context is active at depth 0
    for j, cs in enumerate(sorted(int(c) for c in ctx)):
        loc = j + 1
        state_block[cs] = -2  # replicated: lives in every block
        state_local[cs] = loc
        l_in_tag[:, loc] = t.in_tag[cs]
        l_selfloop[:, loc] = t.selfloop[cs]
        l_init[:, loc] = t.init[cs]
    base = 1 + len(ctx)
    for gi, members in enumerate(bins):
        members = sorted(members)  # ascending global id ⇒ parents first
        for j, gs in enumerate(members):
            loc = base + j
            state_block[gs] = gi
            state_local[gs] = loc
            l_in_tag[gi, loc] = t.in_tag[gs]
            l_selfloop[gi, loc] = t.selfloop[gs]
            l_init[gi, loc] = t.init[gs]
        for gs in members:
            p = int(t.in_state[gs])
            l_in_state[gi, state_local[gs]] = 0 if p == 0 else state_local[p]

    # bit-packed tables: per-tag word masks (+ one wild-only row for
    # out-of-range tags), parent word/bit gather indices, state words
    n_tags = int(nfa.n_tags)
    wild_words = _pack_bits(l_in_tag == WILD_TAG)           # (G, WB)
    tagmask = np.repeat(wild_words[:, None, :], n_tags + 1, axis=1)
    gg, jj = np.nonzero(l_in_tag >= 0)
    tags = l_in_tag[gg, jj]
    valid = tags < n_tags
    gg, jj, tags = gg[valid], jj[valid], tags[valid]
    np.bitwise_or.at(
        tagmask, (gg, tags, jj // WORD_BITS),
        np.uint32(1) << (jj % WORD_BITS).astype(np.uint32))
    pw = (l_in_state >> 5).reshape(g, wb, WORD_BITS).astype(np.int32)
    pb = (l_in_state & 31).reshape(g, wb, WORD_BITS).astype(np.int32)

    # accept lanes: queries grouped by owning block; the mapping is
    # many-to-one — queries sharing an accept state (minimized automata,
    # duplicate subscriber profiles) share ONE lane, so the verdict width
    # QB is bounded by distinct accept states (≤ BLK), not by Q.  Lane
    # QB-1 of every block is reserved (wired to the inert local root)
    # for padded columns.
    nq = int(t.accept_state.shape[0])
    acc_block = np.zeros(nq, np.int32)
    acc_slot = np.zeros(nq, np.int32)
    counts = np.zeros(g, np.int32)
    lanes: list[list[tuple[int, int]]] = [[] for _ in range(g)]
    lane_of: dict[int, tuple[int, int]] = {}  # accept state → (block, lane)
    for q in range(nq):
        a = int(t.accept_state[q])
        if a <= 0 or state_block[a] < 0:  # root/pad accept: inert column
            acc_block[q] = 0
            acc_slot[q] = -1  # patched to QB-1 below
            continue
        if a in lane_of:
            acc_block[q], acc_slot[q] = lane_of[a]
            continue
        gi = int(state_block[a])
        acc_block[q] = gi
        acc_slot[q] = counts[gi]
        lanes[gi].append((int(counts[gi]), int(state_local[a])))
        lane_of[a] = (gi, int(counts[gi]))
        counts[gi] += 1
    qb = int(counts.max(initial=0)) + 1
    if block_queries is not None:
        if qb > int(block_queries):
            raise PadOverflow(
                f"layout needs {qb} accept lanes but block_queries="
                f"{block_queries} was requested")
        qb = int(block_queries)
    acc_slot[acc_slot < 0] = qb - 1
    acc_word = np.zeros((g, qb), np.int32)
    acc_bit = np.zeros((g, qb), np.int32)
    for gi in range(g):
        for slot, loc in lanes[gi]:
            acc_word[gi, slot] = loc >> 5
            acc_bit[gi, slot] = loc & 31

    return MegaBlockTables(
        tagmask=tagmask, pw=pw, pb=pb,
        selfloop_words=_pack_bits(l_selfloop),
        init_words=_pack_bits(l_init),
        acc_word=acc_word, acc_bit=acc_bit,
        acc_block=acc_block, acc_slot=acc_slot,
        state_block=state_block, state_local=state_local,
        context=np.asarray(sorted(int(c) for c in ctx), np.int32), blk=blk)
