"""Levelwise engines of the port: the NFA advanced level by level (K6).

Counterpart of ``src/repro/core/engines/levelwise.py``.  The document's
structure — per-node ``(depth, parent)`` — is known before filtering
(host parse or device parse), so the paper's stack is virtualised away:
a node's top of stack is its parent node's active set.  Nodes are
bucketed by depth on the host, and the NFA advances every node of a
level at once:

    tagmatch = onehot(tags) @ REQ + wild
    src      = parent_active @ P        (K6: parent_active[:, in_state])
    next     = min(src * tagmatch + parent_active * selfloop, 1)

* :class:`LevelwiseEngine` pads every level to the widest and runs one
  step per level: through K6 (``use_kernel=True``,
  :func:`repro_torch.kernels.nfa_transition.nfa_transition`), through
  ``torch.matmul`` (``use_matmul=True``, the default) or as a gather and
  compare (``use_matmul=False``).
* :class:`WavefrontEngine` splits each level into chunks of ``chunk``
  nodes and runs one step per chunk: a 0/1 bool program by default, K6
  with ``use_kernel=True``.

``vmap`` over documents becomes a batch dimension written out: each level
(or chunk step) is ONE step for the whole batch, so K6 launches once per
level or chunk, not once per document.  A sharded plan's parts fold into
the state axis (:meth:`_LevelEngine._folded_plan`): P parts of S states
are one plan of P·S states whose parent indices never leave their part,
so K6 still launches once per level or chunk for all parts.  The
depth-major bucketing is a host numpy pass (plan meta ``"prep":
"levels-host"``): a batch parsed on the device comes back to the host
for it, and its buckets go to the device once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...kernels import nfa_transition as nt
from ...kernels import ref
from ..events import OPEN, EventBatch, EventStream
from ..nfa import NFA, WILD_TAG, pad_states
from . import base
from .result import NO_MATCH, FilterResult


# --------------------------------------------------------------------- prep
# The host bucketing below is a copy of the JAX package's numpy code.
@dataclass
class LevelDoc:
    """Depth-major dense bucketing of a document's OPEN events."""

    tags: np.ndarray         # (D, Wmax) int32, -1 padding
    parent_slot: np.ndarray  # (D, Wmax) int32 — slot in level d-1; Wmax ⇒ root
    valid: np.ndarray        # (D, Wmax) bool
    event_idx: np.ndarray    # (D, Wmax) int32 — original event position
    n_events: int

    @property
    def depth(self) -> int:
        return int(self.tags.shape[0])

    @property
    def width(self) -> int:
        return int(self.tags.shape[1])

    def padded(self, depth: int, width: int) -> "LevelDoc":
        if depth < self.depth or width < self.width:
            raise ValueError("cannot shrink")
        tags = np.full((depth, width), -1, np.int32)
        parent = np.full((depth, width), width, np.int32)
        valid = np.zeros((depth, width), bool)
        eidx = np.zeros((depth, width), np.int32)
        d, w = self.depth, self.width
        tags[:d, :w] = self.tags
        # re-point root sentinel (old Wmax) to new sentinel (new width)
        parent[:d, :w] = np.where(self.parent_slot == w, width, self.parent_slot)
        valid[:d, :w] = self.valid
        eidx[:d, :w] = self.event_idx
        return LevelDoc(tags, parent, valid, eidx, self.n_events)


def levelize(ev: EventStream) -> LevelDoc:
    """Host-side structure pass: one linear sweep over the events."""
    kind, tag = ev.kind, ev.tag_id
    n = len(ev)
    depth_of: list[list[int]] = []   # per level: node slots in doc order
    tags_l: list[list[int]] = []
    parent_l: list[list[int]] = []
    eidx_l: list[list[int]] = []
    stack: list[int] = []  # slot of each open ancestor within its level
    for i in range(n):
        k = kind[i]
        if k == OPEN:
            d = len(stack)  # 0-based level
            while len(depth_of) <= d:
                depth_of.append([])
                tags_l.append([])
                parent_l.append([])
                eidx_l.append([])
            slot = len(depth_of[d])
            depth_of[d].append(slot)
            tags_l[d].append(int(tag[i]))
            parent_l[d].append(stack[-1] if stack else -1)
            eidx_l[d].append(i)
            stack.append(slot)
        elif k == 1:  # CLOSE
            if stack:
                stack.pop()
    d_max = max(1, len(depth_of))
    w_max = max(1, max((len(x) for x in depth_of), default=1))
    tags = np.full((d_max, w_max), -1, np.int32)
    parent = np.full((d_max, w_max), w_max, np.int32)
    valid = np.zeros((d_max, w_max), bool)
    eidx = np.zeros((d_max, w_max), np.int32)
    for d in range(len(depth_of)):
        w = len(depth_of[d])
        tags[d, :w] = tags_l[d]
        # level 0 nodes point at the root sentinel row (index w_max)
        parent[d, :w] = [p if p >= 0 else w_max for p in parent_l[d]]
        valid[d, :w] = True
        eidx[d, :w] = eidx_l[d]
    return LevelDoc(tags, parent, valid, eidx, n)


def levelize_batch(docs: list[EventStream]) -> LevelDoc:
    """Pad a batch of documents to common (D, W); stacks along axis 0."""
    return _stack_leveldocs([levelize(d) for d in docs])


def _stack_leveldocs(ls: list[LevelDoc]) -> LevelDoc:
    dm = max(l.depth for l in ls)
    wm = max(l.width for l in ls)
    ls = [l.padded(dm, wm) for l in ls]
    return LevelDoc(
        np.stack([l.tags for l in ls]),
        np.stack([l.parent_slot for l in ls]),
        np.stack([l.valid for l in ls]),
        np.stack([l.event_idx for l in ls]),
        max(l.n_events for l in ls),
    )


def levelize_from_arrays(kind: np.ndarray, tag: np.ndarray,
                         depth: np.ndarray, parent: np.ndarray) -> LevelDoc:
    """Vectorized levelize consuming precomputed (depth, parent): the
    depth-major bucketing is pure numpy, with no per-event Python loop."""
    open_idx = np.nonzero(kind == OPEN)[0]
    if len(open_idx) == 0:
        return LevelDoc(np.full((1, 1), -1, np.int32),
                        np.full((1, 1), 1, np.int32),
                        np.zeros((1, 1), bool),
                        np.zeros((1, 1), np.int32), int(kind.shape[0]))
    lev = depth[open_idx].astype(np.int64) - 1        # 0-based level
    d_max = int(lev.max()) + 1
    # slot within level = stable cumcount of the level sequence
    order = np.argsort(lev, kind="stable")
    sorted_lev = lev[order]
    starts = np.searchsorted(sorted_lev, np.arange(d_max))
    ranks = np.arange(len(open_idx)) - starts[sorted_lev]
    slot = np.empty(len(open_idx), np.int64)
    slot[order] = ranks
    widths = np.bincount(lev, minlength=d_max)
    w_max = max(1, int(widths.max()))
    slot_of_event = np.full(kind.shape[0], w_max, np.int64)
    slot_of_event[open_idx] = slot
    tags = np.full((d_max, w_max), -1, np.int32)
    parent_slot = np.full((d_max, w_max), w_max, np.int32)
    valid = np.zeros((d_max, w_max), bool)
    eidx = np.zeros((d_max, w_max), np.int32)
    tags[lev, slot] = tag[open_idx]
    p = parent[open_idx]
    parent_slot[lev, slot] = np.where(
        p >= 0, slot_of_event[np.clip(p, 0, None)], w_max).astype(np.int32)
    valid[lev, slot] = True
    eidx[lev, slot] = open_idx
    return LevelDoc(tags, parent_slot, valid, eidx, int(kind.shape[0]))


def _leveldocs_of_batch(batch: EventBatch) -> list[LevelDoc]:
    """One LevelDoc per document, from the batch's precomputed arrays."""
    batch = batch.to_host()  # depth-major bucketing is a host (numpy) pass
    out = []
    for i in range(batch.batch_size):
        n = int(batch.n_events[i])
        out.append(levelize_from_arrays(
            batch.kind[i, :n], batch.tag_id[i, :n],
            batch.depth[i, :n], batch.parent[i, :n]))
    return out


@dataclass
class ChunkDoc:
    """Chunked wavefront layout: levels split into fixed-width chunks.

    Each level is split into chunks of width C; chunk i owns rows
    [i·C, (i+1)·C) of a flat node buffer and parents are *global* padded
    indices into that buffer, so the engine runs Σ⌈w_d/C⌉ dense steps
    with ≤C padding per level.
    """

    tags: np.ndarray         # (n_chunks, C) int32, -1 pad
    parent_idx: np.ndarray   # (n_chunks, C) int32 — global padded index;
    #                           buffer_len ⇒ virtual root row
    valid: np.ndarray        # (n_chunks, C) bool
    event_idx: np.ndarray    # (n_chunks, C) int32

    @property
    def n_chunks(self) -> int:
        return int(self.tags.shape[0])

    @property
    def chunk(self) -> int:
        return int(self.tags.shape[1])


def chunkize(ev: EventStream, chunk: int = 128) -> ChunkDoc:
    return chunkize_level(levelize(ev), chunk)


def chunkize_level(ld: LevelDoc, chunk: int = 128) -> ChunkDoc:
    d_max, w_max = ld.tags.shape
    # chunks per level and level→base-chunk mapping
    widths = ld.valid.sum(axis=1)
    n_per = [max(1, int(-(-w // chunk))) for w in widths]
    base_chunk = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    n_chunks = int(sum(n_per))
    buf_len = n_chunks * chunk

    def gpos(d: int, slot: np.ndarray) -> np.ndarray:
        return ((base_chunk[d] + slot // chunk) * chunk
                + slot % chunk).astype(np.int32)

    tags = np.full((n_chunks, chunk), -1, np.int32)
    parent = np.full((n_chunks, chunk), buf_len, np.int32)
    valid = np.zeros((n_chunks, chunk), bool)
    eidx = np.zeros((n_chunks, chunk), np.int32)
    for d in range(d_max):
        w = int(widths[d])
        if w == 0:
            continue
        slots = np.arange(w)
        g = gpos(d, slots)
        ci, cj = g // chunk, g % chunk
        tags[ci, cj] = ld.tags[d, :w]
        p = ld.parent_slot[d, :w]
        parent[ci, cj] = np.where(p == w_max, buf_len,
                                  gpos(d - 1, np.clip(p, 0, None)))
        valid[ci, cj] = True
        eidx[ci, cj] = ld.event_idx[d, :w]
    return ChunkDoc(tags, parent, valid, eidx)


# ------------------------------------------------------------------- plan
def _level_plan(engine: str, nfa: NFA, lane: int,
                device: torch.device) -> base.FilterPlan:
    """Shared compile step of the levelwise engines: pad the state space
    to ``lane`` (the engine's ``state_multiple``) and place the dense
    tables (REQ pre-decoder, parent one-hot, accept map) on ``device``
    once."""
    from ...convert import level_plan_from_numpy  # convert imports this package

    nfa = pad_states(nfa, lane)
    t = nfa.tables
    tables = dict(in_state=t.in_state, in_tag=t.in_tag,
                  selfloop=t.selfloop.astype(np.float32),
                  init=t.init.astype(np.float32),
                  accept_state=t.accept_state, req=nfa.req_matrix(),
                  wild=nfa.wild_vector(), parent_1h=nfa.parent_onehot())
    meta = {"n_states": int(t.in_state.shape[0]), "n_tags": nfa.n_tags,
            "state_multiple": lane,
            # document prep (depth-major bucketing) is a host numpy pass
            "prep": "levels-host"}
    return level_plan_from_numpy(engine, tables, meta, device)


def _accumulate(nxt: torch.Tensor, vld: torch.Tensor, eidx: torch.Tensor,
                accept: torch.Tensor, matched: torch.Tensor,
                first: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one step's (B, W, S) states into (B, Q) matched and first:
    ``first`` is the least event index over accepting nodes, with
    ``NO_MATCH`` as the identity."""
    acc = (nxt.index_select(2, accept) > 0) & vld[..., None]    # (B, W, Q)
    ev = torch.where(acc, eidx[..., None],
                     torch.full_like(eidx[..., None], NO_MATCH))
    return matched | acc.any(1), torch.minimum(first, ev.amin(1))


def _start(b: int, n_q: int, device: torch.device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((b, n_q), dtype=torch.bool, device=device),
            torch.full((b, n_q), NO_MATCH, dtype=torch.int32, device=device))


# -------------------------------------------------------------- levelwise
def _run_level(tags: torch.Tensor, parent_slot: torch.Tensor,
               valid: torch.Tensor, event_idx: torch.Tensor,
               plan: base.FilterPlan, *, use_matmul: bool,
               use_kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D, W) level buckets → (B, Q) matched and first.

    The carry ``prev`` is (B, W+1, S) float32: row W of each document is
    the root sentinel, holding ``init``.  One step per level for the whole
    batch: the parents' rows are gathered, the (B·W, S) transition runs
    (K6, ``torch.matmul``, or gather and compare), padding rows are zeroed.
    """
    b, d_max, w_max = tags.shape
    s = int(plan.meta["n_states"])
    dev = tags.device
    selfloop, init, req, wild = (plan[k] for k in (
        "selfloop", "init", "req", "wild"))
    accept = plan["accept_state"].long()
    parent_idx = plan["in_state"]
    in_state = parent_idx.long()
    in_tag = plan["in_tag"]
    rows = torch.arange(b, device=dev)[:, None]
    prev = torch.zeros((b, w_max + 1, s), dtype=torch.float32, device=dev)
    prev[:, w_max] = init
    matched, first = _start(b, accept.shape[0], dev)
    for d in range(d_max):
        tg, vld = tags[:, d], valid[:, d]
        parent_rows = prev[rows, parent_slot[:, d].long()].reshape(b * w_max, s)
        flat_tags = tg.reshape(-1).contiguous()
        if use_kernel:
            nxt = nt.nfa_transition(parent_rows, flat_tags, req, wild,
                                    parent_idx, selfloop)
        else:
            if use_matmul:
                tagmatch = ref.tag_rows(flat_tags, req) + wild[None, :]
                src = parent_rows @ plan["parent_1h"]
            else:
                tagmatch = ((in_tag[None, :] == flat_tags[:, None])
                            | (in_tag == WILD_TAG)[None, :]).to(torch.float32)
                src = parent_rows.index_select(1, in_state)
            nxt = torch.clamp(src * tagmatch + parent_rows * selfloop[None, :],
                              max=1.0)
            del src, tagmatch
        del parent_rows
        nxt = nxt.view(b, w_max, s)
        nxt.mul_(vld[..., None])
        matched, first = _accumulate(nxt, vld, event_idx[:, d], accept,
                                     matched, first)
        prev = torch.cat([nxt, init.expand(b, 1, s)], 1)
        del nxt
    return matched, first


# -------------------------------------------------------------- wavefront
def _run_wavefront(tags: torch.Tensor, parent_idx: torch.Tensor,
                   valid: torch.Tensor, event_idx: torch.Tensor,
                   plan: base.FilterPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Boolean-state wavefront over (B, n_chunks, C) chunk layouts.

    The node buffer is (B, n_chunks·C + 1, S) bool, its last row the root
    sentinel holding ``init``; step i writes its chunk's rows into the
    buffer in place.
    """
    b, n_chunks, c = tags.shape
    s = int(plan.meta["n_states"])
    dev = tags.device
    buf_len = n_chunks * c
    in_state = plan["in_state"].long()
    in_tag = plan["in_tag"]
    wild = (in_tag == WILD_TAG)[None, None, :]
    selfloop = (plan["selfloop"] > 0)[None, None, :]
    accept = plan["accept_state"].long()
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, buf_len + 1, s), dtype=torch.bool, device=dev)
    buf[:, buf_len] = plan["init"] > 0
    matched, first = _start(b, accept.shape[0], dev)
    for i in range(n_chunks):
        tg, vld = tags[:, i], valid[:, i]
        parent_rows = buf[rows, parent_idx[:, i].long()]         # (B, C, S)
        tagmatch = (in_tag[None, None, :] == tg[..., None]) | wild
        src = parent_rows.index_select(2, in_state)
        nxt = ((src & tagmatch) | (parent_rows & selfloop)) & vld[..., None]
        buf[:, i * c:(i + 1) * c] = nxt
        matched, first = _accumulate(nxt, vld, event_idx[:, i], accept,
                                     matched, first)
    return matched, first


def _run_wavefront_kernel(tags: torch.Tensor, parent_idx: torch.Tensor,
                          valid: torch.Tensor, event_idx: torch.Tensor,
                          plan: base.FilterPlan
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wavefront with K6: the same chunk structure as
    :func:`_run_wavefront` over a float32 buffer, updated in place; tags
    are masked by ``valid`` before K6, and each step is one K6 launch
    over the batch's (B·C, S) rows."""
    b, n_chunks, c = tags.shape
    s = int(plan.meta["n_states"])
    dev = tags.device
    buf_len = n_chunks * c
    selfloop, req, wild, in_state = (plan[k] for k in (
        "selfloop", "req", "wild", "in_state"))
    accept = plan["accept_state"].long()
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, buf_len + 1, s), dtype=torch.float32, device=dev)
    buf[:, buf_len] = plan["init"]
    matched, first = _start(b, accept.shape[0], dev)
    for i in range(n_chunks):
        tg, vld = tags[:, i], valid[:, i]
        parent_rows = buf[rows, parent_idx[:, i].long()].reshape(b * c, s)
        tg_masked = torch.where(vld, tg, -1).reshape(-1)
        nxt = nt.nfa_transition(parent_rows, tg_masked, req, wild, in_state,
                                selfloop).view(b, c, s)
        buf[:, i * c:(i + 1) * c] = nxt
        matched, first = _accumulate(nxt, vld, event_idx[:, i], accept,
                                     matched, first)
    return matched, first


# ---------------------------------------------------------------- engines
class _LevelEngine(base.FilterEngine):
    """What the two levelwise engines share: the plan, the staging of host
    buckets on the device, the batch entry points and the sharded runs."""

    state_multiple = 128
    device_sharded = True

    def plan(self, nfa: NFA) -> base.FilterPlan:
        return _level_plan(self.name, nfa, self.state_multiple, self.device)

    def _plan_from_tables(self, tables, meta) -> base.FilterPlan:
        """A cached plan, rebuilt through :func:`repro_torch.convert.
        level_plan_from_numpy` (shapes, state indices in [0, S))."""
        from ...convert import level_plan_from_numpy  # imports this package

        return level_plan_from_numpy(self.name, tables, meta, self.device)

    def part_pads(self, parts, *, query_bucket: int = 8):
        """Uniform pads, the tag space included: REQ is (T, S), so the
        parts stack only at one T, bucketed to 16 so that churn bringing
        new tags rarely forces a global re-pad."""
        pads = super().part_pads(parts, query_bucket=query_bucket)
        pads["n_tags"] = base._round_up(
            max((nfa.n_tags for nfa in parts), default=1), 16)
        return pads

    def _folded_plan(self, sharded: base.ShardedPlan) -> base.FilterPlan:
        """The parts of a stacked plan folded into the state axis: one
        plan of P·S states, ``req`` and the state vectors concatenated
        along S, ``in_state`` and ``accept_state`` offset by ``p·S``.  No
        state reads a parent outside its part, so K6's gather by
        ``in_state`` is exact; no (P·S)² one-hot is built.  Made once per
        sharded plan."""

        def build():
            st = sharded.stacked()
            p, s = st["in_state"].shape
            offs = torch.arange(p, dtype=torch.int32,
                                device=sharded.device)[:, None] * s
            tables = {k: st[k].reshape(-1) for k in (
                "in_tag", "selfloop", "init", "wild")}
            tables.update(
                in_state=(st["in_state"] + offs).reshape(-1),
                accept_state=(st["accept_state"] + offs).reshape(-1),
                req=st["req"].permute(1, 0, 2).reshape(
                    st["req"].shape[1], p * s))
            meta = dict(st.meta, n_states=p * s)
            return base.FilterPlan(self.name, tables, meta)

        return self._lane_memo(sharded, build, "folded")

    def _folds_parts(self) -> bool:
        """Run a sharded plan as one folded plan?  Every mode but
        ``torch.matmul`` by the parent one-hot, which runs part by part."""
        return True

    def _run_parts(self, sharded: base.ShardedPlan, prep: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        if not self._folds_parts():
            return super()._run_parts(sharded, prep)
        matched, first = self._run_with_plan(self._folded_plan(sharded),
                                             prep)
        b, p = matched.shape[0], sharded.n_parts
        return (matched.view(b, p, -1).permute(1, 0, 2),
                first.view(b, p, -1).permute(1, 0, 2))

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        return self.filter_batch_with_plan(self.plan_, batch)

    def filter_documents_batched(self, docs: list[EventStream]
                                 ) -> list[FilterResult]:
        """Legacy list API (prefer :meth:`filter_batch`)."""
        res = self.filter_batch(EventBatch.from_streams(docs))
        return list(res.per_document())

    def _one(self, *arrays: np.ndarray) -> FilterResult:
        """One document's host layout → its verdicts (a batch of one)."""
        matched, first = self._run_with_plan(
            self.plan_, tuple(self.to_device(a[None]) for a in arrays))
        return FilterResult(matched[0].cpu().numpy(), first[0].cpu().numpy())


@base.register("wavefront")
class WavefrontEngine(_LevelEngine):
    """Chunked-wavefront levelwise engine.

    Options: ``chunk=`` (nodes per step, default 128) and ``use_kernel=``
    (K6 over a float32 buffer; default the bool program).
    """

    def __init__(self, nfa: NFA, dictionary=None, chunk: int = 128,
                 use_kernel: bool = False, **options) -> None:
        self.chunk = chunk
        self.use_kernel = use_kernel
        super().__init__(nfa, dictionary, **options)

    def filter_document(self, ev: EventStream) -> FilterResult:
        cd = chunkize(ev, self.chunk)
        return self._one(cd.tags, cd.parent_idx, cd.valid, cd.event_idx)

    def _prep_host(self, batch: EventBatch) -> tuple:
        # precomputed batch structure → no per-event host re-walk
        cds = [chunkize_level(ld, self.chunk)
               for ld in _leveldocs_of_batch(batch)]
        nc = max(c.n_chunks for c in cds)

        def pad(c: ChunkDoc) -> ChunkDoc:
            extra = nc - c.n_chunks
            if extra == 0:
                return c
            ck = c.chunk
            # grow: valid=False chunks at the end; parent root sentinel
            # must point at the NEW buffer end (nc*ck)
            old_len = c.n_chunks * ck
            parent = np.where(c.parent_idx == old_len, nc * ck,
                              c.parent_idx)
            return ChunkDoc(
                np.concatenate([c.tags, np.full((extra, ck), -1, np.int32)]),
                np.concatenate([parent,
                                np.full((extra, ck), nc * ck, np.int32)]),
                np.concatenate([c.valid, np.zeros((extra, ck), bool)]),
                np.concatenate([c.event_idx,
                                np.zeros((extra, ck), np.int32)]),
            )

        cds = [pad(c) for c in cds]
        # fix root sentinel for docs that already had nc chunks
        fixed = []
        for c in cds:
            parent = np.where(c.parent_idx >= nc * c.chunk, nc * c.chunk,
                              c.parent_idx)
            fixed.append(ChunkDoc(c.tags, parent, c.valid, c.event_idx))
        return (np.stack([c.tags for c in fixed]),
                np.stack([c.parent_idx for c in fixed]),
                np.stack([c.valid for c in fixed]),
                np.stack([c.event_idx for c in fixed]))

    def _run_with_plan(self, plan: base.FilterPlan, prep: tuple):
        run = _run_wavefront_kernel if self.use_kernel else _run_wavefront
        return run(*prep, plan)


@base.register("levelwise")
class LevelwiseEngine(_LevelEngine):
    """Levelwise engine: every level padded to the widest, one step each.

    Options: ``use_matmul=`` (default True: ``torch.matmul``; False:
    gather and compare) and ``use_kernel=`` (K6, ahead of either).
    """

    def __init__(self, nfa: NFA, dictionary=None, use_matmul: bool = True,
                 use_kernel: bool = False, **options) -> None:
        self.use_matmul = use_matmul
        self.use_kernel = use_kernel
        super().__init__(nfa, dictionary, **options)

    def filter_document(self, ev: EventStream) -> FilterResult:
        ld = levelize(ev)
        return self._one(ld.tags, ld.parent_slot, ld.valid, ld.event_idx)

    def _prep_host(self, batch: EventBatch) -> tuple:
        # precomputed batch structure → no per-event host re-walk
        ld = _stack_leveldocs(_leveldocs_of_batch(batch))
        return ld.tags, ld.parent_slot, ld.valid, ld.event_idx

    def _run_with_plan(self, plan: base.FilterPlan, prep: tuple):
        return _run_level(*prep, plan, use_matmul=self.use_matmul,
                          use_kernel=self.use_kernel)

    def _folds_parts(self) -> bool:
        # torch.matmul by the parent one-hot would need a (P·S)² one-hot
        return self.use_kernel or not self.use_matmul
