"""The engine contract of the port: ``FilterPlan``, ``FilterEngine``, registry.

Counterpart of ``src/repro/core/engines/base.py`` (lines 64-90, 122-175,
624-728, 890-944, 1005-1086, 1139-1149, 1213-1224, 1404-1474), for
engines whose compiled tables are torch tensors on one device:

* :class:`FilterPlan` — a frozen dict of tensors on one device plus
  static metadata, built once per profile set by :meth:`FilterEngine.plan`.
* :class:`FilterEngine` — compile once, then ``filter_batch`` (events)
  and ``filter_bytes`` (raw wire bytes) into ``(B, Q)`` results, or
  ``filter_batch_sparse`` / ``filter_bytes_sparse`` into bounded match
  lists (:class:`SparseResult`).  Every entry point runs on ``device``
  (``"cuda"`` unless the caller asks for ``"cpu"``, where the kernels'
  plain versions run).
* the registry — the port's own :func:`register` / :func:`create` /
  :func:`names`, separate from the JAX package's.
"""
from __future__ import annotations

import abc
from typing import Any, ClassVar, Mapping

import numpy as np
import torch

from ...kernels.ref import compact_rows
from ..events import DEFAULT_MAX_DEPTH, ByteBatch, EventBatch
from ..nfa import NFA
from .result import NO_MATCH, FilterResult, SparseResult


def _round_up(n: int, multiple: int) -> int:
    multiple = max(1, int(multiple))
    return max(multiple, -(-n // multiple) * multiple)


# ------------------------------------------------- sparse verdict compaction
def _compact_matches(matched: torch.Tensor, first: torch.Tensor,
                     cols: torch.Tensor, cap: int):
    """Cumsum-compact a dense device verdict into a bounded match buffer.

    ``matched`` ``(B, K)`` bool and ``first`` ``(B, K)`` int32 on the
    device; ``cols`` ``(K,)`` int32 names each column (a query column or
    an accept-lane class; ``-1`` discards the column's hits).  The hits
    are compacted in row-major order into ``cap``-row buffers
    (:func:`~repro_torch.kernels.ref.compact_rows`), so the host reads
    ``3 × cap`` int32 and one count.  Returns ``(doc, col, first,
    count)``; ``count > cap`` means the buffers were truncated and the
    caller must recompute densely.
    """
    hits = matched & (cols >= 0)[None, :]
    doc = torch.arange(hits.shape[0], dtype=torch.int32,
                       device=hits.device)[:, None].expand(hits.shape)
    (bdoc, bcol, bfirst), count = compact_rows(
        hits.reshape(-1), (doc, cols[None, :].expand(hits.shape), first),
        (-1, -1, NO_MATCH), cap)
    return bdoc, bcol, bfirst, count


#: default event-axis padding bucket of the byte-ingest paths; an engine
#: created with ``event_bucket=`` (``FilterStage`` passes its own
#: ``bucket``) overrides it
DEFAULT_EVENT_BUCKET = 128


#: the JAX package's default per-program VMEM budget, which sizes its
#: default state blocks (``REPRO_PALLAS_VMEM_BUDGET`` unset)
_TPU_VMEM_BUDGET = 4 << 20


#: engine options the JAX package has and the port does not yet, with the
#: ROADMAP queue item that ports each
NOT_PORTED = {
    "minimize": "queue 1 item 7 (minimized and sharded plans)",
    "plan_cache": "queue 1 item 10 (plan cache)",
    "vmem_budget": "queue 1 item 11 (H100 launch-shape policy)",
    "smem_budget": "queue 1 item 11 (H100 launch-shape policy)",
    "autotune": "queue 1 item 11 (measured autotune)",
    "kernel": "queue 1 item 9 (one execution path per engine so far)",
    "kernel_interpret": "nothing: Pallas interpret mode has no CUDA twin",
}


# ----------------------------------------------------------------- the plan
class FilterPlan:
    """Frozen plan: named tensors on one device + static metadata."""

    __slots__ = ("engine", "device", "_tables", "_meta")

    def __init__(self, engine: str, tables: Mapping[str, torch.Tensor],
                 meta: Mapping[str, Any] | None = None) -> None:
        devices = {t.device for t in tables.values()}
        if len(devices) > 1:
            raise ValueError(f"plan tables span devices {sorted(map(str, devices))}")
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "device",
                           devices.pop() if devices else torch.device("cpu"))
        object.__setattr__(self, "_tables", dict(tables))
        object.__setattr__(self, "_meta", dict(meta or {}))

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("FilterPlan is frozen")

    @property
    def tables(self) -> dict[str, torch.Tensor]:
        return dict(self._tables)

    @property
    def meta(self) -> dict[str, Any]:
        return dict(self._meta)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._tables[name]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FilterPlan({self.engine!r}, device={self.device}, "
                f"tables={sorted(self._tables)}, meta={self._meta})")


# --------------------------------------------------------------- the engine
class FilterEngine(abc.ABC):
    """Uniform engine interface: compile once, filter batches forever."""

    #: registry key, set by the :func:`register` decorator
    name: ClassVar[str] = ""

    #: state-axis pad multiple of this engine's plan tables
    state_multiple: ClassVar[int] = 1

    def __init__(self, nfa: NFA, dictionary=None, *,
                 device: str | torch.device = "cuda", **options: Any) -> None:
        for key in options:
            if key in NOT_PORTED:
                raise NotImplementedError(
                    f"engine option {key}= is not ported yet: "
                    f"{NOT_PORTED[key]}")
        self.dictionary = dictionary
        self.device = torch.device(device)
        self.nfa = nfa
        self.options = options
        self.n_queries = nfa.n_queries
        self.plan_: FilterPlan = self.plan(nfa)

    # ------------------------------------------------------------ contract
    @abc.abstractmethod
    def plan(self, nfa: NFA) -> FilterPlan:
        """Compile the NFA into this engine's device tables (once)."""

    @abc.abstractmethod
    def filter_batch(self, batch: EventBatch) -> FilterResult:
        """Filter a document batch; returns a ``(B, Q)`` result."""

    @abc.abstractmethod
    def device_verdicts(self, batch: EventBatch
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, Q)`` matched (bool) and first (int32) tensors of a batch,
        left on the device (what :meth:`filter_batch` brings back)."""

    def filter_bytes(self, bb: ByteBatch, *,
                     bucket: int | None = None) -> FilterResult:
        """Raw wire bytes → ``(B, Q)`` verdicts, parsed on the device.

        The batch is parsed by :func:`repro_torch.kernels.parse.
        parse_batch` and fed to :meth:`filter_batch` as an `EventBatch`
        of device tensors.  The parse honours the engine's ``max_depth``
        and raises :class:`~repro_torch.core.events.DepthOverflow` on
        documents nested deeper.  ``bucket`` pads the event axis;
        ``None`` resolves through :meth:`_event_bucket`.  Engines with a
        one-launch bytes path override this.
        """
        return self.filter_batch(self._parse(bb, bucket))

    def _parse(self, bb: ByteBatch, bucket: int | None) -> EventBatch:
        from ...kernels.parse import parse_batch

        return parse_batch(
            bb, n_events=bb.event_bound(bucket=self._event_bucket(bucket)),
            max_depth=int(getattr(self, "max_depth", DEFAULT_MAX_DEPTH)),
            device=self.device)

    def _event_bucket(self, bucket: int | None) -> int:
        """The event-axis padding bucket of the byte paths: the argument,
        else the ``event_bucket=`` option (``FilterStage`` sets it to its
        own ``bucket``), else :data:`DEFAULT_EVENT_BUCKET`."""
        if bucket is not None:
            return int(bucket)
        return int(self.options.get("event_bucket", DEFAULT_EVENT_BUCKET))

    # ------------------------------------------------- sparse verdict path
    def match_cap(self, batch_size: int, n_cols: int,
                  cap: int | None = None) -> int:
        """The bounded match-buffer size of one sparse call.

        The argument wins, then the ``match_cap=`` option; the default
        budgets 32 matches per document (at least 4096).  Clamped to the
        dense size, past which the buffer cannot overflow.
        """
        if cap is None:
            cap = self.options.get("match_cap")
        if cap is None:
            cap = max(4096, 32 * batch_size)
        return int(max(1, min(int(cap), batch_size * max(1, n_cols))))

    def _sparse_from_buffers(self, bufs, count: int, cap: int, *,
                             batch_size: int, n_queries: int,
                             meta: dict | None = None,
                             dense_fallback=None) -> SparseResult:
        """A :class:`SparseResult` from :func:`_compact_matches` output.

        Only the first ``count`` rows of ``bufs`` are real.  ``count >
        cap`` means the buffer overflowed: the verdicts are recomputed by
        ``dense_fallback()``, exact, flagged ``overflowed`` and named
        ``path="dense-overflow"``, with the route that was tried kept as
        ``attempted_path``.
        """
        meta = dict(meta or (), match_cap=cap)
        if count > cap:
            sp = dense_fallback().sparsify()
            sp.overflowed = True
            sp.meta.update(meta, matches=count,
                           attempted_path=meta.get("path"),
                           path="dense-overflow")
            return sp
        docs, cols, first = (b[:count].cpu().numpy() for b in bufs)
        return SparseResult(docs, cols, first, batch_size=batch_size,
                            n_queries=n_queries, meta=meta)

    def filter_batch_sparse(self, batch: EventBatch, *,
                            match_cap: int | None = None) -> SparseResult:
        """Sparse twin of :meth:`filter_batch`: the dense verdict is
        compacted on the device (:func:`_compact_matches`), and the host
        reads a bounded ``(doc, query, first)`` list instead of the
        ``(B, Q)`` bitmap (``path="device-compact"``).
        :meth:`SparseResult.densify` gives back :meth:`filter_batch`."""
        matched, first = self.device_verdicts(batch)
        b, q = batch.batch_size, int(matched.shape[-1])
        cap = self.match_cap(b, q, match_cap)
        *bufs, n = _compact_matches(
            matched, first,
            torch.arange(q, dtype=torch.int32, device=matched.device), cap)
        return self._sparse_from_buffers(
            bufs, int(n), cap, batch_size=b, n_queries=q,
            meta={"path": "device-compact"},
            dense_fallback=lambda: FilterResult(matched.cpu().numpy(),
                                                first.cpu().numpy()))

    def filter_bytes_sparse(self, bb: ByteBatch, *,
                            bucket: int | None = None,
                            match_cap: int | None = None) -> SparseResult:
        """Bytes in, sparse match list out: device parse (raising
        :class:`~repro_torch.core.events.DepthOverflow` past
        ``max_depth``), then :meth:`filter_batch_sparse`."""
        return self.filter_batch_sparse(self._parse(bb, bucket),
                                        match_cap=match_cap)

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        """Stage a host array on this engine's device.

        On a card the array is copied once into pinned host memory and
        sent with a ``non_blocking`` copy on the current stream, so the
        transfer overlaps host work until a kernel on that stream needs
        it; on the CPU the tensor shares the array's memory.
        """
        array = np.ascontiguousarray(array)
        t = torch.from_numpy(array if array.flags.writeable else array.copy())
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # ---------------------------------------------- kernel autotune hook
    @staticmethod
    def autotune_blocks(n_states: int, max_depth: int, *,
                        n_tags: int) -> dict:
        """Pick the state-block size ``blk`` from static bounds.

        The JAX package's static policy at its default budget, copied so
        that a plan's default block layout equals the reference's:
        ``blk`` is the largest power-of-two candidate whose per-block
        footprint — packed-word stack, per-tag word masks, parent gather
        lanes — fits the TPU's 4 MiB VMEM budget, clamped to the padded
        state count.  A policy sized for the H100's shared memory is
        ROADMAP queue 1 item 11.
        """
        blk = 32
        for cand in (1024, 512, 256, 128, 64, 32):
            wb = cand // 32
            need = 4 * ((max_depth + 2) * wb    # packed-word stack
                        + (n_tags + 1) * wb     # per-tag word masks
                        + 2 * 32 * wb           # parent word/bit lanes
                        + 4 * wb)               # state/work rows
            if need <= _TPU_VMEM_BUDGET:
                blk = cand
                break
        return {"blk": min(blk, _round_up(max(n_states, 1), 32))}


# -------------------------------------------------------------- the registry
_REGISTRY: dict[str, type[FilterEngine]] = {}


def register(name: str):
    """Class decorator: make the engine constructible by string key."""

    def deco(cls: type[FilterEngine]) -> type[FilterEngine]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> type[FilterEngine]:
    """Engine class for ``name`` (raises with the known names on miss)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"engine {name!r} is not ported (ROADMAP queue 1 item 9); "
            f"ported: {sorted(_REGISTRY)}") from None


def create(name: str, nfa: NFA, dictionary=None,
           **options: Any) -> FilterEngine:
    """Construct a registered engine: ``create('streaming', nfa)``."""
    return get(name)(nfa, dictionary=dictionary, **options)


def names() -> tuple[str, ...]:
    """All registered engine keys, sorted."""
    return tuple(sorted(_REGISTRY))
