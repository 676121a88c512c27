"""The engine contract of the port: ``FilterPlan``, ``FilterEngine``, registry.

Counterpart of ``src/repro/core/engines/base.py`` (lines 122-175,
624-728, 890-944, 1445-1474), for engines whose compiled tables are torch
tensors on one device:

* :class:`FilterPlan` — a frozen dict of tensors on one device plus
  static metadata, built once per profile set by :meth:`FilterEngine.plan`.
* :class:`FilterEngine` — compile once, then ``filter_batch`` (events)
  and ``filter_bytes`` (raw wire bytes) into ``(B, Q)`` results.  Every
  entry point runs on ``device`` (``"cuda"`` unless the caller asks for
  ``"cpu"``, where the kernels' plain versions run).
* the registry — the port's own :func:`register` / :func:`create` /
  :func:`names`, separate from the JAX package's.
"""
from __future__ import annotations

import abc
from typing import Any, ClassVar, Mapping

import numpy as np
import torch

from ..events import ByteBatch, EventBatch
from ..nfa import NFA
from .result import FilterResult


def _round_up(n: int, multiple: int) -> int:
    multiple = max(1, int(multiple))
    return max(multiple, -(-n // multiple) * multiple)


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
    "sparse_epilogue": "queue 1 item 5 (sparse delivery)",
    "ep_tile": "queue 1 item 5 (sparse delivery)",
    "match_cap": "queue 1 item 5 (sparse delivery)",
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
    def filter_bytes(self, bb: ByteBatch) -> FilterResult:
        """Raw wire bytes → ``(B, Q)`` result, decoded on the device."""

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
