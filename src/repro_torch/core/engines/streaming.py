"""Streaming engine of the port: the megakernels behind one engine.

Counterpart of ``src/repro/core/engines/streaming.py``.  Every NFA state
is one bit of a packed 32-bit word; each event advances every state at
once; a bounded stack of packed words realises the paper's tag stack.
The plan lays the states out in word-aligned blocks closed under parent
pointers (:func:`repro_torch.kernels.blocks.state_layout`), and two
hand-written kernels run them (:mod:`repro_torch.kernels.stream_filter`):

* :meth:`StreamingEngine.filter_batch` — host-parsed events through K1,
  one thread block per (document, state block);
* :meth:`StreamingEngine.filter_bytes` — raw wire bytes through K2, one
  launch from bytes to accept lanes, either one document per segment or
  segment-packed (``pack=True``) so short documents share a slot.

The accept-lane → query gather (the paper's priority encoder) and the
scatter of packed slots back to batch order follow each launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels import blocks as blocks_mod
from ...kernels import stream_filter as sf
from ..events import (DEFAULT_MAX_DEPTH, SEG_SENTINEL, ByteBatch, EventBatch,
                      SegmentPack, pack_segments)
from ..nfa import NFA, pad_states
from . import base
from .result import NO_MATCH, FilterResult

#: the segment packer's capacity target, as the JAX package sets it
DEFAULT_SEGMENT_TARGET = 4096

#: TPU grid iteration orders; accepted so the option matches, ignored here
GRID_ORDERS = ("bg", "gb")

#: launch-shape options; ``grid_order`` orders the TPU's sequential grid
#: and is kept in the plan's metadata only, the CUDA grid has no order
TUNABLE_KEYS = ("blk", "grid_order", "segment_target")


@base.register("streaming")
class StreamingEngine(base.FilterEngine):
    """Compile once (``plan``), filter many documents on ``device``.

    Engine options (the JAX engine's, where ported):

    * ``blk=`` / ``grid_order=`` / ``segment_target=`` — launch shape;
      defaults follow the JAX package's static policy so the layouts
      are equal.
    * ``pack=`` — segment-pack byte batches by default in
      :meth:`filter_bytes`.
    * ``fuse=`` — only ``True``, the one-launch bytes path; the two-stage
      parse-then-filter path is ROADMAP queue 1 item 8.
    """

    #: packed-word layout: the state axis must tile into 32-bit words
    state_multiple = 32

    def __init__(self, nfa: NFA, dictionary=None,
                 max_depth: int = DEFAULT_MAX_DEPTH, *,
                 device: str | torch.device = "cuda", **options) -> None:
        self.max_depth = int(max_depth)
        if not options.get("fuse", True):
            raise NotImplementedError(
                "fuse=False (parse, then filter) is not ported yet: "
                "ROADMAP queue 1 item 8")
        options.pop("fuse", None)
        known = set(TUNABLE_KEYS) | {"pack"}
        unknown = sorted(set(options) - known - set(base.NOT_PORTED))
        if unknown:
            raise TypeError(f"unknown streaming engine options {unknown}")
        super().__init__(nfa, dictionary, device=device, **options)

    def kernel_config(self, n_states: int, n_tags: int) -> dict:
        """Launch shape: the static policy, then explicit options."""
        cfg = self.autotune_blocks(n_states, self.max_depth, n_tags=n_tags)
        cfg.update(grid_order="bg", segment_target=DEFAULT_SEGMENT_TARGET)
        cfg.update({k: self.options[k] for k in TUNABLE_KEYS
                    if k in self.options})
        if cfg["grid_order"] not in GRID_ORDERS:
            raise ValueError(f"grid_order={cfg['grid_order']!r} is not one "
                             f"of {GRID_ORDERS}")
        return {"blk": int(cfg["blk"]), "grid_order": cfg["grid_order"],
                "segment_target": max(1, int(cfg["segment_target"]))}

    def plan(self, nfa: NFA) -> base.FilterPlan:
        from ...convert import plan_from_numpy  # convert imports this package

        nfa = pad_states(nfa, self.state_multiple)
        cfg = self.kernel_config(nfa.n_states, nfa.n_tags)
        mk = blocks_mod.state_layout(nfa, blk=cfg["blk"])
        tables = dict(kb_tagmask=mk.tagmask, kb_pw=mk.pw, kb_pb=mk.pb,
                      kb_selfloop=mk.selfloop_words, kb_init=mk.init_words,
                      kb_acc_word=mk.acc_word, kb_acc_bit=mk.acc_bit,
                      kb_acc_block=mk.acc_block, kb_acc_slot=mk.acc_slot)
        meta = dict(cfg, n_states=nfa.n_states, max_depth=self.max_depth,
                    state_multiple=self.state_multiple, blk=mk.blk,
                    n_blocks=mk.n_blocks, block_queries=mk.block_queries)
        return plan_from_numpy(tables, meta, self.device)

    # ----------------------------------------------------------- launches
    def _block_tables(self) -> tuple[torch.Tensor, ...]:
        p = self.plan_
        return (p["kb_tagmask"], p["kb_pw"], p["kb_pb"], p["kb_selfloop"],
                p["kb_init"], p["kb_acc_word"], p["kb_acc_bit"])

    def _lanes_to_queries(self, mb: torch.Tensor, fb: torch.Tensor
                          ) -> tuple[np.ndarray, np.ndarray]:
        """(..., G, QB) accept lanes → (..., Q) host verdicts."""
        ab, sl = self.plan_["kb_acc_block"], self.plan_["kb_acc_slot"]
        matched = mb[..., ab, sl] != 0
        return matched.cpu().numpy(), fb[..., ab, sl].cpu().numpy()

    def filter_batch(self, batch: EventBatch) -> FilterResult:
        """Host-parsed events → ``(B, Q)`` verdicts through K1."""
        events = sf.fuse_events(torch.from_numpy(batch.kind),
                                torch.from_numpy(batch.tag_id))
        mb, fb = sf.stream_filter(
            self.to_device(events.numpy()), *self._block_tables(),
            max_depth=self.plan_.meta["max_depth"])
        return FilterResult(*self._lanes_to_queries(mb, fb))

    def _bytes_prep(self, bb: ByteBatch, pack: bool | None
                    ) -> tuple[np.ndarray, np.ndarray, SegmentPack | None]:
        """(data, starts, pack-or-None) for the one-launch kernel: the
        host segment packer, or one degenerate segment per document whose
        only boundary is the sentinel."""
        if pack is None:
            pack = bool(self.options.get("pack", False))
        if pack:
            sp = pack_segments(
                bb, target_len=int(self.plan_.meta["segment_target"]))
            return sp.data, sp.starts, sp
        starts = np.full((bb.batch_size, 2), SEG_SENTINEL, np.int32)
        starts[:, 0] = 0
        return bb.data, starts, None

    def filter_bytes(self, bb: ByteBatch, *,
                     pack: bool | None = None) -> FilterResult:
        """Raw wire bytes → ``(B, Q)`` verdicts in one K2 launch."""
        data, starts, sp = self._bytes_prep(bb, pack)
        mb, fb = sf.stream_filter_bytes(
            self.to_device(data), self.to_device(starts),
            *self._block_tables(), max_depth=self.plan_.meta["max_depth"])
        # (S, G, D, QB) → (S, D, G, QB) → (S, D, Q)
        m, f = self._lanes_to_queries(mb.transpose(1, 2), fb.transpose(1, 2))
        if sp is None:
            return FilterResult(m[:, 0], f[:, 0])
        return FilterResult(*sp.scatter(m, f, NO_MATCH))
