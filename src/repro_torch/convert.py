"""Carry a streaming plan's numpy tables into a port :class:`FilterPlan`.

:func:`plan_from_numpy` takes the block tables of a streaming plan as
numpy arrays — the port's own (``StreamingEngine.plan``) or those of a
JAX ``FilterPlan`` after ``np.asarray`` — and places them on a device, so
the port can run on exactly the tables another build produced.  Only the
``kb_*`` block tables are read; a plan without them (a scan-only plan)
is refused.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.engines.base import FilterPlan
from .kernels.stream_filter import check_block_tables

#: the block tables the megakernels and the lane → query gather read
BLOCK_TABLES = ("kb_tagmask", "kb_pw", "kb_pb", "kb_selfloop", "kb_init",
                "kb_acc_word", "kb_acc_bit", "kb_acc_block", "kb_acc_slot")

#: plan metadata the port reads
META_KEYS = ("max_depth", "n_states", "state_multiple", "blk", "n_blocks",
             "block_queries", "grid_order", "segment_target")


def _as_int32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        return x.view(np.int32)        # packed words: a bit view, no copy
    if x.dtype.kind not in "iu" or x.size and (
            x.min() < -2 ** 31 or x.max() >= 2 ** 31):
        raise ValueError(f"table of dtype {x.dtype} does not fit int32")
    return x.astype(np.int32)


def plan_from_numpy(tables: Mapping[str, Any], meta: Mapping[str, Any],
                    device: str | torch.device) -> FilterPlan:
    """Streaming plan tables (numpy, uint32 words) → port plan on ``device``.

    ``meta`` must carry ``max_depth``; the launch-shape keys of
    :data:`META_KEYS` are kept when present.  Block tables are checked
    for shape agreement and in-block indices before they reach a kernel.
    """
    missing = [k for k in BLOCK_TABLES if k not in tables]
    if missing:
        raise ValueError(f"plan has no megakernel block tables {missing}; "
                         f"build it with the block layout (a JAX streaming "
                         f"engine with kernel='pallas')")
    if "max_depth" not in meta:
        raise ValueError("plan meta has no max_depth")
    arrays = {k: _as_int32(np.asarray(tables[k])) for k in BLOCK_TABLES}
    g, t1, wb = arrays["kb_tagmask"].shape
    qb = arrays["kb_acc_word"].shape[1]
    want = {"kb_pw": (g, wb, 32), "kb_pb": (g, wb, 32),
            "kb_selfloop": (g, wb), "kb_init": (g, wb),
            "kb_acc_word": (g, qb), "kb_acc_bit": (g, qb)}
    for k, shape in want.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, expected "
                             f"{shape}")
    ab, sl = arrays["kb_acc_block"], arrays["kb_acc_slot"]
    if ab.shape != sl.shape or ab.ndim != 1:
        raise ValueError("kb_acc_block / kb_acc_slot must be equal (Q,)")
    if ab.size and (ab.min() < 0 or ab.max() >= g or sl.min() < 0
                    or sl.max() >= qb):
        raise ValueError("accept lane → query tables leave the (G, QB) grid")
    check_block_tables(arrays)
    dev = torch.device(device)
    placed = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in arrays.items()}
    keep = {k: meta[k] for k in META_KEYS if k in meta}
    keep["max_depth"] = int(meta["max_depth"])
    return FilterPlan("streaming", placed, keep)
