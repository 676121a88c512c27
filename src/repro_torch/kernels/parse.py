"""Device parse: raw byte batches → event batches that stay on the device.

Counterpart of ``src/repro/kernels/parse.py`` (lines 80-216).  A
:class:`~repro_torch.core.events.ByteBatch` becomes an
:class:`~repro_torch.core.events.EventBatch` of torch tensors on the
batch's device, with no per-event host Python:

1. **pre-decode** — every byte position classified into (kind, tag) by
   K5 (:func:`repro_torch.kernels.predecode.predecode`);
2. **compaction** — each row's hits packed into a dense event list by
   cumsum indexing (event *i* lands at the number of hits before it);
3. **depth** — a ``+1/-1`` prefix sum floored at zero like a
   pop-on-empty stack (running sum minus its clipped running minimum);
4. **parent pointers** — "last OPEN seen at each depth" over the
   ``(N, max_depth + 2)`` table of published event indices, and every
   OPEN reads slot ``depth - 1``.

Every function runs on its input's device: the card unless the caller
hands it CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.events import (DEFAULT_MAX_DEPTH, ByteBatch, DepthOverflow,
                           EventBatch, bucket_length)
from . import ref
from .predecode import predecode


def compact_events(kind_pos: torch.Tensor, tag_pos: torch.Tensor,
                   n_events: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-position hits ``(B, L)`` → the first ``n_events`` events of each
    row in order, padded with PAD / -1: kind (B, n_events) int8, tag
    (B, n_events) int32, and the events kept per row (B,) int32."""
    b = kind_pos.shape[0]
    keep = kind_pos != ref.PAD
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    idx = torch.where(keep & (pos < n_events), pos, n_events)  # n_events: drop
    kind = torch.full((b, n_events + 1), ref.PAD, dtype=torch.int8,
                      device=kind_pos.device)
    kind.scatter_(1, idx, kind_pos.to(torch.int8))
    tag = torch.full((b, n_events + 1), -1, dtype=torch.int32,
                     device=kind_pos.device)
    tag.scatter_(1, idx, tag_pos.to(torch.int32))
    n = torch.clamp(keep.sum(1), max=n_events).to(torch.int32)
    return kind[:, :n_events].contiguous(), tag[:, :n_events].contiguous(), n


def structure_scan(kind: torch.Tensor, max_depth: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-event (depth, parent) of a ``(B, N)`` event-kind batch.

    The JAX package carries "last OPEN at each depth" with an associative
    scan that keeps the later of two published indices.  Published
    indices are event positions, which only grow along the event axis, so
    the later one is also the larger one and the scan is a running
    maximum: ``torch.cummax`` over the table, with -1 where nothing is
    published.  The table is ``(B, N, max_depth + 2)`` int32, plus
    cummax's int64 indices.
    """
    b, n = kind.shape
    dev = kind.device
    is_open = kind == ref.OPEN
    is_close = kind == ref.CLOSE
    delta = torch.where(is_open, 1, torch.where(is_close, -1, 0)).to(
        torch.int32)
    s = torch.cumsum(delta, 1, dtype=torch.int32)
    floor = torch.clamp(torch.cummin(s, 1).values, max=0)
    depth = (s - floor).to(torch.int32)

    d_slots = max_depth + 2
    d_pub = torch.clamp(depth, 0, d_slots - 1).long()
    levels = torch.arange(d_slots, device=dev)
    event_idx = torch.arange(n, dtype=torch.int32, device=dev)
    pub = torch.where(is_open[..., None] & (levels == d_pub[..., None]),
                      event_idx[None, :, None], -1)
    last_open_at = torch.cummax(pub, 1).values
    del pub
    lookup = torch.clamp(d_pub - 1, 0, d_slots - 1)
    parent = torch.where(is_open,
                         last_open_at.gather(2, lookup[..., None])[..., 0],
                         -1).to(torch.int32)
    return depth, parent


def parse_arrays(data: torch.Tensor, *, n_events: int,
                 max_depth: int = DEFAULT_MAX_DEPTH):
    """(B, L) uint8 bytes → ``(kind, tag, depth, parent, valid, n)`` on the
    bytes' device: K5, then compaction and the structure scans."""
    kind_pos, tag_pos = predecode(data)
    kind, tag, n = compact_events(kind_pos, tag_pos, n_events)
    depth, parent = structure_scan(kind, max_depth)
    return kind, tag, depth, parent, kind != ref.PAD, n


def parse_batch(bb: ByteBatch, *, n_events: int | None = None,
                bucket: int | None = None,
                max_depth: int = DEFAULT_MAX_DEPTH,
                check_depth: bool = True,
                device: str | torch.device = "cuda") -> EventBatch:
    """Device parse: :class:`ByteBatch` → an `EventBatch` of tensors.

    The bytes go to ``device`` and the batch's fields stay there, so an
    engine on the same device takes it with no host round trip.
    ``n_events`` defaults to the static bound ``bb.max_events``
    (optionally bucketed).  Parent
    pointers are exact only up to ``max_depth``: ``check_depth=True``
    raises :class:`DepthOverflow` naming the documents nested deeper, one
    (B,) transfer to the host; ``check_depth=False`` clips silently.
    """
    if n_events is None:
        n_events = bucket_length(bb.max_events, bucket)
    data = torch.from_numpy(np.ascontiguousarray(bb.data)).to(device)
    kind, tag, depth, parent, valid, n_per_doc = parse_arrays(
        data, n_events=n_events, max_depth=max_depth)
    if check_depth:
        per_doc = depth.max(1).values.cpu().numpy() if depth.numel() \
            else np.zeros(depth.shape[0], np.int32)
        dmax = int(per_doc.max(initial=0))
        if dmax > max_depth:
            bad = [int(i) for i in (per_doc > max_depth).nonzero()[0]]
            raise DepthOverflow(
                f"document nesting depth {dmax} exceeds max_depth="
                f"{max_depth} (documents {bad}); re-parse with "
                f"parse_batch(..., max_depth={dmax}) or larger",
                doc_indices=bad)
    return EventBatch(kind, tag, depth, parent, valid, n_per_doc)
