"""Public wrappers over the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``, with the same names and
arguments:

* :func:`predecode` — K5 over a byte array (:mod:`.predecode`);
* :func:`nfa_transition` — one levelwise step, K6 (:mod:`.nfa_transition`),
  given the parent as the one-hot the JAX package's kernel multiplies by;
* :func:`decode_document` — one document's bytes → its event stream: K5,
  then the compaction of the positions that start a tag;
* :class:`StreamFilterKernelEngine` — K1 behind a one-document API, a
  thin wrapper over the port's :class:`~repro_torch.core.engines.
  streaming.StreamingEngine`.

Inputs that are not tensors go to ``device``: the card unless the caller
asks for ``"cpu"``, where the kernels' plain versions run.  A tensor stays
where it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dictionary import TagDictionary
from ..core.engines.result import FilterResult
from ..core.events import DEFAULT_MAX_DEPTH, EventBatch, EventStream
from ..core.xpath import Query
from . import nfa_transition as nt
from . import ref
from .predecode import predecode as _predecode


def _tensor(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    return x if dtype is None else x.to(dtype)


def predecode(bytes_, *, device: str | torch.device = "cuda"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L) uint8 → per-position (kind, tag) int32 (``PAD`` and -1 off
    tags), by K5 on the card."""
    return _predecode(_tensor(bytes_, device, torch.uint8))


def nfa_transition(parent_rows, tags, req, wild, parent_1h, selfloop, *,
                   bw: int | None = None, bs: int | None = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """One levelwise step of W nodes over S states → (W, S) float32.

    The JAX package's signature: the parent comes as the (S, S) one-hot
    ``parent_1h``, which :func:`~repro_torch.kernels.nfa_transition.
    parent_index` turns into the index K6 gathers by (it raises unless
    every column holds exactly one 1, the form :meth:`~repro_torch.core.
    nfa.NFA.parent_onehot` gives, pad states included).  ``bw`` and ``bs``
    are the TPU kernel's node and state tiles; K6 masks ragged W and S
    edges itself, so it takes no tiles, and they are accepted and
    ignored.
    """
    del bw, bs
    f32 = torch.float32
    rows = _tensor(parent_rows, device, f32)
    dev = rows.device
    parent_idx = nt.parent_index(_tensor(parent_1h, dev))
    return nt.nfa_transition(
        rows.contiguous(), _tensor(tags, dev, torch.int32).contiguous(),
        _tensor(req, dev, f32).contiguous(),
        _tensor(wild, dev, f32).contiguous(), parent_idx,
        _tensor(selfloop, dev, f32).contiguous())


def decode_document(buf: bytes, dictionary: TagDictionary, *,
                    device: str | torch.device = "cuda") -> EventStream:
    """One document's paper-format bytes → its :class:`EventStream`: K5
    classifies every position on the device, the positions that start a
    tag are compacted there in order, and only the events come back.
    ``dictionary`` is accepted as in the JAX package (the byte format
    encodes tag ids, so decoding does not read it)."""
    del dictionary
    data = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy())
    kind, tag = _predecode(data.to(device))
    keep = kind != ref.PAD
    return EventStream(kind[keep].to(torch.int8).cpu().numpy(),
                       tag[keep].cpu().numpy())


class StreamFilterKernelEngine:
    """One-document filtering through K1 (the Fig. 5 layout).

    Queries compile to one shared NFA, laid out in parent-closed
    word-aligned state blocks (``blk`` states each, grown to the plan's
    least parent-closed block) and advanced over each document's events
    by K1; accept lanes map back to query ids.  A thin wrapper over the
    port's ``StreamingEngine``, where the batched, sharded and byte paths
    live.
    """

    def __init__(self, queries: list[Query], dictionary: TagDictionary,
                 blk: int = 256, max_depth: int = DEFAULT_MAX_DEPTH, *,
                 device: str | torch.device = "cuda") -> None:
        from ..core.engines.streaming import StreamingEngine
        from ..core.nfa import compile_queries

        self.max_depth = max_depth
        self._eng = StreamingEngine(
            compile_queries(list(queries), dictionary, shared=True),
            dictionary, max_depth=max_depth, device=device, blk=blk)
        self.n_queries = self._eng.n_queries

    def filter_document(self, ev: EventStream) -> FilterResult:
        return self._eng.filter_batch(EventBatch.from_streams([ev]))[0]
