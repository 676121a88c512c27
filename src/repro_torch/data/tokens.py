# Copy of src/repro/data/tokens.py (the port imports nothing of the JAX package).
"""Deterministic synthetic LM token pipeline.

Generates reproducible token batches for the training examples / smoke
tests without external data: a per-shard counter-based PRNG (threefry via
jax would pull device state; we use numpy Philox keyed by (seed, step,
shard)) so every data-parallel shard sees a disjoint stream and restarts
are exactly resumable from the step counter — the property checkpoint
restore relies on.

Optionally the stream is fed from the XML filter stage: documents that
match routing profiles are serialized (paper-format bytes) and tokenized
at the byte level — the pub-sub path feeding the LM, end to end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..core.events import EventStream, encode_bytes


@dataclass
class TokenPipeline:
    vocab: int
    batch: int            # per-host batch (sequences)
    seq_len: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for a given step — pure function of (seed, step, shard)."""
        bits = np.random.Philox(
            key=np.uint64(self.seed),
            counter=[0, 0, np.uint64(self.shard), np.uint64(step)])
        rng = np.random.Generator(bits)
        tokens = rng.integers(
            0, self.vocab, size=(self.batch, self.seq_len + 1),
            dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class XMLBytePipeline:
    """Byte-level tokens from filtered XML documents (filter stage output).

    Tokens are raw bytes of the paper-format serialized documents (vocab
    256), padded/packed to seq_len.  Demonstrates the paper's filter as
    the ingest stage of LM training (examples/train_lm.py --data-filter).

    Input is either parsed event streams (``docs``, serialized here) or
    raw wire-byte payloads (``payloads``) — the latter is what
    :meth:`from_filtered_bytes` produces: payloads routed through
    ``FilterStage.route_bytes`` (parsed *and* filtered on device) with
    only the matched documents kept, so the whole ingest side of the LM
    pipeline is the paper's same-chip dataflow.
    """

    docs: list[EventStream] | None
    batch: int
    seq_len: int
    text_fill: int = 4
    payloads: list[bytes] | None = None

    def __post_init__(self) -> None:
        if (self.docs is None) == (self.payloads is None):
            raise ValueError("pass exactly one of docs= or payloads=")
        bufs = (self.payloads if self.payloads is not None else
                [encode_bytes(d, text_fill=self.text_fill)
                 for d in self.docs])
        self._buf = np.concatenate(
            [np.frombuffer(b, np.uint8) for b in bufs]).astype(np.int32)

    @classmethod
    def from_filtered_bytes(cls, payloads: list[bytes], stage, batch: int,
                            seq_len: int) -> "XMLBytePipeline":
        """Device-filter raw payloads, keep the matched ones, tokenize.

        ``stage`` is a :class:`~repro.data.filter_stage.FilterStage`;
        payloads that match no standing profile are dropped (unless the
        stage keeps unmatched docs), exactly like pub-sub delivery.
        """
        keep = sorted({r.doc_index for routed in stage.route_bytes(payloads)
                       for r in routed})
        kept = [payloads[i] for i in keep]
        if not kept:
            raise ValueError("no payloads matched the standing profiles")
        return cls(docs=None, batch=batch, seq_len=seq_len, payloads=kept)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        need = self.batch * (self.seq_len + 1)
        start = (step * need) % max(1, len(self._buf) - need - 1)
        chunk = self._buf[start:start + need]
        if len(chunk) < need:
            chunk = np.pad(chunk, (0, need - len(chunk)))
        tok = chunk.reshape(self.batch, self.seq_len + 1)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
