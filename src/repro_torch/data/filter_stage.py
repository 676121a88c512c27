"""Pub-sub content routing as a pipeline stage, on the port's engines.

Counterpart of ``src/repro/data/filter_stage.py`` for one shard of the
subscription set with dense verdicts: a stream of documents is matched
against standing profiles and each document is routed to every data
shard that holds a matching subscription.  :meth:`FilterStage.route`
takes host-parsed event streams, :meth:`FilterStage.route_bytes` raw
paper-format byte payloads decoded on the device by the engine's
``filter_bytes``.  Engines come from the port's registry; subscription
churn, query and data sharding, pipelined dispatch and sparse delivery
are ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..core import engines
from ..core.dictionary import TagDictionary
from ..core.engines import FilterResult
from ..core.events import (ByteBatch, EventBatch, EventStream,
                           event_stream_nbytes)
from ..core.nfa import NFA, compile_queries
from ..core.xpath import Query, parse

TEXT_FILL = 8  # filler text bytes per element in the MB/s accounting


@dataclass
class RoutedDocument:
    doc_index: int
    matched_profiles: np.ndarray       # (n_matched,) int32 profile indices
    shard: int                         # destination data shard
    nbytes: int


@dataclass
class FilterStage:
    """Standing-profile filter + router over a registered port engine.

    ``shard_of_profile[q]`` maps each subscription to a destination shard
    (defaults to round-robin).  A document goes to every shard that has at
    least one matching subscription; unmatched documents are dropped
    (classic pub-sub) or sent to shard 0 with ``keep_unmatched=True``.
    ``bucket`` pads each event batch to a multiple of that length,
    ``byte_bucket`` each byte batch; ``device`` is where the engine runs.
    """

    profiles: Sequence[Query]
    dictionary: TagDictionary
    n_shards: int = 1
    engine: str = "streaming"
    keep_unmatched: bool = False
    batch_size: int = 32
    bucket: int = 128
    byte_bucket: int = 1024
    device: str = "cuda"
    shard_of_profile: np.ndarray = field(default=None)  # type: ignore
    stats: dict = field(default_factory=dict)
    #: extra engine options (e.g. ``{"pack": True}``)
    engine_options: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if isinstance(self.profiles[0], str):
            self.profiles = [parse(p) for p in self.profiles]
        self.nfa: NFA = compile_queries(list(self.profiles), self.dictionary,
                                        shared=True)
        self._eng = engines.create(self.engine, self.nfa,
                                   dictionary=self.dictionary,
                                   device=self.device,
                                   **self.engine_options)
        if self.shard_of_profile is None:
            self.shard_of_profile = (
                np.arange(len(self.profiles)) % self.n_shards).astype(np.int32)
        self.stats = {"batches": 0, "docs": 0, "bytes": 0,
                      "seconds": 0.0, "pair_matches": 0, "pairs": 0}

    # ----------------------------------------------------------------- run
    def _filter_batch(self, docs: list[EventStream]) -> FilterResult:
        batch = EventBatch.from_streams(docs, bucket=self.bucket)
        t0 = time.perf_counter()
        res = self._eng.filter_batch(batch)
        self._record(res, batch.batch_size,
                     int(batch.nbytes(TEXT_FILL).sum()),
                     time.perf_counter() - t0)
        return res

    def _filter_bytebatch(self, bufs: list[bytes]) -> FilterResult:
        bb = ByteBatch.from_buffers(bufs, bucket=self.byte_bucket)
        t0 = time.perf_counter()
        res = self._eng.filter_bytes(bb)
        self._record(res, bb.batch_size, bb.nbytes_total(),
                     time.perf_counter() - t0)
        return res

    def _record(self, res: FilterResult, n_docs: int, n_bytes: int,
                dt: float) -> None:
        """One accounting path for both ingest forms, so throughput()
        stays comparable between them."""
        self.stats["batches"] += 1
        self.stats["docs"] += n_docs
        self.stats["bytes"] += n_bytes
        self.stats["seconds"] += dt
        self.stats["pair_matches"] += int(res.matched.sum())
        self.stats["pairs"] += res.matched.size

    def _chunks(self, items: Iterable) -> Iterator[list]:
        """Accumulate an (unbounded) iterable into batch_size chunks."""
        batch: list = []
        for item in items:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def route(self, docs: Iterable[EventStream]
              ) -> Iterator[list[RoutedDocument]]:
        """Yield routed batches; each doc may fan out to several shards."""
        base = 0
        for batch in self._chunks(docs):
            res = self._filter_batch(batch)
            yield self._fan_out(res, [event_stream_nbytes(d) for d in batch],
                                base)
            base += len(batch)

    def route_bytes(self, payloads: Iterable[bytes]
                    ) -> Iterator[list[RoutedDocument]]:
        """Route raw paper-format byte payloads (device-decode twin of
        :meth:`route`): each batch is decoded *and* filtered on the
        device, then fanned out to shards exactly like the event path."""
        base = 0
        for batch in self._chunks(payloads):
            res = self._filter_bytebatch(batch)
            yield self._fan_out(res, [len(b) for b in batch], base)
            base += len(batch)

    def _fan_out(self, results: FilterResult, nbytes: list[int],
                 base: int = 0) -> list[RoutedDocument]:
        """Verdicts → routed documents, by global profile id."""
        out: list[RoutedDocument] = []
        for i, nb in enumerate(nbytes):
            doc = base + i
            qids = results[i].matching_queries().astype(np.int32)
            if len(qids) == 0:
                if self.keep_unmatched:
                    out.append(RoutedDocument(doc, qids, 0, nb))
                continue
            for shard in np.unique(self.shard_of_profile[qids]):
                mine = qids[self.shard_of_profile[qids] == shard]
                out.append(RoutedDocument(doc, mine, int(shard), nb))
        return out

    # ------------------------------------------------------------- metrics
    def throughput(self) -> dict:
        """Cumulative filtering throughput over everything routed so far."""
        s = self.stats
        dt = max(s["seconds"], 1e-9)
        return {
            "engine": self.engine,
            "docs": s["docs"],
            "docs_per_s": s["docs"] / dt,
            "mb_per_s": s["bytes"] / 1e6 / dt,
            "selectivity": s["pair_matches"] / max(s["pairs"], 1),
        }
