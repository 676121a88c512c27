# Copy of src/repro/core/engines/result.py (the port imports nothing of the JAX package).
"""Common result containers for all engines.

Two verdict forms share one semantics:

* :class:`FilterResult` — the dense ``(B, Q)`` bitmap every engine
  returns from ``filter_batch``.
* :class:`SparseResult` — the match-list wire form for the subscription
  scale-up: one ``(doc_id, query_id, first_event)`` row per match, so
  delivery bandwidth scales with ``matches`` instead of ``B × Q``.

Both carry an optional ``live`` column mask: a churned sharded plan
tombstones removed query columns without recompiling, and those dead
columns must not count in any selectivity denominator or show up in
``matching_queries``.  ``densify``/``sparsify`` round-trip exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

NO_MATCH = np.iinfo(np.int32).max


def _live_mask(live, n_queries: int) -> np.ndarray | None:
    if live is None:
        return None
    live = np.asarray(live, dtype=bool)
    assert live.shape == (n_queries,), (live.shape, n_queries)
    return live


@dataclass
class FilterResult:
    """Per-query outcome of filtering one document — or a batch of them.

    Single document: ``matched``/``first_event`` have shape ``(Q,)``.
    Batched (the :meth:`repro.core.engines.base.FilterEngine.filter_batch`
    contract): shape ``(B, Q)``; ``res[i]`` recovers document i's view.

    ``matched[..., q]`` — document satisfies profile q.
    ``first_event[..., q]`` — event index of the first accepting OPEN event
    (the paper's "location of the match inside the document structure"),
    ``NO_MATCH`` when unmatched.
    ``live[q]`` — optional column-liveness mask: ``False`` marks a
    tombstoned (unsubscribed) or padded column, excluded from
    :meth:`matching_queries` and the :meth:`selectivity` denominator.
    ``None`` means every column is live.
    """

    matched: np.ndarray      # (..., Q) bool
    first_event: np.ndarray  # (..., Q) int32
    live: np.ndarray | None = None  # (Q,) bool, None = all live

    def __post_init__(self) -> None:
        self.matched = np.asarray(self.matched, dtype=bool)
        self.first_event = np.asarray(self.first_event, dtype=np.int32)
        assert self.matched.shape == self.first_event.shape
        self.live = _live_mask(self.live, self.matched.shape[-1])

    # ------------------------------------------------------------ structure
    @property
    def n_queries(self) -> int:
        return int(self.matched.shape[-1])

    @property
    def n_live(self) -> int:
        """Live query columns (tombstones excluded)."""
        if self.live is None:
            return self.n_queries
        return int(self.live.sum())

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.matched.shape[:-1])

    def __len__(self) -> int:
        if not self.batch_shape:
            raise TypeError("len() of a single-document FilterResult")
        return int(self.batch_shape[0])

    def __getitem__(self, i) -> "FilterResult":
        if not self.batch_shape:
            raise TypeError("single-document FilterResult is not indexable")
        return FilterResult(self.matched[i], self.first_event[i], self.live)

    def per_document(self) -> Iterator["FilterResult"]:
        """Iterate a batched result as single-document results."""
        for i in range(len(self)):
            yield self[i]

    @classmethod
    def stack(cls, results: Sequence["FilterResult"]) -> "FilterResult":
        """Stack single-document results into one batched result."""
        return cls(np.stack([r.matched for r in results]),
                   np.stack([r.first_event for r in results]),
                   results[0].live)

    # ------------------------------------------------------------- queries
    def matching_queries(self) -> np.ndarray:
        if self.batch_shape:
            raise TypeError("matching_queries() needs a single-document "
                            "result; index the batch first")
        m = self.matched if self.live is None else self.matched & self.live
        return np.nonzero(m)[0]

    def selectivity(self) -> float:
        """Fraction of (doc, *live* profile) pairs that match.

        Tombstoned/padded columns are excluded from the denominator, so
        a churned sharded plan reports the selectivity of what is
        actually subscribed.
        """
        m = self.matched if self.live is None else self.matched[..., self.live]
        return float(m.mean()) if m.size else 0.0

    def sparsify(self, live_ids: np.ndarray | None = None) -> "SparseResult":
        """Match-list view of a batched result (see :class:`SparseResult`).

        ``live_ids`` optionally renames columns to global subscriber ids
        (``query_ids[k] = live_ids[column]``, the ``FilterStage`` gid
        mapping); without it columns keep their local indices.
        """
        if not self.batch_shape:
            raise TypeError("sparsify() needs a batched (B, Q) result")
        m = self.matched if self.live is None else self.matched & self.live
        docs, cols = np.nonzero(m)
        first = self.first_event[docs, cols]
        qids = cols if live_ids is None else np.asarray(live_ids)[cols]
        return SparseResult(
            doc_ids=docs.astype(np.int32),
            query_ids=qids.astype(np.int32),
            first_event=first.astype(np.int32),
            batch_size=int(self.matched.shape[0]),
            n_queries=self.n_queries,
            live=self.live,
            live_ids=(None if live_ids is None
                      else np.asarray(live_ids, np.int32)),
        )

    def __eq__(self, other: object) -> bool:  # pragma: no cover
        if not isinstance(other, FilterResult):
            return NotImplemented
        return bool(
            self.matched.shape == other.matched.shape
            and (self.matched == other.matched).all()
            and (self.first_event == other.first_event).all()
        )


@dataclass
class SparseResult:
    """Sparse verdicts: one row per (document, subscriber) match.

    The wire format of sparse delivery — three aligned int32 columns::

        doc_ids[k]      batch row of match k
        query_ids[k]    matching query (column index, or global id when
                        the producer supplied ``live_ids``)
        first_event[k]  event index of the first accepting OPEN

    Rows are sorted by (doc, column).  ``verdict_bytes`` is what delivery
    actually moves: 12 bytes per match instead of the dense ``B × Q × 5``
    — the whole point at 10⁵⁺ subscriptions, where selectivity is low
    and the dense bitmap is almost entirely zeros.

    ``overflowed=True`` records that the bounded device match buffer
    overflowed and the rows came from the dense fallback instead — the
    verdicts are still exact, only the bandwidth win is lost for that
    batch.  :meth:`densify` reconstructs the dense
    :class:`FilterResult` bit-exactly.
    """

    doc_ids: np.ndarray      # (M,) int32
    query_ids: np.ndarray    # (M,) int32
    first_event: np.ndarray  # (M,) int32
    batch_size: int
    n_queries: int           # dense column-space width
    live: np.ndarray | None = None      # (n_queries,) bool, None = all live
    live_ids: np.ndarray | None = None  # column → global id, when renamed
    overflowed: bool = False
    meta: dict = field(default_factory=dict)  # producer stats (buffer cap …)

    def __post_init__(self) -> None:
        self.doc_ids = np.asarray(self.doc_ids, np.int32)
        self.query_ids = np.asarray(self.query_ids, np.int32)
        self.first_event = np.asarray(self.first_event, np.int32)
        assert self.doc_ids.shape == self.query_ids.shape \
            == self.first_event.shape
        self.live = _live_mask(self.live, self.n_queries)

    @property
    def n_matches(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def n_live(self) -> int:
        if self.live is None:
            return self.n_queries
        return int(self.live.sum())

    @property
    def verdict_bytes(self) -> int:
        """Bytes this verdict representation moves (3 int32 per match)."""
        return 12 * self.n_matches

    @property
    def dense_bytes(self) -> int:
        """What the dense ``(B, Q)`` twin would move (bool + int32)."""
        return self.batch_size * self.n_queries * 5

    def selectivity(self) -> float:
        """Matches over (doc, live profile) pairs — tombstones excluded."""
        pairs = self.batch_size * self.n_live
        return self.n_matches / pairs if pairs else 0.0

    def matching_queries(self, doc: int) -> np.ndarray:
        """Matching column/global ids of one document, ascending."""
        return np.sort(self.query_ids[self.doc_ids == doc])

    def densify(self) -> FilterResult:
        """Exact dense reconstruction (round-trip of ``sparsify``)."""
        cols = self.query_ids
        if self.live_ids is not None:  # global ids → column indices
            back = np.full(int(self.live_ids.max(initial=-1)) + 1, -1,
                           np.int32)
            back[self.live_ids] = np.arange(self.live_ids.shape[0],
                                            dtype=np.int32)
            cols = back[cols]
        matched = np.zeros((self.batch_size, self.n_queries), bool)
        first = np.full((self.batch_size, self.n_queries), NO_MATCH,
                        np.int32)
        matched[self.doc_ids, cols] = True
        first[self.doc_ids, cols] = self.first_event
        return FilterResult(matched, first, self.live)
