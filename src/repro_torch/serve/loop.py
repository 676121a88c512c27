"""Continuous pub-sub serve loop on the port: bounded ingest, adaptive
batching, K-deep in-flight dispatch on CUDA streams, latency SLOs.

Counterpart of ``src/repro/serve/loop.py``, with the same constructor,
counters and semantics, over the port's :class:`~repro_torch.data.
filter_stage.FilterStage`, unsharded or query-sharded (``data_shards =
1``: the 2-D mesh is not ported).

Dataflow (one :class:`ServeLoop` instance)::

      submit()                  batcher                workers (≤ K)
    ───────────►  ingest queue ─────────►  adaptive  ─────────────►
     admission    (≤ queue_cap)            batching    bytes→verdict
     shed|block                         size OR deadline
                                                            │ FIFO
      deliver()  ◄───────────  completer  ◄─────────────────┘
     subscribers    ordered     fan-out + latency timestamps

* **Admission control** — the ingest queue is bounded at ``queue_cap``;
  an arrival that finds it full is *shed* or *blocks* the producer
  (``overload="block"``).
* **Adaptive batching** — a batch closes on *size* (``max_batch``) or
  *deadline* (``deadline_ms`` after it opened), whichever fires first.
* **K-deep pipelining** — up to ``max_inflight`` closed batches in flight;
  the batcher blocks when all K slots are busy (``backpressure_waits``).
* **Ordered delivery** — one completer thread resolves batches in
  dispatch order; verdicts equal the synchronous
  :meth:`~repro_torch.data.filter_stage.FilterStage.route_bytes` path.
* **SLOs** — :meth:`ServeLoop.slo_summary` reports p50/p99/p999
  bytes→verdict latency, shed rate, batch fill, close reasons, queue depth
  and backpressure occupancy.
* **Fault tolerance** — :func:`~repro_torch.core.events.validate_payload`
  rejects known-bad bytes at :meth:`ServeLoop.submit`; a failing batch is
  retried once, then bisected, and poison documents are quarantined into
  the bounded :attr:`ServeLoop.dead_letter` with typed errors.
* **Shadow-plan hot swap** — :meth:`ServeLoop.subscribe` /
  :meth:`~ServeLoop.unsubscribe` / :meth:`~ServeLoop.rebalance` build the
  replacement plan on a builder thread (a whole engine, or one part of a
  sharded plan) and the completer commits it at a batch boundary;
  in-flight batches keep the :class:`~repro_torch.data.filter_stage.
  PlanEpoch` they were dispatched under.

**Streams.**  On a card each worker thread (and the completer, when it
re-filters a subset) runs its batches on a ``torch.cuda.Stream`` of its
own — the counterpart of JAX's asynchronous dispatch — so one batch's
staging and host work overlap another's kernels.  What crosses streams
is ordered explicitly: a worker's stream waits for the plan tables of
the engine it filters with (:meth:`FilterEngine.wait_plan`; an engine
built by the builder thread copied them on the builder's stream) and of
its epoch's sharded plan (:meth:`ShardedPlan.wait`), and
the engines' memoised lane tables are waited for and recorded on each
reader's stream.  Everything else a worker allocates stays on its own
stream, and its verdicts reach the host before the batch is resolved.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.engines import FilterResult
from ..core.events import (DEFAULT_MAX_DEPTH, DocumentError, KernelFault,
                           validate_payload)
from ..data.filter_stage import FilterStage, PlanEpoch, RoutedDocument

#: admission policies: drop the arrival (count it) vs stall the producer
OVERLOAD_POLICIES = ("shed", "block")


@dataclass
class ServeRequest:
    """One submitted payload's ticket through the loop.

    ``seq`` is the admission sequence number — it doubles as the
    document index in every :class:`RoutedDocument` the request fans out
    to, so delivery order per subscriber is admission order.  Shed
    requests never get a ``seq`` (they were never admitted); neither do
    requests rejected by pre-admission validation.

    ``error`` is the terminal failure state: a typed
    :class:`~repro_torch.core.events.DocumentError` for rejected/quarantined
    poison documents, or the raw worker exception when the loop runs
    with ``recover=False``.  Exactly one of ``routed`` / ``error`` /
    ``shed`` describes a finished ticket.

    ``epoch`` is the :class:`PlanEpoch` the verdicts were filtered under
    (``-1`` until routed), so a caller can hold each request against the
    subscription set that was live for it while churn commits.
    """

    payload: bytes
    t_submit: float
    seq: int = -1
    shed: bool = False
    t_verdict: float | None = None
    routed: list[RoutedDocument] | None = None
    error: BaseException | None = None
    epoch: int = -1
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)

    @property
    def latency_s(self) -> float | None:
        """Enqueue→verdict seconds (``None`` until resolved / if shed)."""
        if self.t_verdict is None:
            return None
        return self.t_verdict - self.t_submit

    @property
    def failed(self) -> bool:
        """Terminal failure: rejected, quarantined, or worker error."""
        return self.error is not None


@dataclass
class ReconfigTicket:
    """One live-reconfiguration request's ticket through the shadow
    builder: prepared off the hot path, committed by the completer at a
    batch boundary.  ``error`` set (and the live plan untouched) when
    the build or commit failed — the rollback path."""

    op: str                            # "subscribe" | "unsubscribe" | "rebalance"
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)
    gid: int | None = None             # result for subscribe/unsubscribe
    stats: dict | None = None          # result for rebalance
    error: BaseException | None = None
    build_s: float = 0.0               # shadow build (prepare) seconds
    commit_s: float = 0.0              # atomic swap seconds


class ServeLoop:
    """Continuous serving front-end over a :class:`FilterStage`.

    Use as a context manager: exiting flushes the queue, drains all
    in-flight batches and joins the worker threads — a wedged device
    call is therefore visible as a *hanging close*, which a caller's
    timeout catches.

    ``deliver`` (optional) is called by the completer with each batch's
    routed documents, in order; a consumer that blocks inside it stalls
    the completer, which fills the K in-flight slots, which blocks the
    batcher, which fills the ingest queue, which sheds (or blocks) new
    arrivals — end-to-end backpressure with no unbounded buffer
    anywhere.
    """

    def __init__(self, stage: FilterStage, *, max_batch: int | None = None,
                 deadline_ms: float = 10.0, queue_cap: int = 64,
                 max_inflight: int = 2, overload: str = "shed",
                 deliver: Callable[[list[RoutedDocument]], Any] | None = None,
                 pad_batches: bool = True, validate: bool = True,
                 recover: bool = True, dead_letter_cap: int = 256,
                 rebalance_every_batches: int = 0,
                 rebalance_tolerance: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(f"overload must be one of {OVERLOAD_POLICIES}, "
                             f"got {overload!r}")
        if queue_cap < 1 or max_inflight < 1:
            raise ValueError("queue_cap and max_inflight must be >= 1")
        self.stage = stage
        self.max_batch = int(max_batch or stage.batch_size)
        self.deadline_s = float(deadline_ms) / 1e3
        self.queue_cap = int(queue_cap)
        self.max_inflight = int(max_inflight)
        self.overload = overload
        self.deliver = deliver
        # compiled-shape discipline: a deadline-closed undersized batch
        # is padded back to max_batch (repeating its last payload; the
        # pad rows' verdicts are sliced off) so the device program keeps
        # ONE batch shape — otherwise every distinct deadline-close size
        # triggers a fresh compile on the latency path.  Sparse stages
        # skip it (their match lists carry real doc ids).
        self.pad_batches = bool(pad_batches) and not stage.sparse
        #: reject known-bad bytes at submit() with a typed error, before
        #: they reach a kernel (host-side, vectorized — cheap)
        self.validate = bool(validate)
        #: isolate poison documents on batch failure (retry + bisection)
        #: instead of failing the whole batch; ``False`` marks all the
        #: batch's requests failed and keeps serving
        self.recover = bool(recover)
        self._max_depth = int(getattr(stage._eng, "max_depth",
                                      DEFAULT_MAX_DEPTH))
        #: run a shadow rebalance every N completed batches (0 = never)
        self.rebalance_every_batches = int(rebalance_every_batches)
        self.rebalance_tolerance = rebalance_tolerance
        self._clock = clock

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue: deque[ServeRequest] = deque()
        self._closing = False
        self._closed = False
        self._error: BaseException | None = None
        # dispatched-but-undelivered batches are bounded at K: a slot is
        # taken at dispatch and released only after delivery
        self._slots = threading.Semaphore(self.max_inflight)
        self._comp_cv = threading.Condition()
        self._completion: deque = deque()
        self._latencies: list[float] = []
        self._batch_fills: list[float] = []
        #: bounded dead-letter buffer of quarantined documents: dicts of
        #: ``{seq, payload, error, message}`` (seq -1 = rejected at
        #: admission); oldest entries fall off at ``dead_letter_cap``
        self.dead_letter: deque[dict] = deque(maxlen=int(dead_letter_cap))
        #: committed hot swaps, in commit order: ``{op, build_s,
        #: commit_s, epoch}``
        self.swap_log: list[dict] = []
        self.counters = {"admitted": 0, "shed": 0, "completed": 0,
                         "batches": 0, "size_closes": 0,
                         "deadline_closes": 0, "flush_closes": 0,
                         "backpressure_waits": 0, "max_queue_depth": 0,
                         "rejected": 0, "quarantined": 0, "failed": 0,
                         "retries": 0, "swaps": 0, "swap_rollbacks": 0,
                         "delivery_errors": 0}
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._batches_since_rebalance = 0
        self._auto_ticket: ReconfigTicket | None = None
        self._reconfig_cv = threading.Condition()
        self._reconfig_q: deque = deque()

        # one CUDA stream per thread that filters (see the module note)
        self._device = torch.device(stage.device)
        self._local = threading.local()

        self._pool = ThreadPoolExecutor(max_workers=self.max_inflight,
                                        thread_name_prefix="serve-filter")
        self._batcher_t = threading.Thread(target=self._batcher,
                                           name="serve-batcher", daemon=True)
        self._completer_t = threading.Thread(target=self._completer,
                                             name="serve-completer",
                                             daemon=True)
        self._builder_t = threading.Thread(target=self._builder,
                                           name="serve-plan-builder",
                                           daemon=True)
        self._batcher_t.start()
        self._completer_t.start()
        self._builder_t.start()

    # ------------------------------------------------------------- ingest
    def submit(self, payload: bytes) -> ServeRequest:
        """Admit one raw wire payload; returns its ticket immediately.

        Under overload (queue at ``queue_cap``): ``overload="shed"``
        marks the ticket shed and returns at once; ``"block"`` stalls
        the caller until the loop drains a slot (producer-side
        backpressure).  A loop that is closing sheds rather than
        deadlocking a blocked producer.

        With ``validate=True`` (default) known-bad bytes are *rejected*
        here — the ticket comes back with a typed
        :class:`~repro_torch.core.events.DocumentError` and a dead-letter
        record, and the payload never reaches a kernel.
        """
        req = ServeRequest(payload=payload, t_submit=self._clock())
        if self.validate:
            try:
                validate_payload(payload, max_depth=self._max_depth)
            except DocumentError as e:
                req.error = e
                req.done.set()
                with self._lock:
                    self.counters["rejected"] += 1
                    self.counters["quarantined"] += 1
                    self.dead_letter.append(
                        {"seq": -1, "payload": payload,
                         "error": type(e).__name__, "message": str(e)})
                return req
        with self._lock:
            if self.overload == "shed":
                if len(self._queue) >= self.queue_cap or self._closing:
                    req.shed = True
                    self.counters["shed"] += 1
                    req.done.set()
                    return req
            else:
                while len(self._queue) >= self.queue_cap \
                        and not self._closing:
                    self._not_full.wait()
                if self._closing:
                    req.shed = True
                    self.counters["shed"] += 1
                    req.done.set()
                    return req
            req.seq = self.counters["admitted"]
            self.counters["admitted"] += 1
            if self._t_first is None:
                self._t_first = req.t_submit
            self._queue.append(req)
            depth = len(self._queue)
            if depth > self.counters["max_queue_depth"]:
                self.counters["max_queue_depth"] = depth
            self._not_empty.notify()
        return req

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ----------------------------------------------------------- batching
    def _batcher(self) -> None:
        try:
            while True:
                with self._lock:
                    while not self._queue and not self._closing:
                        self._not_empty.wait()
                    if not self._queue and self._closing:
                        break
                    # batch opens now; close on size or deadline,
                    # whichever fires first (flush closes immediately)
                    deadline = self._clock() + self.deadline_s
                    while (len(self._queue) < self.max_batch
                           and not self._closing):
                        left = deadline - self._clock()
                        if left <= 0:
                            break
                        self._not_empty.wait(timeout=left)
                    n = min(self.max_batch, len(self._queue))
                    reqs = [self._queue.popleft() for _ in range(n)]
                    if n == self.max_batch:
                        self.counters["size_closes"] += 1
                    elif self._closing:
                        self.counters["flush_closes"] += 1
                    else:
                        self.counters["deadline_closes"] += 1
                    self.counters["batches"] += 1
                    self._not_full.notify_all()
                self._dispatch(reqs)
        except BaseException as e:  # pragma: no cover - defensive
            self._fail(e)
        finally:
            with self._comp_cv:
                self._completion.append(None)
                self._comp_cv.notify()

    def _dispatch(self, reqs: list[ServeRequest]) -> None:
        """Take an in-flight slot (counting the wait as backpressure)
        and hand the batch to a worker; completion order is dispatch
        order regardless of which worker finishes first."""
        if not self._slots.acquire(blocking=False):
            with self._lock:
                self.counters["backpressure_waits"] += 1
            self._slots.acquire()
        future = self._pool.submit(self._run_batch,
                                   [r.payload for r in reqs])
        with self._comp_cv:
            self._completion.append((reqs, future))
            self._comp_cv.notify()

    def _stream(self):
        """This thread's CUDA stream as the current stream (created at
        its first batch); nothing off the card."""
        if self._device.type != "cuda":
            return contextlib.nullcontext()
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self._device)
        return torch.cuda.stream(stream)

    def _run_batch(self, payloads: list[bytes]):
        """Worker-thread body: the stage's device bytes→verdict call, on
        this thread's stream.

        The batch is pinned to a :meth:`FilterStage.plan_epoch`
        snapshot — a hot swap committing mid-flight cannot tear
        engine/gids — and the snapshot rides along for the
        epoch-consistent fan-out.  ``record=False`` — stage stats are
        mutated only by the single-threaded completer, so K concurrent
        workers never race the accounting dict.  The verdicts come back
        on the host, so nothing of the batch outlives its stream's work.
        """
        t0 = time.perf_counter()
        n = len(payloads)
        padded = payloads
        if self.pad_batches and n < self.max_batch:
            padded = payloads + [payloads[-1]] * (self.max_batch - n)
        ep = self.stage.plan_epoch()
        with self._stream():
            res = self.stage._filter_bytebatch(padded, record=False,
                                               epoch=ep)
        if len(padded) != n:
            res = FilterResult(res.matched[:n], res.first_event[:n],
                               res.live)
        return res, [len(p) for p in payloads], time.perf_counter() - t0, ep

    # ----------------------------------------------------------- delivery
    def _completer(self) -> None:
        # two producers feed the completion queue: the batcher (batches)
        # and the shadow builder (plan swaps); each appends one None
        # sentinel on exit, and the completer drains until both are done
        # — so a swap enqueued during shutdown still commits
        producers = 2
        try:
            while True:
                with self._comp_cv:
                    while not self._completion:
                        self._comp_cv.wait()
                    item = self._completion.popleft()
                if item is None:
                    producers -= 1
                    if producers == 0:
                        break
                    continue
                if item[0] == "swap":
                    self._commit_swap(item[1], item[2], item[3])
                    continue
                reqs, future = item
                try:
                    res, nbytes, dt, ep = future.result()
                except BaseException as e:
                    if self.recover:
                        self._recover(reqs, e, retry=True)
                    else:
                        self._fail_requests(reqs, e)
                else:
                    self._resolve(reqs, res, nbytes, dt, ep)
                self._slots.release()
                self._maybe_auto_rebalance()
        except BaseException as e:  # pragma: no cover - defensive
            self._fail(e)

    def _resolve(self, reqs: list[ServeRequest], res, nbytes: list[int],
                 dt: float, ep: PlanEpoch) -> None:
        """Fan a finished batch's verdicts out to its tickets.

        Routing uses the epoch the batch was *filtered* under
        (``ep.gids``) and the requests' own seqs — recovered subsets
        are non-contiguous, and a plan swapped after dispatch must not
        remap this batch's verdict columns."""
        t_done = self._clock()
        routed = self.stage._fan_out(res, nbytes, gids=ep.gids,
                                     seqs=[r.seq for r in reqs])
        self.stage._record(res, len(reqs), sum(nbytes), dt)
        by_doc: dict[int, list[RoutedDocument]] = {}
        for rd in routed:
            by_doc.setdefault(rd.doc_index, []).append(rd)
        for r in reqs:
            r.t_verdict = t_done
            r.routed = by_doc.get(r.seq, [])
            r.epoch = ep.epoch
            self._latencies.append(t_done - r.t_submit)
            r.done.set()
        self.counters["completed"] += len(reqs)
        self._t_last = t_done
        self._batch_fills.append(len(reqs) / self.max_batch)
        if self.deliver is not None:
            # a stalled consumer stalls HERE, holding the slot: that is
            # the backpressure chain's first link.  A *raising* consumer
            # must not kill the loop — its error is counted, not fatal.
            try:
                self.deliver(routed)
            except BaseException:
                self.counters["delivery_errors"] += 1

    # ------------------------------------------------- failure containment
    def _recover(self, reqs: list[ServeRequest], err: BaseException,
                 retry: bool) -> None:
        """Contain a failed batch: isolate poison, save the rest.

        A typed :class:`DocumentError` carrying ``doc_indices`` names
        the poison outright — quarantine those, re-filter the rest.
        Anything else gets one whole-batch retry (transient faults:
        worker hiccup, OOM race), then bisection: halves re-filter
        independently, singletons that still fail are quarantined as
        :class:`KernelFault`.  Healthy co-batched documents therefore
        always complete, with verdicts identical to a fault-free run.
        """
        if isinstance(err, DocumentError) and err.doc_indices:
            # pad rows repeat the last payload, so a pad-row index maps
            # back onto the last real request
            bad_idx = sorted({min(int(i), len(reqs) - 1)
                              for i in err.doc_indices})
            bad = set(bad_idx)
            self._quarantine([reqs[i] for i in bad_idx], err)
            rest = [r for i, r in enumerate(reqs) if i not in bad]
            if rest:
                self._try_subset(rest)
            return
        if retry:
            self.counters["retries"] += 1
            self._try_subset(reqs)
            return
        if len(reqs) == 1:
            self._quarantine(reqs, err)
            return
        mid = len(reqs) // 2
        self._try_subset(reqs[:mid])
        self._try_subset(reqs[mid:])

    def _try_subset(self, reqs: list[ServeRequest]) -> None:
        """Synchronously re-filter a subset on the completer thread;
        recurse into :meth:`_recover` (no further whole-batch retry) if
        it fails again."""
        try:
            res, nbytes, dt, ep = self._run_batch([r.payload for r in reqs])
        except BaseException as e:
            self._recover(reqs, e, retry=False)
            return
        self._resolve(reqs, res, nbytes, dt, ep)

    def _quarantine(self, reqs: list[ServeRequest],
                    err: BaseException) -> None:
        """Terminal poison state: typed error on each ticket (carrying
        the document's admission seq), bounded dead-letter record, loop
        keeps serving."""
        for r in reqs:
            if isinstance(err, DocumentError):
                e = type(err)(str(err), (r.seq,))
            else:
                e = KernelFault(f"{type(err).__name__}: {err}", (r.seq,))
            e.__cause__ = err if e is not err else None
            r.error = e
            with self._lock:
                self.counters["quarantined"] += 1
                self.dead_letter.append(
                    {"seq": r.seq, "payload": r.payload,
                     "error": type(e).__name__, "message": str(err)})
            r.done.set()

    def _fail_requests(self, reqs: Sequence[ServeRequest],
                       err: BaseException) -> None:
        """``recover=False`` terminal path: every request in the batch
        fails with the raw worker error; the loop keeps serving and
        ``close()`` re-raises the first such error."""
        with self._lock:
            if self._error is None:
                self._error = err
            self.counters["failed"] += len(reqs)
        for r in reqs:
            r.error = err
            r.done.set()

    def _fail(self, e: BaseException,
              reqs: Sequence[ServeRequest] = ()) -> None:
        with self._lock:
            if self._error is None:
                self._error = e
            self._not_full.notify_all()
        for r in reqs:
            r.error = e
            r.done.set()

    # ------------------------------------------------- shadow-plan hot swap
    def subscribe(self, profile, shard: int | None = None) -> ReconfigTicket:
        """Add a standing profile *live*: the replacement plan builds on
        the shadow builder thread and swaps in at a batch boundary — no
        queue drain, no filtering pause.  Wait on ``ticket.done`` for
        the gid (or the build error)."""
        return self._enqueue_reconfig("subscribe", profile, shard)

    def unsubscribe(self, gid: int) -> ReconfigTicket:
        """Drop a subscription live (shadow build + boundary swap)."""
        return self._enqueue_reconfig("unsubscribe", gid, None)

    def rebalance(self, tolerance: float | None = None) -> ReconfigTicket:
        """Shadow-rebalance the sharded plan; commits only if trie
        groups actually moved (``ticket.stats``)."""
        return self._enqueue_reconfig("rebalance", tolerance, None)

    def _enqueue_reconfig(self, op: str, arg, shard) -> ReconfigTicket:
        ticket = ReconfigTicket(op=op)
        with self._reconfig_cv:
            if self._closing:
                ticket.error = RuntimeError("serve loop is closing")
                ticket.done.set()
                return ticket
            self._reconfig_q.append((op, arg, shard, ticket))
            self._reconfig_cv.notify()
        return ticket

    def _builder(self) -> None:
        """Shadow-plan builder: one reconfiguration at a time, each
        prepared against the live epoch and handed to the completer for
        the atomic commit.  Serialized on ``ticket.done`` so the next
        prepare never races the previous commit (which would make it
        stale)."""
        try:
            while True:
                with self._reconfig_cv:
                    while not self._reconfig_q and not self._closing:
                        self._reconfig_cv.wait()
                    if not self._reconfig_q:
                        break            # closing, queue drained
                    op, arg, shard, ticket = self._reconfig_q.popleft()
                try:
                    if op == "subscribe":
                        pending = self.stage.prepare_subscribe(arg)
                    elif op == "unsubscribe":
                        pending = self.stage.prepare_unsubscribe(arg)
                    else:
                        pending = self.stage.prepare_rebalance(tolerance=arg)
                except BaseException as e:
                    # rollback: the live plan was never touched
                    ticket.error = e
                    with self._lock:
                        self.counters["swap_rollbacks"] += 1
                    ticket.done.set()
                    continue
                if pending is None:      # rebalance on an unsharded stage
                    ticket.done.set()
                    continue
                ticket.build_s = pending.build_s
                with self._comp_cv:
                    self._completion.append(("swap", ticket, pending, shard))
                    self._comp_cv.notify()
                ticket.done.wait()
        finally:
            with self._comp_cv:
                self._completion.append(None)
                self._comp_cv.notify()

    def _commit_swap(self, ticket: ReconfigTicket, pending,
                     shard) -> None:
        """Completer-side half of the hot swap: a few reference
        assignments under the stage's plan mutex, at a batch boundary
        (never mid-fan-out).  In-flight batches keep their dispatch
        epoch; the next ``_run_batch`` snapshot sees the new plan."""
        t0 = time.perf_counter()
        try:
            out = self.stage.commit(pending, shard=shard)
        except BaseException as e:
            ticket.error = e
            with self._lock:
                self.counters["swap_rollbacks"] += 1
        else:
            ticket.commit_s = time.perf_counter() - t0
            if pending.op == "rebalance":
                ticket.stats = out
            else:
                ticket.gid = out
            with self._lock:
                self.counters["swaps"] += 1
            self.swap_log.append(
                {"op": pending.op, "build_s": round(ticket.build_s, 6),
                 "commit_s": round(ticket.commit_s, 6),
                 "epoch": self.stage._epoch})
        ticket.done.set()

    def _maybe_auto_rebalance(self) -> None:
        """Traffic-driven rebalance: every N completed batches, kick a
        shadow rebalance (skipped while one is still in flight)."""
        if not self.rebalance_every_batches:
            return
        self._batches_since_rebalance += 1
        if self._batches_since_rebalance < self.rebalance_every_batches:
            return
        if self._auto_ticket is not None \
                and not self._auto_ticket.done.is_set():
            return
        self._batches_since_rebalance = 0
        self._auto_ticket = self.rebalance(self.rebalance_tolerance)

    # -------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Flush the queue, drain every in-flight batch and pending
        reconfiguration, join threads.  Idempotent and re-entrant: the
        second and later calls are no-ops (no re-join, no re-raise).

        Raises the first *loop* error, if any (an internal thread crash,
        or a batch failure under ``recover=False``) — exactly once.
        Quarantined documents are not loop errors: their typed
        exceptions live on their tickets and in :attr:`dead_letter`.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._closing = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        with self._reconfig_cv:
            self._reconfig_cv.notify_all()
        self._batcher_t.join()
        self._builder_t.join()
        self._completer_t.join()
        self._pool.shutdown(wait=True)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "ServeLoop":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------ metrics
    def slo_summary(self) -> dict:
        """Latency percentiles + occupancy counters for everything
        served so far (ms; ``nan`` percentiles until something
        completes).

        Accounting closes even under failures: every arrival ends in
        exactly one of completed / shed / failed / quarantined, so at
        quiescence ``arrived == completed + shed + failed +
        quarantined`` (``rejected`` — pre-admission — is the part of
        ``quarantined`` that never got a seq; ``arrived == admitted +
        shed + rejected``)."""
        lat_ms = np.asarray(self._latencies) * 1e3
        c = dict(self.counters)
        arrived = c["admitted"] + c["shed"] + c["rejected"]
        span = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        return {
            **c,
            "arrived": arrived,
            "shed_rate": c["shed"] / max(arrived, 1),
            "dead_letter_depth": len(self.dead_letter),
            "p50_ms": _pct(lat_ms, 50.0),
            "p99_ms": _pct(lat_ms, 99.0),
            "p999_ms": _pct(lat_ms, 99.9),
            "mean_ms": float(lat_ms.mean()) if lat_ms.size else float("nan"),
            "batch_fill": (float(np.mean(self._batch_fills))
                           if self._batch_fills else 0.0),
            "served_per_s": c["completed"] / span if span > 0 else 0.0,
        }

    def swap_summary(self) -> dict:
        """Hot-swap cost summary: shadow build vs atomic commit times
        (ms) over :attr:`swap_log` — the commit is the only part the
        latency path can ever observe."""
        builds = np.asarray([s["build_s"] for s in self.swap_log]) * 1e3
        commits = np.asarray([s["commit_s"] for s in self.swap_log]) * 1e3
        return {
            "swaps": self.counters["swaps"],
            "swap_rollbacks": self.counters["swap_rollbacks"],
            "build_p50_ms": _pct(builds, 50.0),
            "build_p99_ms": _pct(builds, 99.0),
            "commit_p50_ms": _pct(commits, 50.0),
            "commit_p99_ms": _pct(commits, 99.0),
        }

    def latencies_ms(self) -> np.ndarray:
        """Per-request enqueue→verdict latencies (ms), completion order."""
        return np.asarray(self._latencies) * 1e3

    def latency_histogram(self, n_bins: int = 32) -> dict:
        """Log-spaced latency histogram of everything served so far."""
        lat = self.latencies_ms()
        if lat.size == 0:
            return {"edges_ms": [], "counts": []}
        lo = max(float(lat.min()), 1e-3)
        hi = max(float(lat.max()), lo * (1 + 1e-6))
        edges = np.geomspace(lo, hi, n_bins + 1)
        counts, _ = np.histogram(lat, bins=edges)
        return {"edges_ms": edges.tolist(), "counts": counts.tolist()}


def _pct(xs: np.ndarray, q: float) -> float:
    return float(np.percentile(xs, q)) if xs.size else float("nan")


# ------------------------------------------------------- arrival traces
def poisson_arrivals(n: int, rate_hz: float, *, seed: int = 0) -> np.ndarray:
    """``n`` absolute arrival offsets (s) of a Poisson process."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))

def burst_arrivals(n: int, rate_hz: float, *, on_s: float = 0.05,
                   off_s: float = 0.15, seed: int = 0) -> np.ndarray:
    """ON/OFF-modulated Poisson: bursts at ``rate_hz`` for ``on_s``,
    silence for ``off_s`` — the bursty-input scenario the paper's
    "very high input ratios" motivation describes.  Mean rate is
    ``rate_hz * on_s / (on_s + off_s)``."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    rng = np.random.default_rng(seed)
    out: list[float] = []
    t = 0.0
    while len(out) < n:
        window_end = t + on_s
        while len(out) < n:
            t += rng.exponential(1.0 / rate_hz)
            if t >= window_end:
                break
            out.append(t)
        t = window_end + off_s
    return np.asarray(out[:n])

def replay_arrivals(n: int, rate_hz: float | None = None) -> np.ndarray:
    """Deterministic trace: back-to-back (``rate_hz=None``) or evenly
    spaced at ``rate_hz`` — replaying a fixed request list through the
    loop (the old batch driver's arrival pattern, as a trace)."""
    if rate_hz is None or rate_hz <= 0:
        return np.zeros(n)
    return np.arange(n, dtype=np.float64) / rate_hz


def make_arrivals(kind: str, n: int, *, rate_hz: float,
                  on_s: float = 0.05, off_s: float = 0.15,
                  seed: int = 0) -> np.ndarray:
    """Trace dispatcher for the CLI/bench ``--arrival`` knob."""
    if kind == "poisson":
        return poisson_arrivals(n, rate_hz, seed=seed)
    if kind == "burst":
        return burst_arrivals(n, rate_hz, on_s=on_s, off_s=off_s, seed=seed)
    if kind == "replay":
        return replay_arrivals(n, rate_hz)
    raise ValueError(f"unknown arrival trace {kind!r} "
                     f"(poisson|burst|replay)")


def run_trace(loop: ServeLoop, payloads: Sequence[bytes],
              arrivals: np.ndarray, *,
              clock: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], Any] = time.sleep
              ) -> list[ServeRequest]:
    """Submit ``payloads[i]`` at offset ``arrivals[i]`` (open-loop: the
    trace does NOT slow down when the service falls behind, which is
    what makes shed/backpressure measurable).  Returns the tickets."""
    if len(payloads) != len(arrivals):
        raise ValueError(f"{len(payloads)} payloads vs "
                         f"{len(arrivals)} arrival offsets")
    t0 = clock()
    tickets = []
    for payload, due in zip(payloads, arrivals):
        lag = due - (clock() - t0)
        if lag > 0:
            sleep(lag)
        tickets.append(loop.submit(payload))
    return tickets
