"""The serve loop: one producer thread submits pool payloads to a
``ServeLoop`` in an endless shuffled order (each pass through the pool a
new permutation drawn from the seed), and each ticket's ``routed`` is the
answer.

``arrival.process`` ``"backlog"`` submits as fast as the loop admits,
so with ``overload="block"`` the queue stays full and the loop's
capacity is measured; ``"poisson"`` and ``"burst"`` submit each payload
at its due time (``gen.arrivals``), an open loop, and a request's
latency is then also timed from when it was due.  The window opens
``ramp_s`` after the producer starts; a request counts as served in the
window when its verdict came inside it.  Once the window closes the
producer stops and the loop drains, so every request it submitted gets
its verdict and is checked.  A request the loop sheds is refused, not
answered: it counts as failed, and is not compared.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..gen import arrivals, grammar
from . import build_stage, synchronize

_ORDER, _ARRIVALS = 6, 7


def _order(pool: int, seed: int):
    rng = grammar.rng_for(seed, _ORDER)
    while True:
        yield from rng.permutation(pool).tolist()


def run(inputs, config: dict, traffic: dict, *, seconds: float, spans,
        trace, device: str) -> dict:
    from repro_torch.serve.loop import ServeLoop

    opts = traffic["loop"]
    stage = build_stage(config, inputs, batch_size=opts["max_batch"],
                        device=device)
    arrival = traffic["arrival"]
    pool = len(inputs.payloads)
    tickets: list = []             # (pool index, ticket, due time or None)
    stop = threading.Event()
    failure: list[BaseException] = []

    def produce(t0: float) -> None:
        try:
            _produce(t0)
        except BaseException as e:  # re-raised by the main thread
            failure.append(e)

    def _produce(t0: float) -> None:
        order = _order(pool, inputs.seed)
        due = None
        if arrival["process"] != "backlog":
            horizon = arrival["rate_hz"] * (traffic["ramp_s"] + seconds) * 2
            due = iter((t0 + arrivals.offsets(
                arrival, int(horizon) + 64,
                grammar.rng_for(inputs.seed, _ARRIVALS))).tolist())
        while not stop.is_set():
            i = next(order)
            t_due = None
            if due is not None:
                t_due = next(due)
                lag = t_due - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
            with spans.span("loop.submit"):
                tickets.append((i, loop.submit(inputs.payloads[i]), t_due))

    loop = ServeLoop(stage, clock=time.perf_counter, **opts)
    with loop:
        warm = [loop.submit(p) for p in inputs.payloads]
        for t in warm:
            if not t.done.wait(300):
                raise RuntimeError("the warm-up pass did not finish")
        synchronize(device)
        with trace:
            t0 = time.perf_counter()
            producer = threading.Thread(target=produce, args=(t0,),
                                        name="portbench-producer")
            producer.start()
            t_open = t0 + traffic["ramp_s"]
            time.sleep(max(0.0, t_open - time.perf_counter()))
            t_open_ns = time.perf_counter_ns()
            before = dict(loop.counters)
            time.sleep(seconds)
            t_close_ns = time.perf_counter_ns()
            after = dict(loop.counters)
            stop.set()
            producer.join(600)
            if producer.is_alive():
                raise RuntimeError("the producer did not stop")
            if failure:
                raise failure[0]
    t_open, t_close = t_open_ns / 1e9, t_close_ns / 1e9

    answers, shed = [], 0
    counts = np.zeros(pool, np.int64)
    latency, from_due, lag = [], [], []
    for i, t, t_due in tickets:
        if t_due is not None:
            lag.append(t.t_submit - t_due)
        if t.shed:               # refused by the admission policy
            shed += 1
            continue
        ok = t.routed is not None and t.error is None
        answers.append((i, t.routed if ok else None))
        if ok and t_open <= t.t_verdict <= t_close:
            counts[i] += 1
            latency.append(t.t_verdict - t.t_submit)
            if t_due is not None:
                from_due.append(t.t_verdict - t_due)
    return {"t_open": t_open_ns, "t_close": t_close_ns, "answers": answers,
            "attempted": len(tickets), "shed": shed,
            "unanswered": sum(a is None for _, a in answers),
            "done_counts": counts,
            "latency_s": np.asarray(latency),
            "latency_from_due_s": np.asarray(from_due),
            "submit_lag_s": np.asarray(lag),
            "loop_before": before, "loop_after": after,
            "stage_stats": dict(stage.stats)}
