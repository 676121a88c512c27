"""Closed-loop routing: one client sends a request of ``batch`` payloads
to ``FilterStage.route_bytes``, waits for its routed documents, and sends
the next.  Request ``r`` takes pool entries ``(i + 3 r) mod pool`` for
``i < batch``, so the pool's payloads come in rotating orders."""
from __future__ import annotations

import time

import numpy as np

from . import build_stage, synchronize


def run(inputs, config: dict, traffic: dict, *, seconds: float, spans,
        trace, device: str) -> dict:
    stage = build_stage(config, inputs, batch_size=traffic["batch"],
                        device=device)
    pool, batch = len(inputs.payloads), traffic["batch"]

    def request(r: int) -> list[int]:
        return [(i + 3 * r) % pool for i in range(batch)]

    for r in range(traffic["warmup_requests"]):
        list(stage.route_bytes([inputs.payloads[i] for i in request(r)]))
    synchronize(device)

    done: list[tuple[list[int], list]] = []
    with trace:
        t_open = time.perf_counter_ns()
        t_end = t_open + int(seconds * 1e9)
        r = 0
        while True:
            idx = request(r)
            with spans.span("stage.route_bytes"):
                routed = [rd for b in stage.route_bytes(
                    [inputs.payloads[i] for i in idx]) for rd in b]
            done.append((idx, routed))
            r += 1
            if time.perf_counter_ns() >= t_end:
                break
        t_close = time.perf_counter_ns()

    answers = []
    counts = np.zeros(pool, np.int64)
    for idx, routed in done:
        by_doc: dict[int, list] = {i: [] for i in range(len(idx))}
        for rd in routed:
            by_doc[rd.doc_index].append(rd)
        answers += [(p, by_doc[i]) for i, p in enumerate(idx)]
        np.add.at(counts, idx, 1)
    return {"t_open": t_open, "t_close": t_close, "answers": answers,
            "attempted": len(answers), "unanswered": 0,
            "done_counts": counts, "requests": len(done),
            "stage_stats": dict(stage.stats)}
