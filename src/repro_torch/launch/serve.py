"""The serving CLI's pub-sub routing layer on the port.

Counterpart of ``src/repro/launch/serve.py`` lines 62-148: requests carry
paper-format XML payloads, and standing profiles route each one to the
queue of a model replica (the paper's "deliver to interested
subscribers").

* :func:`build_stage` — the CLI's deterministic :class:`~repro_torch.
  data.filter_stage.FilterStage` (seeded DTD and profiles), on the card
  unless ``device="cpu"``; ``plan_cache=`` points its engine at a
  persistent :class:`~repro_torch.checkpoint.PlanCache` directory, so a
  restart skips the plan compile.
* :func:`route_requests` — fan requests out to the replica queues,
  host-parsed events (``ingest="events"``) or raw bytes parsed on the
  device (``ingest="bytes"``).
* :func:`serve_continuous` — the same fan-out through the continuous
  :class:`~repro_torch.serve.loop.ServeLoop` on a seeded arrival trace,
  with its SLO summary.

``data_shards > 1`` builds the stage on a 2-D ``("data", "model")`` mesh
(:func:`~repro_torch.launch.mesh.make_filter_mesh` on ``device``), and
:func:`route_requests` then routes bytes through the stage's pipelined
route.  The JAX package's CLI ``main`` builds ``ServeEngine`` model
replicas and generates with them; the LM substrate is ROADMAP queue 1
item 14, so ``main`` comes with it.
"""
from __future__ import annotations

import json

from ..core.dictionary import TagDictionary
from ..data.filter_stage import FilterStage
from ..data.generator import DTD, gen_profiles
from ..serve.loop import ServeLoop, make_arrivals, run_trace


def build_stage(n_replicas: int, *, engine: str = "levelwise",
                batch_size: int = 8, query_shards: int = 1,
                data_shards: int = 1, seed: int = 0,
                plan_cache: str | None = None, device: str = "cuda"):
    """The serving CLI's routing stage, deterministic for ``seed``.

    Returns ``(stage, dtd)``: the DTD generates the payloads and churn
    profiles.  ``plan_cache`` is a directory for the engine's persistent
    plan cache (a restart then compiles nothing it compiled before).
    """
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    profiles = gen_profiles(dtd, n=32, length=3, seed=seed)
    opts = {"plan_cache": plan_cache} if plan_cache else {}
    stage = FilterStage(profiles, d, n_shards=n_replicas, engine=engine,
                        keep_unmatched=True, batch_size=batch_size,
                        query_shards=query_shards, data_shards=data_shards,
                        device=device, engine_options=opts)
    return stage, dtd


def route_requests(stage: FilterStage, payloads, *, ingest: str = "events",
                   raw=None) -> list[list[int]]:
    """Fan requests out to replica queues through the stage: ``payloads``
    (event streams) with ``ingest="events"``, else the ``raw`` wire
    payloads, parsed on the device — through the pipelined route when the
    stage has a data axis."""
    queues: list[list[int]] = [[] for _ in range(stage.n_shards)]
    if ingest == "bytes":
        routed_batches = (stage.route_bytes_pipelined(raw)
                          if stage.data_shards > 1 else
                          stage.route_bytes(raw))
    else:
        routed_batches = stage.route(payloads)
    for routed in routed_batches:
        for r in routed:
            queues[r.shard].append(r.doc_index)
    return queues


def serve_continuous(stage: FilterStage, raw: list[bytes],
                     args) -> tuple[list[list[int]], dict]:
    """Drive the continuous serve loop over a seeded arrival trace.

    ``args`` carries the JAX CLI's flags (``arrival``, ``rate``,
    ``seed``, ``batch``, ``deadline_ms``, ``queue_cap``,
    ``max_inflight``, ``overload``, ``latency_json``).  Returns
    ``(queues, slo)``: the per-replica delivery queues (what
    :func:`route_requests` routes when nothing is shed) and the SLO
    summary; ``latency_json`` also gets the swaps, dead letters and the
    latency histogram.
    """
    deliveries: list = []
    arrivals = make_arrivals(args.arrival, len(raw), rate_hz=args.rate,
                             seed=args.seed)
    loop = ServeLoop(stage, max_batch=args.batch,
                     deadline_ms=args.deadline_ms,
                     queue_cap=args.queue_cap,
                     max_inflight=args.max_inflight,
                     overload=args.overload,
                     deliver=deliveries.append)
    with loop:
        run_trace(loop, raw, arrivals)
    slo = loop.slo_summary()
    queues: list[list[int]] = [[] for _ in range(stage.n_shards)]
    for routed in deliveries:
        for r in routed:
            queues[r.shard].append(r.doc_index)
    if args.latency_json:
        payload = {"arrival": args.arrival, "rate_hz": args.rate,
                   "deadline_ms": args.deadline_ms,
                   "queue_cap": args.queue_cap,
                   "max_inflight": args.max_inflight,
                   "overload": args.overload, "slo": slo,
                   "swaps": loop.swap_summary(),
                   "dead_letter": [
                       {"seq": r["seq"], "error": r["error"],
                        "message": r["message"]}
                       for r in loop.dead_letter],
                   "histogram": loop.latency_histogram(),
                   "latencies_ms": loop.latencies_ms().tolist()}
        with open(args.latency_json, "w") as f:
            json.dump(payload, f, indent=1)
    return queues, slo
