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

* :func:`main` — the serving CLI (lines 151-301 of the JAX file):
  :class:`~repro_torch.serve.engine.ServeEngine` model replicas, the
  routing stage, live subscription churn, then generation by each
  replica over its queue, with the JAX CLI's flags and printed lines
  and one flag more, ``--device`` (``cuda`` unless given; ``cpu`` runs
  it off the card).

``data_shards > 1`` builds the stage on a 2-D ``("data", "model")`` mesh
(:func:`~repro_torch.launch.mesh.make_filter_mesh` on ``device``), and
:func:`route_requests` then routes bytes through the stage's pipelined
route.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \
      --replicas 2 --filter-engine streaming --ingest bytes
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 8 --replicas 2 --batch 4 --prompt-len 8 --gen-len 4
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import engines
from ..core.dictionary import TagDictionary
from ..core.events import encode_bytes
from ..data.filter_stage import TEXT_FILL, FilterStage
from ..data.generator import DTD, gen_corpus, gen_profiles
from ..models import transformer as T
from ..serve.engine import ServeEngine, require_device
from ..serve.loop import (OVERLOAD_POLICIES, ServeLoop, make_arrivals,
                          run_trace)


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCHS))
    # as in the JAX CLI: store_true with default True, so always reduced
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--filter-engine", default="levelwise",
                    choices=list(engines.names()),
                    help="pub-sub routing engine (any registered engine)")
    ap.add_argument("--ingest", default="events",
                    choices=("events", "bytes"),
                    help="request payload form: pre-parsed event streams "
                         "(host parse) or raw wire bytes parsed on device")
    ap.add_argument("--query-shards", type=int, default=1,
                    help="partition the subscription set into this many "
                         "parts run as one stacked program over the mesh "
                         "'model' axis (1 = monolithic plan)")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="fan the document stream over this many mesh "
                         "'data' replicas (2-D data × model program with "
                         "the async K-deep pipelined byte-ingest loop; "
                         "shrinks to what the host can place)")
    ap.add_argument("--arrival", default=None,
                    choices=("poisson", "burst", "replay"),
                    help="serve CONTINUOUSLY: submit requests on this "
                         "seeded arrival trace through the admission-"
                         "controlled serve loop and print the SLO "
                         "summary (default: the batch driver)")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="arrival rate in req/s (burst: the ON-window "
                         "rate; mean is a quarter of it)")
    ap.add_argument("--deadline-ms", type=float, default=10.0,
                    help="adaptive batching: close a batch this long "
                         "after it opens even if under --batch size")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="K-deep pipelining: dispatched-but-undelivered "
                         "batches held in flight (2 = double buffer)")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="admission control: bound on the ingest queue; "
                         "arrivals beyond it are shed or block")
    ap.add_argument("--overload", default="shed",
                    choices=OVERLOAD_POLICIES,
                    help="overload policy at --queue-cap: shed the "
                         "arrival or block the producer")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-trace seed (workload seeds are fixed)")
    ap.add_argument("--latency-json", default=None, metavar="PATH",
                    help="write the SLO summary + latency histogram "
                         "JSON here")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="persistent compiled-plan cache directory: "
                         "restarts with the same subscription set skip "
                         "plan recompilation (crash-recovery cold start)")
    ap.add_argument("--device", default="cuda",
                    help="where the filter and the model replicas run "
                         "(cuda: the card, which must be present; cpu)")
    args = ap.parse_args()
    device = require_device(args.device)

    cfg = get_config(args.arch, reduced=args.reduced).with_(vocab=256)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(cfg, gen)
    replica_engines = [ServeEngine(cfg, params, batch=args.batch,
                                   max_len=args.prompt_len + args.gen_len + 4,
                                   device=device)
                       for _ in range(args.replicas)]

    # pub-sub routing layer: profiles → replicas
    stage, dtd = build_stage(args.replicas, engine=args.filter_engine,
                             batch_size=args.batch,
                             query_shards=args.query_shards,
                             data_shards=args.data_shards,
                             plan_cache=args.plan_cache, device=args.device)
    payloads = gen_corpus(dtd, n_docs=args.requests, nodes_per_doc=60,
                          seed=1)

    # serialization is request arrival, outside the routing timer; the
    # continuous loop is always a bytes service
    raw = ([encode_bytes(doc, text_fill=TEXT_FILL) for doc in payloads]
           if args.ingest == "bytes" or args.arrival else None)
    t0 = time.perf_counter()
    if args.arrival:
        queues, slo = serve_continuous(stage, raw, args)
        ingest_label = f"bytes, {args.arrival} arrivals"
    else:
        queues = route_requests(stage, payloads, ingest=args.ingest, raw=raw)
        slo = None
        ingest_label = f"{args.ingest} ingest"
    t_route = time.perf_counter() - t0
    tp = stage.throughput()
    print(f"[serve] routed {args.requests} requests ({ingest_label}) → "
          f"{[len(q) for q in queues]} per replica ({t_route*1e3:.1f} ms; "
          f"{tp['engine']}×{tp['query_shards']}: "
          f"{tp['docs_per_s']:.0f} docs/s, {tp['mb_per_s']:.2f} MB/s)")
    if slo is not None:
        print(f"[serve] SLO bytes→verdict: p50 {slo['p50_ms']:.2f} ms, "
              f"p99 {slo['p99_ms']:.2f} ms, p999 {slo['p999_ms']:.2f} ms "
              f"({slo['completed']}/{slo['arrived']} served at "
              f"{slo['served_per_s']:.0f}/s, shed {slo['shed']} = "
              f"{slo['shed_rate']:.1%})")
        if slo.get("quarantined") or slo.get("failed"):
            print(f"[serve] faults: {slo['quarantined']} quarantined "
                  f"({slo['rejected']} pre-admission), "
                  f"{slo['failed']} failed, {slo['retries']} retries, "
                  f"dead-letter depth {slo['dead_letter_depth']}")
        print(f"[serve] loop: {slo['batches']} batches "
              f"(fill {slo['batch_fill']:.2f}; {slo['size_closes']} size / "
              f"{slo['deadline_closes']} deadline / "
              f"{slo['flush_closes']} flush closes), max queue depth "
              f"{slo['max_queue_depth']}/{args.queue_cap}, "
              f"{slo['backpressure_waits']} backpressure waits at "
              f"K={args.max_inflight}")
    if args.data_shards > 1:
        print(f"[serve] 2-D mesh data×model = "
              f"{tp['mesh_data']}×{tp['mesh_model']}: "
              f"{tp['docs_per_s_per_data_shard']:.0f} docs/s per data "
              f"shard, {tp['queries_per_model_shard']} queries per model "
              f"shard, {tp['overlapped_batches']} overlapped transfers "
              f"({tp['put_s']*1e3:.1f} ms staging)")

    # live subscription churn, served without stopping the stream
    churn = gen_profiles(dtd, n=4, length=3, seed=99)
    t0 = time.perf_counter()
    gids = [stage.subscribe(q) for q in churn]
    t_sub = time.perf_counter() - t0
    t0 = time.perf_counter()
    for gid in gids[:2]:
        stage.unsubscribe(gid)
    t_unsub = time.perf_counter() - t0
    re_routed = sum(len(r) for r in stage.route(payloads[:args.batch]))
    print(f"[serve] live churn: +{len(gids)} subscriptions "
          f"({t_sub/len(gids)*1e3:.1f} ms/op), -2 "
          f"({t_unsub/2*1e3:.1f} ms/op); re-routed {args.batch} requests "
          f"→ {re_routed} deliveries under the updated subscription set")

    # each replica generates over its queue, a batch of prompts at a time
    # (the same seeded draw as the JAX CLI; a short last batch still
    # fills every slot, and counts only its requests' tokens)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    n_tok = 0
    for rep, queue in enumerate(queues):
        for i in range(0, len(queue), args.batch):
            chunk = queue[i:i + args.batch]
            prompts = rng.integers(
                0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
            out = replica_engines[rep].generate({"tokens": prompts},
                                                args.gen_len)
            n_tok += out.shape[1] * len(chunk)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {n_tok} tokens across {args.replicas} "
          f"replicas in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
