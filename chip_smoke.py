#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: build, check, drive, time.

Run from the repository root, on a machine with one CUDA card (an H100:
the kernels are built for ``sm_90a``) and the CUDA toolkit::

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX.  Phases, each
printed as it runs; any failure exits non-zero:

1. environment: the card's name and power limit, ``nvcc --version``, and
   the kernels' build from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) with its ``-Xptxas -v`` report;
2. every kernel against its plain PyTorch version on the card, at the
   full-width plan (10,000 profiles, 11 state blocks of 64 words) on short
   documents: K1 and K4 on an event batch, K2 and K3 on unpacked and on
   packed segments with empty slots, K5 on the byte batch; and K6 at the
   levelwise plan (1,024 profiles, 3,712 states) at a wavefront step's
   shape and at the widest level's shape of the first 1 MB request, given
   the parent as ``parent_idx``, against its plain version (the gather)
   and against ``ref.nfa_transition`` (the product by the parent one-hot).
   Lanes, ordinals, predecoded bytes and K6's states must be equal; the
   sparse kernels' rows (whose order on the card is not fixed) as sorted
   sets, with exact counts;
3. the dense main path at full width: ``FilterStage(engine="streaming",
   batch_size=16).route_bytes`` over 4 requests of 16 documents of about
   1 MB (K2), then ``FilterStage.route`` over the same documents decoded
   on the host (K1).  Each run starts with the launch counts at 0 and
   must launch its kernel; the two routings, the packed route and the
   engine-level first-match ordinals must agree.  Then the first request
   as a sparse call with a cap past the epilogue budget: device parse
   (K5), then lane compaction of K1's lanes, equal to the dense verdicts;
4. sparse delivery at full width on pub-sub messages of 1-8 KB:
   ``FilterStage(sparse=True)`` over 4 requests of 16 documents,
   ``route_bytes`` unpacked and packed (K3) and ``route`` (K4), each on
   the fused path with no overflow; with ``match_cap=64`` each overflows
   to the dense kernels (K3 then K2, K4 then K1).  Every route must equal
   the dense stage's;
5. times: each kernel (CUDA events, after a warm-up; K5 and K6 from a
   CUDA graph of launches, since their kernels are about as short as a
   launch; K5 also one by one) and its plain version at the shapes its
   main path gives it, where their outputs must be equal too; the least time the card could
   take for the same work; K2's split (the same bytes with no tag: the
   front end alone; K1 on the same documents: the chain alone) and every
   chain kernel's time an event of its longest chain; for K6 also
   ``torch.index_select`` of the parents' values and ``torch.matmul`` by
   the parent one-hot in full float32, yardsticks the port never calls,
   and K6 must beat the product; docs/s and MB/s end to end; device
   memory;
6. the levelwise engines at 1,024 profiles over the 1 MB documents:
   ``FilterStage(engine="wavefront", engine_options={"use_kernel":
   True}).route_bytes`` over 2 requests of 16 (K5, then K6 once per chunk
   step), then ``engine="levelwise"`` with K6 over 1 request (K6 once per
   level).  Each must route as ``FilterStage(engine="streaming")`` at the
   same profiles (K2); on the first request so must the levelwise engine
   with ``torch.matmul`` and with gather and compare, and the bool
   wavefront, none of which launches K6.  Each request's time is split
   into parse, host bucketing and K6;
7. serving at the streaming plan: ``ServeLoop(FilterStage(sparse=True,
   batch_size=16, engine_options={"match_cap": 7168}), max_batch=16,
   deadline_ms=2, max_inflight=3, queue_cap=256)``, its workers each on a
   CUDA stream of their own.  (a) 1,024 requests of phase 4's messages,
   cycled, under Poisson arrivals at 4,000/s (seed 0): every delivered
   request must route as ``FilterStage.route_bytes`` (K3); p50/p99/p999
   latency, shed, batch fill, close reasons, docs/s.  (b) phase 3's 64
   documents of 1 MB, back to back with ``overload="block"``, at
   ``max_inflight`` 1 and 3 with ``validate=False`` (the host's
   pre-admission check of a 1 MB document, timed alone, takes longer
   than its share of K2), then at 3 with it: routes as phase 3 (K2),
   docs/s, and whether two batches' K2 launches overlapped on the card
   (CUDA events on the worker streams).  (c) (a)'s loop on a trace 16 times as long, with
   ``loop.subscribe`` of a new profile and ``loop.unsubscribe(0)`` at
   fixed points (a shadow build at full width takes about as long as
   (a)'s whole trace): each request must
   route as a synchronous stage built on the live set of the epoch it was
   filtered under; shadow build seconds.  (d) a malformed and an 80-deep
   payload in (a)'s trace: rejected at admission with
   ``MalformedDocument`` and ``DepthOverflow``, dead-lettered;
8. query-sharded plans: (a) ``FilterStage(query_shards=4)`` at the
   10,000 profiles, every part folded into ONE launch a request (P·G
   blocks): ``route_bytes`` and ``route`` over phase 3's requests (K2,
   K1) and, ``sparse=True``, over phase 4's (K3, K4), each equal to the
   unsharded stage's; the folded K2 and K1 timed at one request's shape,
   and the folded K1 and K4 against their plain versions with tombstoned
   columns; (b) churn: subscribe and unsubscribe build seconds and commit
   ms against the unsharded stage's rebuilds, then skewed churn and
   ``maybe_rebalance``, each commit routing as a fresh unsharded stage on
   its live set; (c) ``FilterStage(engine="wavefront", query_shards=2,
   engine_options={"use_kernel": True})`` at 1,024 profiles over one 1 MB
   request: K5, then K6 folded over the parts' states once per chunk
   step, routing as the streaming stage; (d) the chaos drill,
   ``run_chaos_trace(48)`` on the card with every check passing;
9. the rest of the one-card API: (a) the plan cache: phase 3's stage and
   phase 8's ``query_shards=4`` stage (and phase 6's wavefront stage with
   K6) each built twice on one ``PlanCache`` directory in a temporary
   directory: the first build only misses, the second only hits, with
   tables equal to the first's, and routes the first request of phase 3
   (K2) and, as a sparse stage, of phase 4 (K3) as those phases did; cold
   and warm build seconds beside ``compile_queries`` alone; then one
   part's ``manifest.json`` deleted: one miss, the entry rewritten, the
   same routes; (b) ``repro_torch.kernels.autotune.search`` over one
   request of phase 3 (K2, K3): every candidate's effective ``blk`` and
   ``G``, each distinct launch shape timed once, and an
   ``autotune="measured"`` stage that reads the winner and routes as the
   default stage; (c) ``TwigFilter(engine="streaming")`` with 1,024 twigs
   over phase 4's 64 messages (K1 a message), equal to the CPU filter and
   the oracle; (d) ``ops.predecode`` (K5), ``ops.decode_document`` of a
   1 MB document (K5), ``ops.nfa_transition`` at phase 2's K6 shapes given
   ``parent_1h`` (K6) and ``ops.StreamFilterKernelEngine`` (K1), each
   against its plain version or the stage; (e)
   ``XMLBytePipeline.from_filtered_bytes`` through a sparse stage (K3),
   ``launch.serve.build_stage`` twice on one plan cache,
   ``route_requests`` over events (K1) and bytes (K2) and
   ``serve_continuous`` on a replay trace (K2), all with equal queues;
10. the 2-D (data x model) mesh: (a) ``make_filter_mesh(4,
   data_shards=2)``'s placed shape (1 x 1 on one card) and the stage
   built on it (K2 once a position); (b) an explicit 2 x 2
   ``FilterMesh`` over the one card, each position on a stream of its
   own: ``route_bytes`` over phase 3's requests (K2 four times a
   request, timed on the host and per position with CUDA events) and
   ``route`` (K1), phase 4's messages through the sparse events route
   (K4) and the sparse bytes route (K2, sparsified), ``mesh=`` on
   ``filter_bytes_sharded_sparse`` (K3 at the 2 model positions), and the
   levelwise engine with K6 at 2 parts over one 1 MB request (K5 once a
   position, K6 once a level of each position's slice), every route
   equal to the unsharded stage's; (c) ``route_bytes_pipelined`` at
   depths 1 and 3, equal to ``route_bytes``, with ``overlapped_batches``;
   (d) a ``ServeLoop`` over the 2-D sparse stage on the first 2,048
   requests of phase 7(c)'s churn trace (phase 7(a)'s messages and
   rate), one subscribe and one unsubscribe, each request routed as
   phase 7(c)'s synchronous stage on its epoch's live set;
11. model serving: (a) qwen3-0.6b at its published width (28 layers,
   d_model 1,024, 16/8 heads of 128, vocab 151,936, float32 parameters
   drawn from seed 0) on the card against the port on the CPU, one
   16-token prompt, TF32 off: logits within 1e-3, the same greedy token;
   (b) the serving CLI's path at that width: ``build_stage(2,
   engine="streaming")`` routes 32 requests as bytes (K2), then each
   replica's ``ServeEngine`` (bfloat16 cache) generates its queue in
   batches of 8 with 128-token prompts and 32 new tokens: prefill ms and
   decode ms a step (CUDA events), tokens/s, peak device memory, the
   decode step's byte bound and its device-busy share (``torch.profiler``);
   (c) every architecture of the registry, reduced, on the card: prefill
   then decode equal to the full forward and to the CPU port's forward;
   (d) ``repro_torch.launch.serve.main`` once through ``sys.argv``
   (``--filter-engine streaming --ingest bytes``, the rest its defaults);
12. training: (a) every architecture of the registry, reduced, and
   qwen3-0.6b reduced with ``remat`` and 8-token CE chunks (the chunked
   cross-entropy and its recompute), on the card against the port on the
   CPU (the same parameters, float32, TF32 off): ``train_loss`` within
   1e-5 relative, every gradient leaf within ``rtol=1e-4, atol=1e-6``,
   3 AdamW and 3 Adafactor train steps' losses within 1e-5 relative, and
   the parameters and states after 3 updates of each optimizer from the
   same gradients within 1e-5; the parameters after the 3 full train
   steps are read, not held (see :func:`train_zoo`), with the gradient
   on each device of the element that moved most; (b) qwen3-0.6b at its
   published width (``remat``, ``ce_chunk`` 2,048, AdamW) on the training
   CLI's ingest, ``build_filtered_pipeline(batch=2, seq_len=4096,
   ingest="bytes")`` (K5, K6), whose routed documents with their matched
   profiles, kept payloads, token buffer and first batches must equal
   the CPU port's: 4 steps through ``run_training`` with a checkpoint every 2,
   then a restart from the step-2 checkpoint that must replay steps 3-4's
   losses bit for bit (``torch.use_deterministic_algorithms``); step ms
   (CUDA events), tokens/s, the step's FLOP count and rate, peak device
   memory, kernels a step and the card's busy share (``torch.profiler``),
   ``save`` s, the time ``save_async`` blocks and ``restore`` s; (c) the
   training CLI's ``main`` on the card, ``--data-filter --data-ingest
   bytes`` (K5, K6) and ``events`` (K6), 6 steps, a checkpoint every 3:
   the ingest it built equal to the CPU port's as in (b), the loss
   falling;
13. the LM substrate on a mesh (no kernel of its own; its launch counts
   are read and must stay 0): (a) qwen3-0.6b at its published width in
   bfloat16 saved and restored bit for bit (``|V2`` in the npz,
   ``"bfloat16"`` in the manifest), each timed on the host clock; (b) the
   rule specs of the float32 model on ``make_host_mesh()`` and on a 2 x 2
   grid of the card (leaves split, bytes a position), then the elastic
   flow on the grid: save from one device, restore onto 2 x 2 (gathered
   bit for bit, some leaf split), save from the placed layout, restore
   replicated (bit for bit), each timed; (c) one MoE layer of
   qwen3-moe-30b-a3b at its published width on the grid, forward and
   backward at n = 32 (the weights-stationary branch) and n = 4,096 (the
   shard-map branch): each branch's dropped assignments; held against the
   card's single-device ``moe`` where neither drops one, else against the
   same dispatch with its positions one after another on the default
   stream; ms a branch (CUDA events) and peak memory; reduced qwen3-moe
   and deepseek-v3 on the grid against the CPU port's expert-parallel
   path, both branches;
14. the cell table, the meta-device dry run and the sharded train step
   (the steps launch no kernel of the table; their byte ingest launches
   K5 and K6): (a) every cell of ``enumerate_cells`` at both production
   meshes from its specs (argument and gradient bytes a position,
   ``fits_h100_80g``), and the qwen3-0.6b and qwen3-moe-30b-a3b
   ``train_4k`` cells' FLOPs and saved-activation estimate on the meta
   device; (b) qwen3-0.6b at its published width (float32, remat,
   ``ce_chunk`` 2,048, AdamW, TF32 off) on a 2 x 2 grid of the card,
   parameters placed by ``param_shardings`` and the optimizer state by
   ``opt_state_specs``, on ``build_filtered_pipeline(batch=2,
   seq_len=4096, ingest="bytes")``'s batches (K5, K6): the sharded step's
   loss and gathered gradients held to the one-device step's on the
   card, the updates from the same gradients, a second step's loss, the
   output shardings equal to the input's and the placed bytes a position
   equal to the dry run's; step ms (CUDA events), tokens/s, TFLOP/s,
   kernels and busy share (``torch.profiler``), peak memory beside the
   dry run's estimate; (c) the same for qwen3-moe-30b-a3b at its
   published widths with 2 of its 48 layers, at 4 x 4 tokens (the
   weights-stationary dispatch) and 4 x 4,096 (the shard-map dispatch,
   timed), each dispatch's dropped assignments counted (where any drop,
   the reference is the sharded step with its positions one after
   another);
15. the end-to-end line, one ``{"kernels": [...]}`` line, the card line,
   and the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the full-width deployment: ten thousand standing XPath subscriptions of
# path length 6 over a 128-tag DTD, against ~1 MB documents (the paper's
# §4 workload at the README's profile scale) and 1-8 KB pub-sub messages
N_TAGS, FANOUT = 128, 4
N_PROFILES, PATH_LENGTH, P_DESC, P_WILD = 10_000, 6, 0.3, 0.1
MAX_DEPTH = 64
DOC_NODES, DOC_DEPTH, TEXT_FILL = 60_000, 12, 8
BATCH, REQUESTS, DISTINCT_DOCS = 16, 4, 16
SHORT_DOC_NODES = (60, 150, 300, 470)      # 1-8 KB documents
# sparse delivery: a cap the fused epilogue takes at this plan (QB = 912),
# one that overflows, and one past the epilogue budget
SPARSE_CAP, OVERFLOW_CAP, PAST_BUDGET_CAP = 7168, 64, 160_000

# the levelwise engines keep a dense (S, S) parent one-hot and K6 is a
# W x S x S product, so their full width is the paper's section-4 profile
# count (16-1,024 profiles of length 2/4/6), not the streaming plan's:
# 1,024 profiles of length 6 (3,712 states), 2 requests of the 1 MB
# documents through the wavefront engine and 1 through the levelwise
LEVEL_PROFILES, LEVEL_REQUESTS, LEVEL_CHUNK = 1024, 2, 128

# phase 7, serving: ServeLoop(max_batch=16, deadline_ms=2, max_inflight=3,
# queue_cap=256) at 4,000 requests/s (about half the synchronous sparse
# stage's docs/s on the H100), poison at fixed points of (a)'s trace.  A
# shadow build at this width recompiles all 10,000 profiles (a few tenths
# of a second on the host, about (a)'s whole 0.26 s trace), so the churn
# runs on a trace of 16 of (a)'s lengths at the same rate: both swaps
# commit inside it and every epoch serves requests
SERVE_REQUESTS, SERVE_RATE_HZ = 1024, 4000.0
SERVE_DEADLINE_MS, SERVE_QUEUE_CAP = 2, 256
SERVE_DENSE_RUNS = ((1, False), (3, False), (3, True))  # depth, validate
POISON_AT, POISON_DEPTH = (100, 700), 80
SERVE_CHURN_REQUESTS, SUBSCRIBE_AT, UNSUBSCRIBE_AT = 16_384, 0, 1024

# phase 8, query-sharded plans: the streaming plan in 4 parts (phases 3
# and 4's requests), then skewed churn -- unsubscribes from the largest
# part -- and a rebalance at a tolerance the skew exceeds; the levelwise
# plan in 2 parts over phase 6's first request; the chaos drill at its
# default 48 requests
SHARD_PARTS, LEVEL_SHARDS = 4, 2
SKEW_UNSUBSCRIBES, REBALANCE_TOLERANCE = 400, 0.02

# phase 9, the rest of the one-card API: the measured autotune's grid over
# one request of phase 3's documents (every block size up to the one the
# 10,000-profile plan grows to, both segment targets); 1,024 twigs in the
# three shapes of benchmarks/bench_twig.py over phase 4's messages, held
# against the CPU filter on all of them and against the oracle, about
# 1.6 s a message on the host, on the first 8; the serving CLI's stage
# (32 profiles, 2 replicas) over 8 requests
AUTOTUNE_BLKS, AUTOTUNE_SEGMENT_TARGETS = (256, 512, 1024, 2048), (2048, 4096)
AUTOTUNE_TRIALS = 2
N_TWIGS, TWIG_ORACLE_DOCS = 1024, 8
# each plan-cache build kind (cold, warm) is timed this many times and
# reported by its median: single builds on the shared host spread by 2x
CACHE_REPEATS = 3
CLI_REPLICAS, CLI_REQUESTS = 2, 8

# phase 10, the 2-D mesh: the mesh make_filter_mesh places on this host,
# then an explicit 2 x 2 grid of positions on the one card, its stages at
# 2 query parts (one a model position); the pipelined route at depths 1
# and 3; the serve loop on the first 2,048 requests of phase 7(c)'s churn
# trace (phase 7(a)'s messages and rate) with its subscribe and
# unsubscribe: twice (a)'s length, so both shadow builds commit inside it
# and the loop serves it in a few seconds
MESH_DATA, MESH_MODEL = 2, 2
MESH_DEPTHS = (1, 3)
MESH_SERVE_REQUESTS = 2048

# phase 11, model serving: qwen3-0.6b at its published width; 32
# requests of the CLI's workload routed over 2 replicas, each queue
# generated in batches of 8, 128-token prompts, 32 new tokens; one
# 16-token prompt against the CPU; the reduced registry at batch 2, 16
# tokens
LM_ARCH = "qwen3-0.6b"
LM_REQUESTS, LM_REPLICAS, LM_BATCH = 32, 2, 8
LM_PROMPT, LM_NEW, LM_CHECK_TOKENS = 128, 32, 16
LM_TOL = 1e-3
LM_ZOO_BATCH, LM_ZOO_SEQ, LM_ZOO_TOL = 2, 16, 2e-4

# phase 12, training: the reduced registry at batch 2, 16 tokens (and
# reduced qwen3-0.6b in two 8-token CE chunks), card against CPU; qwen3-0.6b at its published width on the training CLI's
# byte ingest, batch 2 of 4,096 tokens (two 2,048-token CE chunks), 4
# steps with a checkpoint every 2, restarted from step 2; the CLI's main
# for 6 steps, a checkpoint every 3
TRAIN_ZOO_BATCH, TRAIN_ZOO_SEQ, TRAIN_ZOO_STEPS = 2, 16, 3
TRAIN_ZOO_CE_CHUNK = 8
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-5, 1e-4, 1e-6
TRAIN_PARAM_TOL = 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 2, 4096, 4, 2
TRAIN_CLI_STEPS, TRAIN_CLI_CKPT_EVERY = 6, 3

# phase 13, the LM substrate on a mesh: an explicit 2 x 2 grid of the one
# card; one MoE layer of qwen3-moe-30b-a3b at its published width (every
# width as published, the depth cut to one layer) at a decode-sized and a
# prefill-sized token count, the reduced zoo's MoE models at the CPU
# tests' token counts; the bounds of tests/test_moe_ep.py
MESH_LM_DATA, MESH_LM_MODEL = 2, 2
MOE_ARCH, MOE_TOKENS = "qwen3-moe-30b-a3b", ((32, "stationary"),
                                             (4096, "shardmap"))
MOE_ZOO, MOE_ZOO_SHAPES = ("qwen3-moe-30b-a3b", "deepseek-v3-671b"), (
    (4, 8), (4, 552))
MOE_FWD_TOL, MOE_GRAD_RTOL, MOE_TIMED_REPS = 1e-4, 1e-5, 3

# phase 14, the cell table, the dry run and the sharded train step: every
# cell at both production meshes from its specs, and the FLOPs of two
# train cells on the meta device; the sharded step of qwen3-0.6b at its
# published width on phase 13's 2 x 2 grid of the card, on phase 12(b)'s
# batches (2 x 4,096 tokens from the byte ingest); qwen3-moe-30b-a3b at
# its published widths with 2 of its 48 layers on the same grid, at 4
# rows of 4 tokens (its 2 microbatches of 8 tokens take the
# weights-stationary dispatch, whose capacity, 8, no expert can pass) and
# of 4,096 (the shard-map dispatch); the bounds of phase 12(a)
SHARDED_FLOP_CELLS = ("qwen3-0.6b", "qwen3-moe-30b-a3b")
SHARDED_MOE_LAYERS = 2
SHARDED_MOE_BATCHES = ((4, 4, "stationary"), (4, 4096, "shardmap"))
SHARDED_TIMED_STEPS = 2

# card peaks (H100 SXM data sheet): HBM bytes/s, the 32-bit non-tensor
# rate, which bounds the kernels' integer bit operations and K6's float32
# arithmetic, and the dense bf16 tensor-core rate (the line a tensor-core
# form of the TPU kernel's product would have had, kept as history)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
# K6 per output: the parent select, the tag-match add, two products, the
# clamp (the valid mask folds into the last)
K6_OPS_PER_OUTPUT = 5
# operation counts of the least work the kernels' functions need: per
# OPEN event, per state block, per packed word: 4 per parent bit the tag
# can match (load, shift, mask, place) + 4 (tag mask, self-loop, or,
# accept test); per CLOSE event and block: 1 (the pop); per byte: 12 to
# classify it (compare '<' and '/', two symbol lookups, select), once;
# per lane of each emitted (document, block): 2 (the hit test, its rank)
OPS_PER_SOURCE_BIT, OPS_PER_WORD, OPS_PER_CLOSE, OPS_PER_BYTE = 4, 4, 1, 12
OPS_PER_EMITTED_LANE = 2
# K5's time at the phase-5 shape with its first design (a thread a
# position), one by one between CUDA events, from this script on an H100
# 80GB HBM3 at 700 W
K5_BEFORE_MS = 0.0920
SOURCE = "src/repro_torch/kernels/csrc/stream_filter.cu"
KERNELS = (  # id, name, source, replaced TPU kernel
    ("K2", "stream_filter_bytes", SOURCE,
     "src/repro/kernels/stream_filter.py:667 (stream_filter_bytes_pallas)"),
    ("K1", "stream_filter", SOURCE,
     "src/repro/kernels/stream_filter.py:311 (stream_filter_pallas)"),
    ("K3", "stream_filter_bytes_sparse", SOURCE,
     "src/repro/kernels/stream_filter.py:751 "
     "(stream_filter_bytes_pallas_sparse)"),
    ("K4", "stream_filter_sparse", SOURCE,
     "src/repro/kernels/stream_filter.py:395 (stream_filter_pallas_sparse)"),
    ("K5", "predecode", "src/repro_torch/kernels/csrc/predecode.cu",
     "src/repro/kernels/predecode.py:57 (predecode_pallas)"),
    ("K6", "nfa_transition", "src/repro_torch/kernels/csrc/nfa_transition.cu",
     "src/repro/kernels/nfa_transition.py:43 (nfa_transition_pallas)"),
)

T0 = time.perf_counter()


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, warmup: int, reps: int):
    """(mean device time of ``fn()`` in ms from CUDA events, last result)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def graph_ms(fn, *, reps: int) -> float:
    """Mean device time of ``fn()`` in ms with no host time between calls:
    ``reps`` calls captured in one CUDA graph, replayed between CUDA
    events.  For kernels shorter than the host's time to launch them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


def max_abs_err(kernel_out, plain_out) -> int:
    return max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
               for k, p in zip(kernel_out, plain_out))


def sorted_rows(buf: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The valid rows of a sparse buffer, sorted (card order is not fixed)."""
    rows = buf[:min(int(count[0]), buf.shape[0])].cpu().long()
    for col in (2, 1, 0):      # stable sorts, last key first
        rows = rows[torch.argsort(rows[:, col], stable=True)]
    return rows


def sparse_err(kernel_out, plain_out, what: str) -> int:
    """max |kernel - plain| over the sorted valid rows; counts must match."""
    kn, pn = int(kernel_out[1][0]), int(plain_out[1][0])
    check(kn == pn, f"{what}: kernel counted {kn} rows, plain {pn}")
    check(kn <= kernel_out[0].shape[0], f"{what}: overflowed its buffer")
    return max_abs_err([sorted_rows(*kernel_out)], [sorted_rows(*plain_out)])


def reset_counts() -> None:
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import predecode as pd
    from repro_torch.kernels import stream_filter as sf

    for fn in (sf.stream_filter, sf.stream_filter_bytes,
               sf.stream_filter_sparse, sf.stream_filter_bytes_sparse,
               pd.predecode, nt.nfa_transition):
        fn.launches = 0


def counts() -> dict:
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import predecode as pd
    from repro_torch.kernels import stream_filter as sf

    return {"K1": sf.stream_filter.launches,
            "K2": sf.stream_filter_bytes.launches,
            "K3": sf.stream_filter_bytes_sparse.launches,
            "K4": sf.stream_filter_sparse.launches,
            "K5": pd.predecode.launches,
            "K6": nt.nfa_transition.launches}


def drive(what: str, fn, want: set[str]):
    """Run ``fn`` with every count at 0; it must launch exactly ``want``."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = counts()
    say(f"{what}: launches {got}")
    for k, n in got.items():
        check((n > 0) == (k in want),
              f"{what} launched {k} {n} times; expected "
              f"{'some' if k in want else 'none'}")
    return out, got


# ----------------------------------------------------------------- phase 1
def environment():
    from repro_torch.kernels import build

    say("phase 1: environment")
    print(card_line(), flush=True)
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print(nvcc.stdout.strip(), flush=True)
    t = time.perf_counter()
    libs = build.build()
    say(f"built {sorted(map(str, libs.values()))} in "
        f"{time.perf_counter() - t:.1f} s from "
        f"{[os.path.relpath(s, ROOT) for s in build.SOURCES]} with nvcc "
        f"{' '.join(build.FLAGS)} (one nvcc per source, in parallel)")
    print(build.build_log().strip(), flush=True)


# ----------------------------------------------------------------- phase 2
def workload():
    from repro_torch.core.dictionary import TagDictionary
    from repro_torch.data.generator import DTD, gen_profiles

    dtd = DTD.generate(n_tags=N_TAGS, fanout=FANOUT, seed=0)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=N_PROFILES, length=PATH_LENGTH, p_desc=P_DESC,
                      p_wild=P_WILD, seed=0)
    return dtd, d, qs


def level_profiles(dtd):
    """The levelwise engines' profiles: the same generator at 1,024."""
    from repro_torch.data.generator import gen_profiles

    return gen_profiles(dtd, n=LEVEL_PROFILES, length=PATH_LENGTH,
                        p_desc=P_DESC, p_wild=P_WILD, seed=0)


def big_documents(dtd) -> list[bytes]:
    """The 16 distinct documents of about 1 MB that phases 3 and 6 route."""
    from repro_torch.core.events import encode_bytes
    from repro_torch.data.generator import gen_document

    t = time.perf_counter()
    bufs = [encode_bytes(gen_document(dtd, target_nodes=DOC_NODES,
                                      max_depth=DOC_DEPTH, seed=i),
                         text_fill=TEXT_FILL) for i in range(DISTINCT_DOCS)]
    say(f"{DISTINCT_DOCS} distinct documents of {min(map(len, bufs))}-"
        f"{max(map(len, bufs))} bytes in {time.perf_counter() - t:.1f} s")
    return bufs


def request_payloads(bufs, requests: int) -> list[bytes]:
    """``requests`` requests of BATCH documents, each taking the distinct
    documents in another order."""
    return [bufs[(i + 3 * r) % DISTINCT_DOCS]
            for r in range(requests) for i in range(BATCH)]


def level_layout(bufs, d) -> dict:
    """K6's shapes on the first 1 MB request, from the host bucketing the
    engines run: a wavefront step is BATCH x LEVEL_CHUNK rows, a levelwise
    level BATCH x the widest level (every level is padded to it)."""
    from repro_torch.core.engines import levelwise as lw
    from repro_torch.core.events import EventBatch, decode_bytes

    sym = d.symbol_value_table()
    batch = EventBatch.from_streams(
        [decode_bytes(b, sym) for b in request_payloads(bufs, 1)])
    lds = lw._leveldocs_of_batch(batch)
    widths = [int(w) for ld in lds for w in ld.valid.sum(1)]
    levels, widest = lw._stack_leveldocs(lds).tags.shape[1:]
    n_chunks = max(lw.chunkize_level(ld, LEVEL_CHUNK).n_chunks for ld in lds)
    out = {"step_rows": BATCH * LEVEL_CHUNK, "levels": levels,
           "widest": widest, "level_rows": BATCH * widest,
           "chunks": n_chunks}
    say(f"levelwise layout of the first request: {out['levels']} levels, "
        f"level widths {min(widths)}-{max(widths)}, widest {out['widest']}; "
        f"{n_chunks} chunks of {LEVEL_CHUNK} in the longest document")
    return out


def kernels_vs_plain(dtd, tables, lane_cls, dev) -> dict:
    """Phase 2: each kernel against its plain version, on the card."""
    from repro_torch.core.events import (SEG_SENTINEL, ByteBatch,
                                         EventBatch, encode_bytes,
                                         pack_segments)
    from repro_torch.data.generator import gen_document
    from repro_torch.kernels import predecode as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_filter as sf

    say("phase 2: kernels against their plain versions at the full-width "
        f"plan (G, T+1, WB) = {tuple(tables[0].shape)}, QB = "
        f"{tables[5].shape[1]}")
    docs = [gen_document(dtd, target_nodes=n, max_depth=DOC_DEPTH,
                         seed=100 + 10 * i + j)
            for i, n in enumerate(SHORT_DOC_NODES) for j in range(2)]
    bufs = [encode_bytes(x, text_fill=TEXT_FILL) for x in docs] + [b""]
    say(f"{len(bufs)} documents of {min(map(len, bufs))}-"
        f"{max(map(len, bufs))} bytes")
    errs = {}

    batch = EventBatch.from_streams(docs, bucket=64)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id)).to(dev)
    k = sf.stream_filter(events, *tables, max_depth=MAX_DEPTH)
    p = sf.stream_filter_plain(events, *tables, max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    check(bool(p[0].any()), "K1 plain version matched nothing")
    errs["K1"] = max_abs_err(k, p)
    say(f"K1 events {tuple(events.shape)}: max |kernel - plain| = "
        f"{errs['K1']}")
    check(errs["K1"] == 0, "K1 disagrees with its plain version")
    # K4: the same stream, rows named by batch row; K1's plain lanes
    # through the plain epilogue are its plain version
    doc_ids = torch.arange(len(docs), dtype=torch.int32, device=dev)[:, None]
    k4 = sf.stream_filter_sparse(events, doc_ids, *tables, lane_cls,
                                 cap=SPARSE_CAP, max_depth=MAX_DEPTH)
    p4 = ref.sparse_epilogue(*p, lane_cls, doc_ids, SPARSE_CAP)
    check(int(p4[1][0]) > 0, "K4 plain version emitted no row")
    errs["K4"] = sparse_err(k4, p4, "K4")
    say(f"K4 events {tuple(events.shape)}, {int(p4[1][0])} rows: max "
        f"|kernel - plain| over sorted rows = {errs['K4']}")
    check(errs["K4"] == 0, "K4 disagrees with its plain version")

    bb = ByteBatch.from_buffers(bufs, bucket=1024)
    one = np.full((bb.batch_size, 2), SEG_SENTINEL, np.int32)
    one[:, 0] = 0
    sp = pack_segments(bb, target_len=4096)
    check(bool((sp.doc_ids < 0).any()), "packed batch has no empty slot")
    for label, data, starts, doc_map in (
            ("unpacked", bb.data, one,
             np.arange(bb.batch_size, dtype=np.int32)[:, None]),
            ("packed", sp.data, sp.starts, sp.doc_ids)):
        data = torch.from_numpy(data).to(dev)
        starts = torch.from_numpy(starts).to(dev)
        doc_map = torch.from_numpy(doc_map).to(dev)
        k = sf.stream_filter_bytes(data, starts, *tables, max_depth=MAX_DEPTH)
        p = sf.stream_filter_bytes_plain(data, starts, *tables,
                                         max_depth=MAX_DEPTH)
        torch.cuda.synchronize()
        check(bool(p[0].any()), f"K2 plain version ({label}) matched nothing")
        err = max_abs_err(k, p)
        errs["K2"] = max(errs.get("K2", 0), err)
        say(f"K2 {label} data {tuple(data.shape)} starts "
            f"{tuple(starts.shape)}: max |kernel - plain| = {err}")
        check(err == 0, f"K2 ({label}) disagrees with its plain version")
        k3 = sf.stream_filter_bytes_sparse(data, starts, doc_map, *tables,
                                           lane_cls, cap=SPARSE_CAP,
                                           max_depth=MAX_DEPTH)
        p3 = ref.sparse_epilogue(*p, lane_cls, doc_map, SPARSE_CAP)
        err = sparse_err(k3, p3, f"K3 ({label})")
        errs["K3"] = max(errs.get("K3", 0), err)
        say(f"K3 {label}, {int(p3[1][0])} rows: max |kernel - plain| over "
            f"sorted rows = {err}")
        check(err == 0, f"K3 ({label}) disagrees with its plain version")

    data = torch.from_numpy(bb.data).to(dev)
    k5, p5 = pd.predecode(data), ref.predecode(data)
    torch.cuda.synchronize()
    check(bool((p5[0] != ref.PAD).any()), "K5 plain version found no tag")
    errs["K5"] = max_abs_err(k5, p5)
    say(f"K5 bytes {tuple(data.shape)}: max |kernel - plain| = "
        f"{errs['K5']}")
    check(errs["K5"] == 0, "K5 disagrees with its plain version")
    return errs


def k6_inputs(plan, rows: int, seed: int, dev):
    """K6's inputs at one shape: seeded 0/1 parent rows (2 % ones), tags in
    [-1, T+2) (pads and tags past the tag space), and the plan's tables,
    the parent as ``parent_idx`` (the plan's ``in_state``), as the engines
    pass it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t, s = plan["req"].shape
    parent = torch.empty((rows, s), dtype=torch.float32,
                         device=dev).bernoulli_(0.02, generator=g)
    tags = torch.randint(-1, t + 2, (rows,), generator=g, device=dev,
                         dtype=torch.int32)
    return (parent, tags, plan["req"], plan["wild"], plan["in_state"],
            plan["selfloop"])


def k6_vs_plain(level_plan, layout, dev) -> float:
    """Phase 2, K6: the kernel against its plain version (the gather by
    ``parent_idx``) and against ``ref.nfa_transition`` (the TPU kernel's
    product by the parent one-hot, full float32) at a wavefront step's
    shape and at the widest level's, on the card."""
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import ref

    err = 0.0
    check(torch.equal(nt.parent_index(level_plan["parent_1h"]),
                      level_plan["in_state"]),
          "the plan's in_state is not its parent one-hot's index")
    for label, rows in (("wavefront step", layout["step_rows"]),
                        ("widest level", layout["level_rows"])):
        args = k6_inputs(level_plan, rows, rows, dev)
        k = nt.nfa_transition(*args)
        p = nt.nfa_transition_plain(*args)
        torch.cuda.synchronize()
        check(bool(p.any()) and not bool(p.all()),
              f"K6 plain version at the {label} is constant")
        e = float((k - p).abs().max())
        del p
        product = ref.nfa_transition(*args[:4], level_plan["parent_1h"],
                                     args[5])
        torch.cuda.synchronize()
        e_product = float((k - product).abs().max())
        say(f"K6 {label} ({rows}, {args[0].shape[1]}): max |kernel - plain| "
            f"= {e}, max |kernel - product form| = {e_product}")
        check(e == 0, f"K6 disagrees with its plain version at the {label}")
        check(e_product == 0, f"K6 disagrees with ref.nfa_transition at the "
                              f"{label}")
        err = max(err, e, e_product)
        del args, k, product
        torch.cuda.empty_cache()
    return err


# ----------------------------------------------------------------- phase 3
def routed(batches) -> list:
    return [(r.doc_index, r.shard, tuple(r.matched_profiles.tolist()))
            for batch in batches for r in batch]


def main_path(d, qs, bufs, dev):
    """Phase 3: the dense main path at full width, K2 then K1; then the
    first request's sparse call past the epilogue budget (K5, K1)."""
    from repro_torch.core.events import ByteBatch, EventBatch, decode_bytes
    from repro_torch.data.filter_stage import FilterStage

    say(f"phase 3: main path, {REQUESTS} requests x {BATCH} documents")
    payloads = request_payloads(bufs, REQUESTS)
    n_bytes = sum(map(len, payloads))
    say(f"{len(payloads)} payloads, {n_bytes} bytes")

    t = time.perf_counter()
    stage = FilterStage(profiles=qs, dictionary=d, engine="streaming",
                        batch_size=BATCH, device=str(dev))
    meta = stage._eng.plan_.meta
    say(f"plan in {time.perf_counter() - t:.1f} s: {meta}")
    list(stage.route_bytes(payloads[:BATCH]))          # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stage.stats.update(batches=0, docs=0, bytes=0, seconds=0.0,
                       pair_matches=0, pairs=0, verdict_bytes=0)

    t = time.perf_counter()
    by_bytes, launches = drive("route_bytes (dense)",
                               lambda: list(stage.route_bytes(payloads)),
                               {"K2"})
    e2e_s = time.perf_counter() - t
    stats = stage.throughput()
    mem = {"max_allocated_bytes": torch.cuda.max_memory_allocated(),
           "allocated_bytes": torch.cuda.memory_allocated()}

    sym = d.symbol_value_table()
    streams = [decode_bytes(b, sym) for b in payloads]
    by_events, got = drive("route (host-decoded events, dense)",
                           lambda: list(stage.route(streams)), {"K1"})
    launches["K1"] = got["K1"]

    a, b = routed(by_bytes), routed(by_events)
    check(a == b, "K2 (bytes) and K1 (host-decoded events) route differently")
    packed = FilterStage(profiles=qs, dictionary=d, engine="streaming",
                         batch_size=BATCH, device=str(dev),
                         engine_options={"pack": True})
    check(routed(packed.route_bytes(payloads)) == a,
          "the packed route differs from the unpacked route")
    n_docs_matched = len({r[0] for r in a})
    say(f"routings agree: {len(a)} routed documents of {len(payloads)}, "
        f"selectivity {stats['selectivity']:.6f}")
    check(0 < stats["selectivity"] < 1, "degenerate selectivity")
    check(n_docs_matched > 0, "no document matched any profile")

    # engine level, first request: verdicts (B, Q) and first-match ordinals
    eng = stage._eng
    bb = ByteBatch.from_buffers(payloads[:BATCH], bucket=stage.byte_bucket)
    batch = EventBatch.from_streams(streams[:BATCH], bucket=stage.bucket)
    r2, r2p, r1 = (eng.filter_bytes(bb), eng.filter_bytes(bb, pack=True),
                   eng.filter_batch(batch))
    for name, r in (("packed K2", r2p), ("K1", r1)):
        check(r.matched.shape == (BATCH, N_PROFILES),
              f"{name} verdicts have shape {r.matched.shape}")
        check(np.array_equal(r.matched, r2.matched)
              and np.array_equal(r.first_event, r2.first_event),
              f"{name} verdicts or first-match ordinals differ from K2")
    say("engine level: K2, packed K2 and K1 give equal verdicts and "
        "first-match ordinals")

    # the first request as a sparse call past the epilogue budget: device
    # parse (K5), then lane compaction of K1's lanes
    check(not eng._fused_sparse_ok(PAST_BUDGET_CAP),
          f"match_cap={PAST_BUDGET_CAP} is within the epilogue budget")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sp, got = drive(f"filter_bytes_sparse(match_cap={PAST_BUDGET_CAP})",
                    lambda: eng.filter_bytes_sparse(
                        bb, match_cap=PAST_BUDGET_CAP), {"K5", "K1"})
    parse_s = time.perf_counter() - t
    launches["K5"] = got["K5"]
    parse_mem = torch.cuda.max_memory_allocated()
    say(f"parse then lane-compact: path {sp.meta['path']}, "
        f"{sp.meta['device_rows']} device rows, {sp.n_matches} matches, "
        f"{sp.verdict_bytes} verdict bytes in {parse_s:.3f} s; peak device "
        f"memory {parse_mem} bytes (the parent-pointer table and its "
        f"cummax)")
    check(sp.meta["path"] == "lane-compact" and not sp.overflowed,
          f"the past-budget sparse call took {sp.meta}")
    dense = sp.densify()
    check(np.array_equal(dense.matched, r2.matched)
          and np.array_equal(dense.first_event, r2.first_event),
          "parse then lane-compact differs from the dense verdicts")
    say("parse then lane-compact densifies to the dense verdicts")
    return dict(stage=stage, payloads=payloads, streams=streams,
                e2e_s=e2e_s, n_bytes=n_bytes, launches=launches,
                stats=stats, mem=mem, parse_mem=parse_mem, routes=a)


# ----------------------------------------------------------------- phase 4
def short_payloads(dtd):
    from repro_torch.core.events import encode_bytes
    from repro_torch.data.generator import gen_document

    return [encode_bytes(gen_document(
        dtd, target_nodes=SHORT_DOC_NODES[i % len(SHORT_DOC_NODES)],
        max_depth=DOC_DEPTH, seed=1000 + i), text_fill=TEXT_FILL)
        for i in range(REQUESTS * BATCH)]


def sparse_phase(dtd, d, qs, dev) -> dict:
    """Phase 4: sparse delivery of short messages at full width."""
    from repro_torch.core.events import decode_bytes
    from repro_torch.data.filter_stage import FilterStage

    payloads = short_payloads(dtd)
    streams = [decode_bytes(b, d.symbol_value_table()) for b in payloads]
    n_bytes = sum(map(len, payloads))
    say(f"phase 4: sparse delivery, {REQUESTS} requests x {BATCH} "
        f"documents of {min(map(len, payloads))}-{max(map(len, payloads))} "
        f"bytes ({n_bytes} bytes)")

    def stage(**opts):
        return FilterStage(profiles=qs, dictionary=d, engine="streaming",
                           batch_size=BATCH, device=str(dev), **opts)

    dense = stage()
    want, _ = drive("dense route_bytes", lambda: routed(
        dense.route_bytes(payloads)), {"K2"})
    check(len({r[0] for r in want}) > 0, "no short document matched")
    dense_stats = dict(dense.stats)
    sparse = stage(sparse=True, engine_options={"match_cap": SPARSE_CAP})
    list(sparse.route_bytes(payloads[:BATCH]))         # warm-up request
    torch.cuda.synchronize()
    sparse.stats.update(batches=0, docs=0, bytes=0, seconds=0.0,
                        pair_matches=0, pairs=0, verdict_bytes=0,
                        device_rows=0, paths={})
    t = time.perf_counter()
    got, launches = drive("sparse route_bytes", lambda: routed(
        sparse.route_bytes(payloads)), {"K3"})
    e2e_s = time.perf_counter() - t
    s = dict(sparse.stats)
    check(s["paths"] == {"kernel-fused": REQUESTS},
          f"sparse route_bytes took the paths {s['paths']}")
    check(got == want, "sparse route_bytes differs from the dense route")
    say(f"sparse route_bytes: {len(payloads) / e2e_s:.1f} docs/s, "
        f"{n_bytes / e2e_s / 1e6:.2f} MB/s (host clock); "
        f"{s['device_rows']} device rows, {s['pair_matches']} matches, "
        f"verdict bytes {s['verdict_bytes']} against "
        f"{dense_stats['verdict_bytes']} dense; paths {s['paths']}")
    results = {"e2e_s": e2e_s, "n_docs": len(payloads), "n_bytes": n_bytes,
               "routes": want, "stats": s, "dense_verdict_bytes":
                   dense_stats["verdict_bytes"], "launches": launches,
               "payloads": payloads, "streams": streams}

    runs = (
        ("sparse route_bytes pack=True", {"pack": True}, "bytes", {"K3"},
         "kernel-fused"),
        ("sparse route (host-decoded events)", {}, "events", {"K4"},
         "kernel-fused"),
        (f"sparse route_bytes match_cap={OVERFLOW_CAP}", {}, "bytes",
         {"K3", "K2"}, "dense-overflow"),
        (f"sparse route match_cap={OVERFLOW_CAP}", {}, "events",
         {"K4", "K1"}, "dense-overflow"))
    for what, opts, ingest, kernels, path in runs:
        cap = OVERFLOW_CAP if path == "dense-overflow" else SPARSE_CAP
        st = stage(sparse=True, engine_options={"match_cap": cap, **opts})
        r, got_launches = drive(what, lambda: routed(
            st.route_bytes(payloads) if ingest == "bytes"
            else st.route(streams)), kernels)
        check(st.stats["paths"] == {path: REQUESTS},
              f"{what} took the paths {st.stats['paths']}")
        check(r == want, f"{what} differs from the dense route")
        say(f"{what}: paths {st.stats['paths']}, {st.stats['device_rows']} "
            f"device rows; routes as the dense stage")
        if what == "sparse route (host-decoded events)":
            results["launches"]["K4"] = got_launches["K4"]
    return results


# ----------------------------------------------------------------- phase 5
def work_counts(tables, kind: np.ndarray, tag: np.ndarray) -> int:
    """Operations the filter needs on these events (see OPS_*)."""
    from repro_torch.core.events import CLOSE, OPEN

    tagmask = tables[0].cpu().numpy().view(np.uint32)     # (G, T+1, WB)
    g, t1, _ = tagmask.shape
    bits = np.unpackbits(tagmask.view(np.uint8), axis=-1).reshape(
        g, t1, -1).sum(-1)                                # (G, T+1)
    per_tag = (OPS_PER_SOURCE_BIT * bits
               + OPS_PER_WORD * tagmask.shape[2]).sum(0)  # (T+1,)
    opens = tag[kind == OPEN]
    tclip = np.where((opens >= 0) & (opens < t1 - 1), opens, t1 - 1)
    hist = np.bincount(tclip, minlength=t1)
    return int(hist @ per_tag) + OPS_PER_CLOSE * g * int((kind == CLOSE).sum())


def bound(n_bytes: int, n_ops: int, ops_per_s: float = INT32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def request_inputs(payloads, streams, stage, dev):
    """One request's kernel inputs: bytes, one-doc starts, doc map, events."""
    from repro_torch.core.events import SEG_SENTINEL, ByteBatch, EventBatch
    from repro_torch.kernels import stream_filter as sf

    bb = ByteBatch.from_buffers(payloads[:BATCH], bucket=stage.byte_bucket)
    one = np.full((BATCH, 2), SEG_SENTINEL, np.int32)
    one[:, 0] = 0
    batch = EventBatch.from_streams(streams[:BATCH], bucket=stage.bucket)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id)).to(dev)
    rows = torch.arange(BATCH, dtype=torch.int32, device=dev)[:, None]
    return (bb, torch.from_numpy(bb.data).to(dev),
            torch.from_numpy(one).to(dev), rows, batch, events)


def times(run, short, tables, lane_cls, errs, dev) -> dict:
    """Phase 5: kernel and plain-version times at the shapes each kernel's
    main path gives it; the plain versions' outputs update ``errs``."""
    from repro_torch.kernels import predecode as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_filter as sf

    stage = run["stage"]
    say("phase 5: times at one request's shapes")
    bb, data, starts, rows, batch, events = request_inputs(
        run["payloads"], run["streams"], stage, dev)
    table_bytes = sum(x.numel() * 4 for x in tables)
    g, qb = tables[5].shape
    ops1 = work_counts(tables, batch.kind, batch.tag_id)
    n_events = int(batch.n_events.sum())
    out = {}

    k2, k2_out = time_ms(lambda: sf.stream_filter_bytes(
        data, starts, *tables, max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"K2 kernel, data {tuple(data.shape)}: {k2:.3f} ms")
    k1, k1_out = time_ms(lambda: sf.stream_filter(
        events, *tables, max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"K1 kernel, events {tuple(events.shape)}: {k1:.3f} ms")
    # K2's split: the same length of bytes with no tag (the byte front end
    # and the hand-over alone), against K1 (the chain alone, on the events
    # already compacted)
    notag = torch.full_like(data, ord(" "))
    k2_front, front_out = time_ms(lambda: sf.stream_filter_bytes(
        notag, starts, *tables, max_depth=MAX_DEPTH), warmup=1, reps=5)
    check(not bool(front_out[0].any()), "K2 matched on bytes with no tag")
    chain = int(batch.n_events.max())
    say(f"K2 split: {k2:.3f} ms = front end alone (no tag, same bytes) "
        f"{k2_front:.3f} ms, chain alone (K1, same documents) {k1:.3f} ms, "
        f"rest {k2 - k1:.3f} ms beyond the chain; chain "
        f"{k1 * 1e6 / chain:.1f} ns an event over {chain} events (K1), "
        f"{k2 * 1e6 / chain:.1f} ns (K2)")
    # the sparse kernels at the same 1 MB shapes, with a cap they fit in
    k3_big, k3_out = time_ms(lambda: sf.stream_filter_bytes_sparse(
        data, starts, rows, *tables, lane_cls, cap=PAST_BUDGET_CAP,
        max_depth=MAX_DEPTH), warmup=1, reps=5)
    k4_big, k4_out = time_ms(lambda: sf.stream_filter_sparse(
        events, rows, *tables, lane_cls, cap=PAST_BUDGET_CAP,
        max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"K3 kernel at the same bytes: {k3_big:.3f} ms; K4 at the same "
        f"events: {k4_big:.3f} ms ({int(k3_out[1][0])} rows, "
        f"cap {PAST_BUDGET_CAP})")
    # the plain versions once each, on the same inputs: a time, and the
    # kernels' check at the main path's shapes; K3/K4 against the plain
    # epilogue over these plain lanes (no second ~100 s event loop)
    p2, p2_out = time_ms(lambda: sf.stream_filter_bytes_plain(
        data, starts, *tables, max_depth=MAX_DEPTH), warmup=0, reps=1)
    p1, p1_out = time_ms(lambda: sf.stream_filter_plain(
        events, *tables, max_depth=MAX_DEPTH), warmup=0, reps=1)
    for name, ms, k, p in (("K2", p2, k2_out, p2_out),
                           ("K1", p1, k1_out, p1_out)):
        err = max_abs_err(k, p)
        errs[name] = max(errs[name], err)
        say(f"{name} plain version: {ms:.1f} ms; max |kernel - plain| = "
            f"{err}")
        check(err == 0, f"{name} disagrees with its plain version at the "
                        f"main path's shapes")
    for name, k, p in (("K3", k3_out, p2_out), ("K4", k4_out, p1_out)):
        err = sparse_err(k, ref.sparse_epilogue(*p, lane_cls, rows,
                                                PAST_BUDGET_CAP),
                         f"{name} at 1 MB")
        errs[name] = max(errs[name], err)
        say(f"{name} at 1 MB: max |kernel - plain epilogue| over sorted "
            f"rows = {err}")
        check(err == 0, f"{name} disagrees with the plain epilogue at 1 MB")

    lanes = 2 * BATCH * g * qb * 4
    b2 = data.numel() + starts.numel() * 4 + table_bytes + lanes
    out["K2"] = (k2, p2) + bound(b2, ops1 + OPS_PER_BYTE * data.numel())
    b1 = events.numel() * 4 + table_bytes + lanes
    out["K1"] = (k1, p1) + bound(b1, ops1)
    for name in ("K2", "K1"):
        ms, _, bms, by = out[name]
        say(f"{name}: {ms:.3f} ms against a bound of {bms:.4f} ms "
            f"({by}); {n_events / ms / 1e3:.1f} M events/s, "
            f"{bb.nbytes_total() / ms / 1e6:.3f} GB/s of payload, "
            f"{ms * 1e6 / chain:.1f} ns an event of the longest chain")


    # K5 where its main path runs it: the 1 MB request's parse.  Device
    # time from a CUDA graph of launches (a call's host time is close to
    # the kernel's), and one by one between CUDA events
    k5_events, k5_out = time_ms(lambda: pd.predecode(data), warmup=1, reps=5)
    k5 = graph_ms(lambda: pd.predecode(data), reps=20)
    p5, p5_out = time_ms(lambda: ref.predecode(data), warmup=1, reps=5)
    errs["K5"] = max(errs["K5"], max_abs_err(k5_out, p5_out))
    check(errs["K5"] == 0, "K5 disagrees with its plain version at 1 MB")
    out["K5"] = (k5, p5) + bound(9 * data.numel(), OPS_PER_BYTE * data.numel())
    say(f"K5 kernel, bytes {tuple(data.shape)}: {k5:.4f} ms (CUDA graph of "
        f"20; {k5_events:.4f} ms launched one by one) against "
        f"{K5_BEFORE_MS} ms with its first design (one by one), "
        f"expected 0.044-0.055 ms; {out['K5'][2] / k5 * 100:.1f} % of its "
        f"bound {out['K5'][2]:.4f} ms ({out['K5'][3]}); plain {p5:.3f} ms; "
        f"{9 * data.numel() / k5 / 1e6:.1f} GB/s moved")
    out["K5_events"] = k5_events

    # K3/K4 where their main path runs them: a request of short messages
    sbb, sdata, sstarts, srows, sbatch, sevents = request_inputs(
        short["payloads"], short["streams"], stage, dev)
    short_chain = int(sbatch.n_events.max())
    out["chain_events"] = {"K1": chain, "K2": chain, "K3": short_chain,
                           "K4": short_chain}
    k3, k3_out = time_ms(lambda: sf.stream_filter_bytes_sparse(
        sdata, sstarts, srows, *tables, lane_cls, cap=SPARSE_CAP,
        max_depth=MAX_DEPTH), warmup=1, reps=20)
    k4, k4_out = time_ms(lambda: sf.stream_filter_sparse(
        sevents, srows, *tables, lane_cls, cap=SPARSE_CAP,
        max_depth=MAX_DEPTH), warmup=1, reps=20)
    p3, p3_out = time_ms(lambda: sf.stream_filter_bytes_sparse_plain(
        sdata, sstarts, srows, *tables, lane_cls, cap=SPARSE_CAP,
        max_depth=MAX_DEPTH), warmup=0, reps=1)
    p4, p4_out = time_ms(lambda: sf.stream_filter_sparse_plain(
        sevents, srows, *tables, lane_cls, cap=SPARSE_CAP,
        max_depth=MAX_DEPTH), warmup=0, reps=1)
    n_rows = int(k3_out[1][0])
    for name, k, p in (("K3", k3_out, p3_out), ("K4", k4_out, p4_out)):
        err = sparse_err(k, p, f"{name} on short messages")
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} disagrees with its plain version on short "
                        f"messages")
    sops = work_counts(tables, sbatch.kind, sbatch.tag_id)
    emit_ops = OPS_PER_EMITTED_LANE * BATCH * g * qb
    rows_out = n_rows * 12 + 4
    b3 = (sdata.numel() + sstarts.numel() * 4 + srows.numel() * 4
          + table_bytes + lane_cls.numel() * 4 + rows_out)
    out["K3"] = (k3, p3) + bound(
        b3, sops + OPS_PER_BYTE * sdata.numel() + emit_ops)
    b4 = (sevents.numel() * 4 + srows.numel() * 4 + table_bytes
          + lane_cls.numel() * 4 + rows_out)
    out["K4"] = (k4, p4) + bound(b4, sops + emit_ops)
    for name, shape in (("K3", tuple(sdata.shape)), ("K4",
                                                     tuple(sevents.shape))):
        ms, pms, bms, by = out[name]
        say(f"{name} kernel on short messages {shape}, {n_rows} rows: "
            f"{ms:.3f} ms, plain {pms:.1f} ms; bound {bms:.4f} ms ({by}); "
            f"{ms * 1e6 / out['chain_events'][name]:.1f} ns an event of the "
            f"longest chain ({out['chain_events'][name]} events)")
    out["big"] = {"K3": k3_big, "K4": k4_big}
    return out


def k6_times(level_plan, layout, errs, dev) -> dict:
    """Phase 5, K6: kernel, plain version and two PyTorch calls the port
    never makes -- ``torch.index_select`` of the parents' values (the
    gather alone) and ``torch.matmul`` by the parent one-hot (the TPU
    kernel's product, full float32, TF32 off) -- at a wavefront step's
    shape and at the widest level's."""
    from repro_torch.kernels import nfa_transition as nt

    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is on")
    say("K6 times; torch.backends.cuda.matmul.allow_tf32 = False, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
    p1h = level_plan["parent_1h"]
    out = {}
    for key, rows, reps in (("step", layout["step_rows"], 50),
                            ("level", layout["level_rows"], 5)):
        args = k6_inputs(level_plan, rows, rows + 1, dev)
        parent, idx = args[0], args[4]
        # device time from a graph of launches: a wavefront step's kernel
        # is shorter than the host's time to launch it
        ms = graph_ms(lambda: nt.nfa_transition(*args), reps=reps)
        events_ms, k_out = time_ms(lambda: nt.nfa_transition(*args),
                                   warmup=1, reps=reps)
        plain_ms, p_out = time_ms(lambda: nt.nfa_transition_plain(*args),
                                  warmup=1, reps=max(1, reps // 3))
        errs["K6"] = max(errs["K6"], float((k_out - p_out).abs().max()))
        check(errs["K6"] == 0, f"K6 disagrees with its plain version at "
                               f"{tuple(parent.shape)}")
        del k_out, p_out
        gather_ms = graph_ms(lambda: torch.index_select(parent, 1, idx),
                             reps=reps)
        matmul_ms = graph_ms(lambda: torch.matmul(parent, p1h),
                             reps=max(1, reps // 2))
        # host time of one call: the Python wrapper and the launch, which
        # the card can hide only when the kernel takes longer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            nt.nfa_transition(*args)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        w, s = parent.shape
        t = args[2].shape[0]
        # the gather's work: each parent row read once and each output
        # written once, req, the three (S,) vectors and the tags read once;
        # about five operations an output (select, add, two products, clamp)
        n_bytes = 4 * (2 * w * s + t * s + 3 * s + w)
        bound_ms, bound_by = bound(n_bytes, K6_OPS_PER_OUTPUT * w * s,
                                   FP32_FLOP_PER_S)
        flop = 2 * w * s * s   # the TPU kernel's dense product, for history
        out[key] = {"rows": w, "ms": ms, "events_ms": events_ms,
                    "plain_ms": plain_ms,
                    "library_ms": gather_ms, "matmul_ms": matmul_ms,
                    "host_ms": host_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "ffma_bound_ms": flop / FP32_FLOP_PER_S * 1e3,
                    "bf16_bound_ms": flop / BF16_TENSOR_FLOP_PER_S * 1e3}
        say(f"K6 kernel ({w}, {s}) gathered by parent_idx ({s},): {ms:.4f} ms "
            f"= {n_bytes / ms / 1e6:.1f} GB/s, {bound_ms / ms * 100:.1f} % of "
            f"its bound {bound_ms:.4f} ms ({bound_by}) (CUDA graph of {reps}); "
            f"{events_ms:.4f} ms a call launched one by one, host time of a "
            f"call {host_ms:.4f} ms; plain {plain_ms:.3f} ms; "
            f"torch.index_select "
            f"{gather_ms:.4f} ms; torch.matmul by the one-hot {matmul_ms:.3f} "
            f"ms; the product's old bounds: float32 FFMA "
            f"{out[key]['ffma_bound_ms']:.4f} ms, bf16 tensor-core line "
            f"{out[key]['bf16_bound_ms']:.4f} ms; max |kernel - plain| = 0")
        check(ms < matmul_ms, f"K6 ({ms:.4f} ms) is not faster than "
                              f"torch.matmul ({matmul_ms:.4f} ms) at "
                              f"{tuple(parent.shape)}")
        del args, parent
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 6
def level_phase(dtd, d, bufs, layout, k6, dev) -> tuple[dict, dict]:
    """Phase 6: the levelwise engines at 1,024 profiles on 1 MB documents,
    each routing held against the streaming stage's at the same plan.
    Returns the engines' numbers and the streaming stage's routes of the
    first request with the levelwise plan's state count."""
    from repro_torch.core.events import ByteBatch
    from repro_torch.data.filter_stage import FilterStage

    qs = level_profiles(dtd)
    payloads = request_payloads(bufs, LEVEL_REQUESTS)
    say(f"phase 6: levelwise engines, {LEVEL_PROFILES} profiles, "
        f"{LEVEL_REQUESTS} requests x {BATCH} documents")

    def stage(engine, **opts):
        return FilterStage(profiles=qs, dictionary=d, engine=engine,
                           batch_size=BATCH, device=str(dev),
                           engine_options=opts)

    streaming = stage("streaming")
    want, _ = drive(f"streaming route_bytes at {LEVEL_PROFILES} profiles",
                    lambda: routed(streaming.route_bytes(payloads)), {"K2"})
    want_first = [r for r in want if r[0] < BATCH]
    check(0 < len({r[0] for r in want}), "no document matched at 1,024 "
                                         "profiles")
    say(f"streaming: {len(want)} routed documents, selectivity "
        f"{streaming.throughput()['selectivity']:.6f}; plan "
        f"{streaming._eng.plan_.meta['n_states']} states")

    out = {}
    for engine, requests, shape in (("wavefront", LEVEL_REQUESTS, "step"),
                                    ("levelwise", 1, "level")):
        st = stage(engine, use_kernel=True)
        n_states = int(st._eng.plan_.meta["n_states"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got, launches = drive(
            f"{engine} route_bytes use_kernel=True, {requests} request(s)",
            lambda: routed(st.route_bytes(payloads[:requests * BATCH])),
            {"K5", "K6"})
        e2e_s = time.perf_counter() - t
        mem = torch.cuda.max_memory_allocated()
        check(got == (want if requests == LEVEL_REQUESTS else want_first),
              f"{engine} with K6 routes differently from the streaming stage")
        # every launch has the shape phase 5 timed: one per chunk step or
        # one per level, of the first request's layout
        steps = layout["chunks"] if engine == "wavefront" else layout["levels"]
        check(launches["K6"] == requests * steps,
              f"{engine} launched K6 {launches['K6']} times, not "
              f"{requests} x {steps}")
        # the first request's parse and host bucketing, alone
        eng = st._eng
        bb = ByteBatch.from_buffers(payloads[:BATCH], bucket=st.byte_bucket)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = eng._parse(bb, st.bucket)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prep = eng._prep(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del batch, prep
        torch.cuda.empty_cache()
        per_request = {
            "route_s": e2e_s / requests, "parse_s": t1 - t0,
            "bucket_s": t2 - t1,
            "k6_s": launches["K6"] / requests * k6[shape]["ms"] / 1e3}
        out[engine] = {"requests": requests, "e2e_s": e2e_s,
                       "launches": launches, "peak_bytes": mem,
                       "per_request": per_request}
        say(f"{engine} with K6 routes as the streaming stage: "
            f"{requests * BATCH / e2e_s:.2f} docs/s; per request "
            f"{per_request['route_s']:.3f} s = parse "
            f"{per_request['parse_s']:.3f} s + host bucketing "
            f"{per_request['bucket_s']:.3f} s + K6 "
            f"{per_request['k6_s']:.3f} s ({launches['K6'] // requests} "
            f"launches x {k6[shape]['ms']:.3f} ms) + the rest; peak device "
            f"memory {mem} bytes")

    # the first request through the modes that launch no K6
    for engine, opts in (("levelwise", {}), ("levelwise", {"use_matmul": False}),
                         ("wavefront", {})):
        st = stage(engine, **opts)
        t = time.perf_counter()
        got, _ = drive(f"{engine} {opts or 'defaults'} route_bytes, first "
                       f"request", lambda: routed(st.route_bytes(
                           payloads[:BATCH])), {"K5"})
        check(got == want_first, f"{engine} {opts} routes differently from "
                                 f"the streaming stage")
        say(f"{engine} {opts or 'defaults'}: routes as the streaming stage "
            f"in {time.perf_counter() - t:.3f} s")
        torch.cuda.empty_cache()
    return out, {"want_first": want_first, "n_states": n_states}


# ----------------------------------------------------------------- phase 7
class LaunchLog:
    """For the length of a ``with``, wrap one kernel wrapper of
    ``repro_torch.kernels.stream_filter`` so that each launch records two
    CUDA events on the stream it was launched on.  The wrapped function
    still counts its launches; the log shows which streams launched and
    whether two launches overlapped on the card."""

    def __init__(self, name: str):
        self.name, self.rows = name, []

    def __enter__(self):
        from repro_torch.kernels import stream_filter as sf

        self.orig = orig = getattr(sf, self.name)
        torch.cuda.synchronize()
        self.origin = torch.cuda.Event(enable_timing=True)
        self.origin.record()

        def logged(*args, **kwargs):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = orig(*args, **kwargs)
            stop.record(stream)
            self.rows.append((stream.cuda_stream, start, stop))
            return out

        logged.launches = 0
        setattr(sf, self.name, logged)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import stream_filter as sf

        # the wrapper counts its launches under its module name, which was
        # the logging function's while the log was on: hand them back
        self.orig.launches += getattr(sf, self.name).launches
        setattr(sf, self.name, self.orig)

    def summary(self) -> dict:
        """Streams used, kernel ms summed, ms of the card covered by at
        least one launch, and whether any two launches overlapped."""
        torch.cuda.synchronize()
        spans = sorted((self.origin.elapsed_time(a),
                        self.origin.elapsed_time(b))
                       for _, a, b in self.rows)
        busy, overlapped, end = 0.0, False, float("-inf")
        for a, b in spans:
            overlapped |= a < end
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        default = torch.cuda.default_stream().cuda_stream
        streams = {row[0] for row in self.rows}
        return {"launches": len(spans), "streams": len(streams),
                "on_default_stream": default in streams,
                "kernel_ms": sum(b - a for a, b in spans), "busy_ms": busy,
                "overlapped": overlapped}


def nested(d, depth: int) -> bytes:
    return (b"".join(d.open_bytes(0) for _ in range(depth))
            + b"".join(d.close_bytes(0) for _ in range(depth)))


def matched_gids(stage, payloads) -> list[tuple[int, ...]]:
    """Each payload's matched global ids under ``stage.route_bytes``,
    through the stage's live gids."""
    out = [set() for _ in payloads]
    for batch in stage.route_bytes(payloads):
        for r in batch:
            out[r.doc_index] |= set(int(g) for g in r.matched_profiles)
    return [tuple(sorted(x)) for x in out]


def ticket_gids(ticket) -> tuple[int, ...]:
    return tuple(sorted(int(g) for rd in ticket.routed
                        for g in rd.matched_profiles))


def serve_summary(what: str, loop, wall_s: float, log: dict, tickets,
                  arrivals) -> dict:
    s = loop.slo_summary()
    out = {k: s[k] for k in ("p50_ms", "p99_ms", "p999_ms", "mean_ms",
                             "shed", "admitted", "completed", "rejected",
                             "batch_fill", "size_closes", "deadline_closes",
                             "flush_closes", "backpressure_waits",
                             "max_queue_depth", "batches", "served_per_s")}
    # how far behind its trace the producer submitted: an open-loop trace
    # that falls behind offers less than its rate
    t = np.asarray([tk.t_submit for tk in tickets])
    lag = (t - t[0]) - (np.asarray(arrivals) - arrivals[0])
    out.update(wall_s=wall_s, docs_per_s=s["completed"] / wall_s,
               launch_log=log, submit_lag_p50_ms=float(np.median(lag)) * 1e3,
               submit_lag_max_ms=float(lag.max()) * 1e3)
    say(f"{what}: p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
        f"p999 {s['p999_ms']:.3f} ms (host clock, admission to verdict); "
        f"shed {s['shed']} of {s['arrived']} ({s['shed_rate'] * 100:.2f} %), "
        f"rejected {s['rejected']}; batch fill {s['batch_fill']:.3f}; "
        f"closes: size {s['size_closes']}, deadline {s['deadline_closes']}, "
        f"flush {s['flush_closes']}; backpressure waits "
        f"{s['backpressure_waits']}, max queue depth {s['max_queue_depth']}; "
        f"{out['docs_per_s']:.1f} docs/s ({s['completed']} in "
        f"{wall_s:.3f} s; the producer submitted {out['submit_lag_p50_ms']:.1f} "
        f"ms behind its trace at the median, {out['submit_lag_max_ms']:.1f} "
        f"ms at most); {log['launches']} launches on {log['streams']} "
        f"worker stream(s), kernels {log['kernel_ms']:.3f} ms summed, card "
        f"busy {log['busy_ms']:.3f} ms, launches overlapped: "
        f"{log['overlapped']}")
    check(not log["on_default_stream"],
          f"{what}: a kernel launched on the default stream, not a worker's")
    return out


def churn_trace(loop, payloads, arrivals, ops):
    """:func:`run_trace` with reconfigurations: ``ops[i]`` is called with
    the loop just before request ``i`` is submitted; returns the tickets
    and the reconfiguration tickets."""
    t0 = time.monotonic()
    tickets, reconfig = [], []
    for i, (payload, due) in enumerate(zip(payloads, arrivals)):
        if i in ops:
            reconfig.append(ops[i](loop))
        lag = due - (time.monotonic() - t0)
        if lag > 0:
            time.sleep(lag)
        tickets.append(loop.submit(payload))
    return tickets, reconfig


def serve_phase(dtd, d, qs, run, short, dev) -> dict:
    """Phase 7: the serve loop at full width, its workers on streams."""
    from repro_torch.core.events import DepthOverflow, MalformedDocument
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.serve import (ServeLoop, poisson_arrivals,
                                   replay_arrivals, run_trace)

    msgs = short["payloads"]
    say(f"phase 7: serving, ServeLoop over the {N_PROFILES}-profile plan; "
        f"{SERVE_REQUESTS} requests of {len(msgs)} messages cycled at "
        f"{SERVE_RATE_HZ:.0f}/s (Poisson, seed 0)")

    def sparse_stage(profiles=qs):
        return FilterStage(profiles=profiles, dictionary=d,
                           engine="streaming", sparse=True, batch_size=BATCH,
                           device=str(dev),
                           engine_options={"match_cap": SPARSE_CAP})

    def loop_of(stage, **kw):
        return ServeLoop(stage, max_batch=BATCH, deadline_ms=SERVE_DEADLINE_MS,
                         max_inflight=3, queue_cap=SERVE_QUEUE_CAP, **kw)

    out = {}
    # (a) sparse pub-sub with (d) two poison payloads in the trace
    stage = sparse_stage()
    want = matched_gids(stage, msgs)
    trace = [msgs[i % len(msgs)] for i in range(SERVE_REQUESTS)]
    source = list(range(SERVE_REQUESTS))
    for at, payload in zip(POISON_AT, (d.open_bytes(0),
                                       nested(d, POISON_DEPTH))):
        trace.insert(at, payload)
        source.insert(at, -1)
    arrivals = poisson_arrivals(len(trace), SERVE_RATE_HZ, seed=0)

    def serve_a():
        with LaunchLog("stream_filter_bytes_sparse") as log:
            loop = loop_of(stage)
            t = time.perf_counter()
            with loop:
                tickets = run_trace(loop, trace, arrivals)
            wall = time.perf_counter() - t
        return loop, tickets, wall, log.summary()

    (loop, tickets, wall, log), _ = drive(
        "(a) serve loop, sparse pub-sub", serve_a, {"K3"})
    out["sparse"] = serve_summary("(a) sparse pub-sub", loop, wall, log,
                                  tickets, arrivals)
    check(loop.slo_summary()["completed"] > 0, "(a) served nothing")
    bad = [t for t, src in zip(tickets, source) if src < 0]
    check([type(t.error).__name__ for t in bad]
          == ["MalformedDocument", "DepthOverflow"]
          and isinstance(bad[0].error, MalformedDocument)
          and isinstance(bad[1].error, DepthOverflow)
          and all(t.seq == -1 for t in bad),
          f"(d) poison tickets ended as {[repr(t.error) for t in bad]}")
    check([(r["seq"], r["error"]) for r in loop.dead_letter]
          == [(-1, "MalformedDocument"), (-1, "DepthOverflow")],
          f"(d) dead letters {[(r['seq'], r['error']) for r in loop.dead_letter]}")
    served = 0
    for t, src in zip(tickets, source):
        if src < 0 or t.shed:
            continue
        check(t.error is None and t.epoch == 0,
              f"(a) request {t.seq} ended with {t.error!r}")
        check(ticket_gids(t) == want[src % len(msgs)],
              f"(a) request {t.seq} routes differently from route_bytes")
        served += 1
    say(f"(a) every one of {served} delivered requests routes as "
        f"FilterStage.route_bytes; (d) the malformed payload ended "
        f"{type(bad[0].error).__name__}, the {POISON_DEPTH}-deep one "
        f"{type(bad[1].error).__name__}, both rejected at admission and "
        f"dead-lettered")

    # (b) dense 1 MB requests, back to back, one batch in flight then
    # three.  The pre-admission check is host numpy over every byte, and
    # at 1 MB it takes longer than a document's share of K2, so the
    # producer would set the pace: the two depths run with validate=False
    # to show the loop itself, then depth 3 once more as users run it
    from repro_torch.core.events import validate_payload

    t = time.perf_counter()
    for payload in run["payloads"][:BATCH]:
        validate_payload(payload)
    out["validate_ms"] = (time.perf_counter() - t) / BATCH * 1e3
    say(f"(b) validate_payload of a 1 MB document: {out['validate_ms']:.2f} "
        f"ms on the host, against K2's {BATCH} documents a launch")
    out["dense"] = {}
    for k, validate in SERVE_DENSE_RUNS:
        def serve_b():
            with LaunchLog("stream_filter_bytes") as log:
                loop = ServeLoop(run["stage"], max_batch=BATCH,
                                 deadline_ms=SERVE_DEADLINE_MS,
                                 max_inflight=k, queue_cap=len(run["payloads"]),
                                 overload="block", validate=validate)
                t = time.perf_counter()
                with loop:
                    tickets = run_trace(loop, run["payloads"],
                                        replay_arrivals(len(run["payloads"])))
                wall = time.perf_counter() - t
            return loop, tickets, wall, log.summary()

        what = f"max_inflight={k}, validate={validate}"
        (loop, tickets, wall, log), _ = drive(
            f"(b) serve loop, dense 1 MB, {what}", serve_b, {"K2"})
        out["dense"][what] = serve_summary(
            f"(b) dense 1 MB, {what}", loop, wall, log, tickets,
            replay_arrivals(len(run["payloads"])))
        got = [(rd.doc_index, rd.shard, tuple(rd.matched_profiles.tolist()))
               for t in tickets for rd in t.routed]
        check(got == run["routes"], f"(b) {what} routes differently from "
                                    f"phase 3")
        say(f"(b) {what}: routes as phase 3's route_bytes")

    # (c) churn: a subscribe and an unsubscribe at fixed points of a longer
    # trace, each request held against the live set of its epoch
    hits = np.bincount(np.concatenate(
        [np.asarray(g, np.int64) for g in want if g]), minlength=N_PROFILES)
    new_q = qs[int(np.argmax(hits))]        # a copy of the busiest profile
    live = {0: list(range(N_PROFILES)), 1: list(range(N_PROFILES + 1)),
            2: list(range(1, N_PROFILES + 1))}
    everyone = list(qs) + [new_q]
    expect = {0: want}
    for epoch in (1, 2):
        gids = np.asarray(live[epoch])
        local = matched_gids(sparse_stage([everyone[g] for g in gids]), msgs)
        expect[epoch] = [tuple(int(gids[i]) for i in x) for x in local]
    check(any(N_PROFILES in x for x in expect[1]),
          "the new profile matches no message")
    churn = [msgs[i % len(msgs)] for i in range(SERVE_CHURN_REQUESTS)]
    ops = {SUBSCRIBE_AT: lambda lp: lp.subscribe(new_q),
           UNSUBSCRIBE_AT: lambda lp: lp.unsubscribe(0)}
    stage = sparse_stage()

    churn_arrivals = poisson_arrivals(len(churn), SERVE_RATE_HZ, seed=1)

    def serve_c():
        with LaunchLog("stream_filter_bytes_sparse") as log:
            loop = loop_of(stage)
            t = time.perf_counter()
            with loop:
                tickets, reconfig = churn_trace(loop, churn, churn_arrivals,
                                                ops)
            wall = time.perf_counter() - t
        return loop, tickets, reconfig, wall, log.summary()

    (loop, tickets, reconfig, wall, log), _ = drive(
        f"(c) serve loop, sparse pub-sub with churn, {len(churn)} requests",
        serve_c, {"K3"})
    out["churn"] = serve_summary("(c) sparse pub-sub with churn", loop, wall,
                                 log, tickets, churn_arrivals)
    check([(r.op, r.error, r.gid) for r in reconfig]
          == [("subscribe", None, N_PROFILES), ("unsubscribe", None, 0)],
          f"(c) reconfigurations ended {[(r.op, r.error, r.gid) for r in reconfig]}")
    check([s_["op"] for s_ in loop.swap_log] == ["subscribe", "unsubscribe"],
          f"(c) swap log {loop.swap_log}")
    per_epoch = {0: 0, 1: 0, 2: 0}
    for i, t in enumerate(tickets):
        if t.shed:
            continue
        check(t.error is None and t.epoch in expect,
              f"(c) request {t.seq}: epoch {t.epoch}, error {t.error!r}")
        check(ticket_gids(t) == expect[t.epoch][i % len(msgs)],
              f"(c) request {t.seq} differs from a stage on epoch "
              f"{t.epoch}'s live set")
        per_epoch[t.epoch] += 1
    check(all(per_epoch.values()), f"(c) an epoch served no request: "
                                   f"{per_epoch}")
    out.update(expect=expect, new_q=new_q)
    out["churn"].update(per_epoch=per_epoch,
                        swaps=[{"op": r.op, "build_s": r.build_s,
                                "commit_ms": r.commit_s * 1e3}
                               for r in reconfig])
    say(f"(c) requests per epoch {per_epoch}, each routed as a synchronous "
        f"stage on its epoch's live set; swaps: " + "; ".join(
            f"{r.op} built in {r.build_s:.3f} s, committed in "
            f"{r.commit_s * 1e3:.3f} ms" for r in reconfig))
    return out


# ----------------------------------------------------------------- phase 8
def stacked_bytes(sharded) -> int:
    return sum(t.numel() * t.element_size()
               for t in sharded.stacked().tables.values())


def drive_once(what: str, fn, kernels: dict):
    """:func:`drive` that also holds each kernel's launch count: one per
    request, however many parts the plan has."""
    out, got = drive(what, fn, set(kernels))
    for k, n in kernels.items():
        check(got[k] == n, f"{what} launched {k} {got[k]} times, not {n}")
    return out, got


def sharded_phase(dtd, d, qs, bufs, run, short, level_ref, layout, k2_ms,
                  dev) -> dict:
    """Phase 8: query-sharded plans on the card, every part in one launch;
    churn, rebalance, the levelwise engines with K6 folded, and the chaos
    drill."""
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_filter as sf
    from repro_torch.serve.faults import run_chaos_trace

    say(f"phase 8: query-sharded plans, {SHARD_PARTS} parts of the "
        f"{N_PROFILES}-profile plan in one launch each")
    out = {}

    def stage(profiles=qs, **kw):
        return FilterStage(profiles=profiles, dictionary=d,
                           engine="streaming", batch_size=BATCH,
                           device=str(dev), **kw)

    # (a) the streaming stage, dense and sparse, events and bytes
    t = time.perf_counter()
    dense = stage(query_shards=SHARD_PARTS)
    torch.cuda.synchronize()
    out["plan_s"] = time.perf_counter() - t
    sp = dense.sharded_
    g1 = int(run["stage"]._eng.plan_.meta["n_blocks"])
    g = int(sp.stacked().meta["n_blocks"])
    out.update(parts=SHARD_PARTS, blocks_per_part=g, folded_blocks=
               SHARD_PARTS * g, unsharded_blocks=g1,
               stacked_bytes=stacked_bytes(sp), pads=sp.pads)
    say(f"(a) sharded plan in {out['plan_s']:.2f} s (the engine's full plan "
        f"included): pads {sp.pads}, part sizes {sp.part_sizes().tolist()}, "
        f"imbalance {sp.imbalance():.4f}; {SHARD_PARTS} x {g} = "
        f"{SHARD_PARTS * g} folded blocks against the unsharded {g1}; "
        f"stacked tables {out['stacked_bytes']} bytes on the card")
    list(dense.route_bytes(run["payloads"][:BATCH]))     # warm-up request
    got, launches = drive_once(
        "(a) sharded route_bytes (dense)",
        lambda: routed(dense.route_bytes(run["payloads"])), {"K2": REQUESTS})
    check(got == run["routes"], "(a) the sharded dense route differs from "
                                "the unsharded stage's (phase 3)")
    out["launches"] = dict(launches)
    got, launches = drive_once(
        "(a) sharded route (host-decoded events, dense)",
        lambda: routed(dense.route(run["streams"])), {"K1": REQUESTS})
    check(got == run["routes"], "(a) the sharded events route differs from "
                                "phase 3's")
    out["launches"]["K1"] = launches["K1"]
    sparse = stage(query_shards=SHARD_PARTS, sparse=True,
                   engine_options={"match_cap": SPARSE_CAP})
    for what, ingest, kernel in (("route_bytes", "bytes", "K3"),
                                 ("route", "events", "K4")):
        got, launches = drive_once(
            f"(a) sharded sparse {what}", lambda: routed(
                sparse.route_bytes(short["payloads"]) if ingest == "bytes"
                else sparse.route(short["streams"])), {kernel: REQUESTS})
        check(got == short["routes"], f"(a) the sharded sparse {what} "
                                      f"differs from the dense stage's")
        out["launches"][kernel] = launches[kernel]
    check(sparse.stats["paths"] == {"kernel-fused": 2 * REQUESTS},
          f"(a) sharded sparse paths {sparse.stats['paths']}")
    say("(a) every sharded route equals the unsharded stage's, one launch "
        "a request")

    # the folded kernels at one request's shapes: K2 and K1 on the 1 MB
    # request (times), K1 and K4 on a short request against their plain
    # versions, over lanes with tombstoned columns
    stacked = dense.sharded_.stacked()
    folded = dense._eng._folded(stacked)
    bb, data, starts, rows, batch, events = request_inputs(
        run["payloads"], run["streams"], run["stage"], dev)
    out["K2_ms"], k2_out = time_ms(lambda: sf.stream_filter_bytes(
        data, starts, *folded, max_depth=MAX_DEPTH), warmup=1, reps=5)
    out["K1_ms"], _ = time_ms(lambda: sf.stream_filter(
        events, *folded, max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"(a) folded K2 ({SHARD_PARTS * g} blocks) {out['K2_ms']:.3f} ms a "
        f"request against phase 5's unsharded K2 in this run, "
        f"{k2_ms:.3f} ms ({out['K2_ms'] / k2_ms:.3f} x; "
        f"expected within +-25 % of 26.46 ms); folded K1 "
        f"{out['K1_ms']:.3f} ms")
    tomb = dense.sharded_.remove_queries(list(range(0, N_PROFILES, 7)))
    lane_cls = dense._eng._sharded_lane_tables(tomb)[0].flatten(0, 1)
    sbb, sdata, sstarts, srows, sbatch, sevents = request_inputs(
        short["payloads"], short["streams"], run["stage"], dev)
    k1 = sf.stream_filter(sevents, *folded, max_depth=MAX_DEPTH)
    p1 = sf.stream_filter_plain(sevents, *folded, max_depth=MAX_DEPTH)
    k4 = sf.stream_filter_sparse(sevents, srows, *folded, lane_cls,
                                 cap=SPARSE_CAP, max_depth=MAX_DEPTH)
    p4 = ref.sparse_epilogue(*p1, lane_cls, srows, SPARSE_CAP)
    out["max_abs_err"] = {"K1": max_abs_err(k1, p1),
                          "K4": sparse_err(k4, p4, "folded K4")}
    check(out["max_abs_err"] == {"K1": 0, "K4": 0},
          f"(a) folded kernels disagree with their plain versions: "
          f"{out['max_abs_err']}")
    say(f"(a) folded K1 and K4 on a short request ({tuple(sevents.shape)} "
        f"events, {int(p4[1][0])} rows, every 7th profile tombstoned) equal "
        f"their plain versions")
    del k2_out, k1, p1, k4, p4

    # (b) churn on the sharded stage, against the unsharded stage's
    # rebuild; after each commit the stage routes as a fresh unsharded
    # stage on its live set
    hits = np.bincount(np.concatenate(
        [np.asarray(r[2], np.int64) for r in short["routes"]]),
        minlength=N_PROFILES)
    new_q = qs[int(np.argmax(hits))]

    def live_routes(st):
        gids = sorted(st._live)
        fresh = stage([st._live[g] for g in gids])
        want = routed(fresh.route_bytes(short["payloads"]))
        return [(doc, shard, tuple(gids[i] for i in m))
                for doc, shard, m in want]

    def timed_commit(st, pending):
        t0 = time.perf_counter()
        st.commit(pending)
        return (time.perf_counter() - t0) * 1e3

    churn = {}
    mono = run["stage"]
    t0 = time.perf_counter()
    pending = mono.prepare_subscribe(new_q)
    torch.cuda.synchronize()
    churn["unsharded_subscribe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pending_u = mono.prepare_unsubscribe(0)
    torch.cuda.synchronize()
    churn["unsharded_unsubscribe_s"] = time.perf_counter() - t0
    del pending, pending_u
    for op, make in (("subscribe", lambda: dense.prepare_subscribe(new_q)),
                     ("unsubscribe", lambda: dense.prepare_unsubscribe(0))):
        t0 = time.perf_counter()
        pending = make()
        torch.cuda.synchronize()
        churn[f"{op}_s"] = time.perf_counter() - t0
        churn[f"{op}_commit_ms"] = timed_commit(dense, pending)
        check(routed(dense.route_bytes(short["payloads"]))
              == live_routes(dense), f"(b) after the {op} the sharded stage "
                                     f"routes differently from a fresh stage")
    say(f"(b) subscribe built in {churn['subscribe_s']:.3f} s, committed in "
        f"{churn['subscribe_commit_ms']:.3f} ms; unsubscribe built in "
        f"{churn['unsubscribe_s']:.3f} s, committed in "
        f"{churn['unsubscribe_commit_ms']:.3f} ms; the unsharded stage's "
        f"rebuilds in this run: {churn['unsharded_subscribe_s']:.3f} s and "
        f"{churn['unsharded_unsubscribe_s']:.3f} s (expected 0.05-0.12 s "
        f"and under 5 ms of host time); each routes as a fresh stage on its "
        f"live set")
    last = int(np.argmax(dense.sharded_.part_sizes()))
    drop = [int(x) for x in dense.sharded_.live_ids()
            if int(dense.sharded_.partition.part_of[x]) == last]
    t0 = time.perf_counter()
    for x in drop[:SKEW_UNSUBSCRIBES]:
        dense.unsubscribe(x)
    churn["skew_s"] = time.perf_counter() - t0
    imb = dense.sharded_.imbalance()
    t0 = time.perf_counter()
    stats = dense.maybe_rebalance(tolerance=REBALANCE_TOLERANCE)
    torch.cuda.synchronize()
    churn["rebalance_s"] = time.perf_counter() - t0
    churn["rebalance"] = stats
    check(stats["moves"] > 0 and dense.sharded_.imbalance() < imb,
          f"(b) the rebalance after skewed churn moved nothing: {stats}")
    check(routed(dense.route_bytes(short["payloads"])) == live_routes(dense),
          "(b) after the rebalance the sharded stage routes differently")
    say(f"(b) {SKEW_UNSUBSCRIBES} unsubscribes from part {last} in "
        f"{churn['skew_s']:.2f} s took the imbalance to {imb:.4f}; "
        f"maybe_rebalance(tolerance={REBALANCE_TOLERANCE}) in "
        f"{churn['rebalance_s']:.3f} s: {stats}; routes as a fresh stage")
    out["churn"] = churn
    del dense, sparse, tomb
    torch.cuda.empty_cache()

    # (c) the wavefront engine with K6 folded over the parts' states
    lqs = level_profiles(dtd)
    payloads = request_payloads(bufs, 1)
    st = FilterStage(profiles=lqs, dictionary=d, engine="wavefront",
                     batch_size=BATCH, device=str(dev),
                     query_shards=LEVEL_SHARDS,
                     engine_options={"use_kernel": True})
    s_part = int(st.sharded_.stacked().meta["n_states"])
    t0 = time.perf_counter()
    got, launches = drive_once(
        f"(c) sharded wavefront route_bytes use_kernel=True, 1 request",
        lambda: routed(st.route_bytes(payloads)),
        {"K5": 1, "K6": layout["chunks"]})
    out["level"] = {"parts": LEVEL_SHARDS, "states_per_part": s_part,
                    "folded_states": LEVEL_SHARDS * s_part,
                    "route_s": time.perf_counter() - t0,
                    "launches": dict(launches)}
    check(got == level_ref["want_first"], "(c) the sharded wavefront routes "
                                       "differently from the streaming stage")
    say(f"(c) {LEVEL_SHARDS} parts of {s_part} states folded to "
        f"{LEVEL_SHARDS * s_part} (unsharded {level_ref['n_states']}); one K6 "
        f"a chunk step ({launches['K6']}), routes as the streaming stage in "
        f"{out['level']['route_s']:.3f} s")
    del st
    torch.cuda.empty_cache()

    # (d) the chaos drill on the card
    t0 = time.perf_counter()
    report, launches = drive("(d) run_chaos_trace(48), query_shards=2",
                             lambda: run_chaos_trace(48, device=str(dev)),
                             {"K2"})
    out["chaos"] = {"checks": report["checks"], "s": time.perf_counter() - t0,
                    "dead_letter": [r["error"] for r in
                                    report["dead_letter"]],
                    "swaps": report["slo"]["swaps"]}
    say(f"(d) chaos drill in {out['chaos']['s']:.1f} s: {report['checks']}; "
        f"dead letters {out['chaos']['dead_letter']}")
    check(report["ok"], f"(d) the chaos drill failed: {report['checks']}")
    return out


# ----------------------------------------------------------------- phase 9
def same_tables(a, b) -> bool:
    """Two plans with the same tables, table for table, bit for bit."""
    return sorted(a.tables) == sorted(b.tables) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
        for k in a.tables)


def cache_builds(what: str, build, directory: str, *,
                 sparse_build: bool = False):
    """A stage built cold and warm on plan caches, CACHE_REPEATS times each:
    every cold build in a directory of its own (only misses), every warm
    build on the first cold build's directory (only hits, as many as it
    missed, tables equal to its), and with ``sparse_build`` one more warm
    build as a sparse stage.  Returns ``(cold, warm, warm_sparse)`` stages
    (the first of each), the first cold build's misses, and the seconds of
    every build by kind."""
    from repro_torch.checkpoint import PlanCache

    def timed(cache, sparse=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stage = build(cache, sparse)
        torch.cuda.synchronize()
        return stage, time.perf_counter() - t

    secs = {"cold": [], "warm": [], "warm_sparse": []}
    first = {}
    for i in range(CACHE_REPEATS):
        cache = PlanCache(directory if i == 0 else f"{directory}-{i}")
        stage, s = timed(cache)
        secs["cold"].append(s)
        check(cache.hits == 0 and cache.misses > 0
              and cache.misses == first.get("misses", cache.misses),
              f"(a) {what}: cold build {i} counted {cache.hits} hits, "
              f"{cache.misses} misses")
        first.setdefault("misses", cache.misses)
        first.setdefault("cold", stage)
        del stage
    misses, cold = first["misses"], first["cold"]
    kinds = ["warm"] * CACHE_REPEATS + (["warm_sparse"] if sparse_build
                                        else [])
    for i, kind in enumerate(kinds):
        cache = PlanCache(directory)
        stage, s = timed(cache, kind == "warm_sparse")
        secs[kind].append(s)
        check(cache.misses == 0 and cache.hits == misses,
              f"(a) {what}: warm build {i} counted {cache.hits} hits and "
              f"{cache.misses} misses against the cold build's {misses}")
        pairs = [(cold._eng.plan_, stage._eng.plan_)]
        if cold.sharded_ is not None:
            pairs += list(zip(cold.sharded_.plans, stage.sharded_.plans))
            pairs.append((cold.sharded_.stacked(), stage.sharded_.stacked()))
        check(all(same_tables(x, y) for x, y in pairs),
              f"(a) {what}: warm build {i}'s tables differ from the cold "
              f"build's")
        first.setdefault(kind, stage)
        del stage
    return ((cold, first["warm"], first.get("warm_sparse")), misses,
            secs)


def api_phase(dtd, d, qs, bufs, run, short, level_ref, layout, dev) -> dict:
    """Phase 9: the rest of the one-card API on the card: the plan cache,
    the measured autotune, twig filtering, the ops wrappers, the token
    pipeline and the serving CLI's routing functions."""
    import tempfile
    from types import SimpleNamespace

    from repro_torch.checkpoint import PlanCache
    from repro_torch.core.events import (ByteBatch, EventBatch, decode_bytes,
                                         encode_bytes)
    from repro_torch.core.nfa import compile_queries
    from repro_torch.core.twig import TwigFilter
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.data.generator import gen_corpus
    from repro_torch.data.tokens import XMLBytePipeline
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.launch import serve

    say("phase 9: the plan cache, the measured autotune, twig filtering, "
        "the ops wrappers, the token pipeline and the serving CLI")
    out = {"launches": {k: 0 for k in counts()}}

    def drive9(what, fn, want, exact=None):
        res, got = drive(what, fn, set(want))
        for k, n in got.items():
            out["launches"][k] += n
        for k, n in (exact or {}).items():
            check(got[k] == n, f"{what} launched {k} {got[k]} times, not {n}")
        return res

    first3 = [r for r in run["routes"] if r[0] < BATCH]
    first4 = [r for r in short["routes"] if r[0] < BATCH]
    level_payloads = request_payloads(bufs, 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        # (a) the plan cache: cold and warm builds of phases 3, 8 and 6's
        # plans, each CACHE_REPEATS times (medians); the NFA compile, which
        # no cache skips, timed alone
        def median_compile(profiles):
            times = []
            for _ in range(CACHE_REPEATS):
                t = time.perf_counter()
                compile_queries(profiles, d, shared=True)
                times.append(time.perf_counter() - t)
            return float(np.median(times))

        nfa_s = median_compile(qs)
        cache_out = {"compile_queries_s": nfa_s}
        kept = {}
        for what, kw in (("unsharded", {}),
                         (f"query_shards={SHARD_PARTS}",
                          {"query_shards": SHARD_PARTS})):
            def build(cache, sparse, kw=kw):
                return FilterStage(
                    profiles=qs, dictionary=d, engine="streaming",
                    batch_size=BATCH, device=str(dev), sparse=sparse,
                    engine_options={"plan_cache": cache,
                                    "match_cap": SPARSE_CAP}, **kw)

            directory = os.path.join(tmp, what)
            (_, warm, warm_sparse), misses, secs = cache_builds(
                what, build, directory, sparse_build=True)
            got = drive9(f"(a) {what}, warm build: route_bytes, first request "
                         f"of phase 3", lambda: routed(warm.route_bytes(
                             run["payloads"][:BATCH])), {"K2"}, {"K2": 1})
            check(got == first3, f"(a) {what}: the warm build routes phase "
                                 f"3's first request differently")
            got = drive9(f"(a) {what}, warm sparse build: route_bytes, first "
                         f"request of phase 4", lambda: routed(
                             warm_sparse.route_bytes(
                                 short["payloads"][:BATCH])),
                         {"K3"}, {"K3": 1})
            check(got == first4, f"(a) {what}: the warm sparse build routes "
                                 f"phase 4's first request differently")
            cold_s, warm_s = (float(np.median(secs[k]))
                              for k in ("cold", "warm"))
            cache_out[what] = {"cold_s": cold_s, "warm_s": warm_s,
                               "secs": secs, "entries": misses}
            say(f"(a) {what}: {misses} entries; median of "
                f"{CACHE_REPEATS} cold builds {cold_s:.3f} s "
                f"({', '.join(f'{x:.3f}' for x in secs['cold'])}), of "
                f"{CACHE_REPEATS} warm builds {warm_s:.3f} s "
                f"({', '.join(f'{x:.3f}' for x in secs['warm'])}; "
                f"{warm_s / cold_s:.2f} x), a warm sparse build "
                f"{secs['warm_sparse'][0]:.3f} s (all hits, tables equal); "
                f"compile_queries alone {nfa_s:.3f} s (median), so the plan "
                f"part is {cold_s - nfa_s:.3f} s cold and "
                f"{warm_s - nfa_s:.3f} s warm; both warm builds route as "
                f"phases 3, 4 and 8")
            kept[what] = (directory, build, warm)
            del warm, warm_sparse
        # a torn part entry: exactly one miss, rewritten, the same routes
        directory, build, warm = kept[f"query_shards={SHARD_PARTS}"]
        sp = warm.sharded_
        key = warm._eng.plan_cache_key(sp.part_nfas[0], sp.pads)
        os.remove(os.path.join(PlanCache(directory)._path(key),
                               "manifest.json"))
        cache = PlanCache(directory)
        torn = build(cache, False)
        check(cache.misses == 1 and key in cache,
              f"(a) after a part's manifest was deleted the build counted "
              f"{cache.misses} misses and {cache.hits} hits; entry rewritten: "
              f"{key in cache}")
        got = drive9("(a) torn entry, rebuilt: route_bytes, first request of "
                     "phase 3", lambda: routed(torn.route_bytes(
                         run["payloads"][:BATCH])), {"K2"}, {"K2": 1})
        check(got == first3, "(a) the stage rebuilt past a torn entry routes "
                             "differently")
        say(f"(a) a part's manifest.json deleted: the next build had 1 miss "
            f"and {cache.hits} hits, rewrote the entry, routes the same")
        del kept, warm, torn, sp
        lqs = level_profiles(dtd)

        def level_build(cache, sparse):
            return FilterStage(profiles=lqs, dictionary=d, engine="wavefront",
                               batch_size=BATCH, device=str(dev),
                               engine_options={"plan_cache": cache,
                                               "use_kernel": True})

        level_nfa_s = median_compile(lqs)
        (_, level_warm, _), misses, secs = cache_builds(
            "wavefront", level_build, os.path.join(tmp, "wavefront"))
        level_plan = level_warm._eng.plan_
        got = drive9("(a) wavefront use_kernel=True, warm build: route_bytes, "
                     "first request of phase 6",
                     lambda: routed(level_warm.route_bytes(level_payloads)),
                     {"K5", "K6"})
        check(got == level_ref["want_first"], "(a) the warm wavefront build "
                                              "routes differently")
        cold_s, warm_s = (float(np.median(secs[k])) for k in ("cold", "warm"))
        cache_out["wavefront"] = {"cold_s": cold_s, "warm_s": warm_s,
                                  "secs": secs,
                                  "compile_queries_s": level_nfa_s,
                                  "entries": misses}
        say(f"(a) wavefront at {LEVEL_PROFILES} profiles: median cold build "
            f"{cold_s:.3f} s ({', '.join(f'{x:.3f}' for x in secs['cold'])}),"
            f" warm {warm_s:.3f} s "
            f"({', '.join(f'{x:.3f}' for x in secs['warm'])}; "
            f"{warm_s / cold_s:.2f} x; compile_queries alone "
            f"{level_nfa_s:.3f} s); routes as phase 6")
        out["cache"] = cache_out
        del level_warm

        # (b) the measured autotune over one request of phase 3
        nfa = compile_queries(qs, d, shared=True)
        bb = ByteBatch.from_buffers(run["payloads"][:BATCH],
                                    bucket=run["stage"].byte_bucket)
        cache_file = os.path.join(tmp, "autotune.json")
        t = time.perf_counter()
        best, rows = drive9(
            f"(b) autotune.search blk {AUTOTUNE_BLKS} x segment_target "
            f"{AUTOTUNE_SEGMENT_TARGETS}, trials={AUTOTUNE_TRIALS}",
            lambda: autotune.search(
                nfa, d, bb, max_depth=MAX_DEPTH, blks=AUTOTUNE_BLKS,
                segment_targets=AUTOTUNE_SEGMENT_TARGETS,
                trials=AUTOTUNE_TRIALS, device=dev, cache_file=cache_file),
            {"K2", "K3"})
        search_s = time.perf_counter() - t
        for i, r in enumerate(rows):
            say(f"(b) candidate {i}: blk {r['blk']} segment_target "
                f"{r['segment_target']} -> " + (
                    f"skipped: {r['skipped']}" if "skipped" in r else
                    f"effective blk {r['blk_eff']}, G {r['n_blocks']}, "
                    f"{r['seconds'] * 1e3:.3f} ms" + (
                        f" (fell in with candidate {r['same_as']}, not "
                        f"timed again)" if "same_as" in r else "")))
        timed = [r for r in rows if "seconds" in r and "same_as" not in r]
        distinct = {(r["blk_eff"], r["n_blocks"], r["segment_target"])
                    for r in rows if "seconds" in r}
        check(len(timed) == len(distinct),
              f"(b) {len(timed)} candidates timed for {len(distinct)} "
              f"distinct launch shapes")
        key = autotune.plan_key(autotune.backend(dev),
                                -(-nfa.n_states // 32) * 32, nfa.n_tags,
                                MAX_DEPTH, 32)
        check(autotune.cached_config(key, cache_file) is not None,
              f"(b) no winner cached under {key}")
        old_env = os.environ.get(autotune.CACHE_ENV)
        os.environ[autotune.CACHE_ENV] = cache_file
        try:
            measured = FilterStage(profiles=qs, dictionary=d,
                                   engine="streaming", batch_size=BATCH,
                                   device=str(dev),
                                   engine_options={"autotune": "measured"})
        finally:
            if old_env is None:
                del os.environ[autotune.CACHE_ENV]
            else:
                os.environ[autotune.CACHE_ENV] = old_env
        meta = measured._eng.plan_.meta
        check((meta["blk"], meta["segment_target"])
              == (best["blk_eff"], best["segment_target"]),
              f"(b) the measured engine's plan {meta} is not the winner "
              f"{best}")
        got = drive9("(b) autotune='measured' stage: route_bytes, first "
                     "request of phase 3", lambda: routed(
                         measured.route_bytes(run["payloads"][:BATCH])),
                     {"K2"}, {"K2": 1})
        check(got == first3, "(b) the measured stage routes differently")
        out["autotune"] = {"rows": rows, "best": best, "search_s": search_s,
                           "timed": len(timed), "key": key}
        say(f"(b) search in {search_s:.2f} s: {len(rows)} candidates, "
            f"{len(timed)} timed; winner blk {best['blk']} (effective "
            f"{best['blk_eff']}, G {best['n_blocks']}) segment_target "
            f"{best['segment_target']} at {best['seconds'] * 1e3:.3f} ms; "
            f"the measured stage routes as the default stage")
        del measured, nfa
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) twig filtering over phase 4's messages
    names = dtd.tag_names
    rng = np.random.default_rng(0)
    twigs = []
    for i in range(N_TWIGS):
        a, b, c = rng.choice(len(names), 3, replace=False)
        twigs.append((f"{names[a]}[//{names[b]}][//{names[c]}]",
                      f"{names[a]}[{names[b]}]//{names[c]}",
                      f"{names[a]}//{names[b]}")[i % 3])
    streams = short["streams"]
    f = TwigFilter(twigs, d, engine="streaming", device=str(dev))
    f.filter_document(streams[0])                        # warm-up
    f.stats.update(stage2_checks=0, stage2_rejects=0)
    t = time.perf_counter()
    got = drive9(f"(c) TwigFilter({N_TWIGS} twigs, engine='streaming') over "
                 f"{len(streams)} messages", lambda: [
                     f.filter_document(ev) for ev in streams],
                 {"K1"}, {"K1": len(streams)})
    twig_s = time.perf_counter() - t
    # the path engine's call alone (a batch of one, K1, the verdicts back):
    # the rest of a message is the twig join and stage 2, on the host
    t = time.perf_counter()
    for ev in streams:
        f._eng.filter_document(ev)
    engine_s = time.perf_counter() - t
    cpu = TwigFilter(twigs, d, engine="streaming", device="cpu")
    for ev, res in zip(streams, got):
        want = cpu.filter_document(ev)
        check(np.array_equal(res.matched, want.matched)
              and np.array_equal(res.first_event, want.first_event),
              "(c) the twig filter on the card differs from the CPU's")
    check(cpu.stats == f.stats, f"(c) stats {f.stats} != {cpu.stats}")
    oracle = TwigFilter(twigs, d, engine="oracle", device="cpu")
    for ev, res in zip(streams[:TWIG_ORACLE_DOCS], got):
        want = oracle.filter_document(ev)
        check(np.array_equal(res.matched, want.matched)
              and np.array_equal(res.first_event, want.first_event),
              "(c) the twig filter on the card differs from the oracle")
    n_matched = sum(int(r.matched.sum()) for r in got)
    check(n_matched > 0, "(c) no twig matched")
    out["twig"] = {"twigs": N_TWIGS, "paths": len(f.paths),
                   "states": f.nfa.n_states,
                   "ms_per_doc": twig_s / len(streams) * 1e3,
                   "engine_ms_per_doc": engine_s / len(streams) * 1e3,
                   "matches": n_matched, "stats": dict(f.stats)}
    say(f"(c) {N_TWIGS} twigs ({len(f.paths)} paths, {f.nfa.n_states} "
        f"states): {out['twig']['ms_per_doc']:.3f} ms a message, of which "
        f"the path engine's call {out['twig']['engine_ms_per_doc']:.3f} ms "
        f"(K1 and its batch of one), the rest the join and stage 2; "
        f"{n_matched} matches, stats {f.stats}; equal to the CPU filter on "
        f"all {len(streams)} and to the oracle on the first "
        f"{TWIG_ORACLE_DOCS}")
    del f, cpu, oracle

    # (d) the ops wrappers against their plain versions on the card
    sbb = ByteBatch.from_buffers(short["payloads"], bucket=1024)
    data = torch.from_numpy(sbb.data).to(dev)
    kind, tag = drive9("(d) ops.predecode, phase 4's byte batch",
                       lambda: ops.predecode(data), {"K5"}, {"K5": 1})
    pk, pt = ref.predecode(data)
    check(torch.equal(kind, pk) and torch.equal(tag, pt),
          "(d) ops.predecode differs from the plain version")
    ev = drive9("(d) ops.decode_document of a 1 MB document",
                lambda: ops.decode_document(bufs[0], d, device=dev),
                {"K5"}, {"K5": 1})
    host = decode_bytes(bufs[0], d.symbol_value_table())
    check(np.array_equal(ev.kind, host.kind)
          and np.array_equal(ev.tag_id, host.tag_id),
          "(d) ops.decode_document differs from the host decode")
    say(f"(d) ops.predecode {tuple(data.shape)} and ops.decode_document "
        f"({len(bufs[0])} bytes, {len(ev)} events) equal their plain "
        f"versions")
    for label, rows in (("wavefront step", layout["step_rows"]),
                        ("widest level", layout["level_rows"])):
        args = k6_inputs(level_plan, rows, rows, dev)
        one_hot = level_plan["parent_1h"]
        k = drive9(f"(d) ops.nfa_transition at the {label} "
                   f"({rows}, {args[0].shape[1]}), given parent_1h",
                   lambda: ops.nfa_transition(*args[:4], one_hot, args[5]),
                   {"K6"}, {"K6": 1})
        p = nt.nfa_transition_plain(*args)
        check(torch.equal(k, p), f"(d) ops.nfa_transition at the {label} "
                                 f"differs from the plain version")
        del args, k, p
        torch.cuda.empty_cache()
    del level_plan
    say("(d) ops.nfa_transition at both K6 shapes equals the plain gather")
    four = streams[:4]
    kernel_eng = ops.StreamFilterKernelEngine(qs, d, device=dev)
    res = drive9("(d) ops.StreamFilterKernelEngine, 4 messages",
                 lambda: [kernel_eng.filter_document(x) for x in four],
                 {"K1"}, {"K1": 4})
    want = run["stage"]._eng.filter_batch(EventBatch.from_streams(four))
    check(all(np.array_equal(r.matched, want.matched[i])
              and np.array_equal(r.first_event, want.first_event[i])
              for i, r in enumerate(res)),
          "(d) StreamFilterKernelEngine differs from the stage's engine")
    say(f"(d) StreamFilterKernelEngine (blk 256, effective "
        f"{kernel_eng._eng.plan_.meta['blk']}) equals the stage's verdicts "
        f"on 4 messages")
    del kernel_eng

    # (e) the token pipeline and the serving CLI's routing functions
    sparse = FilterStage(profiles=qs, dictionary=d, engine="streaming",
                         sparse=True, batch_size=BATCH, device=str(dev),
                         engine_options={"match_cap": SPARSE_CAP})
    pipes = [drive9("(e) XMLBytePipeline.from_filtered_bytes, phase 4's "
                    "payloads, sparse stage", lambda: XMLBytePipeline.
                    from_filtered_bytes(short["payloads"], sparse, batch=8,
                                        seq_len=512), {"K3"},
                    {"K3": REQUESTS}) for _ in range(2)]
    kept_docs = sorted({r[0] for r in short["routes"]})
    check(pipes[0].payloads == [short["payloads"][i] for i in kept_docs],
          "(e) the pipeline kept other payloads than route matches")
    for step in range(4):
        a, b = pipes[0].batch_at(step), pipes[1].batch_at(step)
        check(all(np.array_equal(a[k], b[k]) for k in a),
              "(e) two pipelines gave different batches")
    say(f"(e) from_filtered_bytes kept {len(kept_docs)} of "
        f"{len(short['payloads'])} payloads, the routed ones; two pipelines "
        f"give equal batches")
    del sparse, pipes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_dir:
        builds = []
        for _ in range(2):
            stage, cli_dtd = serve.build_stage(CLI_REPLICAS,
                                               engine="streaming",
                                               plan_cache=cli_dir,
                                               device=str(dev))
            builds.append(stage)
        c0, c1 = (s._eng.plan_cache for s in builds)
        check(c0.misses > 0 and (c1.hits, c1.misses) == (c0.misses, 0),
              f"(e) build_stage twice: {c0.hits}/{c0.misses} then "
              f"{c1.hits}/{c1.misses} hits/misses")
    stage = builds[1]
    docs = gen_corpus(cli_dtd, n_docs=CLI_REQUESTS, nodes_per_doc=60, seed=1)
    raw = [encode_bytes(x, text_fill=TEXT_FILL) for x in docs]
    by_events = drive9("(e) route_requests, ingest events",
                       lambda: serve.route_requests(stage, docs), {"K1"})
    by_bytes = drive9("(e) route_requests, ingest bytes",
                      lambda: serve.route_requests(stage, docs,
                                                   ingest="bytes", raw=raw),
                      {"K2"})
    check(by_events == by_bytes, "(e) route_requests: events and bytes "
                                 "queues differ")
    args = SimpleNamespace(arrival="replay", rate=2000.0, seed=0,
                           batch=stage.batch_size, deadline_ms=10.0,
                           queue_cap=64, max_inflight=2, overload="shed",
                           latency_json=None)
    queues, slo = drive9("(e) serve_continuous, replay trace",
                         lambda: serve.serve_continuous(stage, raw, args),
                         {"K2"})
    check(queues == by_bytes and slo["shed"] == 0,
          f"(e) serve_continuous queues {queues} != {by_bytes} "
          f"(shed {slo['shed']})")
    out["cli"] = {"queues": [len(q) for q in queues], "p99_ms": slo["p99_ms"]}
    say(f"(e) build_stage twice: the second build {c1.hits} hits, 0 misses; "
        f"route_requests (events, bytes) and serve_continuous (replay) give "
        f"the same queues {[len(q) for q in queues]}")
    return out


# ---------------------------------------------------------------- phase 10
def position_ms(log: LaunchLog) -> list[float]:
    """Mean kernel ms of each stream's launches in a log: one stream a
    mesh position, in the order the streams first launched."""
    torch.cuda.synchronize()
    per: dict[int, list[float]] = {}
    for stream, start, stop in log.rows:
        per.setdefault(stream, []).append(start.elapsed_time(stop))
    return [sum(v) / len(v) for v in per.values()]


def mesh_phase(dtd, d, qs, bufs, run, short, level_ref, serving, sharded,
               dev) -> dict:
    """Phase 10: the 2-D (data x model) mesh on the card, one launch per
    position; every route against the unsharded stage's."""
    from repro_torch.core.events import ByteBatch
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.launch.mesh import FilterMesh, make_filter_mesh
    from repro_torch.serve import ServeLoop, poisson_arrivals

    grid = MESH_DATA * MESH_MODEL
    say(f"phase 10: the 2-D (data x model) mesh, {MESH_DATA} x {MESH_MODEL} "
        f"positions on one card")
    out = {"positions": grid, "launches": {}}

    def stage(profiles=qs, **kw):
        kw.setdefault("engine", "streaming")
        return FilterStage(profiles=profiles, dictionary=d,
                           batch_size=BATCH, device=str(dev), **kw)

    # (a) the mesh make_filter_mesh places on this host, and its stage
    placed = make_filter_mesh(SHARD_PARTS, data_shards=MESH_DATA)
    st = stage(query_shards=SHARD_PARTS, data_shards=MESH_DATA)
    out["placed"] = placed.shape
    check(st.mesh.shape == placed.shape and st.mesh.devices == placed.devices,
          f"(a) the stage placed {st.mesh.shape}, make_filter_mesh "
          f"{placed.shape}")
    got, _ = drive_once(
        f"(a) FilterStage(query_shards={SHARD_PARTS}, data_shards="
        f"{MESH_DATA}) on the placed mesh, 1 request",
        lambda: routed(st.route_bytes(run["payloads"][:BATCH])),
        {"K2": placed.size})
    check(got == [r for r in run["routes"] if r[0] < BATCH],
          "(a) the placed 2-D stage routes differently from phase 3")
    say(f"(a) make_filter_mesh({SHARD_PARTS}, data_shards={MESH_DATA}) "
        f"placed {placed.shape} on {torch.cuda.device_count()} card(s); its "
        f"stage routes phase 3's first request as phase 3")
    del st

    # (b) an explicit 2 x 2 grid of positions on the one card
    mesh = FilterMesh([[dev] * MESH_MODEL for _ in range(MESH_DATA)])
    dense = stage(query_shards=MESH_MODEL, data_shards=MESH_DATA, mesh=mesh)
    list(dense.route_bytes(run["payloads"][:BATCH]))     # warm-up request
    torch.cuda.synchronize()

    def k2_route():
        with LaunchLog("stream_filter_bytes") as log:
            t = time.perf_counter()
            got = routed(dense.route_bytes(run["payloads"]))
            wall = time.perf_counter() - t
        return got, wall, log

    (got, wall, log), launches = drive_once(
        "(b) 2-D route_bytes, dense 1 MB", k2_route,
        {"K2": grid * REQUESTS})
    check(got == run["routes"], "(b) the 2-D dense route differs from "
                                "phase 3's")
    summary = log.summary()
    per_pos = position_ms(log)
    check(summary["streams"] == grid and not summary["on_default_stream"],
          f"(b) K2 launched on {summary['streams']} stream(s), default "
          f"{summary['on_default_stream']}; expected one a position")
    out.update(request_ms=wall / REQUESTS * 1e3, position_ms=per_pos,
               k2_busy_ms=summary["busy_ms"] / REQUESTS,
               k2_overlapped=summary["overlapped"])
    out["launches"]["K2"] = launches["K2"]
    phase3_ms = run["e2e_s"] / REQUESTS * 1e3
    say(f"(b) {REQUESTS} requests of {BATCH} 1 MB documents route as phase "
        f"3: {out['request_ms']:.3f} ms a request (host clock) against "
        f"phase 8(a)'s folded K2 {sharded['K2_ms']:.3f} ms "
        f"({out['request_ms'] / sharded['K2_ms']:.3f} x; predicted 1.0-1.4 "
        f"x) and phase 3's {phase3_ms:.3f} ms; K2 per position "
        f"{', '.join(f'{x:.3f}' for x in per_pos)} ms (CUDA events), card "
        f"busy {out['k2_busy_ms']:.3f} ms a request, positions overlapped: "
        f"{summary['overlapped']}")
    got, launches = drive_once(
        "(b) 2-D route, host-decoded events (K1)",
        lambda: routed(dense.route(run["streams"])), {"K1": grid * REQUESTS})
    check(got == run["routes"], "(b) the 2-D events route differs from "
                                "phase 3's")
    out["launches"]["K1"] = launches["K1"]

    # (c) the pipelined route at depths 1 and 3
    out["pipelined"] = {}
    for k in MESH_DEPTHS:
        dense.stats.update(overlapped_batches=0, put_seconds=0.0)
        t = time.perf_counter()
        got, _ = drive_once(
            f"(c) route_bytes_pipelined(depth={k})",
            lambda: routed(dense.route_bytes_pipelined(run["payloads"],
                                                       depth=k)),
            {"K2": grid * REQUESTS})
        wall = time.perf_counter() - t
        ov = dense.stats["overlapped_batches"]
        check(got == run["routes"], f"(c) depth {k} routes differently "
                                    f"from route_bytes")
        check(ov == (0 if k == 1 else REQUESTS - 1),
              f"(c) depth {k} overlapped {ov} batches")
        out["pipelined"][k] = {"docs_per_s": len(run["payloads"]) / wall,
                               "overlapped_batches": ov,
                               "put_ms": dense.stats["put_seconds"] * 1e3}
        say(f"(c) depth {k}: routes as route_bytes, "
            f"{out['pipelined'][k]['docs_per_s']:.1f} docs/s, "
            f"overlapped_batches {ov}, put_seconds "
            f"{out['pipelined'][k]['put_ms']:.3f} ms in all")
    del dense
    torch.cuda.empty_cache()

    # (b) short messages: events through K4, sparse bytes (K2 at every
    # position, sparsified), and mesh= on the 1-D sparse bytes filter (K3
    # at every model position of the first data row)
    sp = stage(query_shards=MESH_MODEL, data_shards=MESH_DATA, mesh=mesh,
               sparse=True, engine_options={"match_cap": SPARSE_CAP})
    got, launches = drive_once(
        "(b) 2-D sparse route, short messages (K4)",
        lambda: routed(sp.route(short["streams"])), {"K4": grid * REQUESTS})
    check(got == short["routes"], "(b) the 2-D K4 route differs from "
                                  "phase 4's")
    out["launches"]["K4"] = launches["K4"]
    got, _ = drive_once(
        "(b) 2-D sparse route_bytes, short messages (K2, sparsified)",
        lambda: routed(sp.route_bytes(short["payloads"])),
        {"K2": grid * REQUESTS})
    check(got == short["routes"], "(b) the 2-D sparse bytes route differs "
                                  "from phase 4's")
    check(sp.stats["paths"] == {"kernel-fused": REQUESTS,
                                "dense-2d": REQUESTS},
          f"(b) 2-D sparse paths {sp.stats['paths']}")

    def k3_route():
        routes = []
        for i in range(REQUESTS):
            bufs_i = short["payloads"][i * BATCH:(i + 1) * BATCH]
            bb = ByteBatch.from_buffers(bufs_i, bucket=sp.byte_bucket)
            res = sp._eng.filter_bytes_sharded_sparse(
                bb, sp.sharded_, mesh=mesh, match_cap=SPARSE_CAP)
            check(res.meta["path"] == "kernel-fused",
                  f"(b) mesh= K3 took {res.meta}")
            routes.append(sp._fan_out(res, [len(b) for b in bufs_i],
                                      i * BATCH))
        return routed(routes)

    got, launches = drive_once(
        "(b) filter_bytes_sharded_sparse(mesh=) (K3)", k3_route,
        {"K3": MESH_MODEL * REQUESTS})
    check(got == short["routes"], "(b) mesh= K3 differs from phase 4's")
    out["launches"]["K3"] = launches["K3"]
    say(f"(b) short messages: K4 at {grid} positions and the sparse bytes "
        f"route route as phase 4; mesh= K3 at the {MESH_MODEL} model "
        f"positions of the first data row (the 1-D path: the JAX package "
        f"replicates it over data) routes as phase 4")

    # (b) the levelwise engine with K6, 2 parts, one 1 MB request
    lst = FilterStage(profiles=level_profiles(dtd), dictionary=d,
                      engine="levelwise", batch_size=BATCH, device=str(dev),
                      query_shards=MESH_MODEL, data_shards=MESH_DATA,
                      mesh=mesh, engine_options={"use_kernel": True})
    t = time.perf_counter()
    got, launches = drive(
        "(b) 2-D levelwise route_bytes use_kernel=True, 1 request",
        lambda: routed(lst.route_bytes(request_payloads(bufs, 1))),
        {"K5", "K6"})
    out["level_s"] = time.perf_counter() - t
    check(launches["K5"] == grid, f"(b) K5 launched {launches['K5']} times, "
                                  f"not once a position")
    check(launches["K6"] >= grid and launches["K6"] % MESH_MODEL == 0,
          f"(b) K6 launched {launches['K6']} times")
    check(got == level_ref["want_first"], "(b) the 2-D levelwise route "
                                          "differs from the streaming stage")
    out["launches"].update(K5=launches["K5"], K6=launches["K6"])
    say(f"(b) levelwise with K6 at {LEVEL_PROFILES} profiles, one part a "
        f"model position: K5 once a position, K6 once a level of each "
        f"position's slice ({launches['K6']}), routes as the streaming stage "
        f"in {out['level_s']:.3f} s")
    del lst, sp
    torch.cuda.empty_cache()

    # (d) the serve loop over the 2-D sparse stage, with a subscribe and
    # an unsubscribe: the head of phase 7(c)'s trace and its churn, each
    # request held against phase 7(c)'s synchronous stage on its epoch's
    # live set
    msgs = short["payloads"]
    expect, new_q = serving["expect"], serving["new_q"]
    loop_stage = stage(query_shards=MESH_MODEL, data_shards=MESH_DATA,
                       mesh=mesh, sparse=True,
                       engine_options={"match_cap": SPARSE_CAP})
    churn = [msgs[i % len(msgs)] for i in range(MESH_SERVE_REQUESTS)]
    ops = {SUBSCRIBE_AT: lambda lp: lp.subscribe(new_q),
           UNSUBSCRIBE_AT: lambda lp: lp.unsubscribe(0)}
    arrivals = poisson_arrivals(SERVE_CHURN_REQUESTS, SERVE_RATE_HZ,
                                seed=1)[:len(churn)]

    def serve_d():
        with LaunchLog("stream_filter_bytes") as log:
            loop = ServeLoop(loop_stage, max_batch=BATCH,
                             deadline_ms=SERVE_DEADLINE_MS, max_inflight=3,
                             queue_cap=SERVE_QUEUE_CAP)
            t = time.perf_counter()
            with loop:
                tickets, reconfig = churn_trace(loop, churn, arrivals, ops)
            wall = time.perf_counter() - t
        return loop, tickets, reconfig, wall, log.summary()

    (loop, tickets, reconfig, wall, log), _ = drive(
        f"(d) serve loop over the 2-D stage with churn, {len(churn)} "
        f"requests", serve_d, {"K2"})
    out["serve"] = serve_summary("(d) 2-D sparse pub-sub with churn", loop,
                                 wall, log, tickets, arrivals)
    check([(r.op, r.error, r.gid) for r in reconfig]
          == [("subscribe", None, N_PROFILES), ("unsubscribe", None, 0)],
          f"(d) reconfigurations ended "
          f"{[(r.op, r.error, r.gid) for r in reconfig]}")
    per_epoch = {0: 0, 1: 0, 2: 0}
    for i, t in enumerate(tickets):
        if t.shed:
            continue
        check(t.error is None and t.epoch in expect,
              f"(d) request {t.seq}: epoch {t.epoch}, error {t.error!r}")
        check(ticket_gids(t) == expect[t.epoch][i % len(msgs)],
              f"(d) request {t.seq} differs from a stage on epoch "
              f"{t.epoch}'s live set")
        per_epoch[t.epoch] += 1
    check(all(per_epoch.values()), f"(d) an epoch served no request: "
                                   f"{per_epoch}")
    out["serve"]["per_epoch"] = per_epoch
    say(f"(d) requests per epoch {per_epoch}, each routed as a synchronous "
        f"stage on its epoch's live set")
    del loop_stage
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 11
def tree_bytes(tree: dict) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def decode_bound_ms(cfg, param_bytes: int, cache_dtype) -> float:
    """The least time of one decode step at LM_BATCH, averaged over the
    run's steps: every parameter read once (the tied embedding once, for
    the unembedding), the cached keys and values up to the step's
    length read once, the logits written once, over the card's memory
    rate.  The products (2 operations a parameter a row, 0.14 ms at the
    float32 rate) take less."""
    elem = torch.empty((), dtype=cache_dtype).element_size()
    per_position = cfg.n_layers * 2 * LM_BATCH * cfg.n_kv_eff * cfg.d_head \
        * elem
    mean_keys = LM_PROMPT + LM_NEW / 2       # step i reads LM_PROMPT + i + 1
    logits = LM_BATCH * cfg.vocab_eff * 4
    return (param_bytes + mean_keys * per_position + logits) \
        / HBM_BYTES_PER_S * 1e3


def device_busy_us(fn) -> tuple[float, int, list] | None:
    """(kernel microseconds, kernel count, the 6 kernel names of most
    time with their microseconds and counts) of ``fn()`` from a
    ``torch.profiler`` trace of the card, or None where the trace holds
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(((k[:70], us, n) for k, (us, n) in by_name.items()),
                 key=lambda r: -r[1])[:6]
    return (busy, len(kernels), top) if busy > 0 else None


def lm_zoo(dev) -> dict:
    """(c) every architecture, reduced, on the card: prefill then decode
    equals the full forward, and the full forward the CPU port's."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import transformer as T

    errs = {}
    for name in ARCHS:
        cfg = get_config(name, reduced=True)
        host = T.init_model(cfg, torch.Generator().manual_seed(0))
        params = tree_to(host, dev)
        rng = np.random.default_rng(0)
        b, s = LM_ZOO_BATCH, LM_ZOO_SEQ
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
        extra = cfg.frontend_len if cfg.family == "vlm" else 0
        key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
        if key:
            batch[key] = torch.from_numpy(rng.normal(
                size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32))
        on_card = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            full, _ = T.forward_logits(cfg, params, on_card)
            want, _ = T.forward_logits(cfg, host, batch)
            caches = T.init_cache(cfg, b, s + 4 + extra,
                                  dtype=torch.float32, device=dev)
            _, caches = T.prefill(cfg, params, {
                **on_card, "tokens": on_card["tokens"][:, :s - 1]}, caches)
            dec, _ = T.decode_step(cfg, params, on_card["tokens"][:, s - 1:],
                                   caches, s - 1 + extra)
        v = cfg.vocab
        full, dec = full[..., :v].float().cpu(), dec[..., :v].float().cpu()
        want = want[..., :v]
        check(torch.allclose(dec[:, -1], full[:, -1], rtol=LM_ZOO_TOL,
                             atol=LM_ZOO_TOL),
              f"(c) {name}: prefill then decode differs from the full "
              f"forward by {float((dec[:, -1] - full[:, -1]).abs().max())}")
        check(torch.allclose(full, want, rtol=LM_ZOO_TOL, atol=LM_ZOO_TOL),
              f"(c) {name}: the card's forward differs from the CPU's by "
              f"{float((full - want).abs().max())}")
        errs[name] = (float((dec[:, -1] - full[:, -1]).abs().max()),
                      float((full - want).abs().max()))
    return errs


def lm_phase(dev) -> dict:
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.events import encode_bytes
    from repro_torch.data.filter_stage import TEXT_FILL as CLI_TEXT_FILL
    from repro_torch.data.generator import gen_corpus
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    # full float32 products, on the card and on the CPU alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    say(f"phase 11: model serving, {LM_ARCH} at its published width: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; TF32 off")
    out: dict = {}
    t = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    out["param_bytes"] = tree_bytes(params)
    say(f"{out['param_bytes'] / 1e9:.3f} GB of float32 parameters drawn on "
        f"the card in {time.perf_counter() - t:.2f} s")

    # (a) the card against the CPU, one prompt
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, LM_CHECK_TOKENS)).astype(np.int32))
    with torch.inference_mode():
        card, _ = T.forward_logits(cfg, params, {"tokens": prompt.to(dev)})
        host_params = tree_to(params, "cpu")
        t = time.perf_counter()
        host, _ = T.forward_logits(cfg, host_params, {"tokens": prompt})
        host_s = time.perf_counter() - t
        del host_params
    card = card[..., :cfg.vocab].float().cpu()
    host = host[..., :cfg.vocab]
    out["max_abs_err"] = float((card - host).abs().max())
    check(torch.allclose(card, host, rtol=LM_TOL, atol=LM_TOL),
          f"(a) {LM_ARCH}: the card's logits differ from the CPU's by "
          f"{out['max_abs_err']}")
    check(int(card[0, -1].argmax()) == int(host[0, -1].argmax()),
          f"(a) {LM_ARCH}: the card's greedy token differs from the CPU's")
    say(f"(a) {LM_CHECK_TOKENS}-token prompt: card logits within "
        f"{out['max_abs_err']:.3g} of the CPU port's (tolerance {LM_TOL}; "
        f"the CPU took {host_s:.2f} s), the same greedy token "
        f"{int(card[0, -1].argmax())}")

    # (b) route (K2), then each replica generates its queue
    stage, dtd = serve.build_stage(LM_REPLICAS, engine="streaming",
                                   batch_size=LM_BATCH, device=str(dev))
    payloads = gen_corpus(dtd, n_docs=LM_REQUESTS, nodes_per_doc=60, seed=1)
    raw = [encode_bytes(x, text_fill=CLI_TEXT_FILL) for x in payloads]
    host_stage, _ = serve.build_stage(LM_REPLICAS, engine="streaming",
                                      batch_size=LM_BATCH, device="cpu")
    want_queues = serve.route_requests(host_stage, payloads)
    replicas = [ServeEngine(cfg, params, batch=LM_BATCH,
                            max_len=LM_PROMPT + LM_NEW + 4, device=dev)
                for _ in range(LM_REPLICAS)]
    rng = np.random.default_rng(0)
    for eng in replicas:      # warm-up: the shapes' first launches
        eng.generate({"tokens": np.zeros((LM_BATCH, LM_PROMPT), np.int32)},
                     2)

    def route_and_generate():
        queues = serve.route_requests(stage, payloads, ingest="bytes",
                                      raw=raw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_tok = calls = 0
        for rep, queue in enumerate(queues):
            for i in range(0, len(queue), LM_BATCH):
                prompts = rng.integers(0, cfg.vocab, (
                    LM_BATCH, LM_PROMPT)).astype(np.int32)
                toks = replicas[rep].generate({"tokens": prompts}, LM_NEW)
                check(toks.shape == (LM_BATCH, LM_NEW)
                      and 0 <= toks.min() and toks.max() < cfg.vocab,
                      f"(b) generate gave {toks.shape} tokens in "
                      f"[{toks.min()}, {toks.max()}]")
                n_tok += LM_NEW * len(queue[i:i + LM_BATCH])
                calls += 1
        return queues, n_tok, calls, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    queues, n_tok, calls, gen_s = route_and_generate()
    wall = time.perf_counter() - t
    out["launches"] = counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    say(f"(b) route then generate: launches {out['launches']}")
    check(out["launches"]["K2"] > 0 and not any(
        n for k, n in out["launches"].items() if k != "K2"),
        "(b) the route → generate run launched other than K2")
    check(queues == want_queues, f"(b) the card routed {queues}, the CPU "
                                 f"stage {want_queues}")
    out.update(queues=[len(q) for q in queues], tokens=n_tok,
               generate_calls=calls, generate_s=gen_s, wall_s=wall,
               tok_per_s=n_tok / gen_s)

    # prefill and decode steps of one batch between CUDA events
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (
        LM_BATCH, LM_PROMPT)).astype(np.int32), device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.inference_mode():
        caches = T.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW + 4,
                              device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev[0].record()
        logits, caches = T.prefill(cfg, params, {"tokens": prompts}, caches)
        tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None].to(torch.int32)
        ev[1].record()
        t1 = time.perf_counter()

        def steps(first, n):
            nonlocal tok, caches
            for i in range(first, first + n):
                logits, caches = T.decode_step(cfg, params, tok, caches,
                                               LM_PROMPT + i)
                tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None].to(
                    torch.int32)

        steps(0, LM_NEW - 2)
        ev[2].record()
        ev[2].synchronize()
        host_decode_ms = (time.perf_counter() - t1) * 1e3 / (LM_NEW - 2)
        out["prefill_ms"] = ev[0].elapsed_time(ev[1])
        out["decode_ms"] = ev[1].elapsed_time(ev[2]) / (LM_NEW - 2)
        busy = device_busy_us(lambda: steps(LM_NEW - 2, 1))
    out["decode_bound_ms"] = decode_bound_ms(cfg, out["param_bytes"],
                                             torch.bfloat16)
    out["decode_busy_ms"] = busy[0] / 1e3 if busy else None
    out["decode_kernels"] = busy[1] if busy else None
    if busy:
        share = out["decode_busy_ms"] / out["decode_ms"]
        busy_text = (f"the card busy {out['decode_busy_ms']:.3f} ms of it "
                     f"in {out['decode_kernels']} kernels ({share:.1%}; "
                     f"torch.profiler, one step)")
    else:
        busy_text = ("its device-busy share not measured (the profiler "
                     "trace held no device time)")
    say(f"(b) {LM_REQUESTS} requests routed to queues {out['queues']} "
        f"(K2, equal to the CPU stage's), {calls} generate calls of "
        f"{LM_BATCH} x {LM_PROMPT} prompts and {LM_NEW} new tokens: "
        f"{n_tok} tokens in {gen_s:.3f} s = {out['tok_per_s']:.1f} tok/s "
        f"(host clock); route and generate {wall:.3f} s; peak device "
        f"memory {out['peak_bytes'] / 2**30:.2f} GiB; prefill "
        f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms']:.3f} ms a "
        f"step (CUDA events; {host_decode_ms:.3f} ms on the host clock) "
        f"against its byte bound {out['decode_bound_ms']:.3f} ms "
        f"({out['decode_bound_ms'] / out['decode_ms']:.1%}); {busy_text}")
    del replicas, params, caches, logits
    torch.cuda.empty_cache()

    # (c) the registry, reduced
    out["zoo"] = lm_zoo(dev)
    say("(c) every architecture, reduced, on the card: prefill then decode "
        "within " + ", ".join(f"{k} {v[0]:.1e}" for k, v in
                              out["zoo"].items())
        + f" of the full forward (tolerance {LM_ZOO_TOL}); the forward "
        f"within at most {max(v[1] for v in out['zoo'].values()):.1e} of "
        f"the CPU port's")

    # (d) the serving CLI's main, through argv
    argv = ["serve", "--filter-engine", "streaming", "--ingest", "bytes"]
    text = io.StringIO()
    saved = sys.argv
    sys.argv = argv
    reset_counts()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            serve.main()
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    out["main_launches"] = counts()
    print(text.getvalue().strip(), flush=True)
    check("[serve] generated" in text.getvalue()
          and "[serve] live churn" in text.getvalue(),
          "(d) main printed no churn or generation line")
    check({k for k, n in out["main_launches"].items() if n}
          == {"K1", "K2"}, f"(d) main launched {out['main_launches']}; "
                           f"expected K2 (bytes) and K1 (the churn's "
                           f"re-route)")
    say(f"(d) {' '.join(argv[1:])}: {main_s:.2f} s, launches "
        f"{out['main_launches']}")
    return out


# ---------------------------------------------------------------- phase 12
class StoreTimes:
    """For the length of a ``with``, time ``CheckpointStore``'s calls on
    the host clock: ``save_async`` (what the loop waits for), its copy of
    the tree to the host (``_flatten``), the write on its thread
    (``_write``) and ``restore``.  The calls run as they would."""

    NAMES = ("save_async", "_write", "restore")

    def __enter__(self) -> dict:
        from repro_torch.checkpoint import store

        self.store = store
        self.orig = {k: getattr(store.CheckpointStore, k) for k in self.NAMES}
        self.flatten = store._flatten
        times: dict = {k: [] for k in self.NAMES + ("_flatten",)}

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    times[name].append(time.perf_counter() - t)
            return wrapper

        for k, fn in self.orig.items():
            setattr(store.CheckpointStore, k, timed(k, fn))
        store._flatten = timed("_flatten", self.flatten)
        return times

    def __exit__(self, *exc) -> None:
        for k, fn in self.orig.items():
            setattr(self.store.CheckpointStore, k, fn)
        self.store._flatten = self.flatten


class RoutedRecord:
    """For the length of a ``with``, keep every document that a
    ``FilterStage`` routes (what ``_fan_out`` returns): its index, its
    shard and the profiles it matched, which are the filter's
    per-profile verdicts.  The stage runs as it would."""

    def __enter__(self) -> list:
        from repro_torch.data.filter_stage import FilterStage

        self.cls, orig = FilterStage, FilterStage._fan_out
        self.orig = orig
        rows: list = []

        def fan_out(stage, *args, **kwargs):
            routed = orig(stage, *args, **kwargs)
            rows.extend((r.doc_index, r.shard,
                         tuple(int(q) for q in r.matched_profiles))
                        for r in routed)
            return routed

        FilterStage._fan_out = fan_out
        return rows

    def __exit__(self, *exc) -> None:
        self.cls._fan_out = self.orig


def same_ingest(what: str, pipe, routed: list, host, host_routed: list,
                steps: int) -> str:
    """Hold a training ingest built on the card (K5, K6) to the CPU port's
    (their plain versions) on the same corpus, exactly: every routed
    document with its matched profiles, the kept payloads (byte ingest),
    the token buffer and the first ``steps`` batches."""
    first = next(((a, b) for a, b in zip(routed, host_routed) if a != b),
                 None)
    check(routed and routed == host_routed,
          f"{what}: the card routed {len(routed)} documents with "
          f"{sum(len(r[2]) for r in routed)} (document, profile) matches, "
          f"the CPU port {len(host_routed)} with "
          f"{sum(len(r[2]) for r in host_routed)}; first difference "
          f"(document, shard, profiles) {first}")
    check(pipe.payloads == host.payloads,
          f"{what}: the kept payloads differ from the CPU port's")
    check(np.array_equal(pipe._buf, host._buf),
          f"{what}: the token buffer differs from the CPU port's")
    for i in range(steps):
        got, want = pipe.batch_at(i), host.batch_at(i)
        check(got.keys() == want.keys()
              and all(np.array_equal(got[k], want[k]) for k in got),
              f"{what}: batch {i} differs from the CPU port's")
    return (f"{len(routed)} routed documents with "
            f"{sum(len(r[2]) for r in routed)} (document, profile) matches, "
            + ("the kept payloads, " if pipe.payloads is not None else "")
            + f"{len(pipe._buf)} byte tokens and the "
            f"first {steps} batches equal to the CPU port's")


def train_flops(cfg, b: int, s: int) -> float:
    """The products of one training step of a dense decoder with remat
    and the chunked CE: the forward F (every layer's projections and MLP,
    2 operations a weight a token; attention scores and values, 4·b·h·s²·dh
    a layer, the causal half not skipped; the unembedding 2·b·s·d·V),
    then the backward pass 2·F, the layers' recompute F, and the CE
    chunks' recompute of the unembedding: 4·F in all.  Norms, RoPE, the
    softmax and the optimizer are not counted."""
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads_eff, cfg.n_kv_eff,
                       cfg.d_head, cfg.d_ff)
    per_layer = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f
    tokens = b * s
    forward = cfg.n_layers * (2 * tokens * per_layer + 4 * b * h * s * s * dh)
    forward += 2 * tokens * d * cfg.vocab_eff
    return 4.0 * forward


def train_zoo(dev) -> dict:
    """(a) every architecture, reduced, on the card against the CPU, and
    reduced qwen3-0.6b once more with ``remat`` and 8-token CE chunks (the
    chunked cross-entropy, each chunk recomputed in the backward): the
    loss and every gradient; then, for each optimizer, 3 train steps on
    each (their losses compared) and 3 optimizer updates on each from the
    same gradients, the CPU's (the parameters and states compared).
    Every failure of every architecture is listed, with its leaf, before
    the phase fails.

    The parameters after the 3 full train steps are read, not held: both
    optimizers scale a gradient element (AdamW: g / (sqrt(v) + eps)) or a
    row and column (Adafactor's factored second moment) to about ±1
    whatever its size, so where a gradient is zero in exact arithmetic
    (qwen1.5's key bias: a bias on every key of a query shifts its scores
    alike) each device's rounding noise moves the parameter by up to lr,
    in its own direction.  For the element that moved most, the row keeps
    its gradient at each step on each device, the evidence for or against
    that reading.
    """
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.train_step import grads_and_metrics
    from repro_torch.tree import (key_of, tree_flatten_with_path,
                                        tree_leaves, tree_map,
                                        tree_unflatten)

    def loss_and_grads(cfg, params, batch):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss, _ = T.train_loss(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.item(), [torch.zeros_like(x) if g is None else g
                             for g, x in zip(grads, leaves)]

    def copy_to(tree, where):
        return tree_map(lambda x: x.to(where, copy=True), tree)

    def recording(opt, grads):
        """``opt`` whose update first keeps a copy of the gradients."""
        def update(g, state, params, step):
            grads.append([x.detach().cpu().clone() for x in tree_leaves(g)])
            return opt.update(g, state, params, step)
        return dataclasses.replace(opt, update=update)

    cases = [(name, get_config(name, reduced=True)) for name in ARCHS]
    cases.append((f"{LM_ARCH} ce_chunk {TRAIN_ZOO_CE_CHUNK} remat",
                  get_config(LM_ARCH, reduced=True).with_(
                      ce_chunk=TRAIN_ZOO_CE_CHUNK, remat=True)))
    out, failures = {}, []
    for name, cfg in cases:
        host = T.init_model(cfg, torch.Generator().manual_seed(0))
        keys = [key_of(p) for p, _ in tree_flatten_with_path(host)]
        rng = np.random.default_rng(0)
        b, s = TRAIN_ZOO_BATCH, TRAIN_ZOO_SEQ
        tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
        if key:
            batch[key] = rng.normal(
                size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        host_batch = {k: torch.from_numpy(np.array(v))
                      for k, v in batch.items()}
        card_batch = {k: v.to(dev) for k, v in host_batch.items()}
        loss_c, grads_c = loss_and_grads(cfg, tree_to(host, dev), card_batch)
        loss_h, grads_h = loss_and_grads(cfg, host, host_batch)
        rel = abs(loss_c / loss_h - 1)
        if rel > TRAIN_LOSS_RTOL:
            failures.append(f"{name}: the card's loss {loss_c} is "
                            f"{rel:.2e} from the CPU's {loss_h}")
        grad_err = 0.0
        for i, (gc, gh) in enumerate(zip(grads_c, grads_h)):
            gc = gc.cpu()
            err = float((gc - gh).abs().max())
            grad_err = max(grad_err, err)
            if not torch.allclose(gc, gh, rtol=TRAIN_GRAD_RTOL,
                                  atol=TRAIN_GRAD_ATOL):
                failures.append(f"{name}: the gradient of {keys[i]} "
                                f"differs from the CPU's by {err}")
        row = {"loss_rel": rel, "grad_err": grad_err}
        for opt_name in ("adamw", "adafactor"):
            # 3 train steps on each device: the losses; the parameters
            # and each step's gradients read
            losses, finals, seen = [], [], []
            for where in (dev, "cpu"):
                params = copy_to(host, where)
                grads: list = []
                opt = recording(make_optimizer(opt_name), grads)
                state = opt.init(params)
                step = make_train_step(cfg, opt)
                run = []
                for i in range(TRAIN_ZOO_STEPS):
                    params, state, m = step(params, state, batch,
                                            np.int32(i))
                    run.append(m["loss"].item())
                losses.append(run)
                finals.append([x.cpu() for x in tree_leaves(params)])
                seen.append(grads)
            step_rel = max(abs(c / h - 1) for c, h in zip(*losses))
            if step_rel > TRAIN_LOSS_RTOL:
                failures.append(f"{name}: {opt_name} step losses on the "
                                f"card {losses[0]}, on the CPU {losses[1]}")
            diffs = [(c - h).abs() for c, h in zip(*finals)]
            leaf = int(np.argmax([float(x.max()) for x in diffs]))
            at = int(diffs[leaf].argmax())
            row[f"{opt_name}_full"] = {
                "leaf": keys[leaf],
                "element": at,
                "diff": float(diffs[leaf].flatten()[at]),
                "grad_card": [float(g[leaf].flatten()[at]) for g in seen[0]],
                "grad_cpu": [float(g[leaf].flatten()[at]) for g in seen[1]],
                "leaf_grad_max": float(seen[1][0][leaf].abs().max())}
            # 3 updates on each device from the CPU's gradients
            opt = make_optimizer(opt_name)
            p_c, p_h = copy_to(host, dev), copy_to(host, "cpu")
            s_c, s_h = opt.init(p_c), opt.init(p_h)
            for i in range(TRAIN_ZOO_STEPS):
                g, _ = grads_and_metrics(cfg, p_h, batch)
                p_c, s_c = opt.update(copy_to(g, dev), s_c, p_c, np.int32(i))
                p_h, s_h = opt.update(g, s_h, p_h, np.int32(i))
            errs = [float((c.cpu() - h).abs().max()) for c, h in zip(
                tree_leaves((p_c, s_c)), tree_leaves((p_h, s_h)))]
            names = keys + [f"state/{key_of(p)}"
                            for p, _ in tree_flatten_with_path(s_h)]
            worst = int(np.argmax(errs))
            if errs[worst] > TRAIN_PARAM_TOL:
                failures.append(
                    f"{name}: after {TRAIN_ZOO_STEPS} {opt_name} updates "
                    f"from the same gradients the card's {names[worst]} is "
                    f"{errs[worst]} from the CPU's")
            row[opt_name] = errs[worst]
            row[f"{opt_name}_step_loss_rel"] = step_rel
        out[name] = row
    check(not failures, "(a) " + "; ".join(failures))
    return out


def train_phase(dev) -> dict:
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    say("phase 12: training; (a) every architecture, reduced, on the card "
        "against the CPU, float32, TF32 off")
    out: dict = {}
    t = time.perf_counter()
    out["zoo"] = zoo = train_zoo(dev)
    worst = {k: max(v[k] for v in zoo.values())
             for k in next(iter(zoo.values())) if not k.endswith("_full")}
    step_rel = max(worst["adamw_step_loss_rel"],
                   worst["adafactor_step_loss_rel"])
    say(f"(a) in {time.perf_counter() - t:.1f} s: loss within "
        f"{worst['loss_rel']:.1e} relative (tolerance {TRAIN_LOSS_RTOL}), "
        f"gradients within {worst['grad_err']:.1e} absolute (rtol "
        f"{TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL}); {TRAIN_ZOO_STEPS} "
        f"train steps' losses within {step_rel:.1e} relative; after {TRAIN_ZOO_STEPS} updates from the same "
        f"gradients the parameters and states within {worst['adamw']:.1e} "
        f"(AdamW), {worst['adafactor']:.1e} (Adafactor) (tolerance "
        f"{TRAIN_PARAM_TOL})")
    # the parameters after the full train steps, read: every element past
    # TRAIN_PARAM_TOL, else the largest, with its gradient at each step
    full = [(name, opt_name, row[f"{opt_name}_full"])
            for name, row in zoo.items() for opt_name in ("adamw",
                                                          "adafactor")]
    shown = ([x for x in full if x[2]["diff"] > TRAIN_PARAM_TOL]
             or [max(full, key=lambda x: x[2]["diff"])])
    for name, opt_name, r in shown:
        say(f"(a) {name}, {TRAIN_ZOO_STEPS} {opt_name} train steps: "
            f"{r['leaf']}[{r['element']}] {r['diff']:.3g} from the CPU's "
            f"(read, not held); its gradient at each step on the card "
            f"{[f'{g:.3g}' for g in r['grad_card']]}, on the CPU "
            f"{[f'{g:.3g}' for g in r['grad_cpu']]}; the leaf's largest "
            f"|gradient| at step 0 {r['leaf_grad_max']:.3g}")

    # (b) qwen3-0.6b at its published width on the CLI's byte ingest
    cfg = get_config(LM_ARCH)
    say(f"(b) {LM_ARCH} at its published width: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, remat {cfg.remat}, "
        f"ce_chunk {cfg.ce_chunk}, {cfg.optimizer}; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens")
    logs: list = []
    with RoutedRecord() as routed:
        pipe, got = drive("(b) build_filtered_pipeline, bytes",
                          lambda: train_cli.build_filtered_pipeline(
                              TRAIN_BATCH, TRAIN_SEQ, log=logs.append,
                              ingest="bytes", device=str(dev)),
                          {"K5", "K6"})
    out["pipeline_launches"] = got
    with RoutedRecord() as host_routed:
        host_pipe = train_cli.build_filtered_pipeline(
            TRAIN_BATCH, TRAIN_SEQ, log=lambda _: None, ingest="bytes",
            device="cpu")
    say(f"(b) {logs[0]}: "
        + same_ingest("(b)", pipe, routed, host_pipe, host_routed,
                      TRAIN_STEPS + 1))
    del host_pipe
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    events: list = []

    def timed_step(p, s, batch, i):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = step(p, s, batch, i)
        ev[1].record()
        events.append(ev)
        return res

    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        out["disk_free_gb"] = shutil.disk_usage(work).free / 1e9
        loop = LoopConfig(total_steps=TRAIN_STEPS,
                          ckpt_every=TRAIN_CKPT_EVERY,
                          ckpt_dir=os.path.join(work, "run"), log_every=1)
        # torch refuses deterministic cuBLAS products unless this is set;
        # the run is one stream, on which cuBLAS is deterministic anyway
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with StoreTimes() as ckpt:
            t = time.perf_counter()
            full = run_training(cfg, loop, params=params, opt_state=state,
                                step_fn=timed_step, batch_fn=pipe.batch_at,
                                log=say)
            torch.cuda.synchronize()
            out["run_s"] = time.perf_counter() - t
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["step_ms"] = [a.elapsed_time(b) for a, b in events]
            check(len(full.losses) == TRAIN_STEPS
                  and all(np.isfinite(full.losses)),
                  f"(b) the run logged losses {full.losses}")
            check(full.losses[-1] < full.losses[0],
                  f"(b) the loss did not fall: {full.losses}")
            # a crash before step 4's checkpoint: restart from step 2
            shutil.rmtree(os.path.join(loop.ckpt_dir,
                                       f"step_{TRAIN_STEPS:08d}"))
            t = time.perf_counter()
            again = run_training(cfg, loop, params=params, opt_state=state,
                                 step_fn=step, batch_fn=pipe.batch_at,
                                 log=say)
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t
        check(again.resumed_from == TRAIN_CKPT_EVERY
              and again.final_step == TRAIN_STEPS,
              f"(b) the restart resumed from {again.resumed_from} and "
              f"ended at {again.final_step}")
        check(again.losses == full.losses[TRAIN_CKPT_EVERY:],
              f"(b) the restart's losses {again.losses} are not the "
              f"uninterrupted run's {full.losses[TRAIN_CKPT_EVERY:]}")
        torch.use_deterministic_algorithms(False)
        out["losses"] = full.losses
        out["ckpt"] = ckpt
        out["ckpt_bytes"] = sum(x.numel() * x.element_size()
                                for x in tree_leaves((params, state)))
        # kernels of one more step, and the card's busy time in it
        batch = pipe.batch_at(TRAIN_STEPS)
        busy = device_busy_us(lambda: step(params, state, batch,
                                           np.int32(TRAIN_STEPS)))
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
        shutil.rmtree(work, ignore_errors=True)
    steady = sorted(out["step_ms"][1:])
    out["steady_step_ms"] = steady[len(steady) // 2]
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / out["steady_step_ms"] \
        * 1e3
    out["flop"] = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out["tflop_per_s"] = out["flop"] / out["steady_step_ms"] / 1e9
    out["busy_ms"] = busy[0] / 1e3 if busy else None
    out["kernels_a_step"] = busy[1] if busy else None
    out["top_kernels"] = busy[2] if busy else None
    if busy:
        busy_text = (f"{out['kernels_a_step']} kernels a step, the card busy "
                     f"{out['busy_ms']:.1f} ms "
                     f"({out['busy_ms'] / out['steady_step_ms']:.1%} of a "
                     f"step; torch.profiler, one step), most of it in "
                     + "; ".join(f"{k} {us / 1e3:.1f} ms x{n}"
                                 for k, us, n in busy[2]))
    else:
        busy_text = ("kernels and busy share not measured (the profiler "
                     "trace held no device time)")

    def secs(xs):
        return ", ".join(f"{x:.2f}" for x in xs) + " s"

    say(f"(b) losses {full.losses} (replayed bit for bit after the restart "
        f"from step {TRAIN_CKPT_EVERY}: {again.losses}); steps "
        + ", ".join(f"{x:.1f}" for x in out["step_ms"])
        + f" ms (CUDA events; median after the first "
        f"{out['steady_step_ms']:.1f} ms): {out['tokens_per_s']:.1f} "
        f"tokens/s, {out['flop'] / 1e12:.2f} TFLOP a step = "
        f"{out['tflop_per_s']:.2f} TFLOP/s; peak device memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; {busy_text}; run "
        f"{out['run_s']:.1f} s, restart {out['resume_s']:.1f} s (host "
        f"clock); checkpoints of {out['ckpt_bytes'] / 1e9:.2f} GB "
        f"(the run's 3 saves, host clock): save_async blocks "
        f"{secs(ckpt['save_async'])}, of which the copy to the host "
        f"{secs(ckpt['_flatten'])} (the rest waits for the previous "
        f"write), the write on its thread {secs(ckpt['_write'])}; save "
        f"(copy + write) "
        f"{secs(a + b for a, b in zip(ckpt['_flatten'], ckpt['_write']))};"
        f" restore {secs(ckpt['restore'])}; {out['disk_free_gb']:.0f} GB "
        f"free where it wrote")
    del params, state, pipe
    torch.cuda.empty_cache()

    # (c) the training CLI's main on the card, each ingest
    out["cli_launches"] = {}
    for ingest, want in (("bytes", {"K5", "K6"}), ("events", {"K6"})):
        ck = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        argv = ["train", "--data-filter", "--data-ingest", ingest,
                "--steps", str(TRAIN_CLI_STEPS), "--ckpt-every",
                str(TRAIN_CLI_CKPT_EVERY), "--ckpt-dir", ck]
        text = io.StringIO()
        saved_argv = sys.argv
        sys.argv = argv
        # keep the pipeline main builds, and the arguments it built it with
        built: list = []
        build = train_cli.build_filtered_pipeline

        def keep(*args, **kwargs):
            built.append((build(*args, **kwargs), args, kwargs))
            return built[-1][0]

        train_cli.build_filtered_pipeline = keep
        t = time.perf_counter()
        try:
            with RoutedRecord() as routed, contextlib.redirect_stdout(text):
                _, got = drive(f"(c) launch.train.main, {ingest}",
                               train_cli.main, want)
        finally:
            train_cli.build_filtered_pipeline = build
            sys.argv = saved_argv
            shutil.rmtree(ck, ignore_errors=True)
        main_s = time.perf_counter() - t
        out["cli_launches"][ingest] = got
        printed = text.getvalue()
        print(printed.strip(), flush=True)
        check(len(built) == 1, f"(c) {ingest}: main built {len(built)} "
              f"pipelines")
        pipe, args, kwargs = built[0]
        host_logs: list = []
        with RoutedRecord() as host_routed:
            host_pipe = build(*args, **{**kwargs, "device": "cpu",
                                        "log": host_logs.append})
        kept = re.search(r"kept (\d+/\d+)", printed)
        check(kept is not None and host_logs[0] in printed,
              f"(c) {ingest}: main kept {kept and kept.group(1)}; the CPU "
              f"port: {host_logs[0]}")
        same = same_ingest(f"(c) {ingest}", pipe, routed, host_pipe,
                           host_routed, TRAIN_CLI_STEPS)
        m = re.search(r"done at step (\d+); loss ([0-9.]+) → ([0-9.]+)",
                      printed)
        check(m is not None and int(m.group(1)) == TRAIN_CLI_STEPS
              and float(m.group(3)) < float(m.group(2)),
              f"(c) {ingest}: main's loss did not fall over "
              f"{TRAIN_CLI_STEPS} steps: {m and m.group(0)}")
        say(f"(c) {ingest}: {main_s:.2f} s, kept {kept.group(1)}; {same}; "
            f"loss {m.group(2)} → {m.group(3)}, launches {got}")
    return out


# ---------------------------------------------------------------- phase 13
def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: the raw 16- or 32-bit words of the values."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    words = {2: torch.int16, 4: torch.int32}.get(a.element_size())
    return torch.equal(a.view(words), b.view(words)) if words is not None \
        and a.is_floating_point() else torch.equal(a, b)


def moe_run(p: dict, x: torch.Tensor, fn, card: bool = True) -> tuple:
    """(y, gradients of router, wi and wo, ms, peak bytes) of
    ``sum(fn(q, x) ** 2)`` forward and backward, ``q`` being ``p``'s
    leaves as new leaves that take gradients; on the card, ms from CUDA
    events on the caller's stream (which joins the positions' streams)
    and the peak of device memory, else ``None``."""
    q = {k: (v.detach().requires_grad_(True) if isinstance(v, torch.Tensor)
             else {kk: vv.detach().requires_grad_(True)
                   for kk, vv in v.items()}) for k, v in p.items()}
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    y = fn(q, x)
    (y ** 2).sum().backward()
    if not card:
        return y.detach(), {k: q[k].grad for k in ("router", "wi", "wo")}, \
            None, None
    ev[1].record()
    ev[1].synchronize()
    return (y.detach(), {k: q[k].grad for k in ("router", "wi", "wo")},
            ev[0].elapsed_time(ev[1]), torch.cuda.max_memory_allocated())


def moe_err(got: tuple, want: tuple) -> tuple[float, float]:
    """(max |forward difference|, max over router / wi / wo of the
    largest gradient difference relative to the largest gradient)."""
    fwd = float((got[0].float().cpu() - want[0].float().cpu()).abs().max())
    rel = max(float((got[1][k].cpu() - want[1][k].cpu()).abs().max())
              / (float(want[1][k].abs().max()) + 1e-9) for k in got[1])
    return fwd, rel


class BranchLog:
    """For the length of a ``with``, list the expert-parallel branches
    taken (``"stationary"``, ``"shardmap"``): by ``moe``, or, given the
    dispatches' bodies' names, by the sharded train step."""

    def __init__(self, names=("_moe_ep_stationary", "_moe_ep_shardmap")):
        self.names = names

    def __enter__(self) -> list:
        from repro_torch.models import layers

        self.layers = layers
        self.orig = {n: getattr(layers, n) for n in self.names}
        taken: list = []

        def logged(name, fn):
            def wrapper(*args, **kwargs):
                taken.append("stationary" if "stationary" in name
                             else "shardmap")
                return fn(*args, **kwargs)
            return wrapper
        for n, fn in self.orig.items():
            setattr(layers, n, logged(n, fn))
        return taken

    def __exit__(self, *exc) -> None:
        for n, fn in self.orig.items():
            setattr(self.layers, n, fn)


def mesh_lm_phase(dev) -> dict:
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.sharding import mesh_context
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import PlacedTensor, gather
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    grid = make_host_mesh(MESH_LM_MODEL,
                          devices=[dev] * (MESH_LM_DATA * MESH_LM_MODEL))
    say(f"phase 13: the LM substrate on a mesh, a {MESH_LM_DATA} x "
        f"{MESH_LM_MODEL} grid of positions on the card")
    out: dict = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    try:
        # (a) a bfloat16 checkpoint at full width
        cfg16 = get_config(LM_ARCH, param_dtype="bfloat16")
        p16 = T.init_model(cfg16, torch.Generator(device=dev).manual_seed(0))
        store = CheckpointStore(os.path.join(work, "bf16"))
        _, save_s = timed(lambda: store.save(1, p16, {"config": cfg16.name}))
        (back, manifest), restore_s = timed(lambda: store.restore(1, p16))
        check(all(same_bits(a, b) for a, b in zip(tree_leaves(back),
                                                   tree_leaves(p16))),
              "(a) the bfloat16 checkpoint did not restore bit for bit")
        check(set(manifest["dtypes"].values()) == {"bfloat16"},
              f"(a) manifest dtypes {set(manifest['dtypes'].values())}")
        with np.load(os.path.join(work, "bf16", "step_00000001",
                                  "arrays.npz")) as z:
            npz_dtype = z["embed"].dtype.str
        check(npz_dtype == "|V2", f"(a) the npz holds {npz_dtype}")
        out["bf16"] = {"bytes": nbytes(p16), "save_s": save_s,
                       "restore_s": restore_s}
        say(f"(a) {LM_ARCH} in bfloat16, {nbytes(p16) / 1e9:.2f} GB: save "
            f"{save_s:.2f} s, restore {restore_s:.2f} s (host clock), "
            f"bit for bit; npz {npz_dtype}, manifest 'bfloat16'")
        del p16, back
        shutil.rmtree(os.path.join(work, "bf16"))

        # (b) rule specs, then the elastic flow on the grid
        cfg = get_config(LM_ARCH)
        shapes = T.init_model(cfg, None)
        total = nbytes(shapes)
        for name, mesh in (("make_host_mesh()", make_host_mesh()),
                           (f"the {MESH_LM_DATA} x {MESH_LM_MODEL} grid",
                            grid)):
            sh = tree_leaves(R.param_shardings(cfg, shapes, mesh))
            split = sum(not s.is_fully_replicated for s in sh)
            per_pos = sum(int(np.prod(s.shard_shape(x.shape)))
                          * x.element_size()
                          for s, x in zip(sh, tree_leaves(shapes)))
            out.setdefault("specs", {})[name] = {
                "shape": mesh.shape, "split": split, "leaves": len(sh),
                "bytes_a_position": per_pos}
            say(f"(b) rule specs on {name} {mesh.shape}: {split} of "
                f"{len(sh)} leaves split, {per_pos / 1e9:.3f} GB a position "
                f"of {total / 1e9:.3f} GB")
        shardings = R.param_shardings(cfg, shapes, grid)
        params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
        store = CheckpointStore(os.path.join(work, "elastic"))
        steps = {}
        _, steps["save, one device"] = timed(
            lambda: store.save(3, params, {"mesh": "none"}))
        (step, placed, _), steps["restore onto 2 x 2"] = timed(
            lambda: store.restore_latest(params, shardings))
        leaves = tree_leaves(placed)
        check(step == 3 and all(isinstance(x, PlacedTensor)
                                for x in leaves),
              "(b) the restore onto the grid did not place every leaf")
        n_split = sum(not x.sharding.is_fully_replicated for x in leaves)
        check(n_split > 0, "(b) no leaf split on the grid")
        check(all(same_bits(gather(a), b)
                  for a, b in zip(leaves, tree_leaves(params))),
              "(b) the gathered leaves differ from the saved ones")
        _, steps["save, placed 2 x 2"] = timed(
            lambda: store.save(4, placed, {"mesh": "2x2"}))
        (step, back, _), steps["restore replicated"] = timed(
            lambda: store.restore_latest(params))
        check(step == 4 and all(same_bits(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(params))),
              "(b) the replicated restore differs from the saved tree")
        out["elastic"] = {"bytes": total, "split": n_split, "s": steps}
        say(f"(b) elastic flow on the grid, {total / 1e9:.2f} GB float32, "
            f"{n_split} leaves split, bit for bit: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in steps.items())
            + " (host clock)")
        del params, placed, back, leaves
        shutil.rmtree(os.path.join(work, "elastic"))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (c) one MoE layer at its published width on the grid
    cfg = get_config(MOE_ARCH)
    p = L.init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
    say(f"(c) one MoE layer of {MOE_ARCH} at its published width: d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts, top-{cfg.moe_top_k}, "
        f"d_expert {cfg.d_expert}, {nbytes(p) / 1e9:.2f} GB float32")
    out["moe"] = {}
    for n, want in MOE_TOKENS:
        x = torch.randn((1, n, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(n))
        x2 = x.reshape(n, cfg.d_model)
        shards = 1 if want == "stationary" else MESH_LM_DATA
        drops = L.dropped_assignments(cfg, p["router"], x2, shards,
                                      L._ep_capacity(cfg, n // shards))
        drops_one = L.dropped_assignments(cfg, p["router"], x2, 1,
                                          L._moe_capacity(cfg, n))

        def ep(q, xx):
            with mesh_context(grid):
                return L.moe(cfg, q, xx)
        with BranchLog() as taken:
            got = moe_run(p, x, ep)
        check(taken == [want], f"(c) n = {n}: moe took {taken}, not "
                               f"[{want!r}]")
        if drops == 0 and drops_one == 0:
            what = "the card's single-device moe"

            def plain(q, xx):
                return L.moe(cfg, q, xx)
        else:
            what = "the same dispatch, positions one after another"
            branch = getattr(L, f"_moe_ep_{want}")

            def plain(q, xx):
                return branch(cfg, q, xx.reshape(n, -1), grid,
                              streams=False).reshape(xx.shape)
        ref = moe_run(p, x, plain)
        fwd, rel = moe_err(got, ref)
        check(fwd < MOE_FWD_TOL and rel < MOE_GRAD_RTOL,
              f"(c) n = {n} ({want}): forward {fwd:.3g}, gradients "
              f"{rel:.3g} relative against {what}")
        # timed in turns after the checked runs: branch, reference, ...
        reps, ref_reps = [], []
        for _ in range(MOE_TIMED_REPS):
            reps.append(moe_run(p, x, ep)[2])
            ref_reps.append(moe_run(p, x, plain)[2])
        reps, ref_reps = sorted(reps), sorted(ref_reps)
        busy = device_busy_us(lambda: moe_run(p, x, ep))
        out["moe"][want] = {
            "n": n, "dropped": drops, "dropped_single": drops_one,
            "ms": reps[len(reps) // 2], "ms_runs": reps, "ref": what,
            "ref_ms": ref_reps[len(ref_reps) // 2], "ref_ms_runs": ref_reps,
            "peak_bytes": got[3], "ref_peak": ref[3],
            "fwd_err": fwd, "grad_rel": rel,
            "y_max": float(ref[0].abs().max()),
            "busy_ms": busy[0] / 1e3 if busy else None,
            "kernels": busy[1] if busy else None,
            "top_kernels": busy[2] if busy else None}
        busy_text = (f"; one more run traced: {busy[1]} kernels, the card "
                     f"busy {busy[0] / 1e3:.2f} ms (torch.profiler), most "
                     f"in " + "; ".join(f"{k} {us / 1e3:.2f} ms x{c}"
                                       for k, us, c in busy[2][:3])
                     if busy else "; busy share not measured (the trace "
                     "held no device time)")
        say(f"(c) n = {n}: the {want} branch; dropped assignments {drops} "
            f"(the single-device path's {drops_one}); against {what}: "
            f"forward {fwd:.2e} (tolerance {MOE_FWD_TOL}), gradients "
            f"{rel:.2e} relative ({MOE_GRAD_RTOL}), the reference's "
            f"largest |y| {out['moe'][want]['y_max']:.3g}; forward + "
            f"backward " + ", ".join(f"{r:.2f}" for r in reps)
            + " ms (CUDA events, in turns with the reference's "
            + ", ".join(f"{r:.2f}" for r in ref_reps) + " ms), peak "
            f"{got[3] / 2**30:.2f} GiB (the reference {ref[3] / 2**30:.2f})"
            + busy_text)
        del got, ref, x, x2
    del p
    torch.cuda.empty_cache()
    cpu_grid = make_host_mesh(MESH_LM_MODEL, devices=["cpu"] * (
        MESH_LM_DATA * MESH_LM_MODEL))
    worst = (0.0, 0.0)
    for arch in MOE_ZOO:
        cfg = get_config(arch, reduced=True)
        p = L.init_moe(cfg, torch.Generator().manual_seed(0))
        for shape in MOE_ZOO_SHAPES:
            x = torch.randn(shape + (cfg.d_model,),
                            generator=torch.Generator().manual_seed(1))

            def ep_on(mesh):
                def f(q, xx):
                    with mesh_context(mesh):
                        return L.moe(cfg, q, xx)
                return f
            on_card = {k: v.to(dev) if isinstance(v, torch.Tensor)
                       else {kk: vv.to(dev) for kk, vv in v.items()}
                       for k, v in p.items()}
            card = moe_run(on_card, x.to(dev), ep_on(grid))
            host = moe_run(p, x, ep_on(cpu_grid), card=False)
            fwd, rel = moe_err(card, host)
            check(fwd < MOE_FWD_TOL and rel < MOE_GRAD_RTOL,
                  f"(c) reduced {arch} {shape}: forward {fwd:.3g}, "
                  f"gradients {rel:.3g} relative against the CPU")
            worst = (max(worst[0], fwd), max(worst[1], rel))
    out["zoo_err"] = worst
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"(c) reduced {', '.join(MOE_ZOO)} on the grid, token counts "
        f"{[a * b for a, b in MOE_ZOO_SHAPES]}, against the CPU port's "
        f"expert-parallel path: forward within {worst[0]:.2e}, gradients "
        f"within {worst[1]:.2e} relative; phase 13 in {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14
class MoeDrops:
    """For the length of a ``with``, count each ``moe`` call's dropped
    assignments at the expert-parallel capacity of ``shards`` data shards
    (``dropped_assignments``), and at the single-device capacity."""

    def __init__(self, cfg, shards: int, stationary: bool) -> None:
        self.cfg, self.shards, self.stationary = cfg, shards, stationary

    def __enter__(self) -> list:
        from repro_torch.models import layers

        self.layers, self.orig = layers, layers.moe
        seen: list = []
        cfg, orig = self.cfg, self.orig

        def moe(c, p, x):
            n = x.shape[0] * x.shape[1]
            x2 = x.reshape(n, -1).detach()
            shards = 1 if self.stationary else self.shards
            seen.append((
                layers.dropped_assignments(cfg, p["router"].detach(), x2,
                                           shards, layers._ep_capacity(
                                               cfg, n // shards)),
                layers.dropped_assignments(cfg, p["router"].detach(), x2, 1,
                                           layers._moe_capacity(cfg, n))))
            return orig(c, p, x)
        layers.moe = moe
        return seen

    def __exit__(self, *exc) -> None:
        self.layers.moe = self.orig


def placed_err(placed, plain, rtol: float, atol: float) -> tuple:
    """(the largest |gathered - plain|, the largest ratio of a difference
    to its bound ``atol + rtol·|plain|``), over the leaves."""
    rows = leaf_ratios(placed, plain, rtol, atol)
    # np.max keeps a NaN (Python's max would drop it)
    return (float(np.max([0.0] + [r[2] for r in rows])),
            float(np.max([0.0] + [r[1] for r in rows])))


def leaf_ratios(got, want, rtol: float, atol: float) -> list:
    """``(path, ratio, max difference)`` a leaf: the largest ratio of
    ``|got - want|`` to ``atol + rtol·|want|``, in float64, a block of
    rows at a time; placed leaves are gathered."""
    from repro_torch.sharding.placement import PlacedTensor, gather
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    rows = []
    for (path, a), b in zip(tree_flatten_with_path(got), tree_leaves(want)):
        a = gather(a) if isinstance(a, PlacedTensor) else a
        b = gather(b) if isinstance(b, PlacedTensor) else b
        ratio = diff = 0.0
        step = max(1, (1 << 24) // max(1, b[0].numel() if b.dim() else 1))
        for i in range(0, max(1, b.shape[0] if b.dim() else 1), step):
            x = a[i:i + step] if a.dim() else a
            y = b[i:i + step].double() if b.dim() else b.double()
            d = (x.double() - y).abs()
            ratio = float(np.max([ratio, float(
                (d / (atol + rtol * y.abs())).max())]))
            diff = float(np.max([diff, float(d.max())]))
        rows.append(("/".join(map(str, path)), ratio, diff))
    return rows


def sharded_case(what: str, cfg, pipe, grid, dev, *, timed: bool,
                 drops_shards: int | None = None,
                 stationary: bool = False) -> dict:
    """One model on the grid: the one-device step's gradients, then the
    sharded step's (held to them), the updates from the same gradients
    (held), a second step through both step functions (losses held), the
    shardings kept; then, with the one-device copies freed, timed steps
    (CUDA events), the card's busy share and peak memory, beside the dry
    run's estimate for this mesh and shape."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.cells import Cell
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import (NamedSharding, PlacedTensor,
                                                device_put, gather)
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.train_step import grads_and_metrics
    from repro_torch.tree import tree_leaves, tree_map_with_path

    out: dict = {}
    b0, b1 = pipe.batch_at(0), pipe.batch_at(1)
    rows, seq = b0["tokens"].shape
    opt = make_optimizer(cfg.optimizer)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    out["param_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree_leaves(params))
    if drops_shards is not None:
        with MoeDrops(cfg, drops_shards, stationary) as seen:
            m1 = grads_and_metrics(cfg, params, b0)[1]
        out["dropped"] = [a for a, _ in seen]
        out["dropped_single"] = [b for _, b in seen]
    drops = sum(out.get("dropped", [])) + sum(out.get("dropped_single", []))
    if not drops:
        # the float32 steps are held to a float64 one-device step: at
        # full width two float32 summation orders (the tied embedding's
        # 8,192 lookups and 151,936-wide unembedding) part by more than
        # phase 12(a)'s bound, and the one-device step's own distance
        # from float64 is the yardstick (a MoE router stays float32: the
        # model computes its logits in float32 whatever the dtypes)
        out["ref"] = "a float64 one-device step"
        c64 = cfg.with_(param_dtype="float64", activ_dtype="float64")
        p64 = tree_map_with_path(
            lambda path, x: x if path[-1] == "router" else x.double(),
            params)
        g64, m64 = grads_and_metrics(c64, p64, b0)
        del p64
        torch.cuda.empty_cache()
        out["loss64"] = float(m64["loss"])
        g1, m1 = grads_and_metrics(cfg, params, b0)
        one = leaf_ratios(g1, g64, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)
        g1 = g64
        del g64
        torch.cuda.empty_cache()
    shapes = T.init_model(cfg, None)
    pspecs = R.param_specs(cfg, shapes, grid)

    def named(specs):
        return tree_map_with_path(lambda _, s: NamedSharding(grid, s), specs,
                                  is_leaf=R.is_spec)
    placed = device_put(tree_map_with_path(lambda _, x: x.clone(), params),
                        named(pspecs))
    state = device_put(opt.init(params), named(D.opt_state_specs(
        cfg.optimizer, shapes, pspecs, grid)))
    before = [x.sharding for x in tree_leaves((placed, state))]
    first = grid.positions()[0]
    out["placed_bytes"] = sum(x.shards[first].numel()
                              * x.shards[first].element_size()
                              for x in tree_leaves((placed, state)))
    cell = Cell(cfg.name, ShapeSpec("phase14", seq, rows, "train"), True)
    t = time.perf_counter()
    art = D.run_cell(cell, multi_pod=False, cfg=cfg, mesh=grid)
    out["dryrun_s"] = time.perf_counter() - t
    check(art["status"] == "ok", f"{what}: the dry run failed: "
                                 f"{art.get('error')}")
    out["dryrun"] = {k: art[k] for k in (
        "params", "opt_state", "batch", "argument_B", "grad_B",
        "saved_B_estimate", "per_position_B", "flops", "fits_h100_80g")}
    check(out["placed_bytes"] == art["params"] + art["opt_state"],
          f"{what}: the placed tree holds {out['placed_bytes']} bytes a "
          f"position, the dry run counts {art['params']} + "
          f"{art['opt_state']}")
    if drops:
        # tokens drop at another capacity than the one-device step's:
        # hold the sharded step against itself with its positions one
        # after another on this stream
        from repro_torch.train import sharded_step

        out["ref"] = "the sharded step, positions one after another"
        g1, m1 = sharded_step.grads_and_metrics(cfg, placed, b0,
                                                streams=False)
    torch.cuda.empty_cache()
    g2, m2 = grads_and_metrics(cfg, placed, b0)
    out["loss"] = (float(m2["loss"]), float(m1["loss"]))
    loss_rel = abs(out["loss"][0] / out["loss"][1] - 1)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"{what}: loss {out['loss'][0]} against {out['ref']}'s "
          f"{out['loss'][1]}")
    ratios = leaf_ratios(g2, g1, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)
    out["grad_diff"] = float(np.max([r[2] for r in ratios]))
    if drops:
        out["grad_ratio"] = float(np.max([r[1] for r in ratios]))
        check(out["grad_ratio"] <= 1.0,
              f"{what}: gathered gradients {out['grad_diff']:.3g} from "
              f"{out['ref']}'s, {out['grad_ratio']:.3g} of the bound")
    else:
        # a leaf passes within the bound, or no farther from float64 than
        # 1.5 times the float32 one-device step
        out["grad_leaves"] = [(p, r, o[1])
                              for (p, r, _), o in zip(ratios, one)]
        worst = max(out["grad_leaves"],
                    key=lambda x: x[1] / max(1.0, 1.5 * x[2]))
        out["grad_ratio"], out["one_ratio"] = worst[1], worst[2]
        out["grad_leaf"] = worst[0]
        check(all(r <= max(1.0, 1.5 * o) for _, r, o in out["grad_leaves"]),
              f"{what}: the gathered gradients' leaf {worst[0]} is "
              f"{worst[1]:.3g} of the bound from the float64 step, the "
              f"float32 one-device step's {worst[2]:.3g}")
    del g1
    torch.cuda.empty_cache()
    # updates from the same gradients: the placed optimizer on the
    # shards, then (their gradients freed first, to keep the peak of the
    # 7.47 GB model inside the card) the one-device one on them gathered
    opt.update(g2, state, placed, 0)
    plain = tree_map_with_path(lambda _, g: gather(g), g2)
    del g2
    torch.cuda.empty_cache()
    one_state = opt.init(params)
    opt.update(plain, one_state, params, 0)
    del plain
    upd = max(placed_err(placed, params, 0.0, 1.0)[0],
              placed_err(state, one_state, 0.0, 1.0)[0])
    check(upd <= TRAIN_PARAM_TOL, f"{what}: after updates from the same "
                                  f"gradients {upd:.3g} apart")
    del one_state
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt)
    got = step(placed, state, b1, np.int32(1))
    check(got[0] is placed and got[1] is state
          and all(isinstance(x, PlacedTensor) and x.sharding == s
                  for x, s in zip(tree_leaves(got[:2]), before)),
          f"{what}: the step's output shardings differ from its input's")
    if not drops:
        # the one-device step's loss at step 1 (its update is not needed)
        want = grads_and_metrics(cfg, params, b1)[1]
        rel1 = abs(float(got[2]["loss"]) / float(want["loss"]) - 1)
        check(rel1 <= TRAIN_LOSS_RTOL, f"{what}: step 1's loss "
              f"{float(got[2]['loss'])} against {float(want['loss'])}")
        out["step1_loss"] = (float(got[2]["loss"]), float(want["loss"]))
    del params
    torch.cuda.empty_cache()
    out.update(loss_rel=loss_rel, update_diff=upd)
    if not timed:
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(SHARDED_TIMED_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        step(placed, state, (b0, b1)[i % 2], np.int32(2 + i))
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    out["step_ms"] = ms
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    busy = device_busy_us(lambda: step(placed, state, b0,
                                       np.int32(2 + SHARDED_TIMED_STEPS)))
    out["busy_ms"] = busy[0] / 1e3 if busy else None
    out["kernels"] = busy[1] if busy else None
    out["top_kernels"] = busy[2] if busy else None
    best = min(ms)
    out["tokens_per_s"] = rows * seq / best * 1e3
    out["tflop_per_s"] = art["flops"] / best / 1e9
    del placed, state
    torch.cuda.empty_cache()
    return out


def sharded_step_phase(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.cells import Cell, enumerate_cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import SHAPES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    total = torch.cuda.get_device_properties(0).total_memory
    out["total_memory"] = total
    say(f"phase 14: the cell table, the dry run and the sharded train step; "
        f"the card's memory {total} bytes (the dry run's H100_80G_BYTES "
        f"{D.H100_80G_BYTES}), {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB still allocated by the earlier phases")
    # (a) every cell at both production meshes, from its specs
    t = time.perf_counter()
    rows = [D.run_cell(c, multi_pod=mp, measure=False)
            for c in enumerate_cells() for mp in (False, True)]
    check(len(rows) == 80 and {r["status"] for r in rows} <= {"ok", "skip"},
          f"(a) the cell table: {len(rows)} rows, statuses "
          f"{sorted({r['status'] for r in rows})}")
    ok = [r for r in rows if r["status"] == "ok"]
    out["table"] = {(r["arch"], r["shape"], r["mesh"]): (
        r["per_position_B"], r["fits_h100_80g"]) for r in ok}
    say(f"(a) {len(rows)} rows ({len(ok)} runnable, "
        f"{len(rows) - len(ok)} skipped) in {time.perf_counter() - t:.1f} s;"
        f" fit an H100 80GB (argument and gradient bytes a position): "
        f"{sum(r['fits_h100_80g'] for r in ok)} of {len(ok)}")
    for arch in dict.fromkeys(r["arch"] for r in ok):
        say(f"(a) {arch}: " + "; ".join(
            f"{r['shape']} @ {r['mesh']} "
            f"{r['per_position_B'] / 2**30:.2f} GiB"
            f"{'' if r['fits_h100_80g'] else ' (does not fit)'}"
            for r in ok if r["arch"] == arch))
    out["flops"] = {}
    for arch in SHARDED_FLOP_CELLS:
        t = time.perf_counter()
        art = D.run_cell(Cell(arch, SHAPES["train_4k"], True),
                         multi_pod=False)
        check(art["status"] == "ok", f"(a) {arch} train_4k: "
                                     f"{art.get('error')}")
        art["seconds"] = time.perf_counter() - t
        out["flops"][arch] = art
        say(f"(a) {arch} train_4k @ pod16x16 on the meta device in "
            f"{art['seconds']:.1f} s: {art['flops']:.4g} FLOP "
            f"({art['flops_per_position']:.4g} a position, even split), "
            f"model_flops {art['model_flops']:.4g}; a position holds "
            f"{art['argument_B'] / 2**30:.2f} GiB of arguments, "
            f"{art['grad_B'] / 2**30:.2f} GiB of gradients and about "
            f"{art['saved_B_estimate'] / 2**30:.2f} GiB of saved "
            f"activations (estimate): {art['per_position_B'] / 2**30:.2f} "
            f"GiB, fits_h100_80g {art['fits_h100_80g']}")

    grid = make_host_mesh(MESH_LM_MODEL,
                          devices=[dev] * (MESH_LM_DATA * MESH_LM_MODEL))
    # (b) qwen3-0.6b at its published width on the byte ingest
    cfg = get_config(LM_ARCH)
    pipe, got = drive("(b) build_filtered_pipeline, bytes",
                      lambda: train_cli.build_filtered_pipeline(
                          TRAIN_BATCH, TRAIN_SEQ, log=lambda _: None,
                          ingest="bytes", device=str(dev)), {"K5", "K6"})
    out["launches"]["b"] = got
    reset_counts()
    t = time.perf_counter()
    out["b"] = b = sharded_case(f"(b) {LM_ARCH}", cfg, pipe, grid, dev,
                                timed=True)
    b["s"] = time.perf_counter() - t
    out["step_launches"] = counts()
    report_case(f"(b) {LM_ARCH}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens", b)
    del pipe
    # (c) qwen3-moe-30b-a3b at its published widths, 2 of 48 layers
    mcfg = get_config(MOE_ARCH).with_(n_layers=SHARDED_MOE_LAYERS)
    out["c"] = {}
    for rows, seq, branch in SHARDED_MOE_BATCHES:
        pipe, got = drive(f"(c) build_filtered_pipeline, bytes, {rows} x "
                          f"{seq}", lambda: train_cli.build_filtered_pipeline(
                              rows, seq, log=lambda _: None, ingest="bytes",
                              device=str(dev)), {"K5", "K6"})
        out["launches"][f"c/{branch}"] = got
        reset_counts()
        t = time.perf_counter()
        with BranchLog(("_ep_stationary_parts",
                        "_ep_shardmap_parts")) as taken:
            c = sharded_case(f"(c) {MOE_ARCH}, {branch}", mcfg, pipe, grid,
                             dev, timed=branch == "shardmap",
                             drops_shards=MESH_LM_DATA,
                             stationary=branch == "stationary")
        c["s"] = time.perf_counter() - t
        check(taken and set(taken) == {branch},
              f"(c) {branch}: the sharded step took {sorted(set(taken))}")
        step_counts = counts()
        check(not any(step_counts.values()),
              f"(c) the sharded steps launched {step_counts}")
        out["c"][branch] = c
        report_case(f"(c) {MOE_ARCH} ({SHARDED_MOE_LAYERS} of 48 layers, "
                    f"{c['param_bytes'] / 1e9:.2f} GB float32), {rows} x "
                    f"{seq} tokens, {branch}", c)
        del pipe
    check(not any(out["step_launches"].values()),
          f"(b) the sharded steps launched {out['step_launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 14 in {out['phase_s']:.1f} s")
    return out


def report_case(what: str, r: dict) -> None:
    d = r["dryrun"]
    drops = (f"; dropped assignments a dispatch (each microbatch's forward "
             f"and its recompute) {r['dropped']} (the single-device path's "
             f"{r['dropped_single']})" if "dropped" in r else "")
    if "one_ratio" in r:
        grads = (f"gathered gradients against a float64 one-device step: "
                 f"the farthest leaf ({r['grad_leaf']}) at {r['grad_ratio']:.3g}"
                 f" of phase 12(a)'s bound (rtol {TRAIN_GRAD_RTOL}, atol "
                 f"{TRAIN_GRAD_ATOL}), the float32 one-device step's "
                 f"{r['one_ratio']:.3g} (every leaf within the bound or 1.5 "
                 f"times the one-device step's); the float64 loss "
                 f"{r['loss64']:.7f}")
    else:
        grads = (f"gathered gradients within {r['grad_diff']:.2e} of "
                 f"{r['ref']}'s ({r['grad_ratio']:.3f} of the bound)")
    say(f"{what}: loss {r['loss'][0]:.7f} against the float32 reference's "
        f"{r['loss'][1]:.7f} ({r['loss_rel']:.2e} relative, tolerance "
        f"{TRAIN_LOSS_RTOL}); {grads}; updates from the same gradients "
        f"within {r['update_diff']:.2e} ({TRAIN_PARAM_TOL})"
        + (f", step 1's loss {r['step1_loss'][0]:.7f} / "
           f"{r['step1_loss'][1]:.7f}" if "step1_loss" in r else "")
        + drops + f"; shardings kept; placed {r['placed_bytes']} bytes a "
        f"position = the dry run's parameters {d['params']} + optimizer "
        f"state {d['opt_state']}; {r['s']:.1f} s (dry run "
        f"{r['dryrun_s']:.1f} s)")
    if "step_ms" not in r:
        return
    busy = (f"{r['kernels']} kernels, the card busy {r['busy_ms']:.1f} ms "
            f"({r['busy_ms'] / min(r['step_ms']):.1%} of the fastest step; "
            f"torch.profiler, one step), most in " + "; ".join(
                f"{k} {us / 1e3:.1f} ms x{n}" for k, us, n in
                r["top_kernels"][:4])
            if r["busy_ms"] else "busy share not measured (the trace held "
            "no device time)")
    say(f"{what}: steps " + ", ".join(f"{x:.1f}" for x in r["step_ms"])
        + f" ms (CUDA events): {r['tokens_per_s']:.1f} tokens/s, "
        f"{d['flops'] / 1e12:.2f} TFLOP a step (FlopCounterMode on the "
        f"meta device) = {r['tflop_per_s']:.2f} TFLOP/s; peak device "
        f"memory {r['peak_bytes'] / 2**30:.2f} GiB for the 4 positions, "
        f"against the dry run's {d['per_position_B'] / 2**30:.2f} GiB a "
        f"position (arguments {d['argument_B'] / 2**30:.2f}, gradients "
        f"{d['grad_B'] / 2**30:.2f}, saved activations about "
        f"{d['saved_B_estimate'] / 2**30:.2f}), "
        f"{4 * d['per_position_B'] / 2**30:.2f} GiB for 4; {busy}")


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from repro_torch.convert import BLOCK_TABLES
    from repro_torch.core.engines import create
    from repro_torch.core.nfa import compile_queries

    environment()
    dtd, d, qs = workload()
    eng = create("streaming", compile_queries(qs, d, shared=True),
                 dictionary=d, device=dev, max_depth=MAX_DEPTH)
    tables = tuple(eng.plan_[k] for k in BLOCK_TABLES[:7])
    lane_cls = eng._plain_lane_tables(eng.plan_)[0]
    say(f"{int(lane_cls.max()) + 1} accept classes over "
        f"{tuple(lane_cls.shape)} lanes")
    bufs = big_documents(dtd)
    layout = level_layout(bufs, d)
    level_plan = create("wavefront", compile_queries(
        level_profiles(dtd), d, shared=True), dictionary=d, device=dev,
        use_kernel=True).plan_
    say(f"levelwise plan at {LEVEL_PROFILES} profiles: {level_plan.meta}")
    errs = kernels_vs_plain(dtd, tables, lane_cls, dev)
    errs["K6"] = k6_vs_plain(level_plan, layout, dev)
    run = main_path(d, qs, bufs, dev)
    short = sparse_phase(dtd, d, qs, dev)
    t = times(run, short, tables, lane_cls, errs, dev)
    k6 = k6_times(level_plan, layout, errs, dev)
    del level_plan
    levels, level_ref = level_phase(dtd, d, bufs, layout, k6, dev)
    serving = serve_phase(dtd, d, qs, run, short, dev)
    sharded = sharded_phase(dtd, d, qs, bufs, run, short, level_ref, layout,
                            t["K2"][0], dev)
    api = api_phase(dtd, d, qs, bufs, run, short, level_ref, layout, dev)
    mesh = mesh_phase(dtd, d, qs, bufs, run, short, level_ref, serving,
                      sharded, dev)
    lm = lm_phase(dev)
    train = train_phase(dev)
    # the LM substrate on a mesh runs no kernel of the filter: its counts
    # are read around it and must stay 0
    reset_counts()
    mesh_lm = mesh_lm_phase(dev)
    torch.cuda.synchronize()
    mesh_lm["launches"] = counts()
    check(not any(mesh_lm["launches"].values()),
          f"phase 13 launched {mesh_lm['launches']}")
    # the sharded step's ingest launches K5 and K6, its steps none
    sharded_lm = sharded_step_phase(dev)

    s = run["stats"]
    card = card_line()
    say(f"phase 15: end to end on {card}: {len(run['payloads'])} documents, "
        f"{run['n_bytes']} bytes in {run['e2e_s']:.3f} s = "
        f"{len(run['payloads']) / run['e2e_s']:.1f} docs/s, "
        f"{run['n_bytes'] / run['e2e_s'] / 1e6:.1f} MB/s (host clock around "
        f"route_bytes); stage accounting {s['docs_per_s']:.1f} docs/s, "
        f"{s['mb_per_s']:.1f} MB/s; device memory {run['mem']}; "
        f"sparse short messages {short['n_docs'] / short['e2e_s']:.1f} "
        f"docs/s, {short['stats']['device_rows']} device rows, "
        f"{short['stats']['verdict_bytes']} verdict bytes (dense "
        f"{short['dense_verdict_bytes']}); levelwise engines at "
        f"{LEVEL_PROFILES} profiles: " + "; ".join(
            f"{e} {v['requests'] * BATCH / v['e2e_s']:.2f} docs/s"
            for e, v in levels.items())
        + f"; query-sharded ({sharded['parts']} parts, "
        f"{sharded['folded_blocks']} folded blocks): K2 "
        f"{sharded['K2_ms']:.3f} ms a request, subscribe "
        f"{sharded['churn']['subscribe_s']:.3f} s, unsubscribe commit "
        f"{sharded['churn']['unsubscribe_commit_ms']:.3f} ms"
        + f"; plan cache: streaming cold "
        f"{api['cache']['unsharded']['cold_s']:.3f} s / warm "
        f"{api['cache']['unsharded']['warm_s']:.3f} s, sharded cold "
        f"{api['cache'][f'query_shards={SHARD_PARTS}']['cold_s']:.3f} s / "
        f"warm {api['cache'][f'query_shards={SHARD_PARTS}']['warm_s']:.3f} "
        f"s, compile_queries {api['cache']['compile_queries_s']:.3f} s; "
        f"autotune winner blk {api['autotune']['best']['blk']} "
        f"(effective {api['autotune']['best']['blk_eff']}); twigs "
        f"{api['twig']['ms_per_doc']:.3f} ms a message"
        + f"; 2-D mesh ({mesh['positions']} positions): dense 1 MB "
        f"{mesh['request_ms']:.3f} ms a request, pipelined depth 3 "
        f"{mesh['pipelined'][3]['docs_per_s']:.1f} docs/s, serve loop "
        f"{mesh['serve']['docs_per_s']:.1f} docs/s"
        + f"; model serving ({LM_ARCH}, {LM_REPLICAS} replicas): "
        f"{lm['tok_per_s']:.1f} tok/s, prefill {lm['prefill_ms']:.3f} ms, "
        f"decode {lm['decode_ms']:.3f} ms a step (bound "
        f"{lm['decode_bound_ms']:.3f} ms), peak "
        f"{lm['peak_bytes'] / 2**30:.2f} GiB"
        + f"; training ({LM_ARCH}, {TRAIN_BATCH} x {TRAIN_SEQ}): "
        f"{train['steady_step_ms']:.1f} ms a step, "
        f"{train['tokens_per_s']:.1f} tokens/s, "
        f"{train['tflop_per_s']:.2f} TFLOP/s, peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB"
        + f"; LM on a {MESH_LM_DATA} x {MESH_LM_MODEL} grid: elastic "
        f"restore onto it {mesh_lm['elastic']['s']['restore onto 2 x 2']:.2f}"
        f" s, MoE layer ({MOE_ARCH}) stationary "
        f"{mesh_lm['moe']['stationary']['ms']:.2f} ms, shard-map "
        f"{mesh_lm['moe']['shardmap']['ms']:.2f} ms forward + backward"
        + f"; the sharded step on the grid: {LM_ARCH} "
        f"{min(sharded_lm['b']['step_ms']):.1f} ms "
        f"({sharded_lm['b']['tokens_per_s']:.1f} tokens/s), {MOE_ARCH} "
        f"({SHARDED_MOE_LAYERS} layers) "
        f"{min(sharded_lm['c']['shardmap']['step_ms']):.1f} ms"
        + f"; serve loop: sparse pub-sub p50 "
        f"{serving['sparse']['p50_ms']:.3f} / p99 "
        f"{serving['sparse']['p99_ms']:.3f} ms at "
        f"{serving['sparse']['docs_per_s']:.1f} docs/s, dense 1 MB "
        + ", ".join(f"{k} {v['docs_per_s']:.1f} docs/s"
                    for k, v in serving["dense"].items()))
    launches = {**run["launches"], "K3": short["launches"]["K3"],
                "K4": short["launches"]["K4"],
                # K6 on both engines' runs; its times are at a wavefront
                # step's shape, the shape of all but a dozen launches
                "K6": sum(v["launches"]["K6"] for v in levels.values())}
    step = k6["step"]
    t["K6"] = (step["ms"], step["plain_ms"], step["bound_ms"],
               step["bound_by"])
    rows = []
    for key, name, source, replaces in KERNELS:
        ms, plain_ms, bound_ms, bound_by = t[key]
        row = {
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # K6: torch.index_select of the parents' values (the gather);
            # torch.matmul by the one-hot beside it
            "library_ms": step["library_ms"] if key == "K6" else None}
        if key == "K6":
            row["matmul_ms"] = step["matmul_ms"]
        if key in t["chain_events"]:
            row["chain_ns_per_event"] = ms * 1e6 / t["chain_events"][key]
        # phase 8's query-sharded runs: the same kernel over the parts
        # folded into one launch (blocks for K1-K4, K6's state axis)
        row["sharded_launches"] = (sharded["level"]["launches"][key]
                                   if key in ("K5", "K6")
                                   else sharded["launches"][key])
        # phase 9: the plan-cache routes, the autotune search, twigs, the
        # ops wrappers and the serving CLI, each launch counted
        row["api_launches"] = api["launches"][key]
        # phase 10: the 2-D mesh, one launch a position (K3: a model
        # position, on the 1-D mesh= path)
        row["mesh_launches"] = mesh["launches"][key]
        # phase 11: the model-serving path (route, then generate) and
        # the serving CLI's main (whose churn re-routes events: K1)
        row["lm_launches"] = lm["launches"][key]
        row["lm_main_launches"] = lm["main_launches"][key]
        # phase 12: the training path's ingest, (b)'s pipeline and (c)'s
        # two CLI runs (bytes: K5 and K6; events: K6)
        row["train_launches"] = train["pipeline_launches"][key] + sum(
            v[key] for v in train["cli_launches"].values())
        # phase 13: the LM substrate on a mesh (no filter kernel)
        row["lm_mesh_launches"] = mesh_lm["launches"][key]
        # phase 14: the sharded step's byte ingest, (b)'s and (c)'s
        # pipelines (K5, K6; the steps launch no kernel of the table)
        row["lm_sharded_launches"] = sum(
            v[key] for v in sharded_lm["launches"].values())
        row["mesh_positions"] = mesh["positions"]
        if key == "K2":
            row["mesh_position_ms"] = mesh["position_ms"]
        if key in ("K1", "K2", "K3", "K4"):
            row["sharded_blocks"] = sharded["folded_blocks"]
        elif key == "K6":
            row["sharded_states"] = sharded["level"]["folded_states"]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
