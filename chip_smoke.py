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
9. the end-to-end line, one ``{"kernels": [...]}`` line, the card line,
   and the result line.
"""
from __future__ import annotations

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

    s = run["stats"]
    card = card_line()
    say(f"phase 9: end to end on {card}: {len(run['payloads'])} documents, "
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
