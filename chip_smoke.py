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
   shape and at the widest level's shape of the first 1 MB request.
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
5. times: each kernel (CUDA events, after a warm-up) and its plain
   version at the shapes its main path gives it, where their outputs must
   be equal too; the least time the card could take for the same work;
   for K6 also ``torch.matmul`` of the same product in full float32, a
   yardstick the port never calls; docs/s and MB/s end to end; device
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
7. one ``{"kernels": [...]}`` line, the card line, and the result line.
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

# card peaks (H100 SXM data sheet): HBM bytes/s, the 32-bit non-tensor
# rate, which bounds the kernels' integer bit operations and K6's float32
# FFMA, and the dense bf16 tensor-core rate (K6's redesign target)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
# operation counts of the least work the kernels' functions need: per
# OPEN event, per state block, per packed word: 4 per parent bit the tag
# can match (load, shift, mask, place) + 4 (tag mask, self-loop, or,
# accept test); per CLOSE event and block: 1 (the pop); per byte: 12 to
# classify it (compare '<' and '/', two symbol lookups, select), once;
# per lane of each emitted (document, block): 2 (the hit test, its rank)
OPS_PER_SOURCE_BIT, OPS_PER_WORD, OPS_PER_CLOSE, OPS_PER_BYTE = 4, 4, 1, 12
OPS_PER_EMITTED_LANE = 2
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
    [-1, T+2) (pads and tags past the tag space), and the plan's tables."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t, s = plan["req"].shape
    parent = torch.empty((rows, s), dtype=torch.float32,
                         device=dev).bernoulli_(0.02, generator=g)
    tags = torch.randint(-1, t + 2, (rows,), generator=g, device=dev,
                         dtype=torch.int32)
    return (parent, tags, plan["req"], plan["wild"], plan["parent_1h"],
            plan["selfloop"])


def k6_vs_plain(level_plan, layout, dev) -> float:
    """Phase 2, K6: the kernel against its plain version at a wavefront
    step's shape and at the widest level's, on the card."""
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import ref

    err = 0.0
    for label, rows in (("wavefront step", layout["step_rows"]),
                        ("widest level", layout["level_rows"])):
        args = k6_inputs(level_plan, rows, rows, dev)
        k = nt.nfa_transition(*args)
        p = ref.nfa_transition(*args)
        torch.cuda.synchronize()
        check(bool(p.any()) and not bool(p.all()),
              f"K6 plain version at the {label} is constant")
        e = float((k - p).abs().max())
        say(f"K6 {label} ({rows}, {args[0].shape[1]}): max |kernel - plain| "
            f"= {e}")
        check(e == 0, f"K6 disagrees with its plain version at the {label}")
        err = max(err, e)
        del args, k, p
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
                stats=stats, mem=mem, parse_mem=parse_mem)


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
               "stats": s, "dense_verdict_bytes":
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
            f"{bb.nbytes_total() / ms / 1e6:.3f} GB/s of payload")

    # K5 where its main path runs it: the 1 MB request's parse
    k5, k5_out = time_ms(lambda: pd.predecode(data), warmup=1, reps=5)
    p5, p5_out = time_ms(lambda: ref.predecode(data), warmup=1, reps=5)
    errs["K5"] = max(errs["K5"], max_abs_err(k5_out, p5_out))
    check(errs["K5"] == 0, "K5 disagrees with its plain version at 1 MB")
    out["K5"] = (k5, p5) + bound(9 * data.numel(), OPS_PER_BYTE * data.numel())
    say(f"K5 kernel, bytes {tuple(data.shape)}: {k5:.4f} ms, plain "
        f"{p5:.3f} ms; bound {out['K5'][2]:.4f} ms ({out['K5'][3]}); "
        f"{data.numel() / k5 / 1e6:.1f} GB/s of bytes")

    # K3/K4 where their main path runs them: a request of short messages
    sbb, sdata, sstarts, srows, sbatch, sevents = request_inputs(
        short["payloads"], short["streams"], stage, dev)
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
            f"{ms:.3f} ms, plain {pms:.1f} ms; bound {bms:.4f} ms ({by})")
    out["big"] = {"K3": k3_big, "K4": k4_big}
    return out


def k6_times(level_plan, layout, errs, dev) -> dict:
    """Phase 5, K6: kernel, plain version and ``torch.matmul`` of its
    product (full float32, TF32 off; the port never calls it) at a
    wavefront step's shape and at the widest level's."""
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import ref

    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is on")
    say("K6 times; torch.backends.cuda.matmul.allow_tf32 = False, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
    out = {}
    for key, rows, reps in (("step", layout["step_rows"], 20),
                            ("level", layout["level_rows"], 3)):
        args = k6_inputs(level_plan, rows, rows + 1, dev)
        ms, k_out = time_ms(lambda: nt.nfa_transition(*args), warmup=1,
                            reps=reps)
        plain_ms, p_out = time_ms(lambda: ref.nfa_transition(*args),
                                  warmup=1, reps=max(1, reps // 3))
        lib_ms, _ = time_ms(lambda: torch.matmul(args[0], args[4]),
                            warmup=1, reps=reps)
        errs["K6"] = max(errs["K6"], float((k_out - p_out).abs().max()))
        check(errs["K6"] == 0, f"K6 disagrees with its plain version at "
                               f"{tuple(args[0].shape)}")
        w, s = args[0].shape
        t = args[2].shape[0]
        flop = 2 * w * s * s
        # parent rows, one-hot, req, wild, selfloop and tags read, out written
        n_bytes = 4 * (2 * w * s + s * s + t * s + 2 * s + w)
        bound_ms, bound_by = bound(n_bytes, flop, FP32_FLOP_PER_S)
        out[key] = {"rows": w, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "bf16_bound_ms": flop / BF16_TENSOR_FLOP_PER_S * 1e3}
        say(f"K6 kernel ({w}, {s}) @ ({s}, {s}): {ms:.3f} ms = "
            f"{flop / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; "
            f"torch.matmul {lib_ms:.3f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}, float32 non-tensor), bf16 tensor-core line "
            f"{out[key]['bf16_bound_ms']:.4f} ms; max |kernel - plain| = 0")
        del args, k_out, p_out
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 6
def level_phase(dtd, d, bufs, layout, k6, dev) -> dict:
    """Phase 6: the levelwise engines at 1,024 profiles on 1 MB documents,
    each routing held against the streaming stage's at the same plan."""
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
    levels = level_phase(dtd, d, bufs, layout, k6, dev)

    s = run["stats"]
    card = card_line()
    say(f"phase 7: end to end on {card}: {len(run['payloads'])} documents, "
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
            for e, v in levels.items()))
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
        rows.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": step["library_ms"] if key == "K6" else None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
