#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: build, check, drive, time.

Run from the repository root, on a machine with one CUDA card (an H100:
the kernels are built for ``sm_90a``) and the CUDA toolkit::

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX.  Phases, each
printed as it runs; any failure exits non-zero:

1. environment: the card's name and power limit, ``nvcc --version``, and
   the kernels' build from ``src/repro_torch/kernels/csrc`` with its
   ``-Xptxas -v`` report;
2. every kernel against its plain PyTorch version on the card, at the
   full-width plan (10,000 profiles, 11 state blocks of 64 words) on short
   documents: K1 on an event batch, K2 on unpacked and on packed segments
   with empty slots; outputs are 0/1 lanes and int32 ordinals, so the
   tolerance is exact equality;
3. the main path at full width: ``FilterStage(engine="streaming",
   batch_size=16).route_bytes`` over 4 requests of 16 documents of about
   1 MB (K2), then ``FilterStage.route`` over the same documents decoded
   on the host (K1).  Each run starts with the launch counts at 0 and
   must launch its kernel; the two routings, the packed route and the
   engine-level first-match ordinals must agree;
4. times: each kernel (CUDA events, after a warm-up) and its plain
   version at the main path's shapes, where their outputs must be equal
   too; the least time the card could take for the same work; docs/s
   and MB/s end to end; device memory;
5. one ``{"kernels": [...]}`` line, the card line, and the result line.
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
# §4 workload at the README's profile scale)
N_TAGS, FANOUT = 128, 4
N_PROFILES, PATH_LENGTH, P_DESC, P_WILD = 10_000, 6, 0.3, 0.1
MAX_DEPTH = 64
DOC_NODES, DOC_DEPTH, TEXT_FILL = 60_000, 12, 8
BATCH, REQUESTS, DISTINCT_DOCS = 16, 4, 16
SHORT_DOC_NODES = (60, 150, 300, 470)      # 1-8 KB documents for phase 2

# card peaks (H100 SXM data sheet): HBM bytes/s, and the 32-bit
# non-tensor rate, which bounds the kernels' integer bit operations
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# operation counts of the least work the two kernels' function needs:
# per OPEN event, per state block, per packed word: 4 per parent bit the
# tag can match (load, shift, mask, place) + 4 (tag mask, self-loop, or,
# accept test); per CLOSE event and block: 1 (the pop); per byte: 12 to
# classify it (compare '<' and '/', two symbol lookups, select), once
OPS_PER_SOURCE_BIT, OPS_PER_WORD, OPS_PER_CLOSE, OPS_PER_BYTE = 4, 4, 1, 12

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


# ----------------------------------------------------------------- phase 1
def environment():
    from repro_torch.kernels import build

    say("phase 1: environment")
    print(card_line(), flush=True)
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print(nvcc.stdout.strip(), flush=True)
    t = time.perf_counter()
    build.load()
    say(f"built {build.library_path()} in {time.perf_counter() - t:.1f} s "
        f"from {[os.path.relpath(s, ROOT) for s in build.SOURCES]} with "
        f"nvcc {' '.join(build.FLAGS)}")
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


def kernels_vs_plain(dtd, tables, dev) -> dict:
    """Phase 2: each kernel against its plain version, on the card."""
    from repro_torch.core.events import (SEG_SENTINEL, ByteBatch,
                                         EventBatch, encode_bytes,
                                         pack_segments)
    from repro_torch.data.generator import gen_document
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

    bb = ByteBatch.from_buffers(bufs, bucket=1024)
    one = np.full((bb.batch_size, 2), SEG_SENTINEL, np.int32)
    one[:, 0] = 0
    sp = pack_segments(bb, target_len=4096)
    check(bool((sp.doc_ids < 0).any()), "packed batch has no empty slot")
    for label, data, starts in (("unpacked", bb.data, one),
                                ("packed", sp.data, sp.starts)):
        data = torch.from_numpy(data).to(dev)
        starts = torch.from_numpy(starts).to(dev)
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
    return errs


# ----------------------------------------------------------------- phase 3
def routed(batches) -> list:
    return [(r.doc_index, r.shard, tuple(r.matched_profiles.tolist()))
            for batch in batches for r in batch]


def main_path(dtd, d, qs, dev):
    """Phase 3: the port's main path at full width, K2 then K1."""
    from repro_torch.core.events import (ByteBatch, EventBatch,
                                         decode_bytes, encode_bytes)
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.data.generator import gen_document
    from repro_torch.kernels import stream_filter as sf

    say(f"phase 3: main path, {REQUESTS} requests x {BATCH} documents")
    t = time.perf_counter()
    bufs = [encode_bytes(gen_document(dtd, target_nodes=DOC_NODES,
                                      max_depth=DOC_DEPTH, seed=i),
                         text_fill=TEXT_FILL) for i in range(DISTINCT_DOCS)]
    # each request takes the distinct documents in another order
    payloads = [bufs[(i + 3 * r) % DISTINCT_DOCS]
                for r in range(REQUESTS) for i in range(BATCH)]
    n_bytes = sum(map(len, payloads))
    say(f"{DISTINCT_DOCS} distinct documents of {min(map(len, bufs))}-"
        f"{max(map(len, bufs))} bytes in {time.perf_counter() - t:.1f} s; "
        f"{len(payloads)} payloads, {n_bytes} bytes")

    t = time.perf_counter()
    stage = FilterStage(profiles=qs, dictionary=d, engine="streaming",
                        batch_size=BATCH, device=str(dev))
    meta = stage._eng.plan_.meta
    say(f"plan in {time.perf_counter() - t:.1f} s: {meta}")
    list(stage.route_bytes(payloads[:BATCH]))          # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stage.stats.update(batches=0, docs=0, bytes=0, seconds=0.0,
                       pair_matches=0, pairs=0)

    sf.stream_filter.launches = sf.stream_filter_bytes.launches = 0
    t = time.perf_counter()
    by_bytes = list(stage.route_bytes(payloads))
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t
    launches = {"K2": sf.stream_filter_bytes.launches,
                "K1_during_K2": sf.stream_filter.launches}
    say(f"route_bytes: launches K2 = {launches['K2']}, K1 = "
        f"{launches['K1_during_K2']}")
    check(launches["K2"] > 0, "the bytes route launched no K2 kernel")
    stats = stage.throughput()
    mem = {"max_allocated_bytes": torch.cuda.max_memory_allocated(),
           "allocated_bytes": torch.cuda.memory_allocated()}

    sym = d.symbol_value_table()
    streams = [decode_bytes(b, sym) for b in payloads]
    sf.stream_filter.launches = sf.stream_filter_bytes.launches = 0
    by_events = list(stage.route(streams))
    torch.cuda.synchronize()
    launches["K1"] = sf.stream_filter.launches
    launches["K2_during_K1"] = sf.stream_filter_bytes.launches
    say(f"route (host-decoded events): launches K1 = {launches['K1']}, "
        f"K2 = {launches['K2_during_K1']}")
    check(launches["K1"] > 0, "the event route launched no K1 kernel")

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
    return dict(stage=stage, payloads=payloads, streams=streams,
                e2e_s=e2e_s, n_bytes=n_bytes, launches=launches,
                stats=stats, mem=mem)


# ----------------------------------------------------------------- phase 4
def work_counts(tables, kind: np.ndarray, tag: np.ndarray) -> int:
    """Operations the function needs on these events (see OPS_*)."""
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


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def times(run, tables, errs, dev) -> dict:
    """Phase 4: kernel and plain-version times at the main path's shapes;
    the plain versions' outputs update ``errs``."""
    from repro_torch.core.events import SEG_SENTINEL, ByteBatch, EventBatch
    from repro_torch.kernels import stream_filter as sf

    stage = run["stage"]
    say("phase 4: times at one request's shapes")
    bb = ByteBatch.from_buffers(run["payloads"][:BATCH],
                                bucket=stage.byte_bucket)
    data = torch.from_numpy(bb.data).to(dev)
    one = np.full((BATCH, 2), SEG_SENTINEL, np.int32)
    one[:, 0] = 0
    starts = torch.from_numpy(one).to(dev)
    batch = EventBatch.from_streams(run["streams"][:BATCH],
                                    bucket=stage.bucket)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id)).to(dev)
    table_bytes = sum(x.numel() * 4 for x in tables)
    g, qb = tables[5].shape
    ops1 = work_counts(tables, batch.kind, batch.tag_id)
    out = {}

    k2, k2_out = time_ms(lambda: sf.stream_filter_bytes(
        data, starts, *tables, max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"K2 kernel, data {tuple(data.shape)}: {k2:.3f} ms")
    k1, k1_out = time_ms(lambda: sf.stream_filter(
        events, *tables, max_depth=MAX_DEPTH), warmup=1, reps=5)
    say(f"K1 kernel, events {tuple(events.shape)}: {k1:.3f} ms")
    # the plain versions once each, on the same inputs: a time, and the
    # kernels' check at the main path's shapes
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

    b2 = (data.numel() + starts.numel() * 4 + table_bytes
          + 2 * BATCH * g * qb * 4)
    out["K2"] = (k2, p2) + bound(b2, ops1 + OPS_PER_BYTE * data.numel())
    b1 = events.numel() * 4 + table_bytes + 2 * BATCH * g * qb * 4
    out["K1"] = (k1, p1) + bound(b1, ops1)
    n_events = int(batch.n_events.sum())
    for name in ("K2", "K1"):
        ms, _, bms, by = out[name]
        say(f"{name}: {ms:.3f} ms against a bound of {bms:.4f} ms "
            f"({by}); {n_events / ms / 1e3:.1f} M events/s, "
            f"{bb.nbytes_total() / ms / 1e6:.3f} GB/s of payload")
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
    errs = kernels_vs_plain(dtd, tables, dev)
    run = main_path(dtd, d, qs, dev)
    t = times(run, tables, errs, dev)

    s = run["stats"]
    card = card_line()
    say(f"phase 5: end to end on {card}: {len(run['payloads'])} documents, "
        f"{run['n_bytes']} bytes in {run['e2e_s']:.3f} s = "
        f"{len(run['payloads']) / run['e2e_s']:.1f} docs/s, "
        f"{run['n_bytes'] / run['e2e_s'] / 1e6:.1f} MB/s (host clock around "
        f"route_bytes); stage accounting {s['docs_per_s']:.1f} docs/s, "
        f"{s['mb_per_s']:.1f} MB/s; device memory {run['mem']}")
    source = "src/repro_torch/kernels/csrc/stream_filter.cu"
    rows = []
    for name, fn, line in (
            ("K2 stream_filter_bytes", "stream_filter_bytes_pallas", 667),
            ("K1 stream_filter", "stream_filter_pallas", 311)):
        key = name[:2]
        ms, plain_ms, bound_ms, bound_by = t[key]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"src/repro/kernels/stream_filter.py:{line} ({fn})",
            "launches": run["launches"][key],
            "max_abs_err": errs[key], "max_abs_diff": errs[key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
