"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes the cell's inputs from the
seed, builds the program's stage and warms it up (the set-up), measures
for ``--seconds``, frees the program, checks every answer of the window
against the plain reference (``portbench/reference``), and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones, each from
``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit.
The same numbers end standard error.

It needs a CUDA card and never falls back to the CPU: with no card, too
few cards for the cell, or no program beside it (``src/repro_torch``), it
exits non-zero and prints no result.  So it does if the process has
loaded JAX, Flax or the JAX package ``repro`` by the end of the window.
"""
from __future__ import annotations

import time

T0_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, Flax's or the JAX package's (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def measure(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", bench: dict | None = None,
            t0_ns: int = T0_NS) -> tuple[dict, list[str]]:
    """One run of a cell on ``device``: the result object and the lines
    for standard error, the checks last."""
    import numpy as np
    import torch

    from portbench import check, inputs as inputs_mod, languages, roofline
    from portbench import spec, trace as trace_mod

    bench = bench or spec.benchmark()
    cell = spec.cell(bench, workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    inputs = inputs_mod.make(config, traffic, seed)
    spans = trace_mod.Spans()
    tracer = trace_mod.DeviceTrace() if trace else contextlib.nullcontext()
    if trace:
        spans.instrument()
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    try:
        rec = driver.run(inputs, config, traffic, seconds=seconds,
                         spans=spans, trace=tracer, device=device)
    finally:
        spans.uninstrument()
    rec["spans"] = spans
    rec["setup_s"] = (rec["t_open"] - t0_ns) / 1e9
    rec["window_s"] = (rec["t_close"] - rec["t_open"]) / 1e9
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    if trace:
        rec["device"] = trace_mod.summarize(tracer, spans, rec["t_open"],
                                            rec["t_close"])
        dev["busy_s"] = rec["device"]["busy_s"]
        dev["window_s"] = rec["device"]["window_s"]
    del tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want, n_match = check.expected(inputs, config["shards"])
    mismatched = sum(
        1 for i, routed in rec["answers"]
        if routed is not None and not check.same(check.answer_of(routed),
                                                 want[i]))
    ref_s = time.perf_counter() - t_ref

    dense = config["delivery"] == "dense"
    work_of = languages.get(inputs.kind).work_counter(inputs.profiles,
                                                      inputs.tag_names)
    work = np.array([work_of(p, matches=m, dense=dense)
                     for p, m in zip(inputs.payloads, n_match)], np.float64)
    counts = rec["done_counts"]
    rec["docs"] = int(counts.sum())
    rec["bytes"] = int(counts @ inputs.pool_bytes)
    rec["work_ops"], rec["work_bytes"] = (counts @ work).tolist()

    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = check.verdict(mismatched, rec["unanswered"])
    result = {"correct": ok, "attempted": rec["attempted"],
              "failed": mismatched + rec["unanswered"] + rec.get("shed", 0),
              "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = trace_mod.breakdown(rec["device"])
    result["checks"] = checks

    lines = [f"cell {workload} seed {seed} trace {int(trace)} on "
             f"{dev['kind']}: set-up {rec['setup_s']:.3f} s, window "
             f"{rec['window_s']:.3f} s, {rec['docs']} documents "
             f"({rec['bytes']} bytes) done in it, {rec['attempted']} "
             f"answers checked against the reference in {ref_s:.2f} s"]
    if "latency_s" in rec and rec["latency_s"].size:
        lat = rec["latency_s"] * 1e3
        lines.append(f"serve latency from submission: p50 "
                     f"{np.percentile(lat, 50):.3f} ms, p99 "
                     f"{np.percentile(lat, 99):.3f} ms over {lat.size} "
                     f"requests (recorded, not judged)")
    if "loop_after" in rec:
        d = {k: rec["loop_after"][k] - rec["loop_before"][k]
             for k in ("batches", "size_closes", "deadline_closes",
                       "backpressure_waits", "completed")}
        lines.append(f"serve loop counters in the window: {d}")
    lines.append(f"stage paths: {rec['stage_stats'].get('paths')}")
    if trace:
        top = sorted(rec["device"]["kernels"].items(), key=lambda kv: -kv[1])
        lines.append("device time by event name: " + "; ".join(
            f"{n or '(unnamed)'}: {s:.6f} s" for n, s in top[:8]))
    if trace and cuda:
        lines.append(f"peaks: {roofline.PEAK_OPS_PER_S:.3g} op/s, "
                     f"{roofline.PEAK_BYTES_PER_S:.3g} B/s; card and power "
                     f"limit: {power_limit()}")
    lines += [f"check {k} {v['value']} limit {v['limit']}"
              for k, v in checks.items()]
    return result, lines


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program to measure: {ROOT / 'src' / 'repro_torch'} is "
              f"missing", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import spec

    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, lines = measure(args.workload, args.seed, args.seconds,
                            bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
