"""The control of ``correct``: the reference put in the program's place
with one guarantee broken, read at a cell's own size.  The profile
language holds it (``languages/<kind>.py``'s ``control``): for linear
paths every ``/`` step taken as ``//``; for twigs the root-to-leaf paths
without the join.

    python3 portbench/control.py --workload <name> --seed <n> [--seed <n> ...]

prints, for each seed, how many of the pool's distinct payloads the
control answers differently from the reference (every answer of a window
is one of them), and how many profile ids it delivers in excess.
``correct`` compares with the limit 0, so a seed with any difference
fails the control.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, inputs, languages, spec  # noqa: E402


def reading(workload: str, seed: int) -> dict:
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    config = spec.config(cell["config"])
    inp = inputs.make(config, spec.traffic(cell["traffic"]), seed)
    want, _ = check.expected(inp, config["shards"])
    got, _ = check.expected(inp, config["shards"], languages.get(
        inp.kind).control(inp.profiles, inp.tag_names))
    wrong = [not check.same(g, w) for g, w in zip(got, want)]
    return {"workload": workload, "seed": seed, "pool": len(wrong),
            "mismatched": sum(wrong),
            "extra_ids": sum(sum(len(v) for v in g.values())
                             - sum(len(v) for v in w.values())
                             for g, w in zip(got, want))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args()
    for seed in args.seed:
        t = time.perf_counter()
        r = reading(args.workload, seed)
        print(f"control {r['workload']} seed {r['seed']}: mismatched "
              f"{r['mismatched']} of {r['pool']} distinct payloads, "
              f"{r['extra_ids']} extra profile ids delivered (limit 0; "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
