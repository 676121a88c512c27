"""Measured launch-shape autotune of the port: timed search + config cache.

Counterpart of ``src/repro/kernels/autotune.py``.
:meth:`repro_torch.core.engines.base.FilterEngine.autotune_blocks` picks
the streaming plan's launch shape from a static budget formula; this
module measures instead:

* :func:`search` runs the real bytes path of the streaming engine
  (``filter_bytes(pack=True)`` then ``filter_bytes_sparse(pack=True)``,
  K2 and K3 on the card) over a representative batch for every candidate
  ``(blk, byte_chunk, grid_order, segment_target, ep_tile)``, best of
  ``trials`` each, and returns the fastest.  On the card ``chunk``,
  ``byte_chunk`` and ``grid_order`` are read by no kernel, and a ``blk``
  below the plan's least parent-closed block grows to it, so candidates
  often fall together: each distinct effective launch shape (block size
  and count, segment target, epilogue tile) is timed once, and every row
  names the effective ``blk`` and ``G`` and the candidate it fell in with.
* a small JSON cache keyed by plan shape (:func:`plan_key`: device ×
  padded states × tags × depth × word multiple) at :func:`cache_path`
  (``$REPRO_TORCH_AUTOTUNE_CACHE``, default
  ``~/.cache/repro_torch/autotune.json``), the port's own file: engines
  built with ``autotune="measured"`` overlay the cached winner when they
  plan (:meth:`repro_torch.core.engines.streaming.StreamingEngine.
  kernel_config`).  The key names the card (``cuda:<name>``) or ``cpu``,
  so a winner measured on one card is never read on another, nor by the
  JAX package.

Only a layout refusal raised while a candidate's plan is built, before
any launch (a ``ValueError`` of ``state_layout`` or
``check_block_tables``), skips a candidate; an error raised by a launch
propagates, so a kernel fault is never reported as a skipped candidate.

CLI::

    python -m repro_torch.kernels.autotune --queries 64 --trials 2
    python -m repro_torch.kernels.autotune --device cpu --trials 1

writes the cache and prints every candidate's row as JSON.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time
from typing import Any, Mapping, Sequence

import torch

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = "~/.cache/repro_torch/autotune.json"

#: part of every :func:`plan_key`: bumped whenever the cached config's
#: schema changes, so old entries miss cleanly
KEY_VERSION = 1

#: candidate grids; the block sizes around the static policy's choice on
#: a large plan, one value of each knob no CUDA kernel reads
DEFAULT_BLKS = (256, 512, 1024, 2048)
DEFAULT_BYTE_CHUNKS = (512,)
DEFAULT_GRID_ORDERS = ("bg",)
DEFAULT_SEGMENT_TARGETS = (2048, 4096)
DEFAULT_EP_TILES = (8,)

#: the config a cache entry holds
CONFIG_KEYS = ("blk", "byte_chunk", "grid_order", "segment_target",
               "ep_tile")


# ------------------------------------------------------------------- cache
def cache_path(path: str | None = None) -> str:
    """The cache file: the argument, else the environment, else the
    default."""
    return os.path.expanduser(
        path or os.environ.get(CACHE_ENV) or DEFAULT_CACHE)


def backend(device: str | torch.device) -> str:
    """The device part of a cache key: ``cuda:<card name>`` or ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def plan_key(backend: str, n_states: int, n_tags: int, max_depth: int,
             state_multiple: int) -> str:
    """Cache key: everything the launch shape may depend on and nothing it
    must not (batch contents, query text), prefixed by the port's
    :data:`KEY_VERSION`."""
    return (f"torch-v{KEY_VERSION}:{backend}:s{int(n_states)}"
            f":t{int(n_tags)}:d{int(max_depth)}:w{int(state_multiple)}")


def load_cache(path: str | None = None) -> dict[str, Any]:
    """The cache's entries (``{}`` for a missing or unreadable file)."""
    try:
        with open(cache_path(path)) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    entries = data.get("entries") if isinstance(data, dict) else None
    return entries if isinstance(entries, dict) else {}


def save_cache(entries: Mapping[str, Any], path: str | None = None) -> str:
    """Write the cache atomically (a temporary file, then a rename)."""
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump({"version": 1, "entries": dict(entries)}, fh,
                      indent=2, sort_keys=True)
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return p


def cached_config(key: str, path: str | None = None) -> dict | None:
    """The winner cached under ``key``, or ``None``: what
    ``autotune="measured"`` engines overlay."""
    entry = load_cache(path).get(key)
    if isinstance(entry, dict) and isinstance(entry.get("config"), dict):
        return dict(entry["config"])
    return None


# ------------------------------------------------------------------ search
def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_engine(eng, bb, trials: int) -> float:
    """Best of ``trials`` seconds for one packed ``filter_bytes`` call and
    one packed ``filter_bytes_sparse`` call (the fused epilogue, where
    ``ep_tile`` counts), the card synchronised before the clock starts
    and before it stops; the first, untimed calls pay any build."""
    eng.filter_bytes(bb, pack=True)
    eng.filter_bytes_sparse(bb, pack=True)
    best = float("inf")
    for _ in range(max(1, trials)):
        _synchronize(eng.device)
        t0 = time.perf_counter()
        eng.filter_bytes(bb, pack=True)
        eng.filter_bytes_sparse(bb, pack=True)
        _synchronize(eng.device)
        best = min(best, time.perf_counter() - t0)
    return best


def search(nfa, dictionary, bb, *, max_depth: int | None = None,
           blks: Sequence[int] = DEFAULT_BLKS,
           byte_chunks: Sequence[int] = DEFAULT_BYTE_CHUNKS,
           grid_orders: Sequence[str] = DEFAULT_GRID_ORDERS,
           segment_targets: Sequence[int] = DEFAULT_SEGMENT_TARGETS,
           ep_tiles: Sequence[int] = DEFAULT_EP_TILES,
           trials: int = 3, device: str | torch.device = "cuda",
           cache: bool = True, cache_file: str | None = None
           ) -> tuple[dict, list[dict]]:
    """Measured search over the streaming plan's launch shape.

    ``nfa`` is the port's compiled NFA, ``bb`` a :class:`~repro_torch.
    core.events.ByteBatch`.  Returns ``(best, rows)``: one row per
    candidate with its config, the effective ``blk_eff`` and
    ``n_blocks``, and its ``seconds`` (with ``same_as``, the index of the
    timed row it fell in with, when it was not timed itself) or its
    ``skipped`` reason.  With ``cache=True`` the winner's config is
    written under this plan shape's :func:`plan_key`.
    """
    from ..core import engines
    from ..core.engines.base import _round_up
    from ..core.events import DEFAULT_MAX_DEPTH

    if max_depth is None:
        max_depth = DEFAULT_MAX_DEPTH
    device = torch.device(device)
    rows: list[dict] = []
    timed: dict[tuple, int] = {}
    best: dict | None = None
    for blk, bc, go, st, ep in itertools.product(
            blks, byte_chunks, grid_orders, segment_targets, ep_tiles):
        cfg = {"blk": int(blk), "byte_chunk": int(bc),
               "grid_order": str(go), "segment_target": int(st),
               "ep_tile": int(ep)}
        try:
            eng = engines.create("streaming", nfa, dictionary=dictionary,
                                 device=device, max_depth=max_depth,
                                 pack=True, **cfg)
        except ValueError as e:      # a layout refusal: nothing launched
            rows.append({**cfg, "skipped": f"{type(e).__name__}: {e}"})
            continue
        meta = eng.plan_.meta
        row = {**cfg, "blk_eff": int(meta["blk"]),
               "n_blocks": int(meta["n_blocks"])}
        effective = (row["blk_eff"], row["n_blocks"],
                     int(meta["segment_target"]), int(meta["ep_tile"]))
        if effective in timed:
            first = rows[timed[effective]]
            row.update(seconds=first["seconds"], same_as=timed[effective])
            rows.append(row)
            continue
        row["seconds"] = _time_engine(eng, bb, trials)
        timed[effective] = len(rows)
        rows.append(row)
        if best is None or row["seconds"] < best["seconds"]:
            best = row
        del eng
    if best is None:
        raise RuntimeError("autotune: no feasible candidate "
                           f"(tried {len(rows)}; see rows for reasons)")
    if cache:
        key = plan_key(backend(device), _round_up(nfa.n_states, 32),
                       nfa.n_tags, max_depth, 32)
        entries = load_cache(cache_file)
        entries[key] = {"config": {k: best[k] for k in CONFIG_KEYS},
                        "seconds": best["seconds"], "trials": int(trials),
                        "timestamp": time.time()}
        save_cache(entries, cache_file)
    return best, rows


# --------------------------------------------------------------------- CLI
def _int_list(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x.strip())


def main(argv: Sequence[str] | None = None) -> int:
    from ..core.dictionary import TagDictionary
    from ..core.events import ByteBatch
    from ..core.nfa import compile_queries
    from ..data.generator import DTD, gen_corpus, gen_profiles

    ap = argparse.ArgumentParser(
        description="measured launch-shape search of the port's streaming "
                    "engine (K2 and K3 on the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--n-tags", type=int, default=24)
    ap.add_argument("--docs", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=60)
    ap.add_argument("--text-fill", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--blks", type=_int_list, default=DEFAULT_BLKS)
    ap.add_argument("--byte-chunks", type=_int_list,
                    default=DEFAULT_BYTE_CHUNKS)
    ap.add_argument("--grid-orders",
                    type=lambda s: tuple(x for x in s.split(",") if x),
                    default=DEFAULT_GRID_ORDERS)
    ap.add_argument("--segment-targets", type=_int_list,
                    default=DEFAULT_SEGMENT_TARGETS)
    ap.add_argument("--ep-tiles", type=_int_list, default=DEFAULT_EP_TILES)
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default ${CACHE_ENV} or "
                         f"{DEFAULT_CACHE})")
    args = ap.parse_args(argv)

    dtd = DTD.generate(n_tags=args.n_tags, seed=args.seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=args.queries, length=4, p_wild=0.1,
                      p_desc=0.3, seed=args.seed)
    nfa = compile_queries(qs, d, shared=True)
    # skewed lengths on purpose: packing quality is part of what the
    # segment_target dimension is tuned against
    docs = (gen_corpus(dtd, n_docs=max(1, args.docs // 4),
                       nodes_per_doc=args.nodes, seed=args.seed)
            + gen_corpus(dtd, n_docs=args.docs - max(1, args.docs // 4),
                         nodes_per_doc=max(2, args.nodes // 8),
                         seed=args.seed + 1))
    bb = ByteBatch.from_streams(docs, text_fill=args.text_fill, bucket=256)
    best, rows = search(
        nfa, d, bb, blks=args.blks, byte_chunks=args.byte_chunks,
        grid_orders=args.grid_orders, segment_targets=args.segment_targets,
        ep_tiles=args.ep_tiles, trials=args.trials, device=args.device,
        cache_file=args.cache)
    print(json.dumps({"best": best, "rows": rows,
                      "cache": cache_path(args.cache)}, indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
