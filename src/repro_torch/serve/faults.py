"""Seeded fault injection for the port's serve loop — the chaos harness.

Counterpart of ``src/repro/serve/faults.py`` over
:class:`repro_torch.serve.ServeLoop`, on the card unless the caller asks
for the CPU.  Reproducible failure drills for every containment path the
loop claims (:mod:`repro_torch.serve.loop`): a :class:`FaultPlan` names
*which* request indices are poisoned and *which* batches/ops misbehave,
a :class:`FaultInjector` wires the non-document faults into a
:class:`~repro_torch.data.filter_stage.FilterStage` (wrapping its batch
entry point and its engine's ``plan_part``), and :func:`run_chaos_trace`
drives a full arrival trace through the loop with the faults active and
checks the loop's promises afterwards:

* the loop *finishes* (no wedge, no thread death);
* accounting closes: ``arrived == completed + shed + failed +
  quarantined``;
* the dead-letter buffer lists exactly the injected poison documents,
  each with a typed error;
* every healthy document's verdict is bit-identical to a fault-free
  reference run (quarantine never corrupts co-batched requests);
* an injected one-shot worker fault is absorbed by the whole-batch
  retry (no quarantine);
* a forced :class:`~repro_torch.kernels.blocks.PadOverflow` during a live
  subscribe exercises the full-replan path inside a shadow swap.

Fault taxonomy (each exercises a different containment layer):

``malformed`` / ``overdepth``
    byte-level poison caught by pre-admission validation
    (:func:`~repro_torch.core.events.validate_payload`) — rejected at
    ``submit()``, never reaches a kernel.
``kernel``
    payload that *passes* validation but makes the device call raise an
    untyped error — isolated by retry + bisection, quarantined as
    :class:`~repro_torch.core.events.KernelFault`.
``worker_fault_batches``
    one-shot transient worker exceptions — absorbed by the retry.
``slow_batches``
    injected service-time spikes (p99 visibility, no failure).
``pad_overflow_adds``
    forced ``PadOverflow`` on the next ``plan_part`` call of the n-th
    live subscribe — the shadow build takes the merge-pads full-replan
    path and still commits.

Run as a module for the chaos report (``--device cpu`` off the card)::

    python -m repro_torch.serve.faults --requests 48 --out chaos.json
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..core.dictionary import TagDictionary
from ..core.events import encode_bytes
from ..data.filter_stage import TEXT_FILL, FilterStage
from ..data.generator import DTD, gen_corpus, gen_profiles
from .loop import ServeLoop, make_arrivals


@dataclass(frozen=True)
class FaultPlan:
    """What to break, where — fully determined by its fields (seeded
    workload + fixed indices = reproducible chaos)."""

    #: request indices replaced by an unbalanced payload (pre-admission)
    malformed: tuple[int, ...] = ()
    #: request indices replaced by an over-depth payload (pre-admission)
    overdepth: tuple[int, ...] = ()
    #: request indices whose payload poisons the device call (bisection)
    kernel: tuple[int, ...] = ()
    #: 1-based batch-call ordinals that raise once then succeed on retry
    worker_fault_batches: tuple[int, ...] = ()
    #: 1-based batch-call ordinals delayed by ``slow_ms``
    slow_batches: tuple[int, ...] = ()
    slow_ms: float = 25.0
    #: 1-based live-subscribe ordinals whose first ``plan_part`` call
    #: raises ``PadOverflow`` (forcing the full-replan path)
    pad_overflow_adds: tuple[int, ...] = ()

    def poison_indices(self) -> tuple[int, ...]:
        return tuple(sorted({*self.malformed, *self.overdepth,
                             *self.kernel}))


#: the default CI drill: every fault class at least once.  The armed
#: pad overflow is the SECOND add — the first add naturally repads to
#: the next query bucket, so the second takes the fits-old-pads fast
#: path, which is the injection's (guarded) call site.
DEFAULT_PLAN = FaultPlan(malformed=(3,), overdepth=(11,), kernel=(17,),
                         worker_fault_batches=(2,), slow_batches=(4,),
                         pad_overflow_adds=(2,))


class FaultInjector:
    """Install a :class:`FaultPlan`'s non-document faults on a stage.

    Wraps ``stage._filter_bytebatch`` (worker faults, slow batches,
    kernel-poison payload detection) and the engine's ``plan_part``
    (armed ``PadOverflow``).  Document-level poisons are substitutions
    in the payload list — see :func:`poison_payloads` — not wrappers.
    """

    def __init__(self, stage: FilterStage, plan: FaultPlan,
                 kernel_payloads: set[bytes]) -> None:
        self.stage = stage
        self.plan = plan
        self.kernel_payloads = kernel_payloads
        self.batch_calls = 0
        self.worker_faults_left = set(plan.worker_fault_batches)
        self.slow_left = set(plan.slow_batches)
        self.pad_overflow_armed = 0
        self.pad_overflows_forced = 0
        self._orig_filter = stage._filter_bytebatch
        self._orig_plan_part = stage._eng.plan_part
        stage._filter_bytebatch = self._filter          # type: ignore
        stage._eng.plan_part = self._plan_part          # type: ignore

    def _filter(self, bufs, record: bool = True, epoch=None):
        self.batch_calls += 1
        n = self.batch_calls
        if n in self.worker_faults_left:
            self.worker_faults_left.discard(n)
            raise RuntimeError(f"injected one-shot worker fault "
                               f"(batch call {n})")
        if any(b in self.kernel_payloads for b in bufs):
            # untyped on purpose: the loop must *bisect* to find it
            raise RuntimeError("injected kernel fault (poison document)")
        if n in self.slow_left:
            self.slow_left.discard(n)
            time.sleep(self.plan.slow_ms / 1e3)
        return self._orig_filter(bufs, record=record, epoch=epoch)

    def _plan_part(self, nfa, pads=None):
        if self.pad_overflow_armed > 0 and pads is not None:
            # fire only at the guarded fits-old-pads attempt (its pads
            # argument is the live plan's own pad dict) — a raise inside
            # the merge-pads full replan would be a *new* failure mode,
            # not the overflow-at-old-buckets one this drills
            live = getattr(self.stage, "sharded_", None)
            if live is not None and dict(pads) == dict(live.pads):
                self.pad_overflow_armed -= 1
                self.pad_overflows_forced += 1
                from ..kernels.blocks import PadOverflow
                raise PadOverflow(
                    "injected pad overflow (forcing full replan)")
        return self._orig_plan_part(nfa, pads)

    def arm_pad_overflow(self) -> None:
        """The next fits-old-pads ``plan_part`` call raises
        ``PadOverflow`` (once), pushing the add onto the merge-pads full
        replan — which must still succeed and commit."""
        self.pad_overflow_armed += 1

    def remove(self) -> None:
        self.stage._filter_bytebatch = self._orig_filter   # type: ignore
        self.stage._eng.plan_part = self._orig_plan_part   # type: ignore


# ------------------------------------------------------------- workload
def _malformed_payload(d: TagDictionary) -> bytes:
    return d.open_bytes(0)                      # one unclosed element


def _overdepth_payload(d: TagDictionary, depth: int = 80) -> bytes:
    return (b"".join(d.open_bytes(0) for _ in range(depth))
            + b"".join(d.close_bytes(0) for _ in range(depth)))


def chaos_workload(n_requests: int, plan: FaultPlan, *,
                   n_queries: int = 16, seed: int = 0):
    """Seeded corpus with the plan's poisons substituted in.

    Returns ``(profiles, dictionary, dtd, payloads, kernel_payloads)``
    — ``kernel_payloads`` is the marker set the injector detects (valid
    bytes that pass pre-admission but "fault" on device).
    """
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    profiles = gen_profiles(dtd, n=n_queries, length=3, seed=seed)
    docs = gen_corpus(dtd, n_docs=n_requests, nodes_per_doc=40, seed=1)
    payloads = [encode_bytes(x, text_fill=TEXT_FILL) for x in docs]
    kernel_payloads: set[bytes] = set()
    for i in plan.malformed:
        payloads[i] = _malformed_payload(d)
    for i in plan.overdepth:
        payloads[i] = _overdepth_payload(d)
    for i in plan.kernel:
        # tag the payload with a unique valid suffix document so it
        # stays well-formed (passes validation) yet is recognizable
        marked = payloads[i] + d.open_bytes(1) + d.close_bytes(1)
        payloads[i] = marked
        kernel_payloads.add(marked)
    return profiles, d, dtd, payloads, kernel_payloads


# ----------------------------------------------------------- chaos trace
def run_chaos_trace(n_requests: int = 48, *, plan: FaultPlan = DEFAULT_PLAN,
                    engine: str = "streaming", n_queries: int = 16,
                    max_batch: int = 4, deadline_ms: float = 10.0,
                    queue_cap: int = 256, rate_hz: float = 400.0,
                    seed: int = 0, stage_opts: dict | None = None,
                    device: str = "cuda") -> dict:
    """One seeded arrival trace with every fault class active.

    Runs the chaos loop and a fault-free reference loop over the same
    healthy payloads, then verifies the containment contract (see
    module docstring).  Returns the report dict that ``main`` writes;
    ``report["ok"]`` is the overall verdict and ``report["checks"]``
    itemizes each invariant.  Both stages run on ``device``.
    """
    stage_opts = dict(stage_opts or {})
    stage_opts.setdefault("device", device)
    # the forced-PadOverflow drill needs the sharded add path (plan_part
    # is only on the sharded subscribe's call chain)
    stage_opts.setdefault("query_shards", 2)
    profiles, d, dtd, payloads, kernel_payloads = chaos_workload(
        n_requests, plan, n_queries=n_queries, seed=seed)
    poison = set(plan.poison_indices())
    healthy = [i for i in range(n_requests) if i not in poison]

    def build_stage():
        return FilterStage(profiles, d, n_shards=2, engine=engine,
                           keep_unmatched=True, batch_size=max_batch,
                           **stage_opts)

    def verdict(t):
        # original-profile gids only: the mid-trace churn legitimately
        # adds matches for gids >= n_queries, which are not part of the
        # "healthy verdicts are unchanged by faults" contract
        gids: set[int] = set()
        for rd in t.routed or []:
            gids.update(int(g) for g in np.asarray(rd.matched_profiles))
        return frozenset(g for g in gids if g < n_queries)

    # ---- reference: the same healthy payloads, no faults ----
    ref_stage = build_stage()
    ref_loop = ServeLoop(ref_stage, max_batch=max_batch,
                         deadline_ms=deadline_ms, queue_cap=queue_cap)
    with ref_loop:
        ref_tickets = [ref_loop.submit(payloads[i]) for i in healthy]
    reference = {i: verdict(t) for i, t in zip(healthy, ref_tickets)}

    # ---- chaos: all payloads, injector armed, churn mid-trace ----
    stage = build_stage()
    injector = FaultInjector(stage, plan, kernel_payloads)
    loop = ServeLoop(stage, max_batch=max_batch, deadline_ms=deadline_ms,
                     queue_cap=queue_cap)
    arrivals = make_arrivals("poisson", n_requests, rate_hz=rate_hz,
                             seed=seed)
    churn = gen_profiles(dtd, n=max(len(plan.pad_overflow_adds), 1) + 1,
                         length=3, seed=97)
    swap_tickets = []
    mid = n_requests // 2

    # submit on the trace manually so we can interleave churn mid-trace
    t0 = time.monotonic()
    tickets = []
    for k, (p, due) in enumerate(zip(payloads, arrivals)):
        lag = due - (time.monotonic() - t0)
        if lag > 0:
            time.sleep(lag)
        tickets.append(loop.submit(p))
        if k == mid:
            for j, q in enumerate(churn, start=1):
                if j in plan.pad_overflow_adds:
                    injector.arm_pad_overflow()
                swap_tickets.append(loop.subscribe(q))
    for tk in swap_tickets:
        tk.done.wait(timeout=120)
    loop.close()
    injector.remove()
    slo = loop.slo_summary()

    # ---- the containment contract ----
    dead = [{"seq": r["seq"], "error": r["error"], "message": r["message"]}
            for r in loop.dead_letter]
    dead_payloads = [r["payload"] for r in loop.dead_letter]
    want_dead = sorted(payloads[i] for i in poison)
    checks = {
        "finished": all(t.done.is_set() for t in tickets),
        "accounting_closed": slo["arrived"] == (
            slo["completed"] + slo["shed"] + slo["failed"]
            + slo["quarantined"]),
        "dead_letter_exact": sorted(dead_payloads) == want_dead,
        "poison_typed": all(tickets[i].failed
                            and tickets[i].error is not None
                            for i in poison),
        "healthy_verdicts_identical": all(
            not tickets[i].failed and verdict(tickets[i]) == reference[i]
            for i in healthy if not tickets[i].shed),
        "worker_fault_retried": (slo["retries"]
                                 >= len(plan.worker_fault_batches)),
        "pad_overflow_forced": (injector.pad_overflows_forced
                                >= len(plan.pad_overflow_adds)),
        "swaps_committed": all(tk.error is None for tk in swap_tickets),
        "no_loop_failure": slo["failed"] == 0,
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "slo": slo,
        "swaps": loop.swap_summary(),
        "dead_letter": dead,
        "injected": {
            "malformed": list(plan.malformed),
            "overdepth": list(plan.overdepth),
            "kernel": list(plan.kernel),
            "worker_fault_batches": list(plan.worker_fault_batches),
            "slow_batches": list(plan.slow_batches),
            "pad_overflow_adds": list(plan.pad_overflow_adds),
        },
        "n_requests": n_requests,
        "seed": seed,
    }


def main(argv: Any = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--engine", default="streaming")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--query-shards", type=int, default=0,
                    help="query shards of the stage (0 = the drill's 2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stages (default the card)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the chaos report JSON here")
    args = ap.parse_args(argv)

    stage_opts = ({"query_shards": args.query_shards}
                  if args.query_shards > 1 else {})
    report = run_chaos_trace(args.requests, engine=args.engine,
                             n_queries=args.queries, max_batch=args.batch,
                             seed=args.seed, stage_opts=stage_opts,
                             device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    s = report["slo"]
    print(f"[chaos] {report['n_requests']} requests: "
          f"{s['completed']} completed, {s['quarantined']} quarantined "
          f"({s['rejected']} pre-admission), {s['retries']} retries, "
          f"{s['swaps']} swaps ({s['swap_rollbacks']} rollbacks)")
    for name, ok in report["checks"].items():
        print(f"[chaos]   {'PASS' if ok else 'FAIL'} {name}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
