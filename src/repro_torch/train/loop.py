"""Fault-tolerant training loop.

Counterpart of ``src/repro/train/loop.py``:

* auto-resume from the newest intact checkpoint;
* an async checkpoint every ``ckpt_every`` steps, off the critical path
  (``CheckpointStore.save_async`` copies to the host, then writes on a
  thread);
* preemption: a signal file triggers checkpoint-and-exit;
* stragglers: a per-step wall-clock deadline; overruns are logged and
  counted;
* deterministic data: ``batch_fn(step)`` is a pure function of the
  step, so a restart replays exactly.

The loss is read with one ``float()`` a step, as in the JAX loop; that
read waits for the step, so the step's wall-clock time is measured with
no other synchronisation.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np

from ..checkpoint.store import CheckpointStore
from ..models.config import ModelConfig


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    # the JAX loop's /tmp/repro_ckpt, under the temporary directory
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    step_deadline_s: float = 0.0      # 0 = disabled
    preempt_file: str = ""            # touch this file to simulate SIGTERM
    log_every: int = 10


@dataclasses.dataclass
class LoopResult:
    final_step: int
    resumed_from: int | None
    straggler_steps: int
    preempted: bool
    losses: list


def run_training(cfg: ModelConfig, loop: LoopConfig, *,
                 params: Any, opt_state: Any,
                 step_fn: Callable, batch_fn: Callable[[int], dict],
                 shardings: Any = None,
                 log: Callable[[str], None] = print) -> LoopResult:
    """Drive step_fn with checkpoint/restart/preemption semantics.

    ``step_fn(params, opt_state, batch, step_idx) -> (params, opt, metrics)``
    ``batch_fn(step) -> batch dict`` (deterministic per step).  A
    restored checkpoint lands on the devices of ``params`` and
    ``opt_state``'s leaves, or, with ``shardings`` (for the tree
    ``(params, opt_state)``), is placed on the mesh's positions by the
    store (elastic restore).
    """
    store = CheckpointStore(loop.ckpt_dir)
    resumed_from = None
    start = 0
    restored = store.restore_latest((params, opt_state), shardings)
    if restored is not None:
        start, (params, opt_state), manifest = restored
        resumed_from = start
        log(f"[loop] resumed from step {start}"
            f" (mesh-independent manifest: {manifest.get('mesh', 'n/a')})")

    stragglers = 0
    preempted = False
    losses = []
    step = start
    for step in range(start, loop.total_steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             np.int32(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        if loop.step_deadline_s and dt > loop.step_deadline_s:
            stragglers += 1
            log(f"[loop] step {step}: straggler ({dt:.3f}s > "
                f"{loop.step_deadline_s:.3f}s deadline)")
        if loop.log_every and step % loop.log_every == 0:
            log(f"[loop] step {step}: loss={loss:.4f} ({dt:.3f}s)")
        done = step + 1
        if loop.ckpt_every and done % loop.ckpt_every == 0:
            store.save_async(done, (params, opt_state),
                             {"config": cfg.name})
        if loop.preempt_file and os.path.exists(loop.preempt_file):
            log(f"[loop] preemption signal at step {done}; checkpointing")
            store.wait()
            store.save(done, (params, opt_state), {"config": cfg.name})
            preempted = True
            break
    store.wait()
    final = step + 1 if (start < loop.total_steps) else start
    return LoopResult(final, resumed_from, stragglers, preempted, losses)
