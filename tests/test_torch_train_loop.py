"""The port's fault-tolerant loop (``repro_torch.train.loop``) on the
CPU, as ``tests/test_train_substrate.py`` holds the JAX loop: preemption
and resume, the straggler count, deterministic replay after a restart,
and the same loss trajectory as the JAX loop on carried-over
parameters.
"""
import dataclasses
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config("qwen3-0.6b", reduced=True).with_(n_layers=2,
                                                            grad_accum=1)
    return jcfg, jax.jit(JT.init_model, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


@pytest.fixture
def tiny(jax_params):
    cfg = get_config("qwen3-0.6b", reduced=True).with_(n_layers=2,
                                                       grad_accum=1)
    params = model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jax_params[1]), "cpu")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=16, seed=1)
    return cfg, params, pipe


def setup(tiny, tmp_path, total=12, ckpt_every=4):
    cfg, params, pipe = tiny
    opt = make_optimizer("adamw", lr=1e-3)
    state = opt.init(params)
    loop = LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp_path / "ck"), log_every=0)
    return cfg, params, state, make_train_step(cfg, opt), pipe, loop


def test_loop_config_is_the_jax_one():
    """The same fields and defaults, the checkpoint directory under the
    temporary directory (``/tmp`` for the JAX loop)."""
    ours = {f.name: f.default for f in dataclasses.fields(LoopConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxLoopConfig)}
    assert ours.pop("ckpt_dir") == os.path.join(tempfile.gettempdir(),
                                                "repro_ckpt")
    assert theirs.pop("ckpt_dir") == "/tmp/repro_ckpt"
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(LoopResult)] == [
        "final_step", "resumed_from", "straggler_steps", "preempted",
        "losses"]


def test_preemption_and_resume(tiny, tmp_path):
    cfg, params, state, step, pipe, loop = setup(tiny, tmp_path)
    loop.preempt_file = str(tmp_path / "PREEMPT")
    logs = []
    open(loop.preempt_file, "w").close()
    r1 = run_training(cfg, loop, params=params, opt_state=state,
                      step_fn=step, batch_fn=pipe.batch_at, log=logs.append)
    assert r1.preempted and r1.final_step == 1 < loop.total_steps
    assert any("preemption signal at step 1" in x for x in logs)
    os.remove(loop.preempt_file)
    r2 = run_training(cfg, loop, params=params, opt_state=state,
                      step_fn=step, batch_fn=pipe.batch_at, log=logs.append)
    assert r2.resumed_from == r1.final_step
    assert r2.final_step == loop.total_steps and not r2.preempted
    assert len(r2.losses) == loop.total_steps - r1.final_step


def test_straggler_detection(tiny, tmp_path):
    cfg, params, state, step, pipe, loop = setup(tiny, tmp_path, total=3,
                                                 ckpt_every=0)
    loop.step_deadline_s = 1e-9  # everything is a straggler
    r = run_training(cfg, loop, params=params, opt_state=state,
                     step_fn=step, batch_fn=pipe.batch_at,
                     log=lambda s: None)
    assert r.straggler_steps == 3
    assert not os.listdir(loop.ckpt_dir)      # ckpt_every=0: none written


def test_deterministic_replay(tiny, tmp_path):
    """6 steps straight through, then a restart from the step-3
    checkpoint: steps 4-6 replay the same losses bit for bit."""
    cfg, params, state, step, pipe, loop = setup(tiny, tmp_path, total=6,
                                                 ckpt_every=3)
    fresh = [p.clone() for p in (params["embed"],)]
    r_full = run_training(cfg, loop, params=params, opt_state=state,
                          step_fn=step, batch_fn=pipe.batch_at,
                          log=lambda s: None)
    assert r_full.resumed_from is None and len(r_full.losses) == 6
    assert not np.array_equal(params["embed"].numpy(), fresh[0].numpy())
    # fresh run resumes at 6 == total → no extra steps
    r_done = run_training(cfg, loop, params=params, opt_state=state,
                          step_fn=step, batch_fn=pipe.batch_at,
                          log=lambda s: None)
    assert r_done.resumed_from == 6 and r_done.final_step == 6
    assert r_done.losses == []
    # drop step 6: a crash before its checkpoint; resume from step 3
    shutil.rmtree(os.path.join(loop.ckpt_dir, "step_00000006"))
    r_resume = run_training(cfg, loop, params=params, opt_state=state,
                            step_fn=step, batch_fn=pipe.batch_at,
                            log=lambda s: None)
    assert r_resume.resumed_from == 3
    assert r_resume.losses == r_full.losses[3:]


def test_loop_equals_the_jax_loop(tiny, jax_params, tmp_path):
    """Carried-over parameters, the same batches and checkpoints: the
    port's loop logs the JAX loop's losses within 1e-4 relative and
    resumes where it does."""
    jcfg, jp = jax_params
    cfg, params, pipe = tiny
    jopt, opt = jax_make_optimizer("adamw", lr=1e-3), make_optimizer(
        "adamw", lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    step = make_train_step(cfg, opt)
    results = []
    for which, run, lc, p, s, f in (
            ("jax", jax_run_training, JaxLoopConfig, jp, jopt.init(jp),
             jstep),
            ("port", run_training, LoopConfig, params, opt.init(params),
             step)):
        loop = lc(total_steps=5, ckpt_every=2, ckpt_dir=str(tmp_path / which),
                  log_every=0)
        r1 = run(cfg, loop, params=p, opt_state=s, step_fn=f,
                 batch_fn=pipe.batch_at, log=lambda x: None)
        shutil.rmtree(os.path.join(loop.ckpt_dir, "step_00000004"))
        r2 = run(cfg, loop, params=p, opt_state=s, step_fn=f,
                 batch_fn=pipe.batch_at, log=lambda x: None)
        results.append((r1, r2))
    (j1, j2), (t1, t2) = results
    np.testing.assert_allclose(t1.losses, j1.losses, rtol=1e-4)
    np.testing.assert_allclose(t2.losses, j2.losses, rtol=1e-4)
    assert (t2.resumed_from, t2.final_step) == (j2.resumed_from,
                                                j2.final_step) == (2, 5)
