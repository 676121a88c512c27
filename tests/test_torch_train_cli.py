"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's, on the CPU.

``build_filtered_pipeline`` keeps the JAX function's documents and gives
its first batches, for both ingests, and runs the levelwise stage
through K6 (and K5's device parse for bytes; on the CPU, their plain
versions).  ``main`` on ``--device cpu`` trains a few steps, checkpoints
and resumes, with the JAX CLI's flags (plus ``--device``) and quirks,
each pinned here: ``--reduced`` is always on, ``--data-filter`` sets the
vocabulary to 256, and a rerun with no step left fails on its summary
line.
"""
import dataclasses
import inspect
import re
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import train as jax_train
from repro_torch.kernels import nfa_transition as nt
from repro_torch.kernels import parse
from repro_torch.launch import train
from repro_torch.train.loop import LoopResult


@pytest.fixture(scope="module")
def jax_pipes():
    """The JAX pipelines (batch 4, seq 32) and their log lines."""
    out = {}
    for ingest in ("events", "bytes"):
        logs = []
        pipe = jax_train.build_filtered_pipeline(4, 32, log=logs.append,
                                                 ingest=ingest)
        out[ingest] = (pipe, logs)
    return out


@pytest.mark.parametrize("ingest", ["events", "bytes"])
def test_build_filtered_pipeline_equals_jax(ingest, jax_pipes, monkeypatch):
    calls = {"K5": 0, "K6": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(parse, "predecode", counted("K5", parse.predecode))
    monkeypatch.setattr(nt, "nfa_transition",
                        counted("K6", nt.nfa_transition))
    logs = []
    pipe = train.build_filtered_pipeline(4, 32, log=logs.append,
                                         ingest=ingest, device="cpu")
    want, want_logs = jax_pipes[ingest]
    assert logs == want_logs
    assert re.search(r"kept (\d+)/64", logs[0])
    if ingest == "bytes":
        assert pipe.payloads == want.payloads
    np.testing.assert_array_equal(pipe._buf, want._buf)
    for step in (0, 1, 7):
        got, ref = pipe.batch_at(step), want.batch_at(step)
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    assert calls["K6"] > 0
    assert (calls["K5"] > 0) == (ingest == "bytes")


def _main(monkeypatch, capsys, args) -> str:
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    train.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("ingest", ["bytes", "events"])
def test_main_trains_checkpoints_and_resumes(ingest, monkeypatch, capsys,
                                             tmp_path, jax_pipes):
    def args(steps):
        return ["--device", "cpu", "--data-filter", "--data-ingest", ingest,
                "--steps", str(steps), "--ckpt-every", "3", "--ckpt-dir",
                str(tmp_path)]

    out = _main(monkeypatch, capsys, args(6))
    assert jax_pipes[ingest][1][0] in out          # the same kept line
    assert "1 device(s) (cpu)" in out
    m = re.search(r"done at step 6; loss ([0-9.]+) → ([0-9.]+)\n", out)
    assert m and float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000003", "step_00000006"]
    out = _main(monkeypatch, capsys, args(8))
    assert "[loop] resumed from step 6" in out
    assert re.search(r"done at step 8; .* \(resumed from 6\)", out)


def test_main_rerun_with_no_step_left_fails_as_jax(monkeypatch, capsys,
                                                   tmp_path):
    """A quirk of the JAX CLI, kept: resumed at ``--steps``, the loop
    runs nothing and the summary line indexes an empty loss list."""
    args = ["--device", "cpu", "--steps", "2", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--batch", "2", "--seq-len", "8"]
    _main(monkeypatch, capsys, args)
    with pytest.raises(IndexError):
        _main(monkeypatch, capsys, args)


@pytest.mark.parametrize("extra,over", [
    ([], {}),
    (["--reduced"], {}),
    (["--data-filter"], {"vocab": 256}),
    (["--d-model", "48", "--layers", "3"],
     {"d_model": 48, "d_ff": 192, "n_layers": 3}),
    (["--arch", "mamba2-780m"], {}),
], ids=["default", "reduced-flag", "data-filter", "widths", "arch"])
def test_main_config_is_the_jax_clis(extra, over, monkeypatch, capsys,
                                     tmp_path):
    """``--reduced`` is ``store_true`` with ``default=True``, so every run
    is reduced; ``--data-filter`` sets ``vocab=256``; the model is the
    port's ``init_model`` from ``torch.Generator(device).manual_seed(0)``
    and the optimizer the config's."""
    seen = {}

    def capture(cfg, loop, *, params, opt_state, step_fn, batch_fn,
                log=print):
        seen.update(cfg=cfg, loop=loop, params=params, opt_state=opt_state,
                    batch=batch_fn(0))
        return LoopResult(0, None, 0, False, [1.0])

    monkeypatch.setattr(train, "run_training", capture)
    if "--data-filter" in extra:
        monkeypatch.setattr(train, "build_filtered_pipeline",
                            lambda *a, **k: train.TokenPipeline(256, 2, 4))
    _main(monkeypatch, capsys, ["--device", "cpu", "--ckpt-dir",
                                str(tmp_path)] + extra)
    arch = extra[1] if extra[:1] == ["--arch"] else "qwen3-0.6b"
    want = jax_get_config(arch, reduced=True)
    if over:
        want = want.with_(**over)
    assert dataclasses.asdict(seen["cfg"]) == dataclasses.asdict(want)
    torch.testing.assert_close(
        seen["params"]["embed"],
        train.T.init_model(seen["cfg"], torch.Generator().manual_seed(0))[
            "embed"])
    assert set(seen["opt_state"]) == ({"m", "v"} if want.optimizer == "adamw"
                                      else {"stats"})
    loop = seen["loop"]
    assert (loop.total_steps, loop.ckpt_every, loop.log_every,
            loop.preempt_file) == (100, 25, 10, "")


def test_main_without_a_card_raises(monkeypatch, capsys):
    """No ``--device``: the card, which must be there; no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _main(monkeypatch, capsys, [])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.build_filtered_pipeline(2, 8)


def test_main_flags_are_the_jax_flags_and_device():
    """The JAX CLI's flags one for one, and ``--device``."""
    def flags(fn):
        return set(re.findall(r'add_argument\("(--[a-z-]+)"',
                              inspect.getsource(fn)))

    assert flags(train.main) == flags(jax_train.main) | {"--device"}
    assert "--data-ingest" in flags(train.main)
