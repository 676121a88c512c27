"""The port's example twins (``examples/torch_*.py``) against the JAX
package's examples, on the CPU (``--device cpu``).

* ``torch_quickstart.py`` prints the JAX quickstart's lines, each
  engine's matches and first-match events included;
* ``torch_pubsub_filtering.py`` at small knobs: the same plan size, the
  same engine agreement, the same deliveries and selectivity from events
  and from bytes (the throughput lines are timings and differ);
* ``torch_twig_filtering.py``: the same paths, states, twig deliveries
  and stage-2 checks and rejects;
* ``torch_train_lm.py`` hands the training CLI the JAX example's
  arguments (plus ``--device``); at small knobs it keeps the JAX run's
  documents, and its losses start where the JAX run's do (both models
  start from random weights, the port's drawn from torch's generator, so
  within 1 % of ln 256 of each other, not equal) and fall.

Every example runs as a script, in a subprocess on one thread, all at
once.
"""
import os
import re
import runpy
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EX = os.path.join(ROOT, "examples")
PUBSUB_KNOBS = ["--queries", "64", "--docs", "8", "--nodes", "150"]
TRAIN_KNOBS = {"--d-model": "64", "--layers": "2", "--batch": "4",
               "--seq-len": "32", "--steps": "3"}
_JAX_TRAIN = r'''
import sys
from repro.launch import train
sys.argv = sys.argv[1:]
train.main()
'''


def _jax_train_argv(ckpt: str) -> list[str]:
    """``examples/train_lm.py``'s argument list at :data:`TRAIN_KNOBS`."""
    k = TRAIN_KNOBS
    return ["train", "--arch", "qwen3-0.6b", "--reduced", "--d-model",
            k["--d-model"], "--layers", k["--layers"], "--steps",
            k["--steps"], "--batch", k["--batch"], "--seq-len",
            k["--seq-len"], "--data-filter", "--ckpt-dir", ckpt]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    # one thread each: eight scripts run at once beside the suite's workers
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    knobs = [x for kv in TRAIN_KNOBS.items() for x in kv]
    runs = {
        "quickstart": [os.path.join(EX, "quickstart.py")],
        "torch_quickstart": [os.path.join(EX, "torch_quickstart.py"),
                             "--device", "cpu"],
        "pubsub": [os.path.join(EX, "pubsub_filtering.py")] + PUBSUB_KNOBS,
        "torch_pubsub": [os.path.join(EX, "torch_pubsub_filtering.py"),
                         "--device", "cpu"] + PUBSUB_KNOBS,
        "twig": [os.path.join(EX, "twig_filtering.py")],
        "torch_twig": [os.path.join(EX, "torch_twig_filtering.py"),
                       "--device", "cpu"],
        # the JAX example's CLI call at the same small knobs
        "train": ["-c", _JAX_TRAIN] + _jax_train_argv(str(tmp / "jax")),
        "torch_train": [os.path.join(EX, "torch_train_lm.py"), "--device",
                        "cpu", "--ckpt-dir", str(tmp / "port")] + knobs,
    }
    procs = {k: subprocess.Popen([sys.executable] + v, env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in runs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (k, stderr[-3000:])
        out[k] = stdout.strip().splitlines()
    return out


def test_quickstart_prints_the_jax_quickstarts_matches(outputs):
    assert outputs["torch_quickstart"] == outputs["quickstart"]
    assert len(outputs["quickstart"]) == 5


def _routes(lines):
    keep = []
    for line in lines:
        if "MB/s" in line and "routing" not in line:
            continue                       # an engine's timing line
        keep.append(re.sub(r"\(\d+ docs/s\)|[0-9.]+ MB/s end-to-end", "",
                           line))
    return keep


def test_pubsub_routes_as_the_jax_example(outputs):
    got, want = _routes(outputs["torch_pubsub"]), _routes(outputs["pubsub"])
    assert got == want
    assert any(line.startswith("engine agreement") for line in got)
    assert any("deliveries to 4 subscriber shards" in line for line in got)


def test_twig_filtering_delivers_as_the_jax_example(outputs):
    def strip(lines):
        return [re.sub(r" in [0-9.]+s", "", line) for line in lines]
    assert strip(outputs["torch_twig"]) == strip(outputs["twig"])
    assert "twig deliveries" in outputs["twig"][1]


def test_train_lm_passes_the_jax_examples_arguments(monkeypatch):
    """At its defaults the twin hands the training CLI the JAX example's
    argument list, plus ``--device``."""
    from repro.launch import train as jax_train
    from repro_torch.launch import train as port_train

    seen = {}
    monkeypatch.setattr(jax_train, "main",
                        lambda: seen.setdefault("jax", list(sys.argv)))
    monkeypatch.setattr(port_train, "main",
                        lambda: seen.setdefault("port", list(sys.argv)))
    for name in ("train_lm.py", "torch_train_lm.py"):
        monkeypatch.setattr(sys, "argv", [name, "--ckpt-dir", "/ck"])
        runpy.run_path(os.path.join(EX, name), run_name="__main__")
    assert seen["port"] == seen["jax"] + ["--device", "cuda"]


def test_train_lm_keeps_the_jax_documents_and_its_loss_falls(outputs):
    def loss(lines):
        m = re.search(r"loss ([0-9.]+) → ([0-9.]+)", lines[-1])
        return float(m.group(1)), float(m.group(2))

    got, want = outputs["torch_train"], outputs["train"]
    kept = [line for line in got if "filter stage kept" in line]
    assert kept and kept == [line for line in want
                             if "filter stage kept" in line]
    (g0, g1), (w0, w1) = loss(got), loss(want)
    assert g1 < g0 and w1 < w0
    assert g0 == pytest.approx(w0, rel=0.01)
