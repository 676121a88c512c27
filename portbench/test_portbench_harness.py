"""The harness end to end on the CPU at a tiny size: a scratch
configuration and mix found by name, a clean run judged correct, and the
faults a cell can have judged not correct.  The look for a card is
skipped (``run.measure`` on ``device="cpu"``); ``run.main`` keeps it."""
import json
import shutil
import subprocess
import sys
import uuid

import numpy as np
import pytest

from portbench import run, spec

ROUTE_CFG = {"profiles": {"count": 400}, "documents": {"nodes": [300, 300]}}
SERVE_CFG = {"profiles": {"count": 400}}
ROUTE_MIX = {"kind": "route", "pool": 3, "batch": 4, "warmup_requests": 1}
SERVE_MIX = {"kind": "serve", "pool": 12, "arrival": {"process": "backlog"},
             "ramp_s": 0.05,
             "loop": {"max_batch": 4, "deadline_ms": 2, "max_inflight": 2,
                      "queue_cap": 8, "overload": "block",
                      "validate": True}}
POISSON_MIX = dict(SERVE_MIX, arrival={"process": "poisson", "rate_hz": 100.0},
                   loop=dict(SERVE_MIX["loop"], overload="shed"))


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and k in base \
            else v
    return out


@pytest.fixture
def scratch():
    """Scratch configuration and traffic files beside the real ones, and a
    benchmark whose cells name them; removed afterwards."""
    tag = uuid.uuid4().hex[:10]
    written = []

    def put(kind: str, name: str, body: dict) -> str:
        path = spec.HERE / kind / f"{name}.json"
        path.write_text(json.dumps(body))
        written.append(path)
        return name

    route_cfg = put("configs", f"_scratch_doc_{tag}",
                    _merge(spec.config("xpath10k-doc1mb"), ROUTE_CFG))
    serve_cfg = put("configs", f"_scratch_msg_{tag}",
                    _merge(spec.config("xpath10k-msg8kb"), SERVE_CFG))
    route_mix = put("traffic", f"_scratch_route_{tag}", ROUTE_MIX)
    serve_mix = put("traffic", f"_scratch_serve_{tag}", SERVE_MIX)
    poisson_mix = put("traffic", f"_scratch_poisson_{tag}", POISSON_MIX)
    bench = spec.benchmark()
    bench["workloads"] = [
        {"name": "t.route", "config": route_cfg, "traffic": route_mix,
         "chips": 1, "why": "test"},
        {"name": "t.serve", "config": serve_cfg, "traffic": serve_mix,
         "chips": 1, "why": "test"},
        {"name": "t.poisson", "config": serve_cfg, "traffic": poisson_mix,
         "chips": 1, "why": "test"}]
    # the route metrics as the doc cell has them; the serve loop's
    # readers, which no cell of BENCHMARK.json uses yet, on the serve cell
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = (["t.route"] if "doc1mb.route" in
                          m.get("workloads", ["doc1mb.route"]) else [])
    bench["end_to_end"].append(
        {"name": "serve_docs_per_s", "unit": "docs/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["t.serve"]})
    bench["end_to_end"][1]["workloads"] += ["t.serve", "t.poisson"]
    bench["per_layer"].append(
        {"name": "serve_slot_wait_share", "unit": "1", "better": "lower",
         "source": "program_counter", "layer": "serve loop",
         "moves": "serve_docs_per_s", "workloads": ["t.serve"]})
    try:
        yield bench
    finally:
        for path in written:
            path.unlink()


def measure(bench, cell, seed=2**31 + 9, trace=False):
    return run.measure(cell, seed, 0.2, trace, device="cpu", bench=bench)


def test_scratch_files_are_found_by_name(scratch):
    cell = spec.cell(scratch, "t.route")
    assert spec.config(cell["config"])["profiles"]["count"] == 400
    assert spec.traffic(cell["traffic"])["batch"] == 4
    names = [m["name"] for m in spec.metrics_of(scratch, "t.route", True)]
    assert "k2_roofline_pct" in names and "k3_roofline_pct" not in names
    assert callable(spec.reader("k2_roofline_pct"))


@pytest.mark.parametrize("cell", ["t.route", "t.serve", "t.poisson"])
def test_clean_run_is_correct(scratch, cell):
    result, lines = measure(scratch, cell)
    assert result["correct"] and result["attempted"] > 0
    if cell != "t.poisson":          # the open loop may shed: refused
        assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-2:] == ["check mismatched 0 limit 0",
                          "check unanswered 0 limit 0"]
    e2e = {"t.route": "route_mb_per_s"}.get(cell, "serve_docs_per_s")
    assert set(result["metrics"]) <= {e2e, "setup_s"}
    assert result["metrics"]["setup_s"]["value"] > 0


def test_traced_run_reports_per_layer_metrics(scratch):
    result, _ = measure(scratch, "t.route", trace=True)
    assert result["correct"]
    assert set(result["metrics"]) <= {"request_host_ms", "k2_roofline_pct",
                                      "mfu_pct.route",
                                      "device_idle_pct.route"}
    assert "request_host_ms" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _drop_half(monkeypatch):
    from repro_torch.data.filter_stage import FilterStage

    orig = FilterStage._fan_out

    def fan_out(self, results, nbytes, base=0, *, gids=None, seqs=None):
        routed = orig(self, results, nbytes, base, gids=gids, seqs=seqs)
        n = len(nbytes)
        docs = list(seqs) if seqs is not None else list(range(base, base + n))
        left_out = set(docs[n // 2:])
        return [rd for rd in routed if rd.doc_index not in left_out]

    monkeypatch.setattr(FilterStage, "_fan_out", fan_out)


def _alter_one(monkeypatch):
    from repro_torch.core.engines.streaming import StreamingEngine

    dense, sparse = (StreamingEngine.filter_bytes,
                     StreamingEngine.filter_bytes_sparse)

    def filter_bytes(self, *args, **kwargs):
        res = dense(self, *args, **kwargs)
        res.matched[0, 0] = ~res.matched[0, 0]
        return res

    def filter_bytes_sparse(self, *args, **kwargs):
        res = sparse(self, *args, **kwargs)
        res.query_ids[0] = (res.query_ids[0] + 1) % res.n_queries
        return res

    monkeypatch.setattr(StreamingEngine, "filter_bytes", filter_bytes)
    monkeypatch.setattr(StreamingEngine, "filter_bytes_sparse",
                        filter_bytes_sparse)


@pytest.mark.parametrize("fault", [_drop_half, _alter_one],
                         ids=["half the batch left out", "answer altered"])
@pytest.mark.parametrize("cell", ["t.route", "t.serve"])
def test_a_fault_underneath_is_not_correct(scratch, monkeypatch, cell,
                                           fault):
    fault(monkeypatch)
    result, lines = measure(scratch, cell)
    assert not result["correct"]
    assert result["checks"]["mismatched"]["value"] > 0
    assert lines[-2].startswith("check mismatched ")


def test_forbidden_modules_compare_whole_names():
    loaded = ["numpy", "repro_torch", "repro_torch.core", "jaxtyping"]
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(loaded + ["repro.core.xpath", "jaxlib",
                                           "flax.linen"]) == [
        "flax", "jaxlib", "repro"]


def test_no_result_without_the_program_or_a_card(tmp_path):
    """Only BENCHMARK.json and the benchmark's own files: non-zero exit,
    nothing on standard output.  With no card (as here) the whole
    checkout fails too, at the look for a card."""
    import torch

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    where = [tmp_path] + ([] if torch.cuda.is_available() else [spec.ROOT])
    for cwd in where:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "doc1mb.route", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


def test_answers_compare_by_shard_and_id():
    from portbench import check
    from repro_torch.data.filter_stage import RoutedDocument

    want = {1: np.array([1, 9]), 2: np.array([2])}
    rd = lambda s, ids: RoutedDocument(0, np.array(ids, np.int32), s, 10)
    assert check.same(check.answer_of([rd(2, [2]), rd(1, [9, 1])]), want)
    assert not check.same(check.answer_of([rd(1, [1, 9])]), want)
    assert not check.same(check.answer_of([rd(1, [1, 9]), rd(2, [2]),
                                           rd(2, [2])]), want)
    assert not check.same(check.answer_of([rd(1, [1, 9]), rd(2, [3])]),
                          want)


def test_instrumentation_wraps_and_restores():
    from portbench import trace
    from repro_torch.core.events import ByteBatch
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.serve import loop

    before = (vars(ByteBatch)["from_buffers"], FilterStage._fan_out,
              loop.validate_payload)
    spans = trace.Spans()
    spans.instrument()
    try:
        assert FilterStage._fan_out is not before[1]
        bb = ByteBatch.from_buffers([b"<aa></aa>", b""])
        assert bb.batch_size == 2
        loop.validate_payload(b"<aa></aa>")
    finally:
        spans.uninstrument()
    assert (vars(ByteBatch)["from_buffers"], FilterStage._fan_out,
            loop.validate_payload) == before
    assert [n for n, *_ in spans.items] == ["stage.pack", "loop.validate"]


def test_idle_time_goes_to_the_deepest_open_span():
    from portbench import trace

    spans = trace.Spans()
    spans.items = [("stage.route_bytes", 0, 100), ("engine.to_device", 10, 30),
                   ("stage.fan_out", 60, 90), ("engine.to_device", 85, 95)]
    got = trace._label_gaps(np.array([[5, 40], [50, 100], [120, 130]]),
                            spans)
    assert got == {"engine.to_device": 30e-9, "stage.fan_out": 25e-9,
                   "stage.route_bytes": 30e-9, "no span": 10e-9}
    busy = trace.merge(np.array([0, 5, 20]), np.array([3, 8, 25]))
    assert busy.tolist() == [[0, 3], [5, 8], [20, 25]]
    assert trace.covered(busy, 1, 22).tolist() == 2 + 3 + 2
