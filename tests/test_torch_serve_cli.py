"""The port's serving-CLI routing layer against the JAX package's.

``repro_torch.launch.serve``'s ``build_stage``, ``route_requests`` and
``serve_continuous`` (``device="cpu"``) against the same functions of
``repro.launch.serve`` on the CLI's deterministic workload (seed 0
profiles, seed 1 corpus): at ``data_shards=1``, with ``query_shards`` 1
and 2, ingest ``events`` and ``bytes``, the replica queues are equal, and
the continuous loop on a ``replay`` trace delivers the same queues with
nothing shed.  With ``data_shards=2`` the stage runs on a mesh and
routes bytes through its pipelined route; those routes are held to the
JAX package's unsharded routes, since the JAX CLI's own 2-D byte routes
fail on this JAX version.  The port's ``main`` runs through
``sys.argv`` with ``--device cpu`` on the argv cases that pass in the
reference (not its 2-D or data-shard byte cases): its printed replica
queues, churn deliveries and generated token count equal the JAX
``main``'s.  Exact equality.
"""
import contextlib
import io
import json
import re
import sys
from types import SimpleNamespace

import pytest
import torch

import repro.launch.serve as jax_serve
from repro.core.events import encode_bytes as jax_encode
from repro.data.generator import gen_corpus as jax_corpus
from repro_torch.checkpoint import PlanCache
from repro_torch.core.events import encode_bytes
from repro_torch.data.filter_stage import TEXT_FILL
from repro_torch.data.generator import gen_corpus
from repro_torch.launch import serve

REQUESTS, REPLICAS, BATCH = 8, 2, 4


def _requests(dtd, corpus, encode):
    payloads = corpus(dtd, n_docs=REQUESTS, nodes_per_doc=60, seed=1)
    return payloads, [encode(doc, text_fill=TEXT_FILL) for doc in payloads]


def _pair(query_shards, engine="levelwise", **kw):
    stage, dtd = serve.build_stage(REPLICAS, engine=engine, batch_size=BATCH,
                                   query_shards=query_shards, device="cpu",
                                   **kw)
    jstage, jdtd = jax_serve.build_stage(REPLICAS, engine=engine,
                                         batch_size=BATCH,
                                         query_shards=query_shards)
    return ((stage, *_requests(dtd, gen_corpus, encode_bytes)),
            (jstage, *_requests(jdtd, jax_corpus, jax_encode)))


@pytest.mark.parametrize("ingest", ["events", "bytes"])
@pytest.mark.parametrize("query_shards", [1, 2])
def test_route_requests_equals_jax(query_shards, ingest):
    (stage, payloads, raw), (jstage, jpayloads, jraw) = _pair(query_shards)
    assert raw == jraw
    got = serve.route_requests(stage, payloads, ingest=ingest, raw=raw)
    want = jax_serve.route_requests(jstage, jpayloads, ingest=ingest,
                                    raw=jraw)
    assert got == want
    assert sum(map(len, got)) >= REQUESTS     # keep_unmatched: all routed
    assert stage.throughput()["docs"] == jstage.throughput()["docs"]


@pytest.mark.parametrize("engine", ["streaming", "wavefront"])
def test_build_stage_is_the_jax_stage(engine):
    """The same profiles, shards, engine and routing policy."""
    (stage, payloads, _), (jstage, _, _) = _pair(1, engine=engine)
    assert [str(q) for q in stage.profiles] \
        == [str(q) for q in jstage.profiles]
    assert stage.shard_of_profile.tolist() \
        == jstage.shard_of_profile.tolist()
    assert (stage.n_shards, stage.engine, stage.keep_unmatched,
            stage.batch_size) == (jstage.n_shards, jstage.engine,
                                  jstage.keep_unmatched, jstage.batch_size)
    assert stage._eng.device.type == "cpu"
    assert serve.route_requests(stage, payloads) \
        == jax_serve.route_requests(jstage, payloads)


def test_build_stage_plan_cache_reaches_the_engine(tmp_path):
    """A restart on the same plan-cache directory compiles nothing."""
    opts = dict(engine="streaming", plan_cache=str(tmp_path))
    cold, dtd = serve.build_stage(REPLICAS, query_shards=2, device="cpu",
                                  **opts)
    assert (cold._eng.plan_cache.hits, cold._eng.plan_cache.misses) \
        == (0, 3)
    warm, _ = serve.build_stage(REPLICAS, query_shards=2, device="cpu",
                                **opts)
    cache = warm._eng.plan_cache
    assert isinstance(cache, PlanCache)
    # the stage's engine read its plan, and the two parts were read too
    # (plan_sharded runs through the same engine and cache)
    assert (cache.hits, cache.misses) == (3, 0)
    payloads, raw = _requests(dtd, gen_corpus, encode_bytes)
    assert serve.route_requests(warm, payloads, ingest="bytes", raw=raw) \
        == serve.route_requests(cold, payloads, ingest="bytes", raw=raw)


@pytest.mark.parametrize("query_shards", [1, 2])
def test_serve_continuous_replay_equals_jax(query_shards, tmp_path):
    """The continuous loop on a replay trace delivers the queues the batch
    route gives, as the JAX CLI's loop does, with nothing shed; the
    latency file holds every completed request."""
    (stage, payloads, raw), (jstage, _, jraw) = _pair(query_shards)
    args = SimpleNamespace(arrival="replay", rate=2000.0, seed=0,
                           batch=BATCH, deadline_ms=10.0, queue_cap=64,
                           max_inflight=2, overload="shed",
                           latency_json=str(tmp_path / "lat.json"))
    queues, slo = serve.serve_continuous(stage, raw, args)
    jqueues, jslo = jax_serve.serve_continuous(
        jstage, jraw, SimpleNamespace(**{**vars(args),
                                         "latency_json": None}))
    assert queues == jqueues
    assert queues == serve.route_requests(stage, payloads, ingest="bytes",
                                          raw=raw)
    assert slo["shed"] == jslo["shed"] == 0
    assert slo["completed"] == jslo["completed"] == REQUESTS
    data = json.loads((tmp_path / "lat.json").read_text())
    assert data["arrival"] == "replay"
    assert len(data["latencies_ms"]) == slo["completed"]
    assert sum(data["histogram"]["counts"]) == slo["completed"]


def test_data_shards_build_through_the_stage():
    """``build_stage(data_shards=2)`` builds the stage on a mesh placed on
    the one CPU device (1 x 1, as the JAX package's is on one device),
    with a sharded plan of ``query_shards`` parts."""
    stage, _ = serve.build_stage(REPLICAS, query_shards=2, data_shards=2,
                                 device="cpu")
    jstage, _ = jax_serve.build_stage(REPLICAS, query_shards=2,
                                      data_shards=2)
    assert stage.mesh.shape == dict(jstage.mesh.shape) \
        == {"data": 1, "model": 1}
    assert stage.sharded_.part_cols == jstage.sharded_.part_cols
    assert stage.mesh.devices == [torch.device("cpu")]


def _reference_queues():
    """The JAX CLI tests' parity oracle: a monolithic event-ingest stage
    over the CLI's workload.  The JAX CLI's own 2-D byte routes fail on
    this JAX version (their mesh-placed batch reaches ``parse_batch``), so
    the port's 2-D routes are held to this unsharded route."""
    (_, _, _), (jstage, jpayloads, _) = _pair(1)
    return jax_serve.route_requests(jstage, jpayloads, ingest="events")


@pytest.mark.parametrize("query_shards", [1, 2],
                         ids=["dshards-bytes", "2d-bytes"])
def test_data_sharded_route_requests_equals_jax_unsharded(query_shards):
    """The twins of the JAX CLI's ``--data-shards 2 --ingest bytes`` runs
    (with ``--query-shards`` 1 and 2): the pipelined bytes route of the
    2-D stage delivers the unsharded stage's queues, on the placed mesh
    and on a grid of the CPU device, 2 x ``query_shards``."""
    from repro_torch.launch.mesh import FilterMesh

    want = _reference_queues()
    for mesh in (None, FilterMesh([["cpu"] * query_shards] * 2)):
        stage, dtd = serve.build_stage(REPLICAS, batch_size=BATCH,
                                       query_shards=query_shards,
                                       data_shards=2, device="cpu")
        if mesh is not None:
            stage.mesh = mesh
        payloads, raw = _requests(dtd, gen_corpus, encode_bytes)
        assert serve.route_requests(stage, payloads, ingest="bytes",
                                    raw=raw) == want
        assert stage.stats["overlapped_batches"] == 1


def test_data_shards_report_per_axis_stats():
    """The twin of the JAX CLI's per-axis stats line: ``throughput()``
    after the pipelined route reports the placed mesh's axes, each data
    row's docs/s, each model position's queries and the overlapped
    batches."""
    stage, dtd = serve.build_stage(REPLICAS, batch_size=BATCH,
                                   data_shards=2, device="cpu")
    payloads, raw = _requests(dtd, gen_corpus, encode_bytes)
    assert serve.route_requests(stage, payloads, ingest="bytes",
                                raw=raw) == _reference_queues()
    tp = stage.throughput()
    assert (tp["mesh_data"], tp["mesh_model"]) == (1, 1)
    assert tp["docs"] == REQUESTS and tp["data_shards"] == 2
    assert tp["docs_per_s_per_data_shard"] == pytest.approx(tp["docs_per_s"])
    assert tp["queries_per_model_shard"] == 32
    assert tp["overlapped_batches"] == 1 and tp["put_s"] >= 0.0


def test_route_requests_helper_matches_stage_routing():
    """The CLI's routing helper on the 2-D stage (the pipelined bytes
    route) fans out to the queues of the JAX package's unsharded
    stage."""
    stage, dtd = serve.build_stage(REPLICAS, batch_size=BATCH,
                                   query_shards=2, data_shards=2,
                                   device="cpu")
    payloads, raw = _requests(dtd, gen_corpus, encode_bytes)
    got = serve.route_requests(stage, payloads, ingest="bytes", raw=raw)
    assert [len(q) for q in got] == [len(q) for q in _reference_queues()]
    assert got == _reference_queues()


# ------------------------------------------------------------------- main
MAIN_ARGS = ["--requests", str(REQUESTS), "--replicas", str(REPLICAS),
             "--batch", str(BATCH), "--prompt-len", "4", "--gen-len", "2"]


def _run(main, monkeypatch, capsys, extra) -> str:
    monkeypatch.setattr(sys, "argv", ["serve"] + MAIN_ARGS + list(extra))
    main()
    return capsys.readouterr().out


def _summary(out: str) -> tuple:
    """(replica queue sizes, churn deliveries, generated tokens) as
    printed; the timings vary and are not compared."""
    queues = re.search(r"→ \[([0-9, ]*)\] per replica", out)
    churn = re.search(r"re-routed (\d+) requests → (\d+) deliveries", out)
    gen = re.search(r"generated (\d+) tokens across (\d+) replicas", out)
    assert queues and churn and gen, f"missing a line in:\n{out}"
    return ([int(x) for x in queues.group(1).split(",")],
            tuple(map(int, churn.groups())), tuple(map(int, gen.groups())))


@pytest.fixture(scope="module")
def jax_main_summary():
    """The JAX ``main`` on the chip smoke's route, streaming over bytes."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", ["serve"] + MAIN_ARGS + [
            "--filter-engine", "streaming", "--ingest", "bytes"])
        jax_serve.main()
    return _summary(out.getvalue())


@pytest.mark.parametrize("extra", [
    ["--filter-engine", "streaming", "--ingest", "bytes"],
    ["--ingest", "bytes"],
    ["--query-shards", "2"],
    ["--arrival", "replay", "--rate", "2000"],
    ["--arrival", "burst", "--rate", "800", "--deadline-ms", "20",
     "--max-inflight", "4", "--queue-cap", "32"],
    ["--arrival", "poisson", "--rate", "4000", "--queue-cap", "2",
     "--overload", "block"],
], ids=["streaming-bytes", "bytes", "qshards", "replay", "burst", "block"])
def test_main_equals_jax_main(extra, monkeypatch, capsys, jax_main_summary):
    """Every flag set routes the deterministic workload to the same
    queues (nothing is shed), so each run prints the JAX run's queues,
    churn deliveries and token count."""
    out = _run(serve.main, monkeypatch, capsys, extra + ["--device", "cpu"])
    assert f"[serve] routed {REQUESTS} requests" in out
    assert _summary(out) == jax_main_summary
    queues, _, (n_tok, replicas) = jax_main_summary
    assert n_tok == 2 * sum(queues) and replicas == REPLICAS
    if "--arrival" in extra:
        assert f"{REQUESTS}/{REQUESTS} served" in out
        assert "shed 0 = 0.0%" in out


def test_main_latency_json(monkeypatch, capsys, tmp_path):
    path = tmp_path / "lat.json"
    _run(serve.main, monkeypatch, capsys,
         ["--arrival", "replay", "--rate", "2000", "--latency-json",
          str(path), "--device", "cpu"])
    data = json.loads(path.read_text())
    assert data["arrival"] == "replay"
    assert len(data["latencies_ms"]) == data["slo"]["completed"] == REQUESTS


def test_main_without_a_card_raises(monkeypatch, capsys):
    """No ``--device``: the card, which must be there; no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _run(serve.main, monkeypatch, capsys, [])


def test_main_flags_are_the_jax_flags_and_device():
    """The JAX CLI's flags one for one, and ``--device``."""
    import inspect

    def flags(fn):
        return set(re.findall(r'add_argument\("(--[a-z-]+)"',
                              inspect.getsource(fn)))

    assert flags(serve.main) == flags(jax_serve.main) | {"--device"}
