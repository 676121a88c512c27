"""The port's serving-CLI routing layer against the JAX package's.

``repro_torch.launch.serve``'s ``build_stage``, ``route_requests`` and
``serve_continuous`` (``device="cpu"``) against the same functions of
``repro.launch.serve`` on the CLI's deterministic workload (seed 0
profiles, seed 1 corpus): at ``data_shards=1``, with ``query_shards`` 1
and 2, ingest ``events`` and ``bytes``, the replica queues are equal, and
the continuous loop on a ``replay`` trace delivers the same queues with
nothing shed.  The JAX CLI's ``main`` generates with the LM substrate
(ROADMAP item 14) and gets no twin; ``data_shards > 1`` raises (item 13).
Exact equality.
"""
import json
from types import SimpleNamespace

import pytest

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


def test_data_shards_raise_through_the_stage():
    with pytest.raises(NotImplementedError, match="item 13"):
        serve.build_stage(REPLICAS, query_shards=2, data_shards=2,
                          device="cpu")
