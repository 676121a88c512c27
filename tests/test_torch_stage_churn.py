"""Churn, poison and build safety of the port's stage and loop, on the CPU.

The counterparts of ``tests/test_faults.py``'s tests of pre-admission
validation, typed errors on routes, poison quarantine, loop accounting
and the shadow-plan hot swap, run on the port (``device="cpu"``) and held
against the JAX package at the same settings: the unsharded stage
(``query_shards=1``; the reference runs its swap tests on
``query_shards=2``), dense and ``sparse=True``.  Exact equality
throughout.  Then what the port adds: the query-sharded and 2-D stages
route as the JAX package's, and the kernel build is safe when threads
miss at the same time.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.dictionary import TagDictionary as JaxDictionary
from repro.core.events import encode_bytes as jax_encode
from repro.core.events import validate_payload as jax_validate
from repro.data.filter_stage import FilterStage as JaxStage
from repro.data.generator import DTD as JaxDTD
from repro.data.generator import gen_corpus as jax_corpus
from repro.data.generator import gen_profiles as jax_profiles
from repro.serve.loop import ServeLoop as JaxLoop
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import (DEFAULT_MAX_DEPTH, DepthOverflow,
                                     DocumentError, KernelFault,
                                     MalformedDocument, encode_bytes,
                                     validate_payload)
from repro_torch.data.filter_stage import (TEXT_FILL, FilterStage,
                                           PlanEpoch, StalePlanError)
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.kernels import build
from repro_torch.serve.loop import ServeLoop

ENGINE = "streaming"
N_QUERIES = 16
BATCH = 4
ROUTES = [{}, {"sparse": True}]
ROUTE_IDS = ["dense", "sparse"]


def _workload(n_docs=16, seed=0):
    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    profiles = gen_profiles(dtd, n=N_QUERIES, length=3, seed=seed)
    docs = gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=40, seed=1)
    raw = [encode_bytes(x, text_fill=TEXT_FILL) for x in docs]
    return profiles, d, dtd, raw


def _jax_workload(n_docs=16, seed=0):
    dtd = JaxDTD.generate(n_tags=24, seed=seed)
    d = JaxDictionary()
    dtd.register(d)
    profiles = jax_profiles(dtd, n=N_QUERIES, length=3, seed=seed)
    docs = jax_corpus(dtd, n_docs=n_docs, nodes_per_doc=40, seed=1)
    raw = [jax_encode(x, text_fill=TEXT_FILL) for x in docs]
    return profiles, d, dtd, raw


def _common(kw):
    kw = dict(kw)
    kw.setdefault("engine", ENGINE)
    kw.setdefault("keep_unmatched", True)
    kw.setdefault("batch_size", BATCH)
    return dict(n_shards=2, **kw)


def _stage(profiles, d, **kw):
    return FilterStage(profiles, d, device="cpu", **_common(kw))


def _jax_stage(profiles, d, **kw):
    return JaxStage(profiles, d, **_common(kw))


def _nested(d, depth):
    return (b"".join(d.open_bytes(0) for _ in range(depth))
            + b"".join(d.close_bytes(0) for _ in range(depth)))


def _routes(tickets):
    return {(rd.doc_index, rd.shard): tuple(int(x) for x in
                                            rd.matched_profiles)
            for t in tickets if not t.shed and not t.failed
            for rd in t.routed}


def _stage_routes(stage, raw):
    return {(r.doc_index, r.shard): tuple(int(x) for x in r.matched_profiles)
            for b in stage.route_bytes(raw) for r in b}


def _verdict_sets(routes: dict) -> dict:
    out: dict[int, list] = {}
    for (_, shard), matched in sorted(routes.items()):
        out.setdefault(shard, []).append(tuple(sorted(matched)))
    return {k: sorted(v) for k, v in out.items()}


# ------------------------------------------------------- error taxonomy
def _outcome(fn, buf, **kw):
    """(error type name, message) of ``fn(buf)``; ``(None, None)`` if valid."""
    try:
        fn(buf, **kw)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None, None


class TestValidatePayload:
    def _cases(self):
        _, d, _, raw = _workload()
        return d, raw

    @pytest.mark.parametrize("case", [
        "corpus", "empty", "unclosed", "close_without_open", "undecodable",
        "overdepth"])
    def test_same_verdict_as_jax(self, case):
        d, raw = self._cases()
        bufs = {"corpus": raw, "empty": [b""],
                "unclosed": [d.open_bytes(0)],
                "close_without_open": [d.close_bytes(0)],
                "undecodable": [b"<\xff\xff"],
                "overdepth": [_nested(d, DEFAULT_MAX_DEPTH + 1)]}[case]
        want_type = {"corpus": None, "empty": None,
                     "unclosed": "MalformedDocument",
                     "close_without_open": "MalformedDocument",
                     "undecodable": "MalformedDocument",
                     "overdepth": "DepthOverflow"}[case]
        for i, buf in enumerate(bufs):
            got = _outcome(validate_payload, buf, doc_index=i)
            assert got == _outcome(jax_validate, buf, doc_index=i)
            assert got[0] == want_type

    def test_messages(self):
        d, _ = self._cases()
        with pytest.raises(MalformedDocument, match="unclosed"):
            validate_payload(d.open_bytes(0))
        with pytest.raises(MalformedDocument, match="without matching"):
            validate_payload(d.close_bytes(0))
        with pytest.raises(MalformedDocument, match="undecodable"):
            validate_payload(b"<\xff\xff")
        with pytest.raises(DepthOverflow, match="max_depth") as ei:
            validate_payload(_nested(d, DEFAULT_MAX_DEPTH + 1), doc_index=3)
        assert ei.value.doc_indices == (3,)

    def test_taxonomy_is_value_error(self):
        assert issubclass(MalformedDocument, DocumentError)
        assert issubclass(DepthOverflow, DocumentError)
        assert issubclass(KernelFault, DocumentError)
        assert issubclass(DocumentError, ValueError)
        assert DepthOverflow("deep", (3, 5)).doc_indices == (3, 5)

    @pytest.mark.parametrize("depth", [1, 2, DEFAULT_MAX_DEPTH - 1,
                                       DEFAULT_MAX_DEPTH,
                                       DEFAULT_MAX_DEPTH + 1,
                                       2 * DEFAULT_MAX_DEPTH])
    def test_depth_boundary(self, depth):
        """Nesting validates iff it fits the parser's bounded stack, in
        both packages."""
        d, jd = TagDictionary(), JaxDictionary()
        d.add("a")
        jd.add("a")
        buf = _nested(d, depth)
        assert buf == _nested(jd, depth)
        got = _outcome(validate_payload, buf)
        assert got == _outcome(jax_validate, buf)
        assert got[0] == (None if depth <= DEFAULT_MAX_DEPTH
                          else "DepthOverflow")


# ------------------------------------------------- typed errors on routes
class TestTypedErrorsOnRoutes:
    def test_route_bytes_overdepth_raises_typed(self):
        """The parse route raises a typed ``DepthOverflow`` naming the
        offending batch row, as the JAX package's does."""
        profiles, d, _, raw = _workload(n_docs=BATCH)
        bad = raw[:2] + [_nested(d, DEFAULT_MAX_DEPTH + 16)] + raw[3:4]
        with pytest.raises(DepthOverflow) as ei:
            list(_stage(profiles, d, engine="levelwise").route_bytes(bad))
        jp, jd, _, jraw = _jax_workload(n_docs=BATCH)
        assert bad == jraw[:2] + [_nested(jd, DEFAULT_MAX_DEPTH + 16)] \
            + jraw[3:4]
        with pytest.raises(ValueError) as ej:
            list(_jax_stage(jp, jd, engine="levelwise").route_bytes(bad))
        assert type(ej.value).__name__ == "DepthOverflow"
        assert 2 in ei.value.doc_indices
        assert ei.value.doc_indices == ej.value.doc_indices

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_loop_rejects_poison(self, kw):
        """Malformed and over-depth payloads are rejected pre-admission
        with typed errors; the healthy co-submitted documents get the
        fault-free verdicts, the JAX loop's."""
        profiles, d, _, raw = _workload(n_docs=6)
        want = _stage_routes(_stage(profiles, d), raw)
        jp, jd, _, jraw = _jax_workload(n_docs=6)
        outs = []
        for loop_cls, stage, dd in (
                (ServeLoop, _stage(profiles, d, **kw), d),
                (JaxLoop, _jax_stage(jp, jd, **kw), jd)):
            loop = loop_cls(stage, max_batch=BATCH, deadline_ms=60_000,
                            queue_cap=64)
            with loop:
                bad_m = loop.submit(dd.open_bytes(0))
                bad_d = loop.submit(_nested(dd, DEFAULT_MAX_DEPTH + 1))
                tickets = [loop.submit(p) for p in raw]
            s = loop.slo_summary()
            outs.append((type(bad_m.error).__name__,
                         type(bad_d.error).__name__, bad_m.seq, bad_d.seq,
                         _routes(tickets), s["rejected"], s["quarantined"],
                         s["completed"],
                         [(r["seq"], r["error"]) for r in loop.dead_letter]))
        got, jax_got = outs
        assert got == jax_got
        assert got[:4] == ("MalformedDocument", "DepthOverflow", -1, -1)
        assert got[4] == want
        assert got[5:8] == (2, 2, len(raw)) and len(got[8]) == 2


# -------------------------------------------------- quarantine/bisection
class _Poisoner:
    """Make the stage's batch call raise an *untyped* error whenever a
    marked payload is present — the loop must bisect to find it."""

    def __init__(self, stage, poison: set):
        self.poison = poison
        self._orig = stage._filter_bytebatch
        stage._filter_bytebatch = self._filter

    def _filter(self, bufs, record=True, epoch=None):
        if any(b in self.poison for b in bufs):
            raise RuntimeError("poisoned batch")
        return self._orig(bufs, record=record, epoch=epoch)


class TestQuarantine:
    def _run(self, poison_at, kw, n_docs=8, jax=False):
        profiles, d, _, raw = (_jax_workload if jax else _workload)(
            n_docs=n_docs)
        make = _jax_stage if jax else _stage
        healthy = [i for i in range(n_docs) if i not in poison_at]
        want = _stage_routes(make(profiles, d), [raw[i] for i in healthy])
        marked = dict(enumerate(raw))
        for i in poison_at:
            marked[i] = raw[i] + d.open_bytes(1) + d.close_bytes(1)
        stage = make(profiles, d, **kw)
        _Poisoner(stage, {marked[i] for i in poison_at})
        loop = (JaxLoop if jax else ServeLoop)(
            stage, max_batch=BATCH, deadline_ms=60_000, queue_cap=64)
        with loop:
            tickets = [loop.submit(marked[i]) for i in range(n_docs)]
        return loop, tickets, healthy, want

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_single_poison_quarantined_as_kernel_fault(self, kw):
        loop, tickets, healthy, _ = self._run({2}, kw)
        t = tickets[2]
        assert t.failed and isinstance(t.error, KernelFault)
        assert t.error.doc_indices == (t.seq,)
        assert t.error.__cause__ is not None
        s = loop.slo_summary()
        assert s["quarantined"] == 1 and s["failed"] == 0
        assert s["retries"] >= 1
        recs = list(loop.dead_letter)
        assert len(recs) == 1 and recs[0]["error"] == "KernelFault"

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_healthy_verdicts_survive_quarantine(self, kw):
        loop, tickets, healthy, want = self._run({2}, kw)
        got = {(rd.doc_index, rd.shard): tuple(int(x) for x in
                                               rd.matched_profiles)
               for i in healthy for rd in tickets[i].routed}
        assert _verdict_sets(got) == _verdict_sets(want)

    @pytest.mark.parametrize("pos", [{0}, {3, 4}, {1, 5, 7}],
                             ids=["first", "pair", "three"])
    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_poison_subset_is_contained_as_in_jax(self, kw, pos):
        """Wherever the poison lands, the loop quarantines exactly those
        requests, completes the rest with fault-free verdicts, and ends
        with the JAX loop's tickets, dead letters and counters."""
        runs = [self._run(pos, kw, jax=jax) for jax in (False, True)]
        summaries = []
        for loop, tickets, healthy, want in runs:
            for i in pos:
                assert type(tickets[i].error).__name__ == "KernelFault"
            for i in healthy:
                assert not tickets[i].failed and tickets[i].routed is not None
            s = loop.slo_summary()
            assert s["quarantined"] == len(pos)
            assert s["arrived"] == (s["completed"] + s["shed"] + s["failed"]
                                    + s["quarantined"])
            summaries.append((
                [(t.seq, type(t.error).__name__) for t in tickets],
                _routes(tickets),
                [(r["seq"], r["error"]) for r in loop.dead_letter],
                {k: s[k] for k in ("completed", "quarantined", "retries",
                                   "batches")}))
        assert summaries[0] == summaries[1]


# ------------------------------------------------------------ accounting
class TestAccountingAndClose:
    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_accounting_closes_with_mixed_outcomes(self, kw):
        profiles, d, _, raw = _workload(n_docs=8)
        loop = ServeLoop(_stage(profiles, d, **kw), max_batch=BATCH,
                         deadline_ms=60_000, queue_cap=64)
        with loop:
            loop.submit(d.open_bytes(0))
            for p in raw:
                loop.submit(p)
        s = loop.slo_summary()
        assert s["arrived"] == s["admitted"] + s["shed"] + s["rejected"]
        assert s["arrived"] == (s["completed"] + s["shed"] + s["failed"]
                                + s["quarantined"])
        assert s["dead_letter_depth"] == 1

    def test_close_is_idempotent_and_reentrant(self):
        profiles, d, _, raw = _workload(n_docs=2)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=5, queue_cap=8)
        with loop:
            ts = [loop.submit(p) for p in raw]
        loop.close()
        loop.close()
        assert all(t.done.is_set() for t in ts)

    def test_concurrent_close_from_two_threads(self):
        profiles, d, _, raw = _workload(n_docs=2)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=5, queue_cap=8)
        for p in raw:
            loop.submit(p)
        t = threading.Thread(target=loop.close)
        t.start()
        loop.close()
        t.join(timeout=120)
        assert not t.is_alive()

    def test_submit_after_close_sheds(self):
        profiles, d, _, raw = _workload(n_docs=1)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=5, queue_cap=8)
        loop.close()
        t = loop.submit(raw[0])
        assert t.shed and t.done.is_set()

    def test_dead_letter_buffer_is_bounded(self):
        profiles, d, _, _ = _workload(n_docs=1)
        loop = ServeLoop(_stage(profiles, d), max_batch=BATCH,
                         deadline_ms=5, queue_cap=8, dead_letter_cap=3)
        with loop:
            for _ in range(10):
                loop.submit(d.open_bytes(0))
        assert len(loop.dead_letter) == 3
        assert loop.slo_summary()["rejected"] == 10


# ---------------------------------------------------- shadow-plan hot swap
class TestShadowSwap:
    """The hot-swap cases on the unsharded stage, each held against the
    JAX stage at the same settings (``query_shards=1``)."""

    def _pair(self, n_docs=16, **kw):
        profiles, d, dtd, raw = _workload(n_docs=n_docs)
        jp, jd, jdtd, jraw = _jax_workload(n_docs=n_docs)
        assert raw == jraw
        return ((_stage(profiles, d, **kw), dtd, raw),
                (_jax_stage(jp, jd, **kw), jdtd, jraw))

    def test_prepare_commit_subscribe(self):
        for stage, dtd, _ in self._pair():
            q = (gen_profiles if isinstance(stage, FilterStage)
                 else jax_profiles)(dtd, n=1, length=3, seed=50)[0]
            ep0 = stage.plan_epoch()
            pending = stage.prepare_subscribe(q)
            assert stage.plan_epoch().epoch == ep0.epoch  # not installed
            gid = stage.commit(pending)
            assert gid == N_QUERIES
            assert stage.plan_epoch().epoch == ep0.epoch + 1
            assert list(stage.plan_epoch().gids) == list(range(N_QUERIES + 1))
            assert stage.prepare_rebalance() is None
            assert stage.maybe_rebalance() is None

    def test_stale_prepare_raises_and_retry_succeeds(self):
        gids = []
        for stage, dtd, _ in self._pair():
            qa, qb = (gen_profiles if isinstance(stage, FilterStage)
                      else jax_profiles)(dtd, n=2, length=3, seed=51)
            pending = stage.prepare_subscribe(qa)
            stage.subscribe(qb)
            with pytest.raises(RuntimeError) as ei:
                stage.commit(pending)
            assert type(ei.value).__name__ == "StalePlanError"
            gid = stage.commit(stage.prepare_subscribe(qa))
            assert gid in stage.plan_epoch().gids
            gids.append((gid, list(stage.plan_epoch().gids)))
        assert isinstance(ei.value, RuntimeError)
        assert issubclass(StalePlanError, RuntimeError)
        assert gids[0] == gids[1]

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_epoch_pins_inflight_batch_plan(self, kw):
        """A batch filtered against an epoch-N snapshot fans out with
        epoch N's engine and gid table even after a swap commits."""
        outs = []
        for stage, dtd, raw in self._pair(n_docs=BATCH, **kw):
            want = _stage_routes(stage, raw)
            ep = stage.plan_epoch()
            if isinstance(stage, FilterStage):
                assert isinstance(ep, PlanEpoch)
            stage.subscribe((gen_profiles if isinstance(stage, FilterStage)
                             else jax_profiles)(dtd, n=1, length=3,
                                                seed=52)[0])
            stage.unsubscribe(0)
            assert stage.plan_epoch().epoch == ep.epoch + 2
            res = stage._filter_bytebatch(raw, record=False, epoch=ep)
            routed = stage._fan_out(res, [len(p) for p in raw],
                                    gids=ep.gids)
            got = {(r.doc_index, r.shard): tuple(int(x) for x in
                                                 r.matched_profiles)
                   for r in routed}
            assert got == want
            assert np.array_equal(np.sort(np.asarray(ep.gids)),
                                  np.arange(N_QUERIES))
            outs.append((got, _stage_routes(stage, raw),
                         list(stage.plan_epoch().gids)))
        assert outs[0] == outs[1]
        assert 0 not in outs[0][2] and N_QUERIES in outs[0][2]

    @pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
    def test_loop_subscribe_swaps_without_drain(self, kw):
        """A live subscribe through the loop commits while the loop keeps
        serving; later documents are routed with the new profile, as the
        JAX loop routes them."""
        outs = []
        for stage, dtd, raw in self._pair(n_docs=12, **kw):
            port = isinstance(stage, FilterStage)
            # a copy of the profile that matches most documents after the
            # swap, so that the new gid must show in the routes
            hits = np.bincount(np.concatenate(
                [m for (doc, _), m in _stage_routes(stage, raw).items()
                 if doc >= BATCH]).astype(np.int64), minlength=N_QUERIES)
            q = stage.profiles[int(np.argmax(hits))]
            loop = (ServeLoop if port else JaxLoop)(
                stage, max_batch=BATCH, deadline_ms=60_000, queue_cap=64)
            with loop:
                pre = [loop.submit(p) for p in raw[:BATCH]]
                tk = loop.subscribe(q)
                assert tk.done.wait(timeout=120)
                post = [loop.submit(p) for p in raw[BATCH:]]
            assert tk.error is None and tk.gid == N_QUERIES
            sw = loop.swap_summary()
            assert loop.slo_summary()["swaps"] == 1
            assert sw["swaps"] == 1 and sw["swap_rollbacks"] == 0
            assert np.isfinite(sw["commit_p50_ms"])
            for t in pre:
                for rd in t.routed:
                    assert all(int(x) < N_QUERIES
                               for x in np.asarray(rd.matched_profiles))
            assert all(not t.failed for t in pre + post)
            outs.append(_routes(post))
        assert outs[0] == outs[1]
        assert any(N_QUERIES in m for m in outs[0].values())

    def test_failed_shadow_build_rolls_back(self):
        """A prepare that raises leaves the serving plan untouched and
        surfaces the error on the ticket — never kills the loop."""
        profiles, d, dtd, raw = _workload(n_docs=8)
        stage = _stage(profiles, d)
        ep0 = stage.plan_epoch()
        orig = stage.prepare_subscribe
        stage.prepare_subscribe = lambda q: (_ for _ in ()).throw(
            RuntimeError("shadow build exploded"))
        loop = ServeLoop(stage, max_batch=BATCH, deadline_ms=60_000,
                         queue_cap=64)
        with loop:
            tk = loop.subscribe(gen_profiles(dtd, n=1, length=3,
                                             seed=54)[0])
            assert tk.done.wait(timeout=120)
            assert tk.error is not None
            assert "shadow build exploded" in str(tk.error)
            stage.prepare_subscribe = orig
            tickets = [loop.submit(p) for p in raw]
        assert all(not t.failed for t in tickets)
        s = loop.slo_summary()
        assert s["swap_rollbacks"] == 1 and s["swaps"] == 0
        assert s["completed"] == len(raw)
        assert stage.plan_epoch().epoch == ep0.epoch
        assert stage.plan_epoch().eng is ep0.eng
        assert _routes(tickets) == _stage_routes(_stage(profiles, d), raw)


# ------------------------------------------------------- the 2-D stage
@pytest.mark.parametrize("kw", [{"data_shards": 2},
                                {"query_shards": 2, "data_shards": 2}],
                         ids=["data", "both"])
def test_data_sharded_stage_routes_as_jax(kw):
    """A stage with a data axis runs the 2-D path (here over a 2 x 2 grid
    of the CPU device, or 2 x 1 with one part): its routes equal the JAX
    package's unsharded stage, dense and sparse, before and after the
    same churn."""
    from repro_torch.launch.mesh import FilterMesh

    profiles, d, dtd, raw = _workload(n_docs=8)
    jprofiles, jd, jdtd, jraw = _jax_workload(n_docs=8)
    model = kw.get("query_shards", 1)
    mesh = FilterMesh([["cpu"] * model for _ in range(2)])
    want = _stage_routes(_jax_stage(jprofiles, jd), jraw)
    for route in ROUTES:
        stage = _stage(profiles, d, mesh=mesh, **route, **kw)
        assert stage.sharded_.n_parts == model
        assert want and _stage_routes(stage, raw) == want
    jstage = _jax_stage(jprofiles, jd)
    for st, g in ((stage, gen_profiles), (jstage, jax_profiles)):
        st.subscribe(g(dtd if st is stage else jdtd, n=1, length=3,
                       seed=57)[0])
        st.unsubscribe(3)
    assert _stage_routes(stage, raw) == _stage_routes(jstage, jraw)


@pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
def test_query_sharded_stage_routes_as_jax(kw):
    """A query-sharded stage (``query_shards=2``) is ported: its routes
    equal the JAX package's sharded stage (dense) and the unsharded
    stage's, dense and ``sparse=True``, before and after churn."""
    profiles, d, dtd, raw = _workload(n_docs=8)
    jprofiles, jd, jdtd, jraw = _jax_workload(n_docs=8)
    stage = _stage(profiles, d, query_shards=2, **kw)
    want = _stage_routes(_jax_stage(jprofiles, jd, query_shards=2), jraw)
    assert want and _stage_routes(stage, raw) == want
    assert _stage_routes(_stage(profiles, d), raw) == want
    jstage = _jax_stage(jprofiles, jd, query_shards=2)
    for st, g in ((stage, gen_profiles), (jstage, jax_profiles)):
        st.subscribe(g(dtd if st is stage else jdtd, n=1, length=3,
                       seed=57)[0])
        st.unsubscribe(3)
    assert _stage_routes(stage, raw) == _stage_routes(jstage, jraw)


# ------------------------------------------------------------ kernel build
def test_build_is_safe_when_threads_miss_together(tmp_path, monkeypatch):
    """Eight threads build every source at once into an empty build
    directory: exactly one compile runs per source, every thread gets the
    same library paths, and no temporary file is left behind."""
    log = tmp_path / "compiles.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=\"\"\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = \"-o\" ]; then out=\"$2\"; fi\n"
        "  shift\n"
        "done\n"
        f"echo \"$out\" >> {log}\n"
        "sleep 0.2\n"
        "echo built > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    start = threading.Barrier(8)
    got, errors = [], []

    def worker():
        try:
            start.wait(timeout=60)
            got.append(build.build())
        except Exception as e:  # reported below, with the thread's error
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 8 and all(g == got[0] for g in got)
    compiles = log.read_text().split()
    assert len(compiles) == len(build.SIGNATURES)
    assert all(".tmp" in c for c in compiles)
    assert sorted(p.name for p in (tmp_path / "lib").iterdir()
                  if p.suffix == ".so") == sorted(p.name
                                                  for p in got[0].values())
    assert not list((tmp_path / "lib").glob("*.tmp"))


# ------------------------------------------------- state shared by workers
def test_launch_counts_lose_nothing_under_threads():
    """The serve loop's workers count launches at the same time; with the
    interpreter switching threads as often as it can, 16 threads of
    2,000 counts each must add up exactly."""
    import sys

    from repro_torch.kernels.launches import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    start = threading.Barrier(16)

    def worker():
        start.wait(timeout=60)
        for _ in range(2000):
            count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000


def test_lane_memo_is_built_once_per_plan_under_threads():
    """Workers that miss the lane-class memo at the same time all get the
    one table that was kept, equal to a fresh build."""
    import sys

    profiles, d, _, _ = _workload(n_docs=1)
    stage = _stage(profiles, d, sparse=True)
    eng = stage.plan_epoch().eng
    start = threading.Barrier(12)
    got = []

    def worker():
        start.wait(timeout=60)
        got.append(eng._plain_lane_tables(eng.plan_))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 12 and all(g is got[0] for g in got)
    assert len(eng._lane_cache) == 1
    lane_cls, offsets, members = got[0]
    eng._lane_cache.clear()
    fresh = eng._plain_lane_tables(eng.plan_)
    assert torch.equal(fresh[0], lane_cls)
    np.testing.assert_array_equal(fresh[1], offsets)
    np.testing.assert_array_equal(fresh[2], members)
