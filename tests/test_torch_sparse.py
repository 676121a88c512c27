"""Sparse delivery of the port against the JAX package's, on the CPU.

Kernel level: K4 and K3's plain versions (K1/K2's plain versions, then
the plain epilogue) against ``stream_filter_pallas_sparse`` and
``stream_filter_bytes_pallas_sparse`` in interpret mode, on the same
tables, events, bytes and accept classes.  On the CPU the rows come in
the TPU grid's order, so the whole ``(cap, 3)`` buffer and the count are
compared, under and over the cap, for packed segments with empty slots.
Engine level: ``SparseResult`` (rows, ``overflowed``, ``meta["path"]``,
``attempted_path``, ``device_rows``) against the JAX engine with its
megakernels (``kernel="pallas"``, interpreted), over caps around the true
row count and for every ``sparse_epilogue`` mode.  Stage level:
``FilterStage(sparse=True)`` routes as the JAX stage and as the dense
stage do.  Exact equality throughout.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_stream_filter import (KB, fused, jax_kernel_plan,  # noqa: E402
                                      port_plan, ragged_bb, workload)

from repro.core import engines as jax_engines  # noqa: E402
from repro.core.engines import streaming as jax_streaming  # noqa: E402
from repro.core.events import (ByteBatch, EventBatch,  # noqa: E402
                               encode_bytes, pack_segments)
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.data.generator import gen_corpus  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import stream_filter as jax_sf  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.engines import base  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import stream_filter as sf  # noqa: E402

KERNEL_OPTS = dict(kernel="pallas", kernel_interpret=True)


def port_batch(batch):
    return tev.EventBatch(batch.kind, batch.tag_id, batch.depth,
                          batch.parent, batch.valid, batch.n_events)


def port_bytes(bb):
    return tev.ByteBatch(np.asarray(bb.data), np.asarray(bb.n_bytes))


def lane_classes(jplan):
    return jax_streaming._lane_classes(jplan)[1]


def dense_heavy(seed=1, n_queries=24):
    """Profiles with many descendant steps, so several lanes hit."""
    return workload(n_queries=n_queries, seed=seed, p_desc=0.6, length=3)


# ------------------------------------------------------- K4 and K3 plain
class TestEpilogueKernels:
    @pytest.mark.parametrize("cap_of", [lambda n: n + 7, lambda n: n,
                                        lambda n: n // 2, lambda n: 1])
    def test_event_epilogue_equals_pallas(self, cap_of):
        dtd, d, qs, nfa = dense_heavy(seed=1)
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        plan = port_plan(jplan)
        lane_cls = lane_classes(jplan)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=30, seed=1)
        ev = fused(EventBatch.from_streams(docs, bucket=32))
        doc_ids = np.array([[0], [-1], [2], [3]], np.int32)  # row 1 dropped
        n = int(sf.stream_filter_sparse(
            torch.from_numpy(ev), torch.from_numpy(doc_ids),
            *(plan[k] for k in KB), torch.from_numpy(lane_cls),
            cap=10 ** 6, max_depth=64)[1][0])
        assert n > 4, "workload must emit a few rows"
        cap = cap_of(n)
        jb, jc = jax_sf.stream_filter_pallas_sparse(
            ev, jnp.asarray(doc_ids), *(jplan[k] for k in KB),
            jnp.asarray(lane_cls), cap=cap, max_depth=64, chunk=32,
            interpret=True)
        tb, tc = sf.stream_filter_sparse(
            torch.from_numpy(ev), torch.from_numpy(doc_ids),
            *(plan[k] for k in KB), torch.from_numpy(lane_cls), cap=cap,
            max_depth=64)
        assert tb.shape == (cap, 3) and tc.shape == (1,)
        assert int(tc[0]) == int(np.asarray(jc).reshape(-1)[0]) == n
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[:cap])

    @pytest.mark.parametrize("pack,cap", [(False, 500), (True, 500),
                                          (True, 3)])
    def test_bytes_epilogue_equals_pallas(self, pack, cap):
        """Unpacked, and packed with empty (-1) slots, a single-event doc
        and a doc longer than the segment; the last case overflows."""
        dtd, d, qs, nfa = dense_heavy(seed=3)
        jplan = jax_kernel_plan(nfa, d, blk=32, chunk=32)
        plan = port_plan(jplan)
        lane_cls = lane_classes(jplan)
        bb = ragged_bb(dtd, d, 3)
        if pack:
            sp = pack_segments(bb, target_len=256)
            assert (sp.doc_ids < 0).any()
            data, starts, doc_map = sp.data, sp.starts, sp.doc_ids
        else:
            data = np.asarray(bb.data)
            starts = np.full((bb.batch_size, 2), 2 ** 31 - 1, np.int32)
            starts[:, 0] = 0
            doc_map = np.arange(bb.batch_size, dtype=np.int32)[:, None]
        jb, jc = jax_sf.stream_filter_bytes_pallas_sparse(
            data, starts, doc_map, *(jplan[k] for k in KB),
            jnp.asarray(lane_cls), cap=cap, max_depth=64, chunk=64,
            interpret=True)
        tb, tc = sf.stream_filter_bytes_sparse(
            *map(torch.from_numpy, (data, starts, doc_map)),
            *(plan[k] for k in KB), torch.from_numpy(lane_cls), cap=cap,
            max_depth=64)
        count = int(np.asarray(jc).reshape(-1)[0])
        assert count > 3
        assert int(tc[0]) == count
        assert (count > cap) == (cap == 3)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[:cap])

    def test_plain_epilogue_equals_jax_ref(self):
        """The epilogue alone, on the same dense lanes, against the JAX
        package's block-level oracle, mid-overflow included."""
        rng = np.random.default_rng(5)
        matched = (rng.random((3, 4, 2, 16)) < 0.3).astype(np.int32)
        first = rng.integers(0, 50, size=matched.shape).astype(np.int32)
        lane_cls = rng.integers(-1, 9, size=(4, 16)).astype(np.int32)
        doc_ids = np.array([[0, 1], [2, -1], [-1, -1]], np.int32)
        for cap in (1000, 17, 1):
            rows, count = jax_ref.sparse_epilogue(matched, first, lane_cls,
                                                  doc_ids, cap)
            buf, cnt = ref.sparse_epilogue(
                *map(torch.from_numpy, (matched, first, lane_cls, doc_ids)),
                cap)
            assert int(cnt[0]) == count
            np.testing.assert_array_equal(buf.numpy()[:len(rows)], rows)
            assert (buf.numpy()[len(rows):] == [-1, -1, 2 ** 31 - 1]).all()

    def test_wrappers_check_inputs_and_count_nothing_on_cpu(self):
        dtd, d, qs, nfa = workload(n_queries=8, seed=12)
        plan = engines.create("streaming", nfa, dictionary=d,
                              device="cpu").plan_
        tables = [plan[k] for k in KB]
        g, qb = tables[5].shape
        lane_cls = torch.zeros((g, qb), dtype=torch.int32)
        ev = torch.zeros((2, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="doc_ids"):
            sf.stream_filter_sparse(ev, torch.zeros((2, 2), dtype=torch.int32),
                                    *tables, lane_cls, cap=4, max_depth=4)
        with pytest.raises(ValueError, match="lane_cls"):
            sf.stream_filter_sparse(ev, torch.zeros((2, 1), dtype=torch.int32),
                                    *tables, lane_cls[:, :1], cap=4,
                                    max_depth=4)
        with pytest.raises(ValueError, match="cap"):
            sf.stream_filter_sparse(ev, torch.zeros((2, 1), dtype=torch.int32),
                                    *tables, lane_cls, cap=0, max_depth=4)
        k3, k4 = (sf.stream_filter_bytes_sparse.launches,
                  sf.stream_filter_sparse.launches)
        sf.stream_filter_sparse(ev, torch.zeros((2, 1), dtype=torch.int32),
                                *tables, lane_cls, cap=4, max_depth=4)
        starts = torch.tensor([[0, 2 ** 31 - 1]], dtype=torch.int32)
        sf.stream_filter_bytes_sparse(
            torch.zeros((1, 16), dtype=torch.uint8), starts,
            torch.zeros((1, 1), dtype=torch.int32), *tables, lane_cls,
            cap=4, max_depth=4)
        assert (sf.stream_filter_bytes_sparse.launches,
                sf.stream_filter_sparse.launches) == (k3, k4)


# ------------------------------------------------------------- engine
def assert_sparse_equal(jax_sp, port_sp):
    np.testing.assert_array_equal(port_sp.doc_ids, jax_sp.doc_ids)
    np.testing.assert_array_equal(port_sp.query_ids, jax_sp.query_ids)
    np.testing.assert_array_equal(port_sp.first_event, jax_sp.first_event)
    assert port_sp.overflowed == jax_sp.overflowed
    assert (port_sp.batch_size, port_sp.n_queries) \
        == (jax_sp.batch_size, jax_sp.n_queries)
    for key in ("path", "attempted_path", "device_rows", "match_cap",
                "launch"):
        assert port_sp.meta.get(key) == jax_sp.meta.get(key), key


def engine_pair(nfa, d, **kw):
    jax_eng = jax_engines.create("streaming", nfa, dictionary=d,
                                 **KERNEL_OPTS, **kw)
    port = engines.create("streaming", nfa, dictionary=d, device="cpu",
                          **kw)
    return jax_eng, port


class TestEngineSparse:
    @pytest.mark.parametrize("route", ["events", "bytes", "bytes-packed"])
    def test_cap_sweep_equals_jax_engine(self, route):
        """Caps at, above and below the true row count: the fused path,
        then dense overflow naming the path it tried (the cases of
        tests/test_sparse_epilogue.py's sweep)."""
        dtd, d, qs, nfa = dense_heavy(seed=2, n_queries=20)
        docs = gen_corpus(dtd, n_docs=5, nodes_per_doc=40, seed=2)
        batch = EventBatch.from_streams(docs, bucket=64)
        bb = ByteBatch.from_streams(docs, text_fill=2, bucket=256)
        jax_eng, port = engine_pair(nfa, d, blk=32, segment_target=512)

        def run(eng, cap, host):
            if route == "events":
                return eng.filter_batch_sparse(
                    batch if host else port_batch(batch), match_cap=cap)
            return eng.filter_bytes_sparse(
                bb if host else port_bytes(bb), match_cap=cap,
                pack=route == "bytes-packed")

        n = run(port, None, False).meta["device_rows"]
        assert n > 2, "workload must produce a few device rows"
        for cap in (n + 1, n, n - 1):
            want, got = run(jax_eng, cap, True), run(port, cap, False)
            assert got.meta["path"] == ("dense-overflow" if cap < n
                                        else "kernel-fused")
            assert_sparse_equal(want, got)
        dense = port.filter_batch(port_batch(batch))
        np.testing.assert_array_equal(got.densify().matched, dense.matched)
        np.testing.assert_array_equal(got.densify().first_event,
                                      dense.first_event)

    @pytest.mark.parametrize("mode", ["on", "off"])
    @pytest.mark.parametrize("ingest", ["events", "bytes"])
    def test_sparse_epilogue_modes_equal_jax_engine(self, mode, ingest):
        """``"off"`` compacts K1's lanes (``lane-compact``); on bytes it
        parses on the device first (K5), as the JAX engine does for caps
        past the epilogue budget."""
        dtd, d, qs, nfa = dense_heavy(seed=4, n_queries=16)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=30, seed=4)
        jax_eng, port = engine_pair(nfa, d, blk=32, sparse_epilogue=mode)
        if ingest == "events":
            batch = EventBatch.from_streams(docs, bucket=64)
            want = jax_eng.filter_batch_sparse(batch)
            got = port.filter_batch_sparse(port_batch(batch))
        else:
            bb = ByteBatch.from_streams(docs, text_fill=1, bucket=128)
            want = jax_eng.filter_bytes_sparse(bb, bucket=32)
            got = port.filter_bytes_sparse(port_bytes(bb), bucket=32)
        assert got.meta["path"] == ("kernel-fused" if mode == "on"
                                    else "lane-compact")
        assert got.n_matches > 0
        assert_sparse_equal(want, got)

    def test_lane_compact_overflow_equals_jax_engine(self):
        dtd, d, qs, nfa = dense_heavy(seed=4, n_queries=16)
        docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=30, seed=4)
        batch = EventBatch.from_streams(docs, bucket=64)
        jax_eng, port = engine_pair(nfa, d, blk=32, sparse_epilogue="off")
        want = jax_eng.filter_batch_sparse(batch, match_cap=2)
        got = port.filter_batch_sparse(port_batch(batch), match_cap=2)
        assert got.meta["attempted_path"] == "lane-compact"
        assert_sparse_equal(want, got)

    def test_bogus_sparse_epilogue_raises_like_jax(self):
        dtd, d, qs, nfa = workload(n_queries=8, seed=4)
        batch = EventBatch.from_streams(
            gen_corpus(dtd, n_docs=2, nodes_per_doc=10, seed=4), bucket=32)
        jax_eng, port = engine_pair(nfa, d, sparse_epilogue="bogus")
        with pytest.raises(ValueError, match="sparse_epilogue"):
            jax_eng.filter_batch_sparse(batch)
        with pytest.raises(ValueError, match="sparse_epilogue"):
            port.filter_batch_sparse(port_batch(batch))

    def test_match_cap_resolution_equals_jax_engine(self):
        dtd, d, qs, nfa = workload(n_queries=8, seed=6)
        jax_eng, port = engine_pair(nfa, d, match_cap=5)
        plain_jax, plain = engine_pair(nfa, d)
        for b, q, cap in ((4, 8, None), (4, 8, 3), (1, 2, 50), (300, 8, None)):
            assert port.match_cap(b, q, cap) == jax_eng.match_cap(b, q, cap)
            assert plain.match_cap(b, q, cap) \
                == plain_jax.match_cap(b, q, cap)
        assert port._fused_sparse_ok(1024) and not port._fused_sparse_ok(10 ** 7)

    def test_base_device_compact_equals_jax_base(self):
        """The base class's dense-verdict compaction (reached by the JAX
        scan engine as ``base_path="device-compact"``), with and without
        overflow."""
        dtd, d, qs, nfa = dense_heavy(seed=7, n_queries=12)
        batch = EventBatch.from_streams(
            gen_corpus(dtd, n_docs=4, nodes_per_doc=30, seed=7), bucket=64)
        scan = jax_engines.create("streaming", nfa, dictionary=d,
                                  kernel="scan")
        port = engines.create("streaming", nfa, dictionary=d, device="cpu")
        for cap in (None, 3):
            want = scan.filter_batch_sparse(batch, match_cap=cap)
            got = base.FilterEngine.filter_batch_sparse(
                port, port_batch(batch), match_cap=cap)
            assert got.meta["path"] == want.meta["base_path"] \
                == ("device-compact" if cap is None else "dense-overflow")
            for k in ("doc_ids", "query_ids", "first_event"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k))
            assert got.overflowed == want.overflowed


# -------------------------------------------------------------- stage
class TestSparseStage:
    def _payloads(self, dtd, seed):
        docs = gen_corpus(dtd, n_docs=7, nodes_per_doc=40, seed=seed)
        return docs, ([encode_bytes(x, text_fill=8) for x in docs] + [b""]
                      + [encode_bytes(docs[0], text_fill=1)])

    @staticmethod
    def flat(routed):
        return [(r.doc_index, r.shard, r.nbytes, tuple(r.matched_profiles),
                 r.matched_profiles.dtype)
                for batch in routed for r in batch]

    @pytest.mark.parametrize("ingest,opts", [
        ("bytes", {}), ("bytes", {"pack": True, "match_cap": 4}),
        ("events", {}), ("events", {"match_cap": 4})])
    def test_sparse_stage_routes_as_jax_and_dense(self, ingest, opts):
        dtd, d, qs, nfa = workload(n_queries=32, seed=4)
        docs, payloads = self._payloads(dtd, 4)
        common = dict(profiles=list(qs), dictionary=d, n_shards=3,
                      batch_size=4, engine="streaming")
        jax_stage = JaxStage(sparse=True, **common)
        stage = FilterStage(device="cpu", sparse=True, engine_options=opts,
                            **common)
        dense = FilterStage(device="cpu", **common)
        if ingest == "bytes":
            want = list(jax_stage.route_bytes(payloads))
            got = list(stage.route_bytes(payloads))
            plain = list(dense.route_bytes(payloads))
        else:
            streams = [tev.EventStream(x.kind, x.tag_id) for x in docs]
            want = list(jax_stage.route(docs))
            got = list(stage.route(streams))
            plain = list(dense.route(streams))
        assert self.flat(got) and self.flat(got) == self.flat(want) \
            == self.flat(plain)
        s, js = stage.throughput(), jax_stage.throughput()
        assert s["selectivity"] == js["selectivity"]
        assert stage.stats["verdict_bytes"] == jax_stage.stats["verdict_bytes"]
        assert stage.stats["verdict_bytes"] \
            < dense.stats["verdict_bytes"]
