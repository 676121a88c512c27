"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no card is visible, so collection is the same on every machine.  On a
machine with an H100 and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

The first test builds the kernels (``build/repro_torch/``).  Outputs are
0/1 lanes, int32 ordinals and int32 match rows: exact equality, with the
sparse kernels' rows compared as sorted sets (their order on the card is
not fixed) and their counts exactly.  The file imports nothing of JAX, so
it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import BLOCK_TABLES
from repro_torch.core import engines
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import (SEG_SENTINEL, ByteBatch, EventBatch,
                                     encode_bytes, pack_segments)
from repro_torch.core.nfa import compile_queries
from repro_torch.data.generator import DTD, gen_corpus, gen_profiles
from repro_torch.kernels import parse
from repro_torch.kernels import predecode as pd
from repro_torch.kernels import stream_filter as sf

pytestmark = pytest.mark.gpu

KB = BLOCK_TABLES[:7]          # the tables the kernels read


def one_doc_starts(n):
    starts = np.full((n, 2), SEG_SENTINEL, np.int32)
    starts[:, 0] = 0
    return starts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def workload(n_queries, seed, n_tags=24):
    dtd = DTD.generate(n_tags=n_tags, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=n_queries, length=5, p_desc=0.4, p_wild=0.1,
                      seed=seed)
    return dtd, d, compile_queries(qs, d, shared=True)


def plans(nfa, d, cuda, **kw):
    cpu = engines.create("streaming", nfa, dictionary=d, device="cpu", **kw)
    gpu = engines.create("streaming", nfa, dictionary=d, device=cuda, **kw)
    return cpu, gpu


@pytest.mark.parametrize("blk", [32, 256, 2048])
def test_event_kernel_equals_plain(cuda, blk):
    dtd, d, nfa = workload(200, seed=1)
    cpu, gpu = plans(nfa, d, cuda, blk=blk)
    docs = gen_corpus(dtd, n_docs=6, nodes_per_doc=150, seed=1)
    batch = EventBatch.from_streams(docs, bucket=64)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id))
    before = sf.stream_filter.launches
    km, kf = sf.stream_filter(events.to(cuda),
                              *(gpu.plan_[k] for k in KB), max_depth=64)
    torch.cuda.synchronize()
    assert sf.stream_filter.launches == before + 1
    pm, pf = sf.stream_filter(events, *(cpu.plan_[k] for k in KB),
                              max_depth=64)
    assert pm.any()
    assert torch.equal(km.cpu(), pm) and torch.equal(kf.cpu(), pf)


@pytest.mark.parametrize("pack", [False, True])
def test_bytes_kernel_equals_plain(cuda, pack):
    dtd, d, nfa = workload(200, seed=2)
    cpu, gpu = plans(nfa, d, cuda, blk=64)
    docs = gen_corpus(dtd, n_docs=9, nodes_per_doc=60, seed=2)
    bufs = [encode_bytes(x, text_fill=5) for x in docs] + [b""]
    bb = ByteBatch.from_buffers(bufs, bucket=256)
    if pack:
        sp = pack_segments(bb, target_len=512)
        data, starts = sp.data, sp.starts
    else:
        data, starts = bb.data, one_doc_starts(bb.batch_size)
    data, starts = torch.from_numpy(data), torch.from_numpy(starts)
    before = sf.stream_filter_bytes.launches
    km, kf = sf.stream_filter_bytes(data.to(cuda), starts.to(cuda),
                                    *(gpu.plan_[k] for k in KB),
                                    max_depth=64)
    torch.cuda.synchronize()
    assert sf.stream_filter_bytes.launches == before + 1
    pm, pf = sf.stream_filter_bytes(data, starts,
                                    *(cpu.plan_[k] for k in KB),
                                    max_depth=64)
    assert pm.any()
    assert torch.equal(km.cpu(), pm) and torch.equal(kf.cpu(), pf)


def test_engine_on_card_equals_engine_on_cpu(cuda):
    dtd, d, nfa = workload(300, seed=3)
    cpu, gpu = plans(nfa, d, cuda, max_depth=5)
    docs = gen_corpus(dtd, n_docs=5, nodes_per_doc=80, seed=3)
    batch = EventBatch.from_streams(docs, bucket=64)
    bb = ByteBatch.from_streams(docs, text_fill=8, bucket=1024)
    for a, b in ((cpu.filter_batch(batch), gpu.filter_batch(batch)),
                 (cpu.filter_bytes(bb), gpu.filter_bytes(bb)),
                 (cpu.filter_bytes(bb, pack=True),
                  gpu.filter_bytes(bb, pack=True))):
        np.testing.assert_array_equal(b.matched, a.matched)
        np.testing.assert_array_equal(b.first_event, a.first_event)


def test_oversized_block_is_refused_with_sizes(cuda):
    dtd, d, nfa = workload(20, seed=4, n_tags=24)
    gpu = engines.create("streaming", nfa, dictionary=d, device=cuda)
    tables = [gpu.plan_[k] for k in KB]
    with pytest.raises(ValueError, match="shared memory"):
        sf.stream_filter(torch.zeros((1, 4), dtype=torch.int32,
                                     device=cuda), *tables, max_depth=60000)


def sorted_rows(buf, count, cap):
    rows = buf[:min(int(count[0]), cap)].cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def lane_classes(eng, cuda):
    return eng._plain_lane_tables(eng.plan_)[0].to(cuda)


@pytest.mark.parametrize("cap_of", [lambda n: n + 5, lambda n: n,
                                    lambda n: n // 3])
def test_event_sparse_kernel_equals_plain(cuda, cap_of):
    dtd, d, nfa = workload(200, seed=5)
    cpu, gpu = plans(nfa, d, cuda, blk=256)
    docs = gen_corpus(dtd, n_docs=7, nodes_per_doc=120, seed=5)
    batch = EventBatch.from_streams(docs, bucket=64)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id))
    doc_ids = torch.arange(7, dtype=torch.int32)[:, None]
    doc_ids[3] = -1                                  # a row that emits nothing
    lane_cls = lane_classes(cpu, "cpu")
    full_b, full_n = sf.stream_filter_sparse(
        events, doc_ids, *(cpu.plan_[k] for k in KB), lane_cls,
        cap=10 ** 6, max_depth=64)
    n = int(full_n[0])
    assert n > 10
    cap = cap_of(n)
    before = sf.stream_filter_sparse.launches
    kb, kn = sf.stream_filter_sparse(
        events.to(cuda), doc_ids.to(cuda), *(gpu.plan_[k] for k in KB),
        lane_cls.to(cuda), cap=cap, max_depth=64)
    torch.cuda.synchronize()
    assert sf.stream_filter_sparse.launches == before + 1
    assert int(kn[0]) == n
    if cap >= n:
        np.testing.assert_array_equal(sorted_rows(kb, kn, cap),
                                      sorted_rows(full_b, full_n, 10 ** 6))
        assert (kb[n:].cpu().numpy() == [-1, -1, 2 ** 31 - 1]).all()
    else:          # overflow: any cap of the true rows, each one real
        got = {tuple(r) for r in kb.cpu().numpy()}
        assert len(got) == cap
        assert got <= {tuple(r) for r in full_b[:n].numpy()}


@pytest.mark.parametrize("pack,cap", [(False, 4000), (True, 4000),
                                      (True, 7)])
def test_bytes_sparse_kernel_equals_plain(cuda, pack, cap):
    dtd, d, nfa = workload(200, seed=6)
    cpu, gpu = plans(nfa, d, cuda, blk=64)
    docs = gen_corpus(dtd, n_docs=9, nodes_per_doc=60, seed=6)
    bufs = [encode_bytes(x, text_fill=5) for x in docs] + [b""]
    bb = ByteBatch.from_buffers(bufs, bucket=256)
    if pack:
        sp = pack_segments(bb, target_len=512)
        assert (sp.doc_ids < 0).any()
        data, starts, doc_map = sp.data, sp.starts, sp.doc_ids
    else:
        data, starts = bb.data, one_doc_starts(bb.batch_size)
        doc_map = np.arange(bb.batch_size, dtype=np.int32)[:, None]
    data, starts, doc_map = map(torch.from_numpy, (data, starts, doc_map))
    lane_cls = lane_classes(cpu, "cpu")
    pb, pn = sf.stream_filter_bytes_sparse(
        data, starts, doc_map, *(cpu.plan_[k] for k in KB), lane_cls,
        cap=10 ** 6, max_depth=64)
    before = sf.stream_filter_bytes_sparse.launches
    kb, kn = sf.stream_filter_bytes_sparse(
        data.to(cuda), starts.to(cuda), doc_map.to(cuda),
        *(gpu.plan_[k] for k in KB), lane_cls.to(cuda), cap=cap,
        max_depth=64)
    torch.cuda.synchronize()
    assert sf.stream_filter_bytes_sparse.launches == before + 1
    assert int(kn[0]) == int(pn[0]) > 7
    if cap >= int(pn[0]):
        np.testing.assert_array_equal(sorted_rows(kb, kn, cap),
                                      sorted_rows(pb, pn, 10 ** 6))
    else:
        assert {tuple(r) for r in kb.cpu().numpy()} \
            <= {tuple(r) for r in pb[:int(pn[0])].numpy()}


def test_predecode_kernel_equals_plain(cuda):
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"<<</>abcXYZ09_.x >\x00\xff", np.uint8)
    for shape in ((5, 1021), (3, 3), (70000, 5), (2000,)):
        data = torch.from_numpy(rng.choice(alphabet, size=shape)
                                .astype(np.uint8))
        before = pd.predecode.launches
        kk, kt = pd.predecode(data.to(cuda))
        torch.cuda.synchronize()
        assert pd.predecode.launches == before + 1
        pk, pt = pd.predecode(data)
        assert torch.equal(kk.cpu(), pk) and torch.equal(kt.cpu(), pt)


def test_engine_sparse_and_parse_on_card_equal_cpu(cuda):
    """Every sparse route and the parse route, card against CPU: the
    result is sorted, so it is equal row for row."""
    dtd, d, nfa = workload(300, seed=8)
    docs = gen_corpus(dtd, n_docs=6, nodes_per_doc=80, seed=8)
    batch = EventBatch.from_streams(docs, bucket=64)
    bb = ByteBatch.from_streams(docs, text_fill=8, bucket=1024)
    for opts in ({}, {"sparse_epilogue": "off"}, {"fuse": False}):
        cpu, gpu = plans(nfa, d, cuda, max_depth=12, **opts)
        for cap in (None, 5):
            pairs = ((cpu.filter_batch_sparse(batch, match_cap=cap),
                      gpu.filter_batch_sparse(batch, match_cap=cap)),
                     (cpu.filter_bytes_sparse(bb, match_cap=cap),
                      gpu.filter_bytes_sparse(bb, match_cap=cap)),
                     (cpu.filter_bytes_sparse(bb, match_cap=cap, pack=True),
                      gpu.filter_bytes_sparse(bb, match_cap=cap, pack=True)))
            for a, b in pairs:
                assert a.meta == b.meta
                for k in ("doc_ids", "query_ids", "first_event"):
                    np.testing.assert_array_equal(getattr(b, k),
                                                  getattr(a, k))
        a, b = cpu.filter_bytes(bb), gpu.filter_bytes(bb)
        np.testing.assert_array_equal(b.matched, a.matched)
        np.testing.assert_array_equal(b.first_event, a.first_event)
    pc = parse.parse_batch(bb, max_depth=12, device="cpu").to_host()
    pg = parse.parse_batch(bb, max_depth=12, device=cuda)
    assert pg.kind.device.type == "cuda"
    pg = pg.to_host()
    for f in ("kind", "tag_id", "depth", "parent", "valid", "n_events"):
        np.testing.assert_array_equal(getattr(pg, f), getattr(pc, f))
