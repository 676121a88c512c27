"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no card is visible, so collection is the same on every machine.  On a
machine with an H100 and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

The first test builds the kernels (``build/repro_torch/``).  Outputs are
0/1 lanes, int32 ordinals, int32 match rows and K6's float32 0/1 states
(gathered values, exact): exact equality, with the
sparse kernels' rows compared as sorted sets (their order on the card is
not fixed) and their counts exactly.  K5 is checked on both of its
paths (16-byte vector, scalar), the serve loop on worker streams against
the synchronous route, and a hot swap with batches in flight against the
live set of each batch's epoch.  Query-sharded plans: K1-K4 over the
folded P·G blocks with tombstoned columns, K6 over the parts folded into
its state axis (past shared memory too), and a sharded subscribe made on
one stream while a batch of the old plan runs on another.  The file
imports nothing of JAX, so it runs where only the port is installed.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.convert import BLOCK_TABLES
from repro_torch.core import engines
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import (SEG_SENTINEL, ByteBatch, EventBatch,
                                     encode_bytes, pack_segments)
from repro_torch.core.nfa import compile_queries
from repro_torch.data.generator import (DTD, gen_corpus, gen_document,
                                        gen_profiles)
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


@pytest.mark.parametrize("blk", [32, 256, 2048, 8192])
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


def handover_batch(dtd, seed):
    """Byte segments aimed at the byte kernels' event ring (windows of 256
    positions, 7 in flight): document starts on window edges and inside a
    window, a document longer than the ring, empty document slots (at the
    start, in the middle and unused sentinel slots at the end), and a
    segment with no tags at all.  Returns data (S, L), starts (S, D+1),
    doc_map (S, D) and the documents as event streams, in batch-row
    order."""
    rng = np.random.default_rng(seed)
    docs = [gen_document(dtd, target_nodes=n, max_depth=12, seed=seed + i)
            for i, n in enumerate((20, 300, 25, 15, 40))]
    bufs = [encode_bytes(x, text_fill=5) for x in docs]
    assert len(bufs[1]) > 7 * 256                  # longer than the ring

    def padded(buf, multiple):                     # filler: no '<'
        return buf + b" " * (-len(buf) % multiple)

    segs = [
        # doc 0 ends on a window edge, so doc 1's first '<' opens a window;
        # an empty slot, then doc 2 on a window edge too
        ([padded(bufs[0], 256), padded(bufs[1], 256), b"", bufs[2]],
         [0, 1, -1, 2]),
        # empty slots first, then doc 3, and doc 4 from inside a window
        ([b"", b"", bufs[3], bufs[4]], [-1, -1, 3, 4]),
        # no tags at all in two slots
        ([bytes(rng.choice(list(b"abc xyz/>"), 700).tolist()), b" " * 300],
         [-1, -1]),
    ]
    n_slots = max(len(x) for x, _ in segs) + 1     # + an unused slot
    length = max(sum(map(len, x)) for x, _ in segs)
    data = np.zeros((len(segs), length), np.uint8)
    starts = np.full((len(segs), n_slots + 1), SEG_SENTINEL, np.int32)
    doc_map = np.full((len(segs), n_slots), -1, np.int32)
    for r, (parts, rows) in enumerate(segs):
        pos = 0
        for k, (part, row) in enumerate(zip(parts, rows)):
            starts[r, k] = pos
            data[r, pos:pos + len(part)] = np.frombuffer(part, np.uint8)
            pos += len(part)
            doc_map[r, k] = row
    assert starts[0, 1] % 256 == 0 and starts[0, 3] % 256 == 0
    assert starts[1, 3] % 256 != 0
    return data, starts, doc_map, docs


@pytest.mark.parametrize("seed", [12, 13])
def test_byte_kernels_on_ring_hand_over_cases(cuda, seed):
    """K2 and K3 against their plain versions on the ring's edge cases;
    K1 and K4 on the same documents with an empty one among them."""
    dtd, d, nfa = workload(200, seed=seed)
    cpu, gpu = plans(nfa, d, cuda, blk=64)
    data, starts, doc_map, docs = handover_batch(dtd, seed)
    data, starts, doc_map = map(torch.from_numpy, (data, starts, doc_map))
    lane_cls = lane_classes(cpu, "cpu")
    kt, pt = [gpu.plan_[k] for k in KB], [cpu.plan_[k] for k in KB]
    km, kf = sf.stream_filter_bytes(data.to(cuda), starts.to(cuda), *kt,
                                    max_depth=64)
    pm, pf = sf.stream_filter_bytes(data, starts, *pt, max_depth=64)
    assert pm[0].any() and not pm[2].any()
    assert torch.equal(km.cpu(), pm) and torch.equal(kf.cpu(), pf)
    kb, kn = sf.stream_filter_bytes_sparse(
        data.to(cuda), starts.to(cuda), doc_map.to(cuda), *kt,
        lane_cls.to(cuda), cap=10 ** 5, max_depth=64)
    pb, pn = sf.stream_filter_bytes_sparse(data, starts, doc_map, *pt,
                                           lane_cls, cap=10 ** 5,
                                           max_depth=64)
    assert int(kn[0]) == int(pn[0]) > 0
    np.testing.assert_array_equal(sorted_rows(kb, kn, 10 ** 5),
                                  sorted_rows(pb, pn, 10 ** 5))

    batch = EventBatch.from_streams(docs + [gen_document(
        dtd, target_nodes=0, seed=0)], bucket=64)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id))
    assert events.shape[1] > 8 * 32                # many 32-event chunks
    km, kf = sf.stream_filter(events.to(cuda), *kt, max_depth=64)
    pm, pf = sf.stream_filter(events, *pt, max_depth=64)
    assert torch.equal(km.cpu(), pm) and torch.equal(kf.cpu(), pf)
    rows = torch.arange(events.shape[0], dtype=torch.int32)[:, None]
    kb, kn = sf.stream_filter_sparse(events.to(cuda), rows.to(cuda), *kt,
                                     lane_cls.to(cuda), cap=10 ** 5,
                                     max_depth=64)
    pb, pn = sf.stream_filter_sparse(events, rows, *pt, lane_cls,
                                     cap=10 ** 5, max_depth=64)
    assert int(kn[0]) == int(pn[0]) > 0
    np.testing.assert_array_equal(sorted_rows(kb, kn, 10 ** 5),
                                  sorted_rows(pb, pn, 10 ** 5))


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


# ------------------------------------------------------------------- K6
def transition_inputs(nfa, w, seed, density=0.2):
    """Random 0/1 parent rows and tags in [-1, T+2) over an NFA's tables,
    all on the CPU (float32 and int32, contiguous); the parent is given
    as ``parent_idx`` (the NFA's ``in_state``)."""
    rng = np.random.default_rng(seed)
    s = nfa.n_states
    parent = (rng.random((w, s)) < density).astype(np.float32)
    tags = rng.integers(-1, nfa.n_tags + 2, size=w).astype(np.int32)
    tables = (nfa.req_matrix(), nfa.wild_vector(), nfa.tables.in_state,
              nfa.tables.selfloop.astype(np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (parent, tags) + tables)


@pytest.mark.parametrize("w,multiple", [(1, 1), (63, 1), (65, 7), (130, 128),
                                        (200, 64)])
def test_nfa_transition_kernel_equals_plain(cuda, w, multiple):
    """Ragged W and S (states padded to 1, 7, 64 or 128: the 4-byte and
    the 16-byte paths), tags past the tag space and -1 pads: exact
    equality with the plain version."""
    from repro_torch.core.nfa import pad_states
    from repro_torch.kernels import nfa_transition as nt

    dtd, d, nfa = workload(40, seed=9)
    nfa = pad_states(nfa, multiple)
    args = transition_inputs(nfa, w, seed=w)
    before = nt.nfa_transition.launches
    got = nt.nfa_transition(*(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    assert nt.nfa_transition.launches == before + 1
    want = nt.nfa_transition(*args)
    assert want.any() and (want == 0).any()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("extra", [0, 3])
def test_nfa_transition_kernel_past_shared_memory(cuda, extra):
    """States past what two staged rows fit in shared memory: the kernel
    reads parent values from device memory, equal to the plain version
    (S a multiple of 4, and not)."""
    from repro_torch.core.nfa import pad_states
    from repro_torch.kernels import nfa_transition as nt

    dtd, d, nfa = workload(40, seed=11)
    s = nt.staged_max_states() + 4 + extra
    nfa = pad_states(nfa, to=s)
    args = list(transition_inputs(nfa, 37, seed=11))
    # real states' parents spread over the row, not only at its start
    rng = np.random.default_rng(11)
    args[4] = torch.from_numpy(rng.integers(0, s, size=s).astype(np.int32))
    got = nt.nfa_transition(*(x.to(cuda) for x in args))
    want = nt.nfa_transition(*args)
    assert want.any() and (want == 0).any()
    assert torch.equal(got.cpu(), want)


def test_nfa_transition_kernel_full_width_plan(cuda):
    """The 1,024-profile plan of chip_smoke (3,712 states) at a wavefront
    step's 2,048 rows, against the plain gather and the product form
    (``torch.matmul`` by the one-hot, full float32, no TF32) on the
    card."""
    from repro_torch.core.nfa import pad_states
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import ref

    assert not torch.backends.cuda.matmul.allow_tf32
    dtd = DTD.generate(n_tags=128, fanout=4, seed=0)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=1024, length=6, p_desc=0.3, p_wild=0.1, seed=0)
    nfa = pad_states(compile_queries(qs, d, shared=True), 128)
    assert nfa.n_states == 3712
    args = [x.to(cuda) for x in transition_inputs(nfa, 2048, seed=1,
                                                  density=0.01)]
    got = nt.nfa_transition(*args)
    want = nt.nfa_transition_plain(*args)
    p1h = torch.from_numpy(nfa.parent_onehot()).to(cuda)
    product = ref.nfa_transition(*args[:4], p1h, args[5])
    torch.cuda.synchronize()
    assert want.any()
    assert torch.equal(got, want) and torch.equal(got, product)


@pytest.mark.parametrize("name,opts", [
    ("levelwise", {"use_kernel": True}),
    ("wavefront", {"use_kernel": True, "chunk": 16}),
    ("wavefront", {"use_kernel": True}),
])
def test_level_engines_with_kernel_on_card_equal_cpu(cuda, name, opts):
    from repro_torch.kernels import nfa_transition as nt

    dtd, d, nfa = workload(120, seed=10)
    docs = gen_corpus(dtd, n_docs=5, nodes_per_doc=150, seed=10)
    batch = EventBatch.from_streams(docs, bucket=64)
    bb = ByteBatch.from_streams(docs, text_fill=8, bucket=1024)
    cpu = engines.create(name, nfa, dictionary=d, device="cpu", **opts)
    gpu = engines.create(name, nfa, dictionary=d, device=cuda, **opts)
    before = nt.nfa_transition.launches
    pairs = ((cpu.filter_batch(batch), gpu.filter_batch(batch)),
             (cpu.filter_bytes(bb), gpu.filter_bytes(bb)))
    assert nt.nfa_transition.launches > before
    assert pairs[0][0].matched.any()
    for a, b in pairs:
        np.testing.assert_array_equal(b.matched, a.matched)
        np.testing.assert_array_equal(b.first_event, a.first_event)


# ------------------------------------------------------ K5, redesigned
def tag_bytes(rng, shape):
    """Seeded bytes rich in tags: markers, symbols, filler, bytes outside
    the alphabet."""
    alphabet = np.frombuffer(b"<<<</>abcXYZ09_.x >\x00\xff", np.uint8)
    return torch.from_numpy(rng.choice(alphabet, size=shape)
                            .astype(np.uint8))


@pytest.mark.parametrize("length", [1, 2, 3, 4, 15, 16, 17, 1023, 1024])
def test_predecode_kernel_row_lengths(cuda, length):
    """Both paths of K5 against its plain version: L % 4 == 0 takes the
    word path (row ends inside a warp's span, lane 31's halo from lane 0
    and from memory), any other L the scalar path."""
    data = tag_bytes(np.random.default_rng(length), (37, length))
    before = pd.predecode.launches
    kk, kt = pd.predecode(data.to(cuda))
    torch.cuda.synchronize()
    assert pd.predecode.launches == before + 1
    pk, pt = pd.predecode(data)
    assert (pk != 2).any() or length < 3
    assert torch.equal(kk.cpu(), pk) and torch.equal(kt.cpu(), pt)


@pytest.mark.parametrize("offset", [3, 4, 16, 1024])
def test_predecode_kernel_on_a_view_with_a_storage_offset(cuda, offset):
    """A contiguous view that starts ``offset`` bytes into its storage:
    4-byte aligned offsets keep the word path, others take the scalar
    path; both read only the view's rows."""
    rows, length = 9, 1024
    flat = tag_bytes(np.random.default_rng(offset),
                     (offset + rows * length + 64,))
    view = flat[offset:offset + rows * length].view(rows, length)
    assert view.storage_offset() == offset and view.is_contiguous()
    kk, kt = pd.predecode(flat.to(cuda)[offset:offset + rows * length]
                          .view(rows, length))
    pk, pt = pd.predecode(view)
    torch.cuda.synchronize()
    assert torch.equal(kk.cpu(), pk) and torch.equal(kt.cpu(), pt)


@pytest.mark.parametrize("length", [16, 48, 5])
def test_predecode_kernel_past_65535_rows(cuda, length):
    data = tag_bytes(np.random.default_rng(5), (70_001, length))
    kk, kt = pd.predecode(data.to(cuda))
    pk, pt = pd.predecode(data)
    torch.cuda.synchronize()
    assert torch.equal(kk.cpu(), pk) and torch.equal(kt.cpu(), pt)


# ---------------------------------------------------- the serve loop
def serve_workload(n_docs, seed=0):
    from repro_torch.data.filter_stage import TEXT_FILL

    dtd = DTD.generate(n_tags=24, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=16, length=3, seed=seed)
    raw = [encode_bytes(x, text_fill=TEXT_FILL)
           for x in gen_corpus(dtd, n_docs=n_docs, nodes_per_doc=40,
                               seed=1)]
    return dtd, d, qs, raw


def ticket_routes(tickets):
    return {(rd.doc_index, rd.shard): tuple(int(x) for x in
                                            rd.matched_profiles)
            for t in tickets for rd in t.routed}


def stage_routes(stage, raw):
    return {(r.doc_index, r.shard): tuple(int(x) for x in r.matched_profiles)
            for b in stage.route_bytes(raw) for r in b}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_serve_loop_on_card_equals_route_bytes(cuda, sparse):
    """Three workers, each on its own stream, launch K2 (dense) or K3
    (sparse) from their threads; every request routes as the synchronous
    ``route_bytes``."""
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.serve import ServeLoop

    _, d, qs, raw = serve_workload(n_docs=37)
    kernel = sf.stream_filter_bytes_sparse if sparse \
        else sf.stream_filter_bytes

    def stage():
        return FilterStage(qs, d, n_shards=2, keep_unmatched=True,
                           batch_size=4, device=str(cuda), sparse=sparse)

    before = kernel.launches
    with ServeLoop(stage(), max_batch=4, deadline_ms=60_000, queue_cap=64,
                   max_inflight=3) as loop:
        tickets = [loop.submit(p) for p in raw]
    assert kernel.launches - before == 10
    assert loop.slo_summary()["completed"] == len(raw)
    assert ticket_routes(tickets) == stage_routes(stage(), raw)


def swap_with_batches_in_flight(device, **stage_kw):
    """A hot swap that commits while two batches are in flight.

    Batch A (filtered under epoch 0) is held inside the stage's call
    until the swap is queued behind it, so the completer cannot commit
    yet; batches C and D are then dispatched and filtered under epoch 0
    on the other workers.  Releasing A lets the completer resolve A,
    commit the swap while C and D are still undelivered, and resolve them
    with epoch 0's gids; batch E, submitted after the commit, is filtered
    under epoch 1.  Every request's verdicts must equal a synchronous
    stage built on the live set of its epoch.  Returns the epochs the
    batches were filtered under, in dispatch order."""
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.serve import ServeLoop

    _, d, qs, raw = serve_workload(n_docs=16, seed=2)

    def stage(profiles, **kw):
        return FilterStage(profiles, d, n_shards=2, keep_unmatched=True,
                           batch_size=4, device=device, **kw)

    before = stage_routes(stage(qs), raw)
    hits = np.bincount(np.concatenate(
        [np.asarray(m, np.int64) for m in before.values()]), minlength=16)
    new_q = qs[int(np.argmax(hits))]        # a profile that matches
    after = stage_routes(stage(list(qs) + [new_q]), raw)

    st = stage(qs, **stage_kw)
    orig = st._filter_bytebatch
    release = threading.Event()
    epochs = []

    def gated(bufs, record=True, epoch=None):
        epochs.append(epoch.epoch)
        if bufs[0] == raw[0]:
            assert release.wait(timeout=120), "batch A was never released"
        return orig(bufs, record=record, epoch=epoch)

    st._filter_bytebatch = gated

    def wait_for(cond, what):
        deadline = time.monotonic() + 120
        while not cond():
            assert time.monotonic() < deadline, f"never saw {what}"
            time.sleep(0.005)

    with ServeLoop(st, max_batch=4, deadline_ms=60_000, queue_cap=64,
                   max_inflight=3) as loop:
        a = [loop.submit(p) for p in raw[:4]]
        wait_for(lambda: len(epochs) == 1, "batch A in the stage")
        tk = loop.subscribe(new_q)
        wait_for(lambda: any(item is not None and item[0] == "swap"
                             for item in list(loop._completion)),
                 "the swap queued")
        cd = [loop.submit(p) for p in raw[4:12]]
        wait_for(lambda: len(epochs) == 3, "batches C and D in the stage")
        release.set()
        assert tk.done.wait(timeout=120) and tk.error is None
        e = [loop.submit(p) for p in raw[12:]]
    assert tk.gid == 16 and loop.swap_log[0]["epoch"] == 1
    assert epochs == [0, 0, 0, 1]
    old = {k: v for k, v in before.items() if k[0] < 12}
    new = {k: v for k, v in after.items() if k[0] >= 12}
    assert ticket_routes(a + cd) == old
    assert ticket_routes(e) == new
    assert [t.epoch for t in a + cd + e] == [0] * 12 + [1] * 4
    assert any(16 in m for m in new.values())
    return epochs


def test_hot_swap_with_batches_in_flight_on_card(cuda):
    swap_with_batches_in_flight(str(cuda))


# ------------------------------------------------------ query-sharded plans
def sharded_pair(cuda, n_queries, seed, n_parts, **kw):
    """The same sharded plan on the CPU and on the card, every 5th
    profile tombstoned."""
    dtd, d, nfa = workload(n_queries, seed=seed)
    cpu, gpu = plans(nfa, d, cuda, **kw)
    dead = list(range(0, n_queries, 5))
    return (dtd, cpu, cpu.plan_sharded(n_parts).remove_queries(dead),
            gpu, gpu.plan_sharded(n_parts).remove_queries(dead))


@pytest.mark.parametrize("n_parts", [2, 4])
def test_folded_kernels_equal_plain(cuda, n_parts):
    """K1-K4 over the P·G folded blocks of a sharded plan with tombstoned
    columns, against their plain versions: lanes and ordinals equal, the
    sparse rows equal as sorted sets with exact counts, one launch each."""
    dtd, cpu, csp, gpu, gsp = sharded_pair(cuda, 300, 21, n_parts, blk=256)
    ctab = cpu._folded(csp.stacked())
    gtab = gpu._folded(gsp.stacked())
    assert ctab[0].shape[0] == n_parts * int(csp.stacked().meta["n_blocks"])
    lane = cpu._sharded_lane_tables(csp)[0].flatten(0, 1)
    docs = gen_corpus(dtd, n_docs=6, nodes_per_doc=90, seed=21)
    batch = EventBatch.from_streams(docs, bucket=64)
    events = sf.fuse_events(torch.from_numpy(batch.kind),
                            torch.from_numpy(batch.tag_id))
    rows = torch.arange(6, dtype=torch.int32)[:, None]
    bb = ByteBatch.from_buffers([encode_bytes(x, text_fill=3) for x in docs],
                                bucket=256)
    data = torch.from_numpy(bb.data)
    starts = torch.from_numpy(one_doc_starts(6))
    before = {k: getattr(sf, k).launches for k in (
        "stream_filter", "stream_filter_bytes", "stream_filter_sparse",
        "stream_filter_bytes_sparse")}
    k1 = sf.stream_filter(events.to(cuda), *gtab, max_depth=64)
    p1 = sf.stream_filter(events, *ctab, max_depth=64)
    k2 = sf.stream_filter_bytes(data.to(cuda), starts.to(cuda), *gtab,
                                max_depth=64)
    p2 = sf.stream_filter_bytes(data, starts, *ctab, max_depth=64)
    k4 = sf.stream_filter_sparse(events.to(cuda), rows.to(cuda), *gtab,
                                 lane.to(cuda), cap=4000, max_depth=64)
    p4 = sf.stream_filter_sparse(events, rows, *ctab, lane, cap=4000,
                                 max_depth=64)
    k3 = sf.stream_filter_bytes_sparse(data.to(cuda), starts.to(cuda),
                                       rows.to(cuda), *gtab, lane.to(cuda),
                                       cap=4000, max_depth=64)
    p3 = sf.stream_filter_bytes_sparse(data, starts, rows, *ctab, lane,
                                       cap=4000, max_depth=64)
    torch.cuda.synchronize()
    assert p1[0].any() and int(p4[1][0]) > 0
    for k, p in ((k1, p1), (k2, p2)):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(k, p))
    for k, p in ((k3, p3), (k4, p4)):
        assert int(k[1][0]) == int(p[1][0])
        np.testing.assert_array_equal(sorted_rows(*k, 4000),
                                      sorted_rows(*p, 4000))
    assert all(getattr(sf, k).launches == n + 1 for k, n in before.items())
    # the engine's sharded routes on the card equal its routes on the CPU
    pb = EventBatch.from_streams(docs, bucket=64)
    for call, arg in (("filter_batch_sharded", pb),
                      ("filter_bytes_sharded", bb)):
        got = getattr(gpu, call)(arg, gsp)
        want = getattr(cpu, call)(arg, csp)
        np.testing.assert_array_equal(got.matched, want.matched)
        np.testing.assert_array_equal(got.first_event, want.first_event)
    for call, arg in (("filter_batch_sharded_sparse", pb),
                      ("filter_bytes_sharded_sparse", bb)):
        got = getattr(gpu, call)(arg, gsp)
        want = getattr(cpu, call)(arg, csp)
        assert got.meta["path"] == want.meta["path"] == "kernel-fused"
        for f in ("doc_ids", "query_ids", "first_event"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n_parts", [2, 9])
def test_folded_k6_equals_plain(cuda, n_parts):
    """K6 over the parts of chip_smoke's 1,024-profile levelwise plan
    folded into its state axis, at a wavefront step's 2,048 rows: at two
    parts, and at nine copies of the whole plan (33,408 states, past what
    the kernel stages in shared memory)."""
    from repro_torch.core.engines.base import ShardedPlan
    from repro_torch.kernels import nfa_transition as nt

    dtd = DTD.generate(n_tags=128, fanout=4, seed=0)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=1024, length=6, p_desc=0.3, p_wild=0.1, seed=0)
    nfa = compile_queries(qs, d, shared=True)
    eng = engines.create("wavefront", nfa, dictionary=d, device=cuda,
                         use_kernel=True)
    if n_parts == 2:
        sp = eng.plan_sharded(2)
    else:
        sp = ShardedPlan(eng, [eng.plan_] * n_parts, [[]] * n_parts,
                         [[]] * n_parts, [eng.nfa] * n_parts, {}, 0, 8, True)
    folded = eng._folded_plan(sp)
    s = int(folded["in_state"].shape[0])
    if n_parts > 2:
        assert s > nt.staged_max_states()
    g = torch.Generator(device=cuda).manual_seed(n_parts)
    rows = torch.empty((2048, s), dtype=torch.float32,
                       device=cuda).bernoulli_(0.02, generator=g)
    tags = torch.randint(-1, int(folded["req"].shape[0]) + 2, (2048,),
                         generator=g, device=cuda, dtype=torch.int32)
    args = (rows, tags, folded["req"], folded["wild"], folded["in_state"],
            folded["selfloop"])
    before = nt.nfa_transition.launches
    got = nt.nfa_transition(*args)
    want = nt.nfa_transition_plain(*args)
    torch.cuda.synchronize()
    assert nt.nfa_transition.launches == before + 1
    assert want.any() and torch.equal(got, want)


def test_sharded_hot_swap_with_batches_in_flight_on_card(cuda):
    """The hot-swap scenario on a query-sharded stage: the subscribe's
    one-part restack is made on the shadow builder's stream while batches
    of the old epoch are in flight on the workers' streams."""
    assert swap_with_batches_in_flight(str(cuda), query_shards=2) \
        == [0, 0, 0, 1]


def test_sharded_subscribe_on_another_stream_leaves_inflight_batch(cuda):
    """A batch of the old plan is launched, not waited for, on one stream;
    a subscribe is prepared and committed on another.  The old batch's
    lanes equal the old plan's routes (the restack wrote new tensors), and
    the new plan, read on the first stream after its wait, routes as a
    fresh stage on the live set."""
    from repro_torch.data.filter_stage import FilterStage

    dtd, d, qs, raw = serve_workload(n_docs=8, seed=4)
    st = FilterStage(qs, d, n_shards=2, batch_size=8, device=str(cuda),
                     query_shards=2)
    cpu = FilterStage(qs, d, n_shards=2, batch_size=8, device="cpu",
                      query_shards=2)
    ep = st.plan_epoch()
    bb = ByteBatch.from_buffers(raw, bucket=st.byte_bucket)
    reader, writer = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    with torch.cuda.stream(reader):
        ep.sharded.wait()
        lanes = sf.stream_filter_bytes(
            torch.from_numpy(bb.data).to(cuda),
            torch.from_numpy(one_doc_starts(len(raw))).to(cuda),
            *st._eng._folded(ep.sharded.stacked()), max_depth=64)
    new_q = gen_profiles(dtd, n=1, length=3, seed=77)[0]
    with torch.cuda.stream(writer):
        gid = st.commit(st.prepare_subscribe(new_q))
    assert gid == 16
    torch.cuda.synchronize()
    want_old = cpu._eng.filter_bytes_sharded(bb, cpu.sharded_)
    with torch.cuda.stream(reader):
        m, f = st._eng._sharded_lanes_to_queries(
            lanes[0].transpose(1, 2), lanes[1].transpose(1, 2), ep.sharded)
        got_new = st._filter_bytebatch(raw, record=False)
    np.testing.assert_array_equal(m[:, 0].cpu().numpy(), want_old.matched)
    np.testing.assert_array_equal(f[:, 0].cpu().numpy(),
                                  want_old.first_event)
    cpu.subscribe(new_q)
    want_new = cpu._filter_bytebatch(raw, record=False)
    np.testing.assert_array_equal(got_new.matched, want_new.matched)
    np.testing.assert_array_equal(got_new.first_event, want_new.first_event)
