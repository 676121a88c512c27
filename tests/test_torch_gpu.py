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
one stream while a batch of the old plan runs on another.  The plan
cache: a hit's tables on the card equal a compile's, and a hot swap whose
rebuild reads the cache runs with batches in flight.  The public wrappers
of ``kernels.ops`` and a tiny ``autotune.search`` on the card.  The mesh:
a 2 x 2 and a 1 x 4 grid of positions on the one card, one launch a
position, each on a stream of its own.  The model zoo: every
architecture, reduced, on the card against the CPU (float32, TF32 off:
within ``MODEL_TOL``), prefill then decode against the full forward,
``ServeEngine`` tokens at a float32 cache equal to the CPU engine's, and
the serving CLI's ``main`` on the card (K2 launched).  Training:
``train_loss``, its gradients and 3 AdamW steps on the card against the
CPU, and a ``CheckpointStore`` round trip of a tree of card tensors with
an in-place step between the asynchronous save and its write.  The LM
substrate on a mesh: a parameter tree placed on a 2 x 2 grid of the card
by the rule shardings, the elastic restore flow there (float32 and
bfloat16, bit for bit), and both expert-parallel MoE branches on the
grid, each position on its own stream, against the card's single-device
``moe`` and the CPU's expert-parallel one.  The sharded train step on that
grid (dense with remat and CE chunks, MLA with MTP and Adafactor, both
expert-parallel dispatches, the VLM prefix), repeated, against the card's
one-device step and the CPU grid's sharded step.  The file imports
nothing of JAX, so it runs where only the port is installed.
"""
import contextlib
import sys
import threading
import time
import traceback

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


#: seconds every wait of :func:`swap_with_batches_in_flight` shares
SWAP_BUDGET_S = 45.0


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
    gate = [True]                # only batch A's first run is held
    epochs = []
    # one budget for every wait below, so a failure costs under a minute
    deadline = time.monotonic() + SWAP_BUDGET_S

    def left():
        return max(0.0, deadline - time.monotonic())

    def gated(bufs, record=True, epoch=None):
        epochs.append(epoch.epoch)
        if bufs[0] == raw[0] and gate:
            gate.clear()
            if not release.wait(timeout=left()):
                raise AssertionError("batch A was never released")
        return orig(bufs, record=record, epoch=epoch)

    st._filter_bytebatch = gated

    def wait_for(cond, what, loop, tk=None):
        """Poll ``cond``; fail at once with the build's error if the
        subscribe failed, and with the builder thread's stack if the
        budget runs out."""
        while not cond():
            if tk is not None and tk.done.is_set():
                raise AssertionError(
                    f"never saw {what}: the subscribe ended first, error "
                    f"{tk.error!r}") from tk.error
            if not left():
                frame = sys._current_frames().get(loop._builder_t.ident)
                where = ("".join(traceback.format_stack(frame))
                         if frame is not None else "(builder exited)")
                raise AssertionError(
                    f"never saw {what} in {SWAP_BUDGET_S} s; epochs "
                    f"{epochs}; the plan builder was at:\n{where}")
            time.sleep(0.005)

    def swap_queued(loop):
        with loop._comp_cv:
            items = list(loop._completion)
        return any(item is not None and item[0] == "swap" for item in items)

    with ServeLoop(st, max_batch=4, deadline_ms=60_000, queue_cap=64,
                   max_inflight=3) as loop:
        try:
            a = [loop.submit(p) for p in raw[:4]]
            wait_for(lambda: len(epochs) == 1, "batch A in the stage", loop)
            tk = loop.subscribe(new_q)
            wait_for(lambda: swap_queued(loop), "the swap queued", loop, tk)
            cd = [loop.submit(p) for p in raw[4:12]]
            wait_for(lambda: len(epochs) == 3,
                     "batches C and D in the stage", loop)
        finally:
            # a failed wait must not leave batch A (and the loop's close)
            # held until the gate's own timeout
            release.set()
        assert tk.done.wait(timeout=left()) and tk.error is None
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


# ------------------------------------------- plan cache, ops and autotune
@pytest.mark.parametrize("query_shards", [1, 2])
def test_plan_cache_hit_swap_with_batches_in_flight(cuda, tmp_path,
                                                    query_shards):
    """The hot swap with batches in flight, its shadow rebuild read from a
    warm plan cache: the hit's tables are placed on the shadow build's
    stream while batches of the old epoch run on the workers' streams,
    and every request routes as a synchronous stage on its epoch's live
    set (the helper's checks)."""
    from repro_torch.checkpoint import PlanCache
    from repro_torch.data.filter_stage import FilterStage

    _, d, qs, raw = serve_workload(n_docs=16, seed=2)
    kw = {"query_shards": query_shards} if query_shards > 1 else {}

    def stage(cache):
        return FilterStage(qs, d, n_shards=2, keep_unmatched=True,
                           batch_size=4, device=str(cuda),
                           engine_options={"plan_cache": cache}, **kw)

    before = stage_routes(stage(None), raw)
    hits = np.bincount(np.concatenate(
        [np.asarray(m, np.int64) for m in before.values()]), minlength=16)
    stage(str(tmp_path)).subscribe(qs[int(np.argmax(hits))])   # warm
    cache = PlanCache(str(tmp_path))
    assert swap_with_batches_in_flight(
        str(cuda), engine_options={"plan_cache": cache}, **kw) == [0, 0, 0, 1]
    assert cache.misses == 0 and cache.hits >= 2


def test_plan_cache_hit_on_card_equals_compile(cuda, tmp_path):
    """A hit's tables on the card equal the compiled ones, and K2 on them
    gives the plain version's lanes."""
    from repro_torch.checkpoint import PlanCache

    dtd, d, nfa = workload(200, seed=6)
    a = engines.create("streaming", nfa, dictionary=d, device=cuda,
                       plan_cache=str(tmp_path))
    cache = PlanCache(str(tmp_path))
    b = engines.create("streaming", nfa, dictionary=d, device=cuda,
                       plan_cache=cache)
    assert (cache.hits, cache.misses) == (1, 0)
    for k in a.plan_.tables:
        assert a.plan_[k].device.type == "cuda"
        assert torch.equal(a.plan_[k], b.plan_[k]), k
    bb = ByteBatch.from_buffers(
        [encode_bytes(x, text_fill=4) for x in
         gen_corpus(dtd, n_docs=4, nodes_per_doc=120, seed=6)], bucket=256)
    cpu = engines.create("streaming", nfa, dictionary=d, device="cpu")
    got, want = b.filter_bytes(bb), cpu.filter_bytes(bb)
    np.testing.assert_array_equal(got.matched, want.matched)
    np.testing.assert_array_equal(got.first_event, want.first_event)


def test_ops_on_card_equal_cpu(cuda):
    """Each public wrapper on the card launches its kernel once and equals
    the same wrapper on the CPU."""
    from repro_torch.core.nfa import pad_states
    from repro_torch.kernels import nfa_transition as nt
    from repro_torch.kernels import ops

    dtd, d, nfa = workload(120, seed=7)
    docs = gen_corpus(dtd, n_docs=4, nodes_per_doc=150, seed=7)
    bufs = [encode_bytes(x, text_fill=3) for x in docs]
    data = ByteBatch.from_buffers(bufs, bucket=256).data
    before = pd.predecode.launches
    k = ops.predecode(data, device=cuda)
    assert pd.predecode.launches == before + 1
    p = ops.predecode(data, device="cpu")
    assert all(torch.equal(x.cpu(), y) for x, y in zip(k, p))
    ev, ev_cpu = (ops.decode_document(bufs[0], d, device=dev)
                  for dev in (cuda, "cpu"))
    np.testing.assert_array_equal(ev.kind, ev_cpu.kind)
    np.testing.assert_array_equal(ev.tag_id, ev_cpu.tag_id)
    padded = pad_states(nfa, 128)
    s = padded.n_states
    g = torch.Generator().manual_seed(7)
    rows = (torch.rand((333, s), generator=g) < 0.1).float().numpy()
    tags = torch.randint(-1, nfa.n_tags + 2, (333,), generator=g,
                         dtype=torch.int32).numpy()
    args = (rows, tags, padded.req_matrix(), padded.wild_vector(),
            padded.parent_onehot(), padded.tables.selfloop.astype(np.float32))
    before = nt.nfa_transition.launches
    k6 = ops.nfa_transition(*args, device=cuda)
    assert nt.nfa_transition.launches == before + 1
    assert torch.equal(k6.cpu(), ops.nfa_transition(*args, device="cpu"))
    qs = list(nfa.queries)
    before = sf.stream_filter.launches
    eng, eng_cpu = (ops.StreamFilterKernelEngine(qs, d, device=dev)
                    for dev in (cuda, "cpu"))
    for x in docs:
        got, want = eng.filter_document(x), eng_cpu.filter_document(x)
        np.testing.assert_array_equal(got.matched, want.matched)
        np.testing.assert_array_equal(got.first_event, want.first_event)
    assert sf.stream_filter.launches == before + len(docs)


def test_autotune_search_on_card_tiny_grid(cuda, tmp_path):
    """A search on the card times each distinct shape, caches the winner
    under the card's name, and an ``autotune="measured"`` engine reads it
    and filters as the default engine."""
    import os

    from repro_torch.kernels import autotune

    dtd, d, nfa = workload(200, seed=8)
    bb = ByteBatch.from_buffers(
        [encode_bytes(x, text_fill=4) for x in
         gen_corpus(dtd, n_docs=6, nodes_per_doc=100, seed=8)], bucket=256)
    cache = str(tmp_path / "at.json")
    best, rows = autotune.search(nfa, d, bb, blks=(32, 64, 8192),
                                 segment_targets=(512,), trials=1,
                                 device=cuda, cache_file=cache)
    assert all("seconds" in r for r in rows) and best["seconds"] > 0
    key = next(iter(autotune.load_cache(cache)))
    assert key.startswith(
        f"torch-v1:cuda:{torch.cuda.get_device_name(cuda)}:")
    old = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = cache
    try:
        eng = engines.create("streaming", nfa, dictionary=d, device=cuda,
                             autotune="measured")
    finally:
        if old is None:
            del os.environ[autotune.CACHE_ENV]
        else:
            os.environ[autotune.CACHE_ENV] = old
    assert eng.plan_.meta["blk"] == best["blk_eff"]
    plain = engines.create("streaming", nfa, dictionary=d, device=cuda)
    got, want = eng.filter_bytes(bb, pack=True), plain.filter_bytes(bb)
    np.testing.assert_array_equal(got.matched, want.matched)
    np.testing.assert_array_equal(got.first_event, want.first_event)


# ------------------------------------------------------------- the mesh
def card_mesh(cuda, data, model):
    from repro_torch.launch.mesh import FilterMesh

    return FilterMesh([[cuda] * model for _ in range(data)])


@pytest.mark.parametrize("kw", [{}, {"sparse": True},
                                {"engine_options": {"pack": True}},
                                {"engine": "wavefront",
                                 "engine_options": {"use_kernel": True}}],
                         ids=["dense", "sparse", "packed", "wavefront-K6"])
def test_2d_stage_on_card_launches_per_position(cuda, kw):
    """A 2 x 2 mesh over the one card: each request launches its kernel
    at every position (four streams), the routes and the pipelined routes
    equal the unsharded stage's, and both mesh= paths of the 1-D filters
    equal the one-card run."""
    from repro_torch.data.filter_stage import FilterStage
    from repro_torch.kernels import nfa_transition as nt

    dtd, d, qs, raw = serve_workload(n_docs=16)
    kw = dict(kw)
    engine = kw.pop("engine", "streaming")

    def stage(**more):
        return FilterStage(qs, d, n_shards=2, keep_unmatched=True,
                           batch_size=8, device=str(cuda), engine=engine,
                           **kw, **more)

    want = stage_routes(stage(), raw)
    two_d = stage(query_shards=2, data_shards=2, mesh=card_mesh(cuda, 2, 2))
    kernel = (nt.nfa_transition if engine == "wavefront"
              else sf.stream_filter_bytes)
    before = kernel.launches
    assert stage_routes(two_d, raw) == want
    torch.cuda.synchronize()
    assert kernel.launches - before >= 4 * 2        # 2 requests x 4
    if engine == "streaming":
        assert kernel.launches - before == 4 * 2
        got = {(r.doc_index, r.shard): tuple(int(x) for x in
                                             r.matched_profiles)
               for b in two_d.route_bytes_pipelined(raw, depth=3)
               for r in b}
        assert got == want and two_d.stats["overlapped_batches"] == 1
        events = sf.stream_filter_sparse if kw.get("sparse") \
            else sf.stream_filter
        before = events.launches
        streams = [gen_document(dtd, target_nodes=40, seed=i)
                   for i in range(8)]
        list(two_d.route(streams))
        torch.cuda.synchronize()
        assert events.launches - before == 4


def test_mesh_1d_filters_on_card_equal_one_card(cuda):
    """``mesh=`` on every sharded filter over a 1 x 4 grid of the card:
    one launch a model position, equal to the one-card run."""
    _, d, qs, raw = serve_workload(n_docs=8)
    eng = engines.create("streaming", compile_queries(qs, d, shared=True),
                         dictionary=d, device=cuda)
    sp = eng.plan_sharded(4)
    mesh = card_mesh(cuda, 1, 4)
    bb = ByteBatch.from_buffers(raw, bucket=1024)
    from repro_torch.kernels import parse as parse_mod
    batch = parse_mod.parse_batch(bb, device=cuda)
    for method, arg, kernel in (
            ("filter_batch_sharded", batch, sf.stream_filter),
            ("filter_batch_sharded_sparse", batch, sf.stream_filter_sparse),
            ("filter_bytes_sharded", bb, sf.stream_filter_bytes),
            ("filter_bytes_sharded_sparse", bb,
             sf.stream_filter_bytes_sparse)):
        one = getattr(eng, method)(arg, sp)
        before = kernel.launches
        got = getattr(eng, method)(arg, sp, mesh=mesh)
        torch.cuda.synchronize()
        assert kernel.launches - before == 4, method
        if "sparse" in method:
            one, got = one.densify(), got.densify()
        assert np.array_equal(one.matched, got.matched), method
        assert np.array_equal(one.first_event, got.first_event), method


# ------------------------------------------------------------- model zoo
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def no_tf32():
    """Full float32 products for the card-against-CPU checks."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _model(name):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(name, reduced=True)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if key:
        batch[key] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", [
    "qwen3-0.6b", "deepseek-coder-33b", "qwen1.5-110b", "starcoder2-7b",
    "zamba2-7b", "internvl2-76b", "mamba2-780m", "whisper-large-v3",
    "qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_model_on_card_equals_cpu(cuda, no_tf32, name):
    from repro_torch.models import transformer as T

    cfg, params, batch = _model(name)
    dparams, dbatch = _to(params, cuda), _to(batch, cuda)
    with torch.inference_mode():
        want, _ = T.forward_logits(cfg, params, batch)
        got, _ = T.forward_logits(cfg, dparams, dbatch)
        extra = cfg.frontend_len if cfg.family == "vlm" else 0
        caches = T.init_cache(cfg, 2, 20 + extra, dtype=torch.float32,
                              device=cuda)
        _, caches = T.prefill(cfg, dparams, {
            **dbatch, "tokens": dbatch["tokens"][:, :15]}, caches)
        dec, _ = T.decode_step(cfg, dparams, dbatch["tokens"][:, 15:],
                               caches, 15 + extra)
    v = cfg.vocab
    got = got[..., :v].cpu()
    torch.testing.assert_close(got, want[..., :v], **MODEL_TOL)
    torch.testing.assert_close(dec[:, -1, :v].cpu(), got[:, -1], **MODEL_TOL)


def test_serve_engine_on_card_equals_cpu(cuda, no_tf32):
    from repro_torch.serve import ServeEngine

    cfg, params, batch = _model("qwen3-0.6b")
    prompts = batch["tokens"].numpy()
    kw = dict(batch=2, max_len=24, cache_dtype=torch.float32)
    want = ServeEngine(cfg, params, device="cpu", **kw).generate(
        {"tokens": prompts}, 6)
    got = ServeEngine(cfg, params, device=cuda, **kw).generate(
        {"tokens": prompts}, 6)
    np.testing.assert_array_equal(got, want)
    out = ServeEngine(cfg, params, batch=2, max_len=24).generate(
        {"tokens": prompts}, 6)       # the default: the card, bf16 cache
    assert out.shape == (2, 6) and ((out >= 0) & (out < cfg.vocab)).all()


def test_serve_main_on_card(cuda, monkeypatch, capsys):
    """The serving CLI's ``main`` with no ``--device``: the card; bytes
    routed by K2 to the queues a CPU run prints."""
    import re
    import sys

    from repro_torch.launch import serve

    args = ["serve", "--requests", "8", "--replicas", "2", "--batch", "4",
            "--prompt-len", "8", "--gen-len", "4", "--filter-engine",
            "streaming", "--ingest", "bytes"]
    outs = []
    for extra in (["--device", "cpu"], []):
        monkeypatch.setattr(sys, "argv", args + extra)
        before = sf.stream_filter_bytes.launches
        serve.main()
        torch.cuda.synchronize()
        launched = sf.stream_filter_bytes.launches - before
        outs.append(capsys.readouterr().out)
    assert launched > 0

    def summary(out):
        return (re.search(r"→ (\[[0-9, ]*\]) per replica", out).group(1),
                re.search(r"→ (\d+) deliveries", out).group(1),
                re.search(r"generated (\d+) tokens", out).group(1))

    assert summary(outs[1]) == summary(outs[0])


# --------------------------------------------------------------- training
def test_train_loss_grads_and_steps_on_card_equal_cpu(cuda, no_tf32):
    """qwen3-0.6b reduced: the loss within 1e-5 relative, every gradient
    leaf within ``rtol=1e-4, atol=1e-6``; 3 train steps' losses within
    1e-5 relative; after 3 AdamW updates from the same (the CPU's)
    gradients, parameters and states within 1e-5.  (After full steps the
    parameters are not compared: AdamW's first update is g / (|g| +
    eps), so rounding noise in a gradient near zero moves a parameter
    by up to lr.)"""
    from repro_torch.models import transformer as T
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.train_step import grads_and_metrics
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg, params, batch = _model("qwen3-0.6b")
    tok = batch["tokens"].numpy()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def loss_and_grads(p, dev):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = T.train_loss(cfg, tree_unflatten(p, leaves), {
            k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in batch.items()})
        return loss.item(), torch.autograd.grad(loss, leaves)

    def copy_to(tree, dev):
        return tree_map(lambda x: x.to(dev, copy=True), tree)

    want, wgrads = loss_and_grads(params, "cpu")
    got, grads = loss_and_grads(_to(params, cuda), cuda)
    assert abs(got / want - 1) <= 1e-5
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-6)
    losses = []
    for dev in (cuda, "cpu"):
        p = copy_to(params, dev)
        opt = make_optimizer("adamw")
        state = opt.init(p)
        step = make_train_step(cfg, opt)
        run = []
        for i in range(3):
            p, state, m = step(p, state, batch, np.int32(i))
            run.append(m["loss"].item())
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    opt = make_optimizer("adamw")
    p_c, p_h = copy_to(params, cuda), copy_to(params, "cpu")
    s_c, s_h = opt.init(p_c), opt.init(p_h)
    for i in range(3):
        g, _ = grads_and_metrics(cfg, p_h, batch)
        p_c, s_c = opt.update(copy_to(g, cuda), s_c, p_c, np.int32(i))
        p_h, s_h = opt.update(g, s_h, p_h, np.int32(i))
    for a, b in zip(tree_leaves((p_c, s_c)), tree_leaves((p_h, s_h))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


def test_checkpoint_roundtrip_of_card_tensors(cuda, tmp_path):
    """``save_async`` of card tensors copies them to the host before it
    returns: an in-place optimizer step right after does not reach the
    checkpoint; ``restore`` puts the leaves back on the card."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.tree import tree_leaves

    cfg, params, batch = _model("qwen3-0.6b")
    tok = batch["tokens"].numpy()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    params = _to(params, cuda)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    params, state, _ = step(params, state, batch, np.int32(0))
    before = [x.cpu() for x in tree_leaves((params, state))]
    store = CheckpointStore(str(tmp_path))
    store.save_async(1, (params, state))
    params, state, _ = step(params, state, batch, np.int32(1))
    store.wait()
    (p2, s2), _ = store.restore(1, (params, state))
    leaves = tree_leaves((p2, s2))
    assert all(x.device.type == "cuda" for x in leaves)
    for got, want in zip(leaves, before):
        assert torch.equal(got.cpu(), want)
    assert not torch.equal(tree_leaves(params)[0].cpu(), before[0])
    host, _ = store.restore(1, (params, state), device="cpu")
    assert tree_leaves(host)[0].device.type == "cpu"


# ------------------------------------------------------ the LM on a mesh
def _card_grid(cuda):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(2, devices=[cuda] * 4)


def test_placement_on_a_2x2_card_grid(cuda):
    """The rule shardings of reduced qwen3-0.6b on a 2 x 2 grid of the
    card: each position's shard is a view of one copy on the card, of its
    block's shape; gathering gives the tree back."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import device_put, gather
    from repro_torch.tree import tree_leaves

    cfg, params, _ = _model("qwen3-0.6b")
    mesh = _card_grid(cuda)
    sh = R.param_shardings(cfg, T.init_model(cfg, None), mesh)
    placed = device_put(params, sh)
    split = 0
    for leaf, want in zip(tree_leaves(placed), tree_leaves(params)):
        shards = [leaf.shards[i] for i in mesh.positions()]
        assert all(t.device.type == "cuda" for t in shards)
        assert len({t.untyped_storage().data_ptr() for t in shards}) == 1
        assert all(tuple(t.shape) == leaf.sharding.shard_shape(leaf.shape)
                   for t in shards)
        split += not leaf.sharding.is_fully_replicated
        assert torch.equal(gather(leaf).cpu(), want)
    assert split > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elastic_restore_flow_on_card(cuda, tmp_path, dtype):
    """Save card tensors from one device → restore onto the 2 x 2 card
    grid → save from the placed layout → restore replicated on the card,
    each bit for bit."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import PlacedTensor, gather
    from repro_torch.tree import tree_leaves

    cfg, params, _ = _model("qwen3-0.6b")
    cfg = cfg.with_(param_dtype=dtype)
    params = _to(T.init_model(cfg, torch.Generator().manual_seed(0)), cuda)
    store = CheckpointStore(str(tmp_path))
    store.save(3, params)
    sh = R.param_shardings(cfg, T.init_model(cfg, None), _card_grid(cuda))
    _, placed, _ = store.restore_latest(params, sh)
    leaves = tree_leaves(placed)
    assert all(isinstance(x, PlacedTensor) for x in leaves)
    assert any(not x.sharding.is_fully_replicated for x in leaves)
    for got, want in zip(leaves, tree_leaves(params)):
        assert got.dtype == want.dtype
        assert torch.equal(gather(got), want)
    store.save(4, placed)
    _, back, _ = store.restore_latest(params)
    for got, want in zip(tree_leaves(back), tree_leaves(params)):
        assert got.device.type == "cuda" and torch.equal(got, want)


#: runs of each expert-parallel branch held against one reference
EP_REPEATS = 5


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b"])
@pytest.mark.parametrize("shape,branch", [((4, 8), "stationary"),
                                          ((4, 552), "shardmap")])
def test_moe_ep_branches_on_card(cuda, no_tf32, arch, shape, branch):
    """Both EP branches on the 2 x 2 card grid, positions on their own
    streams: forward within 1e-4 and the gradients of router, wi and wo
    within 1e-5 of the largest, against the card's single-device moe (no
    token dropped by either) and the CPU's EP; and equal to the same
    dispatch with its positions one after another on one stream."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding import mesh_context

    cfg = get_config(arch, reduced=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(shape + (cfg.d_model,),
                    generator=torch.Generator().manual_seed(1))
    x2 = x.reshape(-1, cfg.d_model)
    shards = 1 if branch == "stationary" else 2
    assert L.dropped_assignments(cfg, p["router"], x2, shards, L._ep_capacity(
        cfg, x2.shape[0] // shards)) == 0
    assert L.dropped_assignments(cfg, p["router"], x2, 1, L._moe_capacity(
        cfg, x2.shape[0])) == 0

    def run(dev, mesh):
        q = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in p.items() if isinstance(v, torch.Tensor)}
        q.update({k: _to(v, dev) for k, v in p.items() if isinstance(v, dict)})
        with mesh_context(mesh) if mesh is not None else \
                contextlib.nullcontext():
            y = L.moe(cfg, q, x.to(dev))
        (y ** 2).sum().backward()
        torch.cuda.synchronize() if dev.type == "cuda" else None
        return y.detach().cpu(), {k: q[k].grad.cpu()
                                  for k in ("router", "wi", "wo")}

    taken = []
    orig = getattr(L, f"_moe_ep_{branch}")

    def count(*a, **k):
        taken.append(branch)
        return orig(*a, **k)

    L_attr = f"_moe_ep_{branch}"
    setattr(L, L_attr, count)
    try:
        # repeated: a missing order between the position streams (forward
        # or backward) would show as a run far from the others
        eps = [run(cuda, _card_grid(cuda)) for _ in range(EP_REPEATS)]
        host = run(torch.device("cpu"), make_host_mesh(
            2, devices=["cpu"] * 4))
    finally:
        setattr(L, L_attr, orig)
    assert taken == [branch] * (EP_REPEATS + 1)
    one = run(cuda, None)
    for (y, g), (y_ref, g_ref) in [(ep, one) for ep in eps] + [
            (eps[0], host)]:
        assert float((y - y_ref).abs().max()) < 1e-4
        for k in g:
            d = float((g[k] - g_ref[k]).abs().max())
            assert d / (float(g_ref[k].abs().max()) + 1e-9) < 1e-5, (k, d)
    seq = getattr(L, L_attr)(cfg, {k: v.to(cuda) if isinstance(
        v, torch.Tensor) else _to(v, cuda) for k, v in p.items()},
        x2.to(cuda), _card_grid(cuda), streams=False)
    par = getattr(L, L_attr)(cfg, {k: v.to(cuda) if isinstance(
        v, torch.Tensor) else _to(v, cuda) for k, v in p.items()},
        x2.to(cuda), _card_grid(cuda))
    torch.testing.assert_close(par, seq, rtol=0, atol=1e-5)


SHARDED_REPEATS = 3
#: (arch, overrides, rows, tokens a row): drop-free for the MoE models (8
#: tokens: the stationary capacity, 8, cannot be passed; capacity_factor
#: 4: the shard-map capacity equals a shard's tokens)
SHARDED_ON_CARD = {
    "qwen3-0.6b": ("qwen3-0.6b", {"remat": True, "ce_chunk": 16}, 4, 64),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"remat": True}, 2, 4),
    "qwen3-moe-shardmap": ("qwen3-moe-30b-a3b", {"capacity_factor": 4.0},
                           4, 520),
    "internvl2-76b": ("internvl2-76b", {}, 4, 16),
}


@pytest.mark.parametrize("name", list(SHARDED_ON_CARD))
def test_sharded_step_on_card_grid(cuda, no_tf32, name):
    """The sharded train step on the 2 x 2 card grid, each position on its
    own stream, repeated: the loss within 1e-5 relative and the gathered
    gradients within ``rtol=1e-4, atol=1e-6`` of the card's one-device
    step and of the CPU grid's sharded step; a step through
    ``make_train_step`` keeps the shardings and its loss agrees with the
    one-device step's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import (NamedSharding, device_put,
                                                gather)
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.train_step import grads_and_metrics
    from repro_torch.tree import tree_leaves, tree_map_with_path

    arch, over, rows, seq = SHARDED_ON_CARD[name]
    cfg = get_config(arch, reduced=True, **over)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (rows, seq + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    opt = make_optimizer(cfg.optimizer)

    def placed(dev, mesh):
        shapes = T.init_model(cfg, None)
        pspecs = R.param_specs(cfg, shapes, mesh)

        def named(specs):
            return tree_map_with_path(lambda _, s: NamedSharding(mesh, s),
                                      specs, is_leaf=R.is_spec)
        p = _to(params, dev)
        return (device_put(p, named(pspecs)),
                device_put(opt.init(p), named(D.opt_state_specs(
                    cfg.optimizer, shapes, pspecs, mesh))))

    def close(got, want):
        assert float(got[1]["loss"]) == pytest.approx(
            float(want[1]["loss"]), rel=1e-5)
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            a = gather(a).cpu() if not isinstance(a, torch.Tensor) else a
            b = gather(b).cpu() if not isinstance(b, torch.Tensor) else b
            torch.testing.assert_close(a.cpu(), b.cpu(), rtol=1e-4,
                                       atol=1e-6)

    one = grads_and_metrics(cfg, _to(params, cuda), batch)
    grid = _card_grid(cuda)
    pl, state = placed(cuda, grid)
    runs = [grads_and_metrics(cfg, pl, batch)
            for _ in range(SHARDED_REPEATS)]
    host = grads_and_metrics(cfg, placed("cpu", make_host_mesh(
        2, devices=["cpu"] * 4))[0], batch)
    for r in runs:
        close(r, one)
    close(runs[0], host)
    before = [x.sharding for x in tree_leaves((pl, state))]
    p2, s2, m = make_train_step(cfg, opt)(pl, state, batch, np.int32(0))
    assert [x.sharding for x in tree_leaves((p2, s2))] == before
    want = make_train_step(cfg, opt)(_to(params, cuda), opt.init(
        _to(params, cuda)), batch, np.int32(0))[2]
    assert float(m["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
