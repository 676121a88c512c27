"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no card is visible, so collection is the same on every machine.  On a
machine with an H100 and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

The first test builds the kernels (``build/repro_torch/``).  Outputs are
0/1 lanes and int32 ordinals: exact equality.  The file imports nothing
of JAX, so it runs where only the port is installed.
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
