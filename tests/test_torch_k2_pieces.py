"""K2 in pieces in time, on the CPU: the shape rule that picks the pieces,
the plan's window algebra, and the split's invariant on the plain path.

On the card K2 may run each (segment, state block) chain as P pieces, each
started from its ancestors' stack rows (``csrc/stream_filter.cu``).  The
kernel cannot run here, so these tests hold what it rests on:

* :func:`stream_filter.pieces_for` as a pure function of the launch's
  shape and the card's resident blocks;
* the plan the device computes (window walks composed by scans, each
  cut's depth, first ordinal and ancestors, found through the windows'
  least depths), modelled here step by step against a direct walk of the
  events;
* the invariant itself: pieces cut on window edges, each prefixed with
  its ancestors' open tags and run through the plain kernel, merge (OR of
  the lanes, least ordinal mapped back) to the whole document's lanes.

The file imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import BLOCK_TABLES
from repro_torch.core import engines
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import SEG_SENTINEL, encode_bytes
from repro_torch.core.nfa import compile_queries
from repro_torch.data.generator import DTD, gen_document, gen_profiles
from repro_torch.kernels import ref
from repro_torch.kernels import stream_filter as sf

KB = BLOCK_TABLES[:7]
#: the symbol bytes of a tag id's two halves (``ref.symbol_value``'s order)
SYMBOLS = (b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
           b"_.")


# ------------------------------------------------------------ shape rule
@pytest.mark.parametrize("shape, want", [
    # (G, S, D, L, resident blocks)
    ((11, 16, 2, 1_020_928, 528), 1),        # packed segments
    ((11, 48, 1, 1_020_928, 528), 1),        # G·S at capacity
    ((11, 64, 1, 1_020_928, 528), 1),        # G·S above it
    ((11, 16, 1, 12 * 1024, 528), 1),        # a piece under the floor
    # the 1 MB cell: 528 chains in one wave; 4 pieces would take two
    # waves of a quarter each (704 chains), 16.1 ms against 11.4 at 3 on
    # an H100
    ((11, 16, 1, 1_020_928, 528), 3),
    # 211 chains: 2 pieces fit one wave (1/2); 5 take two waves of a
    # fifth (2/5)
    ((211, 1, 1, 10 ** 7, 528), 5),
])
def test_pieces_for(shape, want):
    assert sf.pieces_for(*shape) == want


def test_pieces_for_stops_at_the_floor_and_the_grid():
    floor = sf.MIN_PIECE_WINDOWS * sf.WINDOW
    assert sf.pieces_for(1, 1, 1, 5 * floor, 528) == 5
    assert sf.pieces_for(1, 1, 1, 5 * floor - 1, 528) == 5
    assert sf.pieces_for(1, 1, 1, 5 * floor - sf.WINDOW, 528) == 4
    assert sf.pieces_for(1, 30_000, 1, 10 ** 6, 10 ** 6) == 2
    assert sf.pieces_for(0, 16, 1, 10 ** 6, 528) == 1


# ------------------------------------------------------- documents, walks
def workload(seed, n_queries=60):
    dtd = DTD.generate(n_tags=16, seed=seed)
    d = TagDictionary()
    dtd.register(d)
    qs = gen_profiles(dtd, n=n_queries, length=4, p_desc=0.4, p_wild=0.15,
                      seed=seed)
    eng = engines.create("streaming", compile_queries(qs, d, shared=True),
                         dictionary=d, device="cpu", blk=64)
    return dtd, eng


def document(dtd, seed, nodes=220, stray=False):
    """A generated document's bytes; ``stray`` puts a close before its
    root, at depth 0."""
    buf = encode_bytes(gen_document(dtd, target_nodes=nodes, max_depth=12,
                                    seed=seed), text_fill=5)
    if stray:
        at = buf.index(b"</")
        buf = buf[at:at + 4] + b">" + buf
    return buf


def events_of(buf: bytes):
    """Every event of the bytes: (position, kind, tag) in byte order."""
    kind, tag = ref.predecode(torch.frombuffer(bytearray(buf), dtype=torch.uint8))
    pos = torch.nonzero(kind != ref.PAD)[:, 0]
    return [(int(p), int(kind[p]), int(tag[p])) for p in pos]


def ancestors(events, cut):
    """The opens still open at byte ``cut`` (closes at the root do
    nothing), root first, as (tag, ordinal), and the events before it."""
    stack, n = [], 0
    for pos, kind, tag in events:
        if pos >= cut:
            break
        if kind == ref.OPEN:
            stack.append((tag, n))
        elif stack:
            stack.pop()
        n += 1
    return stack, n


# ------------------------------------------------- the plan's algebra
IDENT = (0, 0, 0, 0, 0)        # (events, net, lo, hi, rise)


def compose(a, b):
    return (a[0] + b[0], a[1] + b[1], min(a[2], a[1] + b[2]),
            max(a[3], a[1] + b[3]), max(a[4], b[4], a[1] - a[2] + b[3]))


def step(kind):
    return (1, -1, -1, 0, 0) if kind == ref.CLOSE else (1, 1, 0, 1, 1)


def depth_after(w, d):
    return max(d + w[1], w[1] - w[2])


def model_plan(buf, n_pieces, max_depth):
    """The device's piece plan, step by step: the windows' walks, their
    depths and least depths, then each piece's (windows, first ordinal,
    ancestors' tags)."""
    n_windows = -(-len(buf) // sf.WINDOW)
    evs = events_of(buf)
    walks = [IDENT] * n_windows
    for pos, kind, _ in evs:
        walks[pos // sf.WINDOW] = compose(walks[pos // sf.WINDOW], step(kind))
    pre, depth, low = IDENT, [], []
    for w in walks:
        d = depth_after(pre, 0)
        depth.append(d)
        low.append(max(0, d + w[2]))
        pre = compose(pre, w)
    clipped = pre[4] > max_depth + 1
    plan = []
    for i in range(n_pieces):
        c0, c1 = i * n_windows // n_pieces, (i + 1) * n_windows // n_pieces
        if clipped:
            c0, c1 = 0, n_windows if i == 0 else 0
        big_d = 0 if clipped else depth[c0]
        base = sum(w[0] for w in walks[:c0])
        tags = []
        for k in range(1, big_d + 1):
            win = max(w for w in range(c0) if low[w] < k)
            dep, tag = depth[win], None
            for pos, kind, t in evs:
                if win * sf.WINDOW <= pos < (win + 1) * sf.WINDOW:
                    if kind == ref.CLOSE:
                        dep = max(dep - 1, 0)
                    else:
                        dep += 1
                        if dep == k:
                            tag = t
            tags.append(tag)
        plan.append((c0, c1, base, tags))
    return plan, clipped


@pytest.mark.parametrize("seed, stray, max_depth", [
    (3, False, 64), (4, True, 64), (5, False, 5)])
def test_plan_finds_each_cut_s_ordinal_and_ancestors(seed, stray, max_depth):
    dtd, _ = workload(seed)
    buf = document(dtd, seed, nodes=400, stray=stray)
    evs = events_of(buf)
    deepest = max(len(ancestors(evs, p)[0]) for p, _, _ in evs)
    for n_pieces in (2, 3, 7):
        plan, clipped = model_plan(buf, n_pieces, max_depth)
        assert clipped == (deepest > max_depth + 1)
        if clipped:
            assert plan[0][:2] == (0, -(-len(buf) // sf.WINDOW))
            assert all(c0 == c1 == 0 for c0, c1, _, _ in plan[1:])
            continue
        for c0, _, base, tags in plan:
            stack, n = ancestors(evs, c0 * sf.WINDOW)
            assert base == n
            assert tags == [t for t, _ in stack]
    assert max_depth == 5 or deepest >= 4


# ------------------------------------------------ the split's invariant
def tag_bytes(tag: int) -> bytes:
    return bytes([SYMBOLS[tag // 64], SYMBOLS[tag % 64]])


def pieces_of(buf, cuts):
    """Byte rows of the pieces [cuts[i], cuts[i+1]): each prefixed with its
    ancestors' open tags and followed by the three bytes after it with no
    '<' (they only decode the piece's last positions), and for each piece
    the ancestors' ordinals and its first event's ordinal."""
    evs = events_of(buf)
    rows, meta = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        stack, base = ancestors(evs, a)
        head = b"".join(b"<" + tag_bytes(t) for t, _ in stack)
        tail = buf[b:b + 3].replace(b"<", b" ")
        rows.append(head + buf[a:b] + tail)
        meta.append(([o for _, o in stack], base))
    return rows, meta


def plain_k2(rows, tables, max_depth):
    length = max(map(len, rows))
    data = np.zeros((len(rows), length), np.uint8)
    for r, row in enumerate(rows):
        data[r, :len(row)] = np.frombuffer(row, np.uint8)
    starts = np.full((len(rows), 2), SEG_SENTINEL, np.int32)
    starts[:, 0] = 0
    m, f = sf.stream_filter_bytes_plain(
        torch.from_numpy(data), torch.from_numpy(starts), *tables,
        max_depth=max_depth)
    return m[:, :, 0].numpy(), f[:, :, 0].numpy()      # (S, G, QB)


@pytest.mark.parametrize("seed, stray", [(7, False), (8, True), (9, False)])
def test_pieces_merge_to_the_whole_document(seed, stray):
    dtd, eng = workload(seed)
    tables = [eng.plan_[k] for k in KB]
    max_depth = int(eng.plan_.meta["max_depth"])
    buf = document(dtd, seed, stray=stray)
    n_windows = -(-len(buf) // sf.WINDOW)
    rng = np.random.default_rng(seed)
    inner = rng.choice(np.arange(1, n_windows), size=min(4, n_windows - 1),
                       replace=False)
    cuts = [0] + sorted(int(c) * sf.WINDOW for c in inner) + [len(buf)]
    whole_m, whole_f = plain_k2([buf], tables, max_depth)
    rows, meta = pieces_of(buf, cuts)
    m, f = plain_k2(rows, tables, max_depth)
    merged_m = np.zeros_like(whole_m[0])
    merged_f = np.full_like(whole_f[0], sf.NO_MATCH)
    for r, (anc_ord, base) in enumerate(meta):
        a = len(anc_ord)
        hit = m[r] != 0
        ords = np.where(f[r] < a,
                        np.asarray(anc_ord + [0])[np.minimum(f[r], a)],
                        f[r] - a + base)
        merged_m |= m[r]
        merged_f = np.where(hit, np.minimum(merged_f, ords), merged_f)
    assert whole_m.any() and len(rows) >= 3
    assert any(len(anc) >= 2 for anc, _ in meta)
    np.testing.assert_array_equal(merged_m, whole_m[0])
    np.testing.assert_array_equal(merged_f, whole_f[0])
