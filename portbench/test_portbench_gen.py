"""The frozen generators: deterministic by seed, the grammar's shapes,
and the wire format the reference decodes."""
import numpy as np
import pytest

from portbench import inputs, spec
from portbench.gen import arrivals, grammar, wire
from portbench.reference import wire as ref_wire

CHILDREN = grammar.dtd(128, 4, 0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3, 2**70 + 1])
def test_inputs_are_deterministic_by_seed(seed):
    cfg, mix = spec.config("xpath10k-msg8kb"), spec.traffic("backlog")
    cfg["profiles"]["count"] = 50
    mix["pool"] = 12
    a, b = inputs.make(cfg, mix, seed), inputs.make(cfg, mix, seed)
    assert a.tag_names == b.tag_names and a.profiles == b.profiles
    assert a.payloads == b.payloads
    c = inputs.make(cfg, mix, seed + 1)
    assert c.profiles != a.profiles and c.payloads != a.payloads


def test_every_seed_gets_the_same_sizes():
    cfg, mix = spec.config("xpath10k-msg8kb"), spec.traffic("backlog")
    cfg["profiles"]["count"] = 10
    mix["pool"] = 40
    lens = [sorted(len(p) for p in inputs.make(cfg, mix, s).payloads)
            for s in (1, 2)]
    assert lens[0] == lens[1]
    assert 60 * 17 <= lens[0][0] and lens[0][-1] <= 470 * 17


@pytest.mark.parametrize("nodes", [1, 60, 470, 5000])
def test_document_follows_the_dtd(nodes):
    kind, tag = grammar.document(CHILDREN, n_nodes=nodes, max_depth=12,
                                 rng=np.random.default_rng(nodes))
    assert (kind == 0).sum() == nodes == (kind == 1).sum()
    stack, deepest = [], 0
    for k, t in zip(kind.tolist(), tag.tolist()):
        if k == 0:
            parent = stack[-1] if stack else -1
            assert t in CHILDREN[parent]
            stack.append(t)
            deepest = max(deepest, len(stack))
        else:
            assert stack.pop() == t
    assert not stack and deepest <= 12


def test_profiles_follow_the_dtd():
    names = grammar.tag_names(128, np.random.default_rng(1))
    assert len(set(names)) == 128
    index = {n: i for i, n in enumerate(names)}
    profs = grammar.profiles(CHILDREN, names, n=300, length=6, p_desc=0.3,
                             p_wild=0.1, rng=np.random.default_rng(2))
    steps = [p.replace("//", "/").split("/")[1:] for p in profs]
    assert all(p.startswith("//") for p in profs)
    assert all(len(s) == 6 for s in steps)
    wild = sum(x == "*" for s in steps for x in s) / (6 * len(steps))
    assert 0.05 < wild < 0.15
    for s in steps:               # concrete steps lie on a DTD path
        first = s[0]
        assert first == "*" or index[first] in CHILDREN[-1]


def test_wire_round_trip():
    kind, tag = grammar.document(CHILDREN, n_nodes=300, max_depth=12,
                                 rng=np.random.default_rng(3))
    buf = wire.encode(kind, tag, 8)
    assert len(buf) == 300 * (4 + 8 + 5)
    is_open, got = ref_wire.decode(buf)
    assert np.array_equal(is_open, kind == 0) and np.array_equal(got, tag)
    with pytest.raises(ValueError):
        ref_wire.decode(buf[:-2])


def test_arrivals():
    rng = np.random.default_rng(0)
    p = arrivals.offsets({"process": "poisson", "rate_hz": 1000.0}, 5000,
                         rng)
    assert np.all(np.diff(p) >= 0) and 4.5 < p[-1] < 5.5
    b = arrivals.offsets({"process": "burst", "rate_hz": 1000.0,
                          "on_s": 0.05, "off_s": 0.15}, 5000, rng)
    assert b.size == 5000 and 17 < b[-1] < 23


def test_every_seed_gets_the_same_automaton():
    from portbench.reference.automaton import prefix_states

    cfg, mix = spec.config("xpath10k-doc1mb"), {"pool": 2}
    cfg["profiles"]["count"] = 500
    cfg["documents"]["nodes"] = [50, 50]
    runs = [inputs.make(cfg, mix, s) for s in (1, 2)]
    assert runs[0].profiles != runs[1].profiles
    assert runs[0].tag_names != runs[1].tag_names
    shape = [sorted(prefix_states(r.profiles).values()) for r in runs]
    assert shape[0] == shape[1]
