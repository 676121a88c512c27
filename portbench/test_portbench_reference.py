"""The reference against the program's own CPU route, on both
configurations at a tiny size, and the control against the reference."""
import numpy as np
import pytest

from portbench import check, inputs, spec
from portbench.drivers import build_stage
from portbench.languages import path
from portbench.reference.automaton import Automaton, parse


def tiny(config: str, seed: int, n_profiles: int = 120, pool: int = 6):
    cfg = spec.config(config)
    cfg["profiles"]["count"] = n_profiles
    if cfg["documents"]["dist"] == "fixed":
        cfg["documents"]["nodes"] = [400, 400]
    mix = {"pool": pool}
    return cfg, inputs.make(cfg, mix, seed)


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
@pytest.mark.parametrize("config", ["xpath10k-doc1mb", "xpath10k-msg8kb"])
def test_reference_agrees_with_the_programs_cpu_route(config, seed):
    cfg, inp = tiny(config, seed)
    stage = build_stage(cfg, inp, batch_size=4, device="cpu")
    want, counts = check.expected(inp, cfg["shards"])
    assert sum(counts) > 0
    got: dict[int, list] = {}
    for routed in stage.route_bytes(inp.payloads):
        for rd in routed:
            got.setdefault(rd.doc_index, []).append(rd)
    for i, w in enumerate(want):
        assert check.same(check.answer_of(got.get(i, [])), w), i


def test_parse_and_anchoring():
    assert parse("//a/b//*") == [(1, "a"), (0, "b"), (1, "*")]
    assert parse("a/b") == [(1, "a"), (0, "b")]
    with pytest.raises(ValueError):
        parse("/a b")
    names = ["r", "a", "b"]

    def doc(*events):              # (open?, tag id)
        from portbench.gen import wire
        kind = np.array([0 if o else 1 for o, _ in events])
        return wire.encode(kind, np.array([t for _, t in events]), 0)

    # <r><a><b/></a></r>
    d = doc((1, 0), (1, 1), (1, 2), (0, 2), (0, 1), (0, 0))
    auto = Automaton(["/r/a", "/a", "//a/b", "//r/b", "//r//b", "/r//*/b",
                      "//b/a"], names)
    assert auto.matches(d).tolist() == [0, 2, 4, 5]


def test_control_breaks_the_parent_child_guarantee():
    cfg, inp = tiny("xpath10k-msg8kb", 5, n_profiles=400, pool=24)
    want, _ = check.expected(inp, cfg["shards"])
    ctrl, _ = check.expected(inp, cfg["shards"],
                             path.StacklessAutomaton(inp.profiles,
                                                     inp.tag_names))
    wrong = sum(not check.same(c, w) for c, w in zip(ctrl, want))
    assert wrong > 0
