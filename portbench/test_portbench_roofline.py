"""The roofline counts come from the inputs alone: hand-checked on a tiny
case, and unchanged when the program's plan layout changes."""
import ast
from pathlib import Path

import numpy as np
import pytest

from portbench import inputs, roofline, spec
from portbench.drivers import build_stage
from portbench.gen import wire


def test_counts_by_hand():
    names = ["r", "a", "b"]
    # shared prefixes: //r, //r/a, //r//a, //*, //*/b -> r:1 a:2 b:1 *:1
    profiles = ["//r/a", "//r//a", "//r", "//*/b"]
    per_tag = roofline.states_per_tag(profiles, names)
    assert per_tag.tolist() == [1 + 1, 2 + 1, 1 + 1]
    kind = np.array([0, 0, 0, 1, 1, 1])          # <r><a><b/></a></r>
    doc = wire.encode(kind, np.array([0, 1, 2, 2, 1, 0]), 3)
    ops, nbytes = roofline.document_work(doc, per_tag, n_profiles=4,
                                         matches=3, dense=True)
    assert ops == (2 + 3 + 2) + 4 and nbytes == len(doc) + 4
    ops, nbytes = roofline.document_work(doc, per_tag, n_profiles=4,
                                         matches=3, dense=False)
    assert ops == 7 + 3 and nbytes == len(doc) + 8 * 3
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.share_pct(0, 0, 1.0) is None
    assert roofline.share_pct(67e12, 0, 4.0) == pytest.approx(25.0)


def test_roofline_reads_nothing_of_the_program():
    tree = ast.parse(Path(roofline.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert not any(m.startswith("repro") for m in mods)


@pytest.mark.parametrize("blk", [64, 256])
def test_count_unchanged_when_the_plan_layout_changes(blk):
    from repro_torch.core import engines

    cfg = spec.config("xpath10k-doc1mb")
    cfg["profiles"]["count"] = 300
    cfg["documents"]["nodes"] = [400, 400]
    inp = inputs.make(cfg, {"pool": 4}, 17)
    per_tag = roofline.states_per_tag(inp.profiles, inp.tag_names)
    work = lambda: [roofline.document_work(p, per_tag, n_profiles=300,
                                           matches=0, dense=True)
                    for p in inp.payloads]
    before = work()
    default = build_stage(cfg, inp, batch_size=4, device="cpu")
    other = build_stage(cfg, inp, batch_size=4, device="cpu")
    other._eng = engines.create("streaming", other.nfa,
                                dictionary=other.dictionary, device="cpu",
                                event_bucket=other.bucket, blk=blk)
    layouts = [s._eng.plan_.meta["blk"] for s in (default, other)]
    assert layouts[0] != layouts[1]
    routes = [[(rd.doc_index, rd.shard, sorted(rd.matched_profiles))
               for b in s.route_bytes(inp.payloads) for rd in b]
              for s in (default, other)]
    assert routes[0] == routes[1]
    assert work() == before
