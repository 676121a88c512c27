"""Profile languages found by name: the path language reads what it read
before, and the twig language's frozen generator, plain reference,
control and work count."""
import hashlib
import json
import re

import numpy as np
import pytest

from portbench import check, inputs, languages, spec
from portbench.gen import grammar, wire
from portbench.languages import twig as twig_lang
from portbench.reference import twig as ref_twig
from portbench.reference import wire as ref_wire
from portbench.reference.automaton import Automaton, prefix_states

CHILD, DESC = ref_twig.CHILD, ref_twig.DESC


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else json.dumps(p).encode())
    return h.hexdigest()[:16]


def _scaled(config: str, count: int = 300, nodes: int = 400) -> dict:
    cfg = spec.config(config)
    cfg["profiles"]["count"] = count
    if cfg["documents"]["dist"] == "fixed":
        cfg["documents"]["nodes"] = [nodes, nodes]
    return cfg


# (inputs, answers, work) digests at 300 profiles, a pool of 6 and 1 MB
# documents cut to 400 elements, computed on the tree before profile
# languages existed
PATH_FINGERPRINTS = {
    ("xpath10k-doc1mb", 11): ("16acd722eec397ae", "26eaeb319fd83d9e",
                              "40a30e4c553dba02"),
    ("xpath10k-doc1mb", 2**31 + 3): ("62c43d3aede6e667", "371f826063724a2a",
                                     "ae94dc1f301add21"),
    ("xpath10k-msg8kb", 11): ("f92196d09f782512", "9ec83f453dd29e07",
                              "6354ff3bbb130879"),
    ("xpath10k-msg8kb", 2**31 + 3): ("f7f6db5edf9b1ae7", "b144bc43b1a93b27",
                                     "f2c7ba79aa5fef22"),
}


@pytest.mark.parametrize("config,seed", sorted(PATH_FINGERPRINTS))
def test_the_path_language_reads_what_it_read_before(config, seed):
    cfg = _scaled(config)
    inp = inputs.make(cfg, {"pool": 6}, seed)
    assert inp.kind == "path"
    want, counts = check.expected(inp, cfg["shards"])
    work_of = languages.get(inp.kind).work_counter(inp.profiles,
                                                   inp.tag_names)
    dense = cfg["delivery"] == "dense"
    work = [list(work_of(p, matches=m, dense=dense))
            for p, m in zip(inp.payloads, counts)]
    got = (_digest(inp.tag_names, inp.profiles, *inp.payloads),
           _digest([[[s, v.tolist()] for s, v in sorted(w.items())]
                    for w in want], counts),
           _digest(work))
    assert got == PATH_FINGERPRINTS[config, seed]


def test_languages_are_found_by_kind():
    assert languages.kind({"profiles": {}}) == "path"
    assert languages.kind(spec.config("xpath10k-twig-doc1mb")) == "twig"
    for name in ("path", "twig"):
        lang = languages.get(name)
        assert all(callable(getattr(lang, f))
                   for f in ("profiles", "matcher", "control",
                           "work_counter"))
    with pytest.raises(ModuleNotFoundError):
        languages.get("no_such_language")


# ------------------------------------------------------------ the generator
def _twig_inputs(seed: int, count: int = 200, nodes: int = 300,
                 pool: int = 3):
    cfg = _scaled("xpath10k-twig-doc1mb", count, nodes)
    return cfg, inputs.make(cfg, {"pool": pool}, seed)


def _dtd_names(seed: int) -> list[str]:
    """The run's names in DTD order (``inputs.make``'s own draw)."""
    return grammar.tag_names(128, grammar.rng_for(seed, inputs._NAMES))


def _canonical(profile: str, names: list[str]) -> str:
    index = {n: i for i, n in enumerate(names)}
    return re.sub(r"[A-Za-z_][-A-Za-z0-9_.]*",
                  lambda m: f"t{index[m.group(0)]}", profile)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_twig_inputs_are_deterministic_by_seed(seed):
    a, b = _twig_inputs(seed)[1], _twig_inputs(seed)[1]
    assert (a.kind, a.tag_names, a.profiles, a.payloads) == \
        ("twig", b.tag_names, b.profiles, b.payloads)
    c = _twig_inputs(seed + 1)[1]
    assert c.profiles != a.profiles and c.payloads != a.payloads


def test_every_seed_gets_the_same_twig_set():
    runs = {s: _twig_inputs(s)[1] for s in (1, 2**40 + 9)}
    assert runs[1].profiles != runs[2**40 + 9].profiles
    shapes = [sorted(_canonical(p, _dtd_names(s)) for p in r.profiles)
              for s, r in runs.items()]
    assert shapes[0] == shapes[1]


def test_twigs_parse_in_the_reference_and_in_the_program():
    from repro_torch.core.twig import decompose, parse_twig

    _, inp = _twig_inputs(3, count=400)
    for p in inp.profiles:
        assert not parse_twig(p).is_linear
        assert {str(q) for q in decompose(parse_twig(p))} == \
            set(twig_lang.paths(p))
        ref_twig.parse(p)


def test_twigs_follow_the_dtd_and_the_configuration():
    children = grammar.dtd(128, 4, 0)
    names = _dtd_names(0)
    cfg = spec.config("xpath10k-twig-doc1mb")["profiles"]
    twigs = twig_lang.profiles(children, names, dict(cfg, count=500),
                               np.random.default_rng(cfg["seed"]))
    index = {n: i for i, n in enumerate(names)}

    def fits(node, parents: set[int]) -> set[int]:
        """DTD tags the node can stand for below one of ``parents``, with
        each step under it a DTD child of the step above."""
        tag, below = node
        can = {t for p in parents for t in children.get(p, [])
               if tag == "*" or index[tag] == t}
        return {t for t in can if all(fits(sub, {t}) for _, sub in below)}

    # stripped of predicates, the trunks are grammar.profiles' profiles
    linear = grammar.profiles(children, names, n=500, length=6,
                              p_desc=0.3, p_wild=0.1,
                              rng=np.random.default_rng(cfg["seed"]))
    n_preds, lengths = [], []
    for t, lin in zip(twigs, linear):
        anchored, root = ref_twig.parse(t)
        assert not anchored and fits(root, {-1})
        trunk = t
        while "[" in trunk:
            trunk = re.sub(r"\[[^][]*\]", "", trunk)
        assert trunk == lin
        preds = re.findall(r"\[([^][]*)\]", t)
        n_preds.append(len(preds))
        lengths += [len(re.findall(r"[A-Za-z_*][-A-Za-z0-9_.]*", p))
                    for p in preds]
    assert set(n_preds) == {1, 2} and set(lengths) == {1, 2, 3}
    assert any(p.startswith("//") for t in twigs
               for p in re.findall(r"\[([^][]*)\]", t))


# ------------------------------------------------------------ the reference
def _render(node, head: str) -> str:
    tag, below = node
    out = head + tag
    for axis, sub in below[:-1]:
        out += "[" + _render(sub, "" if axis == CHILD else "//") + "]"
    if below:
        axis, sub = below[-1]
        out += _render(sub, "/" if axis == CHILD else "//")
    return out


def _random_twig(rng, n_tags: int, depth: int = 0):
    tag = "*" if rng.random() < 0.2 else f"t{rng.integers(n_tags)}"
    k = 0 if depth >= 3 else int(rng.choice([0, 1, 1, 2, 3]))
    return tag, tuple((DESC if rng.random() < 0.4 else CHILD,
                       _random_twig(rng, n_tags, depth + 1))
                      for _ in range(k))


def _brute_force(root, anchored: bool, kind, tag, names) -> bool:
    """Whether some embedding of the twig exists, by trying every
    element for every node."""
    parent, kids, stack = [], [], []
    for k, t in zip(kind.tolist(), tag.tolist()):
        if k == 0:
            parent.append(stack[-1] if stack else -1)
            kids.append([])
            if stack:
                kids[stack[-1]].append(len(parent) - 1)
            stack.append(len(parent) - 1)
        else:
            stack.pop()
    tags = tag[kind == 0].tolist()

    def below(e):
        for c in kids[e]:
            yield c
            yield from below(c)

    def at(node, e) -> bool:
        name, reqs = node
        if name != "*" and names[tags[e]] != name:
            return False
        return all(any(at(sub, c) for c in
                       (kids[e] if axis == CHILD else below(e)))
                   for axis, sub in reqs)

    starts = [e for e in range(len(tags)) if not anchored or parent[e] < 0]
    return any(at(root, e) for e in starts)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_the_reference_agrees_with_a_brute_force_search(seed):
    rng = np.random.default_rng(seed)
    n_tags = 6
    names = [f"t{i}" for i in range(n_tags)]
    children = grammar.dtd(n_tags, 3, seed)
    trees = [(_random_twig(rng, n_tags), bool(rng.random() < 0.3))
             for _ in range(80)]
    # two predicates on one node, and two that one element satisfies
    trees += [(("t0", ((CHILD, ("t1", ())), (CHILD, ("t1", ())),
                       (DESC, ("*", ())))), False),
              (("*", ((DESC, ("t2", ())), (CHILD, ("*", ((CHILD, ("t3",
                                                           ())),))))), True)]
    twigs = [_render(r, "/" if a else str(rng.choice(["//", ""])))
             for r, a in trees]
    # the last step below a node is written as the trunk's next one, the
    # others as predicates, in order: the order the parse gives back
    assert [ref_twig.parse(tw) for tw in twigs] == [(a, r) for r, a in trees]
    reference = ref_twig.Twigs(twigs, names)
    seen = set()
    for d in range(8):
        kind, tag = grammar.document(children, n_nodes=int(10 + 6 * d),
                                     max_depth=5, rng=rng)
        got = reference.matches(wire.encode(kind, tag, 0)).tolist()
        want = [i for i, (r, a) in enumerate(trees)
                if _brute_force(r, a, kind, tag, names)]
        assert got == want, d
        seen |= {len(want) > 0, len(want) < len(twigs)}
    assert seen == {True}


@pytest.mark.parametrize("config", ["xpath10k-doc1mb", "xpath10k-msg8kb"])
def test_twigs_without_branches_give_the_linear_answers(config):
    cfg = _scaled(config, count=200)
    inp = inputs.make(cfg, {"pool": 4}, 21)
    profiles = inp.profiles + ["/" + p.lstrip("/") for p in inp.profiles[:40]]
    linear = Automaton(profiles, inp.tag_names)
    twigs = ref_twig.Twigs(profiles, inp.tag_names)
    total = 0
    for p in inp.payloads:
        want = linear.matches(p)
        assert np.array_equal(twigs.matches(p), want)
        total += want.size
    assert total > 0


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_the_reference_agrees_with_the_programs_cpu_twig_filter(seed):
    from repro_torch.core import events as tev
    from repro_torch.core.dictionary import TagDictionary
    from repro_torch.core.twig import TwigFilter

    _, inp = _twig_inputs(seed, count=150, nodes=400, pool=3)
    dictionary = TagDictionary()
    ids = np.array([dictionary.add(n) for n in inp.tag_names])
    program = TwigFilter(inp.profiles, dictionary, device="cpu")
    reference = twig_lang.matcher(inp.profiles, inp.tag_names)
    total = 0
    for p in inp.payloads:
        is_open, tag = ref_wire.decode(p)
        ev = tev.EventStream(np.where(is_open, tev.OPEN, tev.CLOSE), ids[tag])
        got = np.flatnonzero(program.filter_document(ev).matched)
        want = reference.matches(p)
        assert np.array_equal(got, want)
        total += want.size
    assert 0 < total < len(inp.profiles) * len(inp.payloads)


# ---------------------------------------------------- the control and work
def _doc(events) -> bytes:
    """``[(open?, tag id), ...]`` as a wire payload."""
    kind = np.array([0 if o else 1 for o, _ in events])
    return wire.encode(kind, np.array([t for _, t in events]), 0)


def test_the_control_misses_the_join():
    names = ["r", "a", "b", "c"]
    # <r><a><b/></a><a><c/></a></r>: b and c under different a's
    apart = _doc([(1, 0), (1, 1), (1, 2), (0, 2), (0, 1), (1, 1), (1, 3),
                  (0, 3), (0, 1), (0, 0)])
    # <r><a><b/><c/></a></r>
    together = _doc([(1, 0), (1, 1), (1, 2), (0, 2), (1, 3), (0, 3), (0, 1),
                     (0, 0)])
    twigs = ["a[b]/c", "//r/a", "//a[b]"]
    reference = twig_lang.matcher(twigs, names)
    control = twig_lang.control(twigs, names)
    assert reference.matches(apart).tolist() == [1, 2]
    assert control.matches(apart).tolist() == [0, 1, 2]
    assert reference.matches(together).tolist() == [0, 1, 2]
    assert control.matches(together).tolist() == [0, 1, 2]
    inp = inputs.Inputs(names, twigs, [apart, together], 0, "twig")
    want, _ = check.expected(inp, 2)
    got, _ = check.expected(inp, 2, twig_lang.control(twigs, names))
    assert [check.same(g, w) for g, w in zip(got, want)] == [False, True]


def test_the_control_is_wrong_on_small_twig_inputs():
    cfg, inp = _twig_inputs(7, count=300, nodes=400, pool=4)
    want, _ = check.expected(inp, cfg["shards"])
    got, _ = check.expected(inp, cfg["shards"], languages.get(
        inp.kind).control(inp.profiles, inp.tag_names))
    assert sum(not check.same(g, w) for g, w in zip(got, want)) > 0


def test_twig_work_by_hand():
    names = ["r", "a", "b"]
    doc = _doc([(1, 0), (1, 1), (0, 1), (1, 2), (0, 2), (0, 0)])
    # paths //r/a, //r/b: states r, r/a, r/b; r branches
    ops, nbytes = twig_lang.work_counter(["//r[a]/b"], names)(
        doc, matches=1, dense=True)
    assert (ops, nbytes) == ((1 + 1 + 1) + 1 + 1, len(doc) + 1)
    # and //*/a, //*/b: states *, */a, */b; * branches too:
    # opens r 2, a 3, b 3; closes r 2, a 1, b 1
    twigs = ["//r[a]/b", "//*[a][b]"]
    work = twig_lang.work_counter(twigs, names)
    ops, nbytes = work(doc, matches=2, dense=True)
    assert (ops, nbytes) == (8 + 4 + 2, len(doc) + 2)
    ops, nbytes = work(doc, matches=2, dense=False)
    assert (ops, nbytes) == (8 + 4 + 2, len(doc) + 16)
    assert prefix_states(twig_lang.paths("//*[a][b]")) == {"*": 1, "a": 1,
                                                            "b": 1}
