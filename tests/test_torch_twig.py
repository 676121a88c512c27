"""The port's twig filtering (the paper's §5 extension) against the JAX
package's, on the CPU.

The counterparts of the 9 tests of ``tests/test_twig.py`` (parser,
decomposition, two-stage semantics, the property test against the tree
matcher), each run on the port's ``TwigFilter(device="cpu")`` and held
against the JAX ``TwigFilter`` on the same input; then parity with the JAX
filter on every engine of the registry over a seeded corpus: verdicts,
first-match ordinals and ``stats``.  Exact equality.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _hypothesis_shim import given, settings, st  # noqa: E402
from test_engines import ev_from_nested  # noqa: E402

from repro.core import twig as jax_twig  # noqa: E402
from repro.core.dictionary import TagDictionary as JaxDictionary  # noqa: E402
from repro.data.generator import DTD as JaxDTD  # noqa: E402
from repro.data.generator import gen_corpus as jax_corpus  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.dictionary import TagDictionary  # noqa: E402
from repro_torch.core.events import to_trees  # noqa: E402
from repro_torch.core.twig import (TwigFilter, _twig_matches_tree,  # noqa: E402
                                   decompose, parse_twig)
from repro_torch.core.xpath import XPathSyntaxError  # noqa: E402
from repro_torch.data.generator import DTD, gen_corpus  # noqa: E402


def _dicts(n=30):
    tags = [f"t{i}" for i in range(n)]
    return TagDictionary.build(tags), JaxDictionary.build(tags)


def _port_ev(ev):
    return tev.EventStream(ev.kind, ev.tag_id)


def _both(twigs, ev, *, engine="levelwise", n_tags=30):
    """(port result, JAX result, port filter, JAX filter) of one document
    through the same twigs; the port's result must equal the JAX one."""
    d, jd = _dicts(n_tags)
    f = TwigFilter(twigs, d, engine=engine, device="cpu")
    jf = jax_twig.TwigFilter(twigs, jd, engine=engine)
    res, want = f.filter_document(_port_ev(ev)), jf.filter_document(ev)
    np.testing.assert_array_equal(res.matched, want.matched)
    np.testing.assert_array_equal(res.first_event, want.first_event)
    assert f.stats == jf.stats
    return res, f


class TestParserAndDecomposition:
    def test_parse_linear(self):
        tq = parse_twig("a//b/c")
        assert tq.is_linear
        assert [str(q) for q in decompose(tq)] == ["//a//b/c"] == \
            [str(q) for q in jax_twig.decompose(jax_twig.parse_twig("a//b/c"))]

    def test_parse_branches(self):
        tq = parse_twig("a[b//c][d]/e")
        assert not tq.is_linear
        # bare branch head = child axis (XPath predicate semantics)
        assert {str(q) for q in decompose(tq)} == \
            {"//a/b//c", "//a/d", "//a/e"}

    def test_nested_branches(self):
        tq = parse_twig("/a[b[c]/d]//e")
        paths = {str(q) for q in decompose(tq)}
        assert paths == {"/a/b/c", "/a/b/d", "/a//e"} == {
            str(q) for q in jax_twig.decompose(
                jax_twig.parse_twig("/a[b[c]/d]//e"))}

    @pytest.mark.parametrize("bad", ["a[", "a]b", "a[]", "a[b]]"])
    def test_rejects(self, bad):
        with pytest.raises(XPathSyntaxError):
            parse_twig(bad)
        with pytest.raises(Exception) as jax_err:
            jax_twig.parse_twig(bad)
        assert type(jax_err.value).__name__ == "XPathSyntaxError"


class TestTwigSemantics:
    def test_branch_needs_both(self):
        #  t0 → (t1, t2)  vs  t0 → t1 only
        ev_both = ev_from_nested([(0, [(1, []), (2, [])])])
        ev_one = ev_from_nested([(0, [(1, [])])])
        assert _both(["t0[t1][t2]"], ev_both)[0].matched[0]
        assert not _both(["t0[t1][t2]"], ev_one)[0].matched[0]

    def test_false_positive_eliminated(self):
        """Paths match in different subtrees: the decomposition says yes,
        stage 2 must reject (the paper's stated failure mode)."""
        ev = ev_from_nested([(9, [(0, [(1, [])]), (0, [(2, [])])])])
        res, f = _both(["t0[t1][t2]"], ev)
        assert not res.matched[0]
        assert f.stats["stage2_rejects"] == 1

    def test_child_vs_descendant_branches(self):
        ev = ev_from_nested([(0, [(1, [(2, [])])])])  # t0 > t1 > t2
        res, _ = _both(["t0[/t2]", "t0[//t2]", "t0[/t1/t2]"], ev)
        assert list(res.matched) == [False, True, True]

    def test_mixed_with_linear(self):
        ev = ev_from_nested([(0, [(1, []), (2, [(3, [])])])])
        res, _ = _both(["t0/t1", "t0[t1]/t2/t3", "t0[t3]/t1",
                        "t0[//t3]/t1"], ev)
        assert list(res.matched) == [True, True, False, True]

    @settings(max_examples=30, deadline=None)
    @given(data=st.data())
    def test_property_vs_ground_truth(self, data):
        n_tags = data.draw(st.integers(2, 5))

        def tree(depth):
            return st.tuples(
                st.integers(0, n_tags - 1),
                st.lists(tree(depth - 1), max_size=3) if depth > 0
                else st.just([]))

        spec = data.draw(st.lists(tree(3), min_size=1, max_size=2))
        ev = ev_from_nested(spec)
        tags = [f"t{j}" for j in range(n_tags)]
        root = data.draw(st.sampled_from(tags))
        parts = []
        for _ in range(data.draw(st.integers(1, 2))):
            steps = [data.draw(st.sampled_from(["/", "//"]))
                     + data.draw(st.sampled_from(tags))
                     for _ in range(data.draw(st.integers(1, 2)))]
            parts.append("[" + "".join(steps) + "]")
        twig_s = root + "".join(parts)
        res, f = _both([twig_s], ev, n_tags=n_tags)
        want = _twig_matches_tree(to_trees(_port_ev(ev)), parse_twig(twig_s),
                                  f.dictionary)
        assert bool(res.matched[0]) == want, twig_s


# ------------------------------------------------ every engine, a corpus
def _corpus_twigs(names, rng, n, descendant_only):
    """The three twig shapes of ``benchmarks/bench_twig.py``; matscan
    takes descendant-only, concrete-tag paths, so its first two shapes
    use descendant branches."""
    twigs = []
    for i in range(n):
        a, b, c = rng.choice(len(names), 3, replace=False)
        if i % 3 == 0:
            twigs.append(f"{names[a]}[//{names[b]}][//{names[c]}]")
        elif i % 3 == 1:
            sep = "//" if descendant_only else ""
            twigs.append(f"{names[a]}[{sep}{names[b]}]//{names[c]}")
        else:
            twigs.append(f"{names[a]}//{names[b]}")
    return twigs


@pytest.mark.parametrize("engine", engines.names())
def test_every_engine_equals_jax(engine):
    """48 twigs over a 24-tag DTD and 8 documents: the port's filter on
    every engine of its registry gives the JAX filter's verdicts,
    first-match ordinals and stage-2 counts."""
    dtd, jdtd = DTD.generate(n_tags=24, seed=0), JaxDTD.generate(
        n_tags=24, seed=0)
    d, jd = TagDictionary(), JaxDictionary()
    dtd.register(d)
    jdtd.register(jd)
    twigs = _corpus_twigs(dtd.tag_names, np.random.default_rng(0), 48,
                          descendant_only=engine == "matscan")
    f = TwigFilter(twigs, d, engine=engine, device="cpu")
    jf = jax_twig.TwigFilter(twigs, jd, engine=engine)
    docs = gen_corpus(dtd, n_docs=8, nodes_per_doc=120, seed=1)
    jdocs = jax_corpus(jdtd, n_docs=8, nodes_per_doc=120, seed=1)
    n_matched = 0
    for ev, jev in zip(docs, jdocs):
        got, want = f.filter_document(ev), jf.filter_document(jev)
        np.testing.assert_array_equal(got.matched, want.matched)
        np.testing.assert_array_equal(got.first_event, want.first_event)
        n_matched += int(got.matched.sum())
    assert n_matched > 0
    assert f.stats == jf.stats and f.stats["stage2_checks"] > 0
    assert f.nfa.n_states == jf.nfa.n_states
