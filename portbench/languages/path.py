"""Linear XPath profiles (``/``, ``//``, ``*``): YFilter's PathGenerator
(``gen.grammar.profiles``), the Shift-And reference
(``reference.automaton``), its control without the tag stack, and the
roofline's count (``roofline.states_per_tag``, ``document_work``)."""
from __future__ import annotations

import numpy as np

from .. import roofline
from ..gen import grammar
from ..reference.automaton import Automaton


def profiles(children: dict[int, list[int]], names: list[str], spec: dict,
             rng: np.random.Generator) -> list[str]:
    return grammar.profiles(children, names, n=spec["count"],
                            length=spec["length"], p_desc=spec["p_desc"],
                            p_wild=spec["p_wild"], rng=rng)


class StacklessAutomaton(Automaton):
    """The control: the reference with the parent-child guarantee
    broken.  Every ``/`` step is taken as ``//``, the filter a design
    without the paper's tag stack would give (§3.5): faster, and wrong
    wherever a profile needs a parent, not just an ancestor."""

    def __init__(self, profiles: list[str], tag_names: list[str]):
        super().__init__([_all_descendant(p) for p in profiles], tag_names)


def _all_descendant(profile: str) -> str:
    out = profile.replace("//", "/").replace("/", "//")
    return out if out.startswith("/") else "//" + out


matcher = Automaton
control = StacklessAutomaton


def work_counter(profiles: list[str], tag_names: list[str]):
    """The work of one document, ``(payload, *, matches, dense) -> (ops,
    bytes)``, with the per-tag states counted once."""
    per_tag = roofline.states_per_tag(profiles, tag_names)

    def work(payload: bytes, *, matches: int, dense: bool) -> tuple[int, int]:
        return roofline.document_work(payload, per_tag,
                                      n_profiles=len(profiles),
                                      matches=matches, dense=dense)
    return work
