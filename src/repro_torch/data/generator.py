# Copy of src/repro/data/generator.py (the port imports nothing of the JAX package).
"""Synthetic XML workload generator.

The paper evaluates with ToXGene-generated documents over a DTD and
YFilter's ``PathGenerator`` for profiles (§4): profiles of path length
2/4/6, query counts 16–1024, documents of 1–8 MB.  This module generates
the equivalent workload:

* :class:`DTD` — a randomly generated parent→children tag grammar (like
  the NITF/book DTDs used with ToXGene): a rooted DAG-ish tag hierarchy.
* :func:`gen_document` — random trees following the DTD, serialized as
  event streams (and paper-format bytes via :mod:`repro.core.events`).
* :func:`gen_profiles` — random root-to-descendant paths through the DTD
  with configurable ``//`` and ``*`` probabilities — exactly what
  PathGenerator does.

Deterministic given the seed; no external data needed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.dictionary import TagDictionary
from ..core.events import CLOSE, OPEN, EventStream
from ..core.xpath import Query, parse


@dataclass
class DTD:
    """tag id → allowed child tag ids (root children from tag -1)."""

    n_tags: int
    children: dict[int, list[int]]
    tag_names: list[str]

    @classmethod
    def generate(cls, n_tags: int = 24, fanout: int = 4,
                 seed: int = 0) -> "DTD":
        rng = np.random.default_rng(seed)
        names = [f"t{i}" for i in range(n_tags)]
        children: dict[int, list[int]] = {}
        # layered hierarchy with some cross-links → realistic recursion-free
        # core plus a few recursive tags (XML DTDs commonly have both)
        layers = np.array_split(np.arange(n_tags), max(2, n_tags // 6))
        children[-1] = list(layers[0])
        for li, layer in enumerate(layers):
            nxt = layers[li + 1] if li + 1 < len(layers) else layer
            for t in layer:
                k = int(rng.integers(1, fanout + 1))
                opts = rng.choice(nxt, size=min(k, len(nxt)), replace=False)
                children[int(t)] = [int(x) for x in opts]
        # a couple of recursive tags
        for t in rng.choice(n_tags, size=max(1, n_tags // 12), replace=False):
            children[int(t)].append(int(t))
        return cls(n_tags, children, names)

    def register(self, dictionary: TagDictionary) -> None:
        for n in self.tag_names:
            dictionary.add(n)


def gen_document(dtd: DTD, *, target_nodes: int = 200, max_depth: int = 12,
                 seed: int = 0) -> EventStream:
    """Random document tree following the DTD (event-stream form)."""
    rng = np.random.default_rng(seed)
    kinds: list[int] = []
    tags: list[int] = []
    budget = [target_nodes]

    def emit(tag: int, depth: int) -> None:
        if budget[0] <= 0:
            return
        budget[0] -= 1
        kinds.append(OPEN)
        tags.append(tag)
        if depth < max_depth:
            opts = dtd.children.get(tag, [])
            if opts:
                n_kids = int(rng.integers(0, 4))
                for _ in range(n_kids):
                    if budget[0] <= 0:
                        break
                    emit(int(rng.choice(opts)), depth + 1)
        kinds.append(CLOSE)
        tags.append(tag)

    while budget[0] > 0:
        emit(int(rng.choice(dtd.children[-1])), 1)
    return EventStream(np.array(kinds, np.int8), np.array(tags, np.int32))


def gen_profiles(dtd: DTD, *, n: int = 64, length: int = 4,
                 p_desc: float = 0.3, p_wild: float = 0.1,
                 seed: int = 0) -> list[Query]:
    """PathGenerator-equivalent: random DTD paths with //, * mutations."""
    rng = np.random.default_rng(seed)
    out: list[Query] = []
    for _ in range(n):
        tags: list[int] = []
        cur = -1
        for _ in range(length):
            opts = dtd.children.get(cur, [])
            if not opts:
                break
            cur = int(rng.choice(opts))
            tags.append(cur)
        parts = []
        for i, t in enumerate(tags):
            axis = "//" if (i == 0 or rng.random() < p_desc) else "/"
            name = "*" if rng.random() < p_wild else dtd.tag_names[t]
            parts.append(axis + name)
        out.append(parse("".join(parts)))
    return out


def gen_corpus(dtd: DTD, *, n_docs: int, nodes_per_doc: int = 200,
               seed: int = 0) -> list[EventStream]:
    return [gen_document(dtd, target_nodes=nodes_per_doc, seed=seed + i)
            for i in range(n_docs)]
