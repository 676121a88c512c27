"""Frozen workload generators: the DTD, tag names, XPath profiles and
documents of a deployment, drawn from a seed.

Copied from the port's ``data/generator.py`` (``DTD.generate``,
``gen_profiles``, ``gen_document``) and kept here so that a change to the
program cannot change the benchmark's inputs.  The grammar is the same:

* the DTD is a layered parent -> children tag hierarchy with a few
  recursive tags (``dtd`` is a verbatim copy of ``DTD.generate``);
* a profile walks ``length`` steps down the DTD from the root and mutates
  each step into ``//`` with probability ``p_desc`` (the first step
  always) and into ``*`` with probability ``p_wild`` (YFilter's
  PathGenerator);
* a document emits root elements until its node budget is spent; each
  element below ``max_depth`` that has children in the DTD gets 0-3
  children, each drawn uniformly from them (ToXGene-style).

What differs from the port's copy is only how the random numbers are
drawn: in bulk, not one generator call per node, so a 60,000-node
document takes tens of milliseconds instead of a second.  The same seed
gives the same output.
"""
from __future__ import annotations

import numpy as np

OPEN, CLOSE = 0, 1

_NAME_FIRST = "abcdefghijklmnopqrstuvwxyz"
_NAME_REST = "abcdefghijklmnopqrstuvwxyz0123456789_"


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one input stream of one run seed.
    Any whole number is a seed, negative or past 64 bits included."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             (seed >> 64) & 0xFFFFFFFF, int(seed < 0)]
    return np.random.default_rng(words + [int(s) for s in stream])


def dtd(n_tags: int, fanout: int, seed: int) -> dict[int, list[int]]:
    """Tag id -> allowed child tag ids; the root's children under -1."""
    rng = np.random.default_rng(seed)
    children: dict[int, list[int]] = {}
    layers = np.array_split(np.arange(n_tags), max(2, n_tags // 6))
    children[-1] = list(layers[0])
    for li, layer in enumerate(layers):
        nxt = layers[li + 1] if li + 1 < len(layers) else layer
        for t in layer:
            k = int(rng.integers(1, fanout + 1))
            opts = rng.choice(nxt, size=min(k, len(nxt)), replace=False)
            children[int(t)] = [int(x) for x in opts]
    for t in rng.choice(n_tags, size=max(1, n_tags // 12), replace=False):
        children[int(t)].append(int(t))
    return {k: [int(x) for x in v] for k, v in children.items()}


def tag_names(n: int, rng: np.random.Generator) -> list[str]:
    """``n`` distinct element names of 3 to 10 characters."""
    names: list[str] = []
    seen: set[str] = set()
    while len(names) < n:
        size = int(rng.integers(3, 11))
        first = _NAME_FIRST[int(rng.integers(len(_NAME_FIRST)))]
        rest = rng.integers(len(_NAME_REST), size=size - 1)
        name = first + "".join(_NAME_REST[i] for i in rest)
        if name not in seen:
            seen.add(name)
            names.append(name)
    return names


def profiles(children: dict[int, list[int]], names: list[str], *, n: int,
             length: int, p_desc: float, p_wild: float,
             rng: np.random.Generator) -> list[str]:
    """``n`` linear XPath profiles as strings (``//a/b//*/c``...)."""
    pick = rng.random((n, length))
    desc = rng.random((n, length)) < p_desc
    wild = rng.random((n, length)) < p_wild
    out: list[str] = []
    for q in range(n):
        parts: list[str] = []
        cur = -1
        for i in range(length):
            opts = children.get(cur)
            if not opts:
                break
            cur = opts[int(pick[q, i] * len(opts))]
            axis = "//" if (i == 0 or desc[q, i]) else "/"
            parts.append(axis + ("*" if wild[q, i] else names[cur]))
        out.append("".join(parts))
    return out


def document(children: dict[int, list[int]], *, n_nodes: int,
             max_depth: int, rng: np.random.Generator
             ) -> tuple[np.ndarray, np.ndarray]:
    """One document as event arrays ``(kind, tag)``: every element is an
    OPEN then, after its subtree, a CLOSE; exactly ``n_nodes`` elements."""
    # each element takes one draw for itself and at most one for its
    # child count
    u = rng.random(2 * n_nodes + 2).tolist()
    pos = 0
    kinds: list[int] = []
    tags: list[int] = []
    budget = n_nodes
    stack: list[list[int]] = []   # [tag, depth, children still to emit]

    def open_(tag: int, depth: int) -> None:
        nonlocal pos, budget
        budget -= 1
        kinds.append(OPEN)
        tags.append(tag)
        left = 0
        if depth < max_depth and children.get(tag):
            left = int(u[pos] * 4)
            pos += 1
        stack.append([tag, depth, left])

    roots = children[-1]
    while budget > 0:
        root = roots[int(u[pos] * len(roots))]
        pos += 1
        open_(root, 1)
        while stack:
            top = stack[-1]
            if top[2] > 0 and budget > 0:
                top[2] -= 1
                opts = children[top[0]]
                child = opts[int(u[pos] * len(opts))]
                pos += 1
                open_(child, top[1] + 1)
            else:
                kinds.append(CLOSE)
                tags.append(top[0])
                stack.pop()
    return np.asarray(kinds, np.int8), np.asarray(tags, np.int32)

