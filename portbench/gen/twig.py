"""Frozen generator of twig profiles: linear XPath trunks with
nested-path predicates, as YFilter's workload generator makes them
(Diao et al., "Path sharing and predicate evaluation for high-performance
XML filtering", ACM TODS 28(4), 2003).

* Each twig's trunk is drawn exactly as ``grammar.profiles`` draws a
  linear profile (``length``, ``p_desc``, ``p_wild``), from the same first
  three draws of the generator: stripped of its predicates, twig ``q`` is
  ``grammar.profiles``' profile ``q`` at the same seed.
* It then gets a count of predicates drawn uniformly from ``branches``
  ``[lo, hi]``, each attached at a uniformly chosen trunk step.
* A predicate is a chain of ``branch_length`` ``[lo, hi]`` steps walked
  down the DTD from the tag the trunk drew at its step (under a ``*`` step
  too), so that a document of the DTD can satisfy it.  Each step, the head
  included, is ``//`` with probability ``p_desc`` and ``*`` with
  probability ``p_wild``: ``[b...]`` a child head, ``[//b...]`` a
  descendant one.

The syntax is the port's ``core/twig.py``'s: ``//a[b//c][//d]/e``.  The
branches' draws are made in bulk, for the most each twig could take, so
the output depends on the seed alone.
"""
from __future__ import annotations

import numpy as np


def twigs(children: dict[int, list[int]], names: list[str], *, n: int,
          length: int, p_desc: float, p_wild: float,
          branches: tuple[int, int], branch_length: tuple[int, int],
          rng: np.random.Generator) -> list[str]:
    """``n`` twig profiles as strings."""
    pick = rng.random((n, length))
    desc = rng.random((n, length)) < p_desc
    wild = rng.random((n, length)) < p_wild
    b_lo, b_hi = branches
    l_lo, l_hi = branch_length
    count = b_lo + (rng.random(n) * (b_hi - b_lo + 1)).astype(np.int64)
    at = rng.random((n, b_hi))
    size = l_lo + (rng.random((n, b_hi)) * (l_hi - l_lo + 1)).astype(np.int64)
    b_pick = rng.random((n, b_hi, l_hi))
    b_desc = rng.random((n, b_hi, l_hi)) < p_desc
    b_wild = rng.random((n, b_hi, l_hi)) < p_wild
    out: list[str] = []
    for q in range(n):
        trunk: list[tuple[str, int]] = []      # (step text, DTD tag)
        cur = -1
        for i in range(length):
            opts = children.get(cur)
            if not opts:
                break
            cur = opts[int(pick[q, i] * len(opts))]
            axis = "//" if (i == 0 or desc[q, i]) else "/"
            trunk.append((axis + ("*" if wild[q, i] else names[cur]), cur))
        preds: list[list[str]] = [[] for _ in trunk]
        for b in range(count[q]):
            step = int(at[q, b] * len(trunk))
            cur = trunk[step][1]
            parts: list[str] = []
            for j in range(size[q, b]):
                opts = children.get(cur)
                if not opts:
                    break
                cur = opts[int(b_pick[q, b, j] * len(opts))]
                axis = "//" if b_desc[q, b, j] else ("/" if j else "")
                parts.append(axis + ("*" if b_wild[q, b, j] else names[cur]))
            if parts:
                preds[step].append("".join(parts))
        out.append("".join(text + "".join(f"[{p}]" for p in ps)
                           for (text, _), ps in zip(trunk, preds)))
    return out
