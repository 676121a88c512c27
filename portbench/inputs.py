"""A run's inputs, made from its seed: tag names, profile strings and the
pool of wire payloads the window cycles through.  The program and the
reference are handed the same.

The DTD (the schema) and the profile set's paths are the deployment's
and come from the configuration (``dtd.seed``, ``profiles.seed``); the
profiles are drawn by the generator of their language
(``profiles.kind``, ``languages/<kind>.py``).  The run's seed draws the
element names, which tag gets which wire code, the order of the profiles
(so which shard each lands on), and the documents.  Every seed so gets
the same profile set and the same multiset of document sizes (``sizes``),
in its own order: a seed changes the data and not the amount of work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import languages
from .gen import grammar, wire

# independent random streams of one seed
_NAMES, _CODES, _PROFILE_ORDER, _ORDER, _DOCS = 1, 2, 3, 4, 5


@dataclass
class Inputs:
    tag_names: list[str]         # tag_names[i] has wire code i
    profiles: list[str]          # profile g has global id g
    payloads: list[bytes]        # the pool, indexed by pool position
    seed: int
    kind: str                    # the profile language, languages/<kind>

    @property
    def pool_bytes(self) -> np.ndarray:
        return np.array([len(p) for p in self.payloads], np.int64)


def sizes(spec: dict, n: int) -> np.ndarray:
    """Elements of each of ``n`` documents: ``"fixed"`` at ``nodes[0]``,
    or the ``n`` quantile midpoints of the log-uniform distribution over
    ``[nodes[0], nodes[1]]``, rounded."""
    lo, hi = spec["nodes"]
    if spec["dist"] == "fixed":
        return np.full(n, int(lo), np.int64)
    if spec["dist"] == "loguniform":
        q = (np.arange(n) + 0.5) / n
        return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                       ).astype(np.int64)
    raise ValueError(f"unknown size distribution {spec['dist']!r}")


def make(config: dict, traffic: dict, seed: int) -> Inputs:
    children = grammar.dtd(**config["dtd"])
    n_tags = config["dtd"]["n_tags"]
    names = grammar.tag_names(n_tags, grammar.rng_for(seed, _NAMES))
    code_order = grammar.rng_for(seed, _CODES).permutation(n_tags)
    code = np.argsort(code_order)           # DTD tag -> wire code
    p = config["profiles"]
    language = languages.kind(config)
    paths = languages.get(language).profiles(
        children, names, p, np.random.default_rng(p["seed"]))
    order = grammar.rng_for(seed, _PROFILE_ORDER).permutation(p["count"])
    docs = config["documents"]
    n = traffic["pool"]
    nodes = sizes(docs, n)[grammar.rng_for(seed, _ORDER).permutation(n)]
    payloads = []
    for i, k in enumerate(nodes):
        kind, tag = grammar.document(children, n_nodes=int(k),
                                     max_depth=docs["max_depth"],
                                     rng=grammar.rng_for(seed, _DOCS, i))
        payloads.append(wire.encode(kind, code[tag], docs["text_fill"]))
    return Inputs([names[t] for t in code_order],
                  [paths[i] for i in order], payloads, seed, language)
