"""Quickstart on the PyTorch port: filter an XML document stream against
XPath profiles.

The twin of ``examples/quickstart.py`` through ``repro_torch``: parse
profiles → compile the shared NFA → filter a document stream → report
matching profiles and match locations.  Engines come from the port's
registry (``repro_torch.core.engines``) and run on ``--device`` (a CUDA
card by default; ``cpu`` runs each kernel's plain PyTorch version).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import engines
from repro_torch.core.dictionary import TagDictionary
from repro_torch.core.events import (CLOSE, OPEN, EventBatch, EventStream,
                                     encode_bytes)
from repro_torch.core.nfa import compile_queries
from repro_torch.core.xpath import parse
from repro_torch.kernels.ops import decode_document

# 1. user profiles (subscriptions) — the paper's §3 examples
PROFILES = ["a0//b0", "a0/b0", "/a0//c0", "//b0/c0", "a0//b0//c0"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 2. a document:  <a0><x><b0><c0/></b0></x></a0>
    tags = {"a0": 0, "x": 1, "b0": 2, "c0": 3}
    doc = EventStream(
        np.array([OPEN, OPEN, OPEN, OPEN, CLOSE, CLOSE, CLOSE, CLOSE],
                 np.int8),
        np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32))

    # 3. compile profiles → prefix-shared NFA (dictionary replacement)
    dictionary = TagDictionary.build(tags)
    queries = [parse(p) for p in PROFILES]
    nfa = compile_queries(queries, dictionary, shared=True)
    print(f"{len(queries)} profiles → {nfa.n_states} NFA states "
          f"(prefix-shared, §3.3)")

    # 4. round-trip the paper's byte format through the pre-decode kernel
    buf = encode_bytes(doc, text_fill=3)
    doc2 = decode_document(buf, dictionary, device=args.device)
    assert np.array_equal(doc2.tag_id, doc.tag_id)
    print(f"byte stream: {len(buf)} bytes → {len(doc2)} events "
          f"(§3.4 pre-decode kernel)")

    # 5. filter with every registered engine through the one batched API
    batch = EventBatch.from_streams([doc])
    for name in ("streaming", "levelwise", "yfilter"):
        eng = engines.create(name, nfa, dictionary=dictionary,
                             device=args.device)
        res = eng.filter_batch(batch)[0]
        hits = ", ".join(f"{PROFILES[q]} @ event {res.first_event[q]}"
                         for q in res.matching_queries())
        print(f"{name:>12}: {hits}")


if __name__ == "__main__":
    main()
