"""Filtering engines of the port behind one contract.

``create("streaming", nfa, device="cuda")`` builds an engine from the
port's own registry; importing this package registers every engine of
the JAX package:

* ``oracle``    — recursive tree-walk ground truth (host Python).
* ``yfilter``   — event-driven software baseline (host Python).
* ``streaming`` — the bit-packed megakernels K1–K4 (and K5's parse).
* ``levelwise`` — the NFA advanced level by level over precomputed
  structure; ``use_kernel=True`` runs K6.
* ``wavefront`` — levelwise with fixed-width level chunks; K6 under
  ``use_kernel=True``.
* ``matscan``   — paper-literal regex semantics as transition-matrix
  prefix products.
"""
from . import base  # noqa: F401
from .base import (FilterEngine, FilterPlan, create, get,  # noqa: F401
                   names, register)
from .result import NO_MATCH, FilterResult, SparseResult  # noqa: F401

# importing the implementation modules populates the registry
from . import oracle as _oracle          # noqa: F401,E402
from . import yfilter as _yfilter        # noqa: F401,E402
from . import streaming as _streaming    # noqa: F401,E402
from . import levelwise as _levelwise    # noqa: F401,E402
from . import matscan as _matscan        # noqa: F401,E402
