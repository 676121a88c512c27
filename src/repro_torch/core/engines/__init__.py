"""Filtering engines of the port behind one contract.

``create("streaming", nfa, device="cuda")`` builds an engine from the
port's own registry; importing this package registers the ported engines.
"""
from . import base  # noqa: F401
from .base import (FilterEngine, FilterPlan, create, get,  # noqa: F401
                   names, register)
from .result import NO_MATCH, FilterResult, SparseResult  # noqa: F401

# importing the implementation modules populates the registry
from . import streaming as _streaming    # noqa: F401,E402
