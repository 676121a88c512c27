"""The crash-safe compiled-plan cache (:class:`PlanCache`).

``CheckpointStore``, the JAX package's training checkpoints, flattens
pytrees with JAX and serves only the LM-training substrate, so it comes
with that substrate (ROADMAP queue 1 item 14).
"""
from .store import PlanCache  # noqa: F401
