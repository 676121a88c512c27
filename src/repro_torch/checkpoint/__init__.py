"""Training checkpoints (:class:`CheckpointStore`, the JAX store's format)
and the crash-safe compiled-plan cache (:class:`PlanCache`)."""
from .store import CheckpointStore, PlanCache  # noqa: F401
