"""Distribution of the LM substrate over a mesh of positions: the rule
specs (:mod:`.rules`), the mesh context (:mod:`.ctx`), trees placed on
a mesh (:mod:`.placement`) and the hooks through which the placed layers
report their collectives (:mod:`.counters`).

Counterpart of ``src/repro/sharding/``.  Its ``compat.py`` is a shim over
``jax.shard_map``'s moving keyword arguments, a JAX-version concern with
no counterpart here: the port's ``shard_map`` is a loop over positions
(:func:`repro_torch.models.layers._moe_ep_shardmap`).
"""
from .ctx import axis_size, constrain, mesh_context  # noqa: F401
