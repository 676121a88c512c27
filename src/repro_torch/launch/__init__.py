"""Launch entry points of the port: the serving CLI (:mod:`.serve`), the
training CLI (:mod:`.train`), the meshes (:mod:`.mesh`), the cell table
(:mod:`.cells`), the meta-device dry run (:mod:`.dryrun`) and its
counters (:mod:`.cost_analysis`).

The JAX package's ``launch/hlo_analysis.py`` parses the HLO text XLA
compiles a cell to; the port emits no HLO, so :mod:`.cost_analysis`
counts the same quantities where the port's partitioned steps run: the
collectives it writes out, the aten ops' bytes and FLOPs."""
