"""Launch entry points of the port: the serving CLI (:mod:`.serve`), the
training CLI (:mod:`.train`), the meshes (:mod:`.mesh`), the cell table
(:mod:`.cells`) and the meta-device dry run (:mod:`.dryrun`).

The JAX package's ``launch/hlo_analysis.py`` has no counterpart yet: it
parses the HLO text XLA compiles a cell to, and the port emits no HLO.
The dry run reads its bytes from the rule specs and its FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` instead; its collective and
accessed bytes are still to come, counted from the collectives the port
writes out (see :mod:`.dryrun`)."""
