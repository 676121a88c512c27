"""Hand-written CUDA kernels of the port, their plain versions and layout.

* :mod:`.stream_filter` -- the streaming filter's megakernels K1 (events),
  K2 (raw bytes) and their sparse twins K4 and K3, with plain PyTorch
  versions and launch counts
* :mod:`.predecode`     -- the character pre-decoder K5
* :mod:`.parse`         -- device parse: bytes → an event batch on the card
* :mod:`.ref`           -- plain PyTorch byte classifier, event step and
  sparse epilogue
* :mod:`.blocks`        -- word-aligned parent-closed state-block layout
* :mod:`.build`         -- nvcc build and ctypes loader of ``csrc/``
"""
