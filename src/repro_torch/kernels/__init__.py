"""Hand-written CUDA kernels of the port, their plain versions and layout.

* :mod:`.stream_filter` -- the streaming filter's megakernels K1 (events)
  and K2 (raw bytes), with plain PyTorch versions and launch counts
* :mod:`.ref`           -- plain PyTorch byte classifier and event step
* :mod:`.blocks`        -- word-aligned parent-closed state-block layout
* :mod:`.build`         -- nvcc build and ctypes loader of ``csrc/``
"""
