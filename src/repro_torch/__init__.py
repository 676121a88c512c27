"""PyTorch/CUDA port of the XML filter (``src/repro`` is the JAX reference).

The package mirrors the JAX package's module paths, so each module's
counterpart is found by name.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``; its kernels are CUDA C++ for Hopper
(``kernels/csrc``), built at first use.
"""
