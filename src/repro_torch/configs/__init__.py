# Copy of src/repro/configs/__init__.py, importing the port's modules (the port imports nothing of the JAX package).
"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``get_config(name, reduced=True)`` returns the smoke-test-sized config of
the same family.  ``--arch <id>`` in the launchers resolves here.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = (
    "qwen3-0.6b",
    "deepseek-coder-33b",
    "qwen1.5-110b",
    "starcoder2-7b",
    "zamba2-7b",
    "internvl2-76b",
    "mamba2-780m",
    "whisper-large-v3",
    "qwen3-moe-30b-a3b",
    "deepseek-v3-671b",
)


def get_config(name: str, *, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    cfg: ModelConfig = mod.config()
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg
