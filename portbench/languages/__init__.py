"""A configuration's profile language, found by name: ``profiles.kind``
in the configuration (``"path"`` where it is absent) names
``languages/<kind>.py``.  Each such module holds

* ``profiles(children, names, spec, rng) -> list[str]``: the frozen
  generator, from the DTD, the run's tag names, the configuration's
  ``profiles`` and a generator seeded by ``profiles.seed``;
* ``matcher(profiles, tag_names)``: the plain reference, an object whose
  ``matches(payload)`` gives the sorted global ids a document matches;
* ``control(profiles, tag_names)``: the same with one guarantee broken,
  which ``correct`` has to catch;
* ``work_counter(profiles, tag_names)``: the count of what one document
  needs, from the inputs alone, as a function ``(payload, *, matches,
  dense) -> (ops, bytes)``; what depends only on the profiles is counted
  once, when it is made.

A new language is a new module here; nothing else names one.
"""
from __future__ import annotations

import importlib
from types import ModuleType


def kind(config: dict) -> str:
    return config["profiles"].get("kind", "path")


def get(name: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{name}")
