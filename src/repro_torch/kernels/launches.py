"""Launch counts of the kernel wrappers, safe under threads.

Every wrapper carries ``launches``, a plain int that ``chip_smoke.py``
and the card tests read and reset; a wrapper adds one where it launches
its kernel, and nowhere else.  The serve loop's worker threads launch at
the same time, and ``+=`` on an attribute is a read, an add and a write,
so :func:`count_launch` takes a lock around it.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``."""
    with _LOCK:
        wrapper.launches += 1
