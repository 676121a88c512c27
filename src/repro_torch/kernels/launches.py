"""Launch counts of the kernel wrappers, safe under threads.

Every wrapper carries ``launches``, a plain int that ``chip_smoke.py``
and the card tests read and reset; a wrapper adds one where it launches
its kernel, and nowhere else.  The serve loop's worker threads launch at
the same time, and ``+=`` on an attribute is a read, an add and a write,
so :func:`count_launch` takes a lock around it.  While a profiler runs,
the launch is also counted on the request open on the launching thread
(:func:`repro_torch.tracing.count`, ``launches``).
"""
from __future__ import annotations

import threading

from .. import tracing

_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` and to the open request's
    ``launches``."""
    with _LOCK:
        wrapper.launches += 1
    tracing.count("launches")
