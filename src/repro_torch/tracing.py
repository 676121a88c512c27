"""Spans and counters of the port, recorded while ``torch.profiler`` runs.

The routing path and the serve loop mark their layer boundaries with
:func:`span` and count work with :func:`count`.  Nothing is recorded
unless a profiler session is active (``torch.profiler.profile`` or
``torch.autograd.profiler.profile``): then each span keeps

* its name, its start and end on ``time.perf_counter_ns``, its thread;
* its own id and its parent's id (the enclosing span on the same thread,
  or a span of another thread passed as ``parent=``);
* a request id, shared by every span of one stage batch: the id of the
  outermost ``root=True`` span of its chain;
* attributes: what the call site sets on ``Span.attrs``, and the
  counters (:func:`count`) that the work below the nearest root span on
  the same thread added to it.

Each recorded span also opens a profiler range under its name, so a
profiler trace shows the program's host spans beside the kernels, on the
profiler's clock.  The range is a ``cpu_op`` (``_RecordFunctionFast``),
not a ``record_function`` ``user_annotation``: the profiler mirrors a
user annotation onto the card's timeline over the kernels launched in
it, as a CUDA event that a device trace would take for work on the card
(an ``engine.launch`` of 11.24 s and an ``engine.readback`` of 0.19 s in
a 20 s window of 1 MB requests on an H100).  Finished spans stay in
memory, in one buffer of :data:`CAPACITY` spans per process; past it the
oldest are dropped and counted (:func:`dropped`).  Nothing is written to
a file.

With no profiler active, :func:`span` returns a shared no-op context
manager and :func:`count` returns at once, after one read of the
profiler's flag: nothing is allocated and no clock is read.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: finished spans kept; past it the oldest are dropped and counted
CAPACITY = 1 << 16


@dataclass
class Span:
    """One recorded span; ``end_ns`` is -1 while it is open."""

    name: str
    id: int
    parent: int | None
    request: int | None
    thread: int
    start_ns: int
    end_ns: int = -1
    attrs: dict = field(default_factory=dict)
    #: the root span on this span's thread that its counters go to
    owner: "Span | None" = field(default=None, repr=False, compare=False)


def recording() -> bool:
    """True while a profiler session is active (on any thread)."""
    return _profiler._is_profiler_enabled


#: the context manager of every span that is not recorded
_OFF = contextlib.nullcontext()


class _Recorder:
    """The buffer of finished spans and every thread's open ones."""

    def __init__(self, capacity: int = CAPACITY):
        self._done: deque[Span] = deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, parent: Span | None, root: bool) -> Span:
        stack = self.stack()
        if parent is None and stack:
            parent = stack[-1]
        sid = next(self._ids)
        request = parent.request if parent is not None else None
        if root and request is None:
            request = sid
        sp = Span(name, sid, None if parent is None else parent.id, request,
                  threading.get_ident(), time.perf_counter_ns())
        sp.owner = sp if root else (parent.owner if parent is not None
                                    and parent.thread == sp.thread else None)
        stack.append(sp)
        return sp

    def close(self, sp: Span) -> None:
        sp.end_ns = time.perf_counter_ns()
        stack = self.stack()
        if stack and stack[-1] is sp:
            stack.pop()
        with self._lock:
            if len(self._done) == self._done.maxlen:
                self._dropped += 1
            self._done.append(sp)

    def owner(self) -> Span | None:
        stack = self.stack()
        return stack[-1].owner if stack else None

    def count(self, name: str, n: int) -> None:
        owner = self.owner()
        if owner is not None:
            with self._lock:
                owner.attrs[name] = owner.attrs.get(name, 0) + n

    def spans(self, t0_ns: int | None, t1_ns: int | None) -> list[Span]:
        with self._lock:
            done = list(self._done)
        return [s for s in done
                if (t0_ns is None or s.end_ns >= t0_ns)
                and (t1_ns is None or s.start_ns <= t1_ns)]

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self._dropped = 0


_RECORDER = _Recorder()


class _On:
    """The context manager of a recorded span."""

    __slots__ = ("_name", "_parent", "_root", "_span", "_rf")

    def __init__(self, name: str, parent: Span | None, root: bool):
        self._name, self._parent, self._root = name, parent, root

    def __enter__(self) -> Span:
        # the clock is read just before the profiler stamps its event, as
        # a marker beside a ``perf_counter_ns`` reading is taken
        self._rf = _RecordFunctionFast(self._name)
        self._span = _RECORDER.open(self._name, self._parent, self._root)
        self._rf.__enter__()
        return self._span

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        _RECORDER.close(self._span)
        return False


def span(name: str, *, parent: Span | None = None, root: bool = False):
    """A span named ``name`` around the ``with`` block, yielding its
    :class:`Span` (whose ``attrs`` the caller may fill) while a profiler
    runs and ``None`` otherwise.  ``parent`` is a span of another thread
    that caused this one; by default the parent is the innermost span
    open on this thread.  A ``root`` span receives the counters of the
    work below it on its thread, and starts a request id unless its
    parent already carries one."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, parent, root)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the root span open on this
    thread (nothing when none is open or no profiler runs)."""
    if _profiler._is_profiler_enabled:
        _RECORDER.count(name, n)


def note(name: str, value) -> None:
    """Set the attribute ``name`` of the root span open on this thread
    (nothing when none is open or no profiler runs)."""
    if _profiler._is_profiler_enabled:
        owner = _RECORDER.owner()
        if owner is not None:
            owner.attrs[name] = value


def spans(t0_ns: int | None = None, t1_ns: int | None = None
          ) -> list[Span]:
    """Finished spans that overlap ``[t0_ns, t1_ns]`` (all by default),
    oldest first."""
    return _RECORDER.spans(t0_ns, t1_ns)


def dropped() -> int:
    """Finished spans dropped from the full buffer since the last
    :func:`clear`."""
    return _RECORDER.dropped()


def clear() -> None:
    """Forget every finished span and the dropped count."""
    _RECORDER.clear()
