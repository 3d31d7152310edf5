"""Wall-clock spans and counters inside the port, on the profiler's clock.

The rest of :mod:`repro_torch.obs` runs on the modeled FPGA cycle clock;
this module records where the *host* spends real time, at the program's own
layer boundaries (the serving loop, the U-Net forward, the MMA kernel's
launch, the training step)::

    with timeline.span("segserve.pack"):
        ...
    timeline.count("segserve.requests")

Both are off by default, and off costs two flag reads (this module's and
the profiler's): no clock read, no profiler range, no allocation.  They are
on

* while a ``torch.profiler`` records: each span is then also a
  ``record_function`` range of the same name in the profiler's trace, so
  the device's idle gaps can be told by the program span open over them;
* inside :func:`recording`, which records the spans alone, without the
  profiler's cost.

A span is stamped with ``time.time_ns()``, the epoch nanoseconds the
profiler stamps its own events with, and knows its parent: the span open
around it in the same thread (the autograd engine runs a backward, and
under remat the forward it recomputes, on threads of its own).
:func:`last` returns what the most recent recording holds.  A recording
starts at the first span or count of a :func:`recording` block, or of a
profiler session after :func:`last` was read; so a profiled window holds
nothing of what ran before it.

These records are not events of the cycle-clock bus (:mod:`.events`) and
take no part in its reproducible streams.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

_now = time.time_ns  # the profiler's clock: epoch nanoseconds


class WallSpan(NamedTuple):
    """One recorded span.  ``parent`` indexes :attr:`Recording.spans`;
    ``end_ns`` is None while the span is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    rid: int | None
    thread: int


class Recording:
    """The spans (in the order they opened) and counts of one recording."""

    def __init__(self, closed: bool = False):
        self.spans: list[WallSpan] = []
        self.counts: dict[str, int] = {}
        self.closed = closed  # the next span or count starts a new recording

    def named(self, name: str) -> list[WallSpan]:
        return [s for s in self.spans if s.name == name and s.end_ns is not None]

    def ms(self, name: str) -> list[float]:
        """Each finished span ``name``'s length in milliseconds."""
        return [(s.end_ns - s.start_ns) * 1e-6 for s in self.named(name)]


_lock = threading.Lock()
_local = threading.local()  # .open: indices of this thread's open spans
_on = False  # inside recording()
_last = Recording(closed=True)  # the most recent recording


def _recording() -> Recording:
    """The open recording, or a new one in its place (lock held)."""
    global _last
    if _last.closed:
        _last = Recording()
    return _last


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


_PENDING = WallSpan("", 0, None, None, None, 0)  # a slot taken, not yet stamped


class _Span:
    __slots__ = ("name", "rid", "rec", "index", "open", "range")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        parent = stack[-1] if stack else None
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
        with _lock:
            self.rec = _recording()
            self.index = len(self.rec.spans)
            self.rec.spans.append(_PENDING)
        stack.append(self.index)
        # stamped just outside the profiler's range, so the record holds
        # the range whole and their starts differ by the range's entry alone
        start = _now()
        if self.range is not None:
            self.range.__enter__()
        self.open = WallSpan(self.name, start, None, parent, self.rid, threading.get_ident())
        self.rec.spans[self.index] = self.open
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(None, None, None)
        end = _now()
        _local.open.pop()
        self.rec.spans[self.index] = self.open._replace(end_ns=end)
        return False


def span(name: str, rid: int | None = None):
    """A context manager that records ``name`` over its body while tracing
    is on (``rid``: the request or microbatch the work belongs to), and
    does nothing else while it is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, rid)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _lock:
        rec = _recording()
        rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counts over the block, without the profiler; yields
    the :class:`Recording`, which :func:`last` returns afterwards too."""
    global _on, _last
    if _on:
        raise RuntimeError("timeline.recording() does not nest")
    with _lock:
        rec = _last = Recording()
    _on = True
    try:
        yield rec
    finally:
        _on = False
        rec.closed = True


def last() -> Recording:
    """The most recent recording (empty if there was none).  Read after a
    profiler session has ended, it closes that session's recording, so the
    next session starts a new one."""
    with _lock:
        if not (_on or _profiler._is_profiler_enabled):
            _last.closed = True
        return _last
