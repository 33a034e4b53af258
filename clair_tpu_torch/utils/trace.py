"""Spans and counters of the training path, kept in memory.

``with span("feed.wait"):`` records, into one ring of ``RING`` records that
the process's threads share: the span's name, the thread, its start and end
on ``time.perf_counter_ns``, the name of the span open around it on the
same thread, the sequence number of the batch the thread is serving
(``set_batch``), whether a torch profiler was recording, and a value.
``count(name, value)`` records a value at an instant the same way.

While a torch profiler records, a span also opens
``torch.profiler.record_function`` of its name, so the profiler's trace
shows it as a ``user_annotation`` on the trace's own clock. With no
profiler running a span makes no dispatcher call: the recorder is always
on, and a span costs about 2 microseconds of the host's time (a
``record_function`` outside a profiler about 12).

Records leave the process through the profiler's trace, the training
loop's line per epoch (pipeline/train.py) and ``records()``.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, List, NamedTuple, Optional

# a train step at batch 10,000 makes about 35 records (20 of them the
# producer's waits for blocks), a 51 s window some 22,000
RING = 1 << 16

# torch's own test of whether any profiler records (profile's start() and
# its context alike): a call into C, not the dispatcher. Looked up once
# torch is loaded, so that the feed's importers need not load it
_profiler_enabled: Optional[Callable[[], bool]] = None


def _profiling() -> bool:
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


class Record(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[str]
    batch: int
    profiled: bool
    value: Any


class _Thread(threading.local):
    def __init__(self):
        self.ident = threading.get_ident()
        self.open: Optional[str] = None  # the innermost open span's name
        self.batch = -1


_thread = _Thread()
_clock = time.perf_counter_ns
# the newest RING records, each after its serial number (deque's append
# and count's next hold the interpreter lock: threads need no lock of
# their own), oldest first
_ring: deque = deque(maxlen=RING)
_made = itertools.count()


def set_batch(sequence: int) -> None:
    """The sequence number of the batch this thread now serves, carried by
    the records it makes from here on."""
    _thread.batch = sequence


def batch() -> int:
    """The sequence number of the batch this thread serves (-1: none yet)."""
    return _thread.batch


class span:
    """Records the time spent inside it. ``value`` (settable inside) and
    ``batch`` (default: the thread's) go into the record; ``name`` may be
    changed inside, and the record takes the name it has at the end (a
    profiler's range keeps the first)."""

    __slots__ = ("name", "value", "batch", "_parent", "_range", "_profiled", "_start")

    def __init__(self, name: str, value: Any = None, batch: Optional[int] = None):
        self.name, self.value, self.batch = name, value, batch

    def __enter__(self) -> "span":
        state = _thread
        self._parent, state.open = state.open, self.name
        self._profiled = _profiling()
        self._range = None
        if self._profiled:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self._start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        end = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        state = _thread
        state.open = self._parent
        _ring.append((next(_made), self.name, state.ident, self._start, end, self._parent,
                      state.batch if self.batch is None else self.batch,
                      self._profiled or _profiling(), self.value))


def count(name: str, value: Any) -> None:
    """Records ``value`` under ``name`` now, as a span of no length."""
    state = _thread
    now = _clock()
    _ring.append((next(_made), name, state.ident, now, now, state.open, state.batch,
                  _profiling(), value))


def records(since_ns: int = 0) -> List[Record]:
    """A copy of the ring, in the order the records ended: those that
    started at or after ``since_ns``."""
    return [Record(*r[1:]) for r in list(_ring) if r[3] >= since_ns]


def dropped() -> int:
    """How many records the ring has let go since the last reset: the
    records made (the newest serial number, plus one) less those kept."""
    kept = list(_ring)
    return max(r[0] for r in kept) + 1 - len(kept) if kept else 0


def reset() -> None:
    """Empties the ring, and this thread serves no batch (for tests)."""
    global _made
    _ring.clear()
    _made = itertools.count()
    _thread.batch = -1
