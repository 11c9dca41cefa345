"""One span recorder for the port: spans and counters of the work inside
a job, on one clock that the main process and the HaplotypeCaller's
worker processes share.

Off by default. ``cli`` switches it on for a ``--timed`` job
(:func:`enable`, the root span ``job``, :func:`disable`); the worker pool
switches its workers on and off by message and, at the end of a traced
``call_variants``, drains their records into this process
(:func:`drain`, :func:`merge`), so that they outlive the pool.

- :func:`span` ``(name, **attrs)``, a context manager, records the name,
  start, end, the enclosing span on the same thread (its parent), the job,
  the process and the thread: per-phase, per-batch and per-task work.
- :func:`count` ``(name, n, ns)`` and :func:`counting` ``(name)`` add to a
  counter of calls and summed nanoseconds per (job, process, thread): work
  done once per haplotype or per region.
- :func:`snapshot` returns every record so far and leaves them in place;
  records accumulate across the traced jobs of a process until read.

The clock is ``time.perf_counter_ns()``, which is CLOCK_MONOTONIC on
Linux: the same clock in every process of the machine. Spans are kept up
to ``CAP`` per process; what is dropped beyond it is counted. Off,
:func:`span` and :func:`counting` return one shared object that does
nothing and :func:`count` returns at once: no clock is read and nothing
is allocated.
"""

from __future__ import annotations

import itertools
import os
import threading
from time import perf_counter_ns
from typing import Dict, List, Optional

# spans kept per process; later ones are counted as dropped
CAP = 1 << 18

# the fields of a span record, in the order the recorder keeps them
SPAN_FIELDS = ("name", "start", "end", "id", "parent", "job", "pid", "proc",
               "thread", "attrs")
COUNTER_FIELDS = ("job", "pid", "proc", "thread", "name", "count", "ns")


class _Recorder:
    """The process's records and switch (one instance, ``_REC``)."""

    def __init__(self):
        self.on = False
        self.job = None
        self.proc = "main"
        self.pid = os.getpid()
        self.spans: List[tuple] = []
        self.counters: Dict[tuple, list] = {}
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def keep(self, rec: tuple) -> None:
        if len(self.spans) < CAP:
            self.spans.append(rec)
        else:
            with self.lock:
                self.dropped += 1


_REC = _Recorder()


class _Noop:
    """What :func:`span` and :func:`counting` return when the recorder is
    off: false, and does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass

    def child(self, name: str):
        return None


NOOP = _Noop()


class Span:
    """One span while it is open. ``set`` adds attributes before it ends;
    ``child(name)`` is the first span of that name that ended inside it on
    the same thread; ``seconds`` is its length once it has ended."""

    __slots__ = ("name", "attrs", "start", "end", "sid", "parent", "job", "kids")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.kids = name, attrs, None

    def __enter__(self):
        st = _REC.stack()
        self.parent = st[-1] if st else None
        self.sid = next(_REC.ids)
        self.job = _REC.job
        st.append(self)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = perf_counter_ns()
        _REC.stack().pop()
        p = self.parent
        if p is not None:
            if p.kids is None:
                p.kids = {}
            p.kids.setdefault(self.name, self)
        _REC.keep((self.name, self.start, self.end, self.sid,
                   p.sid if p is not None else None, self.job, _REC.pid,
                   _REC.proc, threading.current_thread().name, self.attrs or None))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def child(self, name: str) -> Optional["Span"]:
        return self.kids.get(name) if self.kids else None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Counting:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        count(self.name, 1, perf_counter_ns() - self.t0)
        return False


def span(name: str, **attrs):
    """A span named ``name`` (with ``attrs``) as a context manager, or the
    shared no-op when the recorder is off."""
    return Span(name, attrs) if _REC.on else NOOP


def count(name: str, n: int = 1, ns: int = 0) -> None:
    """Add ``n`` calls and ``ns`` nanoseconds to this thread's counter
    ``name`` in the current job."""
    if not _REC.on:
        return
    key = (_REC.job, _REC.pid, _REC.proc, threading.current_thread().name, name)
    c = _REC.counters.get(key)
    if c is None:
        c = _REC.counters.setdefault(key, [0, 0])
    c[0] += n
    c[1] += ns


def counting(name: str):
    """A context manager that counts one call of ``name`` and its
    nanoseconds, or the shared no-op when the recorder is off."""
    return _Counting(name) if _REC.on else NOOP


def enable(job, proc: str = "main") -> None:
    """Record from now on, under ``job``; ``proc`` names the kind of
    process (``main``, ``worker``) in every record."""
    _REC.job, _REC.proc, _REC.pid = job, proc, os.getpid()
    _REC.on = True


def disable() -> None:
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def current_job():
    return _REC.job


def drain() -> dict:
    """This process's records, taken out of it (the pool's workers send
    them to the main process, which :func:`merge` s them)."""
    with _REC.lock:
        out = {"spans": _REC.spans, "counters": list(_REC.counters.items()),
               "dropped": _REC.dropped}
        _REC.spans, _REC.counters, _REC.dropped = [], {}, 0
    return out


def merge(records: dict) -> None:
    """Add what :func:`drain` returned in another process to this one's
    records (up to ``CAP``)."""
    room = max(0, CAP - len(_REC.spans))
    spans = records["spans"]
    _REC.spans.extend(spans[:room])
    with _REC.lock:
        _REC.dropped += records["dropped"] + max(0, len(spans) - room)
        for key, (n, ns) in records["counters"]:
            c = _REC.counters.setdefault(key, [0, 0])
            c[0] += n
            c[1] += ns


def clear() -> None:
    """Drop every record."""
    drain()


def snapshot() -> dict:
    """Every record so far, left in place: ``spans`` and ``counters`` as
    dicts of :data:`SPAN_FIELDS` and :data:`COUNTER_FIELDS`, and the
    number of spans ``dropped`` beyond the cap."""
    with _REC.lock:
        spans, counters = list(_REC.spans), list(_REC.counters.items())
        dropped = _REC.dropped
    return {"spans": [dict(zip(SPAN_FIELDS, r)) for r in spans],
            "counters": [dict(zip(COUNTER_FIELDS, key + tuple(v))) for key, v in counters],
            "dropped": dropped}


def summary(job) -> List[str]:
    """One line per (process kind, thread, span or counter name) of
    ``job``: how many, total seconds and self seconds (the total less what
    its child spans cover; a counter's self is its total). Worker
    processes are summed under ``worker``. No line ends in "." or starts
    with "done in", so phase parsers that read ``--timed`` output skip
    them."""
    with _REC.lock:
        spans = [r for r in _REC.spans if r[5] == job]
        counters = [(k, v) for k, v in _REC.counters.items() if k[0] == job]
        dropped = _REC.dropped
    covered: Dict[tuple, int] = {}
    for r in spans:
        if r[4] is not None:
            covered[(r[6], r[4])] = covered.get((r[6], r[4]), 0) + r[2] - r[1]
    agg: Dict[tuple, list] = {}
    for r in spans:
        a = agg.setdefault((r[7], r[8], r[0], "n"), [0, 0, 0])
        a[0] += 1
        a[1] += r[2] - r[1]
        a[2] += r[2] - r[1] - covered.get((r[6], r[3]), 0)
    for (_, _, proc, thread, name), (n, ns) in counters:
        a = agg.setdefault((proc, thread, name, "calls"), [0, 0, 0])
        a[0] += n
        a[1] += ns
        a[2] += ns
    order = sorted(agg.items(), key=lambda kv: (kv[0][0] != "main", kv[0][0], kv[0][1],
                                                -kv[1][1]))
    lines = ["trace: %s %s %s %s=%d total=%.6fs self=%.6fs"
             % (proc, thread, name, unit, n, tot / 1e9, own / 1e9)
             for (proc, thread, name, unit), (n, tot, own) in order]
    if dropped:
        lines.append("trace: %d spans dropped beyond the cap of %d" % (dropped, CAP))
    return lines
