"""The program's spans, and a device trace that shows them.

``span(name)`` marks host work where it happens: a call into a public entry
(``vrt.call``), a kernel wrapper from its entry to its return
(``vrt.kernel.<name>``, the key of ``kernels.resize.launches``), host state
a call rebuilds (``vrt.build.<what>``), a scene's curves packed
(``vrt.pack_curves``).  A span records only while a ``torch.profiler`` is
recording, and then into a list in this process's memory, never as a
profiler or NVTX range: the device trace's operations stay the device's
alone.  Its times are ``time.time_ns()``, the clock the profiler stamps its
events with, so a span lines up with the kernels it launched.  With no
profiler recording, ``span`` returns one shared no-op context manager that
reads no clock and records nothing.

``device_trace`` wraps ``torch.profiler.profile`` (CPU activity, plus CUDA
activity when a card is present) and exports a Chrome trace with the
program's spans in it, which Perfetto or ``chrome://tracing`` opens.  The
logger keeps the name ``"videorenderer_tpu"`` so an existing logging set-up
covers both packages.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from typing import NamedTuple

import torch

log = logging.getLogger("videorenderer_tpu")

CALL = "vrt.call"
MAX_SPANS = 1 << 18
"""Spans the list holds; those opened once it is full are counted in
:func:`dropped` and not kept."""

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    call: int | None      # the id of the vrt.call it lies in
    parent: int | None    # the index in spans() of the span enclosing it
    start_ns: int
    end_ns: int | None    # None while it is open


class _State:
    def __init__(self):
        # the records one after another, five fields each (Span's): a flat
        # list of strings and numbers, so a long trace adds no objects for
        # the garbage collector to walk
        self.flat: list = []
        self.dropped = 0
        self.calls = itertools.count(1)
        self.local = threading.local()   # .open: this thread's open spans

    def open_spans(self) -> list:
        try:
            return self.local.open
        except AttributeError:
            self.local.open = []
            return self.local.open


_state = _State()


class _Open:
    """One recorded span: its record appended at entry, its end at exit."""
    __slots__ = ("name", "call", "index", "flat", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _state
        self.stack = stack = st.open_spans()
        outer = stack[-1] if stack else None
        self.call = outer.call if outer is not None else None
        if self.call is None and self.name == CALL:
            self.call = next(st.calls)
        flat = st.flat
        # a span whose list was cleared since is no parent
        parent = (outer.index if outer is not None and outer.flat is flat
                  else None)
        if len(flat) < 5 * MAX_SPANS:
            self.index, self.flat = len(flat) // 5, flat
            flat.extend((self.name, self.call, parent, time.time_ns(), None))
        else:
            self.index = self.flat = None
            st.dropped += 1
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.flat is not None:
            self.flat[5 * self.index + 4] = time.time_ns()
        self.stack.pop()
        return False


def span(name: str):
    """A context manager that records host work named ``name`` while a
    profiler records, and the shared no-op otherwise.  A ``vrt.call``
    opened outside any call starts a new call (a per-process sequence
    number); every span opened inside it, a nested ``vrt.call`` too,
    carries that call's id and the index of the span enclosing it."""
    return _Open(name) if _recording() else _OFF


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list[Span]:
    """The spans recorded since the last :func:`clear_spans`, in the order
    they opened."""
    f = _state.flat
    return [Span(*f[i:i + 5]) for i in range(0, len(f), 5)]


def dropped() -> int:
    """Spans not kept since the last :func:`clear_spans`: the list was
    full."""
    return _state.dropped


def clear_spans() -> None:
    """Empty the list.  Spans open now still close, and are not kept."""
    _state.flat = []
    _state.dropped = 0


def _chrome_events(base_ns: int, pid: int) -> list[dict]:
    """The spans as Chrome trace events, their times in microseconds from
    ``base_ns``, on a track of their own in process ``pid``."""
    tid = 0
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "vrt spans"}}]
    for i, s in enumerate(spans()):
        if s.end_ns is None:
            continue
        events.append({"ph": "X", "cat": "vrt", "name": s.name, "pid": pid,
                       "tid": tid, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": i, "call": s.call,
                                "parent": s.parent}})
    return events


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` and write a
    Chrome trace (``trace_<pid>.json``) into ``logdir``, the program's
    spans of the region on a track of their own beside the profiler's
    operations; yields the profiler, whose ``key_averages()`` sums the time
    by operator and kernel.  The span list is cleared on entry and holds
    the region's spans after it."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    # the export's "ts" is microseconds from baseTimeNanoseconds (from the
    # epoch where a version writes no base), the clock of time.time_ns()
    data["traceEvents"] += _chrome_events(
        int(data.get("baseTimeNanoseconds", 0)), os.getpid())
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    log.info("device trace written to %s (%d program spans)", path,
             len(_state.flat) // 5)
