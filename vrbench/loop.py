"""The closed loop: calls into the program with ``depth`` of them in flight,
for a window of fixed length.

A call's slot frees when the call ``depth`` before it ends; the first
``depth`` calls' slots are free at the window's start.  A call's latency
runs from its slot's freeing to the end of its work, both read from events
on the device's clock (the window's start from an event recorded when the
device had nothing queued).  So a host that submits late lengthens the
latency by its lag, and the device's times do not depend on when the host
looks.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass


class CudaClock:
    """Events on the current CUDA stream."""

    def __init__(self):
        import torch
        self._torch = torch

    def mark(self):
        e = self._torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, mark) -> None:
        mark.synchronize()

    def sync(self) -> None:
        self._torch.cuda.synchronize()

    def seconds(self, m0, m1) -> float:
        return m0.elapsed_time(m1) / 1e3


class HostClock:
    """The host's clock, for a device that runs each call before it
    returns (the CPU)."""

    def mark(self):
        return time.perf_counter()

    def wait(self, mark) -> None:
        pass

    def sync(self) -> None:
        pass

    def seconds(self, m0, m1) -> float:
        return m1 - m0


@dataclass
class Call:
    index: int
    submit_s: float       # host clock, from the window's start
    return_s: float
    mark: object
    done_s: float = float("inf")
    free_s: float = 0.0   # device clock: when the call's slot freed


@dataclass
class Window:
    seconds: float
    calls: list          # every call submitted in the window
    kept: dict           # call index -> output, for the check

    @property
    def completed(self) -> list:
        return [c for c in self.calls if c.done_s <= self.seconds]


def no_span(name: str):
    return contextlib.nullcontext()


def run(entry, pool, traffic: dict, seconds: float, clock, keep=(),
        span=no_span, first: int = 0) -> Window:
    """Calls ``first``, ``first + 1``, ... on the pool's batches in turn
    until ``seconds`` have passed, at most ``traffic["depth"]`` in flight;
    then waits for all.  Keeps the outputs of the calls in ``keep`` and of
    the last complete one."""
    depth = int(traffic["depth"])
    pool_n = len(pool)
    calls, kept = [], {}
    recent = collections.deque(maxlen=depth + 1)
    inflight = collections.deque()
    clock.sync()
    with span("vrbench.window"):
        t0 = time.perf_counter()
        m0 = clock.mark()
        k = first
        while time.perf_counter() - t0 < seconds:
            if len(inflight) >= depth:
                with span("vrbench.wait"):
                    clock.wait(inflight.popleft().mark)
                continue
            submit = time.perf_counter() - t0
            with span("vrbench.call"):
                out = entry.call(pool[k % pool_n], k)
            call = Call(k, submit, time.perf_counter() - t0, clock.mark())
            calls.append(call)
            inflight.append(call)
            recent.append((call, out))
            if k in keep:
                kept[k] = out
            k += 1
        clock.sync()
    for i, c in enumerate(calls):
        c.done_s = clock.seconds(m0, c.mark)
        if i >= depth:
            c.free_s = calls[i - depth].done_s
    window = Window(seconds, calls, kept)
    done = [(c, out) for c, out in recent if c.done_s <= seconds]
    if done:
        kept[done[-1][0].index] = done[-1][1]
    return window
