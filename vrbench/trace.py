"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, read into the device's operations and the harness's host spans.

The harness marks its own host work with spans (``vrbench.window`` around
the loop, ``vrbench.call`` around each call into the program,
``vrbench.wait`` while it waits for the oldest call in flight, an entry's
``vrbench.pack_curves``); the program has no spans of its own yet.  Every
time is in seconds from the window span's start.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

from . import stats

WINDOW = "vrbench.window"


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters: the first identifier followed at once by "<" or "("; a
    name with none (a copy, a memset) stays whole."""
    m = re.search(r"([A-Za-z_]\w*)[<(]",
                  name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


@dataclass
class Trace:
    window_s: float
    calls: int
    device_ops: list = field(default_factory=list)   # (name, start, end)
    host_spans: list = field(default_factory=list)   # (name, start, end)

    @property
    def busy_s(self) -> float:
        return stats.union((a, b) for _, a, b in self.device_ops)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device, each named by the host span it began in."""
        by_op: dict = {}
        for name, a, b in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        busy = stats.merged((a, b) for _, a, b in self.device_ops)
        edges = [(0.0, 0.0), *busy, (self.window_s, self.window_s)]
        gaps = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
                if edges[i + 1][0] > edges[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": [[self.host_activity(a), b - a]
                              for a, b in gaps[:top]]}

    def host_activity(self, t: float) -> str:
        """The innermost harness span open at ``t``."""
        inner = None
        for name, a, b in self.host_spans:
            if a <= t < b and (inner is None or a >= inner[1]):
                inner = (name, a)
        return inner[0] if inner else "host between spans"


def read_profile(prof, calls: int) -> Trace:
    """The window's device operations and host spans from a finished
    ``torch.profiler.profile``."""
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW
                  and e.device_type == torch.autograd.DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    trace = Trace(window_s=(w1 - w0) / 1e6, calls=calls)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b < w0 or a > w1:
            continue
        a, b = (max(a, w0) - w0) / 1e6, (min(b, w1) - w0) / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith("vrbench."):
                trace.device_ops.append((short_name(e.name), a, b))
        elif e.name.startswith("vrbench.") and e.name != WINDOW:
            trace.host_spans.append((e.name, a, b))
    return trace
