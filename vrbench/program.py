"""The program's own spans (``videorenderer_tpu_torch.utils.trace``) in a
``--trace 1`` run, moved onto the device trace's time base.

The program records its spans in memory while the profiler records, so
after the window its list holds the window's spans: ``vrt.call`` around
each call into a public entry (a root where it encloses no other),
``vrt.kernel.<name>`` around each kernel wrapper, ``vrt.build.<what>``
around host state a call rebuilds, ``vrt.pack_curves`` around a scene's
curves packed before the call.  Their times are nanoseconds on the host's
``time.time_ns()``; the trace's are seconds from the window span's start.
One offset moves the first onto the second: every root ``vrt.call`` lies
inside the harness's ``vrbench.call`` around the same call, so pairing the
two in order, each pair bounds the offset from both sides, and the offset
is the smallest gap between a root's start and its ``vrbench.call``'s.

A program that records no spans (one older than them) gives None, and
every reader of these spans gives nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import stats

CALL = "vrt.call"
HARNESS_CALL = "vrbench.call"


def recorded() -> list | None:
    """The program's spans as ``(name, call, parent, start_ns, end_ns)``,
    or None where the program has none to give."""
    try:
        from videorenderer_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = getattr(trace, "spans", None)
    return list(spans()) if callable(spans) else None


def offset(roots_ns: list, calls_s: list) -> tuple[int, int] | None:
    """The offset (ns) that moves the program's root calls ``roots_ns``
    ((start_ns, end_ns)) onto the harness's ``calls_s`` ((start, end), s
    on the trace), the two paired in order from their last, and its slack:
    the width of the interval of offsets that keeps every root inside its
    harness call (negative where none does).  None with nothing to pair."""
    n = min(len(roots_ns), len(calls_s))
    if n == 0:
        return None
    pairs = list(zip(roots_ns[-n:], calls_s[-n:]))
    hi = min(s - round(a * 1e9) for (s, _), (a, _) in pairs)
    lo = max(e - round(b * 1e9) for (_, e), (_, b) in pairs)
    return hi, hi - lo


@dataclass
class Program:
    """The program's spans that overlap the window: ``at`` maps each one's
    index in ``spans`` to its (start, end) on the trace, in seconds."""
    spans: list        # every recorded span; parents index into it
    at: dict
    offset_ns: int
    slack_ns: int

    def named(self, prefix: str) -> list[int]:
        return [i for i in self.at if self.spans[i][0].startswith(prefix)]

    @property
    def roots(self) -> list[int]:
        return [i for i in self.named(CALL) if self.spans[i][2] is None]

    def in_roots(self, prefix: str) -> list[int]:
        """The spans named ``prefix``... inside the window's root calls."""
        calls = {self.spans[i][1] for i in self.roots}
        return [i for i in self.named(prefix) if self.spans[i][1] in calls]

    def seconds(self, i: int) -> float:
        return (self.spans[i][4] - self.spans[i][3]) / 1e9


def of(ctx) -> Program | None:
    """The window's program spans of a run's metric context, or None where
    the run was not traced or the program recorded no call in it."""
    if ctx.trace is None:
        return None
    spans = recorded()
    if not spans:
        return None
    roots = [(s[3], s[4]) for s in spans
             if s[0] == CALL and s[2] is None and s[4] is not None]
    calls = [(a, b) for name, a, b in ctx.trace.host_spans
             if name == HARNESS_CALL]
    fit = offset(roots, calls)
    if fit is None:
        return None
    off, slack = fit
    at = {}
    for i, s in enumerate(spans):
        if s[4] is None:
            continue
        a, b = (s[3] - off) / 1e9, (s[4] - off) / 1e9
        if b > 0.0 and a < ctx.trace.window_s:
            at[i] = (a, b)
    return Program(spans=spans, at=at, offset_ns=off, slack_ns=slack)


def idle_within(outer: list, busy: list) -> float:
    """Seconds of the union of the ``outer`` intervals that no ``busy``
    interval covers."""
    covered, j = 0.0, 0
    busy = stats.merged(busy)
    for a, b in stats.merged(outer):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return stats.union(outer) - covered
