"""Tracing / profiling utilities — the QPC-instrumentation analogue
(Source/Times.h:23-26, CRenderStats tick counters) plus device-side
profiling through ``torch.profiler``; the port of
``videorenderer_tpu.utils.trace``.

``stage_timer`` gives host-side per-stage wall times (feeding
stats.RenderStats, like the reference's copy/paint/present ticks around
each stage, Source/DX11VideoProcessor.cpp:2606,2802,2818).  ``device_trace``
wraps ``torch.profiler.profile`` (CPU activity, plus CUDA activity when a
card is present) and exports a Chrome trace that Perfetto or
``chrome://tracing`` opens; ``annotate`` adds named regions, also as NVTX
ranges on a card.  The logger keeps the name ``"videorenderer_tpu"`` so an
existing logging set-up covers both packages.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("videorenderer_tpu")


@contextlib.contextmanager
def stage_timer(stats_obj, field: str):
    """Accumulate elapsed seconds into ``stats_obj.<field>``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        setattr(stats_obj, field,
                getattr(stats_obj, field) + (time.perf_counter() - t0))


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` and write a
    Chrome trace (``trace_<pid>.json``) into ``logdir``; yields the
    profiler, whose ``key_averages()`` sums the time by operator and
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces (TraceAnnotation analogue),
    and an NVTX range on a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def dlog(fmt: str, *args) -> None:
    """DLog analogue (Utils/Util.h:20-37): debug-level, skipped unless
    the logger is enabled."""
    if log.isEnabledFor(logging.DEBUG):
        log.debug(fmt, *args)
