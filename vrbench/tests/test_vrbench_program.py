"""The readers of the program's own spans (``vrbench/program.py`` and the
five metrics that read them): the offset onto the trace and its slack, and
each reader, on synthetic spans and traces and on the CPU; on an NVIDIA
card (marker ``cuda``) a traced run of each cell carries them, the window's
kernel spans count as the launch counter does, and a kernel span holds its
launch on the trace's clock.

    python -m pytest -q vrbench/tests/test_vrbench_program.py
"""

from __future__ import annotations

import collections
import os
from types import SimpleNamespace

import pytest
import torch

import vrbench.run as run
from vrbench import gen, loop, program, spec
from vrbench.metrics import (device_idle_in_program_pct, entry_host_ms_per_call,
                             host_builds_per_call, launch_host_ms_per_call,
                             scene_host_ms)
from vrbench.trace import Trace, short_name
from vrbench.tests import small
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.utils import trace

CELLS = small.cells()
READERS = {"entry_host_ms_per_call": entry_host_ms_per_call,
           "launch_host_ms_per_call": launch_host_ms_per_call,
           "host_builds_per_call": host_builds_per_call,
           "scene_host_ms": scene_host_ms,
           "device_idle_in_program_pct": device_idle_in_program_pct}
NEW = set(READERS)
# the program's clock: the window's start at this many nanoseconds
T0 = 1_700_000_000_000_000_000


def fake_spans():
    """Two calls of a DoVi entry, 1 ms apart on the program's clock, the
    first after a scene's curves: (name, call, parent, start_ns, end_ns).
    The window begins at T0, so a span at T0 + x ns is at x ns on the
    trace."""
    return [
        ("vrt.pack_curves", None, None, T0 + 100_000, T0 + 300_000),
        ("vrt.call", 1, None, T0 + 310_000, T0 + 710_000),
        ("vrt.kernel.banded_resize_last_axis", 1, 1, T0 + 320_000,
         T0 + 400_000),
        ("vrt.build.mid_stage", 1, 1, T0 + 400_000, T0 + 450_000),
        ("vrt.kernel.rows3_mid", 1, 1, T0 + 450_000, T0 + 600_000),
        ("vrt.build.windows", 1, 4, T0 + 460_000, T0 + 470_000),
        ("vrt.call", 2, None, T0 + 1_310_000, T0 + 1_610_000),
        ("vrt.kernel.jinc2_resize_fused", 2, 6, T0 + 1_320_000,
         T0 + 1_500_000),
        ("vrt.kernel.jinc2_weight_table", 2, 7, T0 + 1_330_000,
         T0 + 1_400_000),
    ]


def fake_trace():
    """The harness's view of the same window, in seconds: each
    ``vrbench.call`` 5 us before and after the program's root, the device
    busy from 0.5 to 1.4 ms."""
    return Trace(window_s=0.002, calls=2,
                 device_ops=[("rows3_mid_kernel", 0.0005, 0.0014)],
                 host_spans=[("vrbench.call", 0.000095, 0.000715),
                             ("vrbench.pack_curves", 0.0001, 0.0003),
                             ("vrbench.wait", 0.0008, 0.0013),
                             ("vrbench.call", 0.001305, 0.001615)])


def fake_ctx(monkeypatch, spans=None):
    monkeypatch.setattr(program, "recorded",
                        lambda: fake_spans() if spans is None else spans)
    return SimpleNamespace(trace=fake_trace())


def test_offset_is_the_smallest_start_gap_and_its_slack():
    roots = [(T0 + 310_000, T0 + 710_000), (T0 + 1_312_000, T0 + 1_610_000)]
    calls = [(0.000305, 0.000715), (0.001305, 0.001614)]
    off, slack = program.offset(roots, calls)
    # start gaps T0 + 5000 and T0 + 7000; end gaps T0 - 5000, T0 - 4000
    assert off == T0 + 5_000 and slack == 9_000
    # paired from the last: a stale root before the window is left over
    off2, slack2 = program.offset([(T0 - 10 ** 9, T0 - 10 ** 9 + 1)] + roots,
                                  calls)
    assert (off2, slack2) == (off, slack)
    assert program.offset([], calls) is None
    assert program.offset(roots, []) is None


def test_offset_slack_is_negative_where_no_offset_fits():
    # a root longer than its harness call: no offset keeps it inside
    roots = [(T0, T0 + 2_000_000)]
    assert program.offset(roots, [(0.0, 0.001)])[1] < 0


def test_program_spans_of_the_window(monkeypatch):
    p = program.of(fake_ctx(monkeypatch))
    assert p.offset_ns == T0 + 5_000 and p.slack_ns == 10_000
    assert p.roots == [1, 6]
    a, b = p.at[1]
    assert a == pytest.approx(0.000305) and b == pytest.approx(0.000705)
    assert p.in_roots("vrt.build.") == [3, 5]


def test_each_reader_on_synthetic_spans(monkeypatch):
    ctx = fake_ctx(monkeypatch)
    # calls of 0.4 and 0.3 ms
    assert entry_host_ms_per_call.read(ctx) == pytest.approx(0.35)
    # 0.08 + 0.15 in the first, 0.18 (the table's kernel inside the
    # resize counted once) in the second
    assert launch_host_ms_per_call.read(ctx) == pytest.approx(0.205)
    assert host_builds_per_call.read(ctx) == pytest.approx(1.0)
    assert scene_host_ms.read(ctx) == pytest.approx(0.2)
    # inside spans: 0.095-0.295, 0.305-0.705, 1.305-1.605 ms; the device
    # busy 0.5-1.4: idle 0.2 + 0.195 + 0.205 ms of the 2 ms window
    assert device_idle_in_program_pct.read(ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("spans", [None, []], ids=["no_program", "empty"])
def test_readers_give_nothing_without_spans(monkeypatch, spans):
    monkeypatch.setattr(program, "recorded", lambda: spans)
    ctx = SimpleNamespace(trace=fake_trace())
    for reader in READERS.values():
        assert reader.read(ctx) is None
    untraced = SimpleNamespace(trace=None)
    monkeypatch.setattr(program, "recorded", fake_spans)
    for reader in READERS.values():
        assert reader.read(untraced) is None


def test_scene_host_ms_is_none_without_a_scene(monkeypatch):
    spans = [s for s in fake_spans() if s[0] != "vrt.pack_curves"]
    ctx = fake_ctx(monkeypatch, spans)
    assert scene_host_ms.read(ctx) is None
    assert entry_host_ms_per_call.read(ctx) == pytest.approx(0.35)


def test_recorded_reads_the_programs_list():
    trace.clear_spans()
    assert program.recorded() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("vrt.call"):
            pass
    (s,) = program.recorded()
    assert s[0] == "vrt.call" and s[2] is None
    trace.clear_spans()


def test_idle_within():
    assert program.idle_within([(0.0, 1.0), (2.0, 3.0)],
                               [(0.5, 2.5)]) == pytest.approx(1.0)
    assert program.idle_within([(0.0, 1.0)], []) == pytest.approx(1.0)
    assert program.idle_within([], [(0.0, 1.0)]) == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_carries_the_metrics(monkeypatch, cell):
    """A traced run of each cell at the CPU's size (the DoVi cells on their
    kernel route, its wrappers running the plain versions): every new
    metric the cell lists, one ``mid_stage`` a DoVi call, none in hdr10."""
    import videorenderer_tpu_torch.pipeline as tpipe
    small.patch_small(monkeypatch)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    trace.clear_spans()
    r = run.run_cell(cell, 2 ** 31 + 29, 0.5, True, "cpu", loop.HostClock(),
                     start=0.0, info=open(os.devnull, "w"))
    trace.clear_spans()
    listed = {m["name"] for m in spec.load_cell(cell).per_layer} & NEW
    assert listed <= set(r["metrics"]), r["metrics"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["host_builds_per_call"] == (0.0 if cell.startswith("hdr10")
                                         else 1.0)
    assert 0.0 < m["launch_host_ms_per_call"] < m["entry_host_ms_per_call"]
    assert m["entry_host_ms_per_call"] <= m["host_ms_per_call"]


# --- on the card ---------------------------------------------------------------


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_card_carries_the_metrics(cell):
    """A short ``--trace 1`` run of each cell at its own size: the new
    metrics it lists, and the window's kernel spans equal to the launch
    counter key by key."""
    dev = card()
    trace.clear_spans()
    r = run.run_cell(cell, 2 ** 31 + 37, 1.0, True, dev, loop.CudaClock(),
                     start=0.0, info=open(os.devnull, "w"))
    spans = trace.spans()
    trace.clear_spans()
    torch.cuda.empty_cache()
    print(cell, {k: v["value"] for k, v in r["metrics"].items()})
    listed = {m["name"] for m in spec.load_cell(cell).per_layer} & NEW
    assert listed <= set(r["metrics"]), r["metrics"]
    kernels = collections.Counter(s.name[len("vrt.kernel."):] for s in spans
                                  if s.name.startswith("vrt.kernel."))
    assert kernels == collections.Counter(
        {k: v for k, v in rk.launches.items() if v})


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_kernel_span_holds_its_launch_on_the_trace_clock(monkeypatch, cell):
    """Under the profiler, each ``vrt.kernel.*`` span of a call holds the
    ``cudaLaunch*`` runtime event that launched its kernel (matched to the
    kernel on the device by correlation id) on the profiler's clock, and
    no other.  The
    profiler's first call is left out: its first launch can go unrecorded
    while the profiler starts."""
    dev = card()
    small.patch_small(monkeypatch)
    c = spec.load_cell(cell)
    pool = gen.make_pool(c.traffic, c.config, 2 ** 31 + 41, dev)
    entry = spec.module("entries", c.config["entry"]).build(
        c.config, c.traffic, dev)
    entry.call(pool[0], 0)
    torch.cuda.synchronize()
    trace.clear_spans()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(1, 4):
            entry.call(pool[k % len(pool)], k)
            torch.cuda.synchronize()
    spans = trace.spans()
    trace.clear_spans()
    roots = sorted(s.call for s in spans
                   if s.name == "vrt.call" and s.parent is None)
    later = set(roots[1:])
    kernels = [s for s in spans
               if s.name.startswith("vrt.kernel.") and s.call in later]
    events = prof.profiler.kineto_results.events()
    ours = {e.correlation_id() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and "at::" not in e.name()
            and short_name(e.name()).endswith("_kernel")}
    launches = [e for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith("cudaLaunch")
                and e.correlation_id() in ours]
    assert len(later) == 2 and kernels
    for s in kernels:
        held = [e for e in launches
                if s.start_ns <= e.start_ns() and e.end_ns() <= s.end_ns]
        assert len(held) == 1, (s, [e.name() for e in held])
