"""The readers' arithmetic on hand-made inputs: the union of intervals,
percentiles over every call, the spread, roofline bytes and shares, the
trace's breakdown."""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace

import numpy as np
import pytest

from vrbench import loop, roofline, stats
from vrbench.costs import dovi_mid, fused_mid16
from vrbench.metrics import (call_ms_p95, call_roofline_pct, device_idle_pct,
                             frames_per_s, host_ms_per_call, k1_roofline_pct,
                             k2_roofline_pct, k8_roofline_pct)
from vrbench.reference import scale
from vrbench.trace import Trace, short_name


@pytest.mark.parametrize("spans, covered", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 1.0), (0.5, 2.0)], 2.0),
    ([(3.0, 4.0), (0.0, 1.0), (0.2, 0.4)], 2.0),
    ([(0.0, 1.0), (1.0, 2.0), (5.0, 5.5)], 2.5),
])
def test_union(spans, covered):
    assert stats.union(spans) == pytest.approx(covered)
    assert sum(b - a for a, b in stats.merged(spans)) == pytest.approx(covered)


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(1).random(257) * 10)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_spread_is_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.5, 12.0, 10.2]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def window(latencies, seconds=1.0, done_after=()):
    calls = []
    for i, lat in enumerate(latencies):
        c = loop.Call(i, submit_s=i * 0.01, return_s=i * 0.01 + 0.001,
                      mark=None)
        c.free_s = c.submit_s
        c.done_s = c.submit_s + lat if i not in done_after else seconds + 1
        calls.append(c)
    return loop.Window(seconds, calls, {})


def test_call_ms_p95_is_over_every_completed_call():
    lat = [0.002] * 95 + [0.010] * 5
    ctx = SimpleNamespace(window=window(lat + [0.5], done_after={100}),
                          cell=SimpleNamespace(batch=16))
    # the late call is not in the window; the tail is the 95th percentile
    # of the 100 that completed
    assert call_ms_p95.read(ctx) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert frames_per_s.read(ctx) == pytest.approx(16 * 100 / 1.0)
    assert host_ms_per_call.read(ctx) == pytest.approx(1.0)


def test_a_calls_slot_frees_when_the_call_depth_before_it_ends():
    """The loop on the host's clock with calls that take 10 ms each: with
    2 in flight the first two slots are free at the window's start, and
    call k's slot when call k - 2 ended."""
    class Entry:
        def call(self, planes, index):
            time.sleep(0.01)
            return index

    w = loop.run(Entry(), [None], {"depth": 2}, 0.1, loop.HostClock(),
                 keep={1})
    calls = w.calls
    assert len(calls) >= 5
    assert calls[0].free_s == calls[1].free_s == 0.0
    for k in range(2, len(calls)):
        assert calls[k].free_s == calls[k - 2].done_s
        assert calls[k].done_s - calls[k].free_s >= 0.02
    assert 1 in w.kept and w.kept[1] == 1


def test_costs_at_the_cells_sizes():
    cfg = {"video_source": {"width": 3840, "height": 2160},
           "output": {"width": 1920, "height": 1080},
           "settings": {"upscaling": "LANCZOS3"}}
    st = fused_mid16.stages(cfg, 16)
    raw = 16 * (2160 * 3840 + 2 * 1080 * 1920) * 2
    mid = 16 * (2160 * 1920 + 2 * 1080 * 1920) * 2
    surface = 16 * 1080 * 1920 * 4
    assert st["K1"][0] == raw + mid == 663_552_000
    assert st["K2"][0] == mid + surface
    assert st["call"][0] == raw + surface
    # Lanczos3 at 2:1 is its six-tap interpolation filter, the edge taps
    # folded onto the edge texels
    assert 6 * 1920 - 10 <= fused_mid16.taps(
        scale.axis_matrix("LANCZOS3", 3840, 1920)) <= 6 * 1920
    cfg["settings"]["upscaling"] = "CATMULL_ROM"
    dv = dovi_mid.stages(cfg, 16)
    assert dv["K1"][0] == 16 * 2 * 1080 * 1920 * 2 + 16 * 2 * 1080 * 3840 * 2
    assert dv["K8"][0] == (16 * 2160 * 3840 * 2 + 16 * 2 * 1080 * 3840 * 2
                           + 3 * 16 * 1080 * 3840 * 2)
    assert dv["K9"][0] == 3 * 16 * 1080 * 3840 * 2 + surface
    assert dv["call"][0] == raw + surface


def test_axis_matrix_weights():
    m = scale.axis_matrix("CATMULL_ROM", 16, 8)
    assert np.allclose(m.sum(0), 1.0)
    # every output at t = 0.5: (-1, 9, 9, -1) / 16 over texels 2j - 1 .. 2j + 2
    assert np.allclose(m[5:9, 3], [-1 / 16, 9 / 16, 9 / 16, -1 / 16])
    assert np.allclose(scale.chroma_w(4).sum(0), 1.0)
    assert np.allclose(scale.chroma_h(4).sum(0), 1.0)


def fake_trace():
    # two calls: K1 3 ms and K2 1 ms of device time, a 1 ms idle gap
    # while the host waited, the window 6 ms
    return Trace(window_s=0.006, calls=2,
                 device_ops=[("banded_resize_kernel", 0.000, 0.002),
                             ("rows3_tail_kernel", 0.002, 0.0025),
                             ("banded_resize_kernel", 0.0035, 0.0045),
                             ("rows3_tail_kernel", 0.0045, 0.005)],
                 host_spans=[("vrbench.call", 0.0, 0.0004),
                             ("vrbench.wait", 0.0024, 0.0036),
                             ("vrbench.call", 0.0036, 0.0038)])


def test_roofline_shares_on_a_fake_trace():
    costs = {"K1": (3.35e12 * 0.001, 0.0), "K2": (0.0, 67e12 * 0.00025),
             "call": (3.35e12 * 0.0005, 0.0)}
    ctx = SimpleNamespace(trace=fake_trace(), costs=costs)
    # K1: 2 calls x 1 ms least over 3 ms; K2: 2 x 0.25 ms over 1 ms
    assert k1_roofline_pct.read(ctx) == pytest.approx(100 * 2 / 3)
    assert k2_roofline_pct.read(ctx) == pytest.approx(50.0)
    assert k8_roofline_pct.read(ctx) is None
    assert call_roofline_pct.read(ctx) == pytest.approx(100 * 1.0 / 4.0)
    assert device_idle_pct.read(ctx) == pytest.approx(100 * 2 / 6)
    assert roofline.least_seconds(3.35e12, 67e12) == 1.0


def test_breakdown_names_the_host_work_of_each_gap():
    b = fake_trace().breakdown()
    assert b["device_ops"][0] == ["banded_resize_kernel", pytest.approx(0.003)]
    # the gap 2.5-3.5 ms began while the host waited; the last after the
    # window's work, between spans
    assert ["vrbench.wait", pytest.approx(0.001)] in b["idle_gaps"]
    assert ["host between spans", pytest.approx(0.001)] in b["idle_gaps"]


@pytest.mark.parametrize("name, short", [
    ("void rows3_tail_kernel<HeadlineRoute, 4>(float const*, int)",
     "rows3_tail_kernel"),
    ("(anonymous namespace)::banded_resize_kernel(unsigned short const*)",
     "banded_resize_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"),
])
def test_short_name(name, short):
    assert short_name(name) == short
