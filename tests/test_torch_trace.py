"""videorenderer_tpu_torch.utils.trace on the CPU: the program's spans.

With no profiler recording, ``span`` is one shared no-op that reads no
clock; under a CPU profiler spans nest with their parent's index, the spans
of a call carry its id, a nested entry is a child and not a second root,
and the times share the profiler's clock.  A CPU ``VideoProcessor`` call
and a Dolby Vision serving call (on the kernel route, the wrappers running
their plain versions) give their roots, kernel spans and builds; the
program opens no profiler range of its own."""

import inspect
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import (CSP, ColorFormat, HDR10Metadata, Levels,
                                     OutputDescriptor, Primaries, Settings,
                                     SourceDescriptor, ToneMapType, TRC,
                                     Upscaling, VideoProcessor)
from videorenderer_tpu_torch.kernels import deint as dk
from videorenderer_tpu_torch.kernels import jinc2 as jk
from videorenderer_tpu_torch.kernels import probe as pk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import dovi as dovi_ops
from videorenderer_tpu_torch.utils import trace

W, H, OW, OH = 64, 32, 32, 16


@pytest.fixture(autouse=True)
def empty_list():
    trace.clear_spans()
    yield
    trace.clear_spans()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def names(spans):
    return [s.name for s in spans]


def source(fmt=ColorFormat.P010, dovi=None) -> SourceDescriptor:
    return SourceDescriptor(format=fmt, width=W, height=H,
                            matrix=CSP.BT_2020_NC, levels=Levels.TV,
                            primaries=Primaries.BT_2020, transfer=TRC.PQ,
                            hdr10=HDR10Metadata(), dovi=dovi)


def p010(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, (n, H, W), np.uint16) << 6,
            rng.integers(64, 961, (n, H // 2, W // 2), np.uint16) << 6,
            rng.integers(64, 961, (n, H // 2, W // 2), np.uint16) << 6)


def processor(fmt=ColorFormat.P010) -> VideoProcessor:
    return VideoProcessor(Settings(convert_to_sdr=True), source(fmt),
                          OutputDescriptor(width=OW, height=OH, bits=10),
                          device="cpu", pack_surface=True)


def dovi_meta(scale: float = 1.0) -> dovi_ops.DoviMetadata:
    curve = dovi_ops.ReshapeCurve(
        pivots=(), method=(0,), poly=np.array([[0.0, scale, 0.0]]),
        mmr_order=(), mmr_constant=(), mmr_coef=None)
    return dovi_ops.DoviMetadata(
        curves=(curve,) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746], [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))


def test_off_path_is_one_shared_noop(monkeypatch):
    """No profiler: every span is the same no-op object, entering it reads
    no clock, and the program's calls record nothing."""
    assert not torch._C._autograd._profiler_enabled()
    vp = processor()
    planes = p010(1)

    def no_clock():
        raise AssertionError("the off path read the clock")
    monkeypatch.setattr(time, "time_ns", no_clock)
    assert trace.span("vrt.a") is trace.span(trace.CALL)
    with trace.span("vrt.a"), trace.span(trace.CALL):
        vp.process(planes)
    assert trace.spans() == [] and trace.dropped() == 0


def test_profiler_shows_no_program_range():
    """The program's spans are held in memory, never opened as profiler
    ranges: a profiled call shows no ``vrt.*`` event, with spans recorded
    and with none active."""
    vp = processor()
    planes = p010(2)
    with recording() as prof:
        vp.process(planes)
    assert names(trace.spans())[0] == trace.CALL
    with recording() as bare:
        torch.ones(8, 8) @ torch.ones(8, 8)
    for p in (prof, bare):
        assert not [e.name for e in p.events() if e.name.startswith("vrt.")]


def test_spans_nest_with_their_parent_index():
    with recording():
        with trace.span("vrt.a"):
            with trace.span("vrt.b"):
                with trace.span("vrt.c"):
                    pass
            with trace.span("vrt.d"):
                pass
    s = trace.spans()
    assert names(s) == ["vrt.a", "vrt.b", "vrt.c", "vrt.d"]
    assert [x.parent for x in s] == [None, 0, 1, 0]
    assert all(x.call is None for x in s)
    for x in s:
        assert x.start_ns <= x.end_ns
        if x.parent is not None:
            p = s[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_children_share_their_calls_id():
    with recording():
        for _ in range(2):
            with trace.span(trace.CALL):
                with trace.span("vrt.kernel.k"):
                    with trace.span("vrt.build.upload"):
                        pass
        with trace.span("vrt.pack_curves"):
            pass
    s = trace.spans()
    first, second = s[0].call, s[3].call
    assert first is not None and second == first + 1
    assert [x.call for x in s] == [first] * 3 + [second] * 3 + [None]
    assert [x.parent for x in s] == [None, 0, 1, None, 3, 4, None]


def test_nested_entry_is_a_child_not_a_second_root():
    """``process_packed`` of a format unpacked on the host calls
    ``process``: one root, the inner call its child with the same id."""
    vp = processor(ColorFormat.YV12)
    rng = np.random.default_rng(3)
    buf = rng.integers(16, 236, (W * H * 3 // 2,), np.uint8)
    with recording():
        vp.process_packed(buf.tobytes())
    s = trace.spans()
    calls = [i for i, x in enumerate(s) if x.name == trace.CALL]
    assert len(calls) == 2
    root, inner = calls
    assert s[root].parent is None and s[inner].parent == root
    assert s[inner].call == s[root].call
    assert len({x.call for x in s}) == 1


def test_spans_share_the_profilers_clock():
    """A ``record_function`` opened inside a span lies within it on the
    profiler's own timestamps."""
    with recording() as prof:
        with trace.span("vrt.outer"):
            with record_function("probe"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    (outer,) = trace.spans()
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert len(probe) == 1
    assert outer.start_ns <= probe[0].start_ns() <= probe[0].end_ns() \
        <= outer.end_ns


def test_processor_call_spans():
    """A CPU ``VideoProcessor.process`` on the fused path: one root, K1 ×3
    and K2 as its children, nothing rebuilt once warm."""
    vp = processor()
    planes = p010(4)
    vp.process(planes)
    with recording():
        vp.process(planes)
    s = trace.spans()
    assert names(s) == [trace.CALL] + ["vrt.kernel.banded_resize_last_axis"] \
        * 3 + ["vrt.kernel.rows3_tail"]
    assert [x.parent for x in s] == [None, 0, 0, 0, 0]


def test_dovi_serving_call_spans(monkeypatch):
    """A Dolby Vision serving function on the kernel route (the wrappers'
    plain versions here): a ``vrt.pack_curves`` root a pack, and a call K1
    ×2, K8, K9 and one ``vrt.build.mid_stage`` a call."""
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    plan = tpipe.plan_pipeline(
        Settings(convert_to_sdr=True, upscaling=Upscaling.CATMULL_ROM),
        source(dovi=dovi_meta()), OutputDescriptor(width=OW, height=OH,
                                                   bits=10))
    fn = tpipe.make_serving_fn(plan, pack_surface=True)
    planes = tuple(torch.from_numpy(p) for p in p010(5))
    fn(planes, {"dovi_curves": fn.pack_curves(dovi_meta())})
    with recording():
        for scale in (0.99, 0.98):
            rt = {"dovi_curves": fn.pack_curves(dovi_meta(scale))}
            for _ in range(2):
                fn(planes, rt)
    s = trace.spans()
    roots = [x for x in s if x.parent is None]
    assert names(roots) == (["vrt.pack_curves"] + [trace.CALL] * 2) * 2
    call = ["vrt.kernel.banded_resize_last_axis"] * 2 + [
        "vrt.build.mid_stage", "vrt.kernel.rows3_mid",
        "vrt.kernel.cols3_tail"]
    for r in (x for x in roots if x.name == trace.CALL):
        inside = [x for x in s if x.call == r.call and x.name != trace.CALL]
        assert names(inside) == call
    assert all(x.call is None for x in s if x.name == "vrt.pack_curves")


def test_epilogue_rebuild_holds_the_tone_map_scalars():
    """A serving call of c7 (HDR10 passthrough with the local tone map)
    given a scene's ``rt["hdr"]`` rebuilds the tail epilogue once, with the
    tone map's scalars as its child; without ``rt`` it rebuilds nothing."""
    plan = tpipe.plan_pipeline(
        Settings(convert_to_sdr=False, hdr_passthrough=True,
                 hdr_local_tone_mapping=True,
                 hdr_local_tone_mapping_type=ToneMapType.BT2390,
                 hdr_display_max_nits=600),
        source(), OutputDescriptor(width=OW, height=OH, bits=10, hdr=True))
    assert plan.local_tonemap and tpipe.route_of(plan) == "fused"
    fn = tpipe.make_serving_fn(plan, pack_surface=True)
    planes = tuple(torch.from_numpy(p) for p in p010(6))
    fn(planes)
    with recording():
        fn(planes)
        fn(planes, {"hdr": {"max_cll": 2000.0}})
    s = trace.spans()
    builds = [(i, x) for i, x in enumerate(s)
              if not x.name.startswith("vrt.kernel.")]
    assert [x.name for _, x in builds] == [
        trace.CALL, trace.CALL, "vrt.build.epilogue", "vrt.tonemap_scalars"]
    (i, epi), (_, tm) = builds[2:]
    assert tm.parent == i and epi.call == tm.call == builds[1][1].call


@pytest.mark.parametrize("name", sorted(rk.launches))
def test_every_launch_counter_key_has_its_wrappers_span(name):
    """Each kernel of the launch counter has a wrapper spanned under the
    counter's key, so a call's kernel spans and its launches count
    alike on a card."""
    fn = next(getattr(m, name) for m in (rk, dk, jk, pk) if hasattr(m, name))
    spanned = inspect.getclosurevars(fn).nonlocals
    assert spanned["name"] == "vrt.kernel." + name
    assert spanned["fn"] is fn.__wrapped__


def test_kernel_span_refuses_a_name_the_counter_lacks():
    with pytest.raises(KeyError):
        rk.kernel_span("no_such_kernel")


def test_the_list_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with recording():
        with trace.span(trace.CALL):
            for _ in range(4):
                with trace.span("vrt.kernel.k"):
                    pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2
    trace.clear_spans()
    assert trace.spans() == [] and trace.dropped() == 0


def test_clear_while_open_keeps_no_stale_parent():
    with recording():
        with trace.span(trace.CALL):
            trace.clear_spans()
            with trace.span("vrt.kernel.k"):
                pass
    (k,) = trace.spans()
    assert k.parent is None and k.call is not None and k.end_ns is not None


def test_threads_keep_their_own_nesting():
    """A span opened on another thread is no child of one open here."""
    def other():
        with trace.span("vrt.other"):
            pass
    with recording():
        with trace.span(trace.CALL):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    others = [x for x in trace.spans() if x.name == "vrt.other"]
    assert all(x.parent is None and x.call is None for x in others)


def test_device_trace_clears_the_list_on_entry(tmp_path):
    with recording():
        with trace.span("vrt.before"):
            pass
    with trace.device_trace(str(tmp_path)):
        with trace.span("vrt.inside"):
            pass
    assert names(trace.spans()) == ["vrt.inside"]
