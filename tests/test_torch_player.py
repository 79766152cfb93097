"""The player-side host modules of videorenderer_tpu_torch against the JAX
package's originals, on the CPU: ``stats``, ``osd``, ``subtitles`` (the
providers, both queues, the push bridge, ``composite``) and ``io.srt`` give
equal results on the same calls; ``QualityManager``/``PresentClock`` over
the scenarios of tests/test_quality.py give equal decision traces (the
clock replaced by a fake one in both packages); ``run_clip`` and
``windowed_batches`` keep the JAX contract (batch k+1's transfer is issued
before batch k's compute).  The threaded ``SubPicQueue`` hands out numpy
bitmaps only: its worker never touches a device.
"""

import dataclasses
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import videorenderer_tpu.osd as josd
import videorenderer_tpu.runner as jrun
import videorenderer_tpu.stats as jstats
import videorenderer_tpu.subtitles as jsub
import videorenderer_tpu.io.srt as jsrt

import videorenderer_tpu_torch.osd as tosd
import videorenderer_tpu_torch.runner as trun
import videorenderer_tpu_torch.stats as tstats
import videorenderer_tpu_torch.subtitles as tsub
import videorenderer_tpu_torch.io.srt as tsrt

DUR = 1.0 / 60.0
SRT = """1
00:00:01,000 --> 00:00:02,500
<i>Hello</i> world

2
00:00:02,000 --> 00:00:04,000
{\\an8}Second
line

bad block

3
00:00:05.000 --> 00:00:06.000
third
"""


# -- stats ---------------------------------------------------------------------

def _stats_trace(mod):
    m = mod.Metrics()
    for i in range(20):
        m.input_stats.add(i * (1 / 30))
    for i in range(60):
        m.input_stats.add(1.0 + i * (1 / 24))
    for i in range(15):
        m.input_stats.add(4.0 + i * (1 / 60))
    for i in range(11):
        m.draw_stats.frame_drawn(ts=i * 0.020 + (0.002 if i % 2 else 0.0))
    for off in (0.001, -0.002, 0.003, 0.000, -0.001):
        m.render_stats.record_sync_offset(off)
        m.sync_graph.add(off)
    m.render_stats.copy_s, m.render_stats.paint_s = 0.001, 0.002
    ma = mod.MovingAverage(4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        ma.add(v)
    snap = m.snapshot()
    m.render_stats.reset()
    return (snap, m.snapshot(), ma.average(), ma.values(),
            m.sync_graph.values(), m.input_stats.frames,
            m.input_stats.average_duration())


def test_stats_equal():
    assert _stats_trace(tstats) == _stats_trace(jstats)


# -- osd -----------------------------------------------------------------------

@pytest.mark.parametrize("pil", [True, False], ids=["pillow", "5x7"])
def test_osd_equal(pil, monkeypatch):
    for mod in (tosd, josd):
        monkeypatch.setattr(mod, "_HAVE_PIL", mod._HAVE_PIL and pil)
        mod.glyph_atlas.cache_clear()
    try:
        for size in (10, 16):
            a, b = tosd.glyph_atlas(size), josd.glyph_atlas(size)
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
        text = "FPS: 59.94\nSync: -0.25 ms"
        np.testing.assert_array_equal(tosd.render_text(text, 16),
                                      josd.render_text(text, 16))
        pts = [(0, 5), (9, 0), (3, 7), (12, 12), (-2, 4)]
        ca, cb = np.zeros((10, 11), np.uint8), np.zeros((10, 11), np.uint8)
        tosd.draw_polyline(ca, pts, 200)
        josd.draw_polyline(cb, pts, 200)
        np.testing.assert_array_equal(ca, cb)
        snap = _stats_trace(jstats)[0]
        for graph in (None, [0.0, 0.5, -0.5, 0.2]):
            ra, rb = (mod.render_stats_overlay(snap, graph_values=graph)
                      for mod in (tosd, josd))
            for x, y in zip(ra, rb):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    finally:
        for mod in (tosd, josd):
            mod.glyph_atlas.cache_clear()


# -- subtitles and srt ---------------------------------------------------------

def _pics(pics):
    return [(p.rgb, p.alpha, p.x, p.y, p.start, p.stop) for p in pics]


def _assert_pics_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(_pics(a), _pics(b)):
        assert isinstance(x[0], np.ndarray) and isinstance(x[1], np.ndarray)
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2:] == y[2:]


def _events(mod):
    return [mod.TextEvent(0.0, 1.0, "A1", x=2, y=3),
            mod.TextEvent(0.5, 2.0, "b2\nline", x=10),
            mod.TextEvent(3.0, 3.5, "c3")]


TIMES = [0.0, 0.25, 0.5, 0.9, 1.0, 1.5, 2.0, 2.9, 3.2, 3.5, 10.0]


def test_text_provider_and_nothread_queue_equal():
    tp, jp = (m.TextSubtitleProvider(_events(m), size=12)
              for m in (tsub, jsub))
    tq, jq = tsub.SubPicQueueNoThread(tp), jsub.SubPicQueueNoThread(jp)
    for t in TIMES:
        _assert_pics_equal(tp.render(t), jp.render(t))
        assert tp.next_change(t) == jp.next_change(t)
        _assert_pics_equal(tq.lookup(t), jq.lookup(t))
    tq.invalidate()
    jq.invalidate()
    _assert_pics_equal(tq.lookup(0.6), jq.lookup(0.6))


def test_threaded_queue_matches_and_stays_numpy():
    """The threaded queue's lookups equal the render-on-demand queue's at
    increasing times, and every bitmap it hands out is a numpy array (the
    worker rasterises on the host only)."""
    prov = tsub.TextSubtitleProvider(_events(tsub), size=12)
    q = tsub.SubPicQueue(prov, max_ahead=3)
    ref = tsub.SubPicQueueNoThread(tsub.TextSubtitleProvider(_events(tsub),
                                                             size=12))
    try:
        for t in TIMES:
            got = q.lookup(t)
            _assert_pics_equal(got, [p for p in ref.lookup(t)
                                     if p.covers(t)])
    finally:
        q.stop()
    assert not q._thread.is_alive()


def test_threaded_queue_stress():
    """Concurrent lookups from more threads than cores while the worker
    prerenders (tests/test_api_runner.py's stress, with a short switch
    interval): no deadlock, every pic covers its time."""
    events = [tsub.TextEvent(i * 0.1, i * 0.1 + 0.15, f"e{i}")
              for i in range(40)]
    q = tsub.SubPicQueue(tsub.TextSubtitleProvider(events, size=10),
                         max_ahead=4)
    errors = []

    def reader(offset):
        try:
            for i in range(40):
                t = offset + i * 0.05
                for p in q.lookup(t):
                    assert p.covers(t)
                    assert isinstance(p.rgb, np.ndarray)
        except Exception as e:     # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(k * 0.01,))
               for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
        q.stop()
    assert not errors
    assert not any(t.is_alive() for t in threads) and not q._thread.is_alive()


def test_push_bridge_and_composite_equal():
    rng = np.random.default_rng(4)
    pics = {}
    for mod in (tsub, jsub):
        r = np.random.default_rng(4)
        pics[mod] = [mod.SubPic(rgb=r.random((3, 6, 9), np.float32),
                                alpha=r.random((6, 9), np.float32),
                                x=x, y=y, start=0.0, stop=2.0)
                     for x, y in ((3, 2), (-4, 10), (20, -3))]
    tb, jb = tsub.PushSubtitleBridge(), jsub.PushSubtitleBridge()
    tb.deliver(pics[tsub])
    jb.deliver(pics[jsub])
    for t in (0.5, 2.0):
        _assert_pics_equal(tb.render(t), jb.render(t))
    assert tb.next_change(0.0) is None
    frame = rng.random((2, 3, 16, 24), np.float32)
    tf = torch.from_numpy(frame.copy())
    got = tsub.composite(tf, tb.render(0.5))
    want = np.asarray(jsub.composite(jnp.asarray(frame), jb.render(0.5)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tf.numpy(), frame)


def test_srt_equal(tmp_path):
    a, b = tsrt.parse_srt(SRT), jsrt.parse_srt(SRT)
    assert [dataclasses.astuple(e) for e in a] \
        == [dataclasses.astuple(e) for e in b]
    assert [e.text for e in a] == ["Hello world", "Second\nline", "third"]
    path = tmp_path / "s.srt"
    path.write_text(SRT.replace("\n", "\r\n"), encoding="utf-8-sig")
    tp, jp = tsrt.load_srt(str(path), size=12), jsrt.load_srt(str(path),
                                                               size=12)
    assert isinstance(tp, tsub.TextSubtitleProvider)
    for t in (1.5, 2.2, 5.5):
        _assert_pics_equal(tp.render(t), jp.render(t))


# -- quality management (tests/test_quality.py's scenarios) --------------------

def _times(n, late=0.0, start=10.0):
    for i in range(n):
        s = start + i * DUR
        yield s, s + DUR, s + late


def _expensive(qm, n, lateness, start=10.0):
    out = []
    for i in range(n):
        s = start + i * DUR
        d, adj = qm.should_draw(s, s + DUR, s + lateness)
        out.append((d, adj))
        if d != "drop":
            qm.on_render_start(now=s)
            qm.on_render_end(now=s + 0.9 * DUR)
    return out


def _state(qm):
    return (qm.dropped, qm.drawn, qm.render_avg, qm.render_last,
            qm.frame_avg, qm.wait_avg, qm.n_normal, qm.earliness,
            qm.last_draw, qm.supplier_handling_quality)


def _q_on_time(rn, st):
    qm = rn.QualityManager()
    return [qm.should_draw(*f) for f in _times(50)], _state(qm)


def _q_early(rn, st):
    qm = rn.QualityManager()
    return [qm.should_draw(*f) for f in _times(50, late=-0.015)], _state(qm)


def _q_expensive_late(rn, st):
    qm = rn.QualityManager()
    return _expensive(qm, 30, 0.6 * DUR), _state(qm)


def _q_after_drop(rn, st):
    qm = rn.QualityManager()
    trace = _expensive(qm, 8, 0.6 * DUR)
    s = 10.0 + 8 * DUR
    while qm.n_normal != -1 and len(trace) < 200:
        trace.append(qm.should_draw(s, s + DUR, s + 0.6 * DUR))
        s += DUR
    trace.append(qm.should_draw(s, s + DUR, s - 0.020))
    return trace, _state(qm)


def _q_slide(rn, st):
    qm = rn.QualityManager()
    qm.n_normal, qm.earliness = 0, -0.008
    return [qm.should_draw(10.0, 10.0 + DUR, 10.0 - 0.018)], _state(qm)


def _q_messages(late):
    def run(rn, st):
        msgs = []
        qm = rn.QualityManager(quality_sink=lambda m: (msgs.append(m),
                                                       False)[1])
        trace = [qm.should_draw(*f) for f in _times(30, late=late)]
        return trace, [dataclasses.astuple(m) for m in msgs], _state(qm)
    return run


def _q_supplier(handling):
    def run(rn, st):
        qm = rn.QualityManager(quality_sink=lambda m: handling)
        return _expensive(qm, 8, 3.5 * DUR), _state(qm)
    return run


def _q_metrics(rn, st):
    m = st.Metrics()
    qm = rn.QualityManager(metrics=m)
    return _expensive(qm, 20, 0.6 * DUR), _state(qm), m.snapshot()


def _q_spike(rn, st):
    qm = rn.QualityManager()
    out = []
    for a, b in ((0.0, 0.005), (0.1, 0.105), (1.0, 2.0), (3.0, 3.004)):
        qm.on_render_start(now=a)
        qm.on_render_end(now=b)
        out.append((qm.render_avg, qm.render_last))
    return out


class _FakeClock:
    """A clock for both packages' precise_tick and time.sleep: each tick
    advances 0.3 ms, a sleep advances by its delay."""

    def __init__(self):
        self.t = 100.0

    def tick(self):
        self.t += 0.0003
        return self.t

    def sleep(self, d):
        self.t += d


def _clock_run(rn, st, fps, n, sink_msgs=None, late_every=0):
    pc = rn.PresentClock(
        fps=fps, metrics=st.Metrics(),
        quality_sink=None if sink_msgs is None
        else (lambda m: (sink_msgs.append(dataclasses.astuple(m)), False)[1]))
    out = []
    for i in range(n):
        out.append(pc.schedule(i))
        if out[-1]:                           # a render of 0.9 durations
            pc.quality.on_render_start()
            rn.time.sleep(0.9 / fps)
            pc.quality.on_render_end()
        if late_every and i % late_every == 0:
            rn.time.sleep(3.0 / fps)          # a stall: the next ones are late
    drops = [pc.should_drop(i) for i in range(n, n + 5)]
    offs = [pc.wait_for(i) for i in range(n + 5, n + 8)]
    return out, drops, offs, pc.dropped, pc.rendered, _state(pc.quality)


def _q_clock(fps, n, sink=False, late_every=0):
    def run(rn, st):
        msgs = [] if sink else None
        return _clock_run(rn, st, fps, n, msgs, late_every), msgs
    return run


SCENARIOS = {
    "on_time": _q_on_time, "early_waits": _q_early,
    "expensive_late_drops": _q_expensive_late,
    "after_drop_asap": _q_after_drop, "earliness_slide": _q_slide,
    "famine_when_late": _q_messages(0.1),
    "speed_up_when_early": _q_messages(-0.012),
    "supplier_handles": _q_supplier(True),
    "supplier_does_not": _q_supplier(False),
    "drops_into_metrics": _q_metrics, "render_spike": _q_spike,
    "clock_realtime": _q_clock(500.0, 20),
    "clock_sink": _q_clock(1000.0, 5, sink=True),
    "clock_stalls": _q_clock(60.0, 24, sink=True, late_every=5),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_quality_equal(name, monkeypatch):
    results = []
    for rn, st in ((trun, tstats), (jrun, jstats)):
        clock = _FakeClock()
        monkeypatch.setattr(rn, "precise_tick", clock.tick)
        monkeypatch.setattr(rn.time, "sleep", clock.sleep)
        results.append(SCENARIOS[name](rn, st))
    assert results[0] == results[1]


# -- run_clip ------------------------------------------------------------------

def _nv12(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8))


def test_windowed_batches_equal():
    planes = _nv12(16, 8, 10)
    for batch, halo in ((4, 0), (4, 1), (3, 2), (16, 0)):
        a = list(trun.windowed_batches(planes, batch, halo))
        b = list(jrun.windowed_batches(planes, batch, halo))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))


def test_run_clip_outputs_and_metrics():
    from videorenderer_tpu_torch import (ColorFormat, OutputDescriptor,
                                         Settings, SourceDescriptor,
                                         VideoProcessor)
    from videorenderer_tpu_torch.csputils import CSP
    vp = VideoProcessor(Settings(), SourceDescriptor(
        format=ColorFormat.NV12, width=16, height=8, matrix=CSP.BT_709),
        OutputDescriptor(width=16, height=8, bits=8), device="cpu",
        pack_surface=True)
    planes = _nv12(16, 8, 10)
    m = tstats.Metrics()
    res = trun.run_clip(vp._fn, trun.windowed_batches(planes, 4),
                        device="cpu", metrics=m)
    assert res.frames == 10 and len(res.outputs) == 3 and res.fps > 0
    assert m.draw_stats.frames == 3
    for out, b in zip(res.outputs, trun.windowed_batches(planes, 4)):
        assert torch.equal(out, vp.process(b))
    empty = trun.run_clip(vp._fn, [], device="cpu")
    assert (empty.outputs, empty.frames, empty.fps) == ([], 0, 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.run_clip(vp._fn, [], device="cuda")


def test_run_clip_issues_transfer_before_compute(monkeypatch):
    """tests/test_api_runner.py's order check: batch k+1's put is issued
    before batch k's compute."""
    events = []
    put = trun.Stager.put

    def traced(self, batch):
        events.append(("put", float(batch[0].ravel()[0])))
        return put(self, batch)

    monkeypatch.setattr(trun.Stager, "put", traced)
    batches = [(np.full((1, 4, 4), i, np.float32),) for i in range(3)]

    def fn(planes):
        events.append(("compute", float(planes[0].ravel()[0])))
        return planes[0]

    res = trun.run_clip(fn, batches, device="cpu")
    assert res.frames == 3
    assert events == [("put", 0.0), ("put", 1.0), ("compute", 0.0),
                      ("put", 2.0), ("compute", 1.0), ("compute", 2.0)]
