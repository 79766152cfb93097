"""videorenderer_tpu_torch.api.VideoRenderer against the JAX package's
VideoRenderer on the same call sequences, on the CPU (``device="cpu"``):
the scenarios of tests/test_api_runner.py, tests/test_api_deint.py and
tests/test_api_fuzz.py that load no model — planar and packed surfaces,
subtitles (an SRT through ``io.srt``), the alpha bitmap and the stats OSD,
rotation and flip, user shaders before the final dither, the stereo
transform and its subtitle offset, frame stepping, screenshots, live
renegotiation and the cache of built pipelines, settings-routed
deinterlacing — and the device-lost retry.

The tests marked ``kernels`` run the JAX package on its kernel route
(``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``): the screenshots, the geometry and
the deinterlacing, c5s's path among them; the others, whose subject is the
facade's composition, hold it on its XLA route, which is quicker on the
CPU.  The port's CPU path runs its kernels' plain versions.  Band: 1 code on >= 99.9% of the channels, at
most 3 (tests/test_torch_fused.py's band for the mid16 route).  Both
packages' ``precise_tick`` are replaced by one fake clock each, so the
stats OSD shows the same numbers.  Within the port, the renderer's outputs
are bit-equal to the functions it composes (``DeinterlaceSession``, the
blends, ``pack_surface``).

One difference is deliberate: with a packed surface, settings-routed
deinterlacing and a rotation or flip, the port rotates each emitted field
(the JAX package's session leaves the packed fields unrotated there);
``test_deint_packed_rotation`` holds the port to its session + rotation.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu as J
import videorenderer_tpu.api as japi
import videorenderer_tpu.stats as jstats
from videorenderer_tpu.kernels import resize_pallas as jrp

import videorenderer_tpu_torch as T
import videorenderer_tpu_torch.api as tapi
import videorenderer_tpu_torch.stats as tstats
from videorenderer_tpu_torch.io.srt import parse_srt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import dither as tdither
from videorenderer_tpu_torch.ops import geometry as tgeo
from videorenderer_tpu_torch.ops.overlay import (blend_in_rect,
                                                 blend_in_rect_packed)
from videorenderer_tpu_torch.runner import DeinterlaceSession
from videorenderer_tpu_torch.subtitles import TextSubtitleProvider

SRT = """1
00:00:00,000 --> 00:00:10,000
Hi there
"""


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        self.t += 0.001
        return self.t


@pytest.fixture(autouse=True)
def fresh_caches_and_clocks(monkeypatch):
    """Fresh band caches, and a fake clock for each package's renderer and
    stats."""
    monkeypatch.setattr(jrp, "_band_cache", {})
    for mods in ((japi, jstats), (tapi, tstats)):
        clock = _Clock()
        for m in mods:
            monkeypatch.setattr(m, "precise_tick", clock)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package on its kernel route, in interpret mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        yield


kernels = pytest.mark.usefixtures("jax_kernels")


def _e(mod, v):
    """The member of ``mod``'s enum class of the same name as ``v``'s."""
    return getattr(getattr(mod, type(v).__name__), v.name)


def _renderers(settings=None, src=None, dst=None, pack=False):
    """(JAX renderer, port renderer), each opened on the same descriptors
    (given with the port's enums)."""
    out = []
    for mod, cfg, csp, vr_cls, kw in (
            (J, J.config, J.csputils, japi.VideoRenderer, {}),
            (T, T.config, T.csputils, tapi.VideoRenderer, {"device": "cpu"})):
        conv = lambda d, m: {k: (_e(m, v) if hasattr(v, "name") else v)
                             for k, v in (d or {}).items()}
        vr = vr_cls(cfg.Settings(**conv(settings, cfg)), pack_surface=pack,
                    **kw)
        s = {"format": T.ColorFormat.NV12, "width": 32, "height": 16,
             "matrix": T.CSP.BT_709} | (src or {})
        s = {k: (_e(mod, v) if k == "format" else
                 _e(csp, v) if hasattr(v, "name") else v)
             for k, v in s.items()}
        if "hdr10" in s:
            s["hdr10"] = mod.HDR10Metadata(**dataclasses.asdict(s["hdr10"]))
        vr.open(mod.SourceDescriptor(**s),
                mod.OutputDescriptor(**({"width": 32, "height": 16,
                                         "bits": 8} | (dst or {}))))
        out.append(vr)
    return tuple(out)


def _planes(w=32, h=16, seed=0, bits=8, n=None):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    if bits == 8:
        mk = lambda *s: rng.integers(0, 256, lead + s, np.uint8)
    else:
        mk = lambda *s: rng.integers(64, 941, lead + s, np.uint16) << 6
    return mk(h, w), mk(h // 2, w // 2), mk(h // 2, w // 2)


def _codes(out, bits, packed):
    """Integer channel codes of a planar (quantized float) or packed
    output."""
    out = np.asarray(out)
    if packed:
        return np.stack([(out >> (bits * i)) & ((1 << bits) - 1)
                         for i in range(3)], axis=-3).astype(np.int64)
    return np.round(out.astype(np.float64) * (2 ** bits - 1)).astype(
        np.int64)


def assert_band(jout, tout, bits=8, packed=False):
    """Within 1 code on >= 99.9% of the channels, at most 3."""
    tout = tout.numpy() if isinstance(tout, torch.Tensor) else tout
    jout = np.asarray(jout)
    assert jout.shape == tout.shape and jout.dtype == tout.dtype
    if packed:
        assert np.array_equal(np.asarray(jout) >> 30 if bits == 10 else
                              np.asarray(jout) >> 24,
                              tout >> 30 if bits == 10 else tout >> 24)
    d = np.abs(_codes(jout, bits, packed) - _codes(tout, bits, packed))
    assert d.max() <= 3, d.max()
    assert (d > 1).mean() <= 1e-3, (d > 1).mean()


def _both(pair, fn):
    return [fn(vr) for vr in pair]


@kernels
@pytest.mark.parametrize("pack", [False, True], ids=["planar", "packed"])
def test_process_and_screenshots(pack):
    pair = _renderers(dst={"width": 16, "height": 8}, pack=pack)
    planes = _planes()
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    assert to.shape == ((8, 16) if pack else (3, 8, 16))
    assert_band(jo, to, packed=pack)
    jd, td = _both(pair, lambda vr: vr.get_displayed_image())
    assert td.shape == (8, 16, 3) and td.dtype == np.uint8
    assert np.abs(jd.astype(int) - td.astype(int)).max() <= 3
    jc, tc = _both(pair, lambda vr: vr.get_current_image())
    assert tc.shape == (16, 32, 3)
    assert np.abs(jc.astype(int) - tc.astype(int)).max() <= 3
    js, ts = _both(pair, lambda vr: vr.get_stats())
    assert js == ts and ts["frames_drawn"] == 1
    info = pair[1].get_video_processor_info()
    assert "NV12 32x16" in info and "Output: 16x8" in info
    assert "plain PyTorch (CPU)" in info and "Device: cpu" in info


@kernels
@pytest.mark.parametrize("rotation,flip,pack", [
    (90, False, False), (270, True, False), (180, False, True),
    (90, True, True), (0, True, True), (270, False, True)])
def test_rotation_flip(rotation, flip, pack):
    """Rotation keeps the destination surface shape; with a packed surface
    and geometry the only tail, the packed dwords rotate: bit-equal to
    rotating the unrotated packed surface."""
    pair = _renderers(dst={"width": 48, "height": 24}, pack=pack)
    planes = _planes(seed=1)
    unrotated = pair[1].process_frame(planes)
    for vr in pair:
        vr.flt_set("rotation", rotation)
        vr.flt_set("flip", flip)
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    assert to.shape[-2:] == (24, 48)
    assert_band(jo, to, packed=pack)
    assert pair[1].flt_get("rotation") == rotation
    if pack and rotation in (0, 180):
        assert torch.equal(to, tgeo.rotate_flip(unrotated, rotation, flip))
    with pytest.raises(ValueError):
        pair[1].flt_set("rotation", 45)


@pytest.mark.parametrize("case", ["planar", "packed", "packed_hdr"])
def test_overlays(case):
    """Subtitles (an SRT through io.srt's parser), the alpha bitmap and the
    stats OSD; on a PQ output the SDR overlays are pre-compensated.  The
    port's output is bit-equal to its own frame function followed by the
    blends."""
    pack = case != "planar"
    if case == "packed_hdr":
        pair = _renderers(
            settings={"hdr_passthrough": True, "convert_to_sdr": False},
            src={"format": T.ColorFormat.P010, "width": 64, "height": 48,
                 "matrix": T.CSP.BT_2020_NC,
                 "primaries": T.Primaries.BT_2020, "transfer": T.TRC.PQ,
                 "hdr10": T.HDR10Metadata()},
            dst={"width": 64, "height": 48, "bits": 10, "hdr": True},
            pack=True)
        planes, bits = _planes(64, 48, seed=2, bits=10), 10
    else:
        pair = _renderers(src={"width": 64, "height": 48},
                          dst={"width": 96, "height": 72}, pack=pack)
        planes, bits = _planes(64, 48, seed=2), 8
    from videorenderer_tpu.io.srt import parse_srt as jparse
    from videorenderer_tpu.subtitles import TextSubtitleProvider as JTSP
    jev = jparse(SRT)
    for e in jev:
        e.x, e.y = 3, 40
    tev = parse_srt(SRT)
    for e in tev:
        e.x, e.y = 3, 40
    pair[0].set_subtitle_provider(JTSP(jev, size=12), threaded=False)
    pair[1].set_subtitle_provider(TextSubtitleProvider(tev, size=12),
                                  threaded=False)
    bmp = np.random.default_rng(3).random((3, 6, 10), np.float32)
    for vr in pair:
        vr.set_alpha_bitmap(bmp, np.full((6, 10), 0.6, np.float32), x=-2,
                            y=30)
        vr.flt_set("statsEnable", True)
        vr.record_sync_offset(0.002)
    for t in (1.0, 20.0):
        jo, to = _both(pair, lambda vr: vr.process_frame(planes, time=t))
        assert_band(jo, to, bits=bits, packed=pack)
    assert pair[1].get_stats() == pair[0].get_stats()
    # the port's own composition: its frame function, then the blends
    vr = pair[1]
    base = vr._fn(tuple(torch.from_numpy(p) for p in planes))
    assert not torch.equal(to, base)
    vr.flt_set("statsEnable", False)
    vr.set_subtitle_provider(None)
    got = vr.process_frame(planes, time=1.0)
    a = torch.full((6, 10), 0.6)
    rgb = vr._prep(bmp)
    want = (blend_in_rect_packed(base, rgb, a, x=-2, y=30, fmt=vr._out_fmt)
            if pack else blend_in_rect(base, rgb, a, x=-2, y=30))
    assert torch.equal(got, want)


def test_stereo3d_subtitle_offset():
    """The 3D offset shifts overlays only while the half-OU -> interlace
    transform is active (tests/test_api_runner.py's scenario)."""
    bmp, alpha = np.ones((3, 4, 4), np.float32), np.ones((4, 4), np.float32)

    def out_with(transform, offset):
        pair = _renderers(settings={"use_dither": False})
        for vr in pair:
            vr.flt_set("stereo3dTransform", transform)
            vr.set_stereo3d_offset(offset)
            vr.set_alpha_bitmap(bmp, alpha, x=8, y=4)
        jo, to = _both(pair, lambda vr: vr.process_frame(_planes(), time=0.0))
        assert_band(jo, to)
        return to.numpy()

    base, shifted, plain = out_with(0, 6), out_with(1, 6), out_with(0, 0)
    np.testing.assert_array_equal(base, plain)
    assert not np.array_equal(shifted[:, 4:8, 8:12], base[:, 4:8, 8:12])
    np.testing.assert_array_equal(shifted[:, 4:8, 14:18], base[:, 4:8, 8:12])


def test_user_shaders_before_final_dither():
    """An identity shader leaves the output bit-identical; a real one gives
    dither(shader(undithered)); pre- and post-scale shaders run in order."""
    pair = _renderers(dst={"width": 64, "height": 32},
                      settings={"use_dither": True})
    planes = _planes(seed=9)
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    for vr in pair:
        vr.flt_set("cmd_addPostScaleShader", lambda rgb: rgb)
    assert torch.equal(pair[1].process_frame(planes), to)
    jgamma = lambda rgb: jnp.clip(rgb, 0.0, 1.0) ** 1.2
    tgamma = lambda rgb: torch.clamp(rgb, 0.0, 1.0) ** 1.2
    for vr, g in zip(pair, (jgamma, tgamma)):
        vr.flt_set("cmd_clearPostScaleShaders", None)
        vr.flt_set("cmd_addPreScaleShader", lambda rgb: 1.0 - rgb)
        vr.flt_set("cmd_addPostScaleShader", g)
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    assert_band(jo, to)
    vr = pair[1]
    undithered = T.make_frame_fn(dataclasses.replace(vr._plan, dither_bits=0))(
        tuple(torch.from_numpy(p) for p in planes))
    want = tdither.ordered_dither(
        torch.clamp(tgamma(1.0 - undithered), 0.0, 1.0), 8)
    assert torch.equal(to, want)
    for v in pair:
        v.flt_set("cmd_clearPreScaleShaders", None)
        v.flt_set("cmd_clearPostScaleShaders", None)
        v.flt_set("stereo3dTransform", 1)
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    assert_band(jo, to)


def test_frame_step():
    pair = _renderers()
    trace = []
    for vr in pair:
        events, t = [], []
        t.append(vr.can_step())
        vr.frame_step(2)
        vr.process_frame(_planes())
        t.append(vr.step_completed())
        vr.process_frame(_planes())
        t += [vr.step_completed(), vr.step_completed()]
        vr._on_step_complete = lambda: events.append(1)
        vr.frame_step()
        vr.process_frame(_planes())
        vr.frame_step(5)
        vr.cancel_step()
        vr.process_frame(_planes())
        t += [vr.step_completed(), events]
        with pytest.raises(ValueError):
            vr.frame_step(0)
        trace.append(t)
    assert trace[0] == trace[1] == [True, False, True, False, False, [1]]


def test_renegotiation_settings_and_cache():
    """Live reconfiguration: set_settings rebuilds (the dither goes), a
    presentation-only toggle and a screenshot reuse what is built, a
    geometry change rebuilds and switching back hits the cache; mid-stream
    re-open() to P010 HDR at another size and back."""
    pair = _renderers(dst={"width": 64, "height": 32})
    planes = _planes()
    _both(pair, lambda vr: vr.process_frame(planes))
    for vr in pair:
        vr.set_settings(dataclasses.replace(vr.settings, use_dither=False))
    jo, to = _both(pair, lambda vr: vr.process_frame(planes))
    assert_band(jo, to)
    assert np.allclose(to.numpy() * 255, np.round(to.numpy() * 255),
                       atol=1e-4)
    vr = pair[1]
    fn0 = vr._fn
    for key, val in (("statsEnable", True), ("statsEnable", False),
                     ("lessRedraws", True)):
        vr.flt_set(key, val)
        assert vr._fn is fn0
    vr.get_current_image()
    shot0 = vr._shot_cache[1]
    vr.get_current_image()
    assert vr._shot_cache[1] is shot0
    vr.flt_set("rotation", 180)
    fn_rot = vr._fn
    assert fn_rot is not fn0
    vr.flt_set("rotation", 0)
    assert vr._fn is fn0
    vr.flt_set("rotation", 180)
    assert vr._fn is fn_rot
    vr.flt_set("rotation", 0)
    pair[0].flt_set("rotation", 0)
    frames_before = vr.metrics.draw_stats.frames
    hdr = {"format": T.ColorFormat.P010, "width": 48, "height": 32,
           "matrix": T.CSP.BT_2020_NC, "primaries": T.Primaries.BT_2020,
           "transfer": T.TRC.PQ}
    new = _renderers(src=hdr, dst={"width": 64, "height": 32})
    for old, n in zip(pair, new):
        old.open(n._src, n._dst)
    p2 = _planes(48, 32, seed=3, bits=10)
    jo, to = _both(pair, lambda vr: vr.process_frame(p2))
    assert_band(jo, to)
    assert vr.metrics.draw_stats.frames == frames_before + 1
    assert vr._plan.convert_to_sdr
    for old, n in zip(pair, _renderers(dst={"width": 64, "height": 32})):
        old.open(n._src, n._dst)
    jo, to = _both(pair, lambda vr: vr.process_frame(_planes(seed=5)))
    assert_band(jo, to)
    assert vr.flt_get("version") == pair[0].flt_get("version") == "0.3.0"


def test_output_signal_info_and_settings_file(tmp_path):
    h10 = T.HDR10Metadata(mastering_min_nits=0.001, mastering_max_nits=4000.0,
                          max_cll=3500.0, max_fall=800.0)
    src = {"format": T.ColorFormat.P010, "matrix": T.CSP.BT_2020_NC,
           "primaries": T.Primaries.BT_2020, "transfer": T.TRC.PQ,
           "hdr10": h10}
    for settings, dst in (
            ({"hdr_passthrough": True, "convert_to_sdr": False},
             {"bits": 10, "hdr": True}),
            ({"convert_to_sdr": True}, {"bits": 8})):
        pair = _renderers(settings=settings, src=src, dst=dst)
        pair[1].flt_set("rotation", 90)
        pair[0].flt_set("rotation", 90)
        ji, ti = _both(pair, lambda vr: vr.get_output_signal_info())
        assert ti.to_dict() == ji.to_dict()
        assert (ti.width, ti.height) == (32, 16)
    pair[1].save_settings(str(tmp_path / "s.json"))
    assert T.Settings.load(str(tmp_path / "s.json")) == pair[1].settings


def test_displayed_image_bgr48():
    for pack in (False, True):
        pair = _renderers(settings={"use_dither": False},
                          dst={"bits": 10}, pack=pack)
        _both(pair, lambda vr: vr.process_frame(_planes()))
        jd, td = _both(pair, lambda vr: vr.get_displayed_image())
        assert td.shape == (16, 32, 3) and td.dtype == np.uint16
        assert np.all(td % 64 == 0)
        assert np.abs(jd.astype(int) - td.astype(int)).max() <= 3 * 64
        f = pair[1].get_displayed_image(as_uint=False)
        c = np.clip(np.rint(f * 1023.0), 0, 1023).astype(np.uint16)
        np.testing.assert_array_equal(td[..., 2], c[..., 0] << 6)
        np.testing.assert_array_equal(td[..., 0], c[..., 2] << 6)


def test_composition_fuzz():
    """tests/test_api_fuzz.py's invariant without the models: for any
    rotation x flip x stereo x shader x dither, the packed renderer's
    dwords equal the pack of the planar renderer's output (in-kernel pack
    with a geometry-only tail, deferred pack with a float tail); the first
    trials also against the JAX package."""
    rng = np.random.default_rng(77)
    for trial in range(12):
        rotation = int(rng.choice([0, 90, 180, 270]))
        flip, stereo, shader, dither = (bool(rng.integers(2))
                                        for _ in range(4))
        tag = (trial, rotation, flip, stereo, shader, dither)

        def build(packed):
            vr = tapi.VideoRenderer(T.Settings(use_dither=dither),
                                    pack_surface=packed, device="cpu")
            vr.open(T.SourceDescriptor(format=T.ColorFormat.NV12, width=32,
                                       height=16, matrix=T.CSP.BT_709),
                    T.OutputDescriptor(width=48, height=24, bits=8))
            vr.flt_set("rotation", rotation)
            vr.flt_set("flip", flip)
            vr.flt_set("stereo3dTransform", int(stereo))
            if shader:
                vr.flt_set("cmd_addPostScaleShader",
                           lambda rgb: torch.clamp(rgb, 0.0, 1.0) ** 1.05)
            return vr

        planes = _planes(seed=trial)
        planar = build(False).process_frame(planes)
        assert planar.shape == (3, 24, 48), tag
        packed = build(True).process_frame(planes)
        assert torch.equal(packed, trk.pack_surface(planar, "rgba8")), tag


def _deint_pair(double=True, tff=True, rotation=0, pack=False, w=32, h=16,
                ow=32, oh=16, bits=8, **st):
    settings = {"vp_deinterlacing": T.Deinterlacing.ENABLE,
                "deint_double": double} | st
    src = {"interlaced": True, "top_field_first": tff, "width": w,
           "height": h}
    if bits == 10:     # c5's source class: P010 HLG BT.2020
        src |= {"format": T.ColorFormat.P010, "matrix": T.CSP.BT_2020_NC,
                "levels": T.Levels.TV, "primaries": T.Primaries.BT_2020,
                "transfer": T.TRC.HLG}
    pair = _renderers(settings=settings, src=src,
                      dst={"width": ow, "height": oh, "bits": 8}, pack=pack)
    for vr in pair:
        if rotation:
            vr.flt_set("rotation", rotation)
    return pair


def _drive(vr, frames, times=None):
    outs = []
    for i, f in enumerate(frames):
        got = vr.process_frame(f, time=None if times is None else times[i])
        assert isinstance(got, list)
        outs += got
    return outs + vr.flush()


def _session_outputs(vr, frames, **kw):
    sess = DeinterlaceSession(vr._plan, double_rate=vr.settings.deint_double,
                              top_field_first=vr._src.top_field_first,
                              pack_surface=vr._out_fmt is not None,
                              device="cpu", **kw)
    outs = []
    for f in frames:
        outs += sess.push(f)
    return outs + sess.flush()


@kernels
@pytest.mark.parametrize("case", ["double", "single", "bff", "rotation90"])
def test_settings_routed_deint(case):
    """process_frame on an interlaced source returns 0-2 fields a frame,
    then flush: bit-equal to the port's DeinterlaceSession on the same
    frames (+ the rotation), and within the band of the JAX renderer."""
    kw = {"double": {}, "single": {"double": False}, "bff": {"tff": False},
          "rotation90": {"rotation": 90}}[case]
    pair = _deint_pair(**kw)
    frames = [_planes(seed=10 + i) for i in range(4)]
    jo, to = (_drive(vr, frames) for vr in pair)
    assert len(to) == len(jo) == (4 if case == "single" else 8)
    for a, b in zip(jo, to):
        assert_band(a, b)
    want = _session_outputs(pair[1], frames)
    for g, w in zip(to, want):
        assert torch.equal(g, tgeo.rotate_flip(w, kw.get("rotation", 0)))
    assert pair[1].metrics.draw_stats.frames == len(to)
    if case == "double":
        assert "Deinterlacing: motion-adaptive (double-rate)" \
            in pair[1].get_video_processor_info()


@kernels
def test_deint_c5s_packed_with_subtitle():
    """c5s at a small size: P010 HLG interlaced -> RGBA8 through the kernel
    route (K7 + K9's plain versions), a subtitle bitmap on every field;
    each field bit-equal to the session + blend_in_rect_packed, and within
    the band of the JAX renderer (its Pallas kernels in interpret mode)."""
    pair = _deint_pair(pack=True, w=64, h=32, ow=32, oh=16, bits=10,
                       convert_to_sdr=True, upscaling=T.Upscaling.LANCZOS3)
    rng = np.random.default_rng(99)
    rgb = np.full((3, 6, 20), 0.95, np.float32)
    alpha = (rng.random((6, 20)) > 0.45).astype(np.float32) * 0.85
    for vr in pair:
        vr.set_alpha_bitmap(rgb, alpha, x=7, y=9)
    frames = [_planes(64, 32, seed=20 + i, bits=10) for i in range(4)]
    jo, to = (_drive(vr, frames, times=[i / 25 for i in range(4)])
              for vr in pair)
    assert len(to) == 8 and to[0].dtype == torch.int32
    for a, b in zip(jo, to):
        assert_band(a, b, packed=True)
    want = _session_outputs(pair[1], frames)
    for g, w in zip(to, want):
        assert torch.equal(g, blend_in_rect_packed(
            w, torch.from_numpy(rgb), torch.from_numpy(alpha), x=7, y=9,
            fmt="rgba8"))


def test_deint_packed_rotation():
    """The port's deliberate difference: packed fields rotate with the
    surface (the session's packed fields, then rotate_flip)."""
    vr = _deint_pair(pack=True, rotation=180)[1]
    vr.flt_set("flip", True)
    frames = [_planes(seed=30 + i) for i in range(3)]
    got = _drive(vr, frames)
    want = _session_outputs(vr, frames)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, tgeo.rotate_flip(w, 180, True))


def test_deint_disabled_blend_and_reset():
    pair = _deint_pair()
    vr = pair[1]
    vr.set_settings(T.Settings(vp_deinterlacing=T.Deinterlacing.DISABLE))
    out = vr.process_frame(_planes())
    assert not isinstance(out, list) and out.shape == (3, 16, 32)
    assert vr.flush() == []
    assert _deint_pair(deint_blend=True)[1]._deint is None
    vr = _deint_pair()[1]
    frames = [_planes(seed=40 + i) for i in range(3)]
    vr.process_frame(frames[0])
    vr.set_settings(dataclasses.replace(vr.settings,
                                        upscaling=T.Upscaling.LANCZOS3))
    assert vr.process_frame(frames[1]) == []     # the window restarts
    assert len(vr.process_frame(frames[2])) == 2


# -- the device-lost retry, the device, the model hooks -----------------------

def _failing(fn, errors):
    """``fn`` that raises each of ``errors`` once, in turn, then works."""
    errors = list(errors)

    def call(*a):
        if errors:
            raise errors.pop(0)
        return fn(*a)
    return call


def test_device_lost_retried_once():
    vr = _renderers()[1]
    planes = _planes()
    want = vr.process_frame(planes)
    rebuilt = []
    vr._fn = _failing(vr._fn, [torch.AcceleratorError("device lost")])
    orig = vr._rebuild
    vr._rebuild = lambda: (rebuilt.append(1), orig())[1]
    got = vr.process_frame(planes)
    assert torch.equal(got, want)
    assert rebuilt == [1] and vr.get_stats()["frames_failed"] == 1
    # a second failure in the retry raises, counted twice
    vr2 = _renderers()[1]
    real = vr2._rebuild

    def rebuild_failing():
        real()
        vr2._fn = _failing(vr2._fn, [torch.AcceleratorError("again")])
    vr2._fn = _failing(vr2._fn, [torch.AcceleratorError("lost")])
    vr2._rebuild = rebuild_failing
    with pytest.raises(torch.AcceleratorError):
        vr2.process_frame(planes)
    assert vr2.get_stats()["frames_failed"] == 2


@pytest.mark.parametrize("error", [RuntimeError("nvcc failed (1): ..."),
                                   ValueError("unsupported plan")])
def test_build_errors_not_caught(error):
    vr = _renderers()[1]
    vr._fn = _failing(vr._fn, [error])
    with pytest.raises(type(error)):
        vr.process_frame(_planes())
    assert vr.get_stats()["frames_failed"] == 0


def test_deint_device_lost_restarts_window():
    vr = _deint_pair()[1]
    frames = [_planes(seed=50 + i) for i in range(3)]
    vr.process_frame(frames[0])
    vr._deint.push = _failing(vr._deint.push,
                              [torch.AcceleratorError("lost")])
    assert vr.process_frame(frames[1]) == []      # a fresh window
    assert vr.get_stats()["frames_failed"] == 1
    assert len(vr.process_frame(frames[2])) == 2


def test_device_and_model_hooks():
    assert tapi.DEVICE_ERRORS == (torch.AcceleratorError,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.VideoRenderer()
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.VideoRenderer(device="cuda")
    vr = _renderers()[1]
    assert not vr._superres_engaged() and not vr._videohdr_engaged()
    # the hooks take the port's models (their tests: test_torch_models.py)
    from videorenderer_tpu_torch.models import superres, videohdr
    sr = superres.SuperRes(superres.SuperResConfig(channels=8, num_blocks=1))
    vh = videohdr.VideoHDR(videohdr.VideoHDRConfig(channels=8))
    vr.set_superres_params(sr)
    vr.set_videohdr_params(vh)
    assert vr._superres is sr and vr._videohdr is vh
    # a 32 x 16 -> 32 x 16 SDR output: neither gate engages
    assert not vr._superres_engaged() and not vr._videohdr_engaged()
    for hook in (vr.set_superres_params, vr.set_videohdr_params):
        hook(None)
    assert vr._superres is None and vr._videohdr is None
    with pytest.raises(KeyError):
        vr.flt_set("nope", 1)
    with pytest.raises(RuntimeError, match="open"):
        tapi.VideoRenderer(device="cpu").process_frame(_planes())
