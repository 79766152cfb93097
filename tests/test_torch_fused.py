"""The fused linear-resample path of videorenderer_tpu_torch against its
staged path, and both against the JAX package, at small sizes on the CPU:
the port's counterpart of tests/test_fused.py (its cases, its seeded
18-trial configuration fuzz with ``vp_scaling`` and Y8 in it, the dither
and allowlist checks), each case and trial also against the JAX package's
output on the same planes.

Then the paths the port gained with the offset tail, each against the JAX
package (Pallas in interpret mode where the JAX path reaches a kernel:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``; the port's kernel route on the CPU
runs the kernels' plain versions, with ``pipeline._on_card`` patched where
the route is chosen from the planes' device):

 * GRAY sources (Y8, Y16): K1 then K3 on the one plane, the matrix's first
   column, the torch tail;
 * the shader order (``vp_scaling=False``): the corrections at source
   resolution, inside K2's convert epilogue on the kernel route;
 * the SDR BT.2020 fix (CORR_FIX_BT2020) inside K2's tail;
 * a placed plan with a column offset that is not a multiple of 4;
 * Dolby Vision in a rect (K1 ×2 + K8 + K9 with the offset; the JAX
   package's two-stage form).

Bands: fused against staged as tests/test_fused.py holds them (8-bit
codes: more than half a code on < 0.1% of the channels, at most 1.5, and
in the fuzz none over 1.5 and < 0.5% over half), on the fused route with
float32 intermediates (``TexFormat.FLOAT16``), as the JAX package's XLA
fused path computes it on the CPU; the default route's int16 "mid16"
intermediates (``AUTOINT``, the JAX kernel path's) and every route against
the JAX package within 1 code on >= 99.9% of the channels, at most 3
(tests/test_torch_slice.py's band for the kernel path); Dolby Vision in a
rect within tests/test_torch_dovi.py's ROUTE_TOL (1 code on < 2%).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.formats import get_format_info
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import dovi as jdovi

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import dovi as tdovi


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def _planes(fmt_name, w, h, seed=0, bits=8, n=None):
    """tests/test_fused.py's planes: uniform codes of the format's plane
    shapes (10-bit codes MSB-aligned for P010), ``n`` frames or one."""
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    if bits == 8:
        def mk(hh, ww):
            return rng.integers(0, 256, lead + (hh, ww), np.uint8)
    else:
        def mk(hh, ww):
            return rng.integers(0, 1024, lead + (hh, ww), np.uint16) << 6
    shapes = get_format_info(getattr(JFmt, fmt_name)).plane_shapes(w, h)
    return tuple(mk(hh, ww) for hh, ww in shapes)


def _both(fmt_name, w, h, ow, oh, settings=None, src=None, dst=None):
    """The JAX plan and the port's of the same descriptors (settings and
    source overrides by enum member name, as the two packages' enums are
    distinct classes)."""
    def one(cfg, csp, pipe, fmt):
        st = {k: (getattr(getattr(cfg, type(v).__name__), v.name)
                  if hasattr(v, "name") else v)
              for k, v in (settings or {}).items()}
        sd = {k: (getattr(getattr(csp, type(v).__name__), v.name)
                  if hasattr(v, "name") else v)
              for k, v in ({"matrix": tcsp.CSP.BT_709} | (src or {})).items()}
        return pipe.plan_pipeline(
            cfg.Settings(**st),
            pipe.SourceDescriptor(format=getattr(fmt, fmt_name), width=w,
                                  height=h, **sd),
            pipe.OutputDescriptor(width=ow, height=oh, **(dst or {"bits": 8})))
    return one(jcfg, jcsp, jpipe, JFmt), one(tcfg, tcsp, tpipe, TFmt)


def _t(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def assert_jax_band(got, ref, levels=255):
    """The port against the JAX package: within 1 code on >= 99.9% of the
    channels, at most 3 (quantized float output, codes / levels)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    d = np.round(np.abs(got - ref) * levels)
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3, (d.max(),
                                                       (d > 1).mean())


# --- tests/test_fused.py:45 ----------------------------------------------------

CASES = [
    # (fmt, bits, src WxH, dst WxH, settings overrides, src overrides)
    ("NV12", 8, (64, 48), (128, 96), {}, {}),
    ("NV12", 8, (64, 48), (32, 24), dict(upscaling=tcfg.Upscaling.LANCZOS3),
     {}),
    ("P010", 10, (64, 48), (32, 24), dict(convert_to_sdr=True),
     dict(matrix=tcsp.CSP.BT_2020_NC, primaries=tcsp.Primaries.BT_2020,
          transfer=tcsp.TRC.PQ)),
    ("YUY2", 8, (64, 32), (100, 60),
     dict(chroma_scaling=tcfg.ChromaScaling.CATMULL_ROM), {}),
    ("YUV444P8", 8, (64, 32), (20, 12),
     dict(downscaling=tcfg.Downscaling.LANCZOS, interpolate_at_50pct=True),
     {}),
    ("RGB24", 8, (32, 32), (64, 64), {}, {}),
    ("Y8", 8, (32, 32), (48, 48), {}, {}),
    ("NV12", 8, (64, 48), (128, 96), dict(deint_blend=True),
     dict(interlaced=True)),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_fused_matches_staged(case):
    """The port's fused path (its kernel route, the plain versions on the
    CPU) against its staged path at tests/test_fused.py's band, and each
    against the JAX package's fused and staged paths."""
    fmt, bits, (w, h), (ow, oh), st_over, src_over = case
    st = dict(use_dither=False, **st_over)
    jplan, tplan = _both(fmt, w, h, ow, oh,
                         dict(st, tex_format=tcfg.TexFormat.FLOAT16),
                         src_over)
    _, mid16_plan = _both(fmt, w, h, ow, oh, st, src_over)
    assert tpipe.route_of(tplan) == "fused" and jpipe._can_fuse(jplan)
    planes = _planes(fmt, w, h, bits=bits)
    staged = tpipe.make_frame_fn(tplan, fused=False)(_t(planes)).numpy()
    fused = tpipe.make_frame_fn(tplan, fused=True)(_t(planes)).numpy()
    mid16 = tpipe.make_frame_fn(mid16_plan, fused=True)(_t(planes)).numpy()
    assert fused.shape == staged.shape == (3, oh, ow)
    diff = np.abs(fused - staged)
    assert (diff > 0.5 / 255).mean() < 1e-3
    assert diff.max() <= 1.5 / 255
    for fused_jax, got in ((False, staged), (True, fused), (True, mid16)):
        ref = np.asarray(jpipe.make_frame_fn(jplan, fused=fused_jax)(
            _j(planes)))
        assert_jax_band(got, ref)


def test_jinc2_not_fused():
    _, tplan = _both("NV12", 32, 32, 64, 64,
                     dict(upscaling=tcfg.Upscaling.JINC2))
    assert tpipe.route_of(tplan) != "fused"


def test_shader_order_not_fused():
    jplan, tplan = _both("NV12", 32, 32, 64, 64, dict(vp_scaling=False))
    assert tpipe.route_of(tplan) != "fused" and not jpipe._can_fuse(jplan)


def test_fused_with_dither_matches():
    jplan, tplan = _both("NV12", 64, 48, 32, 24,
                         dict(use_dither=True,
                              tex_format=tcfg.TexFormat.FLOAT16))
    planes = _planes("NV12", 64, 48)
    staged = tpipe.make_frame_fn(tplan, fused=False)(_t(planes)).numpy()
    fused = tpipe.make_frame_fn(tplan, fused=True)(_t(planes)).numpy()
    diff = np.abs(staged - fused) * 255
    assert (diff > 0.5).mean() < 1e-3
    assert_jax_band(fused, np.asarray(jpipe.make_frame_fn(jplan, fused=True)(
        _j(planes))))


def test_vp_format_allowlist():
    st = tcfg.Settings(vp_formats=tcfg.VPEnableFormats(
        nv12=False, p01x=True, yuy2=False, other=True))
    info = tpipe.get_format_info
    assert not tpipe._vp_format_allowed(st, info(TFmt.NV12))
    assert tpipe._vp_format_allowed(st, info(TFmt.P010))
    assert not tpipe._vp_format_allowed(st, info(TFmt.YUY2))
    assert tpipe._vp_format_allowed(st, info(TFmt.RGB24))


# --- tests/test_fused.py:105: the seeded fuzz ----------------------------------

FUZZ_FORMATS = ["NV12", "P010", "YUY2", "YUV420P8", "YUV422P8", "YUV444P8",
                "RGB24", "Y8", "AYUV"]


def _fuzz_trials(n=18):
    """tests/test_fused.py's trials, drawn from the same seeded generator in
    the same order: (fmt name, w, h, ow, oh, settings)."""
    rng = np.random.default_rng(1234)
    fmts = FUZZ_FORMATS
    ups, downs = list(tcfg.Upscaling), list(tcfg.Downscaling)
    chromas = list(tcfg.ChromaScaling)
    out = []
    for _ in range(n):
        fmt = fmts[rng.integers(len(fmts))]
        dw, dh = get_format_info(getattr(JFmt, fmt)).chroma_div
        w = int(rng.integers(2, 9)) * 8 * dw
        h = int(rng.integers(2, 7)) * 8 * dh
        ow = int(rng.integers(2, 12)) * 8
        oh = int(rng.integers(2, 10)) * 8
        st = dict(upscaling=ups[rng.integers(len(ups))],
                  downscaling=downs[rng.integers(len(downs))],
                  chroma_scaling=chromas[rng.integers(len(chromas))],
                  interpolate_at_50pct=bool(rng.integers(2)),
                  use_dither=bool(rng.integers(2)),
                  vp_scaling=bool(rng.integers(2)))
        out.append((fmt, w, h, ow, oh, st))
    return out


TRIALS = _fuzz_trials()


def test_fuzz_covers_the_new_paths():
    """The fuzz draws the shader order and may draw Y8 (both refused by the
    port before its offset tail; this seed draws no Y8, which CASES[6] and
    test_gray_matches_jax run)."""
    assert any(not st["vp_scaling"] for *_, st in TRIALS)
    assert "Y8" in FUZZ_FORMATS and any(c[0] == "Y8" for c in CASES)


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_config_fuzz_fused_vs_staged(trial):
    """Every trial builds and runs; where the fused path is legal it
    matches the staged path at tests/test_fused.py's band; both match the
    JAX package's outputs on the same planes."""
    fmt, w, h, ow, oh, st = TRIALS[trial]
    jplan, tplan = _both(fmt, w, h, ow, oh,
                         dict(st, tex_format=tcfg.TexFormat.FLOAT16))
    _, mid16_plan = _both(fmt, w, h, ow, oh, st)
    assert (tpipe.route_of(tplan) == "fused") == jpipe._can_fuse(jplan)
    planes = _planes(fmt, w, h, seed=trial, bits=10 if fmt == "P010" else 8)
    staged = tpipe.make_frame_fn(tplan, fused=False)(_t(planes)).numpy()
    assert staged.shape == (3, oh, ow), (trial, fmt, w, h, ow, oh)
    assert np.isfinite(staged).all(), (trial, fmt)
    auto = tpipe.make_frame_fn(tplan)(_t(planes)).numpy()
    if tpipe.route_of(tplan) == "fused":
        d = np.abs(auto - staged)
        assert (d > 1.5 / 255).mean() == 0, (trial, fmt, st)
        assert (d > 0.5 / 255).mean() < 5e-3, (trial, fmt, st)
    else:
        assert auto.shape == staged.shape
    ref_auto = np.asarray(jpipe.make_frame_fn(jplan)(_j(planes)))
    assert_jax_band(staged, np.asarray(jpipe.make_frame_fn(
        jplan, fused=False)(_j(planes))))
    assert_jax_band(auto, ref_auto)
    assert_jax_band(tpipe.make_frame_fn(mid16_plan)(_t(planes)).numpy(),
                    ref_auto)


# --- the new paths against the JAX package -------------------------------------

@pytest.mark.parametrize("fmt,bits", [("Y8", 8), ("Y16", 16)])
@pytest.mark.parametrize("kernel", [True, False])
def test_gray_matches_jax(fmt, bits, kernel, monkeypatch):
    """A GRAY source to 10-bit dithered output, 2:1 down: the port's K1 +
    K3 route (plain versions) against the JAX kernel route in interpret
    mode, and the plain route against the JAX XLA route."""
    jplan, tplan = _both(fmt, 64, 48, 32, 24,
                         dict(use_accel_backend=kernel), {},
                         dict(bits=10))
    rng = np.random.default_rng(21)
    y = (rng.integers(0, 256, (2, 48, 64), np.uint8) if bits == 8 else
         rng.integers(0, 65536, (2, 48, 64), np.uint16))
    fn = jpipe.make_frame_fn(jplan)
    ref = (in_interpret(monkeypatch, lambda: fn((jnp.asarray(y),)))
           if kernel else np.asarray(fn((jnp.asarray(y),))))
    got = tpipe.make_frame_fn(tplan)(_t((y,))).numpy()
    assert got.shape == (2, 3, 24, 32)
    assert_jax_band(got, ref, 1023)


def _hdr_both(w=128, h=64, ow=64, oh=32, bits=10, transfer="PQ",
              primaries="BT_2020", rect=None, **settings):
    settings.setdefault("upscaling", tcfg.Upscaling.LANCZOS3)
    return _both("P010", w, h, ow, oh, settings,
                 dict(matrix=tcsp.CSP.BT_2020_NC, levels=tcsp.Levels.TV,
                      primaries=getattr(tcsp.Primaries, primaries),
                      transfer=getattr(tcsp.TRC, transfer)),
                 dict(bits=bits, video_rect=rect))


@pytest.mark.parametrize("transfer", ["PQ", "HLG", "GAMMA28"])
@pytest.mark.parametrize("kernel", [True, False])
def test_shader_order_matches_jax(transfer, kernel, monkeypatch):
    """The shader order (the corrections at source resolution, then the
    resize, the final pass): the port's kernel convert (K1 + K2 with the
    correction in its epilogue, plain versions) against the JAX kernel
    convert in interpret mode, and its torch convert against the JAX XLA
    convert; PQ -> SDR, HLG -> SDR and the SDR BT.2020 fix."""
    jplan, tplan = _hdr_both(transfer=transfer, vp_scaling=False)
    assert tpipe.route_of(tplan) != "fused"
    planes = _planes("P010", 128, 64, seed=22, bits=10, n=2)
    fn = jpipe.make_frame_fn(jplan)
    if kernel:
        ref = in_interpret(monkeypatch, lambda: fn(_j(planes)))
        monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    else:
        ref = np.asarray(fn(_j(planes)))
    got = tpipe.make_frame_fn(tplan)(_t(planes)).numpy()
    assert_jax_band(got, ref, 1023)


def test_shader_order_kernel_convert_calls(monkeypatch):
    """The shader order's convert on the kernel route: K1 on U and V, K2
    with the plan's correction (float32 out, no dither) and nothing else;
    the resize and the final pass in torch."""
    _, tplan = _hdr_both(vp_scaling=False)
    calls = []
    for name in ("banded_resize_last_axis", "rows3_tail",
                 "banded_resize_rows"):
        orig = getattr(trk, name)

        def wrap(*a, _o=orig, _n=name, **k):
            calls.append((_n, a[6] if _n == "rows3_tail" else None))
            return _o(*a, **k)
        monkeypatch.setattr(trk, name, wrap)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    tpipe.make_frame_fn(tplan)(_t(_planes("P010", 128, 64, bits=10, n=1)))
    assert [c[0] for c in calls] == ["banded_resize_last_axis"] * 2 + [
        "rows3_tail"]
    epi = calls[-1][1]
    assert (epi.correction, epi.dither_bits) == (trk.CORR_PQ_TO_SDR, 0)


@pytest.mark.parametrize("transfer", ["GAMMA28", "BT_1886", "LINEAR"])
@pytest.mark.parametrize("pack", [True, False])
def test_sdr_bt2020_fix_matches_jax_kernel(transfer, pack, monkeypatch):
    """SDR with BT.2020 primaries on a 709 display: the port's K1 ×3 + K2
    with CORR_FIX_BT2020 (plain versions) against the JAX kernel route in
    interpret mode (rows3_tail with the fix in its epilogue)."""
    jplan, tplan = _hdr_both(transfer=transfer)
    assert tplan.fix_bt2020_sdr and jplan.fix_bt2020_sdr
    assert tpipe._make_tail_epilogue(tplan).correction == trk.CORR_FIX_BT2020
    planes = _planes("P010", 128, 64, seed=23, bits=10, n=2)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=pack)(_j(planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=pack)(_t(planes)).numpy()
    if pack:
        assert got.shape == ref.shape
        d = np.stack([np.abs(((got >> s) & 1023).astype(int)
                             - ((ref >> s) & 1023).astype(int))
                      for s in (0, 10, 20)])
        assert (d <= 1).mean() >= 0.999 and d.max() <= 3
    else:
        assert_jax_band(got, ref, 1023)


@pytest.mark.parametrize("rect", [(2, 1, 63, 31), (4, 3, 60, 29)])
def test_placed_offset_matches_jax_kernel(rect, monkeypatch):
    """A placed plan with an unaligned and an aligned column offset: the
    port's K1 ×3 + K2 with the offset against the JAX kernel route (K1,
    K3, the XLA tail) in interpret mode; the bars equal."""
    jplan, tplan = _hdr_both(rect=rect, convert_to_sdr=True)
    planes = _planes("P010", 128, 64, seed=24, bits=10, n=2)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(_j(planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(_t(planes)).numpy()
    assert got.shape == ref.shape == (2, 32, 64)
    l, tp, r, b = rect
    mask = np.ones((32, 64), bool)
    mask[tp:b, l:r] = False
    assert np.array_equal(got[..., mask], ref[..., mask])
    assert np.all(got[..., mask] == trk.PACKED_ZERO["rgb10a2"])
    d = np.stack([np.abs(((got >> s) & 1023).astype(int)
                         - ((ref >> s) & 1023).astype(int))
                  for s in (0, 10, 20)])
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3


def _dovi_both(rect, pack=True):
    fields = dict(curves=(jdovi.identity_curve(),) * 3,
                  ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                              [1, -0.164553, -0.571353],
                                              [1, 1.8814, 0]]),
                  ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
                  rgb_to_lms_matrix=np.linalg.inv(jdovi.DOVI_LMS2RGB))
    jm = jdovi.DoviMetadata(**fields)
    tm = tdovi.metadata_from_numpy(dataclasses.asdict(jm))
    out = []
    for cfg, csp, pipe, fmt, meta in ((jcfg, jcsp, jpipe, JFmt, jm),
                                      (tcfg, tcsp, tpipe, TFmt, tm)):
        out.append(pipe.plan_pipeline(
            cfg.Settings(convert_to_sdr=True,
                         upscaling=cfg.Upscaling.CATMULL_ROM),
            pipe.SourceDescriptor(format=fmt.P010, width=64, height=32,
                                  matrix=csp.CSP.BT_2020_NC,
                                  levels=csp.Levels.TV,
                                  primaries=csp.Primaries.BT_2020,
                                  transfer=csp.TRC.PQ, dovi=meta,
                                  hdr10=pipe.HDR10Metadata()),
            pipe.OutputDescriptor(width=48, height=24, bits=10,
                                  video_rect=rect)))
    return out


@pytest.mark.parametrize("rect", [(8, 4, 40, 20), (3, 2, 35, 18)])
def test_dovi_in_rect_matches_jax(rect, monkeypatch):
    """Dolby Vision into a rect of the surface (both offsets nonzero; an
    unaligned column offset): the port's K1 ×2 + K8 + K9 with the offset
    (plain versions) against the JAX package's two-stage form in interpret
    mode, within test_torch_dovi's ROUTE_TOL; the bars the packed zero;
    K9 called with the rect's origin."""
    jplan, tplan = _dovi_both(rect)
    planes = _planes("P010", 64, 32, seed=25, bits=10, n=2)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(_j(planes)))
    seen = []
    orig = tdk.cols3_tail

    def k9(*a, **k):
        seen.append(k.get("place"))
        return orig(*a, **k)
    monkeypatch.setattr(tdk, "cols3_tail", k9)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(_t(planes)).numpy()
    l, tp, r, b = rect
    assert seen == [(24, 48, tp, l)]
    assert got.shape == ref.shape == (2, 24, 48)
    mask = np.ones((24, 48), bool)
    mask[tp:b, l:r] = False
    assert np.all(got[..., mask] == trk.PACKED_ZERO["rgb10a2"])
    assert np.array_equal(got[..., mask], ref[..., mask])
    d = np.stack([np.abs(((got >> s) & 1023).astype(int)
                         - ((ref >> s) & 1023).astype(int))
                  for s in (0, 10, 20)])
    assert d.max() <= 1 and (d > 0).mean() < 0.02
