"""Motion-adaptive deinterlacing in videorenderer_tpu_torch (c5: 4K HLG
interlaced -> 1080p SDR, both fields) against the JAX package, at small
sizes on the CPU: the same inputs (numpy, from a seed) through the JAX
function and its port.

 * ``ops/deinterlace`` (bob, weave, blend, motion_adaptive,
   double_rate_fields): equal within 1e-7 on [0, 1) planes.
 * K7's plain version against the JAX ``deint3_rows_dual`` in interpret
   mode: float32 within 3e-5 (the JAX kernel's split-bf16 products); against
   the JAX ``_deint_fields`` and a float32 dense product: within 1e-6.
 * K9's plain version against the JAX ``cols3_tail`` in interpret mode:
   within 1 code and equal on >= 99% of the channels, float output within
   1e-5 without a correction.
 * ``make_deint_fields_fn``: the port's kernel branch (the plain versions
   of K7 and K9 on CPU tensors) against the JAX kernel branch: <= 1 code,
   equal on >= 99%; its plain branch against the JAX XLA branch: <= 1 code.
   ``make_deint_frame_fn`` against JAX: <= 1 code.
 * ``DeinterlaceSession``: the same outputs in the same order as the JAX
   session, through push/flush and push_batch/flush_batch (<= 1 code; the
   port's default route is H first, the JAX one on the CPU W first).
 * The float64 deinterlace oracle against the JAX path at float64: >= 55 dB.

The JAX kernel paths run as the JAX tests run them on the CPU:
``make_deint_fields_fn(plan, force_kernel=True)`` inside
``pltpu.force_tpu_interpret_mode()``.
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
from videorenderer_tpu.kernels import deint_pallas as jdp
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import chroma as jchroma
from videorenderer_tpu.ops import deinterlace as jdi
from videorenderer_tpu.ops import scale as jscale
from videorenderer_tpu.runner import DeinterlaceSession as JSession

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import deinterlace as tdi
from videorenderer_tpu_torch.oracle import oracle_deint
from videorenderer_tpu_torch.runner import DeinterlaceSession as TSession

THR = 8.0 / 255.0


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def codes(x, pack):
    """Channel codes of a packed surface, or of a quantized float output."""
    x = np.asarray(x)
    if pack is None:
        return np.round(x.astype(np.float64) * 255.0).astype(np.int64)
    d = x.view(np.uint32)
    bits, mask = (10, 0x3FF) if pack == "rgb10a2" else (8, 0xFF)
    return np.stack([(d >> (bits * i)) & mask for i in range(3)],
                    -3).astype(np.int64)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- ops/deinterlace ---------------------------------------------------------

OPS = {
    "bob0": lambda m, f, tff: m.bob(f[1], 0, tff),
    "bob1": lambda m, f, tff: m.bob(f[1], 1, tff),
    "weave": lambda m, f, tff: m.weave(f[1]),
    "blend": lambda m, f, tff: m.blend(f[1]),
    "motion0": lambda m, f, tff: m.motion_adaptive(f[1], f[0], f[2], 0, tff),
    "motion1": lambda m, f, tff: m.motion_adaptive(f[1], f[0], f[2], 1, tff,
                                                   threshold=0.05),
    "double": lambda m, f, tff: m.double_rate_fields(f[1], tff),
}


@pytest.mark.parametrize("h", [9, 10])
@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("op", list(OPS))
def test_deinterlace_ops_match_jax(op, tff, h):
    rng = np.random.default_rng(1)
    frames = [rng.random((2, h, 12), dtype=np.float32) for _ in range(3)]
    # static and moving pixels both: prev == next on the left half
    frames[2][..., :6] = frames[0][..., :6]
    ref = OPS[op](jdi, [jnp.asarray(f) for f in frames], tff)
    got = OPS[op](tdi, [t(f) for f in frames], tff)
    if op == "double":
        ref, got = np.stack(ref), torch.stack(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)


# --- K7 ---------------------------------------------------------------------

# (format, width, height, output height): c5's P010 form and the NV12 form
# with a chroma height (20) that is not a multiple of 16
K7_CASES = [("P010", 64, 32, 16), ("NV12", 64, 40, 24)]


def _k7_inputs(fmt, w, h, h_out, seed):
    rng = np.random.default_rng(seed)
    dt, hi, shift = ((np.uint16, 1024, 6) if fmt == "P010"
                     else (np.uint8, 256, 0))
    frames = []
    for _ in range(3):
        frames.append(tuple((rng.integers(0, hi, s).astype(dt) << shift)
                            .astype(dt)
                            for s in ((2, h, w), (2, h // 2, w // 2),
                                      (2, h // 2, w // 2))))
    # prev == next on the left half: weave, ramp and bob all occur
    frames[2] = tuple(np.concatenate([p[..., :w_ // 2], n[..., w_ // 2:]], -1)
                      for p, n, w_ in zip(frames[0], frames[2],
                                          (w, w // 2, w // 2)))
    wy = jscale.upscale_matrix(jcfg.Upscaling.LANCZOS3, h, h_out)
    _, uy = jchroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, jcfg.ChromaScaling.BILINEAR,
        jcsp.ChromaLocation.MPEG2)
    my_y = np.asarray(wy, np.float32)
    my_c = np.asarray(uy @ wy, np.float32)
    maxval = 65535.0 if fmt == "P010" else 255.0
    return frames, my_y, my_c, THR * maxval, 1.0 / maxval


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_plain_matches_jax_kernel(case, tff):
    fmt, w, h, h_out = case
    frames, my_y, my_c, thr, norm = _k7_inputs(fmt, w, h, h_out, 2)
    with pltpu.force_tpu_interpret_mode():
        ref = jdp.deint3_rows_dual(
            *(tuple(jnp.asarray(p) for p in f) for f in frames), my_y, my_c,
            h_out, thr, top_field_first=tff, y_scale=norm, c_scale=norm)
    got = tdk.deint3_rows_dual(
        *(tuple(t(p) for p in f) for f in frames),
        trk.BandedMatrix(my_y, pre_scale=norm),
        trk.BandedMatrix(my_c, pre_scale=norm), h_out, thr, tff)
    for f, rf in enumerate(ref):
        for r, g in zip(rf, got):
            assert g[:, f].shape == r.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g[:, f].numpy(), np.asarray(r), rtol=0,
                                       atol=3e-5)


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_plain_matches_jax_select_and_dense_product(case, tff):
    fmt, w, h, h_out = case
    frames, my_y, my_c, thr, norm = _k7_inputs(fmt, w, h, h_out, 3)
    ys, us, vs = tdk.deint3_rows_dual(
        *(tuple(t(p) for p in f) for f in frames),
        trk.BandedMatrix(my_y, pre_scale=norm),
        trk.BandedMatrix(my_c, pre_scale=norm), h_out, thr, tff)
    for k, (got, mat) in enumerate(((ys, my_y), (us, my_c), (vs, my_c))):
        m = mat * np.float32(norm)
        for b in range(2):   # _deint_fields takes one (H, W) stripe
            pf, cf, nf = (jnp.asarray(f[k][b], jnp.float32) for f in frames)
            d = jdp._deint_fields(pf, cf, nf, thr, tff, cf.shape[0])
            for f in (0, 1):
                want = m.T @ np.asarray(d[f])
                np.testing.assert_allclose(got[b, f].numpy(), want, rtol=0,
                                           atol=1e-6)


def test_k7_stacks_both_fields_per_plane():
    """(y, u, v) of (B, 2, h_out, W): field f of a plane is [:, f], and each
    field equals a one-field motion-adaptive deinterlace and H product."""
    frames, my_y, my_c, thr, norm = _k7_inputs("NV12", 64, 40, 24, 4)
    tf = [tuple(t(p) for p in f) for f in frames]
    out = tdk.deint3_rows_dual(*tf, trk.BandedMatrix(my_y, pre_scale=norm),
                               trk.BandedMatrix(my_c, pre_scale=norm), 24, thr)
    assert [tuple(o.shape) for o in out] == [(2, 2, 24, 64), (2, 2, 24, 32),
                                             (2, 2, 24, 32)]
    for k, mat in enumerate((my_y, my_c, my_c)):
        m = torch.from_numpy(mat * np.float32(norm)).T
        p, c, n = (f[k].to(torch.float32) for f in tf)
        for f in (0, 1):
            want = m @ tdi.motion_adaptive(c, p, n, f, threshold=thr)
            np.testing.assert_allclose(out[k][:, f].numpy(), want.numpy(),
                                       rtol=0, atol=1e-6)


# --- K9 ---------------------------------------------------------------------

def _plan_args(cfg, csp, pipe, fmt, *, fmt_name="P010", w=64, h=32, ow=32,
               oh=16, transfer="HLG", bits=8, interlaced=True, **settings):
    matrix = csp.CSP.BT_709 if fmt_name == "NV12" else csp.CSP.BT_2020_NC
    prim = csp.Primaries.BT_709 if fmt_name == "NV12" else csp.Primaries.BT_2020
    src = pipe.SourceDescriptor(
        format=getattr(fmt, fmt_name), width=w, height=h, matrix=matrix,
        levels=csp.Levels.TV, primaries=prim,
        transfer=getattr(csp.TRC, transfer), interlaced=interlaced)
    settings.setdefault("convert_to_sdr", True)
    settings.setdefault("upscaling", "LANCZOS3")
    settings["upscaling"] = cfg.Upscaling[settings["upscaling"]]
    return (cfg.Settings(**settings), src,
            pipe.OutputDescriptor(width=ow, height=oh, bits=bits))


def _plans(**kw):
    return (jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt, **kw)),
            tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, **kw)))


# (transfer, output bits, use_dither, pack, with_cmat)
K9_EPILOGUES = {
    "pq_dither10_rgb10a2": ("PQ", 10, True, "rgb10a2", True),
    "hlg_dither8_rgba8": ("HLG", 8, True, "rgba8", True),
    "hlg_dither8_float": ("HLG", 8, True, None, True),
    "none_round8_rgba8": ("BT_1886", 8, False, "rgba8", True),
    "none_float": ("BT_1886", 16, True, None, True),
    "none_float_no_cmat": ("BT_1886", 16, True, None, False),
}


@pytest.mark.parametrize("maps", ["both", "none"])
@pytest.mark.parametrize("epi", list(K9_EPILOGUES))
def test_k9_plain_matches_jax_kernel(maps, epi):
    transfer, bits, dither, pack, with_cmat = K9_EPILOGUES[epi]
    # an SDR source keeps BT.709 primaries (BT.2020 ones take the gamut fix)
    jplan, tplan = _plans(transfer=transfer, bits=bits, use_dither=dither,
                          fmt_name="NV12" if transfer == "BT_1886" else "P010")
    rng = np.random.default_rng(5)
    h = 16
    if maps == "both":
        # K7's float output at c5's geometry: luma 64 -> 32 columns, chroma
        # 32 -> 32 through the composed upsample and resize
        wx = jscale.upscale_matrix(jcfg.Upscaling.LANCZOS3, 64, 32)
        ux, _ = jchroma.chroma_upsample_matrices(
            32, 16, 420, jcfg.ChromaScaling.BILINEAR, jcsp.ChromaLocation.MPEG2)
        mx_y, mx_c = np.asarray(wx, np.float32), np.asarray(ux @ wx, np.float32)
        planes = (rng.uniform(0.06, 0.92, (2, h, 64)).astype(np.float32),
                  rng.uniform(0.06, 0.94, (2, h, 32)).astype(np.float32),
                  rng.uniform(0.06, 0.94, (2, h, 32)).astype(np.float32))
        scale = None
        tm = (trk.BandedMatrix(mx_y), trk.BandedMatrix(mx_c))
    else:
        # raw planes read directly, times the normalisation
        mx_y = mx_c = None
        planes = tuple(rng.integers(64 << 6, 941 << 6, (2, h, 32))
                       .astype(np.uint16) for _ in range(3))
        scale = 1.0 / 65535.0
        tm = (None, None)
    jepi = jpipe._make_tail_epilogue(jplan, with_cmat=with_cmat)
    tepi = tpipe._make_tail_epilogue(tplan, with_cmat=with_cmat)
    assert (tepi.cmat is None) == (not with_cmat)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdp.cols3_tail(
            *(jnp.asarray(p) for p in planes), mx_y, mx_c, 32, jepi,
            y_scale=scale, c_scale=scale, pack_format=pack))
    got = tdk.cols3_tail(*(t(p) for p in planes), *tm, 32, tepi,
                         y_scale=scale, c_scale=scale,
                         pack_format=pack).numpy()
    assert got.shape == ref.shape == ((2, h, 32) if pack else (2, 3, h, 32))
    if tplan.dither_bits == 0:
        # the JAX kernel's split-bf16 W products, amplified by the colour
        # matrix's chroma gains (~2): measured 1.67e-5, held at 3e-5 for
        # reorderings of the plain sums (ROADMAP §3)
        tol = 3e-5 if maps == "both" and with_cmat else 1e-5
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        return
    if pack is None:
        q = 2 ** abs(tplan.dither_bits) - 1
        d = np.abs(np.round((got.astype(np.float64) - ref) * q))
    else:
        d = np.abs(codes(got, pack) - codes(ref, pack))
        alpha = 30 if pack == "rgb10a2" else 24
        assert np.array_equal(got.view(np.uint32) >> alpha,
                              ref.view(np.uint32) >> alpha)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_kernel_wrappers_refuse_bad_input():
    frames, my_y, my_c, thr, norm = _k7_inputs("NV12", 64, 40, 24, 6)
    frames = [tuple(t(p) for p in f) for f in frames]
    ky, kc = trk.BandedMatrix(my_y), trk.BandedMatrix(my_c)
    mixed = (frames[0][0], frames[0][1].to(torch.int16), frames[0][2])
    with pytest.raises(TypeError, match="one dtype"):
        tdk.deint3_rows_dual(mixed, frames[1], frames[2], ky, kc, 24, thr)
    with pytest.raises(ValueError, match="H matrix"):
        tdk.deint3_rows_dual(*frames, kc, kc, 24, thr)
    with pytest.raises(ValueError, match="differ in shape"):
        tdk.deint3_rows_dual(frames[0], frames[1],
                             tuple(p[:1] for p in frames[2]), ky, kc, 24, thr)
    y = torch.zeros((1, 8, 16))
    c = torch.zeros((1, 8, 8))
    epi = tpipe._make_tail_epilogue(_plans()[1])
    with pytest.raises(ValueError, match="no W matrix"):
        tdk.cols3_tail(y, c, c, None, None, 8, epi, y_scale=1.0)
    with pytest.raises(ValueError, match="W matrix"):
        tdk.cols3_tail(y, c, c, trk.BandedMatrix(np.ones((8, 8))), None, 8,
                       epi)
    with pytest.raises(NotImplementedError):
        tdk.cols3_tail(c, c, c, None, None, 8, epi, pack_format="rgb565")
    meta = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tdk.cols3_tail(meta, meta, meta, None, None, 8, epi)


# --- the path: make_deint_fields_fn, make_deint_frame_fn ------------------------

# (plan keywords, input format and sizes): c5's form at 64x32 and NV12 at
# 64x40 (chroma height 20), rounded instead of dithered
PATH_CASES = {
    "c5": dict(),
    "nv12_64x40": dict(fmt_name="NV12", h=40, oh=24, transfer="BT_1886",
                       use_dither=False),
}


def _window(kw, seed):
    """(prev, cur, next) raw frames of a plan's format, prev == next on the
    left half of every plane."""
    fmt = kw.get("fmt_name", "P010")
    w, h = kw.get("w", 64), kw.get("h", 32)
    rng = np.random.default_rng(seed)

    def frame():
        if fmt == "P010":
            return (rng.integers(64, 941, (2, h, w), np.uint16) << 6,
                    rng.integers(64, 961, (2, h // 2, w // 2), np.uint16) << 6,
                    rng.integers(64, 961, (2, h // 2, w // 2), np.uint16) << 6)
        return (rng.integers(16, 236, (2, h, w), dtype=np.uint8),
                rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8),
                rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8))

    p, c, n = frame(), frame(), frame()
    n = tuple(np.concatenate([a[..., :a.shape[-1] // 2],
                              b[..., a.shape[-1] // 2:]], -1)
              for a, b in zip(p, n))
    return p, c, n


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_fields_kernel_branch_matches_jax_kernel(case, tff, pack):
    kw = PATH_CASES[case]
    jplan, tplan = _plans(**kw)
    win = _window(kw, 7)
    with pltpu.force_tpu_interpret_mode():
        ref = jpipe.make_deint_fields_fn(jplan, top_field_first=tff,
                                         pack_surface=pack,
                                         force_kernel=True)(*win)
    fn = tpipe.make_deint_fields_fn(tplan, top_field_first=tff,
                                    pack_surface=pack)
    got = fn(*(tuple(t(x) for x in f) for f in win))
    fmt = tpipe.surface_pack_format(tplan.dst) if pack else None
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        d = np.abs(codes(g.numpy(), fmt) - codes(r, fmt))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_fields_plain_branch_matches_jax_xla(case, tff):
    kw = dict(PATH_CASES[case], use_accel_backend=False)
    jplan, tplan = _plans(**kw)
    assert not tpipe._can_kernel_deint(tplan)
    win = _window(kw, 8)
    ref = jpipe.make_deint_fields_fn(jplan, top_field_first=tff,
                                     pack_surface=True)(*win)
    got = tpipe.make_deint_fields_fn(tplan, top_field_first=tff,
                                     pack_surface=True)(
        *(tuple(t(x) for x in f) for f in win))
    fmt = tpipe.surface_pack_format(tplan.dst)
    for r, g in zip(ref, got):
        assert np.abs(codes(g.numpy(), fmt) - codes(r, fmt)).max() <= 1


@pytest.mark.parametrize("accel", [True, False])
@pytest.mark.parametrize("field", [0, 1])
def test_frame_fn_matches_jax(field, accel):
    """Single rate: the deinterlace in torch, then make_frame_fn (K1 x3 +
    K2 on a card; their plain versions here) on float32 raw-unit planes."""
    kw = dict(use_accel_backend=accel)
    jplan, tplan = _plans(**kw)
    win = _window(kw, 9)
    ref = jpipe.make_deint_frame_fn(jplan, field=field, pack_surface=True)(*win)
    got = tpipe.make_deint_frame_fn(tplan, field=field, pack_surface=True)(
        *(tuple(t(x) for x in f) for f in win))
    d = np.abs(codes(got.numpy(), "rgba8") - codes(ref, "rgba8"))
    assert d.max() <= 1


# which plans take the kernel route: as the JAX package decides on a TPU
ROUTE_CASES = {
    "c5": dict(),
    "nv12": dict(fmt_name="NV12", transfer="BT_1886"),
    "no_accel": dict(use_accel_backend=False),
    "p01x_off": dict(vp_formats=None),
    "jinc2": dict(upscaling="JINC2", ow=128, oh=64, transfer="BT_1886"),
    "yuy2": dict(fmt_name="YUY2", transfer="BT_1886"),
    "src_rect": dict(src_rect=(0, 0, 32, 16)),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_kernel_route_condition_matches_jax(case, monkeypatch):
    kw = dict(ROUTE_CASES[case])
    rect = kw.pop("src_rect", None)
    if "vp_formats" in kw:
        kw["vp_formats"] = jcfg.VPEnableFormats(p01x=False)
        jargs = _plan_args(jcfg, jcsp, jpipe, JFmt, **kw)
        kw["vp_formats"] = tcfg.VPEnableFormats(p01x=False)
        targs = _plan_args(tcfg, tcsp, tpipe, TFmt, **kw)
    else:
        jargs = _plan_args(jcfg, jcsp, jpipe, JFmt, **kw)
        targs = _plan_args(tcfg, tcsp, tpipe, TFmt, **kw)
    if rect is not None:
        jargs = (jargs[0], dataclasses.replace(jargs[1], src_rect=rect),
                 jargs[2])
        targs = (targs[0], dataclasses.replace(targs[1], src_rect=rect),
                 targs[2])
    jplan, tplan = jpipe.plan_pipeline(*jargs), tpipe.plan_pipeline(*targs)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert tpipe._can_kernel_deint(tplan) == jpipe._can_kernel_deint(jplan)
    assert tpipe._can_kernel_deint(tplan) == (case in ("c5", "nv12", "yuy2"))


def test_c5_plan_and_maps_equal_jax():
    """c5 at full size: the same plan as the JAX package's, on the kernel
    route, with the interpolating Lanczos3 at 2:1."""
    kw = dict(w=3840, h=2160, ow=1920, oh=1080)
    jplan, tplan = _plans(**kw)
    assert np.array_equal(jplan.cmat_m, tplan.cmat_m)
    assert np.array_equal(jplan.cmat_c, tplan.cmat_c)
    for f in ("apply_matrix", "convert_to_sdr", "hlg_to_pq", "dither_bits"):
        assert getattr(jplan, f) == getattr(tplan, f), f
    assert tpipe.route_of(tplan) == "fused"
    assert tpipe._can_kernel_deint(tplan)
    s = jplan.settings
    cy = jscale.select_scaler(2160, 1080, s.upscaling, s.downscaling,
                              s.interpolate_at_50pct)
    assert cy[0] == "up"          # the 2:1 Lanczos3 interpolates at 50%


# --- the session --------------------------------------------------------------

def _stream(kw, n, seed):
    w, h = kw.get("w", 64), kw.get("h", 32)
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6)


def _drive(sess, stream, batched, to_port):
    n = stream[0].shape[0]
    conv = (lambda ps: tuple(t(p) for p in ps)) if to_port else (lambda ps: ps)
    outs = []
    if batched:
        for lo, hi in ((0, 4), (4, n)):
            outs += sess.push_batch(conv(tuple(p[lo:hi] for p in stream)))
        outs += sess.flush_batch()
    else:
        for i in range(n):
            outs += sess.push(conv(tuple(p[i] for p in stream)))
        outs += sess.flush()
    return [np.asarray(o.numpy() if to_port else o) for o in outs]


@pytest.mark.parametrize("double_rate", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_session_matches_jax(batched, double_rate):
    jplan, tplan = _plans()
    stream = _stream({}, 6, 10)
    ref = _drive(JSession(jplan, double_rate=double_rate, pack_surface=True),
                 stream, batched, False)
    got = _drive(TSession(tplan, double_rate=double_rate, pack_surface=True,
                          device="cpu"),
                 stream, batched, True)
    # batched: three steps of one output batch per field; streamed: one
    # output per field and frame
    assert len(got) == len(ref) == (3 if batched else 6) * (1 + double_rate)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        d = np.abs(codes(g, "rgba8") - codes(r, "rgba8"))
        assert d.max() <= 1 and (d == 0).mean() >= 0.98


def test_session_batched_equals_streamed():
    """One stream, both APIs: frame i's fields are the same outputs."""
    _, tplan = _plans()
    stream = _stream({}, 6, 11)
    one = _drive(TSession(tplan, pack_surface=True, device="cpu"), stream,
                 False, True)
    bat = _drive(TSession(tplan, pack_surface=True, device="cpu"), stream,
                 True, True)
    fields = [np.concatenate(bat[f::2]) for f in (0, 1)]
    assert fields[0].shape == (6, 16, 32)
    for i in range(6):
        for f in (0, 1):
            d = np.abs(codes(one[2 * i + f], "rgba8")
                       - codes(fields[f][i], "rgba8"))
            assert d.max() <= 1 and (d == 0).mean() >= 0.99


def test_session_post_applies_to_every_output():
    _, tplan = _plans()
    stream = _stream({}, 6, 14)
    plain = _drive(TSession(tplan, device="cpu"), stream, True, True)
    post = _drive(TSession(tplan, post=lambda o: 1.0 - o, device="cpu"),
                  stream, True, True)
    assert len(post) == len(plain) == 6
    for a, b in zip(post, plain):
        assert np.array_equal(a, 1.0 - b)


def test_session_refuses_mixed_apis():
    _, tplan = _plans()
    frame = tuple(t(p[0]) for p in _stream({}, 1, 12))
    s = TSession(tplan, device="cpu")
    s.push(frame)
    with pytest.raises(RuntimeError, match="streaming mode"):
        s.push_batch(tuple(p[None] for p in frame))
    with pytest.raises(RuntimeError, match="streaming mode"):
        s.flush_batch()
    s = TSession(tplan, device="cpu")
    s.push_batch(tuple(p[None] for p in frame))
    with pytest.raises(RuntimeError, match="batched mode"):
        s.push(frame)
    with pytest.raises(RuntimeError, match="batched mode"):
        s.flush()
    s.reset()
    assert s.push(frame) == [] and len(s.flush()) == 2


def test_session_moves_numpy_frames_to_its_device():
    """numpy frames and device="cpu": CPU tensors out, as from tensors."""
    _, tplan = _plans()
    stream = _stream({}, 3, 15)
    s = TSession(tplan, pack_surface=True, device="cpu")
    outs = s.push_batch(stream) + s.flush_batch()
    assert len(outs) == 4
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu"
               for o in outs)
    ref = _drive(TSession(tplan, pack_surface=True, device="cpu"), stream,
                 True, True)
    assert all(np.array_equal(o.numpy(), r) for o, r in zip(outs, ref))


def test_session_defaults_to_the_card(monkeypatch):
    """The default device is CUDA: without one the session raises instead
    of running on the CPU."""
    _, tplan = _plans()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSession(tplan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSession(tplan, device="cuda:0")


# --- the float64 oracle ---------------------------------------------------------

@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("field", [0, 1])
def test_deint_oracle_matches_jax_float64(field, tff):
    """As bench_oracle.py runs c5's reference: the JAX double-rate function
    at float64, the stream's first frame with prev clamped to it."""
    jplan, _ = _plans()
    b = _stream({}, 2, 13)
    f0 = tuple(p[0] for p in b)
    f1 = tuple(p[1] for p in b)
    with jax.enable_x64(True):
        out = jpipe.make_deint_fields_fn(jplan, top_field_first=tff,
                                         dtype=jnp.float64)(f0, f0, f1)
        ref = np.asarray(out[field])
    want = oracle_deint(tuple(t(p) for p in f0), tuple(t(p) for p in f0),
                        tuple(t(p) for p in f1), 32, 16, field=field,
                        top_field_first=tff).numpy()
    assert want.shape == ref.shape == (3, 16, 32)
    assert psnr(want, ref) >= 55.0
