"""Letterboxed and pillarboxed output (``OutputDescriptor.video_rect``) in
videorenderer_tpu_torch against the JAX package, at small sizes on the CPU:
the same frames (numpy, from a seed) through the JAX function and its port.

 * K3's plain version (``banded_resize_rows_plain``) against the JAX
   ``banded_resize_rows`` in interpret mode: float32 within 2e-5 on
   outputs in [0, 1] (the JAX kernel's split-bf16 products).
 * The placed ``make_frame_fn`` on the kernel route (K1 ×3 + K2 with the
   rect's origin as an offset into its store; their plain versions on the
   CPU) against the JAX kernel route (Pallas in interpret mode, K1, K3 and
   the XLA tail): within 1 code (the port quantizes K1's output to mid16,
   as the unplaced route does), and every pixel outside the video rect
   equal (black, or the packed zero); the plain route and the staged path
   against the JAX XLA paths: within 1 code.
 * The placed output inside its rect bit-equal to the unplaced plan of the
   rect's size (the same maps, the dither from the video's origin), the
   bars the packed zero, for an aligned and an unaligned column offset;
   K2's and K9's plain versions with ``place``.
 * ``make_serving_fn`` with a runtime colour matrix on the K2 route and on
   the placed route against the JAX serving function.
 * ``oracle`` with placement against the JAX float64 staged path: >= 55 dB.

The JAX kernel paths run as the JAX tests run them on the CPU:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import scale as jscale

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.oracle import oracle


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def codes(x, bits):
    """Channel codes of a packed surface (int32) or a quantized float one."""
    x = np.asarray(x)
    if x.dtype == np.int32:
        d = x.view(np.uint32)
        mask = (1 << bits) - 1
        return np.stack([(d >> (bits * i)) & mask for i in range(3)],
                        -3).astype(np.int64)
    return np.round(x.astype(np.float64) * (2 ** bits - 1)).astype(np.int64)


# --- K3 ------------------------------------------------------------------------

# (dtype, batch x h_in x w, h_out): raw planes with the normalisation in the
# taps, K1's float32 output, mid16-range int16, and a chroma height (20) that
# is not a multiple of 16, upscaled
K3_CASES = {
    "u16_down": (np.uint16, (2, 40, 64), 24),
    "u8_up": (np.uint8, (2, 20, 32), 24),
    "f32_down": (np.float32, (3, 40, 48), 17),
    "i16_down": (np.int16, (2, 32, 40), 16),
}
K3_NORM = {np.uint16: 1 / 65535.0, np.uint8: 1 / 255.0,
           np.int16: 1 / 16384.0, np.float32: None}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_plain_matches_jax_kernel(case):
    dt, shape, h_out = K3_CASES[case]
    rng = np.random.default_rng(1)
    x = (rng.random(shape, dtype=np.float32) if dt == np.float32 else
         rng.integers(0, 16384 if dt == np.int16 else np.iinfo(dt).max,
                      shape).astype(dt))
    mat = np.asarray(jscale.upscale_matrix(jcfg.Upscaling.LANCZOS3, shape[1],
                                           h_out), np.float32)
    norm = K3_NORM[dt]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.banded_resize_rows(jnp.asarray(x), mat,
                                                pre_scale=norm))
    got = trk.banded_resize_rows(t(x), trk.BandedMatrix(mat, pre_scale=norm))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_k3_plain_is_the_dense_product():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 65535, (2, 3, 30, 20)).astype(np.uint16)
    mat = np.asarray(jscale.upscale_matrix(jcfg.Upscaling.CATMULL_ROM, 30, 17))
    got = trk.banded_resize_rows(t(x), trk.BandedMatrix(mat, pre_scale=0.5))
    want = np.einsum("...hw,hk->...kw", x.astype(np.float64), mat * 0.5)
    assert got.shape == (2, 3, 17, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_k3_wrapper_refuses_bad_input():
    mat = trk.BandedMatrix(np.eye(8, 4, dtype=np.float32))
    with pytest.raises(ValueError, match="rows"):
        trk.banded_resize_rows(torch.zeros((2, 6, 5)), mat)
    with pytest.raises(TypeError, match="dtype"):
        trk.banded_resize_rows(torch.zeros((2, 8, 5), dtype=torch.float64),
                               mat)
    with pytest.raises(ValueError, match="no kernel"):
        trk.banded_resize_rows(torch.zeros((2, 8, 5), device="meta"), mat)


# --- the placed path -------------------------------------------------------------

# (source format, width, height, surface width, height, video rect,
# transfer, bits): a 2.39:1 film letterboxed in 16:9 (the PQ -> SDR
# headline chain, 10-bit), and a 4:3 NV12 source pillarboxed in 16:9
CASES = {
    "scope_p010": ("P010", 96, 40, 48, 28, (0, 4, 48, 24), "PQ", 10),
    "pillar_nv12": ("NV12", 64, 48, 64, 36, (8, 0, 56, 36), "BT_1886", 8),
}


def _plan_args(cfg, csp, pipe, fmt, case, **settings):
    f, w, h, ow, oh, rect, transfer, bits = CASES[case]
    nv12 = f == "NV12"
    settings.setdefault("upscaling", "LANCZOS3")
    settings["upscaling"] = cfg.Upscaling[settings["upscaling"]]
    settings.setdefault("convert_to_sdr", True)
    return (cfg.Settings(**settings),
            pipe.SourceDescriptor(
                format=getattr(fmt, f), width=w, height=h,
                matrix=csp.CSP.BT_709 if nv12 else csp.CSP.BT_2020_NC,
                levels=csp.Levels.TV,
                primaries=csp.Primaries.BT_709 if nv12
                else csp.Primaries.BT_2020,
                transfer=getattr(csp.TRC, transfer),
                hdr10=pipe.HDR10Metadata()),
            pipe.OutputDescriptor(width=ow, height=oh, bits=bits,
                                  video_rect=rect))


def _plans(case, **settings):
    return (jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt, case,
                                            **settings)),
            tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, case,
                                            **settings)))


def _frame(case, seed, n=2):
    f, w, h = CASES[case][:3]
    rng = np.random.default_rng(seed)
    if f == "P010":
        return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6)
    return (rng.integers(16, 236, (n, h, w), dtype=np.uint8),
            rng.integers(16, 241, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(16, 241, (n, h // 2, w // 2), dtype=np.uint8))


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def _outside(x, rect):
    """The pixels outside the video rect (the bars), over every channel."""
    l, tp, r, b = rect
    mask = np.ones(x.shape[-2:], bool)
    mask[tp:b, l:r] = False
    return x[..., mask]


def assert_placed_close(got, ref, case, max_diff=1, frac=0.02):
    """Within ``max_diff`` codes on at most ``frac`` of the channels, and
    the bars equal and black."""
    bits, rect = CASES[case][7], CASES[case][5]
    assert got.shape == ref.shape
    d = np.abs(codes(got, bits) - codes(ref, bits))
    assert d.max() <= max_diff and (d > 0).mean() <= frac, (d.max(),
                                                            (d > 0).mean())
    assert np.array_equal(_outside(got, rect), _outside(ref, rect))
    zero = codes(_outside(got, rect), bits)
    assert not zero.any()
    if got.dtype == np.int32:       # the bars are the packed zero: alpha only
        alpha = 30 if bits == 10 else 24
        bars = _outside(got, rect).view(np.uint32)
        assert np.all(bars == (np.uint32(3 if bits == 10 else 255) << alpha))


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_kernel_route_matches_jax_kernel(case, pack, monkeypatch):
    jplan, tplan = _plans(case)
    planes = _frame(case, 3)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=pack)(tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=pack)(
        tuple(t(p) for p in planes)).numpy()
    assert_placed_close(got, ref, case)


def test_placed_kernel_route_calls(monkeypatch):
    """K1 ×3 + K2 ×1 with the offset, as the unplaced plan, and no K3
    (counted by wrapping the kernel wrappers: the CPU launches nothing)."""
    _, tplan = _plans("scope_p010")
    calls = []
    for mod, name in ((trk, "banded_resize_last_axis"),
                      (trk, "banded_resize_rows"), (trk, "rows3_tail"),
                      (tdk, "rows3_mid"), (tdk, "cols3_tail")):
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, wrap)
    out = tpipe.make_frame_fn(tplan, pack_surface=True)(
        tuple(t(p) for p in _frame("scope_p010", 4)))
    assert out.shape == (2, 28, 48) and out.dtype == torch.int32
    assert calls == ["banded_resize_last_axis"] * 3 + ["rows3_tail"]


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_plain_paths_match_jax_xla(case, staged):
    """The plain route (use_accel_backend=False) and the staged path
    (fused=False) against the JAX XLA paths."""
    kw = {} if staged else dict(use_accel_backend=False)
    jplan, tplan = _plans(case, **kw)
    planes = _frame(case, 5)
    fused = False if staged else None
    ref = np.asarray(jpipe.make_frame_fn(jplan, fused=fused,
                                         pack_surface=True)(
        tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, fused=fused, pack_surface=True)(
        tuple(t(p) for p in planes)).numpy()
    assert_placed_close(got, ref, case, frac=0.01)


def test_placed_rotation_matches_jax(monkeypatch):
    """Rotation turns the whole placed surface, bars included."""
    jplan, tplan = _plans("scope_p010")
    planes = _frame("scope_p010", 6)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True, rotation=90)(
            tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=True, rotation=90)(
        tuple(t(p) for p in planes)).numpy()
    assert got.shape == ref.shape == (2, 48, 28)
    d = np.abs(codes(got, 10) - codes(ref, 10))
    assert d.max() <= 1 and (d > 0).mean() <= 0.02


@pytest.mark.parametrize("placed", [False, True])
def test_serving_runtime_matrix_matches_jax(placed, monkeypatch):
    """A runtime colour matrix through make_serving_fn: on the K2 route
    (K2 takes it per launch) and on the placed route, against the JAX
    serving function; a second matrix changes the output."""
    jplan, tplan = _plans("pillar_nv12")
    if not placed:
        import dataclasses
        jplan = jpipe.plan_pipeline(
            jplan.settings, jplan.src,
            dataclasses.replace(jplan.dst, video_rect=None, width=48))
        tplan = tpipe.plan_pipeline(
            tplan.settings, tplan.src,
            dataclasses.replace(tplan.dst, video_rect=None, width=48))
    planes = _frame("pillar_nv12", 7)
    cm = {"m": jplan.cmat_m * 0.8, "c": jplan.cmat_c + 0.02}
    ref = in_interpret(monkeypatch, lambda: jpipe.make_serving_fn(
        jplan, pack_surface=True)(tuple(jnp.asarray(p) for p in planes),
                                  {"cmat": {k: jnp.asarray(v)
                                            for k, v in cm.items()}}))
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    assert fn.allowed_rt_keys == {"cmat"}
    got = fn(tuple(t(p) for p in planes), {"cmat": cm}).numpy()
    d = np.abs(codes(got, 8) - codes(ref, 8))
    assert got.shape == ref.shape and d.max() <= 1 and (d > 0).mean() <= 0.02
    assert not np.array_equal(got, fn(tuple(t(p) for p in planes)).numpy())


def test_placed_oracle_matches_jax_float64():
    """The float64 oracle with placement against the JAX staged path at
    float64 (the headline chain, letterboxed)."""
    jplan, _ = _plans("scope_p010")
    planes = tuple(p[0] for p in _frame("scope_p010", 8, n=1))
    with jax.enable_x64(True):
        ref = np.asarray(jpipe.make_frame_fn(jplan, dtype=jnp.float64,
                                             fused=False)(planes))
    want = oracle(*(t(p) for p in planes), 48, 28,
                  video_rect=(0, 4, 48, 24)).numpy()
    assert want.shape == ref.shape == (3, 28, 48)
    assert not _outside(want, (0, 4, 48, 24)).any()
    assert psnr(want[:, 4:24], ref[:, 4:24]) >= 55.0


# --- the offset store: the rect bit-equal to the unplaced plan -------------------

# (source size, surface size, rect): the letterbox's aligned rect, a
# pillarbox, and a rect whose column offset is not a multiple of 4
RECTS = {
    "letterbox": (96, 40, 48, 28, (0, 4, 48, 24)),
    "pillarbox": (64, 48, 64, 36, (8, 0, 56, 36)),
    "unaligned": (96, 40, 48, 28, (2, 1, 47, 27)),
}


def _rect_plans(case, pack_bits=10, **settings):
    w, h, ow, oh, rect = RECTS[case]
    st = tcfg.Settings(upscaling=tcfg.Upscaling.LANCZOS3,
                       convert_to_sdr=True, **settings)
    src = tpipe.SourceDescriptor(
        format=TFmt.P010, width=w, height=h, matrix=tcsp.CSP.BT_2020_NC,
        levels=tcsp.Levels.TV, primaries=tcsp.Primaries.BT_2020,
        transfer=tcsp.TRC.PQ, hdr10=tpipe.HDR10Metadata())
    l, tp, r, b = rect
    placed = tpipe.OutputDescriptor(width=ow, height=oh, bits=pack_bits,
                                    video_rect=rect)
    bare = tpipe.OutputDescriptor(width=r - l, height=b - tp, bits=pack_bits)
    return tpipe.plan_pipeline(st, src, placed), tpipe.plan_pipeline(
        st, src, bare)


def _p010(w, h, seed, n=2):
    rng = np.random.default_rng(seed)
    return tuple(t(p) for p in (
        rng.integers(64, 941, (n, h, w), np.uint16) << 6,
        rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
        rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6))


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("case", list(RECTS))
def test_placed_rect_bit_equal_to_unplaced_plan(case, pack):
    """Inside the rect the placed surface is the unplaced plan's surface of
    the rect's size bit for bit (the same maps, the dither from the
    video's origin, mid16 on both); every pixel outside is the packed zero
    (or float zeros)."""
    placed, bare = _rect_plans(case)
    w, h, ow, oh, (l, tp, r, b) = RECTS[case]
    planes = _p010(w, h, 11)
    got = tpipe.make_frame_fn(placed, pack_surface=pack)(planes)
    want = tpipe.make_frame_fn(bare, pack_surface=pack)(planes)
    assert torch.equal(got[..., tp:b, l:r], want)
    bars = _outside(got.numpy(), (l, tp, r, b))
    if pack:
        assert got.shape == (2, oh, ow)
        assert np.all(bars == trk.PACKED_ZERO["rgb10a2"])
    else:
        assert got.shape == (2, 3, oh, ow) and not bars.any()


@pytest.mark.parametrize("pack", ["rgb10a2", "rgba8", None])
def test_k2_plain_place_matches_placed_unplaced_output(pack):
    """rows3_tail_plain with ``place`` is its unplaced output put into the
    surface, the bars the packed zero of the format (zeros for float), at
    an unaligned offset; a rect past the surface raises."""
    rng = np.random.default_rng(12)
    y, u, v = (t(rng.random((2, 9, 7), dtype=np.float32)) for _ in range(3))
    epi = tpipe.cmat_epilogue(np.eye(3, 4, dtype=np.float32))
    epi = trk.Epilogue(cmat=epi.cmat, correction=trk.CORR_NONE,
                       luminance_scale=1.0, dither_bits=8 if pack else 0,
                       gamut=np.eye(3, dtype=np.float32),
                       plain=lambda a, b_, c: torch.stack([a, b_, c], -3))
    bare = trk.rows3_tail(y, u, v, None, None, 9, epi, pack_format=pack)
    got = trk.rows3_tail(y, u, v, None, None, 9, epi, pack_format=pack,
                         place=(12, 13, 2, 5))
    assert torch.equal(got[..., 2:11, 5:12], bare)
    bars = _outside(got.numpy(), (5, 2, 12, 11))
    assert np.all(bars == (0 if pack is None else trk.PACKED_ZERO[pack]))
    k9 = tdk.cols3_tail(y, u, v, None, None, 7, epi, pack_format=pack,
                        place=(12, 13, 2, 5))
    assert torch.equal(k9, got)
    with pytest.raises(ValueError, match="does not fit"):
        trk.rows3_tail(y, u, v, None, None, 9, epi, pack_format=pack,
                       place=(10, 13, 2, 5))
