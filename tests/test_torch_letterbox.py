"""Letterboxed and pillarboxed output (``OutputDescriptor.video_rect``) in
videorenderer_tpu_torch against the JAX package, at small sizes on the CPU:
the same frames (numpy, from a seed) through the JAX function and its port.

 * K3's plain version (``banded_resize_rows_plain``) against the JAX
   ``banded_resize_rows`` in interpret mode: float32 within 2e-5 on
   outputs in [0, 1] (the JAX kernel's split-bf16 products).
 * The placed ``make_frame_fn`` on the kernel route (K1 ×3 + K3 ×3 and the
   torch tail; their plain versions on the CPU) against the JAX kernel
   route (Pallas in interpret mode): within 1 code, and every pixel outside
   the video rect equal (black, or the packed zero); the plain route and
   the staged path against the JAX XLA paths: within 1 code.
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
    """K1 ×3 + K3 ×3 and no K2 (counted by wrapping the kernel wrappers:
    the CPU launches nothing)."""
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
    assert calls == ["banded_resize_last_axis", "banded_resize_rows"] * 3


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
