"""The Jinc2 upscale path of videorenderer_tpu_torch (c3, c3rot) against the
JAX package, at small sizes on the CPU: the same inputs (numpy, from a seed)
through the JAX function and its port.

 * Host planning (``jinc2_passes``, ``_jinc2_tap_data``, ``_phase_period``,
   ``_jinc2_g``): exactly equal.
 * ``rotate_flip``, ``rf_decompose``, ``upsample_chroma``: equal to 1e-6.
 * The port's plain Jinc2 (the direct 4x4-tap gather of K5 and K6) against
   the JAX gather ``_jinc2_gather``: 1e-5.  Against the JAX kernel K5 in
   interpret mode, which runs the low-rank SVD expansion with its 1e-4
   singular-value cutoff: 5e-5 at 2x (exact rank), elsewhere the cutoff's
   band, 1e-3 and >= 65 dB.
 * K6's plain version against the JAX K6 in interpret mode, and the port's
   ``make_frame_fn`` against the JAX kernel and XLA paths: at most 1 code,
   on < 1% of the channels (dither flips where the two float32 chains
   round a value across a quantization step).
 * Rotation: (90, True) bit-equal to the transposed unrotated surface; the
   other rotations within 1 code on < 2% of rotating the surface.
 * An HDR10 -> SDR Jinc2 plan (``resize_plane`` and the torch tail) against
   the JAX XLA path: the band of tests/test_torch_slice.py (>= 99.9% of the
   channels within 1 code, none beyond 4).
 * The float64 Jinc2 oracle against the JAX staged path at float64: >= 70 dB.

The JAX kernel paths run as the JAX tests run them on the CPU:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``.  The port's kernel route (K1, K2, K5,
K6) is taken only for planes on a CUDA device; on the CPU the tests patch
``pipeline._on_card`` to take it with the plain versions.
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
from videorenderer_tpu.kernels import jinc2_pallas as jjp
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import chroma as jchroma
from videorenderer_tpu.ops import dither as jdither
from videorenderer_tpu.ops import geometry as jgeo
from videorenderer_tpu.ops import scale as jscale

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import jinc2 as tjk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import geometry as tgeo
from videorenderer_tpu_torch.ops import scale as tscale
from videorenderer_tpu_torch.oracle import oracle_jinc2

GEOMETRIES = [(1080, 2160), (1080, 3840), (1920, 2160), (1920, 3840),
              (48, 96), (30, 61), (40, 90), (27, 96), (48, 54), (64, 64),
              (100, 60), (100, 40)]


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def codes8(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0xFF for s in (0, 8, 16)], -3).astype(np.int32)


def codes10(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)], -3).astype(np.int32)


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


# --- host planning -----------------------------------------------------------

def test_jinc2_constants_equal():
    for name in ("_JINC2_WINDOW_SINC", "_JINC2_SINC", "_JINC2_AR_STRENGTH"):
        assert getattr(tscale, name) == getattr(jscale, name)


@pytest.mark.parametrize("sizes", GEOMETRIES)
def test_jinc2_host_planning_equal(sizes):
    i, o = sizes
    jb, jf = jscale._jinc2_tap_data(i, o)
    tb, tf = tscale._jinc2_tap_data(i, o)
    assert np.array_equal(jb, tb) and np.array_equal(jf, tf)
    assert tscale._phase_period(i, o) == jscale._phase_period(i, o)
    for k50 in (True, False):
        assert (tscale.jinc2_passes(i, 2 * i, o, o + 1, k50)
                == jscale.jinc2_passes(i, 2 * i, o, o + 1, k50))
        assert (tscale.jinc2_passes(o, i, i, o, k50)
                == jscale.jinc2_passes(o, i, i, o, k50))
    d2 = (jf[:, None] - np.arange(-1, 3)[None, :]) ** 2
    grid = d2[:, :, None] + d2[:, None, :]
    assert np.array_equal(tscale._jinc2_g(grid), jscale._jinc2_g(grid))
    base, tab = tscale.jinc2_axis_tables(i, o)
    assert np.array_equal(base, jb) and tab.shape == (4, o)
    assert np.array_equal(tab, d2.T.astype(np.float32))


@pytest.mark.parametrize("sizes", GEOMETRIES)
def test_jinc2_route_follows_jax_passes(sizes):
    """One 2D pass exactly where the JAX staged path takes one (W up, H up
    or unchanged); no Jinc2 at all where JAX's _separable_geometry holds."""
    i, o = sizes
    for k50 in (True, False):
        for h, w, oh, ow in ((i, i, o, o), (i, 2 * i, o, o + 1), (o, i, i, o),
                             (i, o, i, o), (o, i, o, i)):
            rx, ry = jscale.jinc2_passes(h, w, oh, ow, k50)
            route = tscale.jinc2_route(h, w, oh, ow, k50)
            assert (route is None) == ("up" not in (rx, ry))
            assert (route == "one_pass") == (rx == "up" and ry in ("up", None))


# --- geometry and chroma -----------------------------------------------------

ALL_RF = [(r, f) for r in (0, 90, 180, 270) for f in (False, True)]


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_rotate_flip_equal(rotation, flip):
    x = np.random.default_rng(rotation + flip).random((2, 5, 7), np.float32)
    ref = np.asarray(jgeo.rotate_flip(jnp.asarray(x), rotation, flip))
    got = tgeo.rotate_flip(torch.from_numpy(x), rotation, flip).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert tgeo.rf_decompose(rotation, flip) == jgeo.rf_decompose(rotation, flip)
    assert tgeo.rotated_size(7, 5, rotation) == jgeo.rotated_size(7, 5, rotation)


def test_rotate_flip_refuses_other_angles():
    with pytest.raises(ValueError):
        tgeo.rotate_flip(torch.zeros((2, 2)), 45)


@pytest.mark.parametrize("sub", [420, 422])
@pytest.mark.parametrize("method", ["NEAREST", "BILINEAR", "CATMULL_ROM"])
@pytest.mark.parametrize("loc", ["MPEG1", "MPEG2", "COSITED"])
def test_upsample_chroma_equal(sub, method, loc):
    c = np.random.default_rng(3).random((2, 2, 9, 12), np.float32)
    ref = np.asarray(jchroma.upsample_chroma(
        jnp.asarray(c), sub, jcfg.ChromaScaling[method],
        jcsp.ChromaLocation[loc]))
    got = tchroma.upsample_chroma(
        torch.from_numpy(c), sub, tcfg.ChromaScaling[method],
        tcsp.ChromaLocation[loc]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_blend_deinterlace_luma_equal():
    y = np.random.default_rng(4).random((2, 9, 12), np.float32)
    ref = np.asarray(jchroma.blend_deinterlace_luma(jnp.asarray(y)))
    got = tchroma.blend_deinterlace_luma(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


# --- the Jinc2 resample (K5) -------------------------------------------------

K5_GEOMETRIES = [(24, 32, 48, 64), (30, 40, 61, 90), (27, 48, 96, 54)]


@pytest.mark.parametrize("g", K5_GEOMETRIES)
def test_plain_jinc2_matches_jax_gather(g):
    h, w, oh, ow = g
    x = np.random.default_rng(13).random((2, h, w)).astype(np.float32)
    ref = np.asarray(jscale._jinc2_gather(jnp.asarray(x), oh, ow))
    got = tjk.jinc2_resize_fused(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == (2, oh, ow) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("g", K5_GEOMETRIES)
def test_plain_jinc2_matches_jax_k5_interpret(g):
    h, w, oh, ow = g
    x = np.random.default_rng(14).random((2, h, w)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jjp.jinc2_resize_fused(jnp.asarray(x), oh, ow))
    got = tscale.jinc2_resize(torch.from_numpy(x), oh, ow).numpy()
    if (oh, ow) == (2 * h, 2 * w):
        np.testing.assert_allclose(got, ref, atol=5e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-3)
        assert psnr(got, ref) >= 65.0


@pytest.mark.parametrize("bits", [8, -8, 10])
def test_k5_epilogue_matches_jax(bits, monkeypatch):
    """The dithered (or rounded) Jinc2 against the JAX kernel with the
    pipeline's epilogue, at 2x (exact rank): within 1 code on < 1%."""
    x = np.random.default_rng(15).random((3, 24, 40)).astype(np.float32)

    def epi(tile):
        t = jnp.clip(tile, 0.0, 1.0)
        return (jdither.quantize(t, -bits) if bits < 0
                else jdither.ordered_dither_iota(t, bits))

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jjp.jinc2_resize_fused(jnp.asarray(x), 48, 80,
                                                epilogue=epi))
    got = tjk.jinc2_resize_fused(torch.from_numpy(x), 48, 80,
                                 tjk.dither_epilogue(bits)).numpy()
    d = np.abs(np.round((got - ref) * (2 ** abs(bits) - 1)))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


# --- K6 ----------------------------------------------------------------------

def _yuv(seed, w, h, sub, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    hc = h // 2 if sub == 420 else h
    cw = w if sub == 444 else w // 2
    return tuple(rng.integers(hi // 16, hi - hi // 16, s).astype(dtype)
                 for s in ((2, h, w), (2, hc, cw), (2, hc, cw)))


@pytest.mark.parametrize("sub,out", [(420, (96, 128)), (422, (64, 128))])
@pytest.mark.parametrize("pack", ["rgba8", None])
def test_k6_plain_matches_jax_k6_interpret(sub, out, pack):
    w, h = 64, 48 if sub == 420 else 32
    oh, ow = out
    planes = _yuv(11, w, h, sub)
    ux, uy = jchroma.chroma_upsample_matrices(
        w // 2, h // 2 if sub == 420 else h, sub, jcfg.ChromaScaling.BILINEAR,
        jcsp.ChromaLocation.MPEG2)
    plan = jpipe.plan_pipeline(
        jcfg.Settings(upscaling=jcfg.Upscaling.JINC2),
        jpipe.SourceDescriptor(format=JFmt.NV12, width=w, height=h,
                               matrix=jcsp.CSP.BT_709),
        jpipe.OutputDescriptor(width=ow, height=oh, bits=8))

    def epi(tile):
        return jdither.ordered_dither_iota(jnp.clip(tile, 0.0, 1.0), 8)

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jjp.jinc2_convert_fused(
            *(jnp.asarray(p) for p in planes),
            None if uy is None else np.asarray(uy, np.float32),
            np.asarray(ux, np.float32), plan.cmat_m, plan.cmat_c, oh, ow,
            1 / 255.0, 1 / 255.0, epilogue=epi, pack_format=pack))
    cmat = np.concatenate([np.asarray(plan.cmat_m, np.float32),
                           np.asarray(plan.cmat_c, np.float32)[:, None]], 1)
    got = tjk.jinc2_convert_fused(
        *(torch.from_numpy(p) for p in planes),
        None if uy is None else trk.BandedMatrix(uy), trk.BandedMatrix(ux),
        cmat, oh, ow, 1 / 255.0, 1 / 255.0, epilogue=tjk.dither_epilogue(8),
        pack_format=pack).numpy()
    assert got.shape == ref.shape
    if pack is None:
        d = np.abs(np.round((got - ref) * 255.0))
    else:
        d = np.abs(codes8(got) - codes8(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_k6_out_transpose_is_the_transpose():
    planes = tuple(torch.from_numpy(p) for p in _yuv(12, 64, 48, 420))
    ux, uy = tchroma.chroma_upsample_matrices(
        32, 24, 420, tcfg.ChromaScaling.BILINEAR, tcsp.ChromaLocation.MPEG2)
    args = (*planes, trk.BandedMatrix(uy), trk.BandedMatrix(ux),
            np.eye(3, 4, dtype=np.float32), 96, 128, 1 / 255.0, 1 / 255.0)
    for pack in (None, "rgba8"):
        flat = tjk.jinc2_convert_fused(*args, pack_format=pack)
        tr = tjk.jinc2_convert_fused(*args, pack_format=pack,
                                     out_transpose=True)
        assert torch.equal(tr, flat.transpose(-2, -1))


def test_kernel_wrappers_refuse_bad_input():
    x = torch.zeros((1, 8, 8))
    with pytest.raises(TypeError):
        tjk.jinc2_resize_fused(x.double(), 16, 16)
    with pytest.raises(NotImplementedError):
        tjk.jinc2_resize_fused(x, 16, 16, tjk.Jinc2Epilogue(6, lambda t: t))
    y = torch.zeros((1, 8, 8), dtype=torch.uint8)
    c = torch.zeros((1, 4, 4), dtype=torch.uint8)
    ux = trk.BandedMatrix(np.ones((4, 8)))
    cm = np.eye(3, 4, dtype=np.float32)
    with pytest.raises(ValueError, match="comp_y"):        # no H upsample
        tjk.jinc2_convert_fused(y, c, c, None, ux, cm, 16, 16, 1.0, 1.0)
    with pytest.raises(TypeError):
        tjk.jinc2_convert_fused(y, c.to(torch.int16), c, None, ux, cm, 16,
                                16, 1.0, 1.0)
    with pytest.raises(NotImplementedError):
        tjk.jinc2_convert_fused(y, c, c, ux, ux, cm, 16, 16, 1.0, 1.0,
                                pack_format="rgb565")


# --- the path through make_frame_fn ------------------------------------------

C3_W, C3_H, C3_OW, C3_OH = 64, 48, 128, 96


def _plan_args(cfg, csp, pipe, fmt, *, upscaling="JINC2", accel=True,
               w=C3_W, h=C3_H, ow=C3_OW, oh=C3_OH, fmt_name="NV12",
               hdr=False, bits=8, **settings):
    if hdr:
        src = pipe.SourceDescriptor(
            format=getattr(fmt, "P010"), width=w, height=h,
            matrix=csp.CSP.BT_2020_NC, levels=csp.Levels.TV,
            primaries=csp.Primaries.BT_2020, transfer=csp.TRC.PQ,
            hdr10=pipe.HDR10Metadata())
    else:
        src = pipe.SourceDescriptor(format=getattr(fmt, fmt_name), width=w,
                                    height=h, matrix=csp.CSP.BT_709)
    return (cfg.Settings(upscaling=cfg.Upscaling[upscaling], use_dither=True,
                         use_accel_backend=accel, convert_to_sdr=hdr,
                         **settings),
            src, pipe.OutputDescriptor(width=ow, height=oh, bits=bits))


def run_jax(planes, monkeypatch, kernel, rotation=0, flip=False, pack=True,
            **kw):
    plan = jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt,
                                           accel=kernel, **kw))
    fn = jpipe.make_frame_fn(plan, fused=False, pack_surface=pack,
                             rotation=rotation, flip=flip)
    if kernel:
        return in_interpret(monkeypatch, lambda: fn(planes))
    return np.asarray(fn(tuple(jnp.asarray(p) for p in planes)))


def run_port(planes, kernel, monkeypatch, rotation=0, flip=False, pack=True,
             **kw):
    """The port's make_frame_fn; ``kernel`` takes the kernel route (the
    plain versions of K1, K2, K5, K6 on these CPU tensors)."""
    plan = tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, **kw))
    with monkeypatch.context() as mp:
        mp.setattr(tpipe, "_on_card", lambda planes: kernel)
        fn = tpipe.make_frame_fn(plan, pack_surface=pack, rotation=rotation,
                                 flip=flip)
        return fn(tuple(torch.from_numpy(p) for p in planes)).numpy()


def test_jinc2_plans_take_the_staged_path():
    for up, fused in (("JINC2", False), ("LANCZOS3", True)):
        plan = tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt,
                                               upscaling=up))
        assert (tpipe.route_of(plan) == "fused") is fused


@pytest.mark.parametrize("port_kernel,jax_kernel", [
    (True, True), (False, False), (True, False)])
def test_c3_like_plan_matches_jax(port_kernel, jax_kernel, monkeypatch):
    """The port's kernel route (K6) against the JAX kernel path (K6) and
    the JAX XLA path; the port's staged plain route against the JAX XLA
    path."""
    planes = _yuv(21, C3_W, C3_H, 420)
    got = codes8(run_port(planes, port_kernel, monkeypatch))
    ref = codes8(run_jax(planes, monkeypatch, jax_kernel))
    assert got.shape == ref.shape == (2, 3, C3_OH, C3_OW)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("fmt_name,sub", [("YUY2", 422), ("YV24", 444)])
def test_other_subsamplings_match_jax(fmt_name, sub, kernel, monkeypatch):
    """4:2:2 (W-only chroma upsample) and 4:4:4 (none: K2 and K6 scale the
    chroma themselves) on both routes."""
    w, h = 64, 32
    planes = _yuv(23, w, h, sub)
    kw = dict(fmt_name=fmt_name, w=w, h=h, ow=128, oh=64)
    got = codes8(run_port(planes, kernel, monkeypatch, **kw))
    ref = codes8(run_jax(planes, monkeypatch, kernel, **kw))
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_c3rot_like_geometry_matches_jax(monkeypatch):
    """The rotation plan's geometry (a 9/8 W and a 32/9 H upscale) on
    the kernel routes, rotation 90 + flip: the JAX kernel carries its
    singular-value cutoff here, so the band is the dither's."""
    planes = _yuv(24, 64, 36, 420)
    kw = dict(w=64, h=36, ow=72, oh=128)
    got = codes8(run_port(planes, True, monkeypatch, rotation=90, flip=True,
                          **kw))
    ref = codes8(run_jax(planes, monkeypatch, True, rotation=90, flip=True,
                         **kw))
    assert got.shape == ref.shape == (2, 3, 72, 128)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_rotation_90_flip_is_the_transpose(monkeypatch):
    planes = _yuv(25, C3_W, C3_H, 420)
    base = run_port(planes, True, monkeypatch)
    got = run_port(planes, True, monkeypatch, rotation=90, flip=True)
    assert np.array_equal(got, np.swapaxes(base, -2, -1))


@pytest.mark.parametrize("rotation,flip", [(90, False), (270, False),
                                           (180, True)])
def test_other_rotations_rotate_the_surface(rotation, flip, monkeypatch):
    """Those take K1 + K2 + K5 and rotate the finished surface."""
    planes = _yuv(26, C3_W, C3_H, 420)
    base = torch.from_numpy(run_port(planes, True, monkeypatch))
    got = run_port(planes, True, monkeypatch, rotation=rotation, flip=flip)
    ref = tgeo.rotate_flip(base, rotation, flip).numpy()
    d = np.abs(codes8(got) - codes8(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_rotation_on_the_fused_path_matches_jax(monkeypatch):
    planes = _yuv(27, C3_W, C3_H, 420)
    kw = dict(upscaling="LANCZOS3")
    plan = tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, **kw))
    got = tpipe.make_frame_fn(plan, pack_surface=True, rotation=270)(
        tuple(torch.from_numpy(p) for p in planes)).numpy()
    jplan = jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt,
                                            accel=False, **kw))
    ref = np.asarray(jpipe.make_frame_fn(jplan, pack_surface=True,
                                         rotation=270)(planes))
    d = np.abs(codes8(got) - codes8(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("kernel", [True, False])
def test_hdr10_to_sdr_jinc2_plan_matches_jax_xla(kernel, monkeypatch):
    """PQ P010 -> SDR 10-bit with Jinc2: no dither-only tail, so the Jinc2
    runs without epilogue (``resize_plane`` -> K5) and the torch tail
    follows."""
    rng = np.random.default_rng(28)
    planes = (rng.integers(64, 941, (2, C3_H, C3_W), dtype=np.uint16) << 6,
              rng.integers(64, 961, (2, C3_H // 2, C3_W // 2),
                           dtype=np.uint16) << 6,
              rng.integers(64, 961, (2, C3_H // 2, C3_W // 2),
                           dtype=np.uint16) << 6)
    kw = dict(hdr=True, bits=10)
    got = codes10(run_port(planes, kernel, monkeypatch, **kw))
    ref = codes10(run_jax(planes, monkeypatch, False, **kw))
    d = np.abs(got - ref)
    assert (d <= 1).mean() >= 0.999 and d.max() <= 4


def test_mixed_up_down_resize_plane_matches_jax():
    """A Jinc2 plan whose H axis downscales past the 50% rule: the W pass
    is the 2D shader at scale 1 in H, the H pass a separable convolution."""
    x = np.random.default_rng(29).random((2, 3, 60, 40)).astype(np.float32)
    for oh, ow in ((20, 64), (64, 16)):
        ref = np.asarray(jscale.resize_plane(jnp.asarray(x), oh, ow,
                                             upscaling=jcfg.Upscaling.JINC2))
        got = tscale.resize_plane(torch.from_numpy(x), oh, ow,
                                  upscaling=tcfg.Upscaling.JINC2).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_convert_color_matches_jax():
    planes = _yuv(30, C3_W, C3_H, 420)
    args_j = _plan_args(jcfg, jcsp, jpipe, JFmt)
    args_t = _plan_args(tcfg, tcsp, tpipe, TFmt)
    ref = np.asarray(jpipe._convert_color(jpipe.plan_pipeline(*args_j),
                                          tuple(jnp.asarray(p) for p in planes)))
    got = tpipe._convert_color(tpipe.plan_pipeline(*args_t),
                               tuple(torch.from_numpy(p) for p in planes))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_staged_path_forced_on_a_separable_plan(monkeypatch):
    """fused=False on a Lanczos plan: the staged convert and resize_plane
    against the JAX XLA path."""
    planes = _yuv(31, C3_W, C3_H, 420)
    kw = dict(upscaling="LANCZOS3")
    plan = tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, **kw))
    got = tpipe.make_frame_fn(plan, pack_surface=True, fused=False)(
        tuple(torch.from_numpy(p) for p in planes)).numpy()
    ref = run_jax(planes, monkeypatch, False, **kw)
    d = np.abs(codes8(got) - codes8(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_launch_counts_untouched_on_cpu():
    trk.reset_launches()
    vp = tpipe.VideoProcessor(*_plan_args(tcfg, tcsp, tpipe, TFmt),
                              device="cpu", pack_surface=True)
    vp.process(_yuv(32, C3_W, C3_H, 420))
    assert set(trk.launches.values()) == {0}


# --- the float64 oracle ------------------------------------------------------

def test_jinc2_oracle_matches_jax_staged_float64():
    planes = _yuv(33, C3_W, C3_H, 420)
    with jax.enable_x64(True):
        plan = jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt,
                                               accel=False))
        ref = np.asarray(jpipe.make_frame_fn(plan, dtype=jnp.float64,
                                             fused=False)(planes))
    for i in range(2):
        want = oracle_jinc2(*(torch.from_numpy(p[i]) for p in planes),
                            C3_OW, C3_OH).numpy()
        assert psnr(want, ref[i]) >= 70.0


def test_jinc2_oracle_rotates_the_frame():
    planes = [torch.from_numpy(p[0]) for p in _yuv(34, C3_W, C3_H, 420)]
    base = oracle_jinc2(*planes, C3_OW, C3_OH)
    rot = oracle_jinc2(*planes, C3_OW, C3_OH, rotation=90, flip=True)
    assert torch.equal(rot, base.transpose(-2, -1))


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_jinc2_oracle_rotation_matches_jax(rotation, flip):
    """The oracle rotates on its own (not through ops.geometry): the same
    turn and mirror as the JAX package's rotate_flip."""
    planes = [torch.from_numpy(p[0]) for p in _yuv(35, C3_W, C3_H, 420)]
    base = oracle_jinc2(*planes, C3_OW, C3_OH).numpy()
    got = oracle_jinc2(*planes, C3_OW, C3_OH, rotation=rotation,
                       flip=flip).numpy()
    want = np.asarray(jgeo.rotate_flip(jnp.asarray(base), rotation, flip))
    assert np.array_equal(got, want)
