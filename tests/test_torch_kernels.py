"""Kernels K1 (banded W resize) and K2 (H resize + tail) of
videorenderer_tpu_torch: their plain versions against the JAX package's
Pallas kernels in interpret mode, and the tap-table arithmetic the CUDA
kernels run, replayed in torch, against the plain versions.  (The CUDA
kernels themselves run in tests/test_torch_cuda.py, on a card.)

Tolerances:
 * K1 float32 output <= 2e-5 abs: the JAX kernel's split-bf16 products
   drop the lo*lo term (~2^-16 relative); the port sums in float32.
 * K1 mid16 output <= 1 code: that error flips a rounding at most once.
 * K2 packed output <= 1 code per 10-bit channel, on < 2% of the channels:
   the same bf16 error in the H pass, through the tail, shifts a dither
   threshold now and then.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.kernels import resize_pallas as jrp

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import scale as tscale

N16 = 1.0 / 65535.0


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix): a new matrix of
    the same shape that reuses a freed one's id would hit a stale entry.
    Each test gets its own cache and leaves no entry behind."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def _lanczos(n_in, n_out):
    return np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, n_in,
                                            n_out), np.float32)


def _chroma_w(n_c, n_out):
    ux, _ = tchroma.chroma_upsample_matrices(
        n_c, 8, 420, tcfg.ChromaScaling.BILINEAR, tcsp.ChromaLocation.MPEG2)
    up = np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, 2 * n_c,
                                          n_out))
    return np.asarray(ux @ up, np.float32)


def _u16(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, shape, dtype=np.uint16) << 6)


def _jax_k1(x, mat, pre_scale, mid16):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jrp.banded_resize_last_axis(
            jnp.asarray(x), mat, pre_scale=pre_scale, mid16=mid16))


MATS = {"luma_2to1": lambda: _lanczos(512, 256),
        "chroma_up_down": lambda: _chroma_w(256, 256),
        "up_1to2": lambda: _lanczos(200, 400)}


@pytest.mark.parametrize("which", list(MATS))
def test_k1_plain_matches_pallas_f32(which):
    mat = MATS[which]()
    x = _u16((2, 24, mat.shape[0]), seed=1)
    got = trk.banded_resize_last_axis(torch.from_numpy(x),
                                      trk.BandedMatrix(mat, pre_scale=N16))
    ref = _jax_k1(x, mat, N16, False)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 2e-5


@pytest.mark.parametrize("which", list(MATS))
def test_k1_plain_matches_pallas_mid16(which):
    mat = MATS[which]()
    x = _u16((2, 24, mat.shape[0]), seed=2)
    got = trk.banded_resize_last_axis(torch.from_numpy(x),
                                      trk.BandedMatrix(mat, pre_scale=N16),
                                      mid16=True)
    ref = _jax_k1(x, mat, N16, True)
    assert got.dtype == torch.int16 and ref.dtype == np.int16
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.5


def test_k1_plain_float_and_u8_inputs():
    mat = _lanczos(300, 128)
    rng = np.random.default_rng(3)
    xf = rng.random((5, 300), dtype=np.float32)
    got = trk.banded_resize_last_axis(torch.from_numpy(xf), trk.BandedMatrix(mat))
    assert np.abs(got.numpy() - _jax_k1(xf, mat, None, False)).max() <= 2e-5
    x8 = rng.integers(0, 256, (5, 300), dtype=np.uint8)
    got = trk.banded_resize_last_axis(torch.from_numpy(x8),
                                      trk.BandedMatrix(mat, pre_scale=1 / 255.0))
    np.testing.assert_allclose(got.numpy(), (x8 / 255.0) @ mat, atol=2e-6)


def _replay_taps(x: torch.Tensor, mat: trk.BandedMatrix) -> torch.Tensor:
    """What csrc/banded_resize.cu computes for each output, in torch: the
    sum over t of x[starts[j] + t] * taps[t, j], taps past the input edge
    skipped."""
    n_in = mat.in_size
    starts, taps = (torch.from_numpy(a) for a in (mat.starts, mat.taps))
    acc = torch.zeros(x.shape[:-1] + (mat.out_size,), dtype=torch.float32)
    xf = x.to(torch.float32)
    for t in range(mat.n_taps):
        idx = starts.long() + t
        ok = idx < n_in
        acc += torch.where(ok, xf[..., idx.clamp(max=n_in - 1)] * taps[t], 0.0)
    return acc


@pytest.mark.parametrize("which", list(MATS))
def test_tap_replay_matches_plain(which):
    """The tap-table layout (T, out) and the edge guard the kernels rely
    on reproduce the dense product; both K1 (columns) and K2 (rows) read
    their tables this way."""
    mat = trk.BandedMatrix(MATS[which](), pre_scale=N16)
    x = torch.from_numpy(_u16((3, 7, mat.in_size), seed=4))
    replay = _replay_taps(x, mat)
    plain_w = trk.banded_resize_last_axis_plain(x, mat)
    xt = x.mT.contiguous()                       # the same data, H major
    plain_h = trk.rows3_tail_plain(xt, xt, xt, mat, mat, mat.out_size,
                                   _identity_epilogue())[..., 0, :, :].mT
    assert torch.allclose(replay, plain_w, atol=2e-6, rtol=0)
    assert torch.allclose(replay, plain_h, atol=2e-6, rtol=0)


def _identity_epilogue():
    return trk.Epilogue(cmat=None, correction=trk.CORR_NONE,
                        luminance_scale=1.0, dither_bits=0,
                        gamut=np.eye(3, dtype=np.float32),
                        plain=lambda y, u, v: torch.stack([y, u, v], dim=-3))


# --- K2 ----------------------------------------------------------------------

def _headline_plans(w=256, h=128, ow=128, oh=64):
    def mk(cfg, csp, pipe, fmt):
        return pipe.plan_pipeline(
            cfg.Settings(upscaling=cfg.Upscaling.LANCZOS3,
                         chroma_scaling=cfg.ChromaScaling.BILINEAR),
            pipe.SourceDescriptor(format=fmt.P010, width=w, height=h,
                                  matrix=csp.CSP.BT_2020_NC,
                                  levels=csp.Levels.TV,
                                  primaries=csp.Primaries.BT_2020,
                                  transfer=csp.TRC.PQ,
                                  hdr10=pipe.HDR10Metadata()),
            pipe.OutputDescriptor(width=ow, height=oh, bits=10))
    return mk(jcfg, jcsp, jpipe, JFmt), mk(tcfg, tcsp, tpipe, TFmt)


def _packed_codes(dw):
    d = np.asarray(dw).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)]).astype(np.int32)


def test_k2_plain_matches_pallas_headline_packed():
    """Identical mid16 W-passed planes into both K2s, each with its own
    package's H matrices (equal) and headline epilogue, packed."""
    jplan, tplan = _headline_plans()
    wy = np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, 128, 64),
                    np.float64)
    _, uy = tchroma.chroma_upsample_matrices(
        64, 64, 420, tcfg.ChromaScaling.BILINEAR, tcsp.ChromaLocation.MPEG2)
    cwy = uy @ wy
    rng = np.random.default_rng(11)
    # mid16 codes of plausible W-pass outputs: luma ~[0.06, 0.92], chroma
    # ~[0.06, 0.94], plus a little filter overshoot
    y = rng.integers(700, 15400, (2, 128, 128)).astype(np.int16)
    u = rng.integers(700, 15600, (2, 64, 128)).astype(np.int16)
    v = rng.integers(700, 15600, (2, 64, 128)).astype(np.int16)
    unscale = 1.0 / trk.MID16_SCALE

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.rows3_tail(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            np.asarray(wy, np.float32), np.asarray(cwy, np.float32), 64,
            jpipe._make_tail_epilogue(jplan), y_scale=unscale,
            c_scale=unscale, pack_format="rgb10a2"))
    got = trk.rows3_tail(
        torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
        trk.BandedMatrix(wy, pre_scale=unscale),
        trk.BandedMatrix(cwy, pre_scale=unscale), 64,
        tpipe._make_tail_epilogue(tplan), pack_format="rgb10a2")
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 64, 128)
    g, r = _packed_codes(got.numpy()), _packed_codes(ref)
    assert np.array_equal(np.asarray(got.numpy()).view(np.uint32) >> 30,
                          np.full((2, 64, 128), 3, np.uint32))
    d = np.abs(g - r)
    assert d.max() <= 1
    assert (d > 0).mean() < 0.02


def test_k2_plain_matches_pallas_direct_read_rgba8():
    """The c1 form: raw uint8 luma read directly (no H matrix, scaled by
    1/255), mid16 chroma with the chroma H upsample, BT.709 TV matrix, no
    correction, ordered dither to 8 bits, RGBA8 packing."""
    def mk(cfg, csp, pipe, fmt):
        return pipe.plan_pipeline(
            cfg.Settings(), pipe.SourceDescriptor(
                format=fmt.NV12, width=128, height=64, matrix=csp.CSP.BT_709,
                levels=csp.Levels.TV),
            pipe.OutputDescriptor(width=128, height=64, bits=8))
    jplan, tplan = mk(jcfg, jcsp, jpipe, JFmt), mk(tcfg, tcsp, tpipe, TFmt)
    _, uy = tchroma.chroma_upsample_matrices(
        64, 32, 420, tcfg.ChromaScaling.BILINEAR, tcsp.ChromaLocation.MPEG2)
    rng = np.random.default_rng(12)
    y = rng.integers(16, 236, (2, 64, 128), dtype=np.uint8)
    u = rng.integers(1000, 15700, (2, 32, 128)).astype(np.int16)
    v = rng.integers(1000, 15700, (2, 32, 128)).astype(np.int16)
    unscale = 1.0 / trk.MID16_SCALE
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.rows3_tail(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), None,
            np.asarray(uy, np.float32), 64, jpipe._make_tail_epilogue(jplan),
            y_scale=1 / 255.0, c_scale=unscale, pack_format="rgba8"))
    got = trk.rows3_tail(
        torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v), None,
        trk.BandedMatrix(uy, pre_scale=unscale), 64,
        tpipe._make_tail_epilogue(tplan), y_scale=1 / 255.0,
        pack_format="rgba8").numpy().view(np.uint32)
    ref = ref.view(np.uint32)
    assert np.array_equal(got >> 24, np.full_like(got, 255))
    d = np.abs(np.stack([(got >> s) & 0xFF for s in (0, 8, 16)]).astype(int)
               - np.stack([(ref >> s) & 0xFF for s in (0, 8, 16)]).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("bad", [
    dict(correction=7), dict(dither_bits=6), dict(cmat=np.eye(3))])
def test_k2_refuses_unported_epilogues(bad):
    kw = dict(cmat=None, correction=trk.CORR_NONE, luminance_scale=1.0,
              dither_bits=0, gamut=np.eye(3, dtype=np.float32),
              plain=lambda y, u, v: torch.stack([y, u, v], dim=-3))
    kw.update(bad)
    p = torch.zeros((1, 8, 8), dtype=torch.float32)
    with pytest.raises((NotImplementedError, ValueError)):
        trk.rows3_tail(p, p, p, None, None, 8, trk.Epilogue(**kw))


def test_k2_refuses_bad_shapes():
    p = torch.zeros((1, 8, 8), dtype=torch.float32)
    q = torch.zeros((1, 4, 8), dtype=torch.float32)
    epi = _identity_epilogue()
    with pytest.raises(ValueError):
        trk.rows3_tail(p, q, q, None, None, 8, epi)       # chroma 4 rows, no H
    with pytest.raises(ValueError):
        trk.rows3_tail(p, p, q, None, None, 8, epi)       # u and v differ
    with pytest.raises(ValueError):                        # scale beside H
        trk.rows3_tail(p, p, p, trk.BandedMatrix(np.eye(8)), None, 8, epi,
                       y_scale=0.5)
    with pytest.raises(NotImplementedError):
        trk.rows3_tail(p, p, p, None, None, 8, epi, pack_format="rgb565")
    with pytest.raises(TypeError):
        trk.rows3_tail(p.to(torch.int32), p, p, None, None, 8, epi)


def test_pack_surface_matches_jax():
    rng = np.random.default_rng(13)
    rgb = rng.uniform(-0.2, 1.2, (2, 3, 9, 17)).astype(np.float32)
    for fmt in ("rgb10a2", "rgba8"):
        got = trk.pack_surface(torch.from_numpy(rgb), fmt).numpy()
        ref = np.asarray(jpipe._pack_surface_xla(jnp.asarray(rgb), fmt))
        assert got.dtype == np.int32 and np.array_equal(got, ref)
