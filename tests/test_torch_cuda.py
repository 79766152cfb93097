"""The CUDA kernels K1 and K2 of videorenderer_tpu_torch on the card,
against their plain PyTorch versions on the same card and inputs.

Every test here needs an NVIDIA card with nvcc (marker ``cuda``) and skips
elsewhere.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Tolerances:
 * K1 float32 <= 2e-6 abs (outputs ~[0,1]): the kernel sums its taps in
   order with FMAs, the plain version is one cuBLAS product;
 * K1 mid16 <= 1 code: that difference flips a rounding at most once;
 * K2 quantized <= 1 code per channel on < 2% of the channels; float output
   <= 1e-5 without a PQ/HLG correction and <= 2e-4 with one (the PQ curve
   multiplies a float32 rounding step by up to ~400).
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch import config as C, csputils as S
from videorenderer_tpu_torch import pipeline as P
from videorenderer_tpu_torch.formats import ColorFormat
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import chroma, scale

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA not available)")
    from videorenderer_tpu_torch.kernels import build
    build.load()
    return torch.device("cuda")


def _lanczos(n_in, n_out):
    return scale.upscale_matrix(C.Upscaling.LANCZOS3, n_in, n_out)


def _planes(rng, dtype, shape):
    if dtype == torch.float32:
        return torch.from_numpy(rng.random(shape, dtype=np.float32))
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    if dtype == torch.uint16:
        return torch.from_numpy(rng.integers(0, 65536, shape, dtype=np.uint16))
    return torch.from_numpy(rng.integers(-2000, 18000, shape).astype(np.int16))


NORM = {torch.uint8: 1 / 255.0, torch.uint16: 1 / 65535.0,
        torch.int16: 1 / 16384.0, torch.float32: None}


@pytest.mark.parametrize("dtype", list(NORM))
@pytest.mark.parametrize("mid16", [False, True])
@pytest.mark.parametrize("sizes", [(3840, 1920), (1000, 333), (960, 1920)])
def test_k1_kernel_matches_plain(dev, dtype, mid16, sizes):
    rng = np.random.default_rng(1)
    mat = rk.BandedMatrix(_lanczos(*sizes), pre_scale=NORM[dtype])
    x = _planes(rng, dtype, (2, 37, sizes[0])).to(dev)
    before = rk.launches["banded_resize_last_axis"]
    got = rk.banded_resize_last_axis(x, mat, mid16=mid16)
    torch.cuda.synchronize()
    assert rk.launches["banded_resize_last_axis"] == before + 1
    ref = rk.banded_resize_last_axis_plain(x, mat, mid16=mid16)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if mid16:
        assert (got.int() - ref.int()).abs().max().item() <= 1
    else:
        assert (got - ref).abs().max().item() <= 2e-6


def _epi(correction, dither_bits):
    """K2's epilogue of a P010 BT.2020 plan with this correction and
    dither depth (8/10 ordered, -8/-10 rounded, 0 float output)."""
    transfer = {rk.CORR_NONE: S.TRC.BT_1886, rk.CORR_PQ_TO_SDR: S.TRC.PQ,
                rk.CORR_HLG_TO_SDR: S.TRC.HLG}[correction]
    plan = P.plan_pipeline(
        C.Settings(use_dither=dither_bits > 0),
        P.SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                           matrix=S.CSP.BT_2020_NC, transfer=transfer,
                           primaries=(S.Primaries.BT_709
                                      if correction == rk.CORR_NONE
                                      else S.Primaries.BT_2020)),
        P.OutputDescriptor(width=64, height=32,
                           bits=abs(dither_bits) if dither_bits else 16))
    epi = P._make_tail_epilogue(plan)
    assert epi.correction == correction and epi.dither_bits == dither_bits
    return epi


def _codes(dw, fmt):
    d = dw.cpu().numpy().view(np.uint32)
    bits, mask = (10, 0x3FF) if fmt == "rgb10a2" else (8, 0xFF)
    return np.stack([(d >> (bits * i)) & mask for i in range(3)]).astype(int)


@pytest.mark.parametrize("correction", [rk.CORR_PQ_TO_SDR, rk.CORR_HLG_TO_SDR,
                                        rk.CORR_NONE])
@pytest.mark.parametrize("dither_bits,pack", [
    (10, "rgb10a2"), (-10, "rgb10a2"), (8, "rgba8"), (-8, None), (0, None)])
def test_k2_kernel_matches_plain(dev, correction, dither_bits, pack):
    """Headline-shaped planes (mid16 luma and chroma, both H matrices) with
    every ported epilogue combination."""
    rng = np.random.default_rng(2)
    hy, hc, w, h_out = 216, 108, 200, 108
    unscale = 1.0 / rk.MID16_SCALE
    _, uy = chroma.chroma_upsample_matrices(
        w // 2, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    my = rk.BandedMatrix(_lanczos(hy, h_out), pre_scale=unscale)
    mc = rk.BandedMatrix(uy @ _lanczos(hy, h_out), pre_scale=unscale)
    y = torch.from_numpy(rng.integers(700, 15400, (2, hy, w)).astype(np.int16))
    u = torch.from_numpy(rng.integers(700, 15600, (2, hc, w)).astype(np.int16))
    v = torch.from_numpy(rng.integers(700, 15600, (2, hc, w)).astype(np.int16))
    y, u, v = y.to(dev), u.to(dev), v.to(dev)
    epi = _epi(correction, dither_bits)
    got = rk.rows3_tail(y, u, v, my, mc, h_out, epi, pack_format=pack)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(y, u, v, my, mc, h_out, epi, pack_format=pack)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if pack is not None:
        d = np.abs(_codes(got, pack) - _codes(ref, pack))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        assert torch.equal(got.cpu() >> 30 if pack == "rgb10a2" else got.cpu() >> 24,
                           ref.cpu() >> 30 if pack == "rgb10a2" else ref.cpu() >> 24)
    elif dither_bits:
        q = 2 ** abs(dither_bits) - 1
        d = ((got - ref).abs() * q).round().cpu().numpy()
        assert d.max() <= 1 and (d > 0).mean() < 0.02
    else:
        tol = 1e-5 if correction == rk.CORR_NONE else 2e-4
        assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize("ytype", [torch.uint8, torch.uint16, torch.float32])
def test_k2_kernel_direct_read(dev, ytype):
    """A luma plane without H matrix (the c1 form), read directly and
    scaled; chroma with its H upsample; no colour matrix for float."""
    rng = np.random.default_rng(3)
    h, hc, w = 64, 32, 160
    _, uy = chroma.chroma_upsample_matrices(
        w // 2, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    mc = rk.BandedMatrix(uy, pre_scale=1.0 / rk.MID16_SCALE)
    y = _planes(rng, ytype, (3, h, w)).to(dev)
    u = torch.from_numpy(rng.integers(1000, 15700, (3, hc, w)).astype(np.int16)).to(dev)
    v = torch.from_numpy(rng.integers(1000, 15700, (3, hc, w)).astype(np.int16)).to(dev)
    epi = _epi(rk.CORR_NONE, 8)
    got = rk.rows3_tail(y, u, v, None, mc, h, epi, y_scale=NORM[ytype],
                        pack_format="rgba8")
    ref = rk.rows3_tail_plain(y, u, v, None, mc, h, epi, y_scale=NORM[ytype],
                              pack_format="rgba8")
    d = np.abs(_codes(got, "rgba8") - _codes(ref, "rgba8"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("src_rect", [None, (32, 16, 480, 240)])
def test_slice_on_card_matches_cpu(dev, src_rect):
    """The whole main path at a small size, whole frame and a source crop:
    the kernels on the card against the plain versions on the CPU; and the
    launch counts of one call."""
    rng = np.random.default_rng(4)
    wi, hi, wo, ho = 512, 256, 256, 128
    planes = (rng.integers(64, 941, (2, hi, wi), dtype=np.uint16) << 6,
              rng.integers(64, 961, (2, hi // 2, wi // 2), dtype=np.uint16) << 6,
              rng.integers(64, 961, (2, hi // 2, wi // 2), dtype=np.uint16) << 6)
    args = (C.Settings(upscaling=C.Upscaling.LANCZOS3),
            P.SourceDescriptor(format=ColorFormat.P010, width=wi, height=hi,
                               matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                               primaries=S.Primaries.BT_2020,
                               transfer=S.TRC.PQ, src_rect=src_rect),
            P.OutputDescriptor(width=wo, height=ho, bits=10))
    gpu = P.VideoProcessor(*args, device=dev, pack_surface=True)
    cpu = P.VideoProcessor(*args, device="cpu", pack_surface=True)
    rk.reset_launches()
    got = gpu.process(planes)
    torch.cuda.synchronize()
    assert rk.launches == {"banded_resize_last_axis": 3, "rows3_tail": 1}
    ref = cpu.process(planes)
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


def test_kernels_refuse_noncontiguous(dev):
    mat = rk.BandedMatrix(_lanczos(64, 32))
    x = torch.zeros((64, 8), device=dev).mT
    with pytest.raises(ValueError, match="contiguous"):
        rk.banded_resize_last_axis(x, mat)
