"""The CUDA kernels K1-K10 of videorenderer_tpu_torch on the card, against
their plain PyTorch versions on the same card and inputs, and the paths
built on them.

Every test here needs an NVIDIA card with nvcc (marker ``cuda``) and skips
elsewhere.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Tolerances:
 * K1 float32 <= 2e-6 abs (outputs ~[0,1]): the kernel sums its taps in
   order with FMAs, the plain version is one cuBLAS product;
 * K1 mid16 <= 1 code: that difference flips a rounding at most once;
 * K2 quantized <= 1 code per channel on < 2% of the channels; float output
   <= 1e-5 without a PQ/HLG correction and <= 2e-4 with one (the PQ curve
   multiplies a float32 rounding step by up to ~400);
 * K5 and K6 float output <= 1e-5 (outputs ~[0,1]: the kernels and the
   plain versions round every operation alike, only sinf's last bits
   differ); quantized <= 1 code on < 1% of the channels; K6's transposed
   store bit-equal to the transpose of its plain store; the table and
   per-output routes of each bit-equal to each other;
 * K7 float32 <= 2e-5 (the deinterlaced values are bit-equal, the tap sums
   run in another order); K9 as K2 (float output without a correction
   <= 1e-5);
 * K3 float32 <= 2e-6, as K1;
 * K8 float32 <= 1e-5 with c8's metadata (the identity LMS fold: only the
   tap sums differ) and <= 1e-4 with the non-identity variant and the
   curve structure's limits (the PQ round trip of the LMS step amplifies
   the sums' rounding near black); its LMS route bit-equal to its
   long-window route;
   K2's Dolby Vision route (stage A of the two-stage form, the same
   convert) likewise;
 * K2 with the local tone map (selections 1-6) or HLG -> PQ as K2 above;
 * K4 float32 <= 1e-5 with the colour matrix only; with a whole tail,
   dithered float within 1 code on < 2% of the channels, as K2;
 * K10 ``wpass_floor`` bit-equal (the same bf16 rounding of exact codes),
   ``wpass_bf16`` <= 1e-5 (exact bf16 products, the sums in another
   order);
 * the long-window routes of K2, K3, K7, K8 and K9 bit-equal to the staged
   routes on maps both take (forced by the modules' ``*_LONG_WINDOW``
   flags), and within their kernel's band of the plain version on maps
   only they take; a placed K2 or K9 output bit-equal inside its rect to
   the unplaced output, every bar the packed zero (or float zeros);
 * K2, K9 and K4 with the SDR BT.2020 fix as K2 with a correction above;
 * the renderer facade (``api.VideoRenderer``) on the card against the same
   renderer on the CPU as K2/K9 (1 code on < 2%), its overlays included;
   ``process_packed`` bit-equal to ``process`` of the host-unpacked planes
   on the card, and ``run_clip`` bit-equal to ``process`` of each batch;
 * training: 3 steps of either trainer on the card within 1% of the
   CPU's, loss by loss; a one-rank NCCL mesh bit-equal to no mesh.
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch import config as C, csputils as S
from videorenderer_tpu_torch import pipeline as P
from videorenderer_tpu_torch.formats import ColorFormat
from videorenderer_tpu_torch.kernels import deint as dk
from videorenderer_tpu_torch.kernels import jinc2 as jk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import chroma, geometry, scale
from videorenderer_tpu_torch.ops import dovi, dovi_ext, hdr10plus
from videorenderer_tpu_torch.ops import tonemap as tm_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA not available)")
    from videorenderer_tpu_torch.kernels import build
    build.load()
    return torch.device("cuda")


def only(**counts):
    """The launch counts of a call that launches these kernels and no
    other."""
    return {k: counts.get(k, 0) for k in rk.launches}


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


def _unaligned(x):
    """A contiguous copy of ``x`` on the card whose storage starts one
    element into its buffer, so its data pointer is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", list(NORM))
@pytest.mark.parametrize("mid16", [False, True])
@pytest.mark.parametrize("sizes", [
    (3840, 1920), (1000, 333), (960, 1920), (1366, 683), (1001, 1920),
    (1920, 1366)])
@pytest.mark.parametrize("batch,unaligned", [(2, False), (1, False),
                                             (17, False), (2, True)])
def test_k1_kernel_matches_plain(dev, dtype, mid16, sizes, batch, unaligned):
    """Widths that are not a multiple of the vector or the span, rows that
    are not a multiple of the block's (37 a frame), batch 1 and 17, and an
    input whose pointer is not 16-byte aligned."""
    rng = np.random.default_rng(1)
    mat = rk.BandedMatrix(_lanczos(*sizes), pre_scale=NORM[dtype])
    x = _planes(rng, dtype, (batch, 37, sizes[0])).to(dev)
    if unaligned:
        x = _unaligned(x)
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


def _headline_k2(rng, batch, hy, w, h_out, dtype=torch.int16):
    """K2's headline-shaped call: both planes with H maps (Lanczos3 hy ->
    h_out, the chroma's composed with the bilinear upsample), mid16 codes
    (or ``dtype`` planes with their normalisation in the maps)."""
    hc = hy // 2
    _, uy = chroma.chroma_upsample_matrices(
        w // 2, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    scale_ = 1.0 / rk.MID16_SCALE if dtype == torch.int16 else NORM[dtype]
    my = rk.BandedMatrix(_lanczos(hy, h_out), pre_scale=scale_)
    mc = rk.BandedMatrix(uy @ _lanczos(hy, h_out), pre_scale=scale_)
    if dtype == torch.int16:
        y = torch.from_numpy(rng.integers(700, 15400, (batch, hy, w))
                             .astype(np.int16))
        u, v = (torch.from_numpy(rng.integers(700, 15600, (batch, hc, w))
                                 .astype(np.int16)) for _ in range(2))
    else:
        y, u, v = (_planes(rng, dtype, (batch, h, w)) for h in (hy, hc, hc))
    return y.to(dev_of()), u.to(dev_of()), v.to(dev_of()), my, mc


def dev_of():
    return torch.device("cuda")


def _k2_close(got, ref, pack, dither_bits, correction):
    """K2 against its plain version at the bands of the module docstring."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if pack is not None:
        d = np.abs(_codes(got, pack) - _codes(ref, pack))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        top = 30 if pack == "rgb10a2" else 24
        assert torch.equal(got.cpu() >> top, ref.cpu() >> top)
    elif dither_bits:
        q = 2 ** abs(dither_bits) - 1
        d = ((got - ref).abs() * q).round().cpu().numpy()
        assert d.max() <= 1 and (d > 0).mean() < 0.02
    else:
        tol = 1e-5 if correction == rk.CORR_NONE else 2e-4
        assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize("w,hy,h_out,batch,unaligned", [
    (1366, 216, 108, 2, False),   # width not a multiple of the tile
    (1001, 216, 108, 2, False),   # nor of the vector
    (1920, 1080, 541, 1, False),  # h_out not a multiple of the tile rows
    (200, 64, 33, 17, False),     # batch 17
    (1920, 216, 108, 1, False),
    (1000, 216, 108, 2, True),    # planes not 16-byte aligned
    (1001, 216, 108, 2, True)])
def test_k2_tiled_edges(dev, w, hy, h_out, batch, unaligned):
    """The tiled K2 at shapes a tiled, vectorised kernel can get wrong, with
    the headline's epilogue packed: within 1 code of its plain version."""
    rng = np.random.default_rng(30)
    y, u, v, my, mc = _headline_k2(rng, batch, hy, w, h_out)
    if unaligned:
        y, u, v = _unaligned(y), _unaligned(u), _unaligned(v)
    epi = _epi(rk.CORR_PQ_TO_SDR, 10)
    got = rk.rows3_tail(y, u, v, my, mc, h_out, epi, pack_format="rgb10a2")
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(y, u, v, my, mc, h_out, epi,
                              pack_format="rgb10a2")
    _k2_close(got, ref, "rgb10a2", 10, rk.CORR_PQ_TO_SDR)


def test_k2_taps_past_the_input_edge(dev):
    """A map whose last rows' taps run past the input: the guard skips
    them in the staged window as it did in device memory."""
    rng = np.random.default_rng(31)
    m = np.zeros((14, 7), np.float32)
    for j in range(6):
        m[2 * j:2 * j + 4, j] = [0.1, 0.4, 0.4, 0.1]
    m[12:14, 6] = [0.5, 0.5]
    mat = rk.BandedMatrix(m)
    assert mat.starts[-1] + mat.n_taps > mat.in_size
    planes = [_planes(rng, torch.float32, (3, 14, 260)).to(dev)
              for _ in range(3)]
    epi = P.cmat_epilogue(np.array([[1, 0, 0.5, 0], [0, 1, 0, 0.1],
                                    [0.2, 0, 1, 0]], np.float32))
    got = rk.rows3_tail(*planes, mat, mat, 7, epi)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*planes, mat, mat, 7, epi)
    _k2_close(got, ref, None, 0, rk.CORR_NONE)


@pytest.mark.parametrize("ytype", list(NORM))
@pytest.mark.parametrize("ctype", list(NORM))
def test_k2_plane_dtypes(dev, ytype, ctype):
    """Every plane dtype pair through the staged windows (both planes with H
    maps), the headline's tail packed."""
    rng = np.random.default_rng(32)
    y = _headline_k2(rng, 2, 216, 200, 108, ytype)
    c = _headline_k2(rng, 2, 216, 200, 108, ctype)
    epi = _epi(rk.CORR_PQ_TO_SDR, 10)
    args = (y[0], c[1], c[2], y[3], c[4], 108, epi)
    got = rk.rows3_tail(*args, pack_format="rgb10a2")
    torch.cuda.synchronize()
    _k2_close(got, rk.rows3_tail_plain(*args, pack_format="rgb10a2"),
              "rgb10a2", 10, rk.CORR_PQ_TO_SDR)


def _planes_epilogue():
    """torch_headline_micro's tailH epilogue: the planes as R, G, B."""
    return rk.Epilogue(cmat=None, correction=rk.CORR_NONE,
                       luminance_scale=1.0, dither_bits=0,
                       gamut=np.eye(3, dtype=np.float32),
                       plain=lambda y, u, v: torch.stack([y, u, v], dim=-3))


def _cmat_epi():
    return P.cmat_epilogue(np.array([[1.0, 0.0, 1.4746, -0.7373],
                                     [1.0, -0.1646, -0.5714, 0.3680],
                                     [1.0, 1.8814, 0.0, -0.9407]], np.float32))


K2_ROUTES = [
    # (route name, luma dtype (None: mid16 with an H map), chroma dtype,
    #  epilogue, pack)
    ("headline int16", torch.int16, torch.int16,
     lambda: _epi(rk.CORR_PQ_TO_SDR, 10), "rgb10a2"),
    ("headline float32", torch.float32, torch.float32,
     lambda: _epi(rk.CORR_PQ_TO_SDR, 10), "rgb10a2"),
    ("headline planar float32", torch.float32, torch.float32,
     lambda: _epi(rk.CORR_PQ_TO_SDR, 10), None),
    ("c1 uint8/int16", torch.uint8, torch.int16,
     lambda: _epi(rk.CORR_NONE, 8), "rgba8"),
    ("c5 int16", torch.int16, torch.int16,
     lambda: _epi(rk.CORR_HLG_TO_SDR, 8), "rgba8"),
    ("c7 uint16/int16", torch.uint16, torch.int16,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108)), "rgb10a2"),
    ("c7 uint16/float32", torch.uint16, torch.float32,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108),
                                   rt={"hdr": SCENE}),
     "rgb10a2"),
    ("c7 planar uint16/float32", torch.uint16, torch.float32,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108)), None),
    ("hlg-to-pq uint16/int16", torch.uint16, torch.int16,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108, transfer="HLG",
                                            local=False)), "rgb10a2"),
    ("matrix uint8/float32", torch.uint8, torch.float32, _cmat_epi, None),
    ("matrix rgb10 float32", torch.float32, torch.float32, _cmat_epi,
     "rgb10a2"),
    ("matrix rgb10 uint16/float32", torch.uint16, torch.float32, _cmat_epi,
     "rgb10a2"),
    ("planes rgb10 float32", torch.float32, torch.float32, _planes_epilogue,
     "rgb10a2"),
    ("planes rgb10 uint16/float32", torch.uint16, torch.float32,
     _planes_epilogue, "rgb10a2"),
    # a combination no path runs: rounding to 10 bits takes the runtime form
    ("runtime", torch.int16, torch.int16,
     lambda: _epi(rk.CORR_PQ_TO_SDR, -10), "rgb10a2"),
    ("runtime", torch.uint16, torch.int16,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108, sel="HABLE")),
     "rgb10a2"),
    # c7's dtypes and pack with the guided curve (c7p) or the L2 trims:
    # the runtime route, never a compiled one
    ("runtime", torch.uint16, torch.int16,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108, hdr10plus=GUIDED)),
     "rgb10a2"),
    ("runtime", torch.uint16, torch.float32,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108, hdr10plus=GUIDED),
                                   rt={"hdr": SCENE}), "rgb10a2"),
    ("runtime", torch.uint16, torch.int16,
     lambda: P._make_tail_epilogue(_c7_plan(w=200, h=108, dovi_trims=TRIMS)),
     "rgb10a2"),
]


@pytest.mark.parametrize("name,ytype,ctype,make_epi,pack", K2_ROUTES,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(K2_ROUTES)])
def test_k2_routes_match_plain(dev, name, ytype, ctype, make_epi, pack):
    """Each specialised route, and two combinations that take the runtime
    instantiation: the name rows3_tail_route reports, and the kernel within
    its band of the plain version.  A luma of uint8/uint16 is read
    directly (the c1, c7, staged-convert and stage-split forms)."""
    rng = np.random.default_rng(33)
    epi = make_epi()
    assert rk.rows3_tail_route(ytype, ctype, epi, pack) == name
    w, h_out = 200, 108
    if ytype in (torch.uint8, torch.uint16):
        y = _planes(rng, ytype, (2, h_out, w)).to(dev)
        my, y_scale = None, NORM[ytype]
    else:
        y, _, _, my, _ = _headline_k2(rng, 2, 216, w, h_out, ytype)
        y_scale = None
    _, u, v, _, mc = _headline_k2(rng, 2, 216, w, h_out, ctype)
    args = (y, u, v, my, mc, h_out, epi)
    kw = dict(y_scale=y_scale, pack_format=pack)
    got = rk.rows3_tail(*args, **kw)
    torch.cuda.synchronize()
    _k2_close(got, rk.rows3_tail_plain(*args, **kw), pack, epi.dither_bits,
              epi.correction)


def test_k2_is_deterministic(dev):
    """Two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(34)
    y, u, v, my, mc = _headline_k2(rng, 3, 1080, 1920, 541)
    epi = _epi(rk.CORR_PQ_TO_SDR, 10)
    a = rk.rows3_tail(y, u, v, my, mc, 541, epi, pack_format="rgb10a2")
    b = rk.rows3_tail(y, u, v, my, mc, 541, epi, pack_format="rgb10a2")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k1_k2_refuse_windows_over_the_budget(dev):
    """A box average of 8192 inputs into 4 outputs at float32: K1 stages
    fewer rows a block and K2 takes its long-window route, each within its
    band of the plain version; only a K1 span whose one row does not fit
    (60000 float32 columns) raises, before any launch.  The inputs are
    whole numbers, so the box sums are exact in any order."""
    rng = np.random.default_rng(35)
    box = rk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert rk.k1_rows(4, box.row_windows(rk.K1_SPAN)[1]) == 4
    x = torch.from_numpy(rng.integers(0, 256, (3, 8192)).astype(
        np.float32)).to(dev)
    got = rk.banded_resize_last_axis(x, box)
    torch.cuda.synchronize()
    assert (got - rk.banded_resize_last_axis_plain(x, box)).abs().max() \
        <= 2e-6
    assert rk.k2_route(4, 4, box, box) == "long-window"
    p = torch.from_numpy(rng.integers(0, 256, (1, 8192, 8)).astype(
        np.float32) / 256).to(dev)
    got = rk.rows3_tail(p, p, p, box, box, 4, _cmat_epi())
    torch.cuda.synchronize()
    assert (got - rk.rows3_tail_plain(p, p, p, box, box, 4, _cmat_epi())
            ).abs().max() <= 1e-5
    wide = rk.BandedMatrix(np.full((60000, 1), 1 / 60000, np.float32))
    before = dict(rk.launches)
    with pytest.raises(ValueError, match="shared memory"):
        rk.banded_resize_last_axis(
            torch.zeros((1, 60000), dtype=torch.float32, device=dev), wide)
    assert rk.launches == before


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
    assert rk.launches == only(banded_resize_last_axis=3, rows3_tail=1)
    ref = cpu.process(planes)
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


def test_kernels_refuse_noncontiguous(dev):
    mat = rk.BandedMatrix(_lanczos(64, 32))
    x = torch.zeros((64, 8), device=dev).mT
    with pytest.raises(ValueError, match="contiguous"):
        rk.banded_resize_last_axis(x, mat)


def _k2_kconvert_case(rng, sub):
    """The staged convert's K2 call: raw uint8 luma read directly, chroma
    already W-upsampled to float32 by K1, the chroma H upsample, a
    colour-matrix-only epilogue, float output."""
    h, w = 48, 96
    ux, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2 if sub == 420 else h, sub, C.ChromaScaling.BILINEAR,
        S.ChromaLocation.MPEG2)
    hc = h // 2 if sub == 420 else h
    y = torch.from_numpy(rng.integers(16, 236, (2, h, w), dtype=np.uint8))
    u8 = torch.from_numpy(rng.integers(16, 241, (2, hc, w // 2), dtype=np.uint8))
    v8 = torch.from_numpy(rng.integers(16, 241, (2, hc, w // 2), dtype=np.uint8))
    return h, y, u8, v8, ux, uy


@pytest.mark.parametrize("sub", [420, 422])
def test_k2_kconvert_mode(dev, sub):
    rng = np.random.default_rng(5)
    h, y, u8, v8, ux, uy = _k2_kconvert_case(rng, sub)
    kw = rk.BandedMatrix(ux, pre_scale=1 / 255.0)
    kh = None if uy is None else rk.BandedMatrix(uy)
    cmat = np.concatenate([np.eye(3, dtype=np.float32) * 1.1,
                           np.full((3, 1), -0.05, np.float32)], axis=1)
    epi = rk.Epilogue(cmat=cmat, correction=rk.CORR_NONE, luminance_scale=1.0,
                      dither_bits=0, gamut=np.eye(3, dtype=np.float32),
                      plain=lambda a, b, c: P._apply_cmat(cmat[:, :3],
                                                          cmat[:, 3], a, b, c))
    y, u8, v8 = y.to(dev), u8.to(dev), v8.to(dev)
    u = rk.banded_resize_last_axis(u8, kw)
    v = rk.banded_resize_last_axis(v8, kw)
    assert u.dtype == torch.float32
    got = rk.rows3_tail(y, u, v, None, kh, h, epi, y_scale=1 / 255.0)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(y, u, v, None, kh, h, epi, y_scale=1 / 255.0)
    assert got.shape == ref.shape == (2, 3, h, y.shape[-1])
    assert (got - ref).abs().max().item() <= 1e-5


def _q_codes(x, bits):
    return (x * (2 ** bits - 1)).round().int()


@pytest.mark.parametrize("dither_bits", [0, 8, -10])
@pytest.mark.parametrize("sizes", [(27, 48, 54, 96), (30, 40, 61, 90),
                                   (27, 48, 96, 54), (32, 48, 64, 48)])
def test_k5_kernel_matches_plain(dev, sizes, dither_bits):
    h, w, oh, ow = sizes
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((3, h, w), dtype=np.float32)).to(dev)
    epi = jk.dither_epilogue(dither_bits) if dither_bits else None
    before = rk.launches["jinc2_resize_fused"]
    got = jk.jinc2_resize_fused(x, oh, ow, epi)
    torch.cuda.synchronize()
    assert rk.launches["jinc2_resize_fused"] == before + 1
    ref = jk.jinc2_resize_fused_plain(x, oh, ow, epi)
    assert got.shape == ref.shape == (3, oh, ow)
    if dither_bits == 0:
        assert (got - ref).abs().max().item() <= 1e-5
    else:
        d = (_q_codes(got, abs(dither_bits)) - _q_codes(ref, abs(dither_bits))).abs()
        assert d.max().item() <= 1 and (d > 0).double().mean().item() < 0.01


K5_GEOMS = [(27, 48, 54, 96),     # 2x both axes (c3's ratio)
            (30, 40, 61, 90),     # odd outputs, unaligned widths
            (27, 48, 96, 54),     # 3.5x up rows, 9/8 columns (c3rot-like)
            (32, 48, 64, 48),     # 2x rows, columns unchanged
            (40, 300, 80, 1000),  # several column tiles, 10/3 across
            (1079, 67, 2160, 133)]  # no short period: no table


@pytest.mark.parametrize("planes", [1, 7])
@pytest.mark.parametrize("dither_bits", [0, 8, -8, 10])
@pytest.mark.parametrize("geom", K5_GEOMS)
def test_k5_table_route_bit_equal_to_per_output_route(dev, geom, dither_bits,
                                                      planes, monkeypatch):
    """K5's table route and its per-output route (the cap at 0) give the
    same bits, float, dithered and rounded, on one plane and on many, at
    widths that are no multiple of 4; the per-output route builds no
    table."""
    h, w, oh, ow = geom
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.random((planes, h, w), dtype=np.float32)).to(dev)
    epi = jk.dither_epilogue(dither_bits) if dither_bits else None
    route = jk.k5_route(*geom)
    assert route[1] == "staged"
    first = jk.jinc2_resize_fused(x, oh, ow, epi)
    monkeypatch.setattr(jk, "TABLE_CAP", 0)
    assert jk.k5_route(*geom) == ("per-output", "staged")
    before = dict(rk.launches)
    per_output = jk.jinc2_resize_fused(x, oh, ow, epi)
    torch.cuda.synchronize()
    assert rk.launches["jinc2_weight_table"] == before["jinc2_weight_table"]
    assert rk.launches["jinc2_resize_fused"] == \
        before["jinc2_resize_fused"] + 1
    assert torch.equal(first, per_output)


def test_k5_unaligned_planes_and_output_rows(dev):
    """A plane whose data pointer is not 16-byte aligned (element copies
    into the window) and an output row whose stores cannot be vectors
    give the aligned call's bits."""
    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.random((3, 36, 64), dtype=np.float32)).to(dev)
    epi = jk.dither_epilogue(8)
    want = jk.jinc2_resize_fused(x, 72, 128, epi)
    got = jk.jinc2_resize_fused(_unaligned(x), 72, 128, epi)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = jk.jinc2_resize_fused_plain(x, 72, 126, epi)
    got = jk.jinc2_resize_fused(x, 72, 126, epi)
    d = (_q_codes(got, 8) - _q_codes(ref, 8)).abs()
    assert d.max().item() <= 1 and (d > 0).double().mean().item() < 0.01


def test_k5_window_over_the_budget_reads_taps_through_l1(dev,
                                                          monkeypatch):
    """A 10x downscale on both axes: a tile's source window (314 rows x
    1274 columns) does not fit a block's shared memory, so K5 takes its
    direct route, which reads the taps through L1, runs once and agrees
    with its plain version; with the table cap at 0 too, bit-equal."""
    geom = (640, 1280, 64, 128)
    assert jk.k5_window(*geom)[2] > rk.SMEM_BUDGET
    assert jk.k5_route(*geom) == ("table", "direct")
    rng = np.random.default_rng(63)
    x = torch.from_numpy(rng.random((2, 640, 1280), dtype=np.float32)).to(dev)
    before = rk.launches["jinc2_resize_fused"]
    got = jk.jinc2_resize_fused(x, 64, 128)
    torch.cuda.synchronize()
    assert rk.launches["jinc2_resize_fused"] == before + 1
    ref = jk.jinc2_resize_fused_plain(x, 64, 128)
    assert (got - ref).abs().max().item() <= 1e-5
    monkeypatch.setattr(jk, "TABLE_CAP", 0)
    assert torch.equal(jk.jinc2_resize_fused(x, 64, 128), got)


def test_k5_and_k6_share_the_weight_table(dev):
    """K5 and K6 read one table a geometry: after K5's first call builds
    it, K6 at that geometry builds none, and the other way round."""
    rng = np.random.default_rng(64)
    planes, rest = _k6_geom_case(rng, 48, 64, 96, 128)
    x = torch.from_numpy(rng.random((3, 48, 64), dtype=np.float32)).to(dev)
    for order in ("k5 first", "k6 first"):
        jk.clear_weight_tables()
        rk.reset_launches()
        calls = [lambda: jk.jinc2_resize_fused(x, 96, 128),
                 lambda: jk.jinc2_convert_fused(*planes, *rest)]
        for call in calls if order == "k5 first" else calls[::-1]:
            call()
        torch.cuda.synchronize()
        assert rk.launches == only(jinc2_resize_fused=1,
                                   jinc2_convert_fused=1,
                                   jinc2_weight_table=1), order


def _k6_case(rng, dtype, sub, h=48, w=64):
    hc = h // 2 if sub == 420 else h
    cw = w if sub == 444 else w // 2

    def mk(shape):
        if dtype == torch.float32:
            return torch.from_numpy(rng.random(shape, dtype=np.float32))
        hi = 256 if dtype == torch.uint8 else 65536
        return torch.from_numpy(rng.integers(hi // 16, hi - hi // 16, shape)
                                .astype(np.uint8 if hi == 256 else np.uint16))

    y, u, v = mk((2, h, w)), mk((2, hc, cw)), mk((2, hc, cw))
    ux, uy = chroma.chroma_upsample_matrices(
        cw, hc, sub, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    comp_x = None if ux is None else rk.BandedMatrix(ux)
    comp_y = None if uy is None else rk.BandedMatrix(uy)
    plan = P.plan_pipeline(
        C.Settings(upscaling=C.Upscaling.JINC2),
        P.SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=S.CSP.BT_709),
        P.OutputDescriptor(width=2 * w, height=2 * h, bits=8))
    cmat = np.concatenate([np.asarray(plan.cmat_m, np.float32),
                           np.asarray(plan.cmat_c, np.float32)[:, None]], 1)
    norm = {torch.uint8: 1 / 255.0, torch.uint16: 1 / 65535.0,
            torch.float32: 1.0}[dtype]
    return (y, u, v), comp_y, comp_x, cmat, norm


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("pack,dither_bits", [("rgba8", 8), ("rgb10a2", -10),
                                              (None, 8), (None, 0)])
@pytest.mark.parametrize("sub", [420, 422, 444])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
def test_k6_kernel_matches_plain(dev, dtype, sub, pack, dither_bits,
                                 transpose):
    rng = np.random.default_rng(7)
    planes, comp_y, comp_x, cmat, norm = _k6_case(rng, dtype, sub)
    planes = tuple(p.to(dev) for p in planes)
    h, w = planes[0].shape[-2:]
    oh, ow = (2 * h, 2 * w) if sub == 420 else (85, 72)
    epi = jk.dither_epilogue(dither_bits) if dither_bits else None
    args = (*planes, comp_y, comp_x, cmat, oh, ow, norm, norm)
    kw = dict(epilogue=epi, pack_format=pack)
    before = rk.launches["jinc2_convert_fused"]
    got = jk.jinc2_convert_fused(*args, **kw, out_transpose=transpose)
    torch.cuda.synchronize()
    assert rk.launches["jinc2_convert_fused"] == before + 1
    ref = jk.jinc2_convert_fused_plain(*args, **kw, out_transpose=transpose)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if pack is not None:
        d = np.abs(_codes(got, pack) - _codes(ref, pack))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    elif dither_bits:
        d = (_q_codes(got, 8) - _q_codes(ref, 8)).abs()
        assert d.max().item() <= 1 and (d > 0).double().mean().item() < 0.01
    else:
        assert (got - ref).abs().max().item() <= 1e-5
    if transpose:
        flat = jk.jinc2_convert_fused(*args, **kw)
        assert torch.equal(got, flat.transpose(-2, -1))


def _k6_geom_case(rng, h, w, oh, ow):
    """NV12-like uint8 planes of (h, w) luma, 4:2:0 chroma where both are
    even (4:4:4 otherwise), the bilinear upsample, BT.709's matrix."""
    sub = 420 if h % 2 == 0 and w % 2 == 0 else 444
    planes, comp_y, comp_x, cmat, norm = _k6_case(rng, torch.uint8, sub, h=h,
                                                  w=w)
    return tuple(p.to("cuda") for p in planes), (comp_y, comp_x, cmat, oh,
                                                 ow, norm, norm)


K6_GEOMS = [(48, 64, 96, 128),     # c3's 2x: 2 x 2 classes
            (36, 64, 128, 72),     # c3rot's ratios (32/9 down, 9/8 across)
            (64, 96, 48, 72),      # 3/4 on both axes
            (47, 61, 96, 128)]     # long periods, still under the cap


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("pack,dither_bits", [("rgba8", 8), (None, 0),
                                              ("rgb10a2", -10)])
@pytest.mark.parametrize("geom", K6_GEOMS)
def test_k6_table_route_bit_equal_to_per_output_route(dev, geom, pack,
                                                      dither_bits, transpose,
                                                      monkeypatch):
    """The table route and the per-output route (the cap set to 0) give the
    same bits at c3's, c3rot's and other ratios, packed, float and
    rounded, stored transposed or not; so the table's weights are, bit for
    bit, those K6 computes per output."""
    rng = np.random.default_rng(70)
    planes, rest = _k6_geom_case(rng, *geom)
    epi = jk.dither_epilogue(dither_bits) if dither_bits else None
    kw = dict(epilogue=epi, pack_format=pack, out_transpose=transpose)
    assert jk.weight_route(*geom) == "table"
    table = jk.jinc2_convert_fused(*planes, *rest, **kw)
    monkeypatch.setattr(jk, "TABLE_CAP", 0)
    assert jk.weight_route(*geom) == "per-output"
    before = dict(rk.launches)
    per_output = jk.jinc2_convert_fused(*planes, *rest, **kw)
    torch.cuda.synchronize()
    assert rk.launches["jinc2_weight_table"] == before["jinc2_weight_table"]
    assert torch.equal(table, per_output)


@pytest.mark.parametrize("transpose", [False, True])
def test_k6_per_output_route_matches_plain(dev, transpose):
    """1079 -> 2160 rows by 67 -> 133 columns has no short period on either
    axis: the table would pass the cap, so K6 computes each output's
    weights; it builds no table and agrees with its plain version."""
    rng = np.random.default_rng(71)
    geom = (1079, 67, 2160, 133)
    assert jk.weight_route(*geom) == "per-output"
    planes, rest = _k6_geom_case(rng, *geom)
    kw = dict(epilogue=jk.dither_epilogue(8), pack_format="rgba8",
              out_transpose=transpose)
    rk.reset_launches()
    got = jk.jinc2_convert_fused(*planes, *rest, **kw)
    torch.cuda.synchronize()
    assert rk.launches == only(jinc2_convert_fused=1)
    ref = jk.jinc2_convert_fused_plain(*planes, *rest, **kw)
    d = np.abs(_codes(got, "rgba8") - _codes(ref, "rgba8"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_k6_weight_table_built_once_per_geometry(dev):
    """A geometry's table is built by one launch at its first K6 call and
    reused: a second call, transposed or not, builds nothing; another
    geometry builds its own.  The table holds (n_row_cls, n_col_cls, 20)
    floats within float32 rounding of the plain table, the pad zero."""
    rng = np.random.default_rng(72)
    jk.clear_weight_tables()
    planes, rest = _k6_geom_case(rng, 48, 64, 96, 128)
    rk.reset_launches()
    jk.jinc2_convert_fused(*planes, *rest)
    jk.jinc2_convert_fused(*planes, *rest, out_transpose=True)
    torch.cuda.synchronize()
    assert rk.launches == only(jinc2_convert_fused=2, jinc2_weight_table=1)
    planes2, rest2 = _k6_geom_case(rng, 36, 64, 128, 72)
    jk.jinc2_convert_fused(*planes2, *rest2)
    torch.cuda.synchronize()
    assert rk.launches == only(jinc2_convert_fused=3, jinc2_weight_table=2)
    on = planes[0].device          # the key K6's calls use: cuda:0
    for h, w, oh, ow in ((48, 64, 96, 128), (36, 64, 128, 72)):
        table = jk._weight_table(h, oh, w, ow, on)[2]
        ref = jk.jinc2_weight_table_plain(
            torch.tensor(jk.axis_classes(h, oh)[1], device=dev),
            torch.tensor(jk.axis_classes(w, ow)[1], device=dev))
        assert table.shape == ref.shape
        assert torch.equal(table[..., 17:], torch.zeros_like(table[..., 17:]))
        assert (table - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
    assert rk.launches["jinc2_weight_table"] == 2


def test_kernels_raise_instead_of_plain(dev):
    """A CUDA tensor that the kernel cannot take raises; it never gets the
    plain result."""
    with pytest.raises(TypeError):
        jk.jinc2_resize_fused(torch.zeros((1, 8, 8), dtype=torch.float64,
                                          device=dev), 16, 16)
    rng = np.random.default_rng(8)
    planes, comp_y, comp_x, cmat, norm = _k6_case(rng, torch.uint8, 420,
                                                  h=48, w=4096)
    planes = tuple(p.to(dev) for p in planes)
    with pytest.raises(ValueError, match="shared"):   # a 4096 -> 8 window
        jk.jinc2_convert_fused(*planes, comp_y, comp_x, cmat, 96, 8,
                               norm, norm)


def _c3_like(w=128, h=64, **settings):
    return (C.Settings(upscaling=C.Upscaling.JINC2, use_dither=True,
                       **settings),
            P.SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                               matrix=S.CSP.BT_709),
            P.OutputDescriptor(width=2 * w, height=2 * h, bits=8))


def test_jinc2_path_on_card_matches_cpu(dev):
    """The c3 route on the card (K6) against the staged plain route on the
    CPU, its rotations and their launch counts."""
    rng = np.random.default_rng(9)
    w, h = 128, 64
    planes = (rng.integers(16, 236, (2, h, w), dtype=np.uint8),
              rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8),
              rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8))
    cuda_planes = tuple(torch.from_numpy(p).to(dev) for p in planes)
    plan = P.plan_pipeline(*_c3_like(w, h))
    ref = P.VideoProcessor(*_c3_like(w, h), device="cpu",
                           pack_surface=True).process(planes)
    jk.clear_weight_tables()
    rk.reset_launches()
    got = P.VideoProcessor(*_c3_like(w, h), device=dev,
                           pack_surface=True).process(planes)
    torch.cuda.synchronize()
    # the path's first call builds its geometry's weight table
    assert rk.launches == only(jinc2_convert_fused=1, jinc2_weight_table=1)
    d = np.abs(_codes(got, "rgba8") - _codes(ref, "rgba8"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    rot = P.make_frame_fn(plan, pack_surface=True, rotation=90, flip=True)
    assert torch.equal(rot(cuda_planes), got.transpose(-2, -1))
    rk.reset_launches()
    r270 = P.make_frame_fn(plan, pack_surface=True, rotation=270)(cuda_planes)
    torch.cuda.synchronize()
    assert rk.launches == only(banded_resize_last_axis=2, rows3_tail=1,
                               jinc2_resize_fused=1)
    d = np.abs(_codes(r270, "rgba8")
               - _codes(geometry.rotate_flip(got, 270), "rgba8"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def _c5_plan(w=3840, h=2160, ow=1920, oh=1080):
    """c5 (bench_common.build_plan("c5")) at any size: P010 HLG BT.2020
    interlaced, Lanczos3, HLG -> SDR, 8-bit ordered dither."""
    return P.plan_pipeline(
        C.Settings(convert_to_sdr=True, upscaling=C.Upscaling.LANCZOS3),
        P.SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                           matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                           primaries=S.Primaries.BT_2020, transfer=S.TRC.HLG,
                           interlaced=True),
        P.OutputDescriptor(width=ow, height=oh, bits=8))


def _c5_window(rng, n, w, h):
    """(prev, cur, next) P010 windows of n frames, prev == next on the left
    half: the weave, the ramp and the bob all occur."""
    def frame():
        return (rng.integers(64, 941, (n, h, w), dtype=np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), dtype=np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), dtype=np.uint16) << 6)
    p, c, x = frame(), frame(), frame()
    x = tuple(np.concatenate([a[..., :a.shape[-1] // 2],
                              b[..., a.shape[-1] // 2:]], -1)
              for a, b in zip(p, x))
    return [tuple(torch.from_numpy(a) for a in f) for f in (p, c, x)]


@pytest.mark.parametrize("tff", [True, False])
def test_k7_kernel_matches_plain(dev, tff):
    """c5's geometry on 2 frames: float32 within 2e-5 (only the tap sums
    differ in order; the deinterlaced values are bit-equal)."""
    rng = np.random.default_rng(10)
    win = [tuple(p.to(dev) for p in f) for f in _c5_window(rng, 2, 3840, 2160)]
    _, uy = chroma.chroma_upsample_matrices(
        1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    wy = _lanczos(2160, 1080)
    args = (*win, rk.BandedMatrix(wy, pre_scale=1 / 65535.0),
            rk.BandedMatrix(uy @ wy, pre_scale=1 / 65535.0), 1080,
            8 / 255 * 65535.0, tff)
    before = rk.launches["deint3_rows_dual"]
    got = dk.deint3_rows_dual(*args)
    torch.cuda.synchronize()
    assert rk.launches["deint3_rows_dual"] == before + 1
    ref = dk.deint3_rows_dual_plain(*args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (g - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("case", ["c5_rgba8", "direct_float_no_cmat"])
def test_k9_kernel_matches_plain(dev, case):
    """c5's W maps and epilogue on K7-like float planes, packed RGBA8 (<= 1
    code on < 2% of the channels); and raw uint16 planes read directly
    with a colour-matrix-free epilogue, float out (within 1e-5)."""
    rng = np.random.default_rng(11)
    plan = _c5_plan()
    if case == "c5_rgba8":
        ux, _ = chroma.chroma_upsample_matrices(
            1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
        wx = _lanczos(3840, 1920)
        mx_y, mx_c = rk.BandedMatrix(wx), rk.BandedMatrix(ux @ wx)
        y = torch.from_numpy(rng.uniform(0.06, 0.92, (4, 1080, 3840))
                             .astype(np.float32))
        u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (4, 1080, 1920))
                                 .astype(np.float32)) for _ in range(2))
        epi, pack, scale = P._make_tail_epilogue(plan), "rgba8", None
    else:
        mx_y = mx_c = None
        y, u, v = (torch.from_numpy(rng.integers(0, 65536, (2, 64, 96),
                                                 dtype=np.uint16))
                   for _ in range(3))
        epi = P._make_tail_epilogue(P.plan_pipeline(
            C.Settings(), P.SourceDescriptor(format=ColorFormat.NV12,
                                             width=96, height=64),
            P.OutputDescriptor(width=96, height=64, bits=16)),
            with_cmat=False)
        pack, scale = None, 1 / 65535.0
    y, u, v = y.to(dev), u.to(dev), v.to(dev)
    w_out = y.shape[-1] if mx_y is None else mx_y.out_size
    args = (y, u, v, mx_y, mx_c, w_out, epi)
    kw = dict(y_scale=scale, c_scale=scale, pack_format=pack)
    before = rk.launches["cols3_tail"]
    got = dk.cols3_tail(*args, **kw)
    torch.cuda.synchronize()
    assert rk.launches["cols3_tail"] == before + 1
    ref = dk.cols3_tail_plain(*args, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if pack is not None:
        d = np.abs(_codes(got, pack) - _codes(ref, pack))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        assert torch.equal(got.cpu() >> 24, ref.cpu() >> 24)
    else:
        assert (got - ref).abs().max().item() <= 1e-5


def test_deint_path_on_card_matches_cpu(dev):
    """The double-rate session at a small size: K7 x1 + K9 x1 per push on
    the card, within 1 code of the plain versions on the CPU."""
    from videorenderer_tpu_torch.runner import DeinterlaceSession
    rng = np.random.default_rng(12)
    plan = _c5_plan(256, 128, 128, 64)
    stream = _c5_window(rng, 3, 256, 128)
    gpu = DeinterlaceSession(plan, pack_surface=True, device=dev)
    cpu = DeinterlaceSession(plan, pack_surface=True, device="cpu")
    rk.reset_launches()
    got = []
    for b in stream:
        got += gpu.push_batch(tuple(p.to(dev) for p in b))
    torch.cuda.synchronize()
    assert rk.launches == only(deint3_rows_dual=3, cols3_tail=3)
    got += gpu.flush_batch()
    ref = []
    for b in stream:
        ref += cpu.push_batch(b)
    ref += cpu.flush_batch()
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        d = np.abs(_codes(g, "rgba8") - _codes(r, "rgba8"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
    rk.reset_launches()
    single = P.make_deint_frame_fn(plan, field=0, pack_surface=True)
    one = single(*[tuple(p.to(dev) for p in f) for f in stream])
    torch.cuda.synchronize()
    assert rk.launches == only(banded_resize_last_axis=3, rows3_tail=1)
    assert one.shape == (3, 64, 128)
    # single rate on the card (K1 on float32 planes, K2 with the HLG tail)
    # against the plain versions on the CPU
    d = np.abs(_codes(one, "rgba8") - _codes(single(*stream), "rgba8"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


THR = {torch.uint8: 8.0, torch.uint16: 8 / 255 * 65535.0,
       torch.int16: 8 / 255 * 16384.0, torch.float32: 8 / 255}


def _k7_case(rng, dtype, batch, w, h, h_out):
    """A K7 window of ``batch`` frames: (prev, cur, next) luma (h, w) and
    chroma (ceil(h / 2), ceil(w / 2)) planes of ``dtype``, next equal to
    prev on the left half; the luma's Lanczos3 H map and the chroma's (the
    4:2:0 upsample composed with it), the normalisation in the taps."""
    hc, wc = -(-h // 2), -(-w // 2)
    frames = []
    for _ in range(3):
        frames.append([_planes(rng, dtype, (batch, hh, ww))
                       for hh, ww in ((h, w), (hc, wc), (hc, wc))])
    frames[2] = [torch.cat([a[..., :a.shape[-1] // 2],
                            b[..., a.shape[-1] // 2:]], dim=-1)
                 for a, b in zip(frames[0], frames[2])]
    _, uy = chroma.chroma_upsample_matrices(
        wc, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    return ([tuple(p.to("cuda") for p in f) for f in frames],
            rk.BandedMatrix(_lanczos(h, h_out), pre_scale=NORM[dtype]),
            rk.BandedMatrix(uy @ _lanczos(2 * hc, h_out),
                            pre_scale=NORM[dtype]))


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("w,h,h_out,batch,dtype,unaligned", [
    (3840, 216, 108, 2, torch.uint16, False),
    (1366, 215, 108, 1, torch.uint16, False),   # odd height, ragged tiles
    (1001, 216, 101, 17, torch.uint16, False),  # odd width, batch 17
    (1366, 216, 541, 1, torch.uint16, False),   # h_out not a multiple of 32
    (1366, 216, 108, 2, torch.uint8, False),
    (1366, 216, 108, 2, torch.int16, False),
    (1001, 215, 108, 2, torch.float32, False),
    (3840, 216, 108, 2, torch.uint16, True),    # planes not 16-byte aligned
    (1001, 216, 108, 1, torch.float32, True)])
def test_k7_tiled_shapes(dev, w, h, h_out, batch, dtype, unaligned, tff):
    """The tiled K7 at shapes a tiled, vectorised kernel can get wrong
    (widths that are not a multiple of its 64-column tile or of the vector,
    both height parities, h_out not a multiple of its 32-row tile, batch 1
    and 17, every plane dtype, planes whose pointers are not 16-byte
    aligned, both field orders): within 2e-5 of its plain version, one
    launch."""
    rng = np.random.default_rng(15)
    win, my, mc = _k7_case(rng, dtype, batch, w, h, h_out)
    if unaligned:
        win = [tuple(_unaligned(p) for p in f) for f in win]
    args = (*win, my, mc, h_out, THR[dtype], tff)
    before = rk.launches["deint3_rows_dual"]
    got = dk.deint3_rows_dual(*args)
    torch.cuda.synchronize()
    assert rk.launches["deint3_rows_dual"] == before + 1
    for g, r in zip(got, dk.deint3_rows_dual_plain(*args)):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (g - r).abs().max().item() <= 2e-5


def test_k7_is_deterministic(dev):
    """Two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(16)
    win, my, mc = _k7_case(rng, torch.uint16, 3, 1366, 216, 108)
    args = (*win, my, mc, 108, THR[torch.uint16], True)
    a = dk.deint3_rows_dual(*args)
    b = dk.deint3_rows_dual(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _epi_rgb(correction, dither_bits):
    """K9's epilogue for planes that are R, G, B already (c8's form:
    ``with_cmat=False``) of a P010 BT.2020 plan."""
    plan = P.plan_pipeline(
        C.Settings(use_dither=dither_bits > 0, convert_to_sdr=True),
        P.SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                           matrix=S.CSP.BT_2020_NC, transfer=S.TRC.PQ,
                           primaries=S.Primaries.BT_2020),
        P.OutputDescriptor(width=64, height=32, bits=abs(dither_bits)))
    epi = P._make_tail_epilogue(plan, with_cmat=False)
    assert epi.cmat is None and epi.correction == correction
    return epi


K9_ROUTES = [
    # (route name, plane dtype (None: read directly), epilogue, pack)
    ("c5 float32", torch.float32, lambda: P._make_tail_epilogue(_c5_plan()),
     "rgba8"),
    ("c8 float32", torch.float32,
     lambda: _epi_rgb(rk.CORR_PQ_TO_SDR, 10), "rgb10a2"),
    # combinations no path runs take the runtime form: c5's tail planar,
    # c8's packed RGBA8, integer planes, planes read directly
    ("runtime", torch.float32, lambda: P._make_tail_epilogue(_c5_plan()),
     None),
    ("runtime", torch.float32, lambda: _epi_rgb(rk.CORR_PQ_TO_SDR, 8),
     "rgba8"),
    ("runtime", torch.uint16, lambda: P._make_tail_epilogue(_c5_plan()),
     "rgba8"),
    ("runtime", None, lambda: _cmat_epi(), None),
    # c8's flags with the trims (c8x: PQ domain), c8hdr (trims in nits and
    # ST 2094-10) and the guided curve: the runtime route
    ("runtime", torch.float32, lambda: _dovi_ext_epi(False), "rgb10a2"),
    ("runtime", torch.float32, lambda: _dovi_ext_epi(True), "rgb10a2"),
    ("runtime", torch.float32,
     lambda: P._make_tail_epilogue(_c7_plan(hdr10plus=GUIDED)), "rgb10a2"),
]


@pytest.mark.parametrize("w_out", [1920, 1001, 683])
@pytest.mark.parametrize("name,dtype,make_epi,pack", K9_ROUTES,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(K9_ROUTES)])
def test_k9_routes_match_plain(dev, name, dtype, make_epi, pack, w_out):
    """Each compiled route of K9 and combinations that take the runtime
    instantiation, at widths that are a multiple of its 128-column tile,
    of neither the tile nor the vector (1001 from 2002), and of neither
    from a 2:1 map (683 from 1366): the name cols3_tail_route reports, and
    the kernel within its band of the plain version (<= 1 code on < 2%;
    float <= 1e-5)."""
    rng = np.random.default_rng(17)
    epi = make_epi()
    rows = 40
    if dtype is None:     # raw uint16 planes read directly
        y, u, v = (_planes(rng, torch.uint16, (2, rows, w_out)).to(dev)
                   for _ in range(3))
        mx_y = mx_c = None
        kw = dict(y_scale=1 / 65535.0, c_scale=1 / 65535.0)
        assert dk.cols3_tail_route(torch.uint16, torch.uint16, epi,
                                   pack) == name
    else:
        assert dk.cols3_tail_route(dtype, dtype, epi, pack) == name
        wy, wc = 2 * w_out, w_out
        ux, _ = chroma.chroma_upsample_matrices(
            wc, 16, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
        wx = _lanczos(wy, w_out)
        mx_y = rk.BandedMatrix(wx, pre_scale=NORM[dtype])
        mx_c = rk.BandedMatrix(ux @ wx, pre_scale=NORM[dtype])
        if dtype == torch.float32:
            y = torch.from_numpy(rng.uniform(0.06, 0.92, (2, rows, wy))
                                 .astype(np.float32)).to(dev)
            u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (2, rows, wc))
                                     .astype(np.float32)).to(dev)
                    for _ in range(2))
        else:
            y = _planes(rng, dtype, (2, rows, wy)).to(dev)
            u, v = (_planes(rng, dtype, (2, rows, wc)).to(dev)
                    for _ in range(2))
        kw = {}
    args = (y, u, v, mx_y, mx_c, w_out, epi)
    before = rk.launches["cols3_tail"]
    got = dk.cols3_tail(*args, pack_format=pack, **kw)
    torch.cuda.synchronize()
    assert rk.launches["cols3_tail"] == before + 1
    ref = dk.cols3_tail_plain(*args, pack_format=pack, **kw)
    if pack is None and not epi.dither_bits:
        assert (got - ref).abs().max().item() <= 1e-5
    else:
        _k2_close(got, ref, pack, epi.dither_bits, epi.correction)


@pytest.mark.parametrize("batch,rows,unaligned", [
    (2, 40, True),     # planes not 16-byte aligned: element staging
    (17, 5, False),    # batch 17, rows not a multiple of the 16-row tile
    (1, 1080, False)])
def test_k9_tiled_edges(dev, batch, rows, unaligned):
    """c5's maps and route at batches and heights its tiles can get wrong,
    and on planes whose pointers are not 16-byte aligned."""
    rng = np.random.default_rng(18)
    ux, _ = chroma.chroma_upsample_matrices(
        1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    wx = _lanczos(3840, 1920)
    mx_y, mx_c = rk.BandedMatrix(wx), rk.BandedMatrix(ux @ wx)
    y = torch.from_numpy(rng.uniform(0.06, 0.92, (batch, rows, 3840))
                         .astype(np.float32)).to(dev)
    u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (batch, rows, 1920))
                             .astype(np.float32)).to(dev) for _ in range(2))
    if unaligned:
        y, u, v = _unaligned(y), _unaligned(u), _unaligned(v)
    epi = P._make_tail_epilogue(_c5_plan())
    args = (y, u, v, mx_y, mx_c, 1920, epi)
    got = dk.cols3_tail(*args, pack_format="rgba8")
    torch.cuda.synchronize()
    _k2_close(got, dk.cols3_tail_plain(*args, pack_format="rgba8"), "rgba8",
              8, epi.correction)


def test_k9_is_deterministic(dev):
    rng = np.random.default_rng(19)
    wx = _lanczos(3840, 1920)
    mx = rk.BandedMatrix(wx)
    y, u, v = (torch.from_numpy(rng.uniform(0.0, 0.9, (2, 64, 3840))
                                .astype(np.float32)).to(dev)
               for _ in range(3))
    epi = _epi_rgb(rk.CORR_PQ_TO_SDR, 10)
    a = dk.cols3_tail(y, u, v, mx, mx, 1920, epi, pack_format="rgb10a2")
    b = dk.cols3_tail(y, u, v, mx, mx, 1920, epi, pack_format="rgb10a2")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k7_k9_refuse_windows_and_grids_over_their_limits(dev):
    """A box average of 8192 inputs into 4 outputs: the staged window does
    not fit a block's shared memory, so K7 and K9 take their long-window
    routes, within their bands of the plain versions; 65536 frames: past
    K9's grid z limit (K7 folds the frames into x), which raises, naming
    the limit, before any launch.  The inputs are whole numbers (and prev
    is next: no motion), so the box sums are exact in any order."""
    rng = np.random.default_rng(36)
    box = rk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert dk.k7_route(4, box, box) == dk.k9_route(4, 4, box, box) \
        == "long-window"
    p = torch.from_numpy(rng.integers(0, 256, (1, 8192, 8)).astype(
        np.float32) / 256).to(dev)
    win = ((p,) * 3, (p,) * 3, (p,) * 3)
    got = dk.deint3_rows_dual(*win, box, box, 4, 1.0)
    torch.cuda.synchronize()
    for g, r in zip(got, dk.deint3_rows_dual_plain(*win, box, box, 4, 1.0)):
        assert (g - r).abs().max().item() <= 2e-5
    q = p.reshape(1, 8, 8192).contiguous()
    got = dk.cols3_tail(q, q, q, box, box, 4, _cmat_epi())
    torch.cuda.synchronize()
    assert (got - dk.cols3_tail_plain(q, q, q, box, box, 4, _cmat_epi())
            ).abs().max().item() <= 1e-5
    before = dict(rk.launches)
    eye = rk.BandedMatrix(np.eye(4, dtype=np.float32))
    many = torch.zeros((65536, 4, 4), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="65535"):
        dk.cols3_tail(many, many, many, eye, eye, 4, _cmat_epi())
    assert rk.launches == before


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32, torch.uint8])
@pytest.mark.parametrize("sizes", [(1608, 804), (804, 804), (37, 20)])
def test_k3_kernel_matches_plain(dev, dtype, sizes):
    """The letterboxed path's H maps (a 2.39:1 film's luma 1608 -> 804 rows,
    the chroma's upsample composed with it, 804 -> 804) and a small odd
    one."""
    rng = np.random.default_rng(13)
    if sizes == (804, 804):
        _, uy = chroma.chroma_upsample_matrices(
            150, 804, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
        m = uy @ _lanczos(1608, 804)
    else:
        m = _lanczos(*sizes)
    mat = rk.BandedMatrix(m, pre_scale=NORM[dtype])
    x = _planes(rng, dtype, (2, sizes[0], 300)).to(dev)
    before = rk.launches["banded_resize_rows"]
    got = rk.banded_resize_rows(x, mat)
    torch.cuda.synchronize()
    assert rk.launches["banded_resize_rows"] == before + 1
    ref = rk.banded_resize_rows_plain(x, mat)
    assert got.shape == ref.shape == (2, sizes[1], 300)
    assert (got - ref).abs().max().item() <= 2e-6


@pytest.mark.parametrize("dtype", list(NORM))
@pytest.mark.parametrize("h_in,h_out,w,batch,unaligned", [
    (1608, 804, 1920, 16, False),   # the letterbox's luma
    (203, 101, 300, 1, False),      # 101 rows: no multiple of 32
    (75, 150, 130, 2, True),        # 2x up, unaligned plane and width
    (37, 20, 131, 3, False),        # an odd map and width
    (64, 64, 8, 1, False)])         # narrower than a tile
def test_k3_tiled_edges(dev, dtype, h_in, h_out, w, batch, unaligned):
    """K3's tiles at their edges: heights that are no multiple of the tile,
    widths that are no multiple of 4 or of the tile, a plane whose data
    pointer is not 16-byte aligned (element copies), batch 1 to 16, all
    four input dtypes, against the plain version."""
    rng = np.random.default_rng(14)
    mat = rk.BandedMatrix(_lanczos(h_in, h_out), pre_scale=NORM[dtype])
    x = _planes(rng, dtype, (batch, h_in, w)).to(dev)
    if unaligned:
        x = _unaligned(x)
    got = rk.banded_resize_rows(x, mat)
    torch.cuda.synchronize()
    ref = rk.banded_resize_rows_plain(x, mat)
    assert got.shape == ref.shape == (batch, h_out, w)
    assert (got - ref).abs().max().item() <= 2e-6


def test_k3_shrinks_its_tile_then_refuses_windows_over_the_budget(dev):
    """Box averages of 256 rows into each of 4 need a 256-row window a
    row: K3 makes tiles of one row and still agrees with its plain version;
    8192 rows into 4 does not fit even at one row a tile, so K3 takes its
    long-window route (no window is refused any more), within its band."""
    band = np.zeros((1024, 4), np.float32)
    for j in range(4):
        band[256 * j:256 * (j + 1), j] = 1 / 256
    box = rk.BandedMatrix(band)
    assert rk.k3_tile_rows(4, box) == 1
    x = torch.from_numpy(np.random.default_rng(15).random(
        (2, 1024, 200), dtype=np.float32)).to(dev)
    got = rk.banded_resize_rows(x, box)
    torch.cuda.synchronize()
    assert (got - rk.banded_resize_rows_plain(x, box)).abs().max().item() \
        <= 2e-6
    big = rk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert rk.k3_route(4, big) == ("long-window", rk.K3_TILE_ROWS)
    x = torch.from_numpy(np.random.default_rng(15).integers(
        0, 256, (1, 8192, 8)).astype(np.float32)).to(dev)   # exact sums
    got = rk.banded_resize_rows(x, big)
    torch.cuda.synchronize()
    assert (got - rk.banded_resize_rows_plain(x, big)).abs().max().item() \
        <= 2e-6


def test_k3_is_deterministic(dev):
    rng = np.random.default_rng(16)
    mat = rk.BandedMatrix(_lanczos(1608, 804))
    x = _planes(rng, torch.float32, (2, 1608, 384)).to(dev)
    a = rk.banded_resize_rows(x, mat)
    b = rk.banded_resize_rows(x, mat)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _mmr_curve(ch, pivots, method, order):
    """A curve of channel ``ch`` with these pivots, kinds and MMR orders:
    each polynomial piece near the identity, each MMR piece the channel's
    own linear term near 1 at order 1 with small linear and cross terms
    at each order, its constant and coefficients apart from piece to
    piece."""
    n = len(method)
    poly = np.array([[0.01 * p, 0.97 + 0.01 * p, -0.02] for p in range(n)])
    coef = np.zeros((n, 3, 7))
    for p in range(n):
        coef[p, 0] = [0.01, 0.01, 0.01, 0.02, -0.01, 0.01, 0.005]
        coef[p, 0, ch] = 0.96 + 0.005 * p
        coef[p, 1] = [0.02, -0.01, 0.01, 0.01, 0.005, 0, 0.01]
        coef[p, 2] = [0.005, 0, 0.003, 0, 0, 0.002, 0.003]
    return dovi.ReshapeCurve(
        pivots=pivots, method=method, poly=poly, mmr_order=order,
        mmr_constant=tuple(0.002 * p - 0.005 for p in range(n)),
        mmr_coef=coef)


def _dovi_meta(kind):
    """c8's metadata (identity curves, LMS matrices mutual inverses), a
    variant where nothing folds (p5's structure: a 2-piece polynomial on
    Y, a polynomial + MMR order-2 curve on Cb, an MMR order-3 curve on Cr,
    2% crosstalk), or "limits", the curve structure's limits with the
    variant's LMS step: 8 pieces on Y, polynomial and MMR pieces of orders
    1, 2 and 3 side by side on every channel, so that the pixels of one
    warp (and of one thread's group) fall on different pieces and
    kinds."""
    ycc = np.array([[1, 0, 1.4746], [1, -0.164553, -0.571353],
                    [1, 1.8814, 0]])
    inv = np.linalg.inv(dovi.DOVI_LMS2RGB)
    if kind == "c8":
        return dovi.DoviMetadata(curves=(dovi.identity_curve(),) * 3,
                                 ycc_to_rgb_matrix=ycc,
                                 ycc_to_rgb_offset=np.array([0, 0.5, 0.5]),
                                 rgb_to_lms_matrix=inv)
    if kind == "limits":
        curves = (_mmr_curve(0, (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8),
                             (0, 1, 1, 1, 0, 1, 0, 1),
                             (0, 1, 2, 3, 0, 3, 0, 2)),
                  _mmr_curve(1, (0.4, 0.6), (1, 0, 1), (3, 0, 1)),
                  _mmr_curve(2, (0.5,), (1, 1), (2, 3)))
        return dovi.DoviMetadata(
            curves=curves, ycc_to_rgb_matrix=ycc,
            ycc_to_rgb_offset=np.array([0, 0.5, 0.5]),
            rgb_to_lms_matrix=inv @ (0.94 * np.eye(3) + 0.02))
    cb = np.zeros((2, 3, 7))
    cb[1, 0] = [0, 0.98, 0, 0.02, 0, -0.01, 0]
    cb[1, 1] = [0, 0.01, 0, 0, 0.005, 0, 0.01]
    cr = np.zeros((1, 3, 7))
    cr[0, 0] = [0, 0, 0.97, 0, 0.02, 0.01, 0]
    cr[0, 1] = [0, 0, 0.02, 0.01, 0, 0, 0]
    cr[0, 2] = [0, 0, 0.005, 0, 0, 0, 0.003]
    curves = (
        dovi.ReshapeCurve(pivots=(0.45,), method=(0, 0),
                          poly=np.array([[0.01, 0.95, 0.05],
                                         [-0.02, 1.05, -0.03]])),
        dovi.ReshapeCurve(pivots=(0.5,), method=(0, 1),
                          poly=np.array([[0, 1.0, 0], [0, 0, 0]]),
                          mmr_order=(0, 2), mmr_constant=(0.0, 0.01),
                          mmr_coef=cb),
        dovi.ReshapeCurve(pivots=(), method=(1,), poly=np.array([[0, 1.0, 0]]),
                          mmr_order=(3,), mmr_constant=(-0.005,), mmr_coef=cr))
    return dovi.DoviMetadata(curves=curves, ycc_to_rgb_matrix=ycc,
                             ycc_to_rgb_offset=np.array([0, 0.5, 0.5]),
                             rgb_to_lms_matrix=inv @ (0.94 * np.eye(3) + 0.02))


@pytest.mark.parametrize("maps", ["c8", "blend_no_out", "direct"])
@pytest.mark.parametrize("kind", ["c8", "variant", "limits"])
def test_k8_kernel_matches_plain(dev, kind, maps):
    """c8's geometry (luma read directly, chroma H upsample 540 -> 1080,
    2:1 Catmull-Rom out) on a 1080-row strip, the blend map on the luma
    without an out map, and raw chroma read directly; scene 2's curves."""
    rng = np.random.default_rng(14)
    h, w = (1080, 960) if maps == "c8" else (96, 200)
    norm = 1 / 65535.0
    meta = _dovi_meta(kind)
    m, c = dovi.build_ycc_to_rgb_cmat(meta)
    scene = {k: v * np.float32(0.98) for k, v in dovi.pack_curves(meta).items()}
    mid = dovi.mid_stage(meta, m, c, scene)
    y = torch.from_numpy(rng.integers(64, 941, (2, h, w), dtype=np.uint16)
                         << 6).to(dev)
    if maps == "direct":
        u, v = (torch.from_numpy(rng.integers(64, 961, (2, h, w),
                                              dtype=np.uint16) << 6).to(dev)
                for _ in range(2))
        kin_c, c_scale = None, norm
    else:
        u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (2, h // 2, w))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        _, uy = chroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, C.ChromaScaling.BILINEAR,
            S.ChromaLocation.MPEG2)
        kin_c, c_scale = rk.BandedMatrix(uy), None
    kin_y = (rk.BandedMatrix(chroma.blend_deinterlace_matrix(h),
                             pre_scale=norm) if maps == "blend_no_out"
             else None)
    out = (None if maps == "blend_no_out" else
           rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.CATMULL_ROM, h,
                                                h // 2)))
    h_out = h if out is None else h // 2
    args = (y, u, v, kin_y, kin_c, h, mid, out, h_out)
    kw = dict(y_scale=None if kin_y is not None else norm, c_scale=c_scale)
    before = rk.launches["rows3_mid"]
    got = dk.rows3_mid(*args, **kw)
    torch.cuda.synchronize()
    assert rk.launches["rows3_mid"] == before + 1
    ref = dk.rows3_mid_plain(*args, **kw)
    tol = 1e-5 if kind == "c8" else 1e-4
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, h_out, w) and g.is_contiguous()
        assert (g - r).abs().max().item() <= tol


def _k8_args(rng, kind, h=1080, w=960, batch=2, out_map="c8"):
    """c8's call on an h-row strip: uint16 luma read directly, float32
    chroma with the bilinear H upsample, the Catmull-Rom 2:1 out map (or
    ``out_map`` "edge": a map whose last taps run past h_mid, or "box16": a
    16:1 box average, whose windows need tiles shorter than 32 rows);
    scene 2's curves."""
    meta = _dovi_meta(kind)
    m, c = dovi.build_ycc_to_rgb_cmat(meta)
    scene = {k: v * np.float32(0.98) for k, v in dovi.pack_curves(meta).items()}
    mid = dovi.mid_stage(meta, m, c, scene)
    y = torch.from_numpy(rng.integers(64, 941, (batch, h, w), dtype=np.uint16)
                         << 6).to(dev_of())
    u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (batch, h // 2, w))
                             .astype(np.float32)).to(dev_of())
            for _ in range(2))
    _, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    if out_map == "c8":
        out = scale.upscale_matrix(C.Upscaling.CATMULL_ROM, h, h // 2)
    elif out_map == "edge":
        out = np.zeros((h, h // 2), np.float32)
        for j in range(h // 2 - 1):
            out[2 * j:2 * j + 4, j] = [0.1, 0.4, 0.4, 0.1]
        out[h - 2:, h // 2 - 1] = [0.5, 0.5]
    else:
        out = np.zeros((h, h // 16), np.float32)
        for j in range(h // 16):
            out[16 * j:16 * j + 16, j] = 1 / 16
    kout = rk.BandedMatrix(out)
    return (y, u, v, None, rk.BandedMatrix(uy), h, mid, kout,
            kout.out_size), dict(y_scale=1 / 65535.0)


def _k8_runtime(args, kw):
    """K8 on the launch ``args`` with the uint16 luma as float32 (the same
    values, read with the same scale or in map): the staged runtime route,
    which converts every pixel alone with ExactDiv and pow_pos."""
    before = dk.k8_route_launches[dk.K8_RUNTIME]
    out = dk.rows3_mid(args[0].float(), *args[1:], **kw)
    torch.cuda.synchronize()
    assert dk.k8_route_launches[dk.K8_RUNTIME] == before + 1
    return out


@pytest.mark.parametrize("kind,route", [("c8", "c8 uint16/float32"),
                                        ("variant", "lms uint16/float32"),
                                        ("limits", "lms uint16/float32")])
def test_k8_routes_match_plain(dev, kind, route):
    """c8's metadata takes the compiled c8 route (identity curves, the LMS
    step folded), the variant and the structure's limits the compiled LMS
    route; raw chroma read directly takes the runtime route.  Each agrees
    with the plain version within K8's band, one launch each, counted
    under its route."""
    rng = np.random.default_rng(16)
    args, kw = _k8_args(rng, kind)
    y, u, mid = args[0], args[1], args[6]
    assert dk.rows3_mid_route(y.dtype, u.dtype, mid) == route
    assert dk.rows3_mid_route(y.dtype, torch.uint16, mid) == "runtime"
    # the wrapper's tile rows follow the same choice of route
    assert dk.k8_compiled_route(y.dtype, u.dtype, mid) == route
    assert dk.k8_compiled_route(y.dtype, torch.uint16, mid) == "runtime"
    rk.reset_launches()
    got = dk.rows3_mid(*args, **kw)
    torch.cuda.synchronize()
    assert rk.launches == only(rows3_mid=1)
    assert dk.k8_route_launches == {r: int(r == route)
                                    for r in dk.k8_route_launches}
    ref = dk.rows3_mid_plain(*args, **kw)
    tol = 1e-5 if kind == "c8" else 1e-4
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= tol
    if route == dk.K8_LMS:
        # exactly the runtime route's bits (ExactDiv and pow_pos on every
        # pixel), which the same luma as float32 takes
        runtime = _k8_runtime(args, kw)
        assert all(torch.equal(g, r) for g, r in zip(got, runtime))


@pytest.mark.parametrize("kind", ["c8", "variant", "limits"])
@pytest.mark.parametrize("h,w,batch,out_map,unaligned", [
    (1080, 960, 1, "c8", False),     # 34 16-row tiles: a last group of 2
    (1000, 960, 1, "c8", False),     # 17 31-row tiles, the last of 4 rows
    (200, 200, 3, "c8", False),      # a ragged column tile
    (96, 1001, 2, "c8", False),      # width not a multiple of 4
    (96, 130, 2, "edge", True),      # taps past h_mid; unaligned planes
    (2048, 128, 1, "box16", False),  # windows that need 16-row tiles
])
def test_k8_tiled_edges(dev, monkeypatch, kind, h, w, batch, out_map,
                        unaligned):
    """The tiled K8 at shapes the path's tiles do not divide (a last group
    of tiles shorter than K8_TILES_PER_BLOCK, a ragged last tile, a ragged
    column tile, a width that is not a multiple of the 4 columns a thread
    converts), unaligned pointers (element copies and scalar loads), an
    out map whose last taps run past h_mid, and a steep downscale whose
    window shrinks the tile; within K8's band of the plain version.  The
    LMS route (the variant, the structure's limits) gives the bits of the
    long-window route, whose runtime convert takes one pixel at a time."""
    rng = np.random.default_rng(17)
    args, kw = _k8_args(rng, kind, h=h, w=w, batch=batch, out_map=out_map)
    if unaligned:
        args = (*(_unaligned(p) for p in args[:3]), *args[3:])
    if out_map == "box16":
        n_vals = args[6].host_values().size
        assert dk.k8_tile_rows(2, 4, None, args[4], args[7], h, n_vals) < 32
    if (h, out_map) == (1000, "c8"):
        n_tiles = -(-args[8] // dk.K8_LMS_TILE_ROWS)
        assert n_tiles % dk.K8_TILES_PER_BLOCK == 1
        assert args[8] % dk.K8_LMS_TILE_ROWS == 4
    got = dk.rows3_mid(*args, **kw)
    torch.cuda.synchronize()
    ref = dk.rows3_mid_plain(*args, **kw)
    tol = 1e-5 if kind == "c8" else 1e-4
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.is_contiguous()
        assert (g - r).abs().max().item() <= tol
    if kind != "c8":
        assert dk.k8_compiled_route(args[0].dtype, args[1].dtype,
                                    args[6]) == dk.K8_LMS
        monkeypatch.setattr(dk, "K8_LONG_WINDOW", True)
        rk.reset_launches()
        lw = dk.rows3_mid(*args, **kw)
        torch.cuda.synchronize()
        assert dk.k8_route_launches[dk.K8_LONG] == 1
        assert all(torch.equal(g, z) for g, z in zip(got, lw))


def test_k8_is_deterministic(dev):
    """Two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(18)
    args, kw = _k8_args(rng, "variant", h=256, w=512)
    a = torch.stack(dk.rows3_mid(*args, **kw))
    b = torch.stack(dk.rows3_mid(*args, **kw))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k8_refuses_windows_over_its_budget(dev):
    """An out map where every output reads 512 of 1024 mid rows: its
    window fits a block at no tile size, so K8 takes its long-window route
    (no window is refused any more), within its band of the plain
    version."""
    rng = np.random.default_rng(19)
    args, kw = _k8_args(rng, "c8", h=96, w=64)
    full = rk.BandedMatrix(np.kron(np.eye(2), np.full((512, 1), 1 / 512))
                           .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 65535, (1, 1024, 64),
                                      dtype=np.uint16)).to(dev)
    c = torch.from_numpy(rng.random((1, 1024, 64), dtype=np.float32)).to(dev)
    call = (y, c, c, None, None, 1024, args[6], full, 2)
    kw = dict(y_scale=1 / 65535.0, c_scale=1.0)
    assert dk.k8_route(2, 4, None, None, full, 1024,
                       args[6].host_values().size)[0] == "long-window"
    got = dk.rows3_mid(*call, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, dk.rows3_mid_plain(*call, **kw)):
        assert (g - r).abs().max().item() <= 1e-5


def _dovi_plan(w, h, ow, oh, kind="variant", accel=True):
    return P.plan_pipeline(
        C.Settings(convert_to_sdr=True, upscaling=C.Upscaling.CATMULL_ROM,
                   use_accel_backend=accel),
        P.SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                           matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                           primaries=S.Primaries.BT_2020, transfer=S.TRC.PQ,
                           dovi=_dovi_meta(kind), hdr10=P.HDR10Metadata()),
        P.OutputDescriptor(width=ow, height=oh, bits=10))


def _p010(rng, n, w, h):
    return tuple(torch.from_numpy(a) for a in (
        rng.integers(64, 941, (n, h, w), dtype=np.uint16) << 6,
        rng.integers(64, 961, (n, h // 2, w // 2), dtype=np.uint16) << 6,
        rng.integers(64, 961, (n, h // 2, w // 2), dtype=np.uint16) << 6))


@pytest.mark.parametrize("kind,route", [("variant", "lms uint16/float32"),
                                        ("c8", "c8 uint16/float32")])
def test_dovi_serving_on_card_matches_cpu(dev, kind, route):
    """The serving function at a small size over two scenes: K1 ×2 + K8 +
    K9 per call on the card, within 1 code of the CPU's plain route; a
    call of the variant (p5's structure) makes one launch of K8's LMS
    route, a call of c8's metadata one of its c8 route."""
    rng = np.random.default_rng(15)
    plan = _dovi_plan(256, 128, 128, 64, kind)
    fn = P.make_serving_fn(plan, pack_surface=True)
    planes = _p010(rng, 2, 256, 128)
    for i in (0, 3):
        rt = {"dovi_curves": {k: v * np.float32(1 - 0.01 * i) for k, v in
                              fn.pack_curves(plan.dovi).items()}}
        rk.reset_launches()
        got = fn(tuple(p.to(dev) for p in planes), rt)
        torch.cuda.synchronize()
        assert rk.launches == only(banded_resize_last_axis=2, rows3_mid=1,
                                   cols3_tail=1)
        assert dk.k8_route_launches == {r: int(r == route)
                                        for r in dk.k8_route_launches}
        ref = fn(planes, rt)
        assert got.shape == ref.shape == (2, 64, 128)
        d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02


def _stage_a_args(rng, kind, dtypes, h, w, batch, blend=False):
    """A call of K2's Dolby Vision route (stage A of the two-stage form):
    uint16 luma, read directly or through the blend map; "u16/f32": K1's
    float32 chroma through the bilinear H upsample, "u16/u16": raw 4:4:4
    chroma read directly; a scene's runtime curves (several pieces in the
    variant)."""
    meta = _dovi_meta(kind)
    m, c = dovi.build_ycc_to_rgb_cmat(meta)
    scene = {k: v * np.float32(0.98) for k, v in dovi.pack_curves(meta).items()}
    mid = dovi.mid_stage(meta, m, c, scene)
    norm = 1 / 65535.0
    y = torch.from_numpy(rng.integers(64, 941, (batch, h, w), dtype=np.uint16)
                         << 6)
    if dtypes == "u16/u16":
        u, v = (torch.from_numpy(rng.integers(64, 961, (batch, h, w),
                                              dtype=np.uint16) << 6)
                for _ in range(2))
        kin_c, c_scale = None, norm
    else:
        u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (batch, h // 2, w))
                                 .astype(np.float32)) for _ in range(2))
        _, uy = chroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, C.ChromaScaling.BILINEAR,
            S.ChromaLocation.MPEG2)
        kin_c, c_scale = rk.BandedMatrix(uy), None
    kin_y = (rk.BandedMatrix(chroma.blend_deinterlace_matrix(h),
                             pre_scale=norm) if blend else None)
    return ((y.to(dev_of()), u.to(dev_of()), v.to(dev_of()), kin_y, kin_c, h,
             mid), dict(y_scale=None if blend else norm, c_scale=c_scale))


@pytest.mark.parametrize("kind", ["c8", "variant"])
@pytest.mark.parametrize("dtypes", ["u16/f32", "u16/u16"])
@pytest.mark.parametrize("h,w,batch,blend,unaligned", [
    (1080, 960, 2, False, False),   # c8's strip: 34 row tiles
    (200, 1001, 3, False, False),   # ragged tiles, width not a multiple of 4
    (96, 130, 2, True, True),       # the blend map; unaligned planes
    (40, 64, 1, False, False),      # one frame, a last tile of 8 rows
])
def test_k2_dovi_route_matches_plain(dev, kind, dtypes, h, w, batch, blend,
                                     unaligned):
    """K2's Dolby Vision route against its plain version, one launch: c8's
    metadata (the light route on uint16/float32) and the variant (the LMS
    route), the runtime route on uint16/uint16; within 1e-5, 1e-4 with the
    LMS step (K8's band)."""
    rng = np.random.default_rng(20)
    args, kw = _stage_a_args(rng, kind, dtypes, h, w, batch, blend)
    if unaligned:
        args = (*(_unaligned(p) for p in args[:3]), *args[3:])
    before = rk.launches["rows3_tail_dovi"]
    got = rk.rows3_tail_dovi(*args, **kw)
    torch.cuda.synchronize()
    assert rk.launches["rows3_tail_dovi"] == before + 1
    ref = rk.rows3_tail_dovi_plain(*args, **kw)
    assert got.shape == ref.shape == (batch, 3, h, w)
    assert all(got[:, i].is_contiguous() for i in range(3))
    tol = 1e-5 if kind == "c8" else 1e-4
    assert (got - ref).abs().max().item() <= tol


def test_k2_dovi_route_is_deterministic(dev):
    rng = np.random.default_rng(21)
    args, kw = _stage_a_args(rng, "variant", "u16/f32", 256, 512, 2)
    a = rk.rows3_tail_dovi(*args, **kw)
    b = rk.rows3_tail_dovi(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k2_dovi_route_refuses_long_windows(dev):
    """A map whose windows do not fit shared memory raises before a launch:
    the route has no long-window form."""
    rng = np.random.default_rng(22)
    args, _ = _stage_a_args(rng, "c8", "u16/f32", 32, 64, 1)
    full = rk.BandedMatrix(np.full((2160, 16), 1 / 2160, np.float32))
    y = torch.zeros((1, 16, 64), dtype=torch.uint16, device=dev)
    c = torch.zeros((1, 2160, 64), dtype=torch.float32, device=dev)
    before = rk.launches["rows3_tail_dovi"]
    with pytest.raises(ValueError, match="no long-window route"):
        rk.rows3_tail_dovi(y, c, c, None, full, 16, args[6],
                           y_scale=1 / 65535.0)
    assert rk.launches["rows3_tail_dovi"] == before


@pytest.mark.parametrize("placed", [False, True])
def test_dovi_two_stage_serving_on_card_matches_cpu(dev, placed,
                                                    monkeypatch):
    """The two-stage form (VRT_TPU_DOVI_MID=0) at a small size over two
    scenes: K1 ×5 + K2's Dolby Vision route + K2 per call on the card (the
    offset store for a placed plan), within 1 code of the CPU's plain
    route, the bars the packed zero."""
    monkeypatch.setenv("VRT_TPU_DOVI_MID", "0")
    rng = np.random.default_rng(23)
    plan = _dovi_plan(256, 128, 128, 64)
    if placed:
        plan = P.plan_pipeline(plan.settings, plan.src, P.OutputDescriptor(
            width=160, height=96, bits=10, video_rect=(16, 8, 144, 72)))
    fn = P.make_serving_fn(plan, pack_surface=True)
    planes = _p010(rng, 2, 256, 128)
    for i in (0, 3):
        rt = {"dovi_curves": {k: v * np.float32(1 - 0.01 * i) for k, v in
                              fn.pack_curves(plan.dovi).items()}}
        rk.reset_launches()
        got = fn(tuple(p.to(dev) for p in planes), rt)
        torch.cuda.synchronize()
        assert rk.launches == only(banded_resize_last_axis=5,
                                   rows3_tail_dovi=1, rows3_tail=1)
        ref = fn(planes, rt)
        assert got.shape == ref.shape
        d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        if placed:
            bars = torch.cat([got[:, :8], got[:, 72:]], dim=1).cpu()
            assert torch.all(bars == -1073741824)


def test_letterbox_on_card_matches_cpu(dev):
    """A 2.39:1 film letterboxed into 16:9 at a small size: K1 ×3 + K2
    with the rect's offset per call on the card, within 1 code of the CPU,
    the bars the packed zero."""
    rng = np.random.default_rng(16)
    plan = P.plan_pipeline(
        C.Settings(upscaling=C.Upscaling.LANCZOS3, convert_to_sdr=True),
        P.SourceDescriptor(format=ColorFormat.P010, width=384, height=160,
                           matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                           primaries=S.Primaries.BT_2020, transfer=S.TRC.PQ,
                           hdr10=P.HDR10Metadata()),
        P.OutputDescriptor(width=192, height=108, bits=10,
                           video_rect=(0, 14, 192, 94)))
    fn = P.make_frame_fn(plan, pack_surface=True)
    planes = _p010(rng, 2, 384, 160)
    rk.reset_launches()
    got = fn(tuple(p.to(dev) for p in planes))
    torch.cuda.synchronize()
    assert rk.launches == only(banded_resize_last_axis=3, rows3_tail=1)
    ref = fn(planes)
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    bars = torch.cat([got[:, :14], got[:, 94:]], dim=1).cpu()
    assert torch.all(bars == -1073741824)


# --- the local tone map in K2's tail, HLG -> PQ, K4, c7 -----------------------

C7_META = dict(mastering_max_nits=4000.0, max_cll=3000.0, max_fall=800.0)


def _c7_plan(w=64, h=36, sel="BT2390", display=600, transfer="PQ",
             local=True, accel=True, hdr10plus=None, dovi_trims=None,
             **meta):
    """A c7-shaped plan (P010 HDR10 1:1 -> RGB10 PQ, the local tone map of
    selection ``sel`` for a ``display``-nit display) at a small size; with
    ``hdr10plus`` metadata (c7p: its guided curve, selection 7) or L2
    ``dovi_trims``."""
    return P.plan_pipeline(
        C.Settings(convert_to_sdr=False, hdr_passthrough=True,
                   hdr_local_tone_mapping=local,
                   hdr_local_tone_mapping_type=C.ToneMapType[sel],
                   hdr_display_max_nits=display, use_accel_backend=accel),
        P.SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                           matrix=S.CSP.BT_2020_NC,
                           primaries=S.Primaries.BT_2020,
                           transfer=S.TRC[transfer],
                           hdr10=P.HDR10Metadata(**{**C7_META, **meta}),
                           hdr10plus=hdr10plus, dovi_trims=dovi_trims),
        P.OutputDescriptor(width=w, height=h, bits=10, hdr=True))


# c7p's HDR10+ metadata (one window with a guided curve: knee (0.25, 0.3),
# anchors 0.4, 0.7, 0.9, a 4000-nit scene peak) and a set of L2 trims
GUIDED = hdr10plus.HDR10PlusMetadata(windows=(hdr10plus.HDR10PlusWindow(
    maxscl=(0.4, 0.4, 0.4), average_maxrgb=0.05, tone_mapping_flag=1,
    knee_point_x=0.25, knee_point_y=0.3,
    bezier_curve_anchors=(0.4, 0.7, 0.9)),))
TRIMS = tm_ops.DoviTrims(chroma_weight=0.05, saturation_gain=0.1,
                         trim_slope=1.1, trim_offset=-0.02, trim_power=0.9,
                         l2_enabled=True)


def _dovi_ext():
    """c8x's extension blocks: L1 (62, 3079, 1229) and L2 trims for 100,
    600 and 1000-nit targets."""
    def l2(nits, **kw):
        return dovi_ext.L2Extension(
            target_max_pq=int(round(dovi_ext.nits_to_pq(nits) * 4095)), **kw)
    return dovi_ext.DoviExtensions(
        l1=dovi_ext.L1Extension(min_pq=62, max_pq=3079, avg_pq=1229),
        l2=(l2(100, trim_slope=1800, trim_offset=2100, trim_power=2200,
               trim_chroma_weight=2148, trim_saturation_gain=2348),
            l2(600, trim_slope=2000, trim_power=1900,
               trim_saturation_gain=2148),
            l2(1000, trim_slope=2200)))


def _dovi_ext_epi(hdr):
    """K9's epilogue of c8x (Dolby Vision to SDR with the PQ-domain trims)
    or of c8hdr (to a 600-nit HDR display: the trims in nits, then ST
    2094-10 by the L1 upgrade)."""
    settings = (C.Settings(convert_to_sdr=False, hdr_passthrough=True,
                           hdr_local_tone_mapping=True,
                           hdr_local_tone_mapping_type=C.ToneMapType.BT2390,
                           hdr_display_max_nits=600) if hdr else
                C.Settings(convert_to_sdr=True, hdr_display_max_nits=100))
    plan = P.plan_pipeline(
        settings,
        P.SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                           matrix=S.CSP.BT_2020_NC,
                           primaries=S.Primaries.BT_2020, transfer=S.TRC.PQ,
                           dovi=_dovi_meta("c8"), dovi_ext=_dovi_ext(),
                           hdr10=P.HDR10Metadata()),
        P.OutputDescriptor(width=64, height=32, bits=10, hdr=hdr))
    epi = P._make_tail_epilogue(plan, with_cmat=False)
    assert epi.trims is not None and epi.trims_pq == (not hdr)
    assert epi.tonemap == (6 if hdr else 0)
    return epi


def _c7_k2_inputs(rng, n=2, w=64, h=36):
    """c7's K2 call: raw uint16 luma read directly, mid16 chroma with the
    bilinear H upsample."""
    _, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    y = torch.from_numpy(rng.integers(64, 941, (n, h, w), dtype=np.uint16) << 6)
    u = torch.from_numpy(rng.integers(1000, 15600, (n, h // 2, w)).astype(np.int16))
    v = torch.from_numpy(rng.integers(1000, 15600, (n, h // 2, w)).astype(np.int16))
    return y, u, v, rk.BandedMatrix(uy, pre_scale=1.0 / rk.MID16_SCALE)


SCENE = {"mastering_min_nits": 0.005, "mastering_max_nits": 2000.0,
         "max_cll": 1400.0, "max_fall": 450.0, "display_max_nits": 650.0}


@pytest.mark.parametrize("passthrough", [False, True])
@pytest.mark.parametrize("route", ["static", "serving"])
@pytest.mark.parametrize("sel", ["ACES", "REINHARD", "HABLE", "MOBIUS",
                                 "BT2390", "ST2094_10"])
def test_k2_local_tonemap_matches_plain(dev, sel, route, passthrough):
    """K2 with each local tone map (selections 1-6), its scalars from the
    plan (float64 on the host) or from a scene (float32), and with a
    display at least as bright as the source (the PQ round trip alone for
    5 and 6): within 1 code on < 2% of the channels."""
    rng = np.random.default_rng(20)
    plan = _c7_plan(sel=sel, display=1500 if passthrough else 600,
                    **(dict(max_cll=800.0) if passthrough else {}))
    hdr = None
    if route == "serving":
        hdr = dict(SCENE, display_max_nits=1500.0) if passthrough else SCENE
    epi = P._make_tail_epilogue(
        plan, rt=None if hdr is None else {"hdr": hdr})
    assert epi.tonemap == C.ToneMapType[sel]
    y, u, v, mc = _c7_k2_inputs(rng)
    args = (y.to(dev), u.to(dev), v.to(dev), None, mc, 36, epi)
    kw = dict(y_scale=1 / 65535.0, pack_format="rgb10a2")
    got = rk.rows3_tail(*args, **kw)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*args, **kw)
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


GUIDED_CASES = {
    # the plan's metadata (float64 scalars), a scene's (float32), a display
    # at least as bright as the scene peak (the round trip through nits)
    "guided": dict(hdr10plus=GUIDED),
    "guided_serving": dict(hdr10plus=GUIDED, hdr=SCENE),
    "guided_bright": dict(hdr10plus=GUIDED, display=5000),
    "guided_trims": dict(hdr10plus=GUIDED, dovi_trims=TRIMS),
    **{f"trims_{sel}": dict(sel=sel, dovi_trims=TRIMS)
       for sel in ("ACES", "REINHARD", "HABLE", "MOBIUS", "BT2390",
                   "ST2094_10")},
    "trims_bright": dict(sel="BT2390", dovi_trims=TRIMS, display=5000),
}


@pytest.mark.parametrize("case", list(GUIDED_CASES))
def test_k2_guided_and_trims_match_plain(dev, case):
    """K2's runtime route with the HDR10+ guided curve (selection 7) and
    with the linear-domain L2 trims before each selection (5 and 6 in
    their general forms): within 1 code on < 2% of the channels."""
    rng = np.random.default_rng(22)
    kw = dict(GUIDED_CASES[case])
    hdr = kw.pop("hdr", None)
    plan = _c7_plan(**kw)
    epi = P._make_tail_epilogue(
        plan, rt=None if hdr is None else {"hdr": hdr})
    assert (epi.tonemap == 7) == ("hdr10plus" in kw)
    assert (epi.trims is not None) == ("dovi_trims" in kw)
    y, u, v, mc = _c7_k2_inputs(rng)
    args = (y.to(dev), u.to(dev), v.to(dev), None, mc, 36, epi)
    kw = dict(y_scale=1 / 65535.0, pack_format="rgb10a2")
    assert rk.rows3_tail_route(torch.uint16, torch.int16, epi,
                               "rgb10a2") == "runtime"
    before = rk.launches["rows3_tail"]
    got = rk.rows3_tail(*args, **kw)
    torch.cuda.synchronize()
    assert rk.launches["rows3_tail"] == before + 1
    ref = rk.rows3_tail_plain(*args, **kw)
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("local", [False, True])
def test_k2_hlg_to_pq_matches_plain(dev, local):
    """HLG passthrough: the OOTF and the PQ OETF at 1000 nits inside K2,
    with and without the BT.2390 tone map after it."""
    rng = np.random.default_rng(21)
    plan = _c7_plan(transfer="HLG", local=local)
    epi = P._make_tail_epilogue(plan)
    assert epi.correction == rk.CORR_HLG_TO_PQ
    y, u, v, mc = _c7_k2_inputs(rng)
    args = (y.to(dev), u.to(dev), v.to(dev), None, mc, 36, epi)
    kw = dict(y_scale=1 / 65535.0, pack_format="rgb10a2")
    got = rk.rows3_tail(*args, **kw)
    torch.cuda.synchronize()
    d = np.abs(_codes(got, "rgb10a2")
               - _codes(rk.rows3_tail_plain(*args, **kw), "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def _k4_case(rng, kind):
    """K4's two geometries at a small size: ``headline``, 4:2:0 P010 with a
    2:1 Lanczos3 downscale (maps on both axes of every plane) and the
    headline's PQ -> SDR tail; ``c7``, 1:1 (luma direct, chroma upsampled)
    with c7's BT.2390 tail."""
    if kind == "headline":
        h, w, oh, ow = 256, 512, 128, 256
        wx, wy = _lanczos(w, ow), _lanczos(h, oh)
        ux, uy = chroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, C.ChromaScaling.BILINEAR,
            S.ChromaLocation.MPEG2)
        maps = (wx, ux @ wx, wy, uy @ wy)
        plan = P.plan_pipeline(
            C.Settings(upscaling=C.Upscaling.LANCZOS3, convert_to_sdr=True),
            P.SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                               matrix=S.CSP.BT_2020_NC,
                               primaries=S.Primaries.BT_2020,
                               transfer=S.TRC.PQ, hdr10=P.HDR10Metadata()),
            P.OutputDescriptor(width=ow, height=oh, bits=10))
    else:
        h, w, oh = 72, 128, 72
        ux, uy = chroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, C.ChromaScaling.BILINEAR,
            S.ChromaLocation.MPEG2)
        maps = (None, ux, None, uy)
        plan = _c7_plan(w=w, h=h)
    planes = _p010(rng, 2, w, h)
    (ky, hy), (kc, hc) = (rk.mega_maps(maps[0], maps[2], 1 / 65535.0),
                          rk.mega_maps(maps[1], maps[3], 1 / 65535.0))
    return planes, (ky, kc, hy, hc, oh), plan


@pytest.mark.parametrize("tail", ["cmat", "full"])
@pytest.mark.parametrize("kind", ["headline", "c7"])
def test_k4_kernel_matches_plain(dev, kind, tail):
    """K4 at both geometries: with the colour matrix only (float32 within
    1e-5) and with the plan's whole tail (dithered float, within 1 code on
    < 2% of the channels)."""
    rng = np.random.default_rng(22)
    planes, maps, plan = _k4_case(rng, kind)
    epi = (P.cmat_epilogue(np.concatenate(
        [np.asarray(plan.cmat_m, np.float32),
         np.asarray(plan.cmat_c, np.float32)[:, None]], 1))
        if tail == "cmat" else P._make_tail_epilogue(plan))
    args = (*(p.to(dev) for p in planes), *maps, epi, 1 / 65535.0)
    assert rk.k4_route(2, 2, *maps[:4])[0] == "staged"
    assert rk.mega3_tail_route(torch.uint16, torch.uint16, epi) == K4_ROUTES[
        "matrix" if tail == "cmat" else kind]
    before = rk.launches["mega3_tail"]
    got = rk.mega3_tail(*args)
    torch.cuda.synchronize()
    assert rk.launches["mega3_tail"] == before + 1
    _k4_close(got, rk.mega3_tail_plain(*args), tail)


# the compiled route each of phase 19's tails takes on the raw P010 planes
K4_ROUTES = {"headline": "headline planar uint16", "c7": "c7 planar uint16",
             "matrix": "matrix planar uint16"}


def _k4_close(got, ref, tail):
    """K4's bands: float32 within 1e-5 with the colour matrix only, dithered
    float within 1 code on < 2% of the channels with a whole tail."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    if tail == "cmat":
        assert (got - ref).abs().max().item() <= 1e-5
    else:
        d = ((got - ref).abs() * 1023).round().cpu().numpy()
        assert d.max() <= 1 and (d > 0).mean() < 0.02


def _k4_both(monkeypatch, args):
    """K4 on its staged route and with the long-window route forced, one
    launch each; the two outputs must be bit-equal."""
    before = rk.launches["mega3_tail"]
    staged = rk.mega3_tail(*args)
    with monkeypatch.context() as mp:
        mp.setattr(rk, "K4_LONG_WINDOW", True)
        got = rk.mega3_tail(*args)
    torch.cuda.synchronize()
    assert rk.launches["mega3_tail"] == before + 2
    assert torch.equal(got, staged)
    return staged


@pytest.mark.parametrize("tail", ["cmat", "full"])
@pytest.mark.parametrize("kind", ["headline", "c7"])
def test_k4_long_window_bit_equal_to_staged(dev, kind, tail, monkeypatch):
    """On maps both routes take, K4's long-window route (forced) gives the
    staged route's bits, and both the plain version's band."""
    rng = np.random.default_rng(43)
    planes, maps, plan = _k4_case(rng, kind)
    epi = (P.cmat_epilogue(np.concatenate(
        [np.asarray(plan.cmat_m, np.float32),
         np.asarray(plan.cmat_c, np.float32)[:, None]], 1))
        if tail == "cmat" else P._make_tail_epilogue(plan))
    args = (*(p.to(dev) for p in planes), *maps, epi, 1 / 65535.0)
    _k4_close(_k4_both(monkeypatch, args), rk.mega3_tail_plain(*args), tail)


def _k4_ragged(rng, dev, dtype, h, w, oh, ow, w_map, h_map, unaligned):
    """Planes of ``dtype`` (4:2:0: chroma h/2 x w/2) and their K4 maps at
    ``oh`` x ``ow`` (Lanczos3, the chroma composed with a bilinear
    upsample), without the W or the H maps where ``w_map``/``h_map`` are
    False (that axis keeps its size: ow = w or oh = h, the chroma upsample
    alone)."""
    norm = NORM[dtype]
    ux, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, C.ChromaScaling.BILINEAR,
        S.ChromaLocation.MPEG2)
    wx = _lanczos(w, ow) if w_map else None
    wy = _lanczos(h, oh) if h_map else None
    (ky, hy) = rk.mega_maps(wx, wy, norm)
    (kc, hc) = rk.mega_maps(ux if wx is None else ux @ wx,
                            uy if wy is None else uy @ wy, norm)
    planes = [_planes(rng, dtype, s).to(dev)
              for s in ((2, h, w), (2, h // 2, w // 2), (2, h // 2, w // 2))]
    if unaligned:
        planes = [_unaligned(q) for q in planes]
    return planes, (ky, kc, hy, hc, oh), norm


K4_RAGGED = [
    # dtype, h, w, oh, ow, W map, H map, unaligned pointers
    (torch.uint16, 90, 250, 45, 125, True, True, False),
    (torch.uint16, 88, 256, 44, 128, True, True, True),
    (torch.uint8, 72, 202, 36, 101, True, True, False),
    (torch.int16, 100, 300, 50, 150, True, True, False),
    (torch.float32, 70, 198, 35, 99, True, True, False),
    (torch.uint16, 72, 250, 72, 125, True, False, False),
    (torch.uint8, 90, 202, 45, 202, False, True, False),
    (torch.float32, 66, 134, 66, 134, False, False, False),
]


@pytest.mark.parametrize("tail", ["cmat", "full"])
@pytest.mark.parametrize("case", K4_RAGGED,
                         ids=[f"{c[0]}".split(".")[-1] + f"-{c[2]}x{c[1]}-"
                              f"{c[4]}x{c[3]}-w{int(c[5])}h{int(c[6])}"
                              f"{'-unaligned' if c[7] else ''}"
                              for c in K4_RAGGED])
def test_k4_ragged_edges_dtypes_and_missing_maps(dev, case, tail,
                                                 monkeypatch):
    """K4 where w_out is no multiple of the strip or of 4, h_out no
    multiple of the tile, rows not 16-byte aligned (odd byte widths,
    pointers one element in), uint8, int16 and float32 planes (the runtime
    tail), and planes without a W map, an H map or both (read directly):
    the staged and the forced long-window route bit-equal, both within the
    plain version's band."""
    rng = np.random.default_rng(44)
    dtype, h, w, oh, ow, w_map, h_map, unaligned = case
    planes, maps, norm = _k4_ragged(rng, dev, dtype, h, w, oh, ow, w_map,
                                    h_map, unaligned)
    epi = (P.cmat_epilogue(np.asarray(
        [[1.0, 0.0, 1.4, -0.7], [1.0, -0.2, -0.7, 0.45],
         [1.0, 1.8, 0.0, -0.9]], np.float32)) if tail == "cmat"
        else P._make_tail_epilogue(_k4_case(rng, "headline")[2]))
    args = (*planes, *maps, epi, norm)
    if dtype != torch.uint16:
        assert rk.mega3_tail_route(dtype, dtype, epi) == "runtime"
    _k4_close(_k4_both(monkeypatch, args), rk.mega3_tail_plain(*args), tail)


@pytest.mark.parametrize("down", [C.Downscaling.HAMMING,
                                  C.Downscaling.LANCZOS])
def test_k4_strong_downscale_takes_the_long_window_route(dev, down):
    """A 4K thumbnail's row ratio (2160 -> 68, as a 120 x 68 thumbnail) at a
    narrower width: K4 picks its long-window route on its own, in one
    launch, within the plain version's band with the headline's tail."""
    rng = np.random.default_rng(45)
    h, w, oh, ow = 2160, 960, 68, 40
    wx, wy, cwx, cwy = _thumb_maps(h, w, oh, ow, down)
    (ky, hy), (kc, hc) = (rk.mega_maps(wx, wy, 1 / 65535.0),
                          rk.mega_maps(cwx, cwy, 1 / 65535.0))
    assert rk.k4_route(2, 2, ky, kc, hy, hc)[0] == "long-window"
    planes = tuple(p.to(dev) for p in _p010(rng, 2, w, h))
    epi = P._make_tail_epilogue(_k4_case(rng, "headline")[2])
    args = (*planes, ky, kc, hy, hc, oh, epi, 1 / 65535.0)
    before = rk.launches["mega3_tail"]
    got = rk.mega3_tail(*args)
    torch.cuda.synchronize()
    assert rk.launches["mega3_tail"] == before + 1
    _k4_close(got, rk.mega3_tail_plain(*args), "full")


def test_c7_serving_on_card_matches_cpu(dev):
    """c7's serving function at a small size over two scenes: K1 ×2 + K2
    per call on the card, no build between scenes, within 1 code of the
    CPU's plain route."""
    from videorenderer_tpu_torch.kernels import build
    rng = np.random.default_rng(23)
    plan = _c7_plan(w=128, h=72)
    fn = P.make_serving_fn(plan, pack_surface=True)
    assert fn.allowed_rt_keys == {"cmat", "hdr"}
    planes = _p010(rng, 2, 128, 72)
    lib = build.load()
    outs = []
    for i in (0, 3):
        rt = {"hdr": dict(SCENE, max_cll=1200.0 + 100.0 * i)}
        rk.reset_launches()
        got = fn(tuple(p.to(dev) for p in planes), rt)
        torch.cuda.synchronize()
        assert rk.launches == only(banded_resize_last_axis=2, rows3_tail=1)
        ref = fn(planes, rt)
        assert got.shape == ref.shape == (2, 72, 128)
        d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        outs.append(got.cpu())
    assert build.load() is lib
    assert not torch.equal(outs[0], outs[1])


def _bench_config(name, w, h, ow, oh):
    """A configuration of the port's benchmark (``vrbench/configs``) at a
    small size."""
    from vrbench import spec
    c = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    c["video_source"].update(width=w, height=h)
    c["output"].update(width=ow, height=oh)
    return c


def test_k2_route_counter(dev):
    """K2's launches by route (``rk.k2_route_launches``): serving calls of
    the HDR10 passthrough cell's configuration at 128 x 72 with two
    scenes' HDR10 values take the compiled c7 route only; a call of the
    HDR10 -> SDR cell's configuration (128 x 72 -> 64 x 36) its headline
    route only; ``reset_launches`` zeroes both counters."""
    from vrbench.entries import common, serving_hdr10
    rng = np.random.default_rng(25)
    c7 = _bench_config("hdr10_uhd_to_hdr600_bt2390", 128, 72, 128, 72)
    fn = P.make_serving_fn(P.plan_pipeline(
        serving_hdr10.settings(c7), common.source(c7), common.output(c7)),
        pack_surface=True)
    planes = tuple(p.to(dev) for p in _p010(rng, 2, 128, 72))
    rk.reset_launches()
    for max_cll in (3000.0, 2820.0):
        fn(planes, {"hdr": {"mastering_min_nits": 0.005,
                            "mastering_max_nits": 4000.0,
                            "max_cll": max_cll, "max_fall": 800.0}})
    torch.cuda.synchronize()
    assert rk.launches == only(banded_resize_last_axis=4, rows3_tail=2)
    assert {k: v for k, v in rk.k2_route_launches.items() if v} == {
        "c7 uint16/int16": 2}
    hl = _bench_config("hdr10_uhd_to_sdr1080", 128, 72, 64, 36)
    fn = P.make_serving_fn(P.plan_pipeline(
        common.settings(hl), common.source(hl), common.output(hl)),
        pack_surface=True)
    rk.reset_launches()
    assert set(rk.k2_route_launches.values()) == {0}
    fn(planes)
    torch.cuda.synchronize()
    assert rk.launches == only(banded_resize_last_axis=3, rows3_tail=1)
    assert {k: v for k, v in rk.k2_route_launches.items() if v} == {
        "headline int16": 1}
    rk.reset_launches()
    assert set(rk.k2_route_launches.values()) == {0}
    assert set(rk.launches.values()) == {0}


def _k6_counted(fn):
    """``fn()`` under a profiler from zeroed counters: (its output, the
    ``vrt.build.jinc2_table`` spans it opened, K6's launches by route)."""
    from videorenderer_tpu_torch.utils import trace
    rk.reset_launches()
    trace.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    torch.cuda.synchronize()
    builds = sum(s.name == "vrt.build.jinc2_table" for s in trace.spans())
    trace.clear_spans()
    return out, builds, {k: v for k, v in rk.k6_route_launches.items() if v}


def test_k6_route_counter_and_table_build(dev, monkeypatch):
    """K6's launches by route (``rk.k6_route_launches``) and the weight
    table's build span, through ``VideoProcessor.process`` of the Jinc2
    cell's configuration at 480 x 270 -> 960 x 540: the first call takes
    one "table" launch and builds its table (one ``vrt.build.jinc2_table``
    span, one table launch), the second builds nothing; the surface is
    within 1 code of the benchmark's reference on under 0.2% of the
    channels (tests/test_torch_jinc2_cell.py's band).  c3rot's plan
    (rotation 90 + flip) takes "table transposed"; with the cap at 0,
    "per-output"."""
    from vrbench.entries import common
    from vrbench.reference import sdr_jinc2
    from vrbench.surfaces import rgba8
    cfg = _bench_config("sdr1080_nv12_to_uhd_jinc2", 480, 270, 960, 540)
    vp = P.VideoProcessor(common.settings(cfg), common.source(cfg),
                          common.output(cfg), device=dev, pack_surface=True)
    assert P.route_of(vp.plan) == "staged"
    rng = np.random.default_rng(27)
    planes = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(16, 236, (2, 270, 480), dtype=np.uint8),
        rng.integers(16, 241, (2, 135, 240), dtype=np.uint8),
        rng.integers(16, 241, (2, 135, 240), dtype=np.uint8)))
    jk.clear_weight_tables()
    first, builds, routes = _k6_counted(lambda: vp.process(planes))
    assert builds == 1 and routes == {"table": 1}
    assert rk.launches == only(jinc2_convert_fused=1, jinc2_weight_table=1)
    second, builds, routes = _k6_counted(lambda: vp.process(planes))
    assert builds == 0 and routes == {"table": 1}
    assert rk.launches == only(jinc2_convert_fused=1)
    assert torch.equal(first, second) and first.shape == (2, 540, 960)
    for f in range(2):
        want = sdr_jinc2.frame(cfg, tuple(p[f] for p in planes), None)
        d = (rgba8.codes(first[f]) - want).abs()
        assert int(d.max()) <= 1 and (d > 0).double().mean().item() < 2e-3
    rot = _bench_config("sdr1080_nv12_to_uhd_jinc2", 480, 270, 540, 960)
    rot_fn = P.make_frame_fn(P.plan_pipeline(
        common.settings(rot), common.source(rot), common.output(rot)),
        pack_surface=True, rotation=90, flip=True)
    out, builds, routes = _k6_counted(lambda: rot_fn(planes))
    assert routes == {"table transposed": 1} and builds == 1
    assert out.shape == (2, 540, 960)
    monkeypatch.setattr(jk, "TABLE_CAP", 0)
    out, builds, routes = _k6_counted(lambda: vp.process(planes))
    assert routes == {"per-output": 1} and builds == 0
    assert rk.launches == only(jinc2_convert_fused=1)
    assert torch.equal(out, first)
    rk.reset_launches()
    assert set(rk.k6_route_launches.values()) == {0}


# --- the c7 routes' checked pow (csrc/tail.cuh CheckedPow) --------------------

ST2084_M1, ST2084_M2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
ST2084_C1 = 3424.0 / 4096.0
# the exponents of the BT.2390 tail's pows, as float32 (tail.cuh's f())
POW_EXPONENTS = {"1/m2": 1.0 / ST2084_M2, "1/m1": 1.0 / ST2084_M1,
                 "m1": ST2084_M1, "m2": ST2084_M2}
POW_CHUNK = 1 << 27


def _checked_pow(x, e):
    """The card's checked pow of the float32 values ``x`` at exponent ``e``
    beside pow_pos (``vrt_checked_pow``): (checked, exact, ok, v), v the
    value its range test compares with 126."""
    from videorenderer_tpu_torch.kernels import build
    checked, exact, v = (torch.empty_like(x) for _ in range(3))
    ok = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    err = build.load().vrt_checked_pow(
        x.data_ptr(), x.numel(), float(np.float32(e)), checked.data_ptr(),
        exact.data_ptr(), ok.data_ptr(), v.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return checked, exact, ok.bool(), v


def _f32_bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.int32))


@pytest.mark.parametrize("name", list(POW_EXPONENTS))
def test_checked_pow_bit_equal_to_pow_pos(dev, name):
    """Every non-negative float32 bit pattern (2^31, in chunks), and every
    128th negative one with -0, -inf and a negative NaN, at each exponent
    of the BT.2390 tail: wherever the range flag holds, the checked pow is
    pow_pos's bits.  The flag is false exactly where its test says: x > 0
    or NaN, and |v| >= 126 (v = e * log2(x) for e > 1, else log2(x)).  So
    it is false on every subnormal, inf and NaN, true on every x <= 0, and
    false on the normals outside the bounds 2^(+-126 / max(e, 1)) (counted
    against float64's, within the patterns whose v rounds across 126: one
    float step of 126, 2^-17 in log2, is ~22 patterns above a power of two
    and ~44 below one, at either bound)."""
    e = float(np.float32(POW_EXPONENTS[name]))
    off_normal = 0
    for start in range(0, 1 << 31, POW_CHUNK):
        bits = torch.arange(start, start + POW_CHUNK, device=dev).int()
        x = bits.view(torch.float32)
        checked, exact, ok, v = _checked_pow(x, e)
        same = checked.view(torch.int32) == exact.view(torch.int32)
        assert bool((same | ~ok).all())
        assert torch.equal(ok, (x <= 0) | (v.abs() < 126))
        special = (bits > 0) & ((bits < 0x800000) | (bits >= 0x7F800000))
        assert not bool(ok[special].any())
        normal = (bits >= 0x800000) & (bits < 0x7F800000)
        off_normal += int((normal & ~ok).sum())
    bound = max(e, 1.0)
    lo, hi = _f32_bits(2.0 ** (-126 / bound)), _f32_bits(2.0 ** (126 / bound))
    expected = (lo - 0x800000) + (0x7F800000 - hi)
    assert abs(off_normal - expected) <= 132, (off_normal, expected)
    neg = torch.cat([torch.arange(-(1 << 31), 0, 128, device=dev),
                     torch.tensor([-(1 << 31), _f32_bits(-np.inf), -1],
                                  device=dev)]).int()
    x = neg.view(torch.float32)
    checked, exact, ok, _ = _checked_pow(x, e)
    assert torch.equal(ok, ~torch.isnan(x))
    assert not bool(checked[ok].any()) and not bool(exact[ok].any())


BT2390_HDR = {"mastering_min_nits": 0.005, "mastering_max_nits": 4000.0,
              "max_cll": 3000.0, "max_fall": 800.0}
# codes outside the gamut (PERF.md section 2: R at PQ 1.42, B at 0, a luma
# of 257,000 nits), as 10-bit P010 codes
FAR_GAMUT = (757, 126, 918)
C7_ROUTES = ["c7 uint16/int16", "c7 uint16/float32",
             "c7 planar uint16/float32", "c7 planar uint16"]


def _bt2390_cell_epilogue(w=3840, h=2160):
    """The HDR10 passthrough cell's plan at w x h and its K2 / K4 epilogue
    with the first scene's HDR10 values."""
    from vrbench.entries import common, serving_hdr10
    cfg = _bench_config("hdr10_uhd_to_hdr600_bt2390", w, h, w, h)
    plan = P.plan_pipeline(serving_hdr10.settings(cfg), common.source(cfg),
                           common.output(cfg))
    return plan, P._make_tail_epilogue(plan, rt={"hdr": BT2390_HDR})


def _far_gamut_p010(rng, n, w, h, r0, c0):
    """The cell's raw P010 planes (luma codes 64-940, chroma 64-960; numpy)
    with an 8 x 16 block of FAR_GAMUT codes in frame 0 at luma row r0,
    column c0 (and the chroma rows and columns every tap of its pixels
    reaches)."""
    y = rng.integers(64, 941, (n, h, w), dtype=np.uint16) << 6
    u, v = (rng.integers(64, 961, (n, h // 2, w // 2), dtype=np.uint16) << 6
            for _ in range(2))
    y[0, r0:r0 + 8, c0:c0 + 16] = FAR_GAMUT[0] << 6
    rc, cc = r0 // 2, c0 // 2
    u[0, rc - 2:rc + 6, cc - 2:cc + 10] = FAR_GAMUT[1] << 6
    v[0, rc - 2:rc + 6, cc - 2:cc + 10] = FAR_GAMUT[2] << 6
    return y, u, v


def _c7_route_call(route, planes, epi):
    """A call of ``route`` (K2's c7 routes, K4's "c7 planar uint16") on the
    raw P010 ``planes`` of the cell's shape: K2 reads the raw luma and the
    chroma after K1's W upsample (mid16 codes, or float32 for the float32
    routes) with the bilinear H upsample; K4 reads all three raw.  Returns
    (kernel, fn), fn() making the call."""
    y, u, v = planes
    n, h, w = y.shape
    ux, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    if route == "c7 planar uint16":
        (ky, hy), (kc, hc) = (rk.mega_maps(None, None, 1 / 65535.0),
                              rk.mega_maps(ux, uy, 1 / 65535.0))
        args = (y, u, v, ky, kc, hy, hc, h, epi, 1 / 65535.0)
        assert rk.mega3_tail_route(torch.uint16, torch.uint16, epi) == route
        return "mega3_tail", lambda: rk.mega3_tail(*args)
    kx = rk.BandedMatrix(ux, pre_scale=1 / 65535.0)
    mid = [rk.banded_resize_last_axis(c, kx, mid16=True) for c in (u, v)]
    if route == "c7 uint16/int16":
        cu, cv = mid
        mc = rk.BandedMatrix(uy, pre_scale=1.0 / rk.MID16_SCALE)
    else:
        cu, cv = (m.float() / rk.MID16_SCALE for m in mid)
        mc = rk.BandedMatrix(uy)
    pack = None if "planar" in route else "rgb10a2"
    assert rk.rows3_tail_route(torch.uint16, cu.dtype, epi, pack) == route
    kw = dict(y_scale=1 / 65535.0, pack_format=pack)
    return "rows3_tail", lambda: rk.rows3_tail(y, cu, cv, None, mc, h, epi,
                                               **kw)


def _staged_and_runtime(monkeypatch, kernel, call):
    """``call`` on its compiled route, then on the long-window route, which
    runs every pixel through tail_exact (the runtime route); the groups
    the compiled route ran again exactly."""
    flag = "K2_LONG_WINDOW" if kernel == "rows3_tail" else "K4_LONG_WINDOW"
    rk.reset_launches()
    staged = call()
    torch.cuda.synchronize()
    redo = rk.redo_groups(kernel)
    with monkeypatch.context() as mp:
        mp.setattr(rk, flag, True)
        runtime = call()
    torch.cuda.synchronize()
    assert rk.launches[kernel] == 2
    assert rk.redo_groups(kernel) == redo
    return staged, runtime, redo


@pytest.mark.parametrize("route", C7_ROUTES)
def test_c7_routes_bit_equal_to_runtime_route(dev, route, monkeypatch):
    """K2's three c7 routes and K4's at the cell's frame shape (2 frames of
    3840 x 2160, the cell's codes: luma 64-940, chroma 64-960, the cell's
    BT.2390 epilogue), with blocks of far-gamut codes: bit-equal to the
    runtime route (tail_exact on every pixel, the long-window route
    forced), the groups run again exactly under 1e-4 of a call's."""
    rng = np.random.default_rng(90)
    _, epi = _bt2390_cell_epilogue()
    planes = tuple(torch.from_numpy(p).to(dev) for p in
                   _far_gamut_p010(rng, 2, 3840, 2160, 1000, 2000))
    kernel, call = _c7_route_call(route, planes, epi)
    staged, runtime, redo = _staged_and_runtime(monkeypatch, kernel, call)
    assert torch.equal(staged, runtime)
    assert redo < 1e-4 * 2 * 2160 * 3840 / 4, redo


def _near_black_pq(code: int):
    """(scale, PQ value): code * scale in float32 is a PQ value whose
    1/m2 power lies ~9 float steps above c1, so that pq_to_p gives ~1.8e-7
    and its 1/m1 power (the tail's lin) is subnormal: a value CheckedPow
    refuses."""
    target = (ST2084_C1 + 9 * 2.0 ** -24) ** ST2084_M2
    sc = np.float32(target / code)
    value = np.float32(np.float32(code) * sc)
    steps = (float(value) ** (1 / ST2084_M2) - ST2084_C1) / 2.0 ** -24
    assert 0 < value < 1e-6 and 5 < steps < 13
    return float(sc), float(value)


@pytest.mark.parametrize("route", C7_ROUTES)
def test_c7_redo_counter_reads_the_planted_groups(dev, route, monkeypatch):
    """The cell's epilogue with its colour matrix made a permutation (R the
    first chroma plane, G the second, B the luma; the route is the same),
    the planes read directly at the cell's frame shape: a frame whose R is
    twice a near-black PQ value runs no group again; the same frame with
    that value (0 < R < 1e-6, its lin subnormal) planted in one pixel of
    each of 50 groups makes the counter read 50.  Both bit-equal to the
    runtime route."""
    import dataclasses
    rng = np.random.default_rng(91)
    _, epi = _bt2390_cell_epilogue()
    epi = dataclasses.replace(epi, cmat=np.array(
        [[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0]], np.float32))
    n, h, w, code = 2, 2160, 3840, 10000
    sc, value = _near_black_pq(code)
    npt = {"c7 uint16/int16": np.int16,
           "c7 planar uint16": np.uint16}.get(route, np.float32)
    dtype = {np.int16: torch.int16, np.uint16: torch.uint16,
             np.float32: torch.float32}[npt]
    mark, clean = ((value, 2 * value) if npt == np.float32
                   else (code, 2 * code))
    planes = [np.zeros((n, h, w), np.uint16), np.full((n, h, w), clean, npt),
              np.zeros((n, h, w), npt)]
    scale_ = 1.0 if npt == np.float32 else sc
    y, u, v = (torch.from_numpy(p).to(dev) for p in planes)
    if route == "c7 planar uint16":
        kernel = "mega3_tail"
        assert rk.mega3_tail_route(torch.uint16, dtype, epi) == route

        def call():
            return rk.mega3_tail(y, u, v, None, None, None, None, h, epi,
                                 scale_)
    else:
        kernel = "rows3_tail"
        pack = None if "planar" in route else "rgb10a2"
        assert rk.rows3_tail_route(torch.uint16, dtype, epi, pack) == route

        def call():
            return rk.rows3_tail(y, u, v, None, None, h, epi, y_scale=1.0,
                                 c_scale=scale_, pack_format=pack)
    staged, runtime, redo = _staged_and_runtime(monkeypatch, kernel, call)
    assert torch.equal(staged, runtime) and redo == 0
    groups = rng.choice(n * h * (w // 4), 50, replace=False)
    b, rest = np.divmod(groups, h * (w // 4))
    r, g = np.divmod(rest, w // 4)
    planes[1][b, r, 4 * g + rng.integers(0, 4, 50)] = mark
    u = torch.from_numpy(planes[1]).to(dev)
    staged, runtime, redo = _staged_and_runtime(monkeypatch, kernel, call)
    assert torch.equal(staged, runtime) and redo == 50


# --- K8's LMS route under CheckedPow (csrc/dovi_mid.cuh dovi_mid_group) -----

P5_CELL = "dovi_1080.p5_b16"


def _p5_k8_call(dev, monkeypatch, batch=2, seed=2**31 + 2026):
    """The p5 cell's K8 call at its shape (vrbench's configuration, its
    traffic's first scene, ``batch`` frames of 3840 x 2160 from its frame
    generator), recorded from the serving function: (args, kw)."""
    from vrbench import gen, spec
    from vrbench.entries import common
    cell = spec.load_cell(P5_CELL)
    meta = common.dovi_metadata(gen.scene(cell.traffic, 0))
    fn = P.make_serving_fn(P.plan_pipeline(
        common.settings(cell.config), common.source(cell.config, dovi=meta),
        common.output(cell.config)), pack_surface=True)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    planes = spec.module("frames", "p010").batch(cell.config, cell.traffic,
                                                 batch, g, dev)
    calls, real = [], dk.rows3_mid
    with monkeypatch.context() as mp:
        mp.setattr(dk, "rows3_mid",
                   lambda *a, **k: calls.append((a, k)) or real(*a, **k))
        fn(planes, {"dovi_curves": fn.pack_curves(meta)})
    torch.cuda.synchronize()
    (args, kw), = calls
    return args, kw


def _lms_route_and_runtime(args, kw):
    """K8 on its LMS route (one launch, counted under it) and on the
    runtime route; the groups the LMS route ran again exactly."""
    assert dk.rows3_mid_route(args[0].dtype, args[1].dtype,
                              args[6]) == dk.K8_LMS
    rk.reset_launches()
    got = dk.rows3_mid(*args, **kw)
    torch.cuda.synchronize()
    redo = dk.k8_redo_groups()
    assert dk.k8_route_launches[dk.K8_LMS] == 1
    runtime = _k8_runtime(args, kw)
    assert dk.k8_redo_groups() == redo
    return got, runtime, redo


def test_k8_lms_route_bit_equal_to_runtime_route_at_the_p5_cell(
        dev, monkeypatch):
    """The p5 cell's K8 call (2 frames of 3840 x 2160 -> 1080 rows,
    Catmull-Rom, the cell's curves and LMS matrix, its frame generator):
    the LMS route, pows and divisions checked once a group, gives the
    runtime route's bits, within K8's band of rows3_mid_plain, and runs no
    group again."""
    args, kw = _p5_k8_call(dev, monkeypatch)
    y, u = args[0], args[1]
    assert y.shape == (2, 2160, 3840) and y.dtype == torch.uint16
    assert u.shape == (2, 1080, 3840) and u.dtype == torch.float32
    assert (args[5], args[8]) == (2160, 1080)
    got, runtime, redo = _lms_route_and_runtime(args, kw)
    assert all(torch.equal(g, r) for g, r in zip(got, runtime))
    assert redo == 0
    for g, r in zip(got, dk.rows3_mid_plain(*args, **kw)):
        assert g.shape == (2, 1080, 3840)
        assert (g - r).abs().max().item() <= 1e-4


def test_k8_redo_counter_reads_the_planted_groups(dev):
    """The p5 cell's curves with the RPU matrix and offsets made R = Cb,
    G = Cb + 0.3, B = Cb + 0.4 and the combined LMS matrix diag(2^-100, 1,
    1), the planes read directly at the cell's frame shape (no out map, so
    each mid pixel is converted once): a frame of Cb 0.25 runs no group
    again; with one of three Cb values that CheckedPow refuses planted in
    one pixel of each of 51 groups (17 of each) the counter reads 51.  Both
    bit-equal to the runtime route and within K8's band of
    rows3_mid_plain."""
    import dataclasses
    from vrbench import gen, spec
    from vrbench.entries import common
    cell = spec.load_cell(P5_CELL)
    meta = common.dovi_metadata(gen.scene(cell.traffic, 0))
    mid = dataclasses.replace(
        dovi.mid_stage(meta, *dovi.build_ycc_to_rgb_cmat(meta)),
        cmat=np.array([[0, 1, 0, 0], [0, 1, 0, 0.3], [0, 1, 0, 0.4]],
                      np.float32),
        lms=np.diag([2.0 ** -100, 1, 1]).astype(np.float32))
    n, h, w = 2, 2160, 3840
    rng = np.random.default_rng(92)
    y = torch.from_numpy(rng.integers(64, 941, (n, h, w), dtype=np.uint16)
                         << 6).to(dev)
    cb = np.full((n, h, w), 0.25, np.float32)
    v = torch.full((n, h, w), 0.4, dtype=torch.float32, device=dev)
    kw = dict(y_scale=1 / 65535.0, c_scale=1.0)

    def call():
        u = torch.from_numpy(cb).to(dev)
        return (y, u, v, None, None, h, mid, None, h), kw

    got, runtime, redo = _lms_route_and_runtime(*call())
    assert all(torch.equal(g, r) for g, r in zip(got, runtime))
    assert redo == 0
    # R is Cb's reshaped value (the p5 curves' Cb piece below 0.5 is the
    # identity): a subnormal PQ code; a PQ code whose p (~1.7e-7) sends the
    # 1/m1 power's product under -126; a PQ code (~2^-39 linear) clean
    # through the EOTF, whose LMS value, 2^-100 times that, is subnormal
    # at the OETF
    plants = np.float32([1e-40, _near_black_pq(10000)[1], 2e-5])
    assert 0 < plants[0] < np.finfo(np.float32).tiny
    groups = rng.choice(n * h * (w // 4), 51, replace=False)
    frame, rest = np.divmod(groups, h * (w // 4))
    row, group = np.divmod(rest, w // 4)
    cb[frame, row, 4 * group + rng.integers(0, 4, 51)] = np.repeat(plants, 17)
    args, kw = call()
    got, runtime, redo = _lms_route_and_runtime(args, kw)
    assert all(torch.equal(g, r) for g, r in zip(got, runtime))
    assert redo == 51
    for g, r in zip(got, dk.rows3_mid_plain(*args, **kw)):
        assert (g - r).abs().max().item() <= 1e-4


@pytest.mark.parametrize("sizes", [(3840, 1920), (600, 250), (1000, 333),
                                   (1001, 500), (999, 333), (517, 250)])
def test_k10_kernels_match_plain(dev, sizes):
    """K10's two forms on raw uint16 codes: wpass_floor bit-equal to its
    plain version, wpass_bf16 within 1e-5 (outputs ~[-0.3, 1.3]; the
    products are exact, only the order of the sum differs), at widths
    whose rows are not 16-byte aligned (1001, 999, 517 codes) and output
    widths that are odd or no multiple of the block's span."""
    from videorenderer_tpu_torch.kernels import probe as pk
    rng = np.random.default_rng(24)
    mat = rk.BandedMatrix(_lanczos(*sizes), pre_scale=1 / 65535.0)
    x = _planes(rng, torch.uint16, (2, 37, sizes[0])).to(dev)
    before = dict(rk.launches)
    got = pk.wpass_bf16(x, mat)
    floor = pk.wpass_floor(x, sizes[1])
    torch.cuda.synchronize()
    assert rk.launches["wpass_bf16"] == before["wpass_bf16"] + 1
    assert rk.launches["wpass_floor"] == before["wpass_floor"] + 1
    ref = pk.wpass_bf16_plain(x, mat)
    assert got.shape == ref.shape == (2, 37, sizes[1])
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(floor, pk.wpass_floor_plain(x, sizes[1]))


def test_k10_floor_refuses_rows_wider_than_its_tile(dev):
    from videorenderer_tpu_torch.kernels import probe as pk
    x = torch.zeros((2, pk.FLOOR_MAX_WIDTH + 8), dtype=torch.uint16,
                    device=dev)
    with pytest.raises(ValueError, match="cannot stage"):
        pk.wpass_floor(x, 8)


def test_stage_split_on_card_matches_cpu(dev, monkeypatch):
    """torch_headline_micro's stages at a small size on the card: ``tail``
    bit-equal to the FLOAT16 frame function there, and within 1 code of
    the CPU's plain route."""
    import chip_smoke as cs
    import torch_headline_micro as thm
    for name, val in (("W", 256), ("H", 128), ("OW", 128), ("OH", 64)):
        monkeypatch.setattr(cs, name, val)
    for plan_name in thm.PLANS:
        planes = cs.p010_batch(2, 5, "cpu")
        on_card = tuple(p.to(dev) for p in planes)
        plan = thm.plan_for(plan_name)
        tail = thm.stages(plan, on_card)["tail"]()
        f16 = P.make_frame_fn(thm.plan_for(plan_name, C.TexFormat.FLOAT16),
                              pack_surface=True)
        assert torch.equal(tail, f16(on_card))
        ref = thm.stages(plan, planes)["tail"]()
        d = np.abs(_codes(tail, "rgb10a2") - _codes(ref, "rgb10a2"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02


# --- the long-window routes, the offset store, the SDR BT.2020 fix ------------

@pytest.fixture
def long_window(monkeypatch):
    """Force every long-window route (the flags K2_LONG_WINDOW ... of
    kernels/resize and kernels/deint) inside a test."""
    def force(on=True):
        for mod, name in ((rk, "K2_LONG_WINDOW"), (rk, "K3_LONG_WINDOW"),
                          (dk, "K7_LONG_WINDOW"), (dk, "K8_LONG_WINDOW"),
                          (dk, "K9_LONG_WINDOW")):
            monkeypatch.setattr(mod, name, on)
    return force


def _fix_epi(dither_bits=10, gamma_trc=S.TRC.GAMMA28, with_cmat=True):
    """The SDR BT.2020 fix's epilogue (a P010 SDR BT.2020 plan with the
    source's power gamma)."""
    plan = P.plan_pipeline(
        C.Settings(use_dither=dither_bits > 0),
        P.SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                           matrix=S.CSP.BT_2020_NC, transfer=gamma_trc,
                           primaries=S.Primaries.BT_2020),
        P.OutputDescriptor(width=64, height=32,
                           bits=abs(dither_bits) if dither_bits else 16))
    epi = P._make_tail_epilogue(plan, with_cmat=with_cmat)
    assert epi.correction == rk.CORR_FIX_BT2020
    return epi


LONG_K2 = [("headline", lambda: _epi(rk.CORR_PQ_TO_SDR, 10), torch.int16,
            "rgb10a2"),
           ("c5", lambda: _epi(rk.CORR_HLG_TO_SDR, 8), torch.int16, "rgba8"),
           ("fix", lambda: _fix_epi(10), torch.int16, "rgb10a2"),
           ("float", lambda: _epi(rk.CORR_PQ_TO_SDR, 0), torch.float32, None),
           ("c7p", lambda: P._make_tail_epilogue(_c7_plan(hdr10plus=GUIDED)),
            torch.int16, "rgb10a2")]


@pytest.mark.parametrize("name,make_epi,dtype,pack", LONG_K2,
                         ids=[c[0] for c in LONG_K2])
def test_k2_long_window_bit_equal_to_staged(dev, long_window, name, make_epi,
                                            dtype, pack):
    """On maps both routes take (the headline's 2:1), K2's long-window
    route gives the staged route's bits, placed or not."""
    rng = np.random.default_rng(40)
    y, u, v, my, mc = _headline_k2(rng, 2, 216, 200, 108, dtype)
    epi = make_epi()
    for place in (None, (120, 212, 6, 5)):
        kw = dict(pack_format=pack, place=place)
        staged = rk.rows3_tail(y, u, v, my, mc, 108, epi, **kw)
        long_window()
        assert rk.k2_route(y.element_size(), u.element_size(), my,
                           mc) == "long-window"
        got = rk.rows3_tail(y, u, v, my, mc, 108, epi, **kw)
        long_window(False)
        torch.cuda.synchronize()
        assert torch.equal(got, staged)


def test_k3_k7_k8_k9_long_window_bit_equal_to_staged(dev, long_window):
    """K3, K7, K8 (c8's and the variant's metadata) and K9 (c5's and c8's
    tails, placed too) on maps both routes take: the long-window routes
    give the staged routes' bits."""
    rng = np.random.default_rng(41)
    h, w, oh, ow = 216, 384, 108, 192

    def both(fn):
        a = fn()
        long_window()
        b = fn()
        long_window(False)
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert all(torch.equal(x, z) for x, z in zip(a, b))

    mat = rk.BandedMatrix(_lanczos(h, oh))
    x = _planes(rng, torch.float32, (2, h, w)).to(dev)
    both(lambda: rk.banded_resize_rows(x, mat))
    prev, cur, nxt = (tuple(_planes(rng, torch.uint16, s).to(dev)
                            for s in ((2, h, w), (2, h // 2, w // 2),
                                      (2, h // 2, w // 2)))
                      for _ in range(3))
    my_c = rk.BandedMatrix(_lanczos(h // 2, oh))
    for tff in (True, False):
        both(lambda: dk.deint3_rows_dual(prev, cur, nxt, mat, my_c, oh,
                                         64.0 * 64, tff))
    for kind in ("c8", "variant", "limits"):
        args, kw = _k8_args(rng, kind, h=h, w=w)
        both(lambda: dk.rows3_mid(*args, **kw))
    mx = rk.BandedMatrix(_lanczos(w, ow))
    fy, fu, fv = (_planes(rng, torch.float32, (2, oh, w)).to(dev)
                  for _ in range(3))
    for epi, pack in ((P._make_tail_epilogue(_c5_plan()), "rgba8"),
                      (_epi_rgb(rk.CORR_PQ_TO_SDR, 10), "rgb10a2"),
                      (_fix_epi(10, with_cmat=False), "rgb10a2")):
        for place in (None, (oh + 3, ow + 9, 2, 7)):
            both(lambda: dk.cols3_tail(fy, fu, fv, mx, mx, ow, epi,
                                       pack_format=pack, place=place))


def _thumb_maps(h, w, oh, ow, down=C.Downscaling.HAMMING):
    """A strong downscale's maps, as fused_maps builds them: luma and
    chroma (4:2:0, composed with the bilinear upsample), W and H."""
    wx = scale.downscale_matrix(down, w, ow)
    wy = scale.downscale_matrix(down, h, oh)
    ux, uy = chroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    return wx, wy, ux @ wx, uy @ wy


@pytest.mark.parametrize("down", [C.Downscaling.HAMMING,
                                  C.Downscaling.LANCZOS])
def test_strong_downscales_take_the_long_window_routes(dev, down):
    """The ratios of a 4K thumbnail (2160 -> 90 rows, 3840 -> 320
    columns) at a narrower width: K2, K7, K8 and K9 pick their
    long-window routes on their own and agree with their plain versions
    within their bands; K1 and K3 too."""
    rng = np.random.default_rng(42)
    h, w, oh, ow = 2160, 960, 90, 80
    wx, wy, cwx, cwy = _thumb_maps(h, w, oh, ow, down)
    unscale = 1.0 / rk.MID16_SCALE
    my = rk.BandedMatrix(wy, pre_scale=unscale)
    mc = rk.BandedMatrix(cwy, pre_scale=unscale)
    assert rk.k2_route(2, 2, my, mc) == "long-window"
    y = _planes(rng, torch.int16, (2, h, w)).to(dev)
    u, v = (_planes(rng, torch.int16, (2, h // 2, w)).to(dev)
            for _ in range(2))
    epi = _epi(rk.CORR_PQ_TO_SDR, 10)
    args = (y, u, v, my, mc, oh, epi)
    got = rk.rows3_tail(*args, pack_format="rgb10a2")
    torch.cuda.synchronize()
    _k2_close(got, rk.rows3_tail_plain(*args, pack_format="rgb10a2"),
              "rgb10a2", 10, rk.CORR_PQ_TO_SDR)
    # K7 on the raw planes (4K's 2160 rows to 90)
    kmy = rk.BandedMatrix(wy, pre_scale=1 / 65535.0)
    kmc = rk.BandedMatrix(cwy, pre_scale=1 / 65535.0)
    assert dk.k7_route(2, kmy, kmc) == "long-window"
    win = [tuple(_planes(rng, torch.uint16, s).to(dev)
                 for s in ((1, h, w), (1, h // 2, w // 2),
                           (1, h // 2, w // 2))) for _ in range(3)]
    got = dk.deint3_rows_dual(*win, kmy, kmc, oh, 512.0)
    torch.cuda.synchronize()
    for g, r in zip(got, dk.deint3_rows_dual_plain(*win, kmy, kmc, oh,
                                                   512.0)):
        assert (g - r).abs().max().item() <= 2e-5
    # K9 on float32 planes of the output rows (3840 -> 320 columns' ratio)
    mx = rk.BandedMatrix(scale.downscale_matrix(down, 3840, 320))
    fp = [_planes(rng, torch.float32, (2, 24, 3840)).to(dev)
          for _ in range(3)]
    assert dk.k9_route(4, 4, mx, mx) == "long-window"
    epi9 = _epi_rgb(rk.CORR_PQ_TO_SDR, 10)
    got = dk.cols3_tail(*fp, mx, mx, 320, epi9, pack_format="rgb10a2")
    torch.cuda.synchronize()
    ref = dk.cols3_tail_plain(*fp, mx, mx, 320, epi9, pack_format="rgb10a2")
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    # K8: c8's maps at 2160 mid rows to 16 output rows
    args, kw = _k8_args(rng, "c8", h=h, w=256, batch=1)
    out16 = rk.BandedMatrix(scale.downscale_matrix(down, h, 16))
    args = args[:7] + (out16, 16)
    assert dk.k8_route(2, 4, None, args[4], out16, h,
                       args[6].host_values().size)[0] == "long-window"
    got = dk.rows3_mid(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, dk.rows3_mid_plain(*args, **kw)):
        assert (g - r).abs().max().item() <= 1e-5
    # K1 on a float32 4K plane to 160 columns: fewer rows a block
    k1 = rk.BandedMatrix(scale.downscale_matrix(down, 3840, 160))
    assert rk.k1_rows(4, k1.row_windows(rk.K1_SPAN)[1]) < rk.K1_ROWS
    xf = _planes(rng, torch.float32, (40, 3840)).to(dev)
    got = rk.banded_resize_last_axis(xf, k1)
    torch.cuda.synchronize()
    assert (got - rk.banded_resize_last_axis_plain(xf, k1)).abs().max() \
        <= 2e-6


@pytest.mark.parametrize("place", [(12, 205, 2, 4), (12, 207, 1, 3),
                                   (10, 200, 0, 0)])
@pytest.mark.parametrize("pack", ["rgb10a2", "rgba8", None])
def test_k2_k9_offset_store(dev, place, pack):
    """K2 and K9 with ``place``: the rect bit-equal to the unplaced kernel
    output (aligned and unaligned column offsets), the bars the packed
    zero (or float zeros), the whole equal to the plain version's
    placement within the band."""
    rng = np.random.default_rng(43)
    y, u, v, my, mc = _headline_k2(rng, 2, 20, 200, 10)
    epi = _epi(rk.CORR_PQ_TO_SDR, 10 if pack else 0)
    sh, sw, oy, ox = place
    bare = rk.rows3_tail(y, u, v, my, mc, 10, epi, pack_format=pack)
    got = rk.rows3_tail(y, u, v, my, mc, 10, epi, pack_format=pack,
                        place=place)
    torch.cuda.synchronize()
    assert torch.equal(got[..., oy:oy + 10, ox:ox + 200], bare)
    fill = 0 if pack is None else rk.PACKED_ZERO[pack]
    mask = torch.ones((sh, sw), dtype=torch.bool, device=dev)
    mask[oy:oy + 10, ox:ox + 200] = False
    assert torch.all(got[..., mask] == fill)
    mx = rk.BandedMatrix(_lanczos(400, 200))
    fp = [_planes(rng, torch.float32, (2, 10, 400)).to(dev) for _ in range(3)]
    bare = dk.cols3_tail(*fp, mx, mx, 200, epi, pack_format=pack)
    got = dk.cols3_tail(*fp, mx, mx, 200, epi, pack_format=pack, place=place)
    torch.cuda.synchronize()
    assert torch.equal(got[..., oy:oy + 10, ox:ox + 200], bare)
    assert torch.all(got[..., mask] == fill)


@pytest.mark.parametrize("trc", [S.TRC.GAMMA28, S.TRC.BT_1886,
                                 S.TRC.LINEAR])
@pytest.mark.parametrize("dither_bits,pack", [(10, "rgb10a2"), (0, None)])
def test_fix_bt2020_kernels_match_plain(dev, trc, dither_bits, pack):
    """CORR_FIX_BT2020 (the source's gamma by value with the launch) on
    K2's runtime route, K9 and K4 against their plain versions: within 1
    code on < 2% of the channels, float output within 2e-4 (the band of a
    correction: the 1/2.2 power near black multiplies a float32 rounding
    step)."""
    rng = np.random.default_rng(44)
    epi = _fix_epi(dither_bits, trc)
    assert rk.rows3_tail_route(torch.int16, torch.int16, epi,
                               pack) == "runtime"
    y, u, v, my, mc = _headline_k2(rng, 2, 216, 200, 108)
    args = (y, u, v, my, mc, 108, epi)
    got = rk.rows3_tail(*args, pack_format=pack)
    torch.cuda.synchronize()
    _k2_close(got, rk.rows3_tail_plain(*args, pack_format=pack), pack,
              dither_bits, rk.CORR_FIX_BT2020)
    mx = rk.BandedMatrix(_lanczos(400, 200))
    fp = [_planes(rng, torch.float32, (2, 10, 400)).to(dev) for _ in range(3)]
    got = dk.cols3_tail(*fp, mx, mx, 200, epi, pack_format=pack)
    torch.cuda.synchronize()
    _k2_close(got, dk.cols3_tail_plain(*fp, mx, mx, 200, epi,
                                       pack_format=pack),
              pack, dither_bits, rk.CORR_FIX_BT2020)
    if pack is None:
        k4 = (*[_planes(rng, torch.uint16, (2, 24, 32)).to(dev)
                for _ in range(3)],
              rk.BandedMatrix(_lanczos(32, 16), pre_scale=1 / 65535.0),
              rk.BandedMatrix(_lanczos(32, 16), pre_scale=1 / 65535.0),
              rk.BandedMatrix(_lanczos(24, 12)),
              rk.BandedMatrix(_lanczos(24, 12)), 12, epi)
        got = rk.mega3_tail(*k4)
        torch.cuda.synchronize()
        assert (got - rk.mega3_tail_plain(*k4)).abs().max().item() <= 2e-4


def _small_plan(fmt=ColorFormat.P010, w=384, h=216, ow=192, oh=108, bits=10,
                rect=None, transfer=S.TRC.PQ, primaries=S.Primaries.BT_2020,
                **settings):
    settings.setdefault("upscaling", C.Upscaling.LANCZOS3)
    return P.plan_pipeline(
        C.Settings(**settings),
        P.SourceDescriptor(format=fmt, width=w, height=h,
                           matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                           primaries=primaries, transfer=transfer,
                           hdr10=P.HDR10Metadata()),
        P.OutputDescriptor(width=ow, height=oh, bits=bits, video_rect=rect))


@pytest.mark.parametrize("case", ["gray", "shader", "sdr2020", "dovi_rect",
                                  "thumb"])
def test_new_paths_on_card_match_cpu(dev, case, monkeypatch):
    """GRAY (K1 + K3), the shader order (K1 + K2's convert with the
    correction), SDR BT.2020 (K2 with the fix), Dolby Vision in a rect (K1
    ×2 + K8 + K9 with the offset) and a thumbnail's ratio (the long-window
    routes) at small sizes: the card's launches, and within 1 code of the
    CPU on < 2% of the channels (the same route's plain versions: the
    routes chosen from the planes' device run the kernel route there
    too)."""
    rng = np.random.default_rng(45)
    if case == "gray":
        plan = _small_plan(ColorFormat.Y16, convert_to_sdr=True)
        planes = (torch.from_numpy(rng.integers(
            0, 65535, (2, 216, 384), dtype=np.uint16)),)
        want = only(banded_resize_last_axis=1, banded_resize_rows=1)
    elif case == "shader":
        plan = _small_plan(convert_to_sdr=True, vp_scaling=False)
        planes = _p010(rng, 2, 384, 216)
        want = only(banded_resize_last_axis=2, rows3_tail=1)
    elif case == "sdr2020":
        plan = _small_plan(transfer=S.TRC.BT_1886)
        planes = _p010(rng, 2, 384, 216)
        want = only(banded_resize_last_axis=3, rows3_tail=1)
    elif case == "dovi_rect":
        base = _dovi_plan(384, 216, 192, 108, kind="c8")
        plan = P.plan_pipeline(base.settings, base.src, P.OutputDescriptor(
            width=256, height=144, bits=10, video_rect=(32, 18, 224, 126)))
        planes = _p010(rng, 2, 384, 216)
        want = only(banded_resize_last_axis=2, rows3_mid=1, cols3_tail=1)
    else:
        plan = _small_plan(w=960, h=2160, ow=40, oh=90)
        planes = _p010(rng, 1, 960, 2160)
        want = only(banded_resize_last_axis=3, rows3_tail=1)
    fn = P.make_frame_fn(plan, pack_surface=True)
    rk.reset_launches()
    got = fn(tuple(p.to(dev) for p in planes))
    torch.cuda.synchronize()
    assert rk.launches == want
    if case == "dovi_rect":
        # the chain's float32 K8 differences (<= 1e-5) can grow past a code
        # in the PQ tail, so each kernel is held to its plain version:
        # K9's call with the offset, then the rect against the unplaced
        # plan on the card, bit for bit
        l, tp, r, bt = plan.dst.video_rect
        with monkeypatch.context() as mp:
            seen = []
            orig = dk.cols3_tail

            def k9(*a, **k):
                seen.append((a, k, orig(*a, **k)))
                return seen[-1][2]
            mp.setattr(dk, "cols3_tail", k9)
            fn(tuple(p.to(dev) for p in planes))
        (a, k, out), = seen
        assert k["place"] == (144, 256, tp, l)
        d = np.abs(_codes(out, "rgb10a2")
                   - _codes(dk.cols3_tail_plain(*a, **k), "rgb10a2"))
        assert d.max() <= 1 and (d > 0).mean() < 0.02
        bare = P.make_frame_fn(base, pack_surface=True)(
            tuple(p.to(dev) for p in planes))
        assert torch.equal(got[:, tp:bt, l:r], bare)
        mask = torch.ones((144, 256), dtype=torch.bool, device=dev)
        mask[tp:bt, l:r] = False
        assert torch.all(got[:, mask] == rk.PACKED_ZERO["rgb10a2"])
        return
    monkeypatch.setattr(P, "_on_card", lambda planes: True)
    ref = fn(planes)
    assert got.shape == ref.shape
    d = np.abs(_codes(got, "rgb10a2") - _codes(ref, "rgb10a2"))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def _renderer(device, pack=True, interlaced=False):
    """A small headline-shaped renderer (P010 PQ -> SDR RGB10, or c5's
    P010 HLG interlaced source -> RGBA8) with a subtitle and an alpha
    bitmap."""
    from videorenderer_tpu_torch.api import VideoRenderer
    from videorenderer_tpu_torch.subtitles import (TextEvent,
                                                   TextSubtitleProvider)
    vr = VideoRenderer(C.Settings(convert_to_sdr=True,
                                  upscaling=C.Upscaling.LANCZOS3),
                       pack_surface=pack, device=device)
    transfer = S.TRC.HLG if interlaced else S.TRC.PQ
    vr.open(P.SourceDescriptor(format=ColorFormat.P010, width=256, height=128,
                               matrix=S.CSP.BT_2020_NC, levels=S.Levels.TV,
                               primaries=S.Primaries.BT_2020,
                               transfer=transfer, interlaced=interlaced,
                               hdr10=P.HDR10Metadata()),
            P.OutputDescriptor(width=128, height=64,
                               bits=8 if interlaced else 10))
    vr.set_subtitle_provider(TextSubtitleProvider(
        [TextEvent(0.0, 5.0, "Sub", x=4, y=40)], size=12), threaded=False)
    vr.set_alpha_bitmap(np.full((3, 8, 12), 0.8, np.float32),
                        np.full((8, 12), 0.5, np.float32), x=100, y=2)
    return vr


@pytest.mark.parametrize("interlaced", [False, True],
                         ids=["headline", "c5s"])
def test_renderer_on_card_matches_cpu(dev, interlaced):
    """The facade on the card (K1 x3 + K2 a frame, or K7 + K9 a pushed
    frame), overlays on the packed surface, against the CPU renderer."""
    rng = np.random.default_rng(31)
    frames = [tuple(p[0] for p in _p010(rng, 1, 256, 128)) for _ in range(3)]
    outs = {}
    for device in ("cpu", dev):
        vr = _renderer(device, interlaced=interlaced)
        rk.reset_launches()
        got = []
        for i, f in enumerate(frames):
            o = vr.process_frame(tuple(p.numpy() for p in f), time=i / 25)
            got += o if interlaced else [o]
        got += vr.flush()
        if device != "cpu":
            want = (only(deint3_rows_dual=3, cols3_tail=3) if interlaced
                    else only(banded_resize_last_axis=9, rows3_tail=3))
            assert rk.launches == want
            assert "CUDA kernels (sm_90a)" in vr.get_video_processor_info()
        outs[str(device)] = got
    fmt = "rgba8" if interlaced else "rgb10a2"
    assert len(outs["cpu"]) == len(outs[str(dev)]) > 0
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        assert b.device.type == "cuda" and a.shape == b.shape
        d = np.abs(_codes(a, fmt) - _codes(b, fmt))
        assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("fmt", [ColorFormat.P010, ColorFormat.V210,
                                 ColorFormat.R210, ColorFormat.B64A,
                                 ColorFormat.YUY2, ColorFormat.YV12])
def test_process_packed_on_card(dev, fmt):
    """The packed bytes unpacked on the card: the planes equal the host
    unpack_frame's, and process_packed is bit-equal to process of those."""
    from videorenderer_tpu_torch import formats as F
    from videorenderer_tpu_torch.kernels import unpack_device as ud
    w, h = 96, 32
    info = F.get_format_info(fmt)
    nbytes = sum(r * t for r, t, _ in F.plane_segments(info, w, h))
    raw = np.random.default_rng(int(fmt)).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    host = F.unpack_frame(fmt, raw, w, h).planes
    vp = P.VideoProcessor(C.Settings(), P.SourceDescriptor(
        format=fmt, width=w, height=h, matrix=S.CSP.BT_709),
        P.OutputDescriptor(width=64, height=24, bits=10), device=dev,
        pack_surface=True)
    if ud.has_device_unpacker(info.name):
        buf = torch.from_numpy(np.frombuffer(
            raw, ud.DEVICE_BUFFER_DTYPE[info.name]).copy()).to(dev)
        for a, b in zip(ud.unpack_frame_device(info.name, buf, w, h), host):
            assert a.device.type == "cuda"
            assert np.array_equal(a.cpu().numpy(), b)
    assert torch.equal(vp.process_packed(raw), vp.process(host))


def test_run_clip_on_card(dev):
    """Four host batches through pinned staging and a side copy stream:
    each output bit-equal to process of its batch."""
    from videorenderer_tpu_torch.runner import run_clip
    rng = np.random.default_rng(41)
    plan = _small_plan(w=256, h=128, ow=128, oh=64)
    vp = P.VideoProcessor(plan.settings, plan.src, plan.dst, device=dev,
                          pack_surface=True)
    batches = [tuple(p.numpy() for p in _p010(rng, 4, 256, 128))
               for _ in range(4)]
    res = run_clip(vp.process, batches, device=dev)
    assert res.frames == 16 and len(res.outputs) == 4
    for out, b in zip(res.outputs, batches):
        assert torch.equal(out, vp.process(b))


def _model_band(a, b, db, max_abs):
    a, b = a.double().cpu(), b.double().cpu()
    d = (a - b).abs().max().item()
    mse = ((a - b) ** 2).mean().item()
    assert (mse == 0 or 10 * np.log10(1 / mse) >= db) and d <= max_abs, (
        mse, d)


@pytest.mark.parametrize("kind", ["superres", "videohdr"])
def test_shipped_models_on_card_match_cpu(dev, kind):
    """The shipped nets on the card (cuDNN, bf16) against the same nets on
    the CPU, within the bands the CPU tests hold them to against the JAX
    package: SuperRes >= 50 dB and <= 2^-6, VideoHDR >= 80 dB and
    <= 1e-3; a 1080p-sized input's odd crop is padded to the grid."""
    from videorenderer_tpu_torch.models import real_eval, superres, videohdr
    mod = superres if kind == "superres" else videohdr
    load = (real_eval.load_shipped_superres if kind == "superres"
            else real_eval.load_shipped_videohdr)
    x = torch.from_numpy(np.random.default_rng(51).random(
        (2, 3, 134, 243)).astype(np.float32))
    cpu_model = load("cpu")
    card_model = load(dev)
    assert all(p.device.type == "cuda" for p in card_model.parameters())
    want = mod.enhance_plane_chw(cpu_model, x)
    got = mod.enhance_plane_chw(card_model, x.to(dev))
    assert got.device.type == "cuda" and got.shape == want.shape
    if kind == "superres":
        _model_band(got, want, 50.0, 2.0 ** -6)
    else:
        _model_band(got, want, 80.0, 1e-3)
    with pytest.raises(RuntimeError, match="move the model first"):
        mod.enhance_plane_chw(cpu_model, x.to(dev))


def test_model_convs_keep_tf32_off(dev):
    """A float32 config's convs run without TF32 inside the hook, whatever
    the global flag says: they match float64 convs to float32 rounding."""
    from videorenderer_tpu_torch.models import superres
    cfg = superres.SuperResConfig(channels=32, num_blocks=1,
                                  dtype=torch.float32)
    model = superres.init_params(torch.Generator().manual_seed(2), cfg)
    model.tail.weight.normal_(0, 0.01,
                              generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(52).random(
        (1, 3, 64, 96)).astype(np.float32))
    b = torch.backends.cudnn
    prev = b.allow_tf32
    b.allow_tf32 = True
    try:
        got = superres.enhance_plane_chw(model.to(dev), x.to(dev))
        assert b.allow_tf32                      # restored after the hook
    finally:
        b.allow_tf32 = prev
    m64 = superres.SuperRes(superres.SuperResConfig(
        channels=32, num_blocks=1, dtype=torch.float64))
    m64.load_state_dict({k: v.double() for k, v in
                         model.cpu().state_dict().items()})
    want = superres.enhance_plane_chw(m64, x.double())
    assert (got.cpu().double() - want).abs().max().item() < 1e-5


def test_renderer_models_on_card_match_cpu(dev):
    """c3sr's and c1vh's renderer paths at a small size: the pipeline 1:1
    on the kernels (K1 x2 + K2 a frame), then the net, then the pack; the
    card's surface against the CPU renderer's within 3 codes at 8 bits;
    the caller's CPU model stays on the CPU."""
    from videorenderer_tpu_torch.api import VideoRenderer
    from videorenderer_tpu_torch.models import real_eval
    rng = np.random.default_rng(53)
    w, h = 128, 64
    frame = (rng.integers(16, 236, (h, w), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8),
             rng.integers(16, 241, (h // 2, w // 2), np.uint8))
    src = P.SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                             matrix=S.CSP.BT_709, levels=S.Levels.TV)
    for kind in ("superres", "videohdr"):
        if kind == "superres":
            model = real_eval.load_shipped_superres("cpu")
            st = C.Settings(vp_superres=C.SuperResolution.P1080)
            dst = P.OutputDescriptor(width=2 * w, height=2 * h, bits=8)
        else:
            model = real_eval.load_shipped_videohdr("cpu")
            st = C.Settings(vp_rtx_video_hdr=True)
            dst = P.OutputDescriptor(width=w, height=h, bits=10, hdr=True)
        outs = []
        for device in ("cpu", dev):
            vr = VideoRenderer(st, pack_surface=True, device=device)
            (vr.set_superres_params if kind == "superres"
             else vr.set_videohdr_params)(model)
            vr.open(src, dst)
            rk.reset_launches()
            outs.append(vr.process_frame(frame))
            if device != "cpu":
                assert rk.launches == only(banded_resize_last_axis=2,
                                           rows3_tail=1)
        assert next(model.parameters()).device.type == "cpu"
        fmt = "rgba8" if dst.bits == 8 else "rgb10a2"
        d = np.abs(_codes(outs[0], fmt) - _codes(outs[1], fmt))
        assert d.max() <= (3 if dst.bits == 8 else 12), (kind, d.max())


@pytest.mark.parametrize("kind", ["superres", "videohdr"])
def test_train_on_card_matches_cpu(dev, kind):
    """Both trainers at the tiny configs of tests/test_torch_train.py:
    3 steps on the card and on the CPU from the same start and batches,
    each loss within 1%; float32 masters on the card."""
    if kind == "superres":
        from videorenderer_tpu_torch.models import sr_train as t
        from videorenderer_tpu_torch.models import superres as m
        cfg = m.SuperResConfig(channels=16, num_blocks=1, s2d=2)
        data = t.synth_frames(5, 16, 32)
    else:
        from videorenderer_tpu_torch.models import hdr_train as t
        from videorenderer_tpu_torch.models import videohdr as m
        cfg = m.VideoHDRConfig(channels=8)
        data = t.synth_hdr_frames(5, 16, 32, cfg)
    start = m.init_params(torch.Generator().manual_seed(0), cfg)
    runs = [t.train(cfg, 3, 8, data, model=start, device=d)
            for d in ("cpu", dev)]
    rel = np.abs(np.subtract(runs[1][1], runs[0][1])) / np.asarray(
        runs[0][1])
    assert rel.max() <= 0.01, rel
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in runs[1][0].parameters())


def test_one_rank_nccl_mesh_equals_no_mesh(dev):
    import torch.distributed as dist
    from videorenderer_tpu_torch.models import sr_train, superres
    from videorenderer_tpu_torch.parallel.mesh import make_mesh
    cfg = superres.SuperResConfig(channels=16, num_blocks=1, s2d=2)
    data = sr_train.synth_frames(5, 16, 32)
    start = superres.init_params(torch.Generator().manual_seed(0), cfg)
    plain = sr_train.train(cfg, 4, 8, data, model=start, device=dev)
    mesh = make_mesh(device=dev)
    try:
        assert dist.get_backend() == "nccl" and mesh.size == 1
        meshed = sr_train.train(cfg, 4, 8, data, model=start, mesh=mesh,
                                device=dev)
    finally:
        mesh.destroy()
    assert not dist.is_initialized()
    assert plain[1] == meshed[1]
    for k, v in plain[0].state_dict().items():
        assert torch.equal(meshed[0].state_dict()[k], v)


# ---------------------------------------------------------------------------
# parallel/spatial: bands of a frame's rows (K5, K6) and the sharded forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dither_bits", [0, 8, -10])
@pytest.mark.parametrize("geom", K5_GEOMS[:5])
def test_k5_band_of_rows_bit_equal_to_the_frame(dev, geom, dither_bits):
    """K5 on a band of a frame's output rows (jinc2.Jinc2Rows: the source
    rows its taps read, clamped as the frame clamps them) gives the frame's
    rows bit for bit, the dither at the frame's rows included."""
    h, w, oh, ow = geom
    x = torch.from_numpy(np.random.default_rng(8).random(
        (2, h, w), dtype=np.float32)).to(dev)
    epi = jk.dither_epilogue(dither_bits) if dither_bits else None
    full = jk.jinc2_resize_fused(x, oh, ow, epi)
    base, _ = scale.jinc2_axis_tables(h, oh)
    for o0, o1 in ((0, oh // 3), (oh // 3, oh - 5), (oh - 5, oh)):
        lo, hi = int(base[o0]) - 1, int(base[o1 - 1]) + 3
        rows = torch.from_numpy(np.clip(np.arange(lo, hi), 0, h - 1)).to(dev)
        band = jk.jinc2_resize_fused(
            x.index_select(-2, rows).contiguous(), o1 - o0, ow, epi,
            rows=jk.Jinc2Rows(h, oh, o0, lo))
        torch.cuda.synchronize()
        assert torch.equal(band, full[..., o0:o1, :])


def _spatial_case(kind):
    """(plan, planes) on the CPU: a small fused, Dolby Vision or Jinc2 plan
    (widths multiples of 16; 100 rows, which 4 shards pad); "jinc2_vrect"
    letterboxes the Jinc2 output, the form's K5 route."""
    rng = np.random.default_rng(9)
    w, h = 96, 100
    if kind.startswith("jinc2"):
        src = P.SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                                 matrix=S.CSP.BT_709)
        rect = (0, 14, 2 * w, 2 * h - 14) if kind == "jinc2_vrect" else None
        settings, dst = (C.Settings(upscaling=C.Upscaling.JINC2),
                         P.OutputDescriptor(width=2 * w, height=2 * h,
                                            bits=8, video_rect=rect))
        planes = (rng.integers(16, 236, (2, h, w), dtype=np.uint8),
                  *(rng.integers(16, 241, (2, h // 2, w // 2),
                                 dtype=np.uint8) for _ in range(2)))
    else:
        meta = dovi.DoviMetadata(
            curves=(dovi.identity_curve(),) * 3,
            ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                        [1, -0.164553, -0.571353],
                                        [1, 1.8814, 0]]),
            ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
            rgb_to_lms_matrix=np.linalg.inv(dovi.DOVI_LMS2RGB))
        src = P.SourceDescriptor(
            format=ColorFormat.P010, width=w, height=h,
            matrix=S.CSP.BT_2020_NC, primaries=S.Primaries.BT_2020,
            transfer=S.TRC.PQ, dovi=meta if kind == "dovi" else None,
            hdr10=P.HDR10Metadata())
        settings = C.Settings(upscaling=C.Upscaling.LANCZOS3,
                              convert_to_sdr=True)
        dst = P.OutputDescriptor(width=w // 2, height=h // 2, bits=10)
        planes = tuple((rng.integers(64, 941, s, dtype=np.uint16) << 6)
                       for s in ((2, h, w), (2, h // 2, w // 2),
                                 (2, h // 2, w // 2)))
    return P.plan_pipeline(settings, src, dst), tuple(
        torch.from_numpy(p) for p in planes)


@pytest.mark.parametrize("kind", ["fused", "dovi", "jinc2", "jinc2_vrect"])
def test_spatial_shards_on_card_bit_equal_to_one(dev, kind):
    """Four shards of a plan run one after another on the card
    (spatial.drive_shards_locally) give the one-shard surface bit for bit,
    each shard's H passes on its own K3 table or its band of K5's or K6's
    rows; one shard against the unsharded frame function: the Jinc2 form's
    K6 route bit-equal to K6, the others within K2's band (1 code on
    < 2%)."""
    from videorenderer_tpu_torch.parallel import spatial as sp
    plan, planes = _spatial_case(kind)
    planes = tuple(p.to(dev) for p in planes)

    def build(sh):
        return sp.make_spatial_frame_fn(plan, sh, pack_surface=True)

    one = build(sp.Shard(0, 1))(planes)
    four = torch.cat(sp.drive_shards_locally(
        build, lambda r: sp.pad_shard_planes_rows(plan, sp.Shard(r, 4),
                                                  planes), 4), dim=-2)
    h = plan.dst.height
    assert torch.equal(four[..., :h, :], one)
    ref = P.make_frame_fn(plan, pack_surface=True)(planes)
    if kind == "jinc2":
        assert torch.equal(one, ref)
    else:
        bits = plan.dst.bits
        d = np.abs(_codes(one, "rgb10a2" if bits == 10 else "rgba8")
                   - _codes(ref, "rgb10a2" if bits == 10 else "rgba8"))
        if kind == "dovi":      # the JAX spatial DoVi band
            assert d.max() <= 1.5 / 255 * 1023 and (
                d > 0.5 / 255 * 1023).mean() < 1e-3
        else:
            assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_spatial_learned_shards_on_card(dev):
    """The learned form with the shipped SuperRes as four shards on the
    card (40 halo rows zeroed outside the frame, ``row_valid``, the s2d
    unit's pad 168 -> 176 rows, the crop): the stitched surface bit-equal
    to one shard's, and one shard >= 50 dB against the net on the
    unsharded frame function's output (tests/test_torch_models.py's band)."""
    from videorenderer_tpu_torch.models import real_eval, superres
    from videorenderer_tpu_torch.parallel import spatial as sp
    model = real_eval.load_shipped_superres(dev)
    rng = np.random.default_rng(10)
    w, h = 96, 168
    src = P.SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                             matrix=S.CSP.BT_709)
    plan = P.plan_pipeline(C.Settings(vp_superres=C.SuperResolution.P1080),
                           src, P.OutputDescriptor(width=w, height=h, bits=8))
    planes = tuple(torch.from_numpy(p).to(dev) for p in (
        rng.integers(16, 236, (2, h, w), dtype=np.uint8),
        *(rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8)
          for _ in range(2))))

    def build(sh):
        return sp.make_spatial_learned_fn(plan, sh, model, "superres",
                                          pack_surface=True)

    one = build(sp.Shard(0, 1))(planes)
    four = torch.cat(sp.drive_shards_locally(
        build, lambda r: sp.pad_shard_planes_rows(plan, sp.Shard(r, 4),
                                                  planes), 4), dim=-2)
    assert four.shape[-2] == 2 * 176
    assert torch.equal(four[..., :2 * h, :], one)
    ref = rk.pack_surface(superres.enhance_plane_chw(
        model, P.make_frame_fn(plan)(planes)), "rgba8")
    d = (_codes(one, "rgba8") - _codes(ref, "rgba8")) / 255.0
    assert np.mean(d ** 2) <= 1e-5             # >= 50 dB
