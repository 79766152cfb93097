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


def _replay_tiled(x: torch.Tensor, mat: trk.BandedMatrix,
                  tile: int) -> torch.Tensor:
    """What the tiled kernels compute for each output, in torch, from the
    block's window: outputs in tiles of ``tile`` (K2's output rows, K1's
    spans of output columns), each tile's window of inputs starting at its
    first input (``row_windows``), each output's taps read at the
    window-relative index start - first, taps past the input edge
    skipped.  The arithmetic is _replay_taps's, so the two are bit-equal
    exactly when the indexing is."""
    lo_t, win = mat.row_windows(tile)
    assert isinstance(lo_t, np.ndarray)
    n_in = mat.in_size
    starts = torch.from_numpy(mat.starts).long()
    taps = torch.from_numpy(mat.taps)
    xf = x.to(torch.float32)
    acc = torch.zeros(x.shape[:-1] + (mat.out_size,), dtype=torch.float32)
    for k, lo in enumerate(lo_t.tolist()):
        j = torch.arange(k * tile, min((k + 1) * tile, mat.out_size))
        window = xf[..., lo:min(lo + win, n_in)]
        local = starts[j] - lo
        assert (local >= 0).all()
        part = torch.zeros(x.shape[:-1] + (len(j),), dtype=torch.float32)
        for t in range(mat.n_taps):
            ok = starts[j] + t < n_in
            idx = local + t
            assert (idx[ok] < window.shape[-1]).all()
            part += torch.where(
                ok, window[..., idx.clamp(max=window.shape[-1] - 1)]
                * taps[t, j], 0.0)
        acc[..., j] = part
    return acc


def _path_maps():
    """The H maps (and the headline's W maps) the port's paths give K1 and
    K2, from pipeline.fused_maps of the headline, c7 and c5 plans, with the
    mid16 unscale (or the normalisation) folded in as the route folds it."""
    def plan(settings, src, dst):
        return tpipe.plan_pipeline(settings, src, dst)

    def p010(w, h, transfer, **kw):
        return tpipe.SourceDescriptor(
            format=TFmt.P010, width=w, height=h, matrix=tcsp.CSP.BT_2020_NC,
            levels=tcsp.Levels.TV, primaries=tcsp.Primaries.BT_2020,
            transfer=transfer, **kw)

    head = plan(tcfg.Settings(upscaling=tcfg.Upscaling.LANCZOS3,
                              chroma_scaling=tcfg.ChromaScaling.BILINEAR,
                              convert_to_sdr=True, use_dither=True),
                p010(3840, 2160, tcsp.TRC.PQ, hdr10=tpipe.HDR10Metadata()),
                tpipe.OutputDescriptor(width=1920, height=1080, bits=10))
    c7 = plan(tcfg.Settings(convert_to_sdr=False, hdr_passthrough=True,
                            hdr_local_tone_mapping=True,
                            hdr_display_max_nits=600),
              p010(3840, 2160, tcsp.TRC.PQ, hdr10=tpipe.HDR10Metadata(
                  mastering_max_nits=4000.0, max_cll=3000.0)),
              tpipe.OutputDescriptor(width=3840, height=2160, bits=10,
                                     hdr=True))
    c5 = plan(tcfg.Settings(convert_to_sdr=True,
                            upscaling=tcfg.Upscaling.LANCZOS3),
              p010(3840, 2160, tcsp.TRC.HLG, interlaced=True),
              tpipe.OutputDescriptor(width=1920, height=1080, bits=8))
    unscale = 1.0 / trk.MID16_SCALE
    maps = {}
    for name, p in (("headline", head), ("c7", c7), ("c5", c5)):
        wx, wy, cwx, cwy, norm = tpipe.fused_maps(p)
        if wx is not None:
            maps[f"{name}_luma_w"] = trk.BandedMatrix(wx, pre_scale=norm)
        if cwx is not None:
            maps[f"{name}_chroma_w"] = trk.BandedMatrix(cwx, pre_scale=norm)
        if wy is not None:
            maps[f"{name}_luma_h"] = trk.BandedMatrix(wy, pre_scale=unscale)
        if cwy is not None:
            maps[f"{name}_chroma_h"] = trk.BandedMatrix(cwy,
                                                        pre_scale=unscale)
    return maps


def _edge_map():
    """A banded (14, 7) map whose last column's band holds the last two
    inputs while the widest band is 4: its taps 2 and 3 lie past the input
    edge."""
    m = np.zeros((14, 7), np.float32)
    for j in range(6):
        m[2 * j:2 * j + 4, j] = [0.1, 0.4, 0.4, 0.1]
    m[12:14, 6] = [0.5, 0.5]
    return trk.BandedMatrix(m)


PATH_MAPS = _path_maps()
TILES = [trk.K2_TILE_ROWS, trk.K1_SPAN, trk.K4_TILE_ROWS, 1, 5]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("which", sorted(PATH_MAPS) + ["edge"])
def test_tiled_replay_matches_tap_replay(which, tile):
    """The window-relative indexing of the tiled K1 and K2 (tile first
    input from row_windows, local index = start - first input) gives the
    same bits as the plain tap replay on the paths' maps, on a map with
    taps past the input edge, and for every tile the kernels use (and two
    that do not divide the outputs)."""
    mat = _edge_map() if which == "edge" else PATH_MAPS[which]
    if which == "edge":
        assert mat.starts[-1] + mat.n_taps > mat.in_size
    x = torch.from_numpy(_u16((2, 3, mat.in_size), seed=5))
    assert torch.equal(_replay_tiled(x, mat, tile), _replay_taps(x, mat))


def test_path_windows_fit_the_shared_memory_budget():
    """Every map the paths give K1 and K2 fits SMEM_BUDGET at the plane
    dtypes they take (K1: raw uint16 or float32 planes; K2: mid16 or
    float32), and the formulas count what the kernels lay out."""
    for name, mat in PATH_MAPS.items():
        win = mat.row_windows(trk.K1_SPAN)[1]
        if name.endswith("_w"):
            for item in (2, 4):
                assert trk.k1_smem_bytes(item, win) <= trk.SMEM_BUDGET
    head_y, head_c = PATH_MAPS["headline_luma_h"], PATH_MAPS["headline_chroma_h"]
    for item in (2, 4):
        assert trk.k2_smem_bytes(item, item, head_y, head_c) <= trk.SMEM_BUDGET
    assert trk.k2_smem_bytes(2, 4, None, PATH_MAPS["c7_chroma_h"]) \
        <= trk.SMEM_BUDGET
    # the layouts: K1 rounds each row's span to 16-byte pieces from a start
    # rounded down; K2 stages win rows x 128 columns a plane, then each
    # map's taps and starts for its tile rows
    assert trk.k1_smem_bytes(2, 516) == trk.K1_ROWS * 528 * 2
    assert trk.k1_smem_bytes(4, 5, rows=3) == 3 * 8 * 4
    wy = head_y.row_windows(trk.K2_TILE_ROWS)[1]
    wc = head_c.row_windows(trk.K2_TILE_ROWS)[1]
    assert trk.k2_smem_bytes(2, 2, head_y, head_c) == (
        (wy + 2 * wc) * trk.K2_TILE_COLS * 2
        + 4 * trk.K2_TILE_ROWS * (head_y.n_taps + 1 + head_c.n_taps + 1))
    assert trk.k2_smem_bytes(1, 1, None, None) == 0


def test_oversized_windows_exceed_the_budget():
    """A box average of 8192 inputs into 4 outputs (every output reads
    every input) needs more shared memory than a block has at float32 (at
    uint8, K1's rows of it still fit): the wrappers refuse such a map on
    the card before the launch."""
    mat = trk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert mat.n_taps == 8192 and mat.row_windows(trk.K1_SPAN)[1] == 8192
    assert trk.k1_smem_bytes(4, 8192) > trk.SMEM_BUDGET
    assert trk.k1_smem_bytes(1, 8192) <= trk.SMEM_BUDGET
    assert trk.k2_smem_bytes(4, 4, mat, mat) > trk.SMEM_BUDGET


def test_row_windows_on_host_and_device():
    mat = _edge_map()
    lo, win = mat.row_windows(3)
    assert lo.tolist() == [0, 6, 12] and win == 8
    lo_t, win_t = mat.row_windows(3, "cpu")
    assert torch.equal(lo_t, torch.from_numpy(lo)) and win_t == win


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
