"""The tiled indexing of K7 (``csrc/deint3_rows_dual.cu``) and K9
(``csrc/cols3_tail.cuh``) replayed in torch on the CPU.

Each kernel is replayed twice with the same float32 arithmetic: once as the
one-output-a-thread kernels it replaces index the planes (the tap replay),
once as the tiled kernel indexes its staged windows (the tiled replay).
The two are bit-equal exactly when the tiled indexing is right: the window
of every tile (``row_windows``; K7's cur widened by the clamped neighbour
rows, K9's span from a start rounded down to 16 bytes), the window-relative
index of every tap, the early stop at the plane's last row (K7) and the
skip of taps past the row's end (K9).  Both are held against the plain
versions within K7's and K9's bands.  The maps are c5's (4K -> 1080p
Lanczos3, the chroma upsample composed in), c8's (Catmull-Rom 2:1) and an
edge map whose last outputs' taps run past the plane.  The shared-memory
formulas and the widened windows are checked here too.
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch import config as C, csputils as S
from videorenderer_tpu_torch.kernels import deint as dk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import chroma, scale

N16 = 1 / 65535.0


def _edge_map():
    """A banded (14, 7) map whose last output's band holds the last two
    inputs while the widest band is 4: its taps 2 and 3 lie past the
    plane."""
    m = np.zeros((14, 7), np.float32)
    for j in range(6):
        m[2 * j:2 * j + 4, j] = [0.1, 0.4, 0.4, 0.1]
    m[12:14, 6] = [0.5, 0.5]
    return m


def _c5_matrices():
    wy = scale.upscale_matrix(C.Upscaling.LANCZOS3, 2160, 1080)
    wx = scale.upscale_matrix(C.Upscaling.LANCZOS3, 3840, 1920)
    ux, uy = chroma.chroma_upsample_matrices(
        1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    return wx, wy, ux @ wx, uy @ wy


def _maps():
    wx, wy, cwx, cwy = _c5_matrices()
    c8 = scale.upscale_matrix(C.Upscaling.CATMULL_ROM, 3840, 1920)
    return {
        # K7's H maps, the normalisation folded in as the path folds it
        "c5_luma_h": rk.BandedMatrix(wy, pre_scale=N16),
        "c5_chroma_h": rk.BandedMatrix(cwy, pre_scale=N16),
        "edge_h": rk.BandedMatrix(_edge_map(), pre_scale=N16),
        # K9's W maps
        "c5_luma_w": rk.BandedMatrix(wx),
        "c5_chroma_w": rk.BandedMatrix(cwx),
        "c8_w": rk.BandedMatrix(c8),
        "edge_w": rk.BandedMatrix(_edge_map()),
    }


MAPS = _maps()
H_MAPS = [k for k in MAPS if k.endswith("_h")]
W_MAPS = [k for k in MAPS if k.endswith("_w")]


# --- K7 -----------------------------------------------------------------------

def _k7_window_rows(lo, win, h):
    """The input rows K7 stages of cur for a tile whose window (of a map's
    row_windows) starts at row ``lo`` of a plane of ``h`` rows
    (csrc/deint3_rows_dual.cu: stage_rows): the window widened by the
    neighbour row above and below, each clamped to the plane; prev and next
    stage the middle ``win`` of them.  Rows past the plane's end (a last
    window shorter than ``win``) are not staged."""
    n = min(win, h - lo)
    return np.clip(np.arange(lo - 1, lo + n + 1), 0, h - 1)


def _select(r, h, up, cur, dn, ramp, use_top):
    """The deinterlaced value of input rows ``r`` (a tensor broadcast over
    the planes' rows) of one field, in the kernel's operation order
    (field_value): the kept field's rows are cur, the other field's bob
    between its clamped neighbours, mixed by the ramp."""
    if use_top:
        dn = torch.where(r == h - 1, up, dn)
    else:
        up = torch.where(r == 0, dn, up)
    bob = (up + dn) * 0.5
    mixed = cur + (bob - cur) * ramp
    return torch.where((r & 1) == (1 if use_top else 0), mixed, cur)


def _ramp(pr, nx, thr):
    thr_t = torch.tensor(thr, dtype=torch.float32)
    return torch.clamp((torch.abs(nx - pr) - thr_t) / thr_t, 0.0, 1.0)


def _k7_tap_replay(prev, cur, nxt, mat, thr, tff):
    """The one-output-a-thread K7: each output row m walks its taps from
    starts[m], carrying cur's rows above and at the tap, loading the row
    below, prev and next at each tap row, until the plane's last row."""
    h = cur.shape[-2]
    pf, cf, nf = (x.to(torch.float32) for x in (prev, cur, nxt))
    outs = [torch.zeros(cf.shape[:-2] + (mat.out_size, cf.shape[-1]))
            for _ in range(2)]
    for m in range(mat.out_size):
        s = int(mat.starts[m])
        up, c = cf[..., max(s - 1, 0), :], cf[..., s, :]
        acc = [torch.zeros_like(c), torch.zeros_like(c)]
        for t in range(mat.n_taps):
            r = s + t
            if r >= h:
                break
            dn = cf[..., min(r + 1, h - 1), :]
            ramp = _ramp(pf[..., r, :], nf[..., r, :], thr)
            rr = torch.tensor(r)
            wt = float(mat.taps[t, m])
            for f, use_top in enumerate((tff, not tff)):
                acc[f] = acc[f] + _select(rr, h, up, c, dn, ramp,
                                          use_top) * wt
            up, c = c, dn
        for f in range(2):
            outs[f][..., m, :] = acc[f]
    return torch.stack(outs, dim=-3)


def _k7_tiled_replay(prev, cur, nxt, mat, thr, tff, tile=dk.K7_TILE_ROWS,
                     cols=dk.K7_TILE_COLS):
    """The tiled K7: per tile of ``tile`` output rows x ``cols`` columns,
    the window of row_windows with cur widened by the clamped neighbour
    rows (_k7_window_rows) and columns past the plane zero; both fields'
    values once per window pixel; then each output's taps read at the
    window-relative row, until the plane's last row."""
    h, w = cur.shape[-2:]
    lo_t, win = mat.row_windows(tile)
    wpad = -(-w // cols) * cols
    pad = (0, wpad - w)
    pf, cf, nf = (torch.nn.functional.pad(x.to(torch.float32), pad)
                  for x in (prev, cur, nxt))
    outs = torch.zeros(cf.shape[:-2] + (2, mat.out_size, wpad))
    for k, lo in enumerate(lo_t.tolist()):
        rows = torch.from_numpy(_k7_window_rows(lo, win, h))
        n = len(rows) - 2
        assert n == min(win, h - lo)
        for c0 in range(0, wpad, cols):
            cw = cf[..., rows, c0:c0 + cols]
            pw = pf[..., lo:lo + n, c0:c0 + cols]
            nw = nf[..., lo:lo + n, c0:c0 + cols]
            r = torch.arange(lo, lo + n).view(n, 1)
            ramp = _ramp(pw, nw, thr)
            fields = [_select(r, h, cw[..., :-2, :], cw[..., 1:-1, :],
                              cw[..., 2:, :], ramp, use_top)
                      for use_top in (tff, not tff)]
            for m in range(k * tile, min((k + 1) * tile, mat.out_size)):
                s = int(mat.starts[m])
                acc = [torch.zeros(cf.shape[:-2] + (cols,)) for _ in range(2)]
                for t in range(mat.n_taps):
                    rt = s + t
                    if rt >= h:
                        break
                    assert 0 <= rt - lo < n
                    wt = float(mat.taps[t, m])
                    for f in range(2):
                        acc[f] = acc[f] + fields[f][..., rt - lo, :] * wt
                for f in range(2):
                    outs[..., f, m, c0:c0 + cols] = acc[f]
    return outs[..., :w]


def _c5_planes(rng, n, h, w):
    """(prev, cur, next) uint16 P010 planes, next equal to prev on the left
    half: the weave, the ramp and the bob all occur."""
    p, c, x = (torch.from_numpy(rng.integers(64, 941, (n, h, w),
                                             dtype=np.uint16) << 6)
               for _ in range(3))
    x = torch.cat([p[..., :w // 2], x[..., w // 2:]], dim=-1)
    return p, c, x


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("tile", [dk.K7_TILE_ROWS, 1, 5])
@pytest.mark.parametrize("which", H_MAPS)
def test_k7_tiled_replay_matches_tap_replay_and_plain(which, tile, tff):
    """K7's tiled indexing gives the bits of the tap replay on c5's luma
    and chroma H maps (every tile of the 1080 output rows) and on the edge
    map, for the kernel's tile and two others; both within 2e-5 of the
    plain version.  70 columns: a full column tile and a ragged one."""
    mat = MAPS[which]
    rng = np.random.default_rng(40)
    prev, cur, nxt = _c5_planes(rng, 1, mat.in_size, 70)
    thr = 8.0 / 255.0 * 65535.0
    taps = _k7_tap_replay(prev, cur, nxt, mat, thr, tff)
    tiled = _k7_tiled_replay(prev, cur, nxt, mat, thr, tff, tile=tile)
    assert torch.equal(tiled, taps)
    plain = dk.deint3_rows_dual_plain((prev,) * 3, (cur,) * 3, (nxt,) * 3,
                                      mat, mat, mat.out_size, thr, tff)[0]
    assert plain.shape == taps.shape
    assert (taps - plain).abs().max().item() <= 2e-5


def test_k7_window_rows_widen_by_the_clamped_neighbours():
    """For every tile of c5's maps and the edge map, the staged cur rows are
    the window widened by one row above and below, clamped to the plane,
    and they hold the neighbours of every row the tile's taps reach."""
    for which in H_MAPS:
        mat = MAPS[which]
        h = mat.in_size
        lo_t, win = mat.row_windows(dk.K7_TILE_ROWS)
        for k, lo in enumerate(lo_t.tolist()):
            rows = _k7_window_rows(lo, win, h)
            n = min(win, h - lo)
            assert len(rows) == n + 2
            assert rows[0] == max(lo - 1, 0) and rows[-1] == min(lo + n, h - 1)
            j = np.arange(k * dk.K7_TILE_ROWS,
                          min((k + 1) * dk.K7_TILE_ROWS, mat.out_size))
            reach = (mat.starts[j][:, None] + np.arange(mat.n_taps)).ravel()
            reach = reach[reach < h]
            assert (reach >= lo).all() and (reach < lo + n).all()
            # row r's neighbours sit at window rows r - lo and r - lo + 2
            assert (rows[reach - lo] == np.maximum(reach - 1, 0)).all()
            assert (rows[reach - lo + 2] == np.minimum(reach + 1, h - 1)).all()


def test_k7_windows_on_host_and_device():
    """The tiles' first rows K7 takes on the device are row_windows' host
    array, and the edge map's windows are the ones worked out by hand."""
    for which in H_MAPS:
        mat = MAPS[which]
        lo, win = mat.row_windows(dk.K7_TILE_ROWS)
        lo_d, win_d = mat.row_windows(dk.K7_TILE_ROWS, "cpu")
        assert torch.equal(lo_d, torch.from_numpy(lo)) and win_d == win
    lo, win = MAPS["edge_h"].row_windows(5)
    assert lo.tolist() == [0, 10] and win == 12
    assert _k7_window_rows(10, 12, 14).tolist() == [9, 10, 11, 12, 13, 13]


# --- K9 -----------------------------------------------------------------------

def _k9_tap_replay(x, mat):
    """The one-pixel-a-thread K9's W pass: each output column sums
    x[starts + t] * taps[t] over its taps, those past the row skipped."""
    n_in = mat.in_size
    starts, taps = (torch.from_numpy(a) for a in (mat.starts, mat.taps))
    xf = x.to(torch.float32)
    acc = torch.zeros(x.shape[:-1] + (mat.out_size,))
    for t in range(mat.n_taps):
        idx = starts.long() + t
        acc = acc + torch.where(idx < n_in,
                                xf[..., idx.clamp(max=n_in - 1)] * taps[t],
                                0.0)
    return acc


def _k9_tiled_replay(x, mat, tile=dk.K9_TILE_COLS):
    """The tiled K9's W pass: per tile of ``tile`` output columns, the span
    of row_windows from a start rounded down to 16 bytes of the plane's
    dtype, k9_pitch elements at most and none past the row; each column's
    taps read at the span-relative index, those past the row skipped; a
    column past the outputs starts at the row's end."""
    itemsize = x.element_size()
    chunk = 16 // itemsize
    lo_t, win = mat.row_windows(tile)
    pitch = dk.k9_pitch(win, itemsize)
    n_in = mat.in_size
    starts = torch.from_numpy(mat.starts).long()
    taps = torch.from_numpy(mat.taps)
    xf = x.to(torch.float32)
    acc = torch.zeros(x.shape[:-1] + (mat.out_size,))
    for k, lo in enumerate(lo_t.tolist()):
        lo_al = lo - lo % chunk
        count = min(pitch, n_in - lo_al)
        span = xf[..., lo_al:lo_al + count]
        j = torch.arange(k * tile, (k + 1) * tile)
        inside = j < mat.out_size
        local = torch.where(inside, starts[j.clamp(max=mat.out_size - 1)],
                            n_in) - lo_al
        assert (local >= 0).all()
        lim = n_in - lo_al
        part = torch.zeros(x.shape[:-1] + (tile,))
        for t in range(mat.n_taps):
            i = local + t
            ok = i < lim
            assert (i[ok] < count).all()
            wt = torch.where(inside, taps[t, j.clamp(max=mat.out_size - 1)],
                             0.0)
            part = part + torch.where(ok, span[..., i.clamp(max=count - 1)]
                                      * wt, 0.0)
        acc[..., j[inside]] = part[..., inside]
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16, torch.uint8])
@pytest.mark.parametrize("tile", [dk.K9_TILE_COLS, 5])
@pytest.mark.parametrize("which", W_MAPS)
def test_k9_tiled_replay_matches_tap_replay_and_plain(which, tile, dtype):
    """K9's tiled W indexing gives the bits of the tap replay on c5's luma
    and chroma W maps, c8's and the edge map, every tile of the outputs,
    for float32 (the paths' planes) and raw integer planes (another
    16-byte rounding of the span's start); within 2e-6 of the plain
    version's W product."""
    mat = MAPS[which]
    rng = np.random.default_rng(41)
    if dtype == torch.float32:
        x = torch.from_numpy(rng.random((2, 3, mat.in_size), dtype=np.float32))
    else:
        x = torch.from_numpy(rng.integers(
            0, 256 if dtype == torch.uint8 else 65536, (2, 3, mat.in_size))
            .astype(np.uint8 if dtype == torch.uint8 else np.uint16))
    taps = _k9_tap_replay(x, mat)
    assert torch.equal(_k9_tiled_replay(x, mat, tile), taps)
    plain = dk._w_plain(x, mat, None)
    scale_ = float(x.to(torch.float32).max())
    assert (taps - plain).abs().max().item() <= 2e-6 * scale_


def test_k9_route_order_covers_each_column_once():
    """A thread's 4 columns in the order the kernel walks them (starting at
    column (lane / 8) % 4): every column once, and at 2:1 a warp's reads of
    one tap fall in 16 distinct banks of 4-byte words."""
    kv = 4
    for lane in range(32):
        rot = (lane >> 3) & 3
        order = [(j + rot) & 3 for j in range(kv)]
        assert sorted(order) == list(range(kv))
        # the pick that undoes it: column k's sum is acc[(k - rot) & 3]
        assert all(order[(k - rot) & 3] == k for k in range(kv))
    for j in range(kv):
        banks = {(2 * (lane * kv + ((j + ((lane >> 3) & 3)) & 3))) % 32
                 for lane in range(32)}
        assert len(banks) == 16


# --- shared memory and the grid -------------------------------------------------

def test_k7_k9_smem_at_c5_and_c8():
    """K7 at c5's uint16 planes and K9 at c5's and c8's float32 planes fit
    SMEM_BUDGET with room for at least 2 blocks an SM (228 KB, 1 KB
    reserved a block), and the formulas count what the kernels lay out."""
    my, mc = MAPS["c5_luma_h"], MAPS["c5_chroma_h"]
    k7 = dk.k7_smem_bytes(2, my, mc)
    win_y = my.row_windows(dk.K7_TILE_ROWS)[1]
    assert k7 == (2 * win_y * 64 * 4 + 4 * 32 * (my.n_taps + 1)
                  + (3 * win_y + 2) * 64 * 2)
    assert 2 * (k7 + 1024) <= 228 * 1024
    assert dk.k7_smem_bytes(4, my, mc) <= rk.SMEM_BUDGET
    mx, mxc, m8 = MAPS["c5_luma_w"], MAPS["c5_chroma_w"], MAPS["c8_w"]
    k9_c5 = dk.k9_smem_bytes(4, 4, mx, mxc)
    wy = mx.row_windows(dk.K9_TILE_COLS)[1]
    wc = mxc.row_windows(dk.K9_TILE_COLS)[1]
    assert k9_c5 == (2 * dk.K9_WARPS
                     * (dk.k9_pitch(wy, 4) + 2 * dk.k9_pitch(wc, 4)) * 4
                     + 4 * 128 * (mx.n_taps + 1 + mxc.n_taps + 1))
    k9_c8 = dk.k9_smem_bytes(4, 4, m8, m8)
    for b in (k9_c5, k9_c8):
        assert 2 * (b + 1024) <= 228 * 1024
    # K1's rounding: a span from a start rounded down to 16 bytes
    assert dk.k9_pitch(260, 4) == 264 and dk.k9_pitch(5, 1) == 32
    assert dk.k9_smem_bytes(4, 4, None, None) == 0


def test_k7_k9_oversized_windows_exceed_the_budget():
    """A box average of 8192 inputs into 4 outputs (every output reads
    every input): its window does not fit a block, so the wrappers refuse
    it on the card before the launch."""
    box = rk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert dk.k7_smem_bytes(1, box, box) > rk.SMEM_BUDGET
    assert dk.k9_smem_bytes(4, 4, box, None) > rk.SMEM_BUDGET
    assert dk.k9_smem_bytes(1, 1, None, box) > rk.SMEM_BUDGET
