"""K5's and K3's tiled indexing (``csrc/jinc2_resize.cu``,
``csrc/banded_resize_rows.cu``) replayed in numpy and torch on the CPU.

K5: a block makes a 32 x 128 output tile of one plane from the source
window its taps reach, staged from a column rounded down to 4; a thread
makes 4 adjacent outputs of a row in 4 rows 8 apart, lanes 16-31 in the
order 2, 3, 0, 1.  Here: every tap of a tile lies in its window and the
window in the block's shared memory (``k5_window``), at c3 (and c3r270,
whose K5 runs c3's geometry), c3rot and the card tests' geometries; a
replay of the staged gather with the table's weights gives the plain
version's outputs bit for bit; each output is made once and stored in its
column; a warp's tap reads fall in distinct banks at 2x; the weights
gathered from the table equal the per-output weights; the route choice; a
CPU call builds no table.

K3: a block makes up to 32 output rows x 128 columns from the window of
input rows ``BandedMatrix.row_windows`` gives.  Here: the windows cover
every tap at the letterbox's two maps and edge maps, a replay of the tiled
sums equals the one-output-a-thread sums bit for bit, and the shared-memory
formula and tile rows.  No GPU, no JAX, no triton.
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch import config as C, csputils as S
from videorenderer_tpu_torch.kernels import jinc2 as jk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import chroma, scale

TR, TC = jk.K5_TILE_ROWS, jk.K5_TILE_COLS
C3 = (1080, 1920, 2160, 3840)        # h, w, out_h, out_w; c3r270's K5 too
C3ROT = (1080, 1920, 3840, 2160)
CARD = [(27, 48, 54, 96), (30, 40, 61, 90), (27, 48, 96, 54),
        (32, 48, 64, 48)]              # tests/test_torch_cuda.py's K5 cases
SMALL = CARD + [(40, 300, 80, 1000), (1079, 67, 2160, 133), (7, 5, 20, 9)]


def _tile_windows(h, w, out_h, out_w):
    """Each tile's (wy0, rows, sx0, staged columns) as the kernel computes
    them: rows by[r0] - 1 .. by[r1 - 1] + 2, columns from bx[c0] - 1
    rounded down to 4 through bx[c1 - 1] + 2, rounded up to 4."""
    by, _ = scale.jinc2_axis_tables(h, out_h)
    bx, _ = scale.jinc2_axis_tables(w, out_w)
    rows = []
    for r0 in range(0, out_h, TR):
        r1 = min(r0 + TR, out_h)
        wy0 = int(by[r0]) - 1
        rows.append((r0, r1, wy0, int(by[r1 - 1]) + 3 - wy0))
    cols = []
    for c0 in range(0, out_w, TC):
        c1 = min(c0 + TC, out_w)
        wx0 = int(bx[c0]) - 1
        sx0 = wx0 - (wx0 & 3)
        cols.append((c0, c1, sx0, (int(bx[c1 - 1]) + 3 - sx0 + 3) // 4 * 4))
    return by, bx, rows, cols


@pytest.mark.parametrize("geom", [C3, C3ROT] + SMALL)
def test_k5_window_covers_every_tap_and_fits_its_block(geom):
    """Every tap row (by - 1 + jo) and column (bx - 1 + io) of a tile's
    outputs lies inside the tile's window, the window inside the block's
    win_h rows x pitch columns, and sx0 is a multiple of 4 at most 3 left
    of the first tap (so the 16-byte chunks start aligned)."""
    h, w, out_h, out_w = geom
    win_h, pitch, smem = jk.k5_window(*geom)
    assert pitch % 4 == 0 and smem == 4 * win_h * pitch
    by, bx, rows, cols = _tile_windows(*geom)
    for r0, r1, wy0, nwh in rows:
        assert nwh <= win_h
        rel = by[r0:r1, None] - 1 + np.arange(4) - wy0
        assert rel.min() == 0 and rel.max() == nwh - 1
    for c0, c1, sx0, ncols in cols:
        assert sx0 % 4 == 0 and 0 <= int(bx[c0]) - 1 - sx0 <= 3
        assert ncols <= pitch
        rel = bx[c0:c1, None] - 1 + np.arange(4) - sx0
        assert rel.min() >= 0 and rel.max() < ncols


def _staged_gather(x, geom):
    """The kernel's 16 taps of every output, read from each tile's staged
    window: row wy0 + r and column sx0 + c of the window hold the plane's
    clamped (row, column); (..., out_h, out_w, 16), tap jo * 4 + io."""
    h, w, out_h, out_w = geom
    by, bx, rows, cols = _tile_windows(*geom)
    win_h, pitch, _ = jk.k5_window(*geom)
    out = torch.empty(x.shape[:-2] + (out_h, out_w, 16), dtype=x.dtype)
    for r0, r1, wy0, nwh in rows:
        src_r = torch.clamp(torch.arange(wy0, wy0 + nwh), 0, h - 1)
        for c0, c1, sx0, ncols in cols:
            src_c = torch.clamp(torch.arange(sx0, sx0 + ncols), 0, w - 1)
            win = x[..., src_r, :][..., src_c]          # the staged window
            wr = torch.from_numpy(by[r0:r1].astype(np.int64)) - 1 - wy0
            wc = torch.from_numpy(bx[c0:c1].astype(np.int64)) - 1 - sx0
            for jo in range(4):
                for io in range(4):
                    out[..., r0:r1, c0:c1, jo * 4 + io] = \
                        win[..., wr + jo, :][..., wc + io]
    return out


def _resolve(t, wt):
    """jinc2.cuh's jinc2_resolve on gathered taps and table entries, in
    its order: products and sums in tap order, the division by the
    entry's sum, the anti-ringing toward the centre 2x2."""
    acc = t[..., 0] * wt[..., 0]
    for k in range(1, 16):
        acc = acc + t[..., k] * wt[..., k]
    out = acc / wt[..., 16]
    mn = torch.minimum(torch.minimum(t[..., 5], t[..., 6]),
                       torch.minimum(t[..., 9], t[..., 10]))
    mx = torch.maximum(torch.maximum(t[..., 5], t[..., 6]),
                       torch.maximum(t[..., 9], t[..., 10]))
    clamped = torch.minimum(torch.maximum(out, mn), mx)
    return out + (clamped - out) * scale._JINC2_AR_STRENGTH


@pytest.mark.parametrize("geom", SMALL + [(64, 96, 128, 192)])
def test_k5_staged_replay_equals_plain_bit_for_bit(geom):
    """The staged window's taps weighted by the table entry of each
    output's (row class, column class) give the plain version's outputs
    bit for bit: the window holds the clamped taps, the table the
    per-output weights."""
    h, w, out_h, out_w = geom
    rng = np.random.default_rng(80)
    x = torch.from_numpy(rng.random((2, h, w), dtype=np.float32))
    t = _staged_gather(x, geom)
    rcls, rrep = jk.axis_classes(h, out_h)
    ccls, crep = jk.axis_classes(w, out_w)
    table = jk.jinc2_weight_table(torch.tensor(rrep), torch.tensor(crep))
    wt = table[torch.from_numpy(rcls.astype(np.int64))][
        :, torch.from_numpy(ccls.astype(np.int64))]
    got = _resolve(t, wt)
    want = jk.jinc2_resize_fused_plain(x, out_h, out_w)
    assert torch.equal(got, want)


def _thread_columns(tx):
    """Output columns (relative to the tile) of a thread's outputs k =
    0..3, and the one its store puts in column j: the kernel's res[k] is
    column 4 tx + (k ^ sw), and the store writes res[j ^ sw] to 4 tx + j."""
    sw = 2 if tx & 16 else 0
    made = [4 * tx + (k ^ sw) for k in range(4)]
    stored = [made[j ^ sw] for j in range(4)]
    return made, stored


def test_k5_thread_mapping_makes_each_output_once():
    """The 256 threads (tx 0..31, ty 0..7), each 4 outputs of rows ty, ty
    + 8, ty + 16, ty + 24, make every output of a 32 x 128 tile once, and
    each store puts an output in its own column."""
    hits = np.zeros((TR, TC), int)
    for ty in range(8):
        for tx in range(32):
            made, stored = _thread_columns(tx)
            assert stored == [4 * tx + j for j in range(4)]
            for i in range(TR // 8):
                for c in made:
                    hits[ty + 8 * i, c] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("geom", [C3, (27, 48, 54, 96)])
def test_k5_tap_reads_at_2x_fall_in_distinct_banks(geom):
    """At 2x a warp's 32 lanes read, for each output k and tap column io,
    words (window row) * pitch + bx - 1 - sx0 + io: distinct words land in
    distinct banks (lanes that share a word are a broadcast), in every
    column tile.  Without the 2, 3, 0, 1 order of lanes 16-31 they would
    not."""
    by, bx, rows, cols = _tile_windows(*geom)
    out_w = geom[3]

    def worst(swizzle):
        most = 1
        for c0, c1, sx0, _ in cols:
            for k in range(4):
                for io in range(4):
                    words = set()
                    for tx in range(32):
                        sw = 2 if swizzle and tx & 16 else 0
                        col = min(c0 + 4 * tx + (k ^ sw), out_w - 1)
                        if c0 + 4 * tx < out_w:
                            words.add(int(bx[col]) - 1 - sx0 + io)
                    per_bank = np.bincount([wd % 32 for wd in words],
                                           minlength=32)
                    most = max(most, int(per_bank.max()))
        return most

    assert worst(True) == 1
    assert worst(False) == 2


def _per_output_weights(h, w, out_h, out_w, rows, cols):
    """The plain versions' weights of outputs (rows x cols) and their sum,
    g(d2y[jo] + d2x[io]) per output, the sum in tap order."""
    _, dy = scale.jinc2_axis_tables(h, out_h)
    _, dx = scale.jinc2_axis_tables(w, out_w)
    dy = torch.tensor(dy[:, rows])
    dx = torch.tensor(dx[:, cols])
    out, wsum = [], None
    for jo in range(4):
        for io in range(4):
            wgt = jk._weight(dy[jo][:, None] + dx[io][None, :])
            out.append(wgt)
            wsum = wgt if wsum is None else wsum + wgt
    return torch.stack(out + [wsum], dim=-1)


@pytest.mark.parametrize("geom", [C3, C3ROT] + CARD + [(40, 300, 80, 1000)])
def test_k5_table_gather_equals_per_output_weights(geom):
    """At K5's geometries the table entry of each output's classes holds
    its per-output weights and their sum bit for bit, over rows and
    columns spanning several periods and tiles."""
    h, w, out_h, out_w = geom
    rows = np.arange(min(out_h, 70))
    cols = np.unique(np.minimum(np.arange(0, 300, 3), out_w - 1))
    rcls, rrep = jk.axis_classes(h, out_h)
    ccls, crep = jk.axis_classes(w, out_w)
    table = jk.jinc2_weight_table(torch.tensor(rrep), torch.tensor(crep))
    got = table[torch.tensor(rcls[rows])][:, torch.tensor(ccls[cols])]
    want = _per_output_weights(h, w, out_h, out_w, rows, cols)
    assert torch.equal(got[..., :17], want)


@pytest.mark.parametrize("geom,route,window", [
    (C3, ("table", "staged"), (20, 72, 5760)),
    (C3ROT, ("table", "staged"), (13, 120, 6240)),
    ((27, 48, 96, 54), ("table", "staged"), (13, 56, 2912)),
    ((1079, 67, 2160, 133), ("per-output", "staged"), (20, 72, 5760)),
    ((640, 1280, 64, 128), ("table", "direct"), (314, 1280, 1607680))])
def test_k5_window_bytes_and_route(geom, route, window):
    """k5_window: c3's 32 x 128 tile reaches 20 rows x 68 columns (pitch
    72, 5760 bytes); c3rot's 13 x 117; a geometry with no short period
    computes its weights; a 10x downscale's window passes the budget, so
    its taps are read through L1."""
    assert jk.k5_window(*geom) == window
    assert jk.k5_route(*geom) == route
    assert (window[2] <= rk.SMEM_BUDGET) == (route[1] == "staged")


def test_k5_cpu_call_builds_no_table():
    """On a CPU tensor K5 runs its plain version: no table is built and no
    launch is counted."""
    x = torch.from_numpy(np.random.default_rng(81).random(
        (3, 27, 48), dtype=np.float32))
    rk.reset_launches()
    before = jk._weight_table.cache_info().currsize
    out = jk.jinc2_resize_fused(x, 54, 96, jk.dither_epilogue(8))
    assert out.shape == (3, 54, 96)
    assert rk.launches["jinc2_weight_table"] == 0
    assert rk.launches["jinc2_resize_fused"] == 0
    assert jk._weight_table.cache_info().currsize == before


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _letterbox_maps():
    """The letterboxed path's H maps: the luma's Lanczos3 1608 -> 804 rows
    and the chroma's upsample composed with it, 804 -> 804."""
    lz = scale.upscale_matrix(C.Upscaling.LANCZOS3, 1608, 804)
    _, uy = chroma.chroma_upsample_matrices(
        1920, 804, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    return {"luma": rk.BandedMatrix(lz), "chroma": rk.BandedMatrix(uy @ lz)}


def _k3_map(name):
    if name in ("luma", "chroma"):
        return _letterbox_maps()[name]
    n_in, n_out = {"odd": (37, 20), "up": (75, 150), "short": (203, 101)}[name]
    return rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.LANCZOS3, n_in,
                                                n_out))


K3_MAPS = ["luma", "chroma", "odd", "up", "short"]


@pytest.mark.parametrize("name", K3_MAPS)
@pytest.mark.parametrize("tile_rows", [32, 1])
def test_k3_windows_cover_every_tap(name, tile_rows):
    """Each tile's window (first row lo, min(win, h_in - lo) rows) holds
    every tap row of its outputs that lies inside the input."""
    mat = _k3_map(name)
    lo, win = mat.row_windows(tile_rows)
    for tile, r0 in enumerate(range(0, mat.out_size, tile_rows)):
        n = min(win, mat.in_size - lo[tile])
        for r in range(r0, min(r0 + tile_rows, mat.out_size)):
            idx = mat.starts[r] + np.arange(mat.n_taps)
            idx = idx[idx < mat.in_size]
            assert (idx >= lo[tile]).all() and (idx < lo[tile] + n).all()


def _k3_direct(x, mat):
    """One output (row, column) a thread, as K3 before its tiles: acc = 0,
    then acc += x[starts[r] + t] * taps[t, r] in tap order, rows past the
    input skipped (float32, the same product and sum in both replays)."""
    out = np.zeros((x.shape[0], mat.out_size, x.shape[-1]), np.float32)
    for r in range(mat.out_size):
        acc = np.zeros((x.shape[0], x.shape[-1]), np.float32)
        for t in range(mat.n_taps):
            i = mat.starts[r] + t
            if i < mat.in_size:
                acc = acc + x[:, i] * mat.taps[t, r]
        out[:, r] = acc
    return out


def _k3_tiled(x, mat, tile_rows):
    """The tiled kernel: per tile the staged window and the tile's starts
    and taps (zero past h_out), then each output's taps from the window in
    the same order."""
    lo, win = mat.row_windows(tile_rows)
    out = np.zeros((x.shape[0], mat.out_size, x.shape[-1]), np.float32)
    for tile, r0 in enumerate(range(0, mat.out_size, tile_rows)):
        n = min(win, mat.in_size - lo[tile])
        window = x[:, lo[tile]:lo[tile] + n]
        rows = min(tile_rows, mat.out_size - r0)
        starts = mat.starts[r0:r0 + rows]
        taps = mat.taps[:, r0:r0 + rows]
        for m in range(rows):
            acc = np.zeros((x.shape[0], x.shape[-1]), np.float32)
            for t in range(mat.n_taps):
                i = starts[m] + t
                if i < mat.in_size:
                    acc = acc + window[:, i - lo[tile]] * taps[t, m]
            out[:, r0 + m] = acc
    return out


@pytest.mark.parametrize("name", K3_MAPS)
@pytest.mark.parametrize("tile_rows", [32, 8])
def test_k3_tiled_replay_equals_one_output_a_thread(name, tile_rows):
    """Replaying the tiled sums (window-relative rows, the tile's staged
    starts and taps) gives the one-output-a-thread sums bit for bit."""
    mat = _k3_map(name)
    x = np.random.default_rng(82).random((2, mat.in_size, 6),
                                         dtype=np.float32)
    assert np.array_equal(_k3_tiled(x, mat, tile_rows), _k3_direct(x, mat))


def test_k3_smem_and_tile_rows():
    """At the letterbox's maps a 32-row tile's window is 68 luma rows (6
    taps, 2:1) and 36 chroma rows (5 taps) of 128 float32 columns plus the
    taps and starts: 35712 and 19200 bytes, so 32-row tiles; uint8 rows
    take a quarter of the window bytes.  A map of 256 taps fits only at one
    row a tile; 8192 taps not at all."""
    maps = _letterbox_maps()
    assert [rk.k3_smem_bytes(4, m) for m in maps.values()] == [35712, 19200]
    assert rk.k3_smem_bytes(4, maps["luma"]) == \
        68 * rk.K3_TILE_COLS * 4 + 4 * 32 * 7
    assert rk.k3_smem_bytes(1, maps["luma"]) == \
        68 * rk.K3_TILE_COLS + 4 * 32 * 7
    assert [rk.k3_tile_rows(4, m) for m in maps.values()] == [32, 32]
    band = np.zeros((1024, 4), np.float32)
    for j in range(4):
        band[256 * j:256 * (j + 1), j] = 1 / 256
    box = rk.BandedMatrix(band)
    assert rk.k3_tile_rows(4, box) == 1
    assert rk.k3_smem_bytes(4, box, 1) <= rk.SMEM_BUDGET \
        < rk.k3_smem_bytes(4, box, 2)
    assert rk.k3_tile_rows(4, rk.BandedMatrix(
        np.full((8192, 4), 1 / 8192, np.float32))) is None


def test_k3_thread_mapping_makes_each_output_once():
    """256 threads, 4 consecutive columns each (tx 0..31), rows ty, ty + 8,
    ... of a 32-row tile: each output of a 32 x 128 tile once."""
    hits = np.zeros((32, rk.K3_TILE_COLS), int)
    for ty in range(8):
        for tx in range(32):
            for m in range(ty, 32, 8):
                hits[m, 4 * tx:4 * tx + 4] += 1
    assert (hits == 1).all()
