"""K8's tiled indexing (``csrc/rows3_mid.cuh``) replayed in torch on the
CPU.

K8 is replayed twice with the same float32 arithmetic: once as the
one-column-a-thread kernel it replaces indexes the planes (the tap replay:
each mid row's in taps over the whole plane, each output's out taps over
the whole mid plane), once as the tiled kernel indexes its staged rows and
its window (the tiled replay: the tile's window of mid rows from the out
map's ``row_windows``, the input rows each in map stages from
``k8_in_windows``, the window-relative in and out starts, the skip of in
taps past the plane and of out taps past h_mid).  Each window's in values
and the outputs of the two are bit-equal exactly when the tiled indexing
is right; both are held against
``rows3_mid_plain`` within K8's bands (1e-5 with c8's metadata, 1e-4 with
the non-identity variant).  The maps are c8's (luma read directly, the
chroma upsample 1080 -> 2160, Catmull-Rom 2160 -> 1080), the blend
deinterlace on the luma without an out map, and edge maps whose last taps
run past the plane and past h_mid.  The shared-memory formula and the
choice of tile rows are checked here too.  No JAX.
"""

import numpy as np
import pytest
import torch

from videorenderer_tpu_torch import config as C, csputils as S
from videorenderer_tpu_torch.kernels import deint as dk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.ops import chroma, dovi, scale

N16 = 1 / 65535.0
GROUP = 4   # adjacent columns a thread converts together (rows3_mid.cuh: kVec)


def _dovi_meta(kind):
    """c8's metadata (identity curves, LMS matrices mutual inverses) or the
    variant where nothing folds: a 2-piece polynomial on Y, a polynomial +
    MMR order-2 curve on Cb, an MMR order-3 curve on Cr, 2% crosstalk."""
    ycc = np.array([[1, 0, 1.4746], [1, -0.164553, -0.571353],
                    [1, 1.8814, 0]])
    inv = np.linalg.inv(dovi.DOVI_LMS2RGB)
    if kind == "c8":
        return dovi.DoviMetadata(curves=(dovi.identity_curve(),) * 3,
                                 ycc_to_rgb_matrix=ycc,
                                 ycc_to_rgb_offset=np.array([0, 0.5, 0.5]),
                                 rgb_to_lms_matrix=inv)
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


def _mid(kind):
    """The MidStage of c8's metadata or the variant with scene 2's curves."""
    meta = _dovi_meta(kind)
    m, c = dovi.build_ycc_to_rgb_cmat(meta)
    scene = {k: v * np.float32(0.98) for k, v in dovi.pack_curves(meta).items()}
    return dovi.mid_stage(meta, m, c, scene)


def _edge(n_in):
    """A banded (n_in, n_in / 2) map, 4 taps a step of 2, whose last
    output's band holds the last two inputs: its taps 2 and 3 lie past the
    plane."""
    n_out = n_in // 2
    m = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out - 1):
        m[2 * j:2 * j + 4, j] = [0.1, 0.4, 0.4, 0.1]
    m[n_in - 2:, n_out - 1] = [0.5, 0.5]
    return m


def _case(which, rng, w=8):
    """(y, u, v, my_in_y, my_in_c, h_mid, my_out, h_out, y_scale, c_scale)
    of a case: c8's geometry at full height on ``w`` columns, the blend
    map on the luma without an out map, or the edge maps."""
    if which == "c8":
        h_mid, h_out, hc = 2160, 1080, 1080
        _, uy = chroma.chroma_upsample_matrices(
            w // 2, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
        my_in_y, my_in_c = None, rk.BandedMatrix(uy)
        my_out = rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.CATMULL_ROM,
                                                      h_mid, h_out))
        hy = h_mid
    elif which == "blend_no_out":
        h_mid = h_out = hy = 96
        hc = 48
        _, uy = chroma.chroma_upsample_matrices(
            w // 2, hc, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
        my_in_y = rk.BandedMatrix(chroma.blend_deinterlace_matrix(h_mid),
                                  pre_scale=N16)
        my_in_c, my_out = rk.BandedMatrix(uy), None
    else:   # edge: in taps past the chroma plane, out taps past h_mid
        h_mid, h_out, hc = 40, 20, 80
        hy = h_mid
        my_in_y, my_in_c = None, rk.BandedMatrix(_edge(hc))
        my_out = rk.BandedMatrix(_edge(h_mid))
    y = torch.from_numpy(rng.integers(64, 941, (1, hy, w), dtype=np.uint16)
                         << 6)
    u, v = (torch.from_numpy(rng.uniform(0.06, 0.94, (1, hc, w))
                             .astype(np.float32)) for _ in range(2))
    y_scale = None if my_in_y is not None else N16
    return y, u, v, my_in_y, my_in_c, h_mid, my_out, h_out, y_scale, None


def _in_tap_replay(p, mat, scale_):
    """One plane's mid rows as the one-column-a-thread kernel made them:
    each mid row's taps from starts over the whole plane, those past the
    plane skipped; or the direct read times the scale."""
    pf = p.to(torch.float32)
    if mat is None:
        return pf * float(np.float32(scale_))
    starts = torch.from_numpy(mat.starts).long()
    acc = torch.zeros(pf.shape[:-2] + (mat.out_size, pf.shape[-1]))
    for t in range(mat.n_taps):
        idx = starts + t
        ok = (idx < mat.in_size).view(-1, 1)
        wt = torch.from_numpy(mat.taps[t]).view(-1, 1)
        acc = acc + torch.where(ok, pf[..., idx.clamp(max=mat.in_size - 1), :]
                                * wt, 0.0)
    return acc


def _out_taps(mid, starts, taps, lim):
    """Each row's out taps over ``mid`` at (relative) ``starts``, those at
    or past ``lim`` skipped."""
    acc = torch.zeros(mid.shape[:-2] + (len(starts), mid.shape[-1]))
    for t in range(taps.shape[0]):
        idx = starts + t
        ok = (idx < lim).view(-1, 1)
        acc = acc + torch.where(ok, mid[..., idx.clamp(max=lim - 1), :]
                                * taps[t].view(-1, 1), 0.0)
    return acc


def _tap_replay(y, u, v, my_in_y, my_in_c, h_mid, mid, my_out, h_out,
                y_scale, c_scale):
    """(the three planes' mid rows, the converted mid rows, the output)."""
    ins = (_in_tap_replay(y, my_in_y, y_scale),
           _in_tap_replay(u, my_in_c, c_scale),
           _in_tap_replay(v, my_in_c, c_scale))
    rgb = torch.stack(mid.plain(*ins))
    if my_out is None:
        return ins, rgb, rgb
    starts = torch.from_numpy(my_out.starts).long()
    taps = torch.from_numpy(my_out.taps)
    return ins, rgb, torch.stack([_out_taps(c, starts, taps, h_mid)
                                  for c in rgb])


def _tiled_replay(y, u, v, my_in_y, my_in_c, h_mid, mid_rows, my_out, h_out,
                  y_scale, c_scale, ins, tile_rows=dk.K8_TILE_ROWS):
    """The tiled K8: per tile of ``tile_rows`` output rows, the window of
    mid rows of ``_k8_windows``; each plane with an in map stages the rows
    of ``k8_in_windows`` (at most its span, none past the plane) and reads
    its taps at the staged-relative start, those past the plane skipped;
    each output's out taps at the window-relative start, those past h_mid
    skipped.  The window's in values are held bit-equal to the tap
    replay's ``ins`` at its rows; the convert is a function of a pixel's
    three in values alone, and torch's CPU transcendentals round by the
    position of an element in its vector loop, so the window's converted
    rows are taken from ``mid_rows``, the one conversion of those in
    values."""
    tile_lo, win = dk._k8_windows(my_out, h_mid, tile_rows)
    n_tiles = -(-h_out // tile_rows)
    assert len(tile_lo) == n_tiles
    spans = {id(m): dk.k8_in_windows(m, tile_lo, win, h_mid)
             for m in (my_in_y, my_in_c) if m is not None}
    out = torch.zeros((3,) + y.shape[:-2] + (h_out, y.shape[-1]))
    for k in range(n_tiles):
        r0 = k * tile_rows
        rows = min(tile_rows, h_out - r0)
        lo = int(tile_lo[k])
        n_win = min(win, h_mid - lo)

        def plane(p, mat, scale_):
            pf = p.to(torch.float32)
            if mat is None:
                return pf[..., lo:lo + n_win, :] * float(np.float32(scale_))
            lo_in, in_win = spans[id(mat)]
            in_lo = int(lo_in[k])
            count = min(in_win, mat.in_size - in_lo)
            staged = pf[..., in_lo:in_lo + count, :]
            rel = torch.from_numpy(mat.starts[lo:lo + n_win]).long() - in_lo
            assert (rel >= 0).all()
            lim = mat.in_size - in_lo
            acc = torch.zeros(pf.shape[:-2] + (n_win, pf.shape[-1]))
            for t in range(mat.n_taps):
                i = rel + t
                ok = i < lim
                assert (i[ok] < count).all()
                wt = torch.from_numpy(mat.taps[t, lo:lo + n_win]).view(-1, 1)
                acc = acc + torch.where(ok.view(-1, 1),
                                        staged[..., i.clamp(max=count - 1), :]
                                        * wt, 0.0)
            return acc

        got = (plane(y, my_in_y, y_scale), plane(u, my_in_c, c_scale),
               plane(v, my_in_c, c_scale))
        for g, ref in zip(got, ins):
            assert torch.equal(g, ref[..., lo:lo + n_win, :])
        for ch in range(3):
            wc = mid_rows[ch, ..., lo:lo + n_win, :]
            if my_out is None:
                assert lo == r0
                out[ch, ..., r0:r0 + rows, :] = wc[..., :rows, :]
                continue
            rel = torch.from_numpy(my_out.starts[r0:r0 + rows]).long() - lo
            assert (rel >= 0).all()
            taps = torch.from_numpy(my_out.taps[:, r0:r0 + rows])
            live = rel.view(-1, 1) + torch.arange(my_out.n_taps).view(1, -1)
            assert (live[live < h_mid - lo] < n_win).all()
            out[ch, ..., r0:r0 + rows, :] = _out_taps(wc, rel, taps,
                                                      h_mid - lo)
    return out


@pytest.mark.parametrize("tile_rows", [dk.K8_TILE_ROWS, dk.K8_LMS_TILE_ROWS,
                                       dk.K8_HEAVY_TILE_ROWS, 1, 5])
@pytest.mark.parametrize("kind", ["c8", "variant"])
@pytest.mark.parametrize("which", ["c8", "blend_no_out", "edge"])
def test_k8_tiled_replay_matches_tap_replay_and_plain(which, kind, tile_rows):
    """K8's tiled indexing gives the bits of the tap replay on c8's maps
    (every tile of the 1080 output rows), the blend map without an out map
    and the edge maps, for the tile rows of each of the kernel's routes
    and two others; both within K8's band of the plain version."""
    rng = np.random.default_rng(50)
    args = _case(which, rng)
    mid = _mid(kind)
    y, u, v, my_in_y, my_in_c, h_mid, my_out, h_out, ys, cs = args
    ins, mid_rows, taps = _tap_replay(y, u, v, my_in_y, my_in_c, h_mid, mid,
                                      my_out, h_out, ys, cs)
    tiled = _tiled_replay(y, u, v, my_in_y, my_in_c, h_mid, mid_rows, my_out,
                          h_out, ys, cs, ins, tile_rows)
    assert torch.equal(tiled, taps)
    plain = torch.stack(dk.rows3_mid_plain(y, u, v, my_in_y, my_in_c, h_mid,
                                           mid, my_out, h_out, ys, cs))
    assert plain.shape == taps.shape
    tol = 1e-5 if kind == "c8" else 1e-4
    assert (taps - plain).abs().max().item() <= tol


def test_k8_in_windows_cover_the_taps():
    """c8's chroma in map: each tile of 32 outputs reaches 66 mid rows, and
    their in taps 34 chroma rows; the edge map's last window stops at the
    plane."""
    rng = np.random.default_rng(51)
    _, _, _, _, my_in_c, h_mid, my_out, _, _, _ = _case("c8", rng)
    tile_lo, win = my_out.row_windows(dk.K8_TILE_ROWS)
    assert win == 66 and len(tile_lo) == 34
    lo, in_win = dk.k8_in_windows(my_in_c, tile_lo, win, h_mid)
    assert in_win == 34 and lo.dtype == np.int32 and len(lo) == 34
    hi = np.minimum(my_in_c.starts + my_in_c.n_taps, my_in_c.in_size)
    for k, m0 in enumerate(tile_lo):
        rows = slice(m0, min(m0 + win, h_mid))
        assert lo[k] == my_in_c.starts[rows].min()
        assert hi[rows].max() - lo[k] <= in_win
    edge = rk.BandedMatrix(_edge(80))
    lo_e, win_e = dk.k8_in_windows(edge, np.array([32], np.int32), 8, 40)
    assert lo_e.tolist() == [64] and win_e == 16


def test_k8_smem_at_c8_fits_three_blocks():
    """c8's block: a 66-row window of three float32 channels x 64 columns,
    34 staged rows of each float32 chroma plane, the chroma in taps (2)
    and the out taps (4) with their starts, c8's 30 curve scalars and the
    curve structure; 3 blocks fit an SM (228 KB, 1 KB reserved a block),
    and the wrapper keeps 32-row tiles."""
    rng = np.random.default_rng(52)
    _, _, _, my_in_y, my_in_c, h_mid, my_out, _, _, _ = _case("c8", rng)
    n_vals = _mid("c8").host_values().size
    assert n_vals == 30
    got = dk.k8_smem_bytes(2, 4, my_in_y, my_in_c, my_out, h_mid, n_vals)
    # each part rounded up to 16 bytes: the 66 starts take 272
    want = (3 * 66 * 64 * 4 + 2 * 34 * 64 * 4 + 2 * 66 * 4 + 272
            + 4 * 32 * 4 + 32 * 4 + 128 + 320)
    assert got == want == 69984
    assert 3 * (got + 1024) <= 228 * 1024
    assert dk.k8_tile_rows(2, 4, my_in_y, my_in_c, my_out, h_mid,
                           n_vals) == dk.K8_TILE_ROWS
    # no out map: the window is the tile's own rows
    _, _, _, by, bc, hb, _, _, _, _ = _case("blend_no_out", rng)
    assert dk._k8_windows(None, hb, 32)[1] == 32
    assert dk.k8_smem_bytes(2, 4, by, bc, None, hb, 30) <= rk.SMEM_BUDGET


@pytest.mark.parametrize("route,rows,win,smem,blocks", [
    (dk.K8_LMS, 31, 64, 68048, 3),       # 80 registers a thread
    (dk.K8_RUNTIME, 16, 34, 36672, 6)])  # 40
def test_k8_light_route_and_heavy_tiles(route, rows, win, smem, blocks):
    """c8's metadata on uint16 luma and float32 chroma takes the light
    route, 32-row tiles and 3 blocks an SM; the variant (non-identity LMS,
    several pieces, MMR) takes the LMS route, whose 31-row tiles reach 64
    mid rows at c8's 2:1 (4 rows of groups a thread) in 68048 bytes with
    the variant's 69 scalars (3 blocks an SM, as its 80 registers allow);
    raw chroma takes the runtime route, whose
    16-row tiles (36672 bytes) fit 6 blocks.  The host's route is the one
    route_of names (csrc/dovi_mid.cuh)."""
    rng = np.random.default_rng(53)
    _, _, _, my_in_y, my_in_c, h_mid, my_out, _, _, _ = _case("c8", rng)
    c8, var = _mid("c8"), _mid("variant")
    assert dk.k8_compiled_route(torch.uint16, torch.float32, c8) == dk.K8_C8
    assert dk.k8_compiled_route(torch.uint16, torch.float32,
                                var) == dk.K8_LMS
    for y, c in ((torch.uint16, torch.uint16), (torch.float32, torch.float32),
                 (torch.int16, torch.float32)):
        for m in (c8, var):
            assert dk.k8_compiled_route(y, c, m) == dk.K8_RUNTIME
    n = var.host_values().size
    assert n == 69
    tr = dk.k8_tile_rows(2, 4, my_in_y, my_in_c, my_out, h_mid, n, route)
    assert tr == rows == dk.K8_ROUTE_TILE_ROWS[route]
    assert my_out.row_windows(tr)[1] == win
    got = dk.k8_smem_bytes(2, 4, my_in_y, my_in_c, my_out, h_mid, n, tr)
    assert got == smem and blocks * (got + 1024) <= 228 * 1024
    assert dk.k8_route(2, 4, my_in_y, my_in_c, my_out, h_mid, n,
                       route) == ("staged", rows)


def test_k8_tile_rows_shrink_for_long_windows():
    """A 16:1 box downscale of 4096 mid rows: 32-row tiles need a 512-row
    window (over the budget), so the tile shrinks to the largest power of
    two that fits; a map that reads every mid row for every output fits
    at no tile size."""
    box = np.zeros((4096, 256), np.float32)
    for j in range(256):
        box[16 * j:16 * j + 16, j] = 1 / 16
    out = rk.BandedMatrix(box)
    args = (4, 4, None, None, out, 4096, 30)
    tr = dk.k8_tile_rows(*args)
    assert 1 <= tr < dk.K8_TILE_ROWS
    assert dk.k8_smem_bytes(*args[:-1], 30, tr) <= rk.SMEM_BUDGET
    assert dk.k8_smem_bytes(*args[:-1], 30, 2 * tr) > rk.SMEM_BUDGET
    full = rk.BandedMatrix(np.full((8192, 4), 1 / 8192, np.float32))
    assert dk.k8_tile_rows(4, 4, None, None, full, 8192, 30) == 0


def _mid_pass(route, n_win):
    """The window pixels (mid row, column of the tile) each thread of a
    block converts in the mid pass, as lists of the groups it converts
    together: on the side-by-side routes (c8's, the LMS route) thread
    (tx, ty) = (tid % 16, tid // 16) converts columns 4 tx .. 4 tx + 3 of
    mid rows ty, ty + 16, ... as one group a row; the runtime route deals
    the window's pixels out one a thread."""
    cols = dk.K8_TILE_COLS
    out = []
    for tid in range(256):
        if route == dk.K8_RUNTIME:
            out.append([[divmod(p, cols)]
                        for p in range(tid, n_win * cols, 256)])
        else:
            tx, ty = tid % 16, tid // 16
            out.append([[(m, GROUP * tx + j)
                         for j in range(GROUP)]
                        for m in range(ty, n_win, 16)])
    return out


@pytest.mark.parametrize("route,rows,groups", [
    (dk.K8_C8, dk.K8_TILE_ROWS, {4, 5}),     # a 66-row window
    (dk.K8_LMS, dk.K8_LMS_TILE_ROWS, {4}),   # 64: 4 groups every thread
    (dk.K8_RUNTIME, dk.K8_HEAVY_TILE_ROWS, {8, 9})])   # 34: pixels
def test_k8_thread_mapping_covers_the_tile_once(route, rows, groups):
    """Each route's mid pass over its window at c8's maps converts every
    mid pixel of the window exactly once: the side-by-side routes in
    groups of GROUP adjacent columns of one mid row (the LMS route's
    64-row window: 4 groups every thread, none idle), the runtime route
    one pixel at a time (8 or 9 a thread).  The out pass (16 across x 16
    down): 4 adjacent columns a thread cover the 64 columns of a row once,
    the tile's rows each fall to one thread row, and a quarter warp's
    16-byte reads of one row span 128 contiguous bytes."""
    rng = np.random.default_rng(54)
    _, _, _, _, _, h_mid, my_out, h_out, _, _ = _case("c8", rng)
    tile_lo, win = my_out.row_windows(rows)
    seen = np.zeros((win, dk.K8_TILE_COLS), int)
    per_thread = set()
    for mine in _mid_pass(route, win):
        per_thread.add(len(mine))
        for group in mine:
            (m0, c0), size = group[0], len(group)
            assert size == (1 if route == dk.K8_RUNTIME else GROUP)
            assert group == [(m0, c0 + j) for j in range(size)]
            assert c0 % size == 0
            for m, c in group:
                seen[m, c] += 1
    assert (seen == 1).all() and per_thread == groups
    # every tile's window, clipped at h_mid, lies inside the widest one
    n_win = np.minimum(win, h_mid - tile_lo)
    assert (n_win >= 1).all() and n_win.max() == win
    cols = np.zeros(64, int)
    for tid in range(256):
        tx = tid % 16
        cols[4 * tx:4 * tx + 4] += 1
    assert (cols == 16).all()
    owners = [[r for r in range(rows) if r % 16 == ty] for ty in range(16)]
    assert sorted(sum(owners, [])) == list(range(rows))
    for q in range(4):
        lanes = range(8 * q, 8 * q + 8)
        starts = sorted({((lane % 16) * 4 * 4) for lane in lanes})
        assert starts[-1] - starts[0] + 16 == 128


def test_k8_route_counter_resets_with_the_launch_counters():
    """K8's launches by route are keyed by rows3_mid_route's names and
    "long-window", registered with kernels/resize, and reset_launches
    zeroes them with the launch counters."""
    assert set(dk.k8_route_launches) == {dk.K8_C8, dk.K8_LMS, dk.K8_RUNTIME,
                                         dk.K8_LONG}
    assert rk.route_launches["rows3_mid"] is dk.k8_route_launches
    dk.k8_route_launches[dk.K8_LMS] += 3
    rk.launches["rows3_mid"] += 3
    rk.reset_launches()
    assert set(dk.k8_route_launches.values()) == {0}
    assert rk.launches["rows3_mid"] == 0


def test_k8_redo_counter_resets_with_the_launch_counters(monkeypatch):
    """The LMS route's redo counter (``rk.redo_counter("rows3_mid",
    device)``): one int64 a device, made at its first use and kept, apart
    from K2's; ``dk.k8_redo_groups`` reads K8's, and ``reset_launches``
    zeroes it with the launch counters and keeps it."""
    monkeypatch.setattr(rk, "redo_counters", {})
    assert dk.k8_redo_groups() == 0
    k8 = rk.redo_counter("rows3_mid", "cpu")
    assert k8.dtype == torch.int64 and k8.shape == (1,) and int(k8) == 0
    assert rk.redo_counter("rows3_mid", torch.device("cpu")) is k8
    k2 = rk.redo_counter("rows3_tail", "cpu")
    k8 += 5
    k2 += 2
    rk.launches["rows3_mid"] += 1
    assert dk.k8_redo_groups() == 5 and rk.k2_redo_groups() == 2
    rk.reset_launches()
    assert dk.k8_redo_groups() == 0 and rk.k2_redo_groups() == 0
    assert rk.launches["rows3_mid"] == 0
    assert rk.redo_counter("rows3_mid", "cpu") is k8
    assert set(rk.redo_counters) == {("rows3_mid", torch.device("cpu")),
                                     ("rows3_tail", torch.device("cpu"))}


@pytest.mark.parametrize("kind,route", [("variant", dk.K8_LMS),
                                        ("c8", dk.K8_C8)])
def test_k8_launch_passes_its_devices_redo_counter(monkeypatch, kind, route):
    """Every K8 launch (the kernel call stubbed: the wrapper's arguments as
    it would pass them) hands vrt_rows3_mid its device's rows3_mid redo
    counter just before the output, one argument short of the entry
    point's signature (the stream follows), on the LMS route and on c8's,
    which ignores it."""
    from videorenderer_tpu_torch.kernels import build
    monkeypatch.setattr(rk, "redo_counters", {})
    seen = []
    monkeypatch.setattr(dk, "_kernel_device", lambda *p: True)
    monkeypatch.setattr(dk, "_launch", lambda *a: seen.append(a))
    rng = np.random.default_rng(55)
    y, u, v, my_in_y, my_in_c, h_mid, my_out, h_out, ys, cs = _case("c8", rng)
    rk.reset_launches()
    out = dk.rows3_mid(y, u, v, my_in_y, my_in_c, h_mid, _mid(kind), my_out,
                       h_out, y_scale=ys, c_scale=cs)
    (name, fn, dev, *args), = seen
    assert (name, fn, dev) == ("rows3_mid", "vrt_rows3_mid", y.device)
    assert len(args) == len(build.SIGNATURES[fn]) - 1
    assert args[-1] == out[0].data_ptr()
    assert args[-2] == rk.redo_counter("rows3_mid", "cpu").data_ptr()
    assert set(rk.redo_counters) == {("rows3_mid", torch.device("cpu"))}
    assert dk.k8_route_launches[route] == 1
