"""The H-first kernels — K7, the deinterlace of both fields fused into the
H-axis resize, K8, the H maps around the Dolby Vision convert, and K9, the
W-axis resize with the whole per-pixel tail — with their plain PyTorch
versions.

Replaces ``videorenderer_tpu/kernels/deint_pallas.py``: ``deint3_rows_dual``
(K7, ``csrc/deint3_rows_dual.cu``), ``rows3_mid`` (K8,
``csrc/rows3_mid.cu``) and ``cols3_tail`` (K9, ``csrc/cols3_tail.cu``).
The double-rate chain runs H first so the vertical neighbours the
deinterlace needs sit inside the H pass: K7 writes both fields' H-resized
planes, K9 resizes W and runs K2's tail on them.  The Dolby Vision chain
(c8) runs K8 between the chroma W upsample (K1) and K9.

As in ``kernels/resize.py``, the matrices are :class:`~.resize.BandedMatrix`
tap tables with the normalisation folded in, the sums are fp32 FMAs (no
split-bf16 products), a wrapper given CPU tensors runs the plain version and
given CUDA tensors launches the kernel or raises, and each launch adds one
to ``resize.launches[name]``.

K7, K8 and K9 are tiled for the H100 as K1 and K2 are: a block stages
the window of inputs its outputs' taps reach in shared memory with 16-byte
copies and each thread makes 4 columns with vector stores.
:func:`k7_smem_bytes`, :func:`k8_smem_bytes` and :func:`k9_smem_bytes`
give a block's shared memory.  A map whose window does not fit SMEM_BUDGET
(a strong downscale) takes each kernel's long-window route, which stages
nothing and reads its taps through the read-only cache, bit-equal to the
staged route (:func:`k7_route`, :func:`k8_route`, :func:`k9_route`); only a
grid past its limits is refused before the launch.  Their times against
their bounds are in ``PERF.md`` section 6.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.dovi import MidStage
from . import build
from .resize import (DOVI_CURVES_BYTES, DTYPE_CODES, PACK_CODES,
                     SMEM_BUDGET, BandedMatrix, Epilogue, _check_plane,
                     _h_plain, _kernel_device, _launch, _no_tf32, _taps_args,
                     _up16, check_place, fill_bars, kernel_span,
                     pack_surface, place_output, redo_counter, redo_groups,
                     route_flags)
from .resize import route_launches as rk_route_launches

K7_TILE_ROWS = 32     # output rows a K7 block makes (its tile_rows)
K7_TILE_COLS = 64     # columns a K7 block makes (kTileCols)
K9_TILE_ROWS = 32     # rows a K9 block makes (tile_rows, csrc/cols3_tail.cuh)
K9_TILE_COLS = 128    # output columns a K9 block makes (kTileCols)
K9_WARPS = 8          # warps of a K9 block, each with two staged rows
GRID_YZ_MAX = 65535   # the grid's y and z dimensions
K7_LONG_WINDOW = False
"""True forces K7's long-window route on every map (its outputs are the
staged route's bit for bit; ``chip_smoke.py`` compares the two)."""
K8_LONG_WINDOW = False
"""The same for K8."""
K9_LONG_WINDOW = False
"""The same for K9."""


def k7_smem_bytes(itemsize: int, my_y: BandedMatrix, my_c: BandedMatrix,
                  tile_rows: int = K7_TILE_ROWS) -> int:
    """Shared memory of a K7 block (Layout, csrc/deint3_rows_dual.cu), the
    larger of the two plane classes': both fields' float32 values of the
    window (win rows x K7_TILE_COLS), the taps and starts of ``tile_rows``
    rows (rounded up to 16 bytes), then the raw windows of cur (win + 2
    rows), prev and next (win rows) at the planes' itemsize."""
    def one(mat: BandedMatrix) -> int:
        win = mat.row_windows(tile_rows)[1]
        return (2 * win * K7_TILE_COLS * 4
                + -(-4 * tile_rows * (mat.n_taps + 1) // 16) * 16
                + (3 * win + 2) * K7_TILE_COLS * itemsize)
    return max(one(my_y), one(my_c))


def k7_route(itemsize: int, my_y: BandedMatrix, my_c: BandedMatrix) -> str:
    """K7's route: "staged" where the windows of a K7_TILE_ROWS tile fit
    SMEM_BUDGET (:func:`k7_smem_bytes`), else "long-window", the kernel
    that reads prev, cur and next through the read-only cache (also with
    K7_LONG_WINDOW).  Both give the same bits."""
    if K7_LONG_WINDOW or k7_smem_bytes(itemsize, my_y, my_c) > SMEM_BUDGET:
        return "long-window"
    return "staged"


def k9_pitch(win: int, itemsize: int) -> int:
    """Input elements a K9 block stages a row for a span of ``win``
    columns: from a start rounded down to 16 bytes (pitch_of,
    csrc/cols3_tail.cuh; K1's rule)."""
    chunk = 16 // itemsize
    return (win + 2 * chunk - 2) // chunk * chunk


def k9_smem_bytes(y_itemsize: int, c_itemsize: int,
                  mx_y: BandedMatrix | None,
                  mx_c: BandedMatrix | None) -> int:
    """Shared memory of a K9 block (Layout, csrc/cols3_tail.cuh): the spans
    of y, u and v, two rows of :func:`k9_pitch` elements for each of its
    K9_WARPS warps (a plane read directly has none), then each map's taps
    and starts for K9_TILE_COLS output columns."""
    total = 0
    for mat, itemsize, planes in ((mx_y, y_itemsize, 1),
                                  (mx_c, c_itemsize, 2)):
        if mat is not None:
            win = mat.row_windows(K9_TILE_COLS)[1]
            total += (planes * 2 * K9_WARPS * k9_pitch(win, itemsize)
                      * itemsize)
            total += 4 * K9_TILE_COLS * (mat.n_taps + 1)
    return total


def k9_route(y_itemsize: int, c_itemsize: int, mx_y: BandedMatrix | None,
             mx_c: BandedMatrix | None) -> str:
    """K9's route: "staged" where the spans fit SMEM_BUDGET
    (:func:`k9_smem_bytes`), else "long-window", the kernel that reads its
    taps through the read-only cache (also with K9_LONG_WINDOW).  Both give
    the same bits."""
    if K9_LONG_WINDOW or k9_smem_bytes(y_itemsize, c_itemsize, mx_y,
                                       mx_c) > SMEM_BUDGET:
        return "long-window"
    return "staged"


# ---------------------------------------------------------------------------
# K7: motion-adaptive deinterlace of both fields + banded H resize
# ---------------------------------------------------------------------------


def _deint_fields(pf: torch.Tensor, cf: torch.Tensor, nf: torch.Tensor,
                  thr: float, top_field_first: bool) -> list[torch.Tensor]:
    """Motion-adaptive deinterlace of (..., H, W) float32 planes for both
    temporal fields from one motion ramp — ``deint_pallas._deint_fields``
    with the bottom clamp at the plane's last row (the port pads nothing).
    The ramp divides by a tensor, not a Python scalar, so the card divides
    exactly as K7 does (a CUDA division by a host scalar multiplies by its
    reciprocal)."""
    thr_t = torch.tensor(thr, dtype=torch.float32, device=cf.device)
    alpha = torch.clamp((torch.abs(nf - pf) - thr_t) / thr_t, 0.0, 1.0)
    h = cf.shape[-2]
    rows = torch.arange(h, device=cf.device).view(h, 1)
    up = torch.cat([cf[..., :1, :], cf[..., :-1, :]], dim=-2)
    dn = torch.cat([cf[..., 1:, :], cf[..., -1:, :]], dim=-2)
    outs = []
    for field in (0, 1):
        use_top = (field == 0) == top_field_first
        if use_top:
            # bottom clamp: the last odd row averages field row H-2 twice
            u_, d_ = up, torch.where(rows == h - 1, up, dn)
        else:
            # top clamp: row 0 averages field row 1 twice
            u_, d_ = torch.where(rows == 0, dn, up), dn
        bob = (u_ + d_) * 0.5
        mixed = cf + (bob - cf) * alpha
        parity = (rows & 1) == (1 if use_top else 0)
        outs.append(torch.where(parity, mixed, cf))
    return outs


def deint3_rows_dual_plain(prev, cur, nxt, my_y: BandedMatrix,
                           my_c: BandedMatrix, h_out: int, thr: float,
                           top_field_first: bool = True):
    """Plain K7: :func:`_deint_fields` per plane, then one dense float32 H
    product per plane and field."""
    _no_tf32()
    outs = []
    for k, mat in ((0, my_y), (1, my_c), (2, my_c)):
        f = [x[k].to(torch.float32) for x in (prev, cur, nxt)]
        d0, d1 = _deint_fields(*f, thr, top_field_first)
        m = mat.dense_on(f[1].device).T
        outs.append(torch.stack([m @ d0, m @ d1], dim=-3))
    return tuple(outs)


@kernel_span("deint3_rows_dual")
def deint3_rows_dual(prev, cur, nxt, my_y: BandedMatrix, my_c: BandedMatrix,
                     h_out: int, thr: float, top_field_first: bool = True):
    """Deinterlace both fields of the (prev, cur, next) window and resize
    each along H.

    ``prev``/``cur``/``nxt``: (y, u, v) raw planes, y (..., Hy, Wy) and u, v
    (..., Hc, Wc), all of one dtype of ``DTYPE_CODES``.  ``my_y`` (Hy,
    h_out) / ``my_c`` (Hc, h_out): the H maps, the plane normalisation
    folded in.  ``thr``: the motion threshold in raw code units.  Returns
    (y, u, v) float32 (..., 2, h_out, W*): field f is ``[..., f, :, :]``.

    Kernel K7 (``csrc/deint3_rows_dual.cu``), replacing
    ``deint_pallas.deint3_rows_dual``.  A block makes K7_TILE_ROWS output
    rows x K7_TILE_COLS columns of one plane: it stages the window of input
    rows its taps reach (cur widened by the clamped neighbour row above and
    below) in shared memory with 16-byte copies, computes
    the motion ramp and both fields' values once per window pixel, then
    runs the taps of 4 columns a thread and stores them as vectors, so the
    deinterlaced planes never reach device memory; neighbouring blocks take
    one tile of consecutive frames, so each raw frame comes from device
    memory about once.  Bound by device memory (the raw frames read once,
    both fields written once: 0.451 ms at c5 on one H100).  A map whose
    window does not fit SMEM_BUDGET takes the long-window route
    (:func:`k7_route`: each tap row's ramp and fields from prev, cur and
    next read through the read-only cache, bit-equal); a grid past its
    limits raises ValueError before the launch."""
    for name, frames in (("prev", prev), ("cur", cur), ("nxt", nxt)):
        if len(frames) != 3:
            raise ValueError(f"{name}: need the (y, u, v) planes, got "
                             f"{len(frames)}")
    planes = [x[k] for k in range(3) for x in (prev, cur, nxt)]
    for p in planes:
        _check_plane("deint3_rows_dual", p)
        if p.dtype != planes[0].dtype:
            raise TypeError("deint3_rows_dual: the nine planes must share "
                            f"one dtype, got {p.dtype} and {planes[0].dtype}")
    y, u = cur[0], cur[1]
    for k in range(3):
        if prev[k].shape != cur[k].shape or nxt[k].shape != cur[k].shape:
            raise ValueError("prev, cur and nxt planes differ in shape")
    if cur[2].shape != u.shape:
        raise ValueError("u and v must share shape")
    lead = y.shape[:-2]
    if u.shape[:-2] != lead:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch")
    (hy, wy), (hc, wc) = y.shape[-2:], u.shape[-2:]
    for name, mat, h_in in (("y", my_y, hy), ("c", my_c, hc)):
        if (mat.in_size, mat.out_size) != (h_in, h_out):
            raise ValueError(f"{name}: H matrix {mat.in_size}->"
                             f"{mat.out_size} for {h_in}->{h_out}")
    if not _kernel_device(*planes):
        return deint3_rows_dual_plain(prev, cur, nxt, my_y, my_c, h_out, thr,
                                      top_field_first)
    batch = y.numel() // (hy * wy) if y.numel() else 0
    col_blocks = -(-wy // K7_TILE_COLS) + 2 * -(-wc // K7_TILE_COLS)
    tiles = -(-h_out // K7_TILE_ROWS)
    if batch == 0 or tiles > GRID_YZ_MAX or col_blocks * batch >= 2 ** 31:
        raise ValueError(f"K7 cannot take batch {batch} x {h_out} rows x "
                         f"{wy} columns: the grid is (column tiles x frames, "
                         f"tiles of {K7_TILE_ROWS} rows), at most 2^31 - 1 "
                         "and 65535")
    long_window = k7_route(y.element_size(), my_y, my_c) == "long-window"
    dev = y.device
    outs = tuple(torch.empty(lead + (2, h_out, w), dtype=torch.float32,
                             device=dev) for w in (wy, wc, wc))
    ptrs = (ctypes.c_void_p * 9)(*(p.data_ptr() for p in planes))
    sy, ty = my_y.taps_on(dev)
    sc, tc = my_c.taps_on(dev)
    lo_y, win_y = my_y.row_windows(K7_TILE_ROWS, dev)
    lo_c, win_c = my_c.row_windows(K7_TILE_ROWS, dev)
    _launch("deint3_rows_dual", "vrt_deint3_rows_dual", dev,
            ctypes.addressof(ptrs), DTYPE_CODES[y.dtype], batch, hy, wy, hc,
            wc, h_out, K7_TILE_ROWS, sy.data_ptr(), ty.data_ptr(),
            my_y.n_taps,
            lo_y.data_ptr(), win_y, sc.data_ptr(), tc.data_ptr(),
            my_c.n_taps, lo_c.data_ptr(), win_c, float(thr),
            int(top_field_first), int(long_window),
            *(o.data_ptr() for o in outs))
    return outs


# ---------------------------------------------------------------------------
# K8: H maps into the mid resolution + the DoVi convert + a shared H map out
# ---------------------------------------------------------------------------

K8_TILE_ROWS = 32     # output rows of a tile (tile_rows, csrc/rows3_mid.cuh)
K8_LMS_TILE_ROWS = 31  # ... on the LMS route: a 64-row window at 2:1
K8_HEAVY_TILE_ROWS = 16  # ... on the runtime route and the long-window one
K8_TILE_COLS = 64     # columns a K8 block makes (kTileCols)
K8_TILES_PER_BLOCK = 4  # consecutive tiles a K8 block walks (kTilesPerBlock)
# K8's routes (csrc/dovi_mid.cuh: route_of, kRouteNames; rows3_mid_route's
# names) and the kernel that keeps no mid window
K8_C8, K8_LMS, K8_RUNTIME = ("c8 uint16/float32", "lms uint16/float32",
                             "runtime")
K8_LONG = "long-window"
# the output rows of a tile on each staged route, before the budget halves
# them
K8_ROUTE_TILE_ROWS = {K8_C8: K8_TILE_ROWS, K8_LMS: K8_LMS_TILE_ROWS,
                      K8_RUNTIME: K8_HEAVY_TILE_ROWS}
k8_route_launches = rk_route_launches.setdefault(
    "rows3_mid", dict.fromkeys((K8_C8, K8_LMS, K8_RUNTIME, K8_LONG), 0))
"""K8's launches by route, reset with ``resize.launches``
(``resize.reset_launches``)."""


def k8_redo_groups() -> int:
    """The groups of 4 pixels whose LMS steps K8's LMS route ran again
    exactly since the last ``resize.reset_launches`` (``csrc/dovi_mid.cuh``:
    dovi_mid_group under CheckedPow; the counter ``resize.redo_counter
    ("rows3_mid", device)``); a mid row that two tiles' windows share is
    converted, and counted, in each.  Reads the counters: a sync."""
    return redo_groups("rows3_mid")


def k8_in_windows(mat: BandedMatrix, tile_lo: np.ndarray, win: int,
                  h_mid: int) -> tuple[np.ndarray, int]:
    """The input rows of an in map that each K8 tile stages: for the tile
    whose window holds mid rows ``tile_lo[k]`` .. + ``win`` (clipped to
    ``h_mid``), the first input row its in taps reach (int32, one a tile)
    and the rows of the widest such span (taps past the plane do not
    count)."""
    hi = np.minimum(mat.starts + mat.n_taps, mat.in_size)
    lo_t, hi_t = [], []
    for lo in np.asarray(tile_lo, np.int64):
        n = min(win, h_mid - int(lo))
        lo_t.append(int(mat.starts[lo:lo + n].min()))
        hi_t.append(int(hi[lo:lo + n].max()))
    return (np.asarray(lo_t, np.int32),
            max(h - l for l, h in zip(lo_t, hi_t)))


def k8_smem_bytes(y_itemsize: int, c_itemsize: int,
                  my_in_y: BandedMatrix | None, my_in_c: BandedMatrix | None,
                  my_out: BandedMatrix | None, h_mid: int, n_vals: int,
                  tile_rows: int = K8_TILE_ROWS) -> int:
    """Shared memory of a K8 block (Layout, csrc/rows3_mid.cuh), each part
    rounded up to 16 bytes: the mid window (three float32 channels of the
    widest window's rows x K8_TILE_COLS), the staged rows of each plane
    with an in map (:func:`k8_in_windows`), each in map's taps and starts
    over the window, the out map's taps and starts of ``tile_rows`` rows,
    then the ``n_vals`` curve scalars and the curve structure."""
    tile_lo, win = _k8_windows(my_out, h_mid, tile_rows)
    total = _up16(3 * win * K8_TILE_COLS * 4)
    for mat, itemsize, planes in ((my_in_y, y_itemsize, 1),
                                  (my_in_c, c_itemsize, 2)):
        if mat is not None:
            in_win = k8_in_windows(mat, tile_lo, win, h_mid)[1]
            total += planes * _up16(in_win * K8_TILE_COLS * itemsize)
            total += _up16(4 * mat.n_taps * win) + _up16(4 * win)
    if my_out is not None:
        total += _up16(4 * my_out.n_taps * tile_rows) + _up16(4 * tile_rows)
    return total + _up16(4 * n_vals) + DOVI_CURVES_BYTES


def _k8_windows(my_out: BandedMatrix | None, h_mid: int, tile_rows: int
                ) -> tuple[np.ndarray, int]:
    """Each tile's first mid row and the widest window: the out map's
    row_windows, or the tile's own rows without an out map."""
    if my_out is None:
        return np.arange(0, h_mid, tile_rows, dtype=np.int32), tile_rows
    return my_out.row_windows(tile_rows)


def k8_compiled_route(y_dtype: torch.dtype, c_dtype: torch.dtype,
                      mid: MidStage) -> str:
    """The route K8's staged kernel takes (csrc/dovi_mid.cuh: route_of;
    the names of :func:`rows3_mid_route`, without loading the library):
    K8_C8 (C8Mid, c8's metadata: uint16 luma, float32 chroma, the LMS step
    folded away and one polynomial piece a channel), K8_LMS (LmsMid: those
    dtypes and a non-identity LMS step, any curves) or K8_RUNTIME."""
    if y_dtype != torch.uint16 or c_dtype != torch.float32:
        return K8_RUNTIME
    if mid.lms is not None:
        return K8_LMS
    return (K8_C8 if all(pieces == 1 and kinds[0] == 0
                         for pieces, kinds, _ in mid.structure)
            else K8_RUNTIME)


@functools.lru_cache(maxsize=64)
def k8_tile_rows(y_itemsize: int, c_itemsize: int,
                 my_in_y: BandedMatrix | None, my_in_c: BandedMatrix | None,
                 my_out: BandedMatrix | None, h_mid: int, n_vals: int,
                 route: str = K8_C8) -> int:
    """The output rows of a K8 tile on the staged ``route`` (a
    :func:`k8_compiled_route`): K8_ROUTE_TILE_ROWS's (32 on c8's light
    route, 31 on the LMS route, 16 on the runtime route: more blocks an
    SM), halved until the block's shared memory fits SMEM_BUDGET (a steep
    downscale's long windows); 0 when not even one row fits."""
    tile_rows = K8_ROUTE_TILE_ROWS[route]
    while tile_rows >= 1:
        if k8_smem_bytes(y_itemsize, c_itemsize, my_in_y, my_in_c, my_out,
                         h_mid, n_vals, tile_rows) <= SMEM_BUDGET:
            return tile_rows
        tile_rows //= 2
    return 0


def k8_route(y_itemsize: int, c_itemsize: int,
             my_in_y: BandedMatrix | None, my_in_c: BandedMatrix | None,
             my_out: BandedMatrix | None, h_mid: int, n_vals: int,
             route: str = K8_C8) -> tuple[str, int]:
    """K8's route and tile rows: ("staged", :func:`k8_tile_rows` on the
    compiled ``route``) where the window fits at some tile, else
    ("long-window", K8_HEAVY_TILE_ROWS), the kernel that keeps no mid
    window (also with K8_LONG_WINDOW).  Both give the same bits."""
    rows = 0 if K8_LONG_WINDOW else k8_tile_rows(
        y_itemsize, c_itemsize, my_in_y, my_in_c, my_out, h_mid, n_vals,
        route)
    return (K8_LONG, K8_HEAVY_TILE_ROWS) if rows == 0 else ("staged", rows)


def rows3_mid_plain(y, u, v, my_in_y: BandedMatrix | None,
                    my_in_c: BandedMatrix | None, h_mid: int,
                    mid: MidStage, my_out: BandedMatrix | None, h_out: int,
                    y_scale: float | None = None,
                    c_scale: float | None = None) -> tuple:
    """Plain K8: each plane's H map as a dense float32 product (or the
    direct read times its scale), :meth:`MidStage.plain`, then the out map
    as one dense product per channel."""
    _no_tf32()
    rgb = mid.plain(_h_plain(y, my_in_y, y_scale), _h_plain(u, my_in_c, c_scale),
                    _h_plain(v, my_in_c, c_scale))
    return tuple(_h_plain(c, my_out, None) for c in rgb)


@kernel_span("rows3_mid")
def rows3_mid(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              my_in_y: BandedMatrix | None, my_in_c: BandedMatrix | None,
              h_mid: int, mid: MidStage, my_out: BandedMatrix | None,
              h_out: int, y_scale: float | None = None,
              c_scale: float | None = None) -> tuple:
    """H-map the (luma, chroma, chroma) planes into ``h_mid`` rows, run the
    Dolby Vision convert ``mid`` there, and H-map the result to ``h_out``.

    ``y`` (..., Hy, W), ``u``/``v`` (..., Hc, W): float32 or raw
    uint8/uint16/int16.  ``my_in_y`` (Hy, h_mid) / ``my_in_c`` (Hc, h_mid):
    the in maps with their scale folded in, or None for a plane read
    directly (its height is then h_mid and ``y_scale``/``c_scale`` scale
    it).  ``my_out`` (h_mid, h_out), or None with h_out == h_mid.  Returns
    the (R, G, B) PQ planes, each (..., h_out, W) float32 and contiguous
    (the three planes of one (3, ..., h_out, W) buffer), so that K9 reads
    each plane without a copy.

    The values in ``mid`` (the matrix and the scene's curves) ride the
    launch by value: a new scene rebuilds nothing and synchronises nothing.

    Kernel K8 (``csrc/rows3_mid.cu``), replacing ``deint_pallas.rows3_mid``
    with the DoVi ``mid_fn``.  A block makes 64 columns of
    K8_TILES_PER_BLOCK consecutive tiles of :func:`k8_tile_rows` output
    rows of one frame: it stages the input rows its mid window's in taps
    reach in shared memory with 16-byte copies (the next tile's while the
    current tile's out taps run), computes each mid pixel of the window
    once into shared memory, then runs the out taps, 4 columns a thread,
    and stores 16-byte vectors, so the full-resolution RGB never reaches
    device memory.  The convert's route is compiled in for c8's metadata
    (K8_C8: 32-row tiles, 4 pixels a thread side by side) and for a
    non-identity LMS step (K8_LMS: 31-row tiles, a thread's 4 pixels
    converted as one group, the 12 pows and 6 divisions of a pixel's LMS
    step checked once a group, a group out of range converted again
    exactly and counted, :func:`k8_redo_groups`); :func:`rows3_mid_route`
    names the route a launch takes, :func:`k8_compiled_route` likewise on
    the host, and each launch adds one to :data:`k8_route_launches` under
    its route (or "long-window").  A map whose window does not fit
    SMEM_BUDGET at one row a tile takes the long-window route
    (:func:`k8_route`: each out tap's mid pixel from inputs read through
    the read-only cache, bit-equal, on the runtime route); a grid past its
    limits raises ValueError before the launch."""
    for name, p in (("y", y), ("u", u), ("v", v)):
        _check_plane(name, p)
    if u.shape != v.shape or u.dtype != v.dtype:
        raise ValueError("u and v must share shape and dtype")
    lead, (hy, w) = y.shape[:-2], y.shape[-2:]
    hc = u.shape[-2]
    if u.shape[:-2] != lead or u.shape[-1] != w:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch or width")
    for name, mat, h_in, scale in (("y", my_in_y, hy, y_scale),
                                   ("c", my_in_c, hc, c_scale)):
        if mat is None and h_in != h_mid:
            raise ValueError(f"{name}: no in map, so its height {h_in} must "
                             f"be h_mid {h_mid}")
        if mat is not None and (mat.in_size, mat.out_size) != (h_in, h_mid):
            raise ValueError(f"{name}: in map {mat.in_size}->{mat.out_size} "
                             f"for {h_in}->{h_mid}")
        if mat is not None and scale is not None:
            raise ValueError(f"{name}: a scale goes into the in map, not "
                             "beside it")
    if my_out is None and h_out != h_mid:
        raise ValueError(f"no out map, so h_out {h_out} must be h_mid {h_mid}")
    if my_out is not None and (my_out.in_size, my_out.out_size) != (h_mid,
                                                                     h_out):
        raise ValueError(f"out map {my_out.in_size}->{my_out.out_size} for "
                         f"{h_mid}->{h_out}")
    if not _kernel_device(y, u, v):
        return rows3_mid_plain(y, u, v, my_in_y, my_in_c, h_mid, mid, my_out,
                               h_out, y_scale, c_scale)
    vals = mid.host_values()
    struct = mid.host_structure()
    compiled = k8_compiled_route(y.dtype, u.dtype, mid)
    route, tile_rows = k8_route(y.element_size(), u.element_size(),
                                my_in_y, my_in_c, my_out, h_mid, vals.size,
                                compiled)
    long_window = route == K8_LONG
    batch = y.numel() // (hy * w) if y.numel() else 0
    n_tiles = -(-h_out // tile_rows)
    if batch == 0 or batch > GRID_YZ_MAX \
            or -(-n_tiles // (1 if long_window else K8_TILES_PER_BLOCK)) \
            > GRID_YZ_MAX:
        raise ValueError(f"K8 cannot take batch {batch} x {h_out} rows: the "
                         "grid is (column tiles, groups of tiles, frames), "
                         "at most 65535 groups and frames")
    dev = y.device
    tile_lo, win = _k8_windows(my_out, h_mid, tile_rows)

    def in_args(mat):   # (starts, taps, T, lo, win); none: read directly
        if mat is None:
            return None, None, 0, None, 0
        if long_window:     # no staged rows
            return (*_taps_args(mat, dev), None, 0)
        lo, in_win = _k8_in_windows_on(mat, my_out, h_mid, tile_rows, dev)
        return (*_taps_args(mat, dev), lo.data_ptr(), in_win)

    out = torch.empty((3,) + lead + (h_out, w), dtype=torch.float32,
                      device=dev)
    _launch("rows3_mid", "vrt_rows3_mid", dev,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, hy, hc, w, h_mid, h_out, tile_rows,
            *in_args(my_in_y), *in_args(my_in_c), *_taps_args(my_out, dev),
            None if my_out is None
            else my_out.row_windows(tile_rows, dev)[0].data_ptr(), win,
            1.0 if y_scale is None else float(y_scale),
            1.0 if c_scale is None else float(c_scale),
            vals.ctypes.data, vals.size, struct.ctypes.data,
            int(mid.lms is None), int(long_window),
            redo_counter("rows3_mid", dev).data_ptr(), out.data_ptr())
    k8_route_launches[K8_LONG if long_window else compiled] += 1
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=32)
def _k8_in_windows_on(mat: BandedMatrix, my_out: BandedMatrix | None,
                      h_mid: int, tile_rows: int, device: torch.device
                      ) -> tuple[torch.Tensor, int]:
    """:func:`k8_in_windows` of an in map for the out map's tiles, its
    first rows on ``device``, uploaded once."""
    tile_lo, win = _k8_windows(my_out, h_mid, tile_rows)
    lo, in_win = k8_in_windows(mat, tile_lo, win, h_mid)
    return torch.from_numpy(lo).to(device), in_win


def rows3_mid_route(y_dtype: torch.dtype, c_dtype: torch.dtype,
                    mid: MidStage) -> str:
    """The K8 route a launch with these plane dtypes and this mid stage
    takes: "c8 uint16/float32" (identity curves and LMS fold), "lms
    uint16/float32" (a non-identity LMS step), or "runtime"
    (vrt_rows3_mid_route; loads the kernel library, so it needs the CUDA
    toolkit; :func:`k8_compiled_route` is its host replay)."""
    vals, struct = mid.host_values(), mid.host_structure()
    return build.load().vrt_rows3_mid_route(
        DTYPE_CODES[y_dtype], DTYPE_CODES[c_dtype], vals.ctypes.data,
        vals.size, struct.ctypes.data, int(mid.lms is None)).decode()


# ---------------------------------------------------------------------------
# K9: W resize of three planes + colour matrix + corrections + dither + pack
# ---------------------------------------------------------------------------


def _w_plain(p: torch.Tensor, mat: BandedMatrix | None,
             scale: float | None) -> torch.Tensor:
    pf = p.to(torch.float32)
    if mat is None:
        return pf if scale is None else pf * float(np.float32(scale))
    return pf @ mat.dense_on(p.device)


def cols3_tail_plain(y, u, v, mx_y: BandedMatrix | None,
                     mx_c: BandedMatrix | None, w_out: int,
                     epilogue: Epilogue, y_scale: float | None = None,
                     c_scale: float | None = None,
                     pack_format: str | None = None,
                     place: tuple | None = None) -> torch.Tensor:
    """Plain K9: each plane's W contraction as a dense float32 product (or
    the direct read times its scale), the torch epilogue, the pack, then
    the placement (``resize.place_output``)."""
    _no_tf32()
    rgb = epilogue.plain(_w_plain(y, mx_y, y_scale), _w_plain(u, mx_c, c_scale),
                         _w_plain(v, mx_c, c_scale))
    out = rgb if pack_format is None else pack_surface(rgb, pack_format)
    return place_output(out, place, pack_format)


@kernel_span("cols3_tail")
def cols3_tail(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               mx_y: BandedMatrix | None, mx_c: BandedMatrix | None,
               w_out: int, epilogue: Epilogue, y_scale: float | None = None,
               c_scale: float | None = None,
               pack_format: str | None = None,
               place: tuple | None = None) -> torch.Tensor:
    """W-resize the (luma, chroma, chroma) planes, then run the epilogue.

    ``y`` (..., H, Wy), ``u``/``v`` (..., H, Wc): float32 or raw
    uint8/uint16/int16.  ``mx_y`` (Wy, w_out) / ``mx_c`` (Wc, w_out): the W
    matrices with their scale folded in, or None for a plane read directly
    — its width is then w_out and ``y_scale``/``c_scale`` scale it.  The
    epilogue is K2's (``cmat=None`` for planes that are R, G, B already).
    Returns (..., 3, H, w_out) float32, or with ``pack_format``
    ("rgb10a2"/"rgba8") (..., H, w_out) int32 dwords; ``place`` puts them
    into a surface as ``resize.rows3_tail``'s does (Dolby Vision in a
    rect).

    Kernel K9 (``csrc/cols3_tail.cu``), replacing
    ``deint_pallas.cols3_tail``: K2's design on the W axis.  A block makes
    K9_TILE_ROWS rows x K9_TILE_COLS output columns; each of its K9_WARPS
    warps stages, row by row and one row ahead, each plane's span of input
    columns its outputs' taps reach in shared memory (16-byte copies), and
    each thread runs the W taps of 4 consecutive columns, the
    shared tail (``csrc/tail.cuh``), the dither from the global row and
    column and one vector store, so no intermediate RGB reaches device
    memory.  The tail's route is compiled in for c5's and c8's epilogues
    (:func:`cols3_tail_route` names it).  A map whose span does not fit
    SMEM_BUDGET takes the long-window route (:func:`k9_route`: every tap
    read through the read-only cache, the runtime tail, bit-equal); a grid
    past its limits raises ValueError before the launch."""
    epilogue.validate()
    if pack_format not in PACK_CODES:
        raise NotImplementedError(f"K9: pack format {pack_format!r}")
    for name, p in (("y", y), ("u", u), ("v", v)):
        _check_plane(name, p)
    if u.shape != v.shape or u.dtype != v.dtype:
        raise ValueError("u and v must share shape and dtype")
    lead, (h, wy) = y.shape[:-2], y.shape[-2:]
    wc = u.shape[-1]
    if u.shape[:-1] != y.shape[:-1]:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch or height")
    for name, mat, w_in, scale in (("y", mx_y, wy, y_scale),
                                   ("c", mx_c, wc, c_scale)):
        if mat is None and w_in != w_out:
            raise ValueError(f"{name}: no W matrix, so its width {w_in} "
                             f"must be w_out {w_out}")
        if mat is not None and (mat.in_size, mat.out_size) != (w_in, w_out):
            raise ValueError(f"{name}: W matrix {mat.in_size}->"
                             f"{mat.out_size} for {w_in}->{w_out}")
        if mat is not None and scale is not None:
            raise ValueError(f"{name}: a scale goes into the W matrix, not "
                             "beside it")
    surface = check_place(place, h, w_out)
    if not _kernel_device(y, u, v):
        return cols3_tail_plain(y, u, v, mx_y, mx_c, w_out, epilogue, y_scale,
                                c_scale, pack_format, place)
    batch = y.numel() // (h * wy) if y.numel() else 0
    tiles = -(-h // K9_TILE_ROWS)
    if batch == 0 or batch > GRID_YZ_MAX or tiles > GRID_YZ_MAX \
            or -(-w_out // K9_TILE_COLS) >= 2 ** 31:
        raise ValueError(f"K9 cannot take batch {batch} x {h} rows x "
                         f"{w_out} columns: the grid is (column tiles, tiles "
                         f"of {K9_TILE_ROWS} rows, frames), at most 65535 "
                         "tiles and frames")
    long_window = k9_route(y.element_size(), u.element_size(), mx_y,
                           mx_c) == "long-window"
    sh, sw = surface[:2]
    if pack_format is None:
        out = torch.empty(lead + (3, sh, sw), dtype=torch.float32,
                          device=y.device)
    else:
        out = torch.empty(lead + (sh, sw), dtype=torch.int32,
                          device=y.device)
    if place is not None:
        fill_bars(out, surface, h, w_out, pack_format)
    mats = epilogue.host_mats()

    def w_args(mat):    # (starts, taps, T, tile_lo, win); none: read directly
        if mat is None:
            return None, None, 0, None, 0
        lo, win = mat.row_windows(K9_TILE_COLS, y.device)
        return (*_taps_args(mat, y.device), lo.data_ptr(), win)

    _launch("cols3_tail", "vrt_cols3_tail", y.device,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, h, wy, wc, w_out, K9_TILE_ROWS,
            *w_args(mx_y), *w_args(mx_c),
            1.0 if y_scale is None else float(y_scale),
            1.0 if c_scale is None else float(c_scale),
            *epilogue.launch_args(mats), epilogue.dither_bits,
            PACK_CODES[pack_format], *surface, int(long_window),
            out.data_ptr())
    return out


def cols3_tail_route(y_dtype: torch.dtype, c_dtype: torch.dtype,
                     epilogue: Epilogue, pack_format: str | None,
                     long_window: bool = False) -> str:
    """The K9 instantiation a launch with these plane dtypes, epilogue and
    pack takes: the name of its compiled route ("c5 float32", "c8
    float32"), "runtime" for the staged one that reads the tail's flags
    (every epilogue with trims or the guided curve), or with
    ``long_window`` "long-window runtime" (vrt_cols3_tail_route over
    ``resize.route_flags``; loads the kernel library, so it needs the CUDA
    toolkit)."""
    return build.load().vrt_cols3_tail_route(
        *route_flags(y_dtype, c_dtype, epilogue, pack_format),
        int(long_window)).decode()
