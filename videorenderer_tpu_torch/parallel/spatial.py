"""Spatially sharded frame processing: one frame split across devices by
rows — the port of ``videorenderer_tpu.parallel.spatial``.

For frames too large for one device's real-time budget (8K and up, or deep
batches), a frame's rows are sharded over a :class:`~.mesh.Mesh`, one
process a device.  Every stage is row-local except the H-axis contractions
(chroma upsample, blend deinterlace, resize), which need ``halo`` input
rows from the neighbouring ranks: :func:`~.mesh.halo_exchange` brings them
(paired sends and receives, NCCL on the card, gloo on the CPU).

Each rank plans its own shard: the rows of a global (H_in, H_out) map that
its output rows reach, with the halo rows outside the frame at zero weight
(:func:`_shard_row_mats`), as a :class:`~..kernels.resize.BandedMatrix`
with the normalisation folded in, which the existing K3
(``kernels/resize.banded_resize_rows``) runs on the rank's halo-extended
block.  The JAX package stacks every shard's band in one table and picks a
shard's with ``axis_index``, so one compiled program serves every shard
(``resize_pallas.banded_resize_rows_packed``); here each process holds its
own table, and no band-selection kernel exists.

A rank returns its own rows: (..., 3, surface_h_pad / n, surface_w) float32,
or with ``pack_surface`` (..., surface_h_pad / n, surface_w) int32 dwords.
:func:`gather_rows` all-gathers them into the whole surface on every rank,
as :func:`~.mesh.jit_frame_parallel` gives its batch.

Exact by construction, as in the JAX package: the ordered dither takes the
shard's global row (``row_offset``), halo rows outside the frame carry
zero weight, and K3 sums each output's taps in the order of the whole
frame's table, so on the card n ranks give the one-rank surface bit for
bit.  On the CPU the plain versions' dense products are bit-equal where the
BLAS does not split the contraction (a few hundred rows).

Each form takes a :class:`~.mesh.Mesh`, or a :class:`Shard` (a rank, a
shard count and a halo source) so that one device can run the shards of an
n-shard plan one after another with no collective
(:func:`drive_shards_locally`).

Forms, as :func:`make_spatial_frame_fn` dispatches them: the fused
linear-prefix plans (K1 per plane, K3 per plane, then the colour matrix,
corrections, local tone map, dither and pack in torch), the Dolby Vision
split-fused plans (stage A at source resolution: K1 and K3 with the
reshape, the RPU matrix and the LMS step per pixel; stage B: K1 and K3),
the one-pass Jinc2 upscales (the direct 4x4-tap form: each rank gathers
the source rows its output rows' taps read and runs K6, or K5 after the
convert, on that band of the frame's rows) and the learned models
(:func:`make_spatial_learned_fn`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import pipeline as pl
from ..config import Upscaling
from ..formats import ColorSystem
from ..kernels import jinc2 as jk
from ..kernels import resize as rk
from ..ops import dither as dither_ops
from ..ops import scale as scale_ops
from .mesh import Mesh, halo_exchange

HaloFn = Callable[[torch.Tensor, int], torch.Tensor]


@dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``size`` row shards.  ``halo(x, rows)`` returns the
    rank's block ``x`` (..., hs, W) extended by ``rows`` rows on each side,
    as :func:`~.mesh.halo_exchange` delivers them; ``device``: where
    :func:`shard_planes_rows` puts the rank's rows (None: where they are)."""
    rank: int
    size: int
    halo: HaloFn | None = None
    device: torch.device | None = None


def shard_of(mesh: Mesh | Shard) -> Shard:
    """The :class:`Shard` of this process on ``mesh`` (its halo source the
    collective), or ``mesh`` itself when it is one."""
    if isinstance(mesh, Shard):
        return mesh
    return Shard(mesh.rank, mesh.size,
                 lambda x, rows: halo_exchange(x, rows, mesh), mesh.device)


# ---------------------------------------------------------------------------
# host planning (numpy)
# ---------------------------------------------------------------------------


def required_halo(mat: np.ndarray, n_shards: int) -> int:
    """Exact halo rows needed so each output shard's rows only reference its
    input shard ± halo."""
    h_in, h_out = mat.shape
    assert h_in % n_shards == 0 and h_out % n_shards == 0
    hs_in, hs_out = h_in // n_shards, h_out // n_shards
    nz_r, nz_c = np.nonzero(mat)
    if nz_r.size == 0:
        return 0
    i = nz_c // hs_out
    return int(max(0, (i * hs_in - nz_r).max(),
                   ((nz_r + 1) - (i + 1) * hs_in).max()))


def _embed(mat: np.ndarray, in_total: int | None = None, in_off: int = 0,
           out_total: int | None = None, out_off: int = 0) -> np.ndarray:
    """Zero-embed an (in, out) axis map into a larger (in_total, out_total):
    input rows land at ``in_off``, output columns at ``out_off``.  Zero
    columns make the corresponding output rows exact 0.0 (black fill) and
    zero rows ignore the pixels cropped away by src_rect."""
    h, w = mat.shape
    it = in_total if in_total is not None else h
    ot = out_total if out_total is not None else w
    if (it, ot) == (h, w) and in_off == 0 and out_off == 0:
        return np.asarray(mat)
    out = np.zeros((it, ot), np.asarray(mat).dtype)
    out[in_off:in_off + h, out_off:out_off + w] = mat
    return out


def _shard_row_mat(mat: np.ndarray, n: int, halo: int, i: int) -> np.ndarray:
    """Shard ``i``'s (hs_in + 2 halo, hs_out) block of a global (h_in, h_out)
    row map: its output rows against its halo-extended input rows (halo
    rows outside the frame get zero weight: halo_exchange's edge-replicated
    rows must not be counted)."""
    h_in, h_out = mat.shape
    hs_in, hs_out = h_in // n, h_out // n
    lo = i * hs_in - halo
    m = np.zeros((hs_in + 2 * halo, hs_out), mat.dtype)
    g0, g1 = max(lo, 0), min(lo + hs_in + 2 * halo, h_in)
    m[g0 - lo:g1 - lo] = mat[g0:g1, i * hs_out:(i + 1) * hs_out]
    return m


def _shard_row_mats(mat: np.ndarray, n: int, halo: int) -> list[np.ndarray]:
    """Every shard's block (:func:`_shard_row_mat`), in rank order."""
    return [_shard_row_mat(mat, n, halo, i) for i in range(n)]


def spatial_padded_heights(plan: pl.PipelinePlan, n: int,
                           surf_unit: int = 1) -> tuple[int, int]:
    """(padded source height, padded surface height) for an ``n``-shard row
    mesh: the smallest heights divisible by n for every plane (luma AND
    chroma) and for the surface.  1080p NV12 on 8 shards pads 1080 -> 1088
    (chroma 540 -> 544); already-divisible geometry pads by zero.
    ``surf_unit`` also makes each shard's surface rows a multiple of it
    (the learned models need s2d-aligned shards)."""
    info = plan.info
    dh = info.chroma_div[1] if info.cs_type == ColorSystem.YUV else 1
    unit = n * dh
    src_h_pad = -(-plan.src.height // unit) * unit
    sunit = n * surf_unit
    surf_h_pad = -(-plan.dst.height // sunit) * sunit
    return src_h_pad, surf_h_pad


def _check_divisible(plan: pl.PipelinePlan, n: int, pad_to_mesh: bool,
                     surf_h: int, surf_unit: int = 1) -> tuple[int, int, bool]:
    """(src_h_pad, surf_h_pad, pad_rows) plus the non-divisible guard."""
    info = plan.info
    dh = info.chroma_div[1] if info.cs_type == ColorSystem.YUV else 1
    src_h_pad, surf_h_pad = spatial_padded_heights(plan, n, surf_unit)
    if not pad_to_mesh and (src_h_pad != plan.src.height
                            or surf_h_pad != surf_h):
        raise ValueError(
            f"a height (src {plan.src.height}, chroma "
            f"{plan.src.height // dh if info.cs_type == ColorSystem.YUV else '-'},"
            f" surface {surf_h}) is not divisible by the {n}-shard "
            "spatial mesh; enable pad_to_mesh for the pad-and-crop fallback")
    return src_h_pad, surf_h_pad, surf_h_pad != surf_h


def _stage_a_height(plan: pl.PipelinePlan, n: int,
                    pad_to_mesh: bool = True) -> int:
    """Height of the row-sharded source-resolution intermediate (the cropped
    source rows at offset 0, padded to the mesh); without ``pad_to_mesh``
    a cropped height the mesh does not divide raises."""
    t0 = plan.src_rect[1] if plan.src_rect is not None else 0
    b0 = plan.src_rect[3] if plan.src_rect is not None else plan.src.height
    ah_pad = -(-(b0 - t0) // n) * n
    if not pad_to_mesh and ah_pad != b0 - t0:
        raise ValueError(
            f"the cropped source height {b0 - t0} is not divisible by the "
            f"{n}-shard spatial mesh; enable pad_to_mesh")
    return ah_pad


def _jinc2_spatial_ok(plan: pl.PipelinePlan) -> bool:
    """True when the plan's resize is the one-pass 2D Jinc2 upscale (both
    axes "up" or one a no-op), the case the JAX package shards.  Mixed
    Jinc2-up / convolution-down axes run two passes and stay on one
    device."""
    s = plan.settings
    if (s.upscaling != Upscaling.JINC2 or not s.vp_scaling
            or plan.dovi is not None):
        return False
    m = pl.PlanMaps(plan)
    rx, ry = scale_ops.jinc2_passes(m.src_h, m.src_w, m.vid_h, m.vid_w,
                                    s.interpolate_at_50pct)
    return (rx == "up" and ry in ("up", None)
            and (m.src_h, m.src_w) != (m.vid_h, m.vid_w))


def model_receptive_radius_s2d(model) -> int:
    """Total receptive-field row radius (in s2d-grid pixels) of a conv
    trunk: the sum of each conv kernel's row radius.  ``model``: an
    ``nn.Module`` or a mapping of its tensors (OIHW weights).  Every conv
    lies on the deepest path through the residual trunks of
    ``models/superres`` and ``models/videohdr``, so the radii add."""
    tensors = (model.values() if isinstance(model, dict)
               else model.parameters())
    return sum((int(w.shape[2]) - 1) // 2 for w in tensors if w.dim() == 4)


# ---------------------------------------------------------------------------
# the halo sources and the per-shard H contraction
# ---------------------------------------------------------------------------


def halo_from_blocks(blocks, rank: int, rows: int) -> torch.Tensor:
    """What :func:`~.mesh.halo_exchange` gives rank ``rank`` for ``rows``
    halo rows, cut from every rank's block (``blocks``, in rank order): the
    last rows of the previous block above, the first rows of the next
    below, the rank's own edge row repeated at the frame's top and
    bottom."""
    x, n = blocks[rank], len(blocks)
    if rows == 0:
        return x
    edge = (*x.shape[:-2], rows, x.shape[-1])
    top = (x[..., :1, :].expand(edge) if rank == 0
           else blocks[rank - 1][..., -rows:, :])
    bottom = (x[..., -1:, :].expand(edge) if rank == n - 1
              else blocks[rank + 1][..., :rows, :])
    return torch.cat([top, x, bottom], dim=-2)


def drive_shards_locally(build: Callable[[Shard], Callable], planes_of,
                         n: int) -> list:
    """Run the ``n`` shards of a spatial function on one device, one rank
    after another, with no collective: ``build(shard)`` makes rank's
    function (e.g. ``lambda sh: make_spatial_frame_fn(plan, sh)``),
    ``planes_of(rank)`` gives its input.  Each rank's k-th halo comes from
    every rank's block at its k-th exchange (:func:`halo_from_blocks`), as
    recorded in the pass before; passes repeat until no rank's blocks
    change, so a halo that depends on an earlier exchange (the Dolby
    Vision form's stage B) settles too: exchange k's blocks are right from
    pass k + 1 on, so a call of E exchanges settles in E + 1 passes.
    Returns each rank's output of the last pass, which is what the ranks
    of a mesh return."""
    records: list[dict[int, torch.Tensor]] = [{} for _ in range(n)]
    state = {"changed": False}

    def halo_fn(rank):
        calls = itertools.count()

        def halo(x, rows):
            k = next(calls)
            seen = records[rank].get(k)
            if seen is None or not torch.equal(seen, x):
                records[rank][k] = x
                state["changed"] = True
            blocks = [records[q].get(k) for q in range(n)]
            if any(b is None for b in blocks):
                return halo_from_blocks([x] * n, rank, rows)  # a first pass
            return halo_from_blocks(blocks, rank, rows)
        return halo

    for passes in itertools.count(1):
        state["changed"] = False
        outs = [build(Shard(r, n, halo_fn(r)))(planes_of(r))
                for r in range(n)]
        if not state["changed"]:
            return outs
        if passes > max(map(len, records)):
            raise RuntimeError(f"the shards' halos did not settle in "
                               f"{passes} passes")


def _check_halo(halo: int, hs: int, what: str = "spatial sharding") -> None:
    """The guard of every form: a halo deeper than a shard's rows would
    need rows from beyond the neighbouring shards."""
    if halo > hs:
        raise ValueError(f"{what} needs {halo} halo rows but each shard only "
                         f"holds {hs}; use fewer shards for this size")


def _stage_a_map(m: np.ndarray | None, in_vid: int, in_full: int,
                 in_off: int, ah_pad: int) -> np.ndarray | None:
    """A stage-A H map: the source rows (``in_vid`` of ``in_full``, from
    ``in_off``) embedded into the ``ah_pad``-row source-resolution
    intermediate at offset 0 (zero rows ignore the crop, zero columns keep
    the pad rows exact 0); None where it would be the identity."""
    if m is None and in_full == ah_pad and in_off == 0 and in_vid == ah_pad:
        return None
    if m is None:
        m = np.eye(in_vid)
    return _embed(np.asarray(m), in_total=in_full, in_off=in_off,
                  out_total=ah_pad, out_off=0)


def _stage_a(plan: pl.PipelinePlan, maps: pl.PlanMaps, shard: Shard,
             use_kernels: bool, src_h_pad: int, ah_pad: int):
    """The JAX package's stage A on this rank, ``planes -> components``
    at source resolution: the crop's columns of each plane, the chroma's W
    upsample (K1), then the blend's or the chroma upsample's H contraction
    into the ``ah_pad`` rows of the intermediate (K3, halos exchanged).
    The luma has no W pass: its normalisation rides its H table (or a
    plain scale where the map is trivial)."""
    l0, t0, r0, b0 = _geometry(plan)[0]
    crop_h, (dw, dh) = b0 - t0, plan.info.chroma_div
    ra_luma = _RowResize(_stage_a_map(maps.by, crop_h, src_h_pad, t0, ah_pad),
                         shard, use_kernels, pre_scale=maps.norm)
    if not maps.yuv:
        return lambda planes: tuple(ra_luma(p[..., l0:r0]) for p in planes)
    ra_chroma = _RowResize(
        _stage_a_map(maps.uy, crop_h // dh, src_h_pad // dh, t0 // dh,
                     ah_pad), shard, use_kernels,
        pre_scale=None if maps.ux is not None else maps.norm)
    wp_c = _WPass(maps.ux, maps.norm, use_kernels)

    def chroma(p):
        return ra_chroma(wp_c(p[..., l0 // dw:r0 // dw]))

    return lambda planes: (ra_luma(planes[0][..., l0:r0]), chroma(planes[1]),
                           chroma(planes[2]))


class _RowResize:
    """One H-axis contraction of this rank's shard: the halo from the
    shard's source, then K3 (``kernels/resize.banded_resize_rows``) on the
    rank's own table, or without kernels the dense product of its block
    (after scaling the rows, as the JAX package's XLA route)."""

    def __init__(self, mat: np.ndarray | None, shard: Shard,
                 use_kernels: bool, pre_scale: float | None = None):
        self.mat, self.shard, self.pre_scale = mat, shard, pre_scale
        if mat is None:
            return
        n = shard.size
        self.halo = required_halo(mat, n)
        _check_halo(self.halo, mat.shape[0] // n)
        block = _shard_row_mat(mat, n, self.halo, shard.rank)
        # the kernel route's table, or the plain route's unscaled block
        self.table = rk.BandedMatrix(
            block, pre_scale=pre_scale if use_kernels else None)
        self.use_kernels = use_kernels

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: this shard's (..., hs_in, W) block (raw integer where
        ``pre_scale`` folds the normalisation, int16 mid16 codes or float32);
        float32 (..., hs_out, W) out."""
        if self.mat is None:
            if self.pre_scale is not None:
                return x.float() * float(np.float32(self.pre_scale))
            return x
        ext = x if self.shard.size == 1 else self.shard.halo(x, self.halo)
        ext = ext.contiguous()
        if self.use_kernels:
            return rk.banded_resize_rows(ext, self.table)
        if self.pre_scale is not None:
            ext = ext.float() * float(np.float32(self.pre_scale))
        return scale_ops.resize_axis(ext.float(),
                                     self.table.dense_on(ext.device), -2)


class _WPass:
    """A W-axis pass on this shard's rows (columns already cropped): K1 with
    the normalisation in its taps (``mid16``: int16 codes), or the plain
    route's scale and dense product; without a map the plane comes back as
    it is (its normalisation rides the H pass)."""

    def __init__(self, mx: np.ndarray | None, norm: float | None,
                 use_kernels: bool, mid16: bool = False):
        self.norm, self.use_kernels, self.mid16 = norm, use_kernels, mid16
        self.mat = None if mx is None else rk.BandedMatrix(
            mx, pre_scale=norm if use_kernels else None)

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        if self.mat is None:
            return p
        if self.use_kernels:
            return rk.banded_resize_last_axis(p.contiguous(), self.mat,
                                              mid16=self.mid16)
        x = p.float()
        if self.norm is not None:
            x = x * float(np.float32(self.norm))
        return scale_ops.resize_axis(x, self.mat.dense_on(x.device), -1)


def _shard_final(plan: pl.PipelinePlan, shard: Shard, surf_h_pad: int,
                 pad_rows: bool, pack_surface: bool):
    """ps_final_pass.hlsl on this rank's ``surf_h_pad / n`` surface rows,
    ``final(rgb)``: the dither in video-local pattern coordinates (the
    global surface row minus the rect's top; columns are video-local until
    the W pad), then FillBlack of the rows outside the rect, the columns
    padded, the pack."""
    _, (l1, t1, r1, b1), surf_w, _ = _geometry(plan)
    fmt = pl.surface_pack_format(plan.dst) if pack_surface else None
    hs_surf = surf_h_pad // shard.size
    row0, db = shard.rank * hs_surf, plan.dither_bits

    def final(rgb):
        if db:
            rgb = torch.clamp(rgb, 0.0, 1.0)
            if db < 0:
                rgb = dither_ops.quantize(rgb, -db)
            else:
                rgb = dither_ops.ordered_dither(rgb, db, row_offset=row0 - t1)
        if plan.dst.video_rect is not None or pad_rows:
            gr = row0 + torch.arange(hs_surf, device=rgb.device)
            inside = ((gr >= t1) & (gr < b1))[:, None]
            rgb = F.pad(torch.where(inside, rgb, 0.0), (l1, surf_w - r1))
        return rgb if fmt is None else rk.pack_surface(rgb, fmt)

    return final


def _geometry(plan: pl.PipelinePlan):
    """(src rect, video rect, surface width, surface height) of a plan."""
    src, dst = plan.src, plan.dst
    return (plan.src_rect or (0, 0, src.width, src.height),
            dst.video_rect or (0, 0, dst.width, dst.height),
            dst.width, dst.height)


# ---------------------------------------------------------------------------
# the frame forms
# ---------------------------------------------------------------------------


def make_spatial_frame_fn(plan: pl.PipelinePlan, mesh: Mesh | Shard,
                          pack_surface: bool = False,
                          pad_to_mesh: bool = True,
                          surf_row_unit: int = 1):
    """Row-sharded version of the frame pipeline on this rank.

    ``fn(planes)``: this rank's rows of each plane (..., H / n, W)
    (:func:`shard_planes_rows`) -> this rank's rows of the surface,
    (..., 3, surf_h_pad / n, dst.width) float32, or with ``pack_surface``
    (..., surf_h_pad / n, dst.width) int32 dwords; the stitched ranks
    equal the one-device frame function's surface.

    Three plan classes shard:

     * fusable linear-prefix plans (``pipeline.route_of``: "fused"): K1
       per plane, K3 per plane on the rank's table, the torch tail;
     * Dolby Vision split-fused plans ("dovi_fused"): the
       reshape, RPU matrix and LMS step are per pixel (row-local), so only
       the chroma upsample's and the resize's H contractions exchange
       halos;
     * one-pass 2D Jinc2 upscales: each rank's output rows from the
       source rows their taps read (:func:`_make_spatial_jinc2`).

    Heights not divisible by the mesh are handled by ``pad_to_mesh``
    (default): plane heights zero-pad to :func:`spatial_padded_heights`
    (:func:`pad_shard_planes_rows` prepares the inputs; the pad rows get
    zero weight in the embedded H maps) and the surface has ``surf_h_pad``
    rows whose trailing pad rows are black: crop with
    ``out[..., :dst.height, :]``.  With ``pad_to_mesh=False`` a height
    not divisible raises."""
    shard = shard_of(mesh)
    route = pl.route_of(plan)
    if route == "fused":
        return _make_spatial_fused(plan, shard, pack_surface, pad_to_mesh,
                                   surf_row_unit)
    if surf_row_unit != 1:
        raise ValueError("surf_row_unit is only supported for fusable "
                         "(linear-prefix) plans — the learned-model class "
                         "composes on those")
    if route == "dovi_fused":
        return _make_spatial_dovi(plan, shard, pack_surface, pad_to_mesh)
    if _jinc2_spatial_ok(plan):
        return _make_spatial_jinc2(plan, shard, pack_surface, pad_to_mesh)
    raise ValueError(
        "spatial sharding requires a fusable (linear-prefix) plan, a DoVi "
        "split-fused plan, or a one-pass 2D Jinc2 upscale; this plan is "
        "none of those (mixed Jinc2 up/down axes, shader-order "
        "corrections, or a non-YUV DoVi source)")


def _make_spatial_fused(plan: pl.PipelinePlan, shard: Shard,
                        pack_surface: bool, pad_to_mesh: bool,
                        surf_row_unit: int = 1):
    """Row-sharded fused (linear-prefix) pipeline — see
    :func:`make_spatial_frame_fn`."""
    use_kernels = pl.kernels_allowed(plan)
    (l0, t0, r0, b0), (_, t1, _, _), _, surf_h = _geometry(plan)
    crop_h = b0 - t0
    dw, dh = plan.info.chroma_div
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(
        plan, shard.size, pad_to_mesh, surf_h, surf_row_unit)
    maps = pl.PlanMaps(plan)
    wx, cwx, norm, yuv = maps.wx, maps.cwx, maps.norm, maps.yuv

    # H maps gain the src_rect input embedding (cropped rows sit at t0 in
    # the whole padded plane) and the video_rect output embedding (video
    # rows sit at t1 in the surface; zero columns give the black fill); an
    # identity map appears wherever embedding makes the H pass non-trivial
    embed_h = (plan.src_rect is not None or plan.dst.video_rect is not None
               or src_h_pad != plan.src.height or pad_rows)

    def h_map(m, in_full, in_off, in_vid):
        if m is None and not embed_h:
            return None
        if m is None:
            m = np.eye(in_vid)
        return _embed(np.asarray(m), in_total=in_full, in_off=in_off,
                      out_total=surf_h_pad, out_off=t1)

    my_luma = h_map(maps.wy_luma, src_h_pad, t0, crop_h)
    my_chroma = (h_map(maps.cwy, src_h_pad // dh, t0 // dh, crop_h // dh)
                 if yuv else None)

    # int16 W-pass intermediates, the unsharded kernel route's; their
    # 1/MID16_SCALE unscale folds into the H tables
    mid16_y, mid16_c = pl.mid16_planes(plan, maps)
    unscale = 1.0 / rk.MID16_SCALE
    ry_luma = _RowResize(my_luma, shard, use_kernels,
                         pre_scale=(norm if wx is None
                                    else unscale if mid16_y else None))
    ry_chroma = (_RowResize(my_chroma, shard, use_kernels,
                            pre_scale=(norm if cwx is None
                                       else unscale if mid16_c else None))
                 if yuv else None)

    final = _shard_final(plan, shard, surf_h_pad, pad_rows, pack_surface)
    vals = pl.CallValues(plan)

    wp_y = _WPass(wx, norm, use_kernels, mid16_y)
    wp_c = _WPass(cwx, norm, use_kernels, mid16_c)

    def luma(p):
        return ry_luma(wp_y(p[..., l0:r0]))

    def chroma(p):
        return ry_chroma(wp_c(p[..., l0 // dw:r0 // dw]))

    def fn(planes):
        comps = ((luma(planes[0]), chroma(planes[1]), chroma(planes[2]))
                 if yuv else tuple(luma(p) for p in planes))
        return pl.torch_tail(plan, vals, comps, end=final)

    return fn


def _make_spatial_dovi(plan: pl.PipelinePlan, shard: Shard,
                       pack_surface: bool, pad_to_mesh: bool):
    """Row-sharded Dolby Vision split-fused pipeline: stage A upsamples the
    chroma to source resolution (the uy H contraction exchanges halos) and
    runs the reshape, the RPU ycc matrix and the LMS PQ round trip, all
    per pixel, so row-local; stage B resizes the PQ RGB to the surface (the
    wy H contraction exchanges halos) and runs the corrections, tone map
    and dither per shard (the reference chain: Source/Shaders.cpp:531-859).
    The JAX package's form, stage for stage; the one-device port runs K8
    and K9 instead (``pipeline._make_dovi_fused_fn``)."""
    n = shard.size
    use_kernels = pl.kernels_allowed(plan)
    _, (_, t1, _, _), _, surf_h = _geometry(plan)
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(plan, n, pad_to_mesh,
                                                       surf_h)
    ah_pad = _stage_a_height(plan, n, pad_to_mesh)   # stage A's rows
    # the plan's maps: at the crop's size, as the shards take them
    maps = pl.PlanMaps(plan)
    stage_a = _stage_a(plan, maps, shard, use_kernels, src_h_pad, ah_pad)

    # stage B's H map: the video rows embedded into the surface at the
    # rect's top
    mb = maps.wy
    if mb is None and not (ah_pad == surf_h_pad and t1 == 0):
        mb = np.eye(maps.vid_h)
    if mb is not None:
        mb = _embed(np.asarray(mb), in_total=ah_pad, in_off=0,
                    out_total=surf_h_pad, out_off=t1)
    rb = _RowResize(mb, shard, use_kernels)

    final = _shard_final(plan, shard, surf_h_pad, pad_rows, pack_surface)
    vals = pl.CallValues(plan)
    wp_rgb = _WPass(maps.wx, None, use_kernels)

    def fn(planes):
        # stage A: raw integer planes -> source-resolution ycc; then the
        # reshape, the ycc matrix and the LMS PQ round trip, per pixel
        rgb = pl.dovi_convert(plan, vals, torch.stack(stage_a(planes), -3))
        # stage B: resize the PQ RGB to the surface
        return pl.torch_tail(plan, vals, rb(wp_rgb(rgb)), end=final)

    return fn


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (dim -2) of a plane, uint16 through its int16 view."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).index_select(-2, idx).view(torch.uint16)
    return x.index_select(-2, idx)


def _halo_over(n: int, hs: int, needs) -> int:
    """The halo that gives every shard of ``hs`` rows the rows it needs:
    ``needs(q)``, shard q's (first, last) row, or None."""
    halo = 0
    for q in range(n):
        need = needs(q)
        if need is not None:
            halo = max(halo, q * hs - need[0], need[1] - ((q + 1) * hs - 1))
    return halo


def _make_spatial_jinc2(plan: pl.PipelinePlan, shard: Shard,
                        pack_surface: bool, pad_to_mesh: bool):
    """Row-sharded one-pass 2D Jinc2 upscale in the port's direct form.

    A rank's surface rows hold video rows v0 .. v1; their 4x4 taps read
    the cropped source rows lo .. hi (``ops/scale.jinc2_axis_tables``),
    clamped to the crop as the one-device resample clamps them.  The rank
    gathers those rows from its halo-extended block and runs the frame's
    Jinc2 on that band (``kernels/jinc2.Jinc2Rows``: the band's rows of the
    frame's tap tables and weight table, the dither at the frame's rows),
    so its outputs are the one-device outputs bit for bit:

     * where the one-device path runs K6 (a YUV source with its matrix, no
       blend, the dither-only tail, no placement), one exchange of the raw
       planes, the chroma rows the band's upsample reads (its H map cut to
       the band) and one K6 launch, dither and pack inside;
     * otherwise the JAX package's stage A (the convert at source
       resolution, the chroma upsample's and the blend's H contractions
       exchanging halos, K1 and K3), one exchange of the RGB, K5 on the
       band, then the corrections, the local tone map and the final pass
       in torch.

    The JAX package shards the same plans through its low-rank expansion
    (``videorenderer_tpu/parallel/spatial.py:624-800``)."""
    dst, info = plan.dst, plan.info
    n, rank = shard.size, shard.rank
    use_kernels = pl.kernels_allowed(plan)
    (l0, t0, r0, b0), (_, t1, _, _), _, surf_h = _geometry(plan)
    crop_h = b0 - t0
    vid_w, vid_h = dst.video_size
    dw, dh = info.chroma_div
    maps = pl.PlanMaps(plan)
    ux, uy, norm, yuv = maps.ux, maps.uy, maps.norm, maps.yuv
    vals = pl.CallValues(plan)
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(plan, n, pad_to_mesh,
                                                       surf_h)
    ah_pad = _stage_a_height(plan, n, pad_to_mesh)
    hs_surf = surf_h_pad // n
    has_vrect = dst.video_rect is not None
    fmt = pl.surface_pack_format(dst) if pack_surface else None
    base, _ = scale_ops.jinc2_axis_tables(crop_h, vid_h)

    def band(q):
        """Shard q's video rows (v0, v1) and their taps' crop rows (lo,
        hi), unclamped; None without video rows."""
        v0 = min(max(q * hs_surf - t1, 0), vid_h)
        v1 = min(max((q + 1) * hs_surf - t1, 0), vid_h)
        if v1 <= v0:
            return None
        return v0, v1, int(base[v0]) - 1, int(base[v1 - 1]) + 3

    def clamped(q):
        """Shard q's tap rows clamped to the crop: (first, last) crop row."""
        b = band(q)
        return None if b is None else (max(b[2], 0), min(b[3], crop_h) - 1)

    mine = band(rank)
    if mine is not None:
        v0, v1, lo, hi = mine
        crop_rows = np.clip(np.arange(lo, hi), 0, crop_h - 1)
        rows = jk.Jinc2Rows(crop_h, vid_h, v0, lo)

    j2_tail = (not (plan.convert_to_sdr or plan.hlg_to_pq
                    or plan.fix_bt2020_sdr or plan.local_tonemap)
               and not has_vrect and plan.dither_bits != 0)

    def black(lead, k, device):
        """``k`` black surface rows: the packed zero, or float zeros."""
        if fmt is None:
            return torch.zeros(lead + (3, k, vid_w), device=device)
        return torch.full(lead + (k, vid_w), rk.PACKED_ZERO[fmt],
                          dtype=torch.int32, device=device)

    if (use_kernels and yuv and plan.apply_matrix and not maps.blend
            and j2_tail):
        # K6: the raw planes' halos, the band's rows gathered, one launch
        hs_y = src_h_pad // n
        halo_y = _halo_over(n, hs_y, lambda q: None if clamped(q) is None
                            else tuple(t0 + r for r in clamped(q)))
        cmat = np.concatenate([vals.m, vals.c[:, None]], axis=1)
        kw_c = None if ux is None else rk.BandedMatrix(ux, pre_scale=norm)
        c_scale = norm if kw_c is None else 1.0
        epi = jk.dither_epilogue(plan.dither_bits)

        def c_rows(q):
            """Crop chroma rows (first, last) shard q's band reads."""
            c = clamped(q)
            if c is None:
                return None
            if uy is None:
                return c
            nz = np.nonzero(uy[:, c[0]:c[1] + 1])[0]
            return int(nz.min()), int(nz.max())

        c_t0 = t0 // dh if uy is not None else t0
        hs_c = src_h_pad // dh // n if uy is not None else hs_y
        halo_c = _halo_over(n, hs_c, lambda q: None if c_rows(q) is None
                            else tuple(c_t0 + r for r in c_rows(q)))
        _check_halo(halo_y, hs_y)
        _check_halo(halo_c, hs_c)
        if mine is not None:
            idx_y = torch.from_numpy(t0 + crop_rows - (rank * hs_y - halo_y))
            c_lo, c_hi = c_rows(rank)
            if uy is None:
                idx_c, kh_c = idx_y, None
            else:
                idx_c = torch.arange(c_lo, c_hi + 1) + c_t0 - (
                    rank * hs_c - halo_c)
                kh_c = rk.BandedMatrix(uy[c_lo:c_hi + 1][:, crop_rows])

        def k6_fn(planes):
            y, u, v = planes
            if n > 1:
                y, u, v = (shard.halo(y, halo_y), shard.halo(u, halo_c),
                           shard.halo(v, halo_c))
            lead = y.shape[:-2]
            if mine is None:
                return black(lead, hs_surf, y.device)
            cols_c = slice(l0 // dw, r0 // dw)
            yb = _take_rows(y, idx_y.to(y.device))[..., l0:r0].contiguous()
            ub = _take_rows(u, idx_c.to(u.device))[..., cols_c].contiguous()
            vb = _take_rows(v, idx_c.to(v.device))[..., cols_c].contiguous()
            out = jk.jinc2_convert_fused(yb, ub, vb, kh_c, kw_c, cmat,
                                         v1 - v0, vid_w, norm, c_scale,
                                         epilogue=epi, pack_format=fmt,
                                         rows=rows)
            k = hs_surf - (v1 - v0)     # the mesh's pad rows below the video
            return out if k == 0 else torch.cat(
                [out, black(lead, k, out.device)], dim=-2)

        return k6_fn

    # the JAX package's stage A, then K5 on the band and the torch tail
    stage_a = _stage_a(plan, maps, shard, use_kernels, src_h_pad, ah_pad)
    ah_s = ah_pad // n
    halo_j = _halo_over(n, ah_s, clamped)
    _check_halo(halo_j, ah_s)
    if mine is not None:
        idx_j = torch.from_numpy(crop_rows - (rank * ah_s - halo_j))

    final = _shard_final(plan, shard, surf_h_pad, pad_rows, pack_surface)

    def k5_fn(planes):
        rgb = vals.matrix(stage_a(planes))
        if n > 1:
            rgb = shard.halo(rgb, halo_j)
        video = rgb.new_zeros(rgb.shape[:-2] + (hs_surf, vid_w))
        if mine is not None:
            out = jk.jinc2_resize_fused(
                _take_rows(rgb, idx_j.to(rgb.device)).contiguous(), v1 - v0,
                vid_w, rows=rows)
            out = pl.torch_tail(plan, vals, out, end=lambda x: x)
            first = v0 + t1 - rank * hs_surf
            video[..., first:first + (v1 - v0), :] = out
        return final(video)

    return k5_fn


# ---------------------------------------------------------------------------
# the learned models
# ---------------------------------------------------------------------------


def make_spatial_learned_fn(plan: pl.PipelinePlan, mesh: Mesh | Shard,
                            model, kind: str, pack_surface: bool = False,
                            pad_to_mesh: bool = True):
    """Row-sharded learned-model composition: the 1:1 convert pipeline in
    its sharded fused form, then the conv net per shard on halo-extended
    rows.

    ``kind`` is ``"superres"`` (``models/superres.enhance_plane_chw``, the
    vendor-SR slot, Source/D3D11VP.cpp:712-844) or ``"videohdr"``
    (``models/videohdr.enhance_plane_chw``, the RTX Video HDR slot,
    Source/D3D11VP.cpp:846-891); ``model`` the loaded model (its ``cfg``
    gives ``s2d`` and the scale), on the rank's device.

    Why it is exact: every conv is zero-padded by one, so an output row at
    distance >= R (the summed conv radius,
    :func:`model_receptive_radius_s2d`) from a block edge equals the whole
    frame's.  Each shard extends its rows by ``halo = R * s2d`` source rows,
    zeroes the halo rows outside the frame (the exchange replicates the
    edge, the whole frame's padding is zero), runs the net with
    ``row_valid``, the frame's rows in the block's s2d rows (each conv's
    output rows outside the frame are zeroed again, or the halo rows would
    carry relu(bias) that the whole frame never has), and crops the halo.
    The space-to-depth grid stays shard-local because each shard's height
    is a multiple of ``s2d`` (``surf_row_unit``).

    Returns this rank's rows of (..., 3, H scale, W scale) float32 (scale =
    ``cfg.scale`` for SuperRes, 1 for VideoHDR), or the packed int32
    surface with ``pack_surface``; rows the mesh padded are black: crop
    the stitched surface with ``[..., :H scale, :]``."""
    from ..models import superres, videohdr
    if kind == "superres":
        net, scale = superres.enhance_plane_chw, model.cfg.scale
    elif kind == "videohdr":
        net, scale = videohdr.enhance_plane_chw, 1
    else:
        raise ValueError(f"unknown learned-model kind {kind!r}")
    shard = shard_of(mesh)
    s2d = int(model.cfg.s2d)
    n, surf_h = shard.size, plan.dst.height
    if surf_h % s2d != 0:
        raise ValueError(
            f"spatial learned-model sharding needs the model input height "
            f"({surf_h}) divisible by cfg.s2d={s2d}: the single-device model "
            "edge-pads the s2d grid, which zero halos cannot reproduce")
    base = make_spatial_frame_fn(plan, shard, pack_surface=False,
                                 pad_to_mesh=pad_to_mesh, surf_row_unit=s2d)
    _, surf_h_pad = spatial_padded_heights(plan, n, surf_unit=s2d)
    hs = surf_h_pad // n
    halo = model_receptive_radius_s2d(model) * s2d
    _check_halo(halo, hs, "learned-model sharding")
    fmt = pl.surface_pack_format(plan.dst) if pack_surface else None
    pad_rows = surf_h_pad != surf_h

    def fn(planes):
        rgb = base(planes)
        if n == 1:
            y = net(model, rgb)
        else:
            ext = shard.halo(rgb, halo)
            start = shard.rank * hs - halo      # the block's global row 0
            gr = start + torch.arange(hs + 2 * halo, device=ext.device)
            ext = torch.where(((gr >= 0) & (gr < surf_h))[:, None], ext, 0.0)
            y = net(model, ext,
                    row_valid=(-start // s2d, (surf_h - start) // s2d))
            y = y[..., halo * scale:(halo + hs) * scale, :]
            if pad_rows:
                # the mesh's pad rows stay black (the biases would leak)
                gro = shard.rank * hs * scale + torch.arange(
                    hs * scale, device=y.device)
                y = torch.where((gro < surf_h * scale)[:, None], y, 0.0)
        return y if fmt is None else rk.pack_surface(y, fmt)

    return fn


# ---------------------------------------------------------------------------
# placing and gathering rows
# ---------------------------------------------------------------------------


def shard_planes_rows(mesh: Mesh | Shard, planes) -> tuple:
    """This rank's rows of each (..., H, W) plane (tensors or numpy arrays),
    contiguous on the mesh's device; H must split over the mesh."""
    shard = shard_of(mesh)
    n, r = shard.size, shard.rank
    out = []
    for p in planes:
        p = torch.as_tensor(p)
        h = p.shape[-2]
        if h % n:
            raise ValueError(f"{h} rows do not split over {n} shards; pad "
                             "with pad_shard_planes_rows")
        hs = h // n
        p = p[..., r * hs:(r + 1) * hs, :].contiguous()
        out.append(p if shard.device is None else p.to(shard.device))
    return tuple(out)


def pad_shard_planes_rows(plan: pl.PipelinePlan, mesh: Mesh | Shard,
                          planes) -> tuple:
    """Zero-pad plane heights to :func:`spatial_padded_heights` and take this
    rank's rows: the input half of the pad-and-crop fallback (the pad rows
    carry zero weight in the embedded H maps)."""
    n = shard_of(mesh).size
    src_h_pad, _ = spatial_padded_heights(plan, n)
    info = plan.info
    dh = info.chroma_div[1]
    out = []
    for i, p in enumerate(planes):
        p = torch.as_tensor(p)
        target = (src_h_pad // dh
                  if i > 0 and info.cs_type == ColorSystem.YUV else src_h_pad)
        if p.shape[-2] < target:
            p = F.pad(p, (0, 0, 0, target - p.shape[-2]))
        out.append(p)
    return shard_planes_rows(mesh, out)


def gather_rows(mesh: Mesh, y: torch.Tensor) -> torch.Tensor:
    """Every rank's rows (dim -2) of a spatial function's output, stitched
    in rank order on every rank (an all-gather over the mesh's group)."""
    if mesh.size == 1:
        return y
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=-2)
