"""Dolby Vision reshaping (poly + MMR) and the LMS colour pipeline.

Port of ``videorenderer_tpu.ops.dovi``.  The host side (metadata, the RPU
fixed-point scaling, the packed runtime curves and the static curve
structure) is numpy, equal to the JAX package's; the per-pixel side is
torch.

Reference equivalents:
 * RPU metadata model: ``MediaSideDataDOVIMetadata``
   (Include/IMediaSideData.h:146-230)
 * curve upload and fixed-point scaling: SetShaderDoviCurves(Poly)
   (Source/DX11VideoProcessor.cpp:990-1130): coefficients times
   2^-coef_log2_denom, pivots over the base layer's code range, unused pivot
   slots padded with +inf
 * the reshape: ShaderDoviReshape(Poly) (Source/Shaders.cpp:531-589) and
   reshape_mmr (Source/Shaders.cpp:733-763)
 * the LMS -> RGB post-matrix chain with its PQ round trip
   (Source/Shaders.cpp:824-859)

The reference picks a piece per pixel with a pivot search; here, as in the
JAX package, the piece index is the count of pivots at or below the signal
and each piece's value is selected by it, and only the pieces, kinds and
MMR orders the metadata has are evaluated.  Kernel K8
(``kernels/deint.rows3_mid``) evaluates the same reshape from the flat
scalar layout of :func:`flatten_curve_scalars`.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from .transfer import linear_to_st2084, st2084_to_linear


@dataclass(frozen=True)
class ReshapeCurve:
    """One component's piecewise reshape curve, already normalised (the
    analogue of PS_DOVI_CURVE after SetShaderDoviCurves scaling).

    pivots: (num_pieces - 1,) interior pivots in [0,1], ascending.
    method: per piece, 0 = polynomial, 1 = MMR.
    poly:   (num_pieces, 3) coefficients c0 + c1*s + c2*s^2.
    mmr_order/mmr_constant/mmr_coef: per-piece MMR data; mmr_coef is
    (num_pieces, 3, 7): [order-1][3 linear + 4 cross terms].
    """

    pivots: tuple[float, ...]
    method: tuple[int, ...]
    poly: np.ndarray
    mmr_order: tuple[int, ...] = ()
    mmr_constant: tuple[float, ...] = ()
    mmr_coef: np.ndarray | None = None

    @property
    def num_pieces(self) -> int:
        return len(self.method)

    @property
    def has_mmr(self) -> bool:
        return any(m == 1 for m in self.method)


@dataclass(frozen=True)
class DoviMetadata:
    """Normalised Dolby Vision mapping and colour metadata
    (MediaSideDataDOVIMetadata, Include/IMediaSideData.h:146-230)."""

    curves: tuple[ReshapeCurve, ReshapeCurve, ReshapeCurve]
    ycc_to_rgb_matrix: np.ndarray    # (3,3)
    ycc_to_rgb_offset: np.ndarray    # (3,)
    rgb_to_lms_matrix: np.ndarray    # (3,3)


def identity_curve() -> ReshapeCurve:
    return ReshapeCurve(pivots=(), method=(0,),
                        poly=np.array([[0.0, 1.0, 0.0]]))


# The BT.2020 LMS->RGB (Hunt-Pointer-Estevez, no crosstalk) constant of the
# codegen (Source/Shaders.cpp:825-829).
DOVI_LMS2RGB = np.array([
    [3.06441879, -2.16597676, 0.10155818],
    [-0.65612108, 1.78554118, -0.12943749],
    [0.01736321, -0.04725154, 1.03004253],
])


def metadata_from_numpy(fields: Mapping) -> DoviMetadata:
    """A :class:`DoviMetadata` from plain fields: ``curves`` (three
    mappings of ``pivots``, ``method``, ``poly`` and optionally
    ``mmr_order``, ``mmr_constant``, ``mmr_coef``), ``ycc_to_rgb_matrix``,
    ``ycc_to_rgb_offset`` and ``rgb_to_lms_matrix``, as numpy arrays or
    sequences.  ``dataclasses.asdict`` of another package's metadata of the
    same fields gives such a mapping."""
    def curve(c: Mapping) -> ReshapeCurve:
        coef = c.get("mmr_coef")
        return ReshapeCurve(
            pivots=tuple(float(p) for p in np.asarray(c["pivots"]).ravel()),
            method=tuple(int(m) for m in np.asarray(c["method"]).ravel()),
            poly=np.array(c["poly"], dtype=np.float64),
            mmr_order=tuple(int(o) for o in
                            np.asarray(c.get("mmr_order", ())).ravel()),
            mmr_constant=tuple(float(k) for k in
                               np.asarray(c.get("mmr_constant", ())).ravel()),
            mmr_coef=None if coef is None else np.array(coef,
                                                        dtype=np.float64))

    if len(fields["curves"]) != 3:
        raise ValueError(f"need three curves, got {len(fields['curves'])}")
    return DoviMetadata(
        curves=tuple(curve(c) for c in fields["curves"]),
        ycc_to_rgb_matrix=np.array(fields["ycc_to_rgb_matrix"], np.float64),
        ycc_to_rgb_offset=np.array(fields["ycc_to_rgb_offset"], np.float64),
        rgb_to_lms_matrix=np.array(fields["rgb_to_lms_matrix"], np.float64))


def from_rpu_mapping(num_pivots, pivots, mapping_idc, poly_order, poly_coef,
                     mmr_order, mmr_constant, mmr_coef,
                     bl_bit_depth: int, coef_log2_denom: int) -> ReshapeCurve:
    """Build a normalised curve from raw RPU fixed-point fields with the
    scaling of SetShaderDoviCurves (Source/DX11VideoProcessor.cpp:996-997):
    coefficients * 2^-coef_log2_denom, pivots / (2^bl_bit_depth - 1)."""
    scale = 1.0 / ((1 << bl_bit_depth) - 1)
    scale_coef = 1.0 / (1 << coef_log2_denom)
    n = int(num_pivots) - 1
    piv = tuple(float(pivots[i + 1]) * scale for i in range(n - 1))
    method = tuple(int(mapping_idc[i]) for i in range(n))
    poly = np.zeros((n, 3))
    morder, mconst = [], []
    mcoef = np.zeros((n, 3, 7))
    for i in range(n):
        if method[i] == 0:
            poly[i, 0] = scale_coef * poly_coef[i][0]
            poly[i, 1] = scale_coef * poly_coef[i][1] if poly_order[i] >= 1 else 0.0
            poly[i, 2] = scale_coef * poly_coef[i][2] if poly_order[i] >= 2 else 0.0
            morder.append(0)
            mconst.append(0.0)
        else:
            morder.append(int(mmr_order[i]))
            mconst.append(scale_coef * float(mmr_constant[i]))
            for j in range(int(mmr_order[i])):
                for k in range(7):
                    mcoef[i, j, k] = scale_coef * float(mmr_coef[i][j][k])
    return ReshapeCurve(pivots=piv, method=method, poly=poly,
                        mmr_order=tuple(morder), mmr_constant=tuple(mconst),
                        mmr_coef=mcoef)


# ---------------------------------------------------------------------------
# host side: packed runtime curves and the static structure
# ---------------------------------------------------------------------------


def curve_structure(meta: DoviMetadata) -> tuple:
    """The STATIC reshape structure: per channel (num_pieces, per-piece
    kinds, per-piece MMR orders).  A scene whose curves change only in
    value keeps it; a change of piece count, kind or MMR order is a
    re-plan (the reference regenerates its reshape HLSL then).  Serving
    callers pack each scene with ``pack_curves(meta, like=structure)`` so
    such a drift raises."""
    for cv in meta.curves:
        if cv.has_mmr and len(cv.mmr_order) != cv.num_pieces:
            raise ValueError("malformed ReshapeCurve: mmr_order needs one "
                             "entry per piece (use from_rpu_mapping)")
    return tuple((cv.num_pieces, cv.method, cv.mmr_order)
                 for cv in meta.curves)


def pack_curves(meta: DoviMetadata, like: tuple | None = None) -> dict:
    """Pack the three reshape curves into fixed-shape float32 arrays, the
    per-scene runtime values (the analogue of the reference re-uploading
    its DoVi cbuffers per sample, Source/DX11VideoProcessor.cpp:990-1130).

    Shapes (C=3 components, P=8 pieces at most, 7 interior pivots):
      pivots (C,7) padded with +inf; poly (C,P,3); is_mmr (C,P);
      mmr_const (C,P); mmr_coef (C,P,3,7); mmr_order (C,P)

    ``like``: the serving plan's :func:`curve_structure`; metadata of
    another structure raises instead of silently feeding a program built
    for the plan's."""
    if like is not None:
        got = curve_structure(meta)
        if got != like:
            raise ValueError(
                "DoVi curve structure changed: the serving plan was built "
                f"for {like} but this scene's metadata has {got}; rebuild "
                "the plan (values-only updates never rebuild, structural "
                "changes are the shader-regeneration case)")
    C, P = 3, 8
    pivots = np.full((C, 7), np.inf, np.float32)
    poly = np.zeros((C, P, 3), np.float32)
    is_mmr = np.zeros((C, P), np.float32)
    mmr_const = np.zeros((C, P), np.float32)
    mmr_coef = np.zeros((C, P, 3, 7), np.float32)
    mmr_order = np.zeros((C, P), np.float32)
    for c, curve in enumerate(meta.curves):
        n = curve.num_pieces
        for i, p in enumerate(curve.pivots):
            pivots[c, i] = p
        poly[c, :n] = curve.poly
        # pieces beyond n replicate the last one, so any selection is
        # well-defined
        poly[c, n:] = curve.poly[n - 1]
        for i in range(n):
            if curve.method[i] == 1:
                is_mmr[c, i] = 1.0
                mmr_const[c, i] = curve.mmr_constant[i]
                mmr_order[c, i] = curve.mmr_order[i]
                mmr_coef[c, i] = curve.mmr_coef[i]
    return {"pivots": pivots, "poly": poly, "is_mmr": is_mmr,
            "mmr_const": mmr_const, "mmr_coef": mmr_coef,
            "mmr_order": mmr_order}


def host_arrays(values: Mapping, name: str = "dovi_curves") -> dict:
    """A serving call's runtime values (a :func:`pack_curves` dict, or a
    colour matrix's ``{"m", "c"}``) as float32 numpy arrays on the host.
    Numpy arrays and CPU tensors are taken; CUDA tensors are refused:
    reading them back would synchronise the stream on every scene."""
    out = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                raise TypeError(
                    f"{name}[{k!r}] lies on {v.device}: pass a scene's "
                    "values as host arrays (numpy or CPU tensors), reading "
                    "a device tensor back would synchronise")
            v = v.numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def curve_scalar_count(structure: tuple) -> int:
    """Length of :func:`flatten_curve_scalars`' vector for ``structure``."""
    n = 0
    for pieces, kinds, orders in structure:
        n += pieces - 1                      # pivots
        for p in range(pieces):
            if kinds[p] == 0:
                n += 3                       # poly c0 c1 c2
            else:
                n += 1 + 7 * int(orders[p])  # const + per-order 3+4 weights
    return n


def flatten_curve_scalars(curves: Mapping, structure: tuple) -> np.ndarray:
    """A :func:`pack_curves` dict flattened into the float32 layout the
    reshape of kernel K8 reads: per channel its ``pieces - 1`` pivots, then
    per piece the poly (c0, c1, c2) or the MMR constant and ``order`` x 7
    weights."""
    curves = host_arrays(curves)
    segs = []
    for c, (pieces, kinds, orders) in enumerate(structure):
        segs.append(curves["pivots"][c][:pieces - 1])
        for p in range(pieces):
            if kinds[p] == 0:
                segs.append(curves["poly"][c, p])
            else:
                o = int(orders[p])
                segs.append(curves["mmr_const"][c, p].reshape(1))
                segs.append(curves["mmr_coef"][c, p, :o].reshape(-1))
    out = np.concatenate(segs).astype(np.float32) if segs else \
        np.zeros((0,), np.float32)
    assert out.shape[0] == curve_scalar_count(structure), \
        (out.shape, structure)      # layout drift guard vs the kernel reader
    return out


def build_ycc_to_rgb_cmat(meta: DoviMetadata, brightness: float = 0.0,
                          contrast: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """DoVi replaces the standard YUV->RGB matrix with the RPU's
    ycc_to_rgb matrix and offset (SetShaderConvertColorParams DoVi branch,
    Source/DX11VideoProcessor.cpp:817-836)."""
    m = meta.ycc_to_rgb_matrix * contrast
    c = np.full(3, brightness) - m @ meta.ycc_to_rgb_offset
    return m, c


def lms_pipeline_matrix(meta: DoviMetadata) -> np.ndarray:
    """mat = DOVI_LMS2RGB @ rgb_to_lms (Source/Shaders.cpp:830-837)."""
    return DOVI_LMS2RGB @ meta.rgb_to_lms_matrix


def lms_is_identity(meta: DoviMetadata) -> bool:
    """The static identity fold of :func:`apply_lms_matrix`: the RPU's LMS
    matrices are mutual inverses (profile 8.1 streams without crosstalk)."""
    return bool(np.allclose(lms_pipeline_matrix(meta), np.eye(3), atol=1e-12))


# ---------------------------------------------------------------------------
# torch side
# ---------------------------------------------------------------------------


def _comp(x: torch.Tensor, i: int, axis: int) -> torch.Tensor:
    return x.select(axis, i)


def _mmr(const, coef, order: int, sig, order_mask=None):
    """reshape_mmr (Source/Shaders.cpp:733-763): c + sum over orders j of
    dot(w_lin_j, sig^j) + dot(w_cross_j, sigX^j), sigX = (s0s1, s0s2, s1s2,
    s0s1s2).  ``coef[j][k]`` are host floats; ``order_mask``, when given,
    gates each order-j term by (mask > j)."""
    s0, s1, s2 = sig
    lin = [s0, s1, s2]
    cross = [s0 * s1, s0 * s2, s1 * s2, s0 * s1 * s2]
    out = torch.full_like(s0, float(const))
    lin_j, cross_j = lin, cross
    for j in range(order):
        if j > 0:
            lin_j = [a * b for a, b in zip(lin_j, lin)]
            cross_j = [a * b for a, b in zip(cross_j, cross)]
        w = [float(x) for x in coef[j]]
        t_lin = sum(w[k] * lin_j[k] for k in range(3))
        t_cross = sum(w[3 + k] * cross_j[k] for k in range(4))
        if order_mask is not None and not order_mask > j:
            t_lin, t_cross = t_lin * 0.0, t_cross * 0.0
        out = out + t_lin
        out = out + t_cross
    return out


def _poly(c, s):
    c0, c1, c2 = (float(v) for v in c)
    return (c2 * s + c1) * s + c0


def _select(s, pivots, vals):
    """vals[idx] with idx = the count of pivots at or below s."""
    if len(vals) == 1:
        return vals[0]
    idx = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for p in pivots:
        idx = idx + (s >= float(p)).to(torch.int32)
    val = vals[0]
    for i in range(1, len(vals)):
        val = torch.where(idx == i, vals[i], val)
    return val


def reshape(ycc: torch.Tensor, meta: DoviMetadata, axis: int = -3
            ) -> torch.Tensor:
    """Apply the per-component piecewise reshape to the (Y, Cb, Cr) signal
    stacked on ``axis`` (ShaderDoviReshape, Source/Shaders.cpp:554-589);
    returns the reshaped signal clamped to [0,1]."""
    sig = [torch.clamp(_comp(ycc, i, axis), 0.0, 1.0) for i in range(3)]
    out = []
    for c, curve in enumerate(meta.curves):
        s = sig[c]
        vals = [_poly(curve.poly[i], s) if curve.method[i] == 0
                else _mmr(curve.mmr_constant[i], curve.mmr_coef[i],
                          curve.mmr_order[i], sig)
                for i in range(curve.num_pieces)]
        out.append(torch.clamp(_select(s, curve.pivots, vals), 0.0, 1.0))
    return torch.stack(out, dim=axis)


def reshape_dynamic(ycc: torch.Tensor, curves: Mapping, axis: int = -3,
                    structure: tuple | None = None) -> torch.Tensor:
    """The reshape from a :func:`pack_curves` dict of host arrays, the
    per-scene runtime values.  ``structure`` (the plan's
    :func:`curve_structure`) prunes the evaluation to the pieces, kinds and
    orders that exist; without it every piece of 8 evaluates a polynomial
    and an order-3 MMR gated by the runtime ``is_mmr`` and ``mmr_order``."""
    cv = host_arrays(curves)
    sig = [torch.clamp(_comp(ycc, i, axis), 0.0, 1.0) for i in range(3)]
    out = []
    for c in range(3):
        s = sig[c]
        if structure is not None:
            n_pieces, kinds, orders = structure[c]
        else:
            n_pieces, kinds, orders = 8, None, None

        def piece_val(p):
            pv_poly = _poly(cv["poly"][c, p], s)
            if kinds is not None:
                if kinds[p] == 0:
                    return pv_poly
                return _mmr(cv["mmr_const"][c, p], cv["mmr_coef"][c, p],
                            int(orders[p]), sig)
            pv_mmr = _mmr(cv["mmr_const"][c, p], cv["mmr_coef"][c, p], 3, sig,
                          order_mask=float(cv["mmr_order"][c, p]))
            return pv_mmr if cv["is_mmr"][c, p] > 0 else pv_poly

        vals = [piece_val(p) for p in range(n_pieces)]
        out.append(torch.clamp(
            _select(s, cv["pivots"][c][:n_pieces - 1], vals), 0.0, 1.0))
    return torch.stack(out, dim=axis)


def _lms_step(rgb: list, mat) -> list:
    """The LMS step on three PQ channels: PQ EOTF, the combined matrix
    ``mat`` (3x3 host floats, None for the identity fold), PQ OETF."""
    if mat is None:
        return [torch.clamp(c, min=0.0) for c in rgb]
    m = [[float(v) for v in row] for row in mat]
    r, g, b = (st2084_to_linear(torch.clamp(c, min=0.0), 1.0) for c in rgb)
    return [linear_to_st2084(torch.clamp(
        m[i][0] * r + m[i][1] * g + m[i][2] * b, min=0.0), 1.0)
        for i in range(3)]


def apply_lms_matrix(rgb_pq: torch.Tensor, meta: DoviMetadata,
                     axis: int = -3) -> torch.Tensor:
    """PQ EOTF -> the LMS-combined matrix -> PQ OETF
    (Source/Shaders.cpp:845-859), at the 1.0 = 10000-nit PQ scale.

    Static identity fold, as in the JAX package: when the RPU's LMS
    matrices are mutual inverses the combined matrix is I and the round
    trip is exactly the input clamped at 0, so it folds away at planning
    time (the matrix is a plan property; per-scene updates carry curves
    only)."""
    mat = None if lms_is_identity(meta) else lms_pipeline_matrix(meta)
    return torch.stack(_lms_step([_comp(rgb_pq, i, axis) for i in range(3)],
                                 mat), dim=axis)


def reshape_from_scalars(sig, scalars: np.ndarray, structure: tuple) -> list:
    """The reshape of (y, u, v) tensors with the coefficients read from the
    flat vector of :func:`flatten_curve_scalars` (host float32) — the
    plain version of kernel K8's reshape, the port of the JAX package's
    ``reshape_tiles_from_scalars``.  Returns the three reshaped
    components."""
    vals = [float(v) for v in np.asarray(scalars, np.float32)]
    if len(vals) != curve_scalar_count(structure):
        raise ValueError(f"{len(vals)} curve scalars for a structure of "
                         f"{curve_scalar_count(structure)}")
    sig = [torch.clamp(s, 0.0, 1.0) for s in sig]
    out, o = [], 0
    for c, (pieces, kinds, orders) in enumerate(structure):
        pivots = vals[o:o + pieces - 1]
        o += pieces - 1
        pv = []
        for p in range(pieces):
            if kinds[p] == 0:
                pv.append(_poly(vals[o:o + 3], sig[c]))
                o += 3
            else:
                n = int(orders[p])
                coef = np.reshape(vals[o + 1:o + 1 + 7 * n], (n, 7))
                pv.append(_mmr(vals[o], coef, n, sig))
                o += 1 + 7 * n
        out.append(torch.clamp(_select(sig[c], pivots, pv), 0.0, 1.0))
    return out


def reshape_tiles_from_scalars(sig, read, base: int,
                               structure: tuple) -> list:
    """The JAX package's name and signature for :func:`reshape_from_scalars`:
    the coefficients are ``read(base + i)`` for i over the structure's
    :func:`curve_scalar_count` scalars (host numbers, float32)."""
    scalars = np.asarray([float(read(base + i)) for i in
                          range(curve_scalar_count(structure))], np.float32)
    return reshape_from_scalars(sig, scalars, structure)


@dataclass(frozen=True)
class MidStage:
    """What kernel K8 runs on each pixel at the mid resolution: the
    reshape, the 3x3+c RPU matrix and the LMS step, as runtime values.

    ``cmat``: (3, 4) float32 rows (m0 m1 m2 c); ``curves``: the float32
    vector of :func:`flatten_curve_scalars` for ``structure``; ``lms``: the
    (3, 3) float32 combined LMS matrix, or None where the RPU's matrices are
    mutual inverses (the identity fold)."""

    cmat: np.ndarray
    curves: np.ndarray
    structure: tuple
    lms: np.ndarray | None

    def host_values(self) -> np.ndarray:
        """The kernel's float vector: cmat, LMS matrix (zeros when folded),
        curve scalars."""
        lms = np.zeros(9, np.float32) if self.lms is None else self.lms
        return np.ascontiguousarray(np.concatenate(
            [np.asarray(self.cmat, np.float32).reshape(-1),
             np.asarray(lms, np.float32).reshape(-1),
             np.asarray(self.curves, np.float32)]))

    def host_structure(self) -> np.ndarray:
        """Per channel: the piece count, then 8 kinds and 8 MMR orders."""
        out = np.zeros((3, 17), np.int32)
        for c, (pieces, kinds, orders) in enumerate(self.structure):
            out[c, 0] = pieces
            out[c, 1:1 + pieces] = kinds
            out[c, 9:9 + pieces] = orders if len(orders) else 0
        return out

    def plain(self, y, u, v) -> list:
        """The stage in torch on (..., H, W) planes -> [R, G, B] (PQ)."""
        yc, uc, vc = reshape_from_scalars((y, u, v), self.curves,
                                          self.structure)
        m = np.asarray(self.cmat, np.float32)
        rgb = [float(m[i, 0]) * yc + float(m[i, 1]) * uc
               + float(m[i, 2]) * vc + float(m[i, 3]) for i in range(3)]
        return _lms_step(rgb, self.lms)


def mid_stage(meta: DoviMetadata, cmat_m: np.ndarray, cmat_c: np.ndarray,
              curves: Mapping | None = None) -> MidStage:
    """The :class:`MidStage` of a plan's metadata and colour matrix, with a
    scene's :func:`pack_curves` values (host arrays) or, without them, the
    metadata's own curves."""
    structure = curve_structure(meta)
    if curves is None:
        curves = pack_curves(meta)
    m = np.asarray(cmat_m, np.float32)
    c = np.asarray(cmat_c, np.float32)
    return MidStage(
        cmat=np.concatenate([m, c[:, None]], axis=1),
        curves=flatten_curve_scalars(curves, structure), structure=structure,
        lms=(None if lms_is_identity(meta)
             else np.asarray(lms_pipeline_matrix(meta), np.float32)))
