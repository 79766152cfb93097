"""Chroma upsampling (4:2:0 / 4:2:2 -> 4:4:4) with chroma-location siting,
as (in, out) weight matrices and as stencils on tensors.

Port of the reference's convert-color shader codegen chroma section
(ShaderGetPixels, Source/Shaders.cpp:82-529) as ``videorenderer_tpu.ops.chroma``
expresses it: because the scale factor is exactly 2, every output pixel falls
into one of two sampling phases per axis with constant filter weights.  The
fused pipeline composes these upsample matrices with the resize matrices, so
chroma upsampling runs inside the banded kernels; the staged pipeline runs
:func:`upsample_chroma`, the same stencils as shifted multiply-adds.
Derivation of the phase weights (MPEG-2 siting: horizontal phases (exact),
(1/2, 1/2); vertical (1/4, 3/4), (3/4, 1/4)) is at the JAX original.  The
matrix builders are numpy, bit-identical to the JAX package's
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ChromaScaling
from ..csputils import ChromaLocation


def catmullrom_weights(t: float) -> tuple[float, float, float, float]:
    """code_CatmullRom_weights (Source/Shaders.cpp:66-72) for taps at
    offsets (-1, 0, 1, 2) from the base texel."""
    t2, t3 = t * t, t * t * t
    w0 = t2 - (t3 + t) / 2
    w1 = t3 * 1.5 + 1 - t2 * 2.5
    w2 = t2 * 2 + t / 2 - t3 * 1.5
    w3 = (t3 - t2) / 2
    return (w0, w1, w2, w3)


# Per-phase 1D stencils: {phase: (offsets, weights)}
PhaseTaps = dict[int, tuple[tuple[int, ...], tuple[float, ...]]]


def _phase_taps_420(method: ChromaScaling, loc: ChromaLocation, axis: str) -> PhaseTaps:
    """Stencils for one axis of the 2x 420 upsample, per output parity."""
    if method == ChromaScaling.NEAREST:
        return {0: ((0,), (1.0,)), 1: ((0,), (1.0,))}

    # chroma-position offsets in *chroma texel* units added to the base
    # sampling position (derived from strChromaPos / strChromaPos2,
    # Source/Shaders.cpp:118-137). Base (no siting) sampling position for
    # luma pixel 2k+p is k + (2p-1)/4 relative to chroma texel k.
    # With texel centers at +0.5, luma pixel 2k+p maps to chroma position
    # k + (2p-1)/4 before siting; the shifts below are the HLSL offsets
    # converted to chroma-texel units:  MPEG-2 "+float2(dx*0.5,0)" -> +1/4
    # horizontally; co-sited also +1/4 vertically; MPEG-1 (center) none.
    # Cross-checked against strChromaPos2 in the Catmull-Rom path: e.g.
    # MPEG-2 frac values {1/4, 3/4} + (-1/4, -1/2) == {0, 1/2} horizontally
    # and {-1/4, +1/4} vertically — identical to (2p-1)/4 + shift.
    if loc == ChromaLocation.COSITED:
        shift_x, shift_y = 0.25, 0.25
    elif loc == ChromaLocation.MPEG1:
        shift_x, shift_y = 0.0, 0.0
    else:  # MPEG2 (default)
        shift_x, shift_y = 0.25, 0.0
    shift = shift_x if axis == "x" else shift_y

    taps: PhaseTaps = {}
    for phase in (0, 1):
        # fractional position t of the output sample between chroma texels
        t = (-0.25 if phase == 0 else 0.25) + shift
        if method == ChromaScaling.BILINEAR:
            if t == 0.0:
                taps[phase] = ((0,), (1.0,))
            elif t > 0:
                taps[phase] = ((0, 1), (1.0 - t, t))
            else:
                taps[phase] = ((-1, 0), (-t, 1.0 + t))
        elif method == ChromaScaling.CATMULL_ROM:
            taps[phase] = ((-1, 0, 1, 2), catmullrom_weights(t))
        else:
            raise ValueError(method)
    return taps


def _phase_taps_422(method: ChromaScaling) -> PhaseTaps:
    """Horizontal stencils for 4:2:2 (chroma co-sited with even luma)."""
    if method == ChromaScaling.NEAREST:
        return {0: ((0,), (1.0,)), 1: ((0,), (1.0,))}
    if method == ChromaScaling.BILINEAR:
        return {0: ((0,), (1.0,)), 1: ((0, 1), (0.5, 0.5))}
    if method == ChromaScaling.CATMULL_ROM:
        # CATMULLROM_05: (9*(c1+c2)-(c0+c3))/16 (Source/Shaders.cpp:144-146)
        return {0: ((0,), (1.0,)),
                1: ((-1, 0, 1, 2), (-1 / 16, 9 / 16, 9 / 16, -1 / 16))}
    raise ValueError(method)


def _shift(p: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Edge-clamped shifted copy: result[i] = p[clamp(i + off)] along axis."""
    if off == 0:
        return p
    n = p.shape[axis]
    idx = torch.clamp(torch.arange(n, device=p.device) + off, 0, n - 1)
    return torch.index_select(p, axis, idx)


def _apply_stencil(p: torch.Tensor,
                   taps: tuple[tuple[int, ...], tuple[float, ...]],
                   axis: int) -> torch.Tensor:
    offs, ws = taps
    out = None
    for off, w in zip(offs, ws):
        term = _shift(p, off, axis) * float(np.float32(w))
        out = term if out is None else out + term
    return out


def _upsample2x_axis(p: torch.Tensor, taps: PhaseTaps, axis: int) -> torch.Tensor:
    """2x upsample along ``axis`` (non-negative) by computing both parity
    phases and interleaving (out[2k + phase] = stencil_phase(p)[k])."""
    ph0 = _apply_stencil(p, taps[0], axis)
    ph1 = _apply_stencil(p, taps[1], axis)
    stacked = torch.stack([ph0, ph1], dim=axis + 1)  # (..., n, 2, ...)
    new_shape = list(p.shape)
    new_shape[axis] *= 2
    return stacked.reshape(new_shape)


def upsample2x_matrix(n_in: int, taps: PhaseTaps) -> np.ndarray:
    """The 1D 2x upsample expressed as an (n_in, 2*n_in) weight matrix —
    used to *compose* chroma upsampling with the resize matrices so both run
    as one banded contraction (see pipeline._make_fused_fn).  Rows are
    edge-clamped (D3D CLAMP addressing)."""
    m = np.zeros((n_in, 2 * n_in), dtype=np.float64)
    for phase in (0, 1):
        offs, ws = taps[phase]
        for k in range(n_in):
            out_col = 2 * k + phase
            for off, w in zip(offs, ws):
                src = min(max(k + off, 0), n_in - 1)
                m[src, out_col] += w
    return m


def chroma_upsample_matrices(n_w: int, n_h: int, subsampling: int,
                             method: ChromaScaling, loc: ChromaLocation
                             ) -> tuple[np.ndarray | None, np.ndarray | None]:
    """(Ux, Uy) upsample matrices for a chroma plane of size (n_h, n_w);
    None where no upsampling happens on that axis."""
    if subsampling in (444, 400):
        return None, None
    if subsampling == 422:
        return upsample2x_matrix(n_w, _phase_taps_422(method)), None
    if subsampling == 420:
        ux = upsample2x_matrix(n_w, _phase_taps_420(method, loc, "x"))
        uy = upsample2x_matrix(n_h, _phase_taps_420(method, loc, "y"))
        return ux, uy
    raise ValueError(subsampling)


def blend_deinterlace_matrix(n: int) -> np.ndarray:
    """Blend deinterlace as an (n, n) row-filter matrix (for folding into
    the luma Y-axis resize): out[r] = (2*y[r] + y[r-1] + y[r+1]) / 4."""
    m = np.zeros((n, n), dtype=np.float64)
    for r in range(n):
        m[r, r] += 0.5
        m[min(max(r - 1, 0), n - 1), r] += 0.25
        m[min(max(r + 1, 0), n - 1), r] += 0.25
    return m


def upsample_chroma(c: torch.Tensor, subsampling: int,
                    method: ChromaScaling = ChromaScaling.BILINEAR,
                    loc: ChromaLocation = ChromaLocation.MPEG2) -> torch.Tensor:
    """Upsample a float chroma plane (or stacked planes) (..., Hc, Wc) to
    luma resolution: 2x2 for 4:2:0, 2x in W for 4:2:2."""
    if subsampling in (444, 400):
        return c
    if subsampling == 422:
        return _upsample2x_axis(c, _phase_taps_422(method), axis=c.dim() - 1)
    if subsampling == 420:
        cx = _upsample2x_axis(c, _phase_taps_420(method, loc, "x"),
                              axis=c.dim() - 1)
        return _upsample2x_axis(cx, _phase_taps_420(method, loc, "y"),
                                axis=cx.dim() - 2)
    raise ValueError(f"unsupported subsampling: {subsampling}")


def blend_deinterlace_luma(y: torch.Tensor) -> torch.Tensor:
    """Blend deinterlace of luma during conversion
    (Source/Shaders.cpp:232-237): y' = (2*y[r] + y[r-1] + y[r+1]) / 4."""
    axis = y.dim() - 2
    return (y * 2 + _shift(y, -1, axis) + _shift(y, 1, axis)) * 0.25
