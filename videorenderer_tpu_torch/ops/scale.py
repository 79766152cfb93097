"""Separable resize: the host-side weight-matrix builders and the plain
application of one.

Port of the reference's resizer shader family as ``videorenderer_tpu.ops.scale``
builds it:
 - upscale ("interpolation"): Shaders/d3d11/ps_interpolation_spline4.hlsl
   (Mitchell / Catmull-Rom), ps_interpolation_lanczos2/3.hlsl
 - downscale ("convolution"): Shaders/d3d11/ps_convolution.hlsl over
   Shaders/resize/convolution_filters.hlsl
 - per-axis up-vs-down selection with the 50% threshold rule
   (ResizeShaderPass, Source/DX11VideoProcessor.cpp:3115-3199)

Every output pixel's taps and weights depend only on the sizes, so each
separable pass is an (in_size, out_size) weight matrix built here in
float64.  The builders are numpy and bit-identical to the JAX package's
(tests/test_torch_host.py); the banded CUDA kernel of
``kernels/resize.py`` applies the same matrices as per-column tap tables.
Sampling semantics (texel centres at +0.5, D3D CLAMP addressing folded onto
the edge rows, the corrected 6-tap Lanczos3 with a ``reference_bug_compat``
switch) are documented at the JAX original.

The same-size stencil form of a narrow-band square map
(:func:`band_diagonals`, :func:`stencil_resize_last_axis`,
:func:`stencil_resize_rows`) is the JAX package's, held equal to it; no path
runs it (the banded kernels take such maps).

The one-pass 2D Jinc2 upscaler (Shaders/examples/resizer_onepass_jinc2.hlsl)
is not separable: :func:`jinc2_resize` runs it as a direct 4x4-tap resample
(kernel K5 of ``kernels/jinc2.py``), planned here per axis by
:func:`jinc2_axis_tables`.  The JAX package's low-rank SVD expansion of the
same weights existed for the TPU's matrix unit and has no counterpart here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import Downscaling, Upscaling

# ---------------------------------------------------------------------------
# filter kernels (host-side, float64) — convolution_filters.hlsl
# ---------------------------------------------------------------------------


def _filter_box(x: np.ndarray) -> np.ndarray:
    return ((x >= -0.5) & (x < 0.5)).astype(np.float64)


def _filter_bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


def _filter_hamming(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    out = np.zeros_like(ax)
    nz = (ax > 0) & (ax < 1.0)
    xpi = ax[nz] * np.pi
    out[nz] = np.sin(xpi) / xpi * (0.54 + 0.46 * np.cos(xpi))
    out[ax == 0] = 1.0
    return out


def _filter_bicubic(a: float):
    def f(x: np.ndarray) -> np.ndarray:
        ax = np.abs(x)
        out = np.zeros_like(ax)
        m1 = ax < 1.0
        m2 = (ax >= 1.0) & (ax < 2.0)
        out[m1] = ((a + 2.0) * ax[m1] - (a + 3.0)) * ax[m1] * ax[m1] + 1.0
        out[m2] = (((ax[m2] - 5) * ax[m2] + 8) * ax[m2] - 4) * a
        return out
    return f


def _sinc(x: np.ndarray) -> np.ndarray:
    out = np.ones_like(x)
    nz = x != 0
    xpi = x[nz] * np.pi
    out[nz] = np.sin(xpi) / xpi
    return out


def _filter_lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    m = (x >= -3.0) & (x < 3.0)
    out[m] = _sinc(x[m]) * _sinc(x[m] / 3.0)
    return out


# {Downscaling: (filter_fn, filter_support)} — convolution_filters.hlsl
_DOWN_FILTERS = {
    Downscaling.BOX: (_filter_box, 0.5),
    Downscaling.BILINEAR: (_filter_bilinear, 1.0),
    Downscaling.HAMMING: (_filter_hamming, 1.0),
    Downscaling.BICUBIC: (_filter_bicubic(-0.5), 2.0),
    Downscaling.BICUBIC_SHARP: (_filter_bicubic(-1.5), 2.0),
    Downscaling.LANCZOS: (_filter_lanczos3, 3.0),
}


# ---------------------------------------------------------------------------
# weight-matrix builders
# ---------------------------------------------------------------------------


def _accumulate(mat: np.ndarray, taps: np.ndarray, w: np.ndarray, j: int) -> None:
    """Scatter tap weights into column j with edge clamp."""
    n_in = mat.shape[0]
    idx = np.clip(taps, 0, n_in - 1)
    np.add.at(mat[:, j], idx, w)


@functools.cache
def upscale_matrix(method: Upscaling, in_size: int, out_size: int,
                   reference_bug_compat: bool = False) -> np.ndarray:
    """(in_size, out_size) interpolation matrix for one axis.

    Implements the exact tap/weight math of the ps_interpolation_* shaders;
    each column sums to 1.
    """
    mat = np.zeros((in_size, out_size), dtype=np.float64)
    for j in range(out_size):
        pos = (j + 0.5) * in_size / out_size - 0.5
        t = pos - math.floor(pos)
        base = int(math.floor(pos))

        if method == Upscaling.NEAREST:
            # point sampling: texel floor((j+0.5)*in/out)
            _accumulate(mat, np.array([int((j + 0.5) * in_size / out_size)]),
                        np.array([1.0]), j)
            continue

        if method in (Upscaling.MITCHELL, Upscaling.CATMULL_ROM):
            t2, t3 = t * t, t * t * t
            if method == Upscaling.MITCHELL:
                # ps_interpolation_spline4.hlsl METHOD==0
                w = (np.array([1., 16., 1., 0.]) / 18.
                     + np.array([-.5, 0., .5, 0.]) * t
                     + np.array([5., -12., 9., -2.]) / 6. * t2
                     + np.array([-7., 21., -21., 7.]) / 18. * t3)
            else:
                # ps_interpolation_spline4.hlsl METHOD==1
                w = (np.array([-.5, 0., .5, 0.]) * t
                     + np.array([1., -2.5, 2., -.5]) * t2
                     + np.array([-.5, 1.5, -1.5, .5]) * t3)
                w[1] += 1.0
            _accumulate(mat, base + np.arange(-1, 3), w, j)
        elif method == Upscaling.LANCZOS2:
            # ps_interpolation_lanczos2.hlsl
            if t == 0.0:
                _accumulate(mat, np.array([base]), np.array([1.0]), j)
                continue
            wset = np.array([1 + t, t, 1 - t, 2 - t]) * np.pi
            w = np.sin(wset) * np.sin(wset * 0.5) / (wset * wset * 0.5)
            wc = 1.0 - w.sum()
            w[1] += wc * (1.0 - t)
            w[2] += wc * t
            _accumulate(mat, base + np.arange(-1, 3), w, j)
        elif method == Upscaling.LANCZOS3:
            # ps_interpolation_lanczos3.hlsl (corrected taps; see module doc)
            if t == 0.0:
                _accumulate(mat, np.array([base]), np.array([1.0]), j)
                continue
            wset0 = (np.array([2., 1., 0.]) + t) * np.pi
            wset1 = (np.array([1., 2., 3.]) - t) * np.pi
            w0 = np.sin(wset0) * np.sin(wset0 * .5) / (wset0 * wset0 * .5)
            w1 = np.sin(wset1) * np.sin(wset1 * .5) / (wset1 * wset1 * .5)
            wc = 1.0 - (w0.sum() + w1.sum())
            w0[2] += wc * (1.0 - t)
            w1[0] += wc * t
            if reference_bug_compat:
                taps = base + np.array([-2, -2, 0, 1, 2, 3])
            else:
                taps = base + np.arange(-2, 4)
            _accumulate(mat, taps, np.concatenate([w0, w1]), j)
        else:
            raise ValueError(f"not a separable upscale method: {method!r}")
    return mat


@functools.cache
def downscale_matrix(method: Downscaling, in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) convolution matrix for one axis
    (ps_convolution.hlsl:28-43 semantics)."""
    filt, support0 = _DOWN_FILTERS[method]
    scale = in_size / out_size
    support = support0 * scale
    ss = 1.0 / scale
    mat = np.zeros((in_size, out_size), dtype=np.float64)
    for j in range(out_size):
        # evaluation order matches the HLSL (Tex*wh + 0.5) so boundary taps of
        # discontinuous filters (box) fall on the same side
        pos = (j + 0.5) / out_size * in_size + 0.5
        low = int(math.floor(pos - support))
        high = int(math.ceil(pos + support))
        n = np.arange(low, high)
        w = filt((n - pos + 0.5) * ss)
        s = w.sum()
        if s == 0.0:
            w = np.zeros_like(w)
            w[len(w) // 2] = 1.0
        else:
            w = w / s
        _accumulate(mat, n, w, j)
    return mat



def resize_axis(x: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply an (in, out) float32 weight matrix, on ``x``'s device, along
    ``axis`` of a float tensor as one dense matrix product (the plain
    version of the banded kernels; TF32 stays off so the product keeps
    float32 rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(moved @ mat, -1, axis)


def select_scaler(in_size: int, out_size: int, upscaling: Upscaling,
                  downscaling: Downscaling, interpolate_at_50pct: bool):
    """Per-axis filter choice (ResizeShaderPass,
    Source/DX11VideoProcessor.cpp:3120-3139): no-op if equal; the
    *downscale* filter only when in > k*out (k=2 with the 50% rule, else 1);
    the upscale interpolation filter otherwise."""
    if in_size == out_size:
        return None
    k = 2 if interpolate_at_50pct else 1
    if in_size > k * out_size:
        return ("down", downscaling)
    return ("up", upscaling)


def build_axis_matrix(choice, in_size: int, out_size: int) -> np.ndarray | None:
    if choice is None:
        return None
    kind, method = choice
    if kind == "down":
        return downscale_matrix(method, in_size, out_size)
    return upscale_matrix(method, in_size, out_size)


def jinc2_passes(in_h: int, in_w: int, out_h: int, out_w: int,
                 interpolate_at_50pct: bool):
    """Per-axis pass roles when the upscaler is Jinc2, mirroring
    ResizeShaderPass's selection (Source/DX11VideoProcessor.cpp:3120-3139):
    returns (x_role, y_role), each None (no-op), "up" (the 2D Jinc2 shader
    handles this axis) or "down" (separable convolution pass)."""
    k = 2 if interpolate_at_50pct else 1

    def role(i, o):
        if i == o:
            return None
        return "down" if i > k * o else "up"

    return role(in_w, out_w), role(in_h, out_h)


def jinc2_route(in_h: int, in_w: int, out_h: int, out_w: int,
                interpolate_at_50pct: bool) -> str | None:
    """How a Jinc2-upscaled resize runs: "one_pass" when one 2D Jinc2 pass
    covers both axes (W up, H up or unchanged), "mixed" when an up axis and
    a down or unchanged axis take separate passes, None when no axis is up
    (every pass is a separable axis matrix)."""
    rx, ry = jinc2_passes(in_h, in_w, out_h, out_w, interpolate_at_50pct)
    if "up" not in (rx, ry):
        return None
    return "one_pass" if rx == "up" and ry in ("up", None) else "mixed"


def _axis_tensor(mat: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(mat, np.float32)).to(device)


def resize_plane(x: torch.Tensor, out_h: int, out_w: int,
                 upscaling: Upscaling = Upscaling.CATMULL_ROM,
                 downscaling: Downscaling = Downscaling.HAMMING,
                 interpolate_at_50pct: bool = True) -> torch.Tensor:
    """Two-pass resize of float (..., H, W) to (..., out_h, out_w) with the
    reference's per-axis up/down selection, X pass first, then Y (the
    intermediate-texture order of ResizeShaderPass).  A Jinc2-upscaled
    axis runs the one-pass 2D shader (:func:`jinc2_resize`); a mixed down
    axis gets its own separable convolution pass."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x

    if upscaling == Upscaling.JINC2:
        route = jinc2_route(h, w, out_h, out_w, interpolate_at_50pct)
        if route == "one_pass":
            return jinc2_resize(x, out_h, out_w)
        if route == "mixed":
            rx, ry = jinc2_passes(h, w, out_h, out_w, interpolate_at_50pct)
            if rx is not None:
                x = (jinc2_resize(x, h, out_w) if rx == "up" else resize_axis(
                    x, _axis_tensor(downscale_matrix(downscaling, w, out_w),
                                    x.device), -1))
            if ry is not None:
                x = (jinc2_resize(x, out_h, out_w) if ry == "up" else
                     resize_axis(x, _axis_tensor(
                         downscale_matrix(downscaling, h, out_h), x.device),
                         -2))
            return x

    cx = select_scaler(w, out_w, upscaling, downscaling, interpolate_at_50pct)
    cy = select_scaler(h, out_h, upscaling, downscaling, interpolate_at_50pct)
    mx = build_axis_matrix(cx, w, out_w)
    my = build_axis_matrix(cy, h, out_h)
    if mx is not None:
        x = resize_axis(x, _axis_tensor(mx, x.device), -1)
    if my is not None:
        x = resize_axis(x, _axis_tensor(my, x.device), -2)
    return x


# ---------------------------------------------------------------------------
# diagonal-band stencils: same-size narrow-band maps as shifted products
# ---------------------------------------------------------------------------


def band_diagonals(mat: np.ndarray, max_band: int = 16) -> dict | None:
    """For a square matrix whose nonzeros hug the diagonal, {offset d:
    weight vector w_d} with ``w_d[j] = mat[j + d, j]``; None where the band
    is wider than ``max_band`` or the matrix is not square.  The JAX
    package's same-size stencil form of a map like the composed chroma
    upsample x resize at net scale 1; the port's paths run such maps
    through the banded kernels instead."""
    n, m = mat.shape
    if n != m:
        return None
    nz_r, nz_c = np.nonzero(mat)
    if len(nz_r) == 0:
        return None
    d = nz_r - nz_c
    if d.max() - d.min() + 1 > max_band:
        return None
    diags = {}
    for off in range(int(d.min()), int(d.max()) + 1):
        w = np.zeros(m, mat.dtype)
        idx = np.arange(max(0, -off), min(m, n - off))
        w[idx] = mat[idx + off, idx]
        if np.any(w):
            diags[off] = w
    return diags


def _shifted(xf: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """``xf`` moved by ``off`` along ``axis`` (-1 or -2): element j holds
    x[j + off], zero past the edge."""
    n = xf.shape[axis]
    out = torch.zeros_like(xf)
    if off >= 0:
        out.narrow(axis, 0, n - off).copy_(xf.narrow(axis, off, n - off))
    else:
        out.narrow(axis, -off, n + off).copy_(xf.narrow(axis, 0, n + off))
    return out


def stencil_resize_last_axis(x: torch.Tensor, diags: dict,
                             dtype=torch.float32) -> torch.Tensor:
    """``out[..., j] = sum_d x[..., j + d] * w_d[j]`` (zero beyond the
    edge: the matrix already folded the clamp into its edge weights), the
    terms summed in the order of ``diags``."""
    xf = x.to(dtype)
    out = None
    for off, w in diags.items():
        term = _shifted(xf, off, -1) * torch.from_numpy(
            np.asarray(w)).to(dtype=dtype, device=x.device)
        out = term if out is None else out + term
    return out


def stencil_resize_rows(x: torch.Tensor, diags: dict,
                        dtype=torch.float32) -> torch.Tensor:
    """The row-axis (-2) form of :func:`stencil_resize_last_axis`."""
    xf = x.to(dtype)
    out = None
    for off, w in diags.items():
        wv = torch.from_numpy(np.asarray(w)).to(dtype=dtype,
                                                device=x.device)[:, None]
        term = _shifted(xf, off, -2) * wv
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Jinc2 (one-pass 2D, non-separable) with anti-ringing: host planning
# ---------------------------------------------------------------------------

_JINC2_WINDOW_SINC = 0.416
_JINC2_SINC = 0.985
_JINC2_AR_STRENGTH = 0.8


@functools.cache
def _jinc2_tap_data(in_size: int, out_size: int):
    """Per-output-axis base indices and fractional offsets (static)."""
    j = np.arange(out_size)
    tex = (j + 0.5) * in_size / out_size  # texel-space coordinate of center
    base = np.floor(tex - 0.5).astype(np.int64)  # tc = floor(tex-0.5)+0.5
    frac = (tex - 0.5) - base                    # pc - tc in [0,1)
    return base, frac


def _phase_period(in_size: int, out_size: int) -> tuple[int, int]:
    """(q, p): output positions repeat with period q while input steps by p
    (q = out/gcd, p = in/gcd)."""
    g = math.gcd(in_size, out_size)
    return out_size // g, in_size // g


def _jinc2_g(d2: np.ndarray) -> np.ndarray:
    """The Jinc2 weight as a function of the squared distance d2 (float64):
    sin(d*wa)*sin(d*wb)/d^2, wa*wb at 0."""
    wa = _JINC2_WINDOW_SINC * np.pi
    wb = _JINC2_SINC * np.pi
    d2 = np.asarray(d2, np.float64)
    d = np.sqrt(d2)
    return np.where(d2 == 0.0, wa * wb,
                    np.sin(d * wa) * np.sin(d * wb)
                    / np.where(d2 == 0.0, 1.0, d2))


@functools.cache
def jinc2_axis_tables(in_size: int, out_size: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """One axis of the 4x4-tap Jinc2 resample: ``base`` (out,) int32, the
    source index of tap 1 (taps sit at base-1 .. base+2, clamped to the
    plane on use), and ``d2`` (4, out) float32, the squared distance
    (frac - (o - 1))**2 of output j to tap o.  The 2D weight of tap
    (jo, io) is ``g(d2y[jo] + d2x[io])``, summed in float32 as the JAX
    package's direct gather (``_jinc2_gather``) does.  Read-only arrays:
    the cache hands the same ones to every caller."""
    base, frac = _jinc2_tap_data(in_size, out_size)
    offs = np.arange(-1, 3)
    d2 = np.ascontiguousarray(((frac[:, None] - offs[None, :]) ** 2).T,
                              np.float32)
    base = base.astype(np.int32)
    base.flags.writeable = False
    d2.flags.writeable = False
    return base, d2


def jinc2_resize(x: torch.Tensor, out_h: int, out_w: int,
                 epilogue=None) -> torch.Tensor:
    """One-pass 2D Jinc2 resample with anti-ringing of float32 (..., H, W)
    to (..., out_h, out_w) (Shaders/examples/resizer_onepass_jinc2.hlsl):
    weights ``sin(d*wa)*sin(d*wb)/d^2`` over the 4x4 texel neighbourhood,
    normalised by their sum; anti-ringing lerps 0.8 of the way toward the
    clamp to the centre 2x2 min/max.  ``epilogue``: an optional
    ``kernels.jinc2.Jinc2Epilogue`` (dither or rounding).

    Kernel K5 for a CUDA tensor, its plain version for a CPU tensor, as the
    JAX package takes its Pallas kernel whenever the backend is the TPU."""
    from ..kernels import jinc2 as jk
    return jk.jinc2_resize_fused(x, out_h, out_w, epilogue=epilogue)
