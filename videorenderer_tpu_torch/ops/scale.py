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

