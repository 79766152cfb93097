"""Resize matrices of the reference: one (n_in, n_out) float64 matrix per
axis, each column an output's weights over the input texels (numpy).

The interpolation filters of MPC Video Renderer's resizer shaders, sampled
at texel centres ((j + 0.5) * n_in / n_out - 0.5), with the edge texels
repeated (D3D CLAMP addressing):

- ``LANCZOS3``: six taps, base - 2 .. base + 3, windowed sinc weights whose
  deficit from 1 is shared by the two centre taps (ps_interpolation_lanczos3
  with its taps in order); one tap where the position falls on a texel.
- ``CATMULL_ROM``: four taps, the spline of ps_interpolation_spline4.

A shrink of more than 2:1 would take the convolution filters, which no
configuration of the benchmark uses yet, so the reference refuses it.

:func:`chroma_w` and :func:`chroma_h` are the 4:2:0 chroma upsample of
MPEG-2 siting as matrices (even outputs on a texel, odd ones halfway; rows
at 1/4 and 3/4), for the cost model; the reference applies the same
weights elementwise (``oracle.upsample_420``).
"""

from __future__ import annotations

import numpy as np


def _weights(name: str, t: np.ndarray) -> tuple[np.ndarray, int]:
    """(weights (n, taps), the first tap's offset from base)."""
    if name == "CATMULL_ROM":
        t2, t3 = t * t, t * t * t
        w = (np.outer(t, [-.5, 0., .5, 0.]) + np.outer(t2, [1., -2.5, 2., -.5])
             + np.outer(t3, [-.5, 1.5, -1.5, .5]))
        w[:, 1] += 1.0
        return w, -1
    if name == "LANCZOS3":
        with np.errstate(invalid="ignore", divide="ignore"):
            a = (np.array([2., 1., 0.]) + t[:, None]) * np.pi
            b = (np.array([1., 2., 3.]) - t[:, None]) * np.pi
            w0 = np.sin(a) * np.sin(a * .5) / (a * a * .5)
            w1 = np.sin(b) * np.sin(b * .5) / (b * b * .5)
        deficit = 1.0 - (w0.sum(1) + w1.sum(1))
        w0[:, 2] += deficit * (1.0 - t)
        w1[:, 0] += deficit * t
        w = np.concatenate([w0, w1], 1)
        # on a texel: the texel alone
        w[t == 0.0] = [0., 0., 1., 0., 0., 0.]
        return w, -2
    raise ValueError(f"the reference has no interpolation filter {name!r}")


def axis_matrix(name: str, n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) resize matrix of one axis; the identity where
    n_in == n_out."""
    if n_in == n_out:
        return np.eye(n_in)
    if n_in > 2 * n_out:
        raise ValueError(f"{n_in} -> {n_out} shrinks by more than 2:1, which "
                         "takes a convolution filter the reference lacks")
    j = np.arange(n_out)
    pos = (j + 0.5) * n_in / n_out - 0.5
    base = np.floor(pos)
    w, first = _weights(name, pos - base)
    taps = np.clip(base[:, None].astype(np.int64) + first
                   + np.arange(w.shape[1]), 0, n_in - 1)
    mat = np.zeros((n_in, n_out))
    np.add.at(mat, (taps, np.broadcast_to(j[:, None], taps.shape)), w)
    return mat


def chroma_w(n_in: int) -> np.ndarray:
    """(n_in, 2 n_in): even outputs on texel k, odd ones the mean of k and
    k + 1 (the last repeats its texel)."""
    mat = np.zeros((n_in, 2 * n_in))
    k = np.arange(n_in)
    mat[k, 2 * k] = 1.0
    np.add.at(mat, (k, 2 * k + 1), 0.5)
    np.add.at(mat, (np.minimum(k + 1, n_in - 1), 2 * k + 1), 0.5)
    return mat


def chroma_h(n_in: int) -> np.ndarray:
    """(n_in, 2 n_in): output 2k = 1/4 of row k - 1 + 3/4 of row k, output
    2k + 1 = 3/4 of row k + 1/4 of row k + 1, edge rows repeated."""
    mat = np.zeros((n_in, 2 * n_in))
    k = np.arange(n_in)
    np.add.at(mat, (np.maximum(k - 1, 0), 2 * k), 0.25)
    np.add.at(mat, (k, 2 * k), 0.75)
    np.add.at(mat, (k, 2 * k + 1), 0.75)
    np.add.at(mat, (np.minimum(k + 1, n_in - 1), 2 * k + 1), 0.25)
    return mat
