"""Colour constants of the reference, worked out here from their published
definitions (float64, numpy).

- :func:`yuv_to_rgb` is the YCbCr -> RGB matrix of a luma weighting at TV
  levels for codes normalised by 2**16 - 1, the P010 container's full
  scale (mpv's mp_get_csp_matrix, as MPC Video Renderer's csputils.cpp
  builds it: the level expansion scaled by (1 << bits) / (2**bits - 1) *
  255 / 256).
- :func:`gamut` is the RGB -> RGB matrix between two sets of primaries
  through CIE XYZ, no chromatic adaptation (both D65 here).
- :func:`bayer` is the recursive ordered-dither matrix, values in [0, 1).
- :data:`DOVI_LMS2RGB` is Dolby Vision's LMS -> RGB matrix
  (MPC Video Renderer, Shaders.cpp's DoVi post-matrix chain).
"""

from __future__ import annotations

import numpy as np

# luma weights (Kr, Kg, Kb) by matrix name (ITU-R BT.709, BT.2020)
LUMA = {"BT_709": (0.2126, 0.7152, 0.0722),
        "BT_2020_NC": (0.2627, 0.6780, 0.0593)}

# (x, y) chromaticities of R, G, B and the white point (D65 as mpv's
# csputils gives it, which MPC Video Renderer's csputils.cpp copies)
_D65 = (0.31271, 0.32902)
PRIMARIES = {"BT_709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
             "BT_2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _D65)}

DOVI_LMS2RGB = np.array([
    [3.06441879, -2.16597676, 0.10155818],
    [-0.65612108, 1.78554118, -0.12943749],
    [0.01736321, -0.04725154, 1.03004253],
])


def yuv_to_rgb(matrix: str, levels: str, bits: int = 16
               ) -> tuple[np.ndarray, np.ndarray]:
    """(m, c): RGB = m @ (Y, Cb, Cr) + c for codes / (2**bits - 1)."""
    if levels != "TV":
        raise ValueError(f"the reference knows TV levels only, not {levels}")
    kr, kg, kb = LUMA[matrix]
    m = np.array([[1.0, 0.0, 2 * (1 - kr)],
                  [1.0, -2 * (1 - kb) * kb / kg, -2 * (1 - kr) * kr / kg],
                  [1.0, 2 * (1 - kb), 0.0]])
    s = (1 << bits) / ((1 << bits) - 1.0) * 255 / 256 / 255
    ymin, ymax, cmax, cmid = 16 * s, 235 * s, 240 * s, 128 * s
    m[:, 0] *= 1.0 / (ymax - ymin)
    m[:, 1:] *= 1.0 / (cmax - cmid) / 2
    c = -m[:, 0] * ymin - (m[:, 1] + m[:, 2]) * cmid
    return m, c


def _rgb_to_xyz(name: str) -> np.ndarray:
    (rx, ry), (gx, gy), (bx, by), (wx, wy) = PRIMARIES[name]
    x = np.array([rx / ry, gx / gy, bx / by])
    z = np.array([(1 - rx - ry) / ry, (1 - gx - gy) / gy, (1 - bx - by) / by])
    white = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
    s = np.linalg.solve(np.stack([x, np.ones(3), z]), white)
    return np.stack([s * x, s, s * z])


def gamut(src: str, dst: str) -> np.ndarray:
    """RGB in ``src`` primaries -> RGB in ``dst`` primaries."""
    return np.linalg.solve(_rgb_to_xyz(dst), _rgb_to_xyz(src))


def bayer(n: int = 32) -> np.ndarray:
    """The n x n recursive Bayer matrix, (m + 0.5) / n**2."""
    m = np.zeros((1, 1), np.int64)
    while m.shape[0] < n:
        m = np.block([[4 * m, 4 * m + 2], [4 * m + 3, 4 * m + 1]])
    return (m + 0.5) / (n * n)
