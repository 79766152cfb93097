"""Quantization / dithering — the "final pass" (Shaders/d3d11/ps_final_pass.hlsl):
``floor(pixel * Q + dither) / Q`` over a tiled 32x32 ordered pattern.

Port of ``videorenderer_tpu.ops.dither``.  The reference's binary dither
texture cannot be copied, so the canonical 32x32 Bayer matrix stands in for
it (same uniform [0,1) distribution and tiling).  ``bayer_field`` is the bit
formula ``csrc/rows3_tail.cu`` evaluates per pixel from the global row and
column.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DITHER_SIZE = 32


@functools.cache
def bayer_matrix(n: int = DITHER_SIZE) -> np.ndarray:
    """Recursive Bayer ordered-dither matrix, values in [0, 1)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"size must be a power of two, got {n}")
    m = np.array([[0]], dtype=np.int64)
    size = 1
    while size < n:
        m = np.block([[4 * m + 0, 4 * m + 2],
                      [4 * m + 3, 4 * m + 1]])
        size *= 2
    return ((m.astype(np.float64) + 0.5) / (n * n)).astype(np.float32)


def _requantize(codes: torch.Tensor, q: float) -> torch.Tensor:
    """codes/q as a multiply by the float32 reciprocal (the JAX package's
    rule, which the kernel follows too); the clamp restores the exact 1.0
    endpoint (q * (1/q) rounds up)."""
    return torch.clamp(codes * float(np.float32(1.0 / q)), max=1.0)


def ordered_dither(img: torch.Tensor, bits: int,
                   row_offset: int = 0) -> torch.Tensor:
    """Ordered-dither quantization to ``bits`` (ps_final_pass.hlsl:24-28)
    over the tiled Bayer pattern.  The last two dims of ``img`` are (H, W);
    leading dims share one pattern, like the reference's one dither texture
    for R, G and B.  Local row i dithers with pattern row
    ``(i + row_offset) % 32``."""
    return ordered_dither_iota(img, bits, row0=row_offset)


def bayer_field(h: int, w: int, row0: int = 0, col0: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """The 32x32 Bayer pattern tiled to (h, w) from the bits of the row and
    column: digit b of the base-4 value is ``2*bit_b(i^j) + bit_b(i)`` with
    weight ``4**(4-b)``.  Bit-identical to tiling :func:`bayer_matrix`."""
    ii = ((torch.arange(h, device=device, dtype=torch.int32) + row0)
          & (DITHER_SIZE - 1))[:, None].expand(h, w)
    jj = ((torch.arange(w, device=device, dtype=torch.int32) + col0)
          & (DITHER_SIZE - 1))[None, :].expand(h, w)
    x = ii ^ jj
    v = torch.zeros((h, w), dtype=torch.int32, device=device)
    for b in range(5):
        digit = ((x >> b) & 1) * 2 + ((ii >> b) & 1)
        v = v + (digit << (2 * (4 - b)))
    return (v.to(torch.float32) + 0.5) / float(DITHER_SIZE * DITHER_SIZE)


def ordered_dither_iota(img: torch.Tensor, bits: int, row0: int = 0,
                        col0: int = 0) -> torch.Tensor:
    """``floor(img * Q + dither) / Q``, Q = 2**bits - 1, with the pattern
    of :func:`bayer_field` at origin (row0, col0), made on ``img``'s device
    (no host constant to upload)."""
    q = float(2 ** bits - 1)
    h, w = img.shape[-2], img.shape[-1]
    d = bayer_field(h, w, row0, col0, device=img.device).to(img.dtype)
    return _requantize(torch.floor(img * q + d), q)


def quantize(img: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-to-nearest-even quantization (the ``use_dither=False`` path)."""
    q = float(2 ** bits - 1)
    return _requantize(torch.round(img * q), q)
