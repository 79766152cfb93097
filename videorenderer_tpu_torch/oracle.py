"""Float64 reference of the main path, in torch so it runs on the card.

The same math as ``bench.py::numpy_oracle`` (the JAX package's headline
oracle), parametrised by sizes, bit depth, colour matrix, transfer and
dither depth so it also covers SDR plans such as c1 (1080p NV12 -> RGB8):

  normalise -> bilinear 4:2:0 chroma upsample (MPEG-2 siting) -> YUV->RGB
  -> per-axis upscale-filter resize (skipped where in == out) -> [PQ EOTF
  -> Hable -> BT.2020->709 -> 2.2 gamma] -> 32x32 ordered dither.

Independent of the code under test: no tap tables, no mid16 codes, no
float32.  Returns (3, out_h, out_w) float64 quantized codes / (2**bits-1).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Upscaling
from .csputils import (CSP, CSPParams, Colorspace, Levels,
                       bt2020_to_bt709_matrix, get_csp_matrix)
from .ops.dither import bayer_matrix
from .ops.scale import upscale_matrix


def _up420_bilinear_mpeg2(c: torch.Tensor) -> torch.Tensor:
    # horizontal phases: even exact, odd avg(k, k+1); vertical (1/4, 3/4)
    cn = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    hx = torch.stack([c, 0.5 * (c + cn)], dim=-1).reshape(c.shape[0], -1)
    up = torch.cat([hx[:1], hx[:-1]], dim=0)
    dn = torch.cat([hx[1:], hx[-1:]], dim=0)
    out = torch.stack([0.25 * up + 0.75 * hx, 0.75 * hx + 0.25 * dn], dim=1)
    return out.reshape(2 * hx.shape[0], hx.shape[1])


def oracle(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           out_w: int, out_h: int, *, bits_in: int = 16,
           matrix: CSP = CSP.BT_2020_NC, levels: Levels = Levels.TV,
           pq_to_sdr: bool = True, sdr_nits: float = 125.0,
           dither_bits: int = 10,
           upscaling: Upscaling = Upscaling.LANCZOS3) -> torch.Tensor:
    """One frame: ``y`` (H, W), ``u``/``v`` (H/2, W/2) raw planes of
    ``bits_in`` bits (16 for P010, 8 for NV12) on any device."""
    dev = y.device
    f64 = torch.float64
    scale = 1.0 / (2.0 ** bits_in - 1.0)
    yf = y.to(f64) * scale
    uu = _up420_bilinear_mpeg2(u.to(f64) * scale)
    vv = _up420_bilinear_mpeg2(v.to(f64) * scale)
    cm = get_csp_matrix(CSPParams(color=Colorspace(matrix, levels),
                                  input_bits=bits_in, texture_bits=bits_in))
    m, c = cm.m.tolist(), cm.c.tolist()
    rgb = torch.stack([m[i][0] * yf + m[i][1] * uu + m[i][2] * vv + c[i]
                       for i in range(3)])

    h, w = y.shape
    if w != out_w:
        mx = torch.from_numpy(upscale_matrix(upscaling, w, out_w)).to(dev)
        rgb = torch.einsum("chw,wx->chx", rgb, mx)
    if h != out_h:
        my = torch.from_numpy(upscale_matrix(upscaling, h, out_h)).to(dev)
        rgb = torch.einsum("chw,hy->cyw", rgb, my)

    x = rgb
    if pq_to_sdr:
        x = torch.clamp(rgb, 0.0, 1.0)
        m1, m2 = 2610 / 16384, 2523 / 4096 * 128
        c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
        x = torch.pow(torch.clamp(x, min=0.0), 1 / m2)
        x = torch.clamp(x - c1, min=0.0) / (c2 - c3 * x)
        x = torch.pow(x, 1 / m1) * (10000.0 / sdr_nits)

        def hable(q):
            A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
            return ((q * (A * q + C * B) + D * E)
                    / (q * (A * q + B) + D * F)) - E / F

        x = hable(x) / hable(torch.tensor(4.8, dtype=f64))
        gm = torch.from_numpy(bt2020_to_bt709_matrix()).to(dev)
        x = torch.einsum("ij,jhw->ihw", gm, x)
        x = torch.pow(torch.clamp(x, 0.0, 1.0), 1 / 2.2)

    q = 2.0 ** dither_bits - 1.0
    pat = bayer_matrix(32).astype(np.float64)
    d = np.tile(pat, ((out_h + 31) // 32, (out_w + 31) // 32))[:out_h, :out_w]
    d = torch.from_numpy(d).to(dev)
    return torch.floor(torch.clamp(x, 0.0, 1.0) * q + d) / q
