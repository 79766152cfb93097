"""The steps the reference chains share (``reference/<chain>.py``), in
torch, float64 by default, on whole planes with no tap tables, no
intermediate codes and no kernel: the P010 normalisation, the 4:2:0
chroma upsample at MPEG-2 siting, the PQ curves, the resize of each axis
(``scale.axis_matrix``), the PQ -> SDR tail (Shaders.cpp:861-884) and the
32 x 32 ordered dither.

``dtype`` and ``tf32`` make the control: the same chain in float32 with
the operands of every matrix product rounded to TF32's ten mantissa bits,
as tensor cores round them.  The float64 chain sets TF32 aside: its
products run in float64.

A chain returns (3, out_h, out_w) int64 codes, floor(clip(x) * (2**bits -
1) + d) with d the dither threshold of the output pixel.  Imports nothing
of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import colour, scale

_PQ_M1, _PQ_M2 = 2610 / 16384, 2523 / 4096 * 128
_PQ_C1, _PQ_C2, _PQ_C3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest, ties to even, at ten explicit
    mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


class Arith:
    """The precision of one evaluation: its dtype, and whether matrix
    products take TF32 operands."""

    def __init__(self, dtype: torch.dtype = torch.float64,
                 tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype, self.tf32 = dtype, tf32

    def const(self, a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=device) \
            .to(self.dtype)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.einsum(eq, a, b)


def upsample_420(c: torch.Tensor) -> torch.Tensor:
    """(h, w) chroma -> (2h, 2w), MPEG-2 siting: along W the even outputs
    on a texel and the odd ones halfway to the next; along H the rows at
    1/4 and 3/4 between neighbours; the edge texels repeated."""
    cn = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    hx = torch.stack([c, 0.5 * (c + cn)], dim=-1).reshape(c.shape[0], -1)
    up = torch.cat([hx[:1], hx[:-1]], dim=0)
    dn = torch.cat([hx[1:], hx[-1:]], dim=0)
    out = torch.stack([0.25 * up + 0.75 * hx, 0.75 * hx + 0.25 * dn], dim=1)
    return out.reshape(2 * hx.shape[0], hx.shape[1])


def normalised(y, u, v, ar: Arith) -> torch.Tensor:
    """(3, H, W) Y, Cb, Cr: P010's codes over 2**16 - 1, chroma upsampled."""
    n = 1.0 / 65535.0
    return torch.stack([y.to(ar.dtype) * n, upsample_420(u.to(ar.dtype) * n),
                        upsample_420(v.to(ar.dtype) * n)])


def pq_eotf(x: torch.Tensor) -> torch.Tensor:
    """ST 2084 EOTF, 10000 nits = 1 (the denominator held above 1e-6)."""
    p = torch.pow(torch.clamp(x, min=0.0), 1 / _PQ_M2)
    return torch.pow(torch.clamp(p - _PQ_C1, min=0.0)
                     / torch.clamp(_PQ_C2 - _PQ_C3 * p, min=1e-6), 1 / _PQ_M1)


def pq_oetf(y: torch.Tensor) -> torch.Tensor:
    """ST 2084 inverse EOTF, 10000 nits = 1."""
    q = torch.pow(torch.clamp(y, min=0.0), _PQ_M1)
    return torch.pow((_PQ_C1 + _PQ_C2 * q) / (1.0 + _PQ_C3 * q), _PQ_M2)


def resize(rgb: torch.Tensor, out_w: int, out_h: int, name: str,
            ar: Arith) -> torch.Tensor:
    h, w = rgb.shape[-2:]
    if w != out_w:
        mx = ar.const(scale.axis_matrix(name, w, out_w), rgb.device)
        rgb = ar.einsum("chw,wx->chx", rgb, mx)
    if h != out_h:
        my = ar.const(scale.axis_matrix(name, h, out_h), rgb.device)
        rgb = ar.einsum("chw,hy->cyw", rgb, my)
    return rgb


def pq_to_sdr(x: torch.Tensor, sdr_nits: float, ar: Arith) -> torch.Tensor:
    """PQ signal -> linear light at SDR white ``sdr_nits`` -> Hable, white
    4.8 -> BT.2020 -> BT.709 -> 2.2 gamma."""
    x = pq_eotf(torch.clamp(x, 0.0, 1.0)) * (10000.0 / sdr_nits)

    def hable(q):
        a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((q * (a * q + c * b) + d * e) / (q * (a * q + b) + d * f)
                - e / f)

    x = hable(x) / hable(torch.tensor(4.8, dtype=ar.dtype))
    x = ar.einsum("ij,jhw->ihw",
                  ar.const(colour.gamut("BT_2020", "BT_709"), x.device), x)
    return torch.pow(torch.clamp(x, 0.0, 1.0), 1 / 2.2)


def dither_codes(x: torch.Tensor, bits: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    q = 2.0 ** bits - 1.0
    d = np.tile(colour.bayer(32), ((h + 31) // 32, (w + 31) // 32))[:h, :w]
    d = torch.as_tensor(d, dtype=x.dtype, device=x.device)
    return torch.floor(torch.clamp(x, 0.0, 1.0) * q + d).to(torch.int64)


def sdr_params(config: dict) -> dict:
    """The parameters of a chain from P010 PQ BT.2020 to a whole 10-bit
    SDR surface, read from the configuration's own settings; a setting
    such a chain does not implement raises."""
    s, src, out = config["settings"], config["video_source"], config["output"]
    want = {"chroma_scaling": "BILINEAR", "convert_to_sdr": True,
            "use_dither": True}
    for k, v in want.items():
        if s.get(k) != v:
            raise ValueError(f"the reference runs {k}={v}, not {s.get(k)}")
    if (src["format"], src["transfer"], src["primaries"]) != \
            ("P010", "PQ", "BT_2020") or out["bits"] != 10 or \
            out.get("video_rect") is not None:
        raise ValueError("the reference runs P010 PQ BT.2020 sources to a "
                         "whole 10-bit surface")
    return {"matrix": src.get("matrix"), "levels": src.get("levels"),
            "filter": s["upscaling"], "out_w": int(out["width"]),
            "out_h": int(out["height"]),
            "sdr_nits": float(s["sdr_display_nits"]), "bits": int(out["bits"])}
