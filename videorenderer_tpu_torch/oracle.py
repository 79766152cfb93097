"""Float64 references of the port's paths, in torch so they run on the card.

The same math as ``bench.py::numpy_oracle`` (the JAX package's headline
oracle), parametrised by sizes, bit depth, colour matrix, transfer and
dither depth so it also covers SDR plans such as c1 (1080p NV12 -> RGB8):

  normalise -> bilinear 4:2:0 chroma upsample (MPEG-2 siting) -> YUV->RGB
  -> per-axis upscale-filter resize (skipped where in == out) -> [PQ EOTF
  -> Hable -> BT.2020->709 -> 2.2 gamma] -> 32x32 ordered dither.

Independent of the code under test: no tap tables, no mid16 codes, no
float32.  Returns (3, out_h, out_w) float64 quantized codes / (2**bits-1).

:func:`oracle_jinc2` is the staged Jinc2 chain of c3 and c3rot: the same
convert, then a direct 4x4-tap Jinc2 with anti-ringing in float64
(Shaders/examples/resizer_onepass_jinc2.hlsl), the ordered dither, and an
optional rotation and flip of the finished frame.

:func:`oracle_deint` is one field of c5: a motion-adaptive deinterlace of
every raw plane by row indices (independent of ``ops/deinterlace``), then
the same convert and resize and the HLG -> SDR tail.
:func:`blend_packed_codes` is c5s's subtitle on such a field: the float64
blend against the quantized backbuffer codes, requantized round-half-up
(``bench_common.np_blend_packed_codes``).

:func:`oracle_dovi` is one frame of c8 (Dolby Vision): normalise, the same
bilinear chroma upsample, the reshape evaluated piece by piece (the piece
found with ``torch.searchsorted`` over the pivots), the RPU matrix, the LMS
step with the PQ formulas, then the resize and the PQ -> SDR tail; with
``video_rect``, placed into a black surface.

:func:`oracle` with ``video_rect`` renders the video at the rect's size,
dithers it from its own origin and places it into a black surface; with
``fix_bt2020_gamma`` it runs the SDR BT.2020 fix (the source's power gamma,
BT.2020 -> 709, the 2.2 gamma) in place of PQ -> SDR; with
``shader_order`` it runs the conversion at source resolution, before the
resize (the reference's shader path).  Its resize takes the downscaling
filter on an axis that shrinks by more than 2:1 (a thumbnail), as the
port's scaler choice does under the 50% rule.

:func:`oracle_gray` is a GRAY (Y8/Y16) source: the one plane through the
colour matrix's first column, the resize and the dither.

:func:`oracle_c7` is one frame of c7 (4K HDR10 passthrough to a dimmer
display): the same convert at 1:1, the PQ EOTF to nits, the BT.2390 EETF in
its linear formulation (a hue-preserving scale of RGB by the mapped over
the original BT.2020 luminance, independent of the port's m1-power
rewrite), the PQ OETF and the ordered dither; with an HDR10+ ``window``
(c7p) the ST 2094-40 guided curve in place of the EETF: the knee and the
Bernstein polynomial evaluated with float64 powers, the scene peak, the
display peak, the ratio on RGB.

:func:`oracle_dovi` with ``trims`` (c8x) runs the Dolby Vision L2 trims on
the PQ signal before PQ -> SDR; with ``hdr_out`` (c8hdr) it keeps the PQ
output for an HDR display instead: the trims in nits, then the ST 2094-10
EETF (its knee adaptation and rational spline solved in float64 here),
the PQ OETF and the dither.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import Downscaling, Upscaling
from .csputils import (CSP, CSPParams, Colorspace, Levels,
                       bt2020_to_bt709_matrix, get_csp_matrix)
from .ops.dither import bayer_matrix
from .ops.scale import downscale_matrix, upscale_matrix


def _up420_bilinear_mpeg2(c: torch.Tensor) -> torch.Tensor:
    # horizontal phases: even exact, odd avg(k, k+1); vertical (1/4, 3/4)
    cn = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    hx = torch.stack([c, 0.5 * (c + cn)], dim=-1).reshape(c.shape[0], -1)
    up = torch.cat([hx[:1], hx[:-1]], dim=0)
    dn = torch.cat([hx[1:], hx[-1:]], dim=0)
    out = torch.stack([0.25 * up + 0.75 * hx, 0.75 * hx + 0.25 * dn], dim=1)
    return out.reshape(2 * hx.shape[0], hx.shape[1])


def _convert(y, u, v, bits_in: int, matrix: CSP, levels: Levels):
    """Normalise, upsample 4:2:0 chroma bilinearly (MPEG-2 siting), apply
    the colour matrix: (3, H, W) float64."""
    f64 = torch.float64
    scale = 1.0 / (2.0 ** bits_in - 1.0)
    yf = y.to(f64) * scale
    uu = _up420_bilinear_mpeg2(u.to(f64) * scale)
    vv = _up420_bilinear_mpeg2(v.to(f64) * scale)
    cm = get_csp_matrix(CSPParams(color=Colorspace(matrix, levels),
                                  input_bits=bits_in, texture_bits=bits_in))
    m, c = cm.m.tolist(), cm.c.tolist()
    return torch.stack([m[i][0] * yf + m[i][1] * uu + m[i][2] * vv + c[i]
                        for i in range(3)])


def _dither(x: torch.Tensor, dither_bits: int) -> torch.Tensor:
    out_h, out_w = x.shape[-2], x.shape[-1]
    q = 2.0 ** dither_bits - 1.0
    pat = bayer_matrix(32).astype(np.float64)
    d = np.tile(pat, ((out_h + 31) // 32, (out_w + 31) // 32))[:out_h, :out_w]
    d = torch.from_numpy(d).to(x.device)
    return torch.floor(torch.clamp(x, 0.0, 1.0) * q + d) / q


def _place(x: torch.Tensor, out_w: int, out_h: int,
           video_rect) -> torch.Tensor:
    """(3, h, w) into a zero (3, out_h, out_w) surface at ``video_rect``."""
    if video_rect is None:
        return x
    l, t, r, b = video_rect
    out = torch.zeros((3, out_h, out_w), dtype=x.dtype, device=x.device)
    out[:, t:b, l:r] = x
    return out


_PQ_M1, _PQ_M2 = 2610 / 16384, 2523 / 4096 * 128
_PQ_C1, _PQ_C2, _PQ_C3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32


def _pq_eotf(x: torch.Tensor) -> torch.Tensor:
    """ST 2084 EOTF, 10000 nits = 1 (the denominator held above 1e-6 as the
    port's EOTF does; it binds only above x = 1)."""
    p = torch.pow(torch.clamp(x, min=0.0), 1 / _PQ_M2)
    return torch.pow(torch.clamp(p - _PQ_C1, min=0.0)
                     / torch.clamp(_PQ_C2 - _PQ_C3 * p, min=1e-6), 1 / _PQ_M1)


def _pq_oetf(y: torch.Tensor) -> torch.Tensor:
    """ST 2084 inverse EOTF, 10000 nits = 1."""
    q = torch.pow(torch.clamp(y, min=0.0), _PQ_M1)
    return torch.pow((_PQ_C1 + _PQ_C2 * q) / (1.0 + _PQ_C3 * q), _PQ_M2)


def _pq_to_sdr(rgb: torch.Tensor, sdr_nits: float) -> torch.Tensor:
    """PQ EOTF at the SDR white of ``sdr_nits``, then the SDR display."""
    x = _pq_eotf(torch.clamp(rgb, 0.0, 1.0)) * (10000.0 / sdr_nits)
    return _to_sdr_display(x)


def _axis_matrix(n_in: int, n_out: int, upscaling: Upscaling,
                 downscaling: Downscaling) -> np.ndarray:
    """An axis's float64 resize matrix: the downscaling filter where it
    shrinks by more than 2:1 (the 50% rule), else the upscale filter."""
    if n_in > 2 * n_out:
        return downscale_matrix(downscaling, n_in, n_out)
    return upscale_matrix(upscaling, n_in, n_out)


def _resize(rgb: torch.Tensor, out_w: int, out_h: int,
            upscaling: Upscaling,
            downscaling: Downscaling = Downscaling.HAMMING) -> torch.Tensor:
    """Per-axis resize of (C, H, W) float64 (:func:`_axis_matrix`),
    skipped where in == out."""
    dev = rgb.device
    h, w = rgb.shape[-2:]
    if w != out_w:
        mx = torch.from_numpy(_axis_matrix(w, out_w, upscaling,
                                           downscaling)).to(dev)
        rgb = torch.einsum("chw,wx->chx", rgb, mx)
    if h != out_h:
        my = torch.from_numpy(_axis_matrix(h, out_h, upscaling,
                                           downscaling)).to(dev)
        rgb = torch.einsum("chw,hy->cyw", rgb, my)
    return rgb


def _to_sdr_display(x: torch.Tensor) -> torch.Tensor:
    """SDR-relative linear light -> Hable (4.8 -> 1.0) -> BT.2020->709 ->
    2.2 gamma."""
    def hable(q):
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((q * (A * q + C * B) + D * E)
                / (q * (A * q + B) + D * F)) - E / F

    x = hable(x) / hable(torch.tensor(4.8, dtype=torch.float64))
    gm = torch.from_numpy(bt2020_to_bt709_matrix()).to(x.device)
    x = torch.einsum("ij,jhw->ihw", gm, x)
    return torch.pow(torch.clamp(x, 0.0, 1.0), 1 / 2.2)


def _fix_bt2020(rgb: torch.Tensor, gamma: float) -> torch.Tensor:
    """The SDR BT.2020 fix (ps_fix_bt2020.hlsl): the source's power gamma,
    BT.2020 -> 709, the 2.2 gamma."""
    x = torch.pow(torch.clamp(rgb, 0.0, 1.0), gamma)
    gm = torch.from_numpy(bt2020_to_bt709_matrix()).to(x.device)
    x = torch.einsum("ij,jhw->ihw", gm, x)
    return torch.pow(torch.clamp(x, 0.0, 1.0), 1 / 2.2)


def oracle(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           out_w: int, out_h: int, *, bits_in: int = 16,
           matrix: CSP = CSP.BT_2020_NC, levels: Levels = Levels.TV,
           pq_to_sdr: bool = True, sdr_nits: float = 125.0,
           dither_bits: int = 10,
           upscaling: Upscaling = Upscaling.LANCZOS3,
           downscaling: Downscaling = Downscaling.HAMMING,
           video_rect: tuple[int, int, int, int] | None = None,
           fix_bt2020_gamma: float | None = None,
           shader_order: bool = False) -> torch.Tensor:
    """One frame: ``y`` (H, W), ``u``/``v`` (H/2, W/2) raw planes of
    ``bits_in`` bits (16 for P010, 8 for NV12) on any device.  With
    ``video_rect`` (left, top, right, bottom) the video is rendered at the
    rect's size and placed into the black out_w x out_h surface.
    ``fix_bt2020_gamma``: the SDR BT.2020 fix with this source gamma in
    place of PQ -> SDR; ``shader_order``: the conversion (PQ -> SDR or the
    fix) before the resize, at source resolution."""
    vw, vh = ((out_w, out_h) if video_rect is None else
              (video_rect[2] - video_rect[0], video_rect[3] - video_rect[1]))

    def convert(x):
        if fix_bt2020_gamma is not None:
            return _fix_bt2020(x, fix_bt2020_gamma)
        return _pq_to_sdr(x, sdr_nits) if pq_to_sdr else x

    x = _convert(y, u, v, bits_in, matrix, levels)
    if shader_order:
        x = _resize(convert(x), vw, vh, upscaling, downscaling)
    else:
        x = convert(_resize(x, vw, vh, upscaling, downscaling))
    return _place(_dither(x, dither_bits), out_w, out_h, video_rect)


def oracle_gray(y: torch.Tensor, out_w: int, out_h: int, *,
                bits_in: int = 16, matrix: CSP = CSP.BT_709,
                levels: Levels = Levels.TV, dither_bits: int = 10,
                upscaling: Upscaling = Upscaling.LANCZOS3,
                downscaling: Downscaling = Downscaling.HAMMING
                ) -> torch.Tensor:
    """One frame of a GRAY source: ``y`` (H, W) raw codes of ``bits_in``
    bits, normalised, resized (:func:`_resize`), through the GRAY colour
    matrix's first column and offset (SetShaderConvertColorParams with
    ``gray``), ordered dither.  Returns (3, out_h, out_w) float64 codes /
    (2**dither_bits - 1)."""
    cm = get_csp_matrix(CSPParams(color=Colorspace(matrix, levels),
                                  gray=True, input_bits=bits_in,
                                  texture_bits=bits_in))
    yf = _resize(y.to(torch.float64)[None] / (2.0 ** bits_in - 1.0), out_w,
                 out_h, upscaling, downscaling)[0]
    m, c = cm.m.tolist(), cm.c.tolist()
    return _dither(torch.stack([m[i][0] * yf + c[i] for i in range(3)]),
                   dither_bits)


def _deint_f64(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
               thr: float, field: int, top_field_first: bool) -> torch.Tensor:
    """Motion-adaptive deinterlace of one raw (H, W) plane in float64 by
    row indices: the rows of the other field become cur + (bob - cur) *
    clip((|next - prev| - thr) / thr, 0, 1), bob the mean of the rows above
    and below, row 1 standing for the missing row above row 0 and row H-2
    for the missing row below the last odd row."""
    p, c, n = (x.to(torch.float64) for x in (prev, cur, nxt))
    h = c.shape[0]
    use_top = (field == 0) == top_field_first
    r = torch.arange(1 if use_top else 0, h, 2, device=c.device)
    above = torch.where(r == 0, 1, r - 1)
    below = torch.where(r < h - 1, r + 1, h - 2 if use_top else h - 1)
    ramp = torch.clamp((torch.abs(n[r] - p[r]) - thr) / thr, 0.0, 1.0)
    out = c.clone()
    out[r] = c[r] + ((c[above] + c[below]) / 2 - c[r]) * ramp
    return out


def oracle_deint(prev, cur, nxt, out_w: int, out_h: int, *, field: int = 0,
                 top_field_first: bool = True, bits_in: int = 16,
                 matrix: CSP = CSP.BT_2020_NC, levels: Levels = Levels.TV,
                 sdr_nits: float = 125.0, dither_bits: int = 8,
                 motion_threshold: float = 8.0 / 255.0) -> torch.Tensor:
    """One field of c5 (4K HLG interlaced -> 1080p SDR): ``prev``, ``cur``,
    ``nxt`` are (y, u, v) raw 4:2:0 planes of one frame each.  Every plane
    is deinterlaced at its own resolution (:func:`_deint_f64`), then the
    convert, the Lanczos3 resize, HLG -> linear with the OOTF (system gamma
    1.2 at 2000 nits), the reference's PQ round trip at 1000 nits as
    clip(x / 1000, 0, 1) * 10000 / sdr_nits, Hable, BT.2020->709, the 2.2
    gamma and the ordered dither.  Returns (3, out_h, out_w) float64 codes /
    (2**dither_bits - 1)."""
    thr = motion_threshold * (2.0 ** bits_in - 1.0)
    planes = [_deint_f64(p, c, n, thr, field, top_field_first)
              for p, c, n in zip(prev, cur, nxt)]
    rgb = _resize(_convert(*planes, bits_in, matrix, levels), out_w, out_h,
                  Upscaling.LANCZOS3)
    x = torch.clamp(rgb, 0.0, 1.0)
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    x = torch.where(x <= 0.5, x * x * 4.0, torch.exp((x - c) / a) + b)
    ys = 2000.0 * (0.2627 * x[0] + 0.6780 * x[1] + 0.0593 * x[2])
    x = x * torch.pow(torch.clamp(ys, min=1e-7), 0.2)
    x = torch.clamp(x / 1000.0, 0.0, 1.0) * (10000.0 / sdr_nits)
    return _dither(_to_sdr_display(x), dither_bits)


def blend_packed_codes(codes: torch.Tensor, ov_rgb, ov_a, x: int, y: int,
                       bits: int) -> torch.Tensor:
    """Float64 reference of ``ops.overlay.blend_in_rect_packed`` on decoded
    (3, H, W) codes / (2**bits - 1): the overlay (rgb (3, h, w), alpha
    (h, w), straight alpha) blended in float64 over the quantized
    backbuffer at (x, y), then requantized as floor(clip * maxv + 0.5) /
    maxv (bench_common.np_blend_packed_codes)."""
    maxv = float(2 ** bits - 1)
    ov_rgb = torch.as_tensor(ov_rgb, dtype=torch.float64, device=codes.device)
    ov_a = torch.as_tensor(ov_a, dtype=torch.float64, device=codes.device)
    out = codes.to(torch.float64).clone()
    h, w = ov_a.shape
    region = out[:, y:y + h, x:x + w]
    blended = ov_rgb * ov_a + region * (1.0 - ov_a)
    out[:, y:y + h, x:x + w] = torch.floor(
        torch.clamp(blended, 0.0, 1.0) * maxv + 0.5) / maxv
    return out


def _jinc2_f64(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Direct 2D Jinc2 of (C, H, W) float64: for output (r, c) the texel
    position ((r + 0.5) * H / out_h - 0.5, likewise for c), its 4x4 texel
    neighbourhood (clamped to the plane), weights
    sin(d * 0.416 pi) * sin(d * 0.985 pi) / d^2 (0.416 pi * 0.985 pi at
    d = 0) normalised by their sum, then 0.8 of the way to the clamp to the
    centre 2x2 taps' range."""
    h, w = x.shape[-2], x.shape[-1]
    dev, f64 = x.device, torch.float64
    wa, wb = 0.416 * math.pi, 0.985 * math.pi

    def axis(n_in, n_out):
        pos = (torch.arange(n_out, dtype=f64, device=dev) + 0.5) \
            * n_in / n_out - 0.5
        base = torch.floor(pos)
        return base.long(), pos - base

    by, fy = axis(h, out_h)
    bx, fx = axis(w, out_w)
    acc = wsum = None
    center = []
    for jo in range(4):
        xr = x[:, torch.clamp(by + jo - 1, 0, h - 1), :]
        for io in range(4):
            tap = xr[:, :, torch.clamp(bx + io - 1, 0, w - 1)]
            if jo in (1, 2) and io in (1, 2):
                center.append(tap)
            d2 = (fy - (jo - 1))[:, None] ** 2 + (fx - (io - 1))[None, :] ** 2
            d = torch.sqrt(d2)
            g = torch.where(d2 == 0, wa * wb, torch.sin(d * wa)
                            * torch.sin(d * wb) / torch.where(d2 == 0, 1.0, d2))
            acc = tap * g if acc is None else acc + tap * g
            wsum = g if wsum is None else wsum + g
    out = acc / wsum
    c4 = torch.stack(center)
    clamped = torch.minimum(torch.maximum(out, c4.amin(0)), c4.amax(0))
    return out + (clamped - out) * 0.8


def oracle_jinc2(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 out_w: int, out_h: int, *, bits_in: int = 8,
                 matrix: CSP = CSP.BT_709, levels: Levels = Levels.TV,
                 dither_bits: int = 8, rotation: int = 0,
                 flip: bool = False) -> torch.Tensor:
    """One frame of the staged Jinc2 chain (c3): ``y`` (H, W), ``u``/``v``
    (H/2, W/2) raw 4:2:0 planes -> (3, out_h, out_w) float64 codes /
    (2**dither_bits - 1), the dither phase from the unrotated frame, then
    a clockwise rotation by ``rotation`` degrees and, with ``flip``, a
    horizontal mirror."""
    rgb = _jinc2_f64(_convert(y, u, v, bits_in, matrix, levels), out_h, out_w)
    out = _dither(rgb, dither_bits)
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    # torch.rot90 turns counter-clockwise for positive k
    out = torch.rot90(out, -(rotation // 90), dims=(-2, -1))
    return torch.flip(out, dims=(-1,)) if flip else out


def _reshape_f64(ycc: torch.Tensor, curves: dict, structure) -> torch.Tensor:
    """The Dolby Vision reshape of (3, H, W) float64 signals, piece by
    piece: each channel's piece is the count of pivots at or below its
    clipped signal (``torch.searchsorted``), then that piece's polynomial
    c0 + c1 s + c2 s^2 or its MMR sum c + sum over orders j of the linear
    (s0, s1, s2) and cross (s0 s1, s0 s2, s1 s2, s0 s1 s2) terms to the
    power j + 1, clipped to [0, 1]."""
    f64 = torch.float64
    sig = torch.clamp(ycc, 0.0, 1.0)
    s0, s1, s2 = sig
    lin = torch.stack([s0, s1, s2])
    cross = torch.stack([s0 * s1, s0 * s2, s1 * s2, s0 * s1 * s2])
    out = []
    for c, (pieces, kinds, orders) in enumerate(structure):
        s = sig[c]
        piv = torch.as_tensor(np.asarray(curves["pivots"][c][:pieces - 1],
                                         np.float64), device=s.device)
        idx = torch.searchsorted(piv, s.contiguous(), right=True)
        vals = torch.zeros((pieces,) + s.shape, dtype=f64, device=s.device)
        for p in range(pieces):
            if kinds[p] == 0:
                c0, c1, c2 = (float(v) for v in curves["poly"][c, p])
                vals[p] = c0 + c1 * s + c2 * s * s
            else:
                acc = float(curves["mmr_const"][c, p]) + torch.zeros_like(s)
                for j in range(int(orders[p])):
                    w = np.asarray(curves["mmr_coef"][c, p, j], np.float64)
                    acc = acc + torch.einsum(
                        "k,khw->hw", torch.from_numpy(w[:3]).to(s.device),
                        lin ** (j + 1))
                    acc = acc + torch.einsum(
                        "k,khw->hw", torch.from_numpy(w[3:]).to(s.device),
                        cross ** (j + 1))
                vals[p] = acc
        out.append(torch.clamp(torch.gather(vals, 0, idx[None])[0], 0.0, 1.0))
    return torch.stack(out)


def _lms_f64(rgb: torch.Tensor, lms: np.ndarray) -> torch.Tensor:
    """PQ EOTF (10000 nits = 1), the combined LMS matrix, PQ OETF, in
    float64."""
    mixed = torch.einsum("ij,jhw->ihw",
                         torch.from_numpy(np.asarray(lms, np.float64))
                         .to(rgb.device), _pq_eotf(rgb))
    return _pq_oetf(mixed)


def oracle_dovi(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                out_w: int, out_h: int, *, curves: dict, structure,
                ycc_to_rgb: np.ndarray, ycc_offset: np.ndarray,
                lms: np.ndarray, bits_in: int = 16, sdr_nits: float = 125.0,
                dither_bits: int = 10,
                upscaling: Upscaling = Upscaling.CATMULL_ROM,
                downscaling: Downscaling = Downscaling.HAMMING,
                video_rect: tuple[int, int, int, int] | None = None,
                trims=None, hdr_out: dict | None = None) -> torch.Tensor:
    """One frame of c8 (4K P010 Dolby Vision -> 1080p SDR RGB10): ``y``
    (H, W), ``u``/``v`` (H/2, W/2) raw 4:2:0 planes; ``curves`` a scene's
    packed reshape values (the ``pack_curves`` layout) and ``structure``
    its (pieces, kinds, MMR orders) per channel; ``ycc_to_rgb`` and
    ``ycc_offset`` the RPU matrix and offset (RGB = M (ycc - offset));
    ``lms`` the combined LMS->RGB @ RGB->LMS matrix.  Normalise, upsample
    the chroma bilinearly (MPEG-2 siting), reshape, RPU matrix, the LMS
    step, resize (2:1 Catmull-Rom at c8), PQ -> SDR, ordered dither.
    Returns (3, out_h, out_w) float64 codes / (2**dither_bits - 1); with
    ``video_rect``, the video at the rect's size placed into the black
    out_w x out_h surface.  ``trims``: the L2 trims' five values
    (:func:`_trims_f64`), on the PQ signal before PQ -> SDR, or with
    ``hdr_out`` in nits.  ``hdr_out``: the HDR output of c8hdr, a dict of
    the ST 2094-10 parameters (mastering_min_nits, max_cll, max_fall,
    display_max_nits): the PQ EOTF to nits, the trims, the EETF, the PQ
    OETF in place of PQ -> SDR."""
    f64 = torch.float64
    scale = 1.0 / (2.0 ** bits_in - 1.0)
    ycc = torch.stack([y.to(f64) * scale,
                       _up420_bilinear_mpeg2(u.to(f64) * scale),
                       _up420_bilinear_mpeg2(v.to(f64) * scale)])
    ycc = _reshape_f64(ycc, curves, structure)
    m = torch.from_numpy(np.asarray(ycc_to_rgb, np.float64)).to(y.device)
    off = torch.from_numpy(np.asarray(ycc_offset, np.float64)).to(y.device)
    rgb = torch.einsum("ij,jhw->ihw", m, ycc - off[:, None, None])
    rgb = _lms_f64(rgb, lms)
    vw, vh = ((out_w, out_h) if video_rect is None else
              (video_rect[2] - video_rect[0], video_rect[3] - video_rect[1]))
    x = _resize(rgb, vw, vh, upscaling, downscaling)
    if hdr_out is not None:
        nits = _pq_eotf(x) * 10000.0
        if trims is not None:
            nits = _trims_f64(nits, trims, pq_input=False)
        x = _pq_oetf(_st2094_10_f64(nits, **hdr_out) / 10000.0)
    else:
        x = torch.clamp(x, 0.0, 1.0)
        if trims is not None:
            x = _trims_f64(x, trims, pq_input=True)
        x = _to_sdr_display(_pq_eotf(x) * (10000.0 / sdr_nits))
    return _place(_dither(x, dither_bits), out_w, out_h, video_rect)


def _bt2390_f64(rgb: torch.Tensor, max_cll: float, display_max_nits: float,
                mastering_max_nits: float) -> torch.Tensor:
    """BT2390Tonemap (ps_hdr10_tonemap.hlsl:66-117) on (3, H, W) float64
    nits: the Hermite roll-off of the PQ-coded BT.2020 luminance above the
    knee ks = 1.5 PQ(display) - 0.5 PQ(peak), applied as a scale of RGB."""
    peak = max_cll if max_cll > 10.0 else (
        mastering_max_nits if mastering_max_nits > 10.0 else 1000.0)
    if display_max_nits >= peak:
        return rgb
    f64 = torch.float64
    max_pq = _pq_oetf(torch.tensor(peak / 10000.0, dtype=f64)).item()
    target_pq = _pq_oetf(torch.tensor(display_max_nits / 10000.0,
                                      dtype=f64)).item()
    ks = max(0.0, 1.5 * target_pq - 0.5 * max_pq)
    avg = 0.2627 * rgb[0] + 0.6780 * rgb[1] + 0.0593 * rgb[2]
    e1 = _pq_oetf(avg / 10000.0)
    t = (e1 - ks) / max(1e-6, max_pq - ks)
    hermite = ((2 * t ** 3 - 3 * t ** 2 + 1) * ks
               + (t ** 3 - 2 * t ** 2 + t) * (max_pq - ks)
               + (-2 * t ** 3 + 3 * t ** 2) * target_pq)
    mapped = _pq_eotf(torch.where(e1 > ks, hermite, e1)) * 10000.0
    scale = torch.where(avg <= 1e-6, 1.0,
                        mapped / torch.clamp(avg, min=1e-6))
    return rgb * scale


def _luma_f64(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2627 * rgb[0] + 0.6780 * rgb[1] + 0.0593 * rgb[2]


def _guided_f64(rgb: torch.Tensor, display_max_nits: float, peak: float,
                window) -> torch.Tensor:
    """The ST 2094-40 guided tone map on (3, H, W) float64 nits: the BT.2020
    luminance over the scene ``peak`` through the window's curve (linear
    with slope ky / kx up to the knee, above it ky + (1 - ky) B(t) with
    B(t) = sum_k C(n, k) t^k (1 - t)^(n - k) P_k, P_0 = 0, the anchors,
    P_n = 1, t = (x - kx) / (1 - kx)), times the display peak, as a ratio
    of RGB; no change where the display is at least as bright as the peak."""
    if display_max_nits >= peak:
        return rgb
    kx, ky = float(window.knee_point_x), float(window.knee_point_y)
    ctrl = [0.0, *(float(a) for a in window.bezier_curve_anchors), 1.0]
    n = len(ctrl) - 1
    lum = _luma_f64(rgb)
    xn = lum / peak
    x = torch.clamp(xn, 0.0, 1.0)
    if window.tone_mapping_flag:
        t = torch.clamp((x - kx) / max(1.0 - kx, 1e-6), 0.0, 1.0)
        bez = sum(math.comb(n, k) * ctrl[k] * t ** k * (1.0 - t) ** (n - k)
                  for k in range(n + 1))
        below = x * (ky / max(kx, 1e-6)) if kx > 0 else torch.zeros_like(x)
        y = torch.where(x <= kx, below, ky + (1.0 - ky) * bez)
    else:
        y = x
    slope0 = ky / kx if kx > 1e-6 else 1.0
    scale = torch.where(xn <= max(kx, 1e-6),
                        slope0 * display_max_nits / peak,
                        y * display_max_nits
                        / torch.clamp(xn * peak, min=1e-9))
    return rgb * scale


def _trims_f64(x: torch.Tensor, trims, pq_input: bool) -> torch.Tensor:
    """The Dolby Vision L2 trims (DolbyVisionTrims,
    ps_hdr10_tonemap.hlsl:250-263) on (3, H, W) float64: ``trims`` the
    (chroma weight, saturation gain, slope, offset, power) values; PQ
    values in and out with ``pq_input``, else nits through the PQ curve."""
    cw, sat, slope, offset, power = (float(v) for v in trims)
    c = x if pq_input else _pq_oetf(x / 10000.0)
    c = torch.pow(torch.clamp(c * slope + offset, min=0.0), power)
    y = torch.clamp(_luma_f64(c), min=1e-9)
    c = c * torch.pow(torch.clamp((1.0 + cw) * c / y, min=0.0), sat)
    return c if pq_input else _pq_eotf(c) * 10000.0


def _st2094_10_f64(rgb: torch.Tensor, mastering_min_nits: float,
                   max_cll: float, max_fall: float,
                   display_max_nits: float) -> torch.Tensor:
    """ST209410Tonemap (ps_hdr10_tonemap.hlsl:119-189) on (3, H, W) float64
    nits: the knee between 10% and 80% of the PQ range, adapted toward the
    display's, the rational spline through (min, knee, max) solved as a
    3 x 3 system in float64, applied as a scale of RGB by the mapped over
    the BT.2020 luminance; no change where the display is at least as bright
    as MaxCLL."""
    if display_max_nits >= max_cll:
        return rgb

    def pq(nits):
        return _pq_oetf(torch.tensor(nits / 10000.0,
                                     dtype=torch.float64)).item()

    def nits_of(code):
        return _pq_eotf(torch.tensor(code, dtype=torch.float64)).item() \
            * 10000.0

    def smoothstep(e0, e1, x):
        t = min(max((x - e0) / (e1 - e0), 0.0), 1.0)
        return t * t * (3.0 - 2.0 * t)

    s_min, s_max, s_avg = pq(mastering_min_nits), pq(max_cll), pq(max_fall)
    d_min, d_max = pq(0.0), pq(display_max_nits)
    knee = s_avg if max_fall > 0.0 else s_min + (s_max - s_min) * 0.4
    knee = min(max(knee, s_min + (s_max - s_min) * 0.1),
               s_min + (s_max - s_min) * 0.8)
    target = (knee - s_min) / (s_max - s_min)
    adapted = d_min + (d_max - d_min) * target
    tuning = 1.0 - smoothstep(0.8, 0.4, target) * smoothstep(0.1, 0.4, target)
    adaptation = 0.4 + 0.6 * tuning
    d_knee = min(max(knee + (adapted - knee) * adaptation,
                     d_min + (d_max - d_min) * 0.1),
                 d_min + (d_max - d_min) * 0.8)
    xs = (mastering_min_nits, nits_of(knee), max_cll)
    ys = (0.0, nits_of(d_knee), display_max_nits)
    # y (1 + c3 x) = c1 + c2 x at the three anchors
    a = np.array([[1.0, xi, -xi * yi] for xi, yi in zip(xs, ys)])
    c1, c2, c3 = np.linalg.solve(a, np.array(ys))
    lum = _luma_f64(rgb)
    mapped = (c1 + c2 * lum) / (1.0 + c3 * lum)
    return rgb * torch.where(lum > 0.0,
                             mapped / torch.clamp(lum, min=1e-9), 1.0)


def oracle_c7(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
              max_cll: float, display_max_nits: float,
              mastering_max_nits: float = 1000.0, bits_in: int = 16,
              matrix: CSP = CSP.BT_2020_NC, levels: Levels = Levels.TV,
              dither_bits: int = 10, window=None) -> torch.Tensor:
    """One frame of c7 (4K P010 HDR10 -> the same size in PQ for a display
    of ``display_max_nits``, BT.2390 local tone map of a scene with
    ``max_cll``): ``y`` (H, W), ``u``/``v`` (H/2, W/2) raw 4:2:0 planes.
    Normalise, upsample the chroma bilinearly (MPEG-2 siting), BT.2020 NCL
    matrix, PQ EOTF to nits, the EETF, PQ OETF, ordered dither.  With an
    HDR10+ ``window`` (c7p) the guided curve of :func:`_guided_f64` with
    ``max_cll`` the scene peak in place of the EETF.  Returns (3, H, W)
    float64 codes / (2**dither_bits - 1)."""
    nits = _pq_eotf(_convert(y, u, v, bits_in, matrix, levels)) * 10000.0
    if window is not None:
        mapped = _guided_f64(nits, display_max_nits, max_cll, window)
    else:
        mapped = _bt2390_f64(nits, max_cll, display_max_nits,
                             mastering_max_nits)
    return _dither(_pq_oetf(mapped / 10000.0), dither_bits)
