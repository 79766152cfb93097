"""HDR tone mapping on torch tensors: the Hable "Convert to SDR" curve
(Shaders/convert/hdr_tone_mapping.hlsl), the HDR10 parameter block, the
six local tone-map operators of the HDR passthrough
(Shaders/d3d11/ps_hdr10_tonemap.hlsl), the HDR10+ guided curve (selection
7, which only HDR10+ metadata selects), ICtCp and the Dolby Vision L2
trims.  Port of ``videorenderer_tpu.ops.tonemap``.

The local tone map is PQ in, PQ out.  Its per-pixel half reads five
float32 scalars derived from the HDR10 metadata (the reference's cbuffer):
:func:`local_tonemap_static_scalars` computes them on the host in float64
from a plan's :class:`HDRParams` (then rounds them to float32), and
:func:`local_tonemap_rt_scalars` in float32 from a serving call's values,
as the JAX package's two routes do.  :func:`local_tonemap_pq_from_scalars`
is the per-pixel half; ``csrc/tail.cuh`` carries the same operations, each
rounded on its own in this order.  With L2 trims on, selections 5 and 6
leave their m1-power fast paths for the general linear-domain forms (the
trims run in between), as the JAX package's do.  Scalars that enter the per-pixel math
become 0-d tensors on the pixels' device, so a division by one is a true
division on the card too (a CUDA division by a host scalar multiplies by
its reciprocal).
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import numpy as np
import torch

from .transfer import (ST2084_C1, ST2084_C2, ST2084_C3, ST2084_M1, ST2084_M2,
                       linear_to_st2084, p_to_st2084, pow_pos,
                       st2084_to_linear, st2084_to_p)

_BT2020_LUMA = (0.2627, 0.6780, 0.0593)

# image of the 1e-6-nits luma clamp in the m1-power domain:
# (1e-6 / 10000) ** M1
_P_EPS = float((1e-10) ** ST2084_M1)

# selections of ToneMapType (ps_hdr10_tonemap.hlsl:20); 7 is the HDR10+
# guided curve, which only HDR10+ metadata selects
ACES, REINHARD, HABLE, MOBIUS, BT2390, ST2094_10 = 1, 2, 3, 4, 5, 6
HDR10PLUS_GUIDED = 7

HDR_KEYS = ("mastering_min_nits", "mastering_max_nits", "max_cll",
            "max_fall", "display_max_nits")


def _hable(x: torch.Tensor) -> torch.Tensor:
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


_HABLE_DIV = ((4.8 * (0.15 * 4.8 + 0.10 * 0.50) + 0.20 * 0.02)
              / (4.8 * (0.15 * 4.8 + 0.50) + 0.20 * 0.30)) - 0.02 / 0.30


def tonemap_hable_sdr(rgb: torch.Tensor) -> torch.Tensor:
    """ToneMappingHable (hdr_tone_mapping.hlsl:1-13): Hable curve normalized
    so input 4.8 maps to 1.0."""
    return _hable(rgb) / _HABLE_DIV


@dataclass(frozen=True)
class HDRParams:
    """HDRParamsConstantBuffer (ps_hdr10_tonemap.hlsl:13-22)."""

    mastering_min_nits: float = 0.0
    mastering_max_nits: float = 1000.0
    max_cll: float = 1000.0
    max_fall: float = 400.0
    display_max_nits: float = 1000.0


# -- host scalars ---------------------------------------------------------------

def _pq_encode_scalar(nits: float) -> float:
    """Host-side (float64) LinearToST2084 of a scalar plan constant."""
    x = (max(nits, 0.0) / 10000.0) ** ST2084_M1
    return float(((ST2084_C1 + ST2084_C2 * x) / (1.0 + ST2084_C3 * x))
                 ** ST2084_M2)


def _pq_decode_scalar(pq: float) -> float:
    x = max(pq, 0.0) ** (1.0 / ST2084_M2)
    x = max(x - ST2084_C1, 0.0) / (ST2084_C2 - ST2084_C3 * x)
    return float(x ** (1.0 / ST2084_M1) * 10000.0)


def _safe_max_cll(p: HDRParams) -> float:
    return p.max_cll if p.max_cll > 10.0 else (
        p.mastering_max_nits if p.mastering_max_nits > 10.0 else 1000.0)


def _smoothstep(edge0: float, edge1: float, x: float) -> float:
    t = min(max((x - edge0) / (edge1 - edge0), 0.0), 1.0)
    return t * t * (3.0 - 2.0 * t)


def _st2094_10_coeffs(p: HDRParams) -> tuple[float, float, float]:
    """Host-side spline coefficients of the ST 2094-10 EETF — the CPU/
    cbuffer half of ps_hdr10_tonemap.hlsl:119-189 (knee adaptation + the
    rational through the (min, knee, max) anchors)."""
    pq1 = _pq_encode_scalar

    src_min = pq1(p.mastering_min_nits)
    src_max = pq1(p.max_cll)
    src_avg = pq1(p.max_fall)
    dst_min = pq1(0.0)
    dst_max = pq1(p.display_max_nits)

    min_knee, max_knee, def_knee, knee_adaptation = 0.1, 0.8, 0.4, 0.4

    def lerp(a, b, t):
        return a + (b - a) * t

    src_knee_min = lerp(src_min, src_max, min_knee)
    src_knee_max = lerp(src_min, src_max, max_knee)
    dst_knee_min = lerp(dst_min, dst_max, min_knee)
    dst_knee_max = lerp(dst_min, dst_max, max_knee)

    src_knee = src_avg if p.max_fall > 0.0 else lerp(src_min, src_max,
                                                     def_knee)
    src_knee = min(max(src_knee, src_knee_min), src_knee_max)

    target = (src_knee - src_min) / (src_max - src_min)
    adapted = lerp(dst_min, dst_max, target)
    tuning = 1.0 - (_smoothstep(max_knee, def_knee, target)
                    * _smoothstep(min_knee, def_knee, target))
    adaptation = lerp(knee_adaptation, 1.0, tuning)
    dst_knee = lerp(src_knee, adapted, adaptation)
    dst_knee = min(max(dst_knee, dst_knee_min), dst_knee_max)

    x1, x2, x3 = p.mastering_min_nits, _pq_decode_scalar(src_knee), p.max_cll
    y1, y2, y3 = 0.0, _pq_decode_scalar(dst_knee), p.display_max_nits

    m00 = x2 * x3 * (y2 - y3)
    m01 = x1 * x3 * (y3 - y1)
    m02 = x1 * x2 * (y1 - y2)
    m10 = x3 * y3 - x2 * y2
    m11 = x1 * y1 - x3 * y3
    m12 = x2 * y2 - x1 * y1
    m20 = x3 - x2
    m21 = x1 - x3
    m22 = x2 - x1
    coef0 = m00 * y1 + m01 * y2 + m02 * y3
    coef1 = m10 * y1 + m11 * y2 + m12 * y3
    coef2 = m20 * y1 + m21 * y2 + m22 * y3
    k = 1.0 / (x3 * y3 * (x1 - x2) + x2 * y2 * (x3 - x1)
               + x1 * y1 * (x2 - x3))
    return k * coef0, k * coef1, k * coef2


def local_tonemap_static_scalars(selection: int, p: HDRParams) -> np.ndarray:
    """The five scalars of :func:`local_tonemap_pq_from_scalars` for a
    plan's static metadata: float64 on the host (``_pq_encode_scalar``, as
    the JAX package's static route computes them), rounded to float32.
    Selection 5: [disp, safe MaxCLL, PQ(safe), PQ(disp), knee start]; 6:
    [disp, MaxCLL, c1, c2, c3] (zeros for c when the display is at least as
    bright as MaxCLL); 7: [disp, MaxCLL (the scene peak), 0, 0, 0]; 1-4:
    [disp, effective peak, MaxFALL gain, 0, 0]."""
    disp = float(p.display_max_nits)
    if selection == HDR10PLUS_GUIDED:
        vals = [disp, p.max_cll, 0.0, 0.0, 0.0]
    elif selection == BT2390:
        safe = _safe_max_cll(p)
        max_pq, target_pq = _pq_encode_scalar(safe), _pq_encode_scalar(disp)
        vals = [disp, safe, max_pq, target_pq,
                max(0.0, 1.5 * target_pq - 0.5 * max_pq)]
    elif selection == ST2094_10:
        coeffs = ((0.0, 0.0, 0.0) if disp >= p.max_cll
                  else _st2094_10_coeffs(p))
        vals = [disp, p.max_cll, *coeffs]
    else:
        base = max(disp, p.mastering_max_nits)
        fall_adj = min(base / p.max_fall, 1.0) if p.max_fall else 1.0
        vals = [disp, min(base, p.max_cll), fall_adj, 0.0, 0.0]
    return np.asarray(vals, np.float64).astype(np.float32)


def hdr_values(values: Mapping, name: str = "hdr") -> dict:
    """A serving call's HDR10 values (the :data:`HDR_KEYS`) as Python
    floats.  Numbers, numpy scalars and CPU tensors are taken; CUDA tensors
    are refused: reading them back would synchronise the stream on every
    scene.  An unknown key raises."""
    bad = set(values) - set(HDR_KEYS)
    if bad:
        raise ValueError(f"{name}: unknown key(s) {sorted(bad)}; the local "
                         f"tone map takes {list(HDR_KEYS)}")
    return _host_floats(values, name)


def _host_floats(values: Mapping, name: str) -> dict:
    """A serving call's values as float32-rounded Python floats; a value
    on a device is refused (reading it back would synchronise)."""
    out = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                raise TypeError(
                    f"{name}[{k!r}] lies on {v.device}: pass a scene's "
                    "values as host numbers (floats, numpy or CPU tensors), "
                    "reading a device tensor back would synchronise")
            v = v.item()
        out[k] = float(np.float32(v))
    return out


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _st2094_10_coeffs_rt(mmin, mcll, mfall, disp):
    """Float32 twin of :func:`_st2094_10_coeffs` on 0-d tensors (the JAX
    package's traced-scalar version): the serving route's knee adaptation."""
    def enc(v):
        return linear_to_st2084(v, 10000.0)

    def dec(v):
        return st2084_to_linear(v, 10000.0)

    def sstep(e0, e1v, x):
        t = torch.clamp((x - e0) / (e1v - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def lerp(a, b, t):
        return a + (b - a) * t

    zero = torch.zeros_like(disp)
    src_min, src_max = enc(mmin), enc(mcll)
    src_avg = enc(mfall)
    dst_min, dst_max = enc(zero), enc(disp)
    mk, xk, dk, ka = 0.1, 0.8, 0.4, 0.4
    skn, skx = lerp(src_min, src_max, mk), lerp(src_min, src_max, xk)
    dkn, dkx = lerp(dst_min, dst_max, mk), lerp(dst_min, dst_max, xk)
    src_knee = torch.where(mfall > 0.0, src_avg, lerp(src_min, src_max, dk))
    src_knee = torch.clamp(src_knee, skn, skx)
    target = (src_knee - src_min) / (src_max - src_min)
    adapted = lerp(dst_min, dst_max, target)
    tuning = 1.0 - sstep(xk, dk, target) * sstep(mk, dk, target)
    adaptation = lerp(ka, 1.0, tuning)
    dst_knee = torch.clamp(lerp(src_knee, adapted, adaptation), dkn, dkx)
    x1, x2, x3 = mmin, dec(src_knee), mcll
    y1, y2, y3 = zero, dec(dst_knee), disp
    m00 = x2 * x3 * (y2 - y3)
    m01 = x1 * x3 * (y3 - y1)
    m02 = x1 * x2 * (y1 - y2)
    m10 = x3 * y3 - x2 * y2
    m11 = x1 * y1 - x3 * y3
    m12 = x2 * y2 - x1 * y1
    m20, m21, m22 = x3 - x2, x1 - x3, x2 - x1
    k = 1.0 / (x3 * y3 * (x1 - x2) + x2 * y2 * (x3 - x1)
               + x1 * y1 * (x2 - x3))
    c1 = k * (m00 * y1 + m01 * y2 + m02 * y3)
    c2 = k * (m10 * y1 + m11 * y2 + m12 * y3)
    c3 = k * (m20 * y1 + m21 * y2 + m22 * y3)
    return c1, c2, c3


def local_tonemap_rt_scalars(selection: int, p: Mapping) -> np.ndarray:
    """The five scalars of :func:`local_tonemap_pq_from_scalars` for a
    serving call: ``p`` holds the five :data:`HDR_KEYS` as host numbers
    (see :func:`hdr_values`), computed in float32 on the host as the JAX
    package's ``local_tonemap_rt_scalars`` computes them per call.  The
    layout is :func:`local_tonemap_static_scalars`'."""
    v = hdr_values(p)
    missing = set(HDR_KEYS) - set(v)
    if missing:
        raise ValueError(f"hdr: missing key(s) {sorted(missing)}")
    mmin, mmax, mcll, mfall, disp = (_f32(v[k]) for k in HDR_KEYS)

    if selection == HDR10PLUS_GUIDED:
        out = [disp, mcll, _f32(0.0), _f32(0.0), _f32(0.0)]
    elif selection == BT2390:
        safe = torch.where(mcll > 10.0, mcll,
                           torch.where(mmax > 10.0, mmax, _f32(1000.0)))
        max_pq = linear_to_st2084(safe, 10000.0)
        target_pq = linear_to_st2084(disp, 10000.0)
        ks = torch.clamp(1.5 * target_pq - 0.5 * max_pq, min=0.0)
        out = [disp, safe, max_pq, target_pq, ks]
    elif selection == ST2094_10:
        out = [disp, mcll, *_st2094_10_coeffs_rt(mmin, mcll, mfall, disp)]
    else:
        base = torch.maximum(disp, mmax)
        eff = torch.minimum(base, mcll)
        fall_adj = torch.clamp(base / torch.clamp(mfall, min=1e-6), max=1.0)
        out = [disp, eff, fall_adj, _f32(0.0), _f32(0.0)]
    return torch.stack(out).numpy()


# -- the operators --------------------------------------------------------------

def _luma(rgb: torch.Tensor, axis: int) -> torch.Tensor:
    r, g, b = (rgb.narrow(axis, i, 1) for i in range(3))
    w0, w1, w2 = _BT2020_LUMA
    return w0 * r + w1 * g + w2 * b


def aces_film(x: torch.Tensor) -> torch.Tensor:
    """ACESFilmTonemap (ps_hdr10_tonemap.hlsl:33-46)."""
    A, B, C, D, E = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (A * x + B)) / (x * (C * x + D) + E)


def reinhard(x: torch.Tensor) -> torch.Tensor:
    """ReinhardTonemap (ps_hdr10_tonemap.hlsl:48-51)."""
    return x / (1.0 + x)


def habel(x: torch.Tensor) -> torch.Tensor:
    """HabelTonemap (ps_hdr10_tonemap.hlsl:53-57) — unnormalized Hable."""
    return _hable(x)


def mobius(x: torch.Tensor, display_max_nits) -> torch.Tensor:
    """MobiusTonemap (ps_hdr10_tonemap.hlsl:59-64)."""
    return x / (1.0 + x / (display_max_nits + 1e-6))


def _passthrough_pq(pq_rgb: torch.Tensor) -> torch.Tensor:
    """The display is at least as bright as the source peak: no EETF, but
    the PQ round trip through the m1-power domain still runs (both JAX
    routes keep it; dropping it moves codes)."""
    return p_to_st2084(st2084_to_p(pq_rgb))


def _bt2390_pq_p(pq_rgb: torch.Tensor, max_pq, target_pq, ks,
                 axis: int) -> torch.Tensor:
    """BT.2390 EETF on PQ-coded RGB in the m1-power domain: decode ->
    :func:`bt2390` -> encode with the per-channel EOTF/OETF round trip
    collapsed, the hue-preserving linear scale s applied as ``p * s**M1``
    where ``s**M1 = p(mapped) / p(avg)`` (12 accurate pows a pixel,
    ps_hdr10_tonemap.hlsl:66-117).  ``max_pq``/``target_pq``/``ks``: 0-d
    tensors; the caller handles the passthrough."""
    p_ch = st2084_to_p(pq_rgb)                        # 1 pow / ch
    lin = pow_pos(p_ch, 1.0 / ST2084_M1)              # 1 pow / ch
    avg = _luma(lin, axis)
    p_avg = pow_pos(avg, ST2084_M1)                   # 1 pow
    e1 = p_to_st2084(p_avg)                           # 1 pow
    t = (e1 - ks) / torch.clamp(max_pq - ks, min=1e-6)
    t2, t3 = t * t, t * t * t
    e2s = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (max_pq - ks)
           + (-2 * t3 + 3 * t2) * target_pq)
    e2 = torch.where(e1 > ks, e2s, e1)
    p_mapped = st2084_to_p(e2)                        # 1 pow
    s_m1 = torch.where(avg <= 1e-10, 1.0,
                       p_mapped / torch.clamp(p_avg, min=_P_EPS))
    return p_to_st2084(p_ch * s_m1)                   # 1 pow / ch


def _st2094_10_pq_p(pq_rgb: torch.Tensor, c1, c2, c3,
                    axis: int) -> torch.Tensor:
    """ST 2094-10 EETF (selection 6) in the m1-power domain: the rational
    spline's luma scale applied as ``s**M1`` in p.  ``c1``/``c2``/``c3``:
    the nits-domain spline coefficients (0-d tensors); the caller handles
    the passthrough.  The sign test is on nits."""
    p_ch = st2084_to_p(pq_rgb)                        # 1 pow / ch
    lin = pow_pos(p_ch, 1.0 / ST2084_M1)              # 1 pow / ch
    xn = _luma(lin, axis) * 10000.0                   # nits
    yn = (c1 + c2 * xn) / (1.0 + c3 * xn)
    scale = torch.where(xn > 0.0, yn / torch.clamp(xn, min=1e-9), 1.0)
    s_m1 = pow_pos(scale, ST2084_M1)                  # 1 pow
    return p_to_st2084(p_ch * s_m1)                   # 1 pow / ch


def _operator(selection: int, c: torch.Tensor, disp) -> torch.Tensor:
    if selection == REINHARD:
        return reinhard(c)
    if selection == HABLE:
        return habel(c)
    if selection == MOBIUS:
        return mobius(c, disp)
    return aces_film(c)          # 1 and the fallback


def bt2390(rgb: torch.Tensor, p: HDRParams, axis: int = -1) -> torch.Tensor:
    """BT2390Tonemap (ps_hdr10_tonemap.hlsl:66-117): BT.2390 EETF Hermite
    roll-off in PQ space on the BT.2020 luma average, hue-preserving scale.
    Input/output in absolute nits."""
    safe_max_cll = _safe_max_cll(p)
    if p.display_max_nits >= safe_max_cll:
        return rgb
    avg = _luma(rgb, axis)
    max_cll_pq = _pq_encode_scalar(safe_max_cll)
    target_pq = _pq_encode_scalar(p.display_max_nits)
    e1 = linear_to_st2084(avg, 10000.0)
    ks = max(0.0, 1.5 * target_pq - 0.5 * max_cll_pq)
    t = (e1 - ks) / max(1e-6, max_cll_pq - ks)
    t2 = t * t
    t3 = t2 * t
    e2_spline = ((2.0 * t3 - 3.0 * t2 + 1.0) * ks
                 + (t3 - 2.0 * t2 + t) * (max_cll_pq - ks)
                 + (-2.0 * t3 + 3.0 * t2) * target_pq)
    e2 = torch.where(e1 > ks, e2_spline, e1)
    mapped = st2084_to_linear(e2, 10000.0)
    scale = torch.where(avg <= 1e-6, 1.0, mapped / torch.clamp(avg, min=1e-6))
    return rgb * scale


def st2094_10(rgb: torch.Tensor, p: HDRParams, axis: int = -1
              ) -> torch.Tensor:
    """ST209410Tonemap (ps_hdr10_tonemap.hlsl:119-189): ST 2094-10 EETF via a
    rational spline through (min, knee, max) anchor points.  Nits in/out."""
    if p.display_max_nits >= p.max_cll:
        return rgb
    c1, c2, c3 = _st2094_10_coeffs(p)
    x_nits = _luma(rgb, axis)
    y_nits = (c1 + c2 * x_nits) / (1.0 + c3 * x_nits)
    scale = torch.where(x_nits > 0.0, y_nits / torch.clamp(x_nits, min=1e-9),
                        1.0)
    return rgb * scale




# -- ICtCp and the Dolby Vision L2 trims ----------------------------------------

@dataclass(frozen=True)
class DoviTrims:
    """DolbyConstants cbuffer (ps_hdr10_tonemap.hlsl:24-33)."""

    chroma_weight: float = 0.0
    saturation_gain: float = 1.0
    trim_slope: float = 1.0
    trim_offset: float = 0.0
    trim_power: float = 1.0
    l2_enabled: bool = False


# a serving call's "l2_trims" keys, in the order of the trims' five scalars
TRIM_KEYS = ("chroma_weight", "saturation_gain", "trim_slope", "trim_offset",
             "trim_power")


def trim_values(trims: DoviTrims) -> np.ndarray:
    """The five float32 scalars of ``trims`` in :data:`TRIM_KEYS` order (the
    tail kernels' trims block, ``kernels/resize.Epilogue.trims``)."""
    return np.asarray([getattr(trims, k) for k in TRIM_KEYS],
                      np.float64).astype(np.float32)


def trims_from_values(values: Mapping, name: str = "l2_trims") -> DoviTrims:
    """A serving call's trims (all five :data:`TRIM_KEYS`, host numbers as
    :func:`hdr_values` takes them) as enabled :class:`DoviTrims` of float32
    values."""
    bad = set(values) - set(TRIM_KEYS)
    missing = set(TRIM_KEYS) - set(values)
    if bad or missing:
        raise ValueError(f"{name}: needs exactly the keys {list(TRIM_KEYS)}"
                         f" (unknown {sorted(bad)}, missing {sorted(missing)})")
    return DoviTrims(**_host_floats(values, name), l2_enabled=True)


def _enabled(trims) -> bool:
    return trims is not None and bool(trims.l2_enabled)


def _split3(x: torch.Tensor, axis: int):
    return tuple(x.narrow(axis, i, 1) for i in range(3))


def rgb_to_ictcp(rgb_nits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """RGB_to_ICTCP (ps_hdr10_tonemap.hlsl:191-208): BT.2020 RGB nits ->
    ICtCp via the LMS/4096 integer matrices."""
    r, g, b = _split3(rgb_nits, axis)
    l = (1688.0 * r + 2146.0 * g + 262.0 * b) / 4096.0
    m = (683.0 * r + 2951.0 * g + 462.0 * b) / 4096.0
    s = (99.0 * r + 309.0 * g + 3688.0 * b) / 4096.0
    l = linear_to_st2084(l, 10000.0)
    m = linear_to_st2084(m, 10000.0)
    s = linear_to_st2084(s, 10000.0)
    i = (2048.0 * l + 2048.0 * m) / 4096.0
    ct = (6610.0 * l - 13613.0 * m + 7003.0 * s) / 4096.0
    cp = (17933.0 * l - 17390.0 * m - 543.0 * s) / 4096.0
    return torch.cat([i, ct, cp], dim=axis)


def ictcp_to_rgb(ictcp: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """ICTCP_to_RGB (ps_hdr10_tonemap.hlsl:210-229)."""
    i, ct, cp = _split3(ictcp, axis)
    l = i + 0.00860904 * ct + 0.11102963 * cp
    m = i - 0.00860904 * ct - 0.11102963 * cp
    s = i + 0.56003134 * ct - 0.32062717 * cp
    l = st2084_to_linear(l, 10000.0)
    m = st2084_to_linear(m, 10000.0)
    s = st2084_to_linear(s, 10000.0)
    r = 3.43660669 * l - 2.50645212 * m + 0.06984542 * s
    g = -0.79132956 * l + 1.98360045 * m - 0.19227090 * s
    b = -0.02594990 * l - 0.09891371 * m + 1.12486361 * s
    return torch.cat([r, g, b], dim=axis)


def apply_l2_trim(rgb_nits: torch.Tensor, t: DoviTrims,
                  axis: int = -1) -> torch.Tensor:
    """ApplyL2Trim (ps_hdr10_tonemap.hlsl:231-248): intensity trim in ICtCp
    with highlight-weighted saturation.  No path of the port calls it (the
    pipeline's trims are :func:`dolby_vision_trims`, as the JAX package's
    are)."""
    i, ct, cp = _split3(rgb_to_ictcp(rgb_nits, axis=axis), axis)
    orig_i = i
    i = torch.clamp(i * float(t.trim_slope) + float(t.trim_offset), min=0.0)
    i = torch.pow(i, float(np.float32(max(t.trim_power, 0.1))))
    sat = float(np.float32(max(t.saturation_gain, 0.0)))
    hw = torch.clamp(orig_i * 2.0, 0.0, 1.0)
    eff = sat + float(np.float32(1.0) - np.float32(sat)) * hw \
        * (1.0 - float(t.chroma_weight))
    return ictcp_to_rgb(torch.cat([i, ct * eff, cp * eff], dim=axis),
                        axis=axis)


def _trims_on(color: torch.Tensor, tr: Sequence[torch.Tensor],
              axis: int) -> torch.Tensor:
    """The trims' per-pixel half on PQ values: ``tr`` the five scalars of
    :func:`trim_values` as 0-d tensors on the pixels' device (so every
    product, power and division is a tensor op, on the card too)."""
    cw, sat, slope, offset, power = tr
    color = torch.pow(torch.clamp(color * slope + offset, min=0.0), power)
    y = _luma(color, axis)
    return color * torch.pow(
        torch.clamp((1.0 + cw) * color / torch.clamp(y, min=1e-9), min=0.0),
        sat)


def dolby_vision_trims(linear: torch.Tensor, t: DoviTrims, axis: int = -1,
                       pq_input: bool = False) -> torch.Tensor:
    """DolbyVisionTrims (ps_hdr10_tonemap.hlsl:250-263): slope/offset/power
    in PQ plus chroma-weighted saturation; in and out linear nits (the
    10000-nit scale) unless ``pq_input`` (the convert-color codegen variant,
    Source/Shaders.cpp:788-796, on PQ-coded values).  Applies ``t`` whatever
    its ``l2_enabled``, as the JAX function does."""
    tr = _device_scalars(trim_values(t), linear)
    if pq_input:
        return _trims_on(linear, tr, axis)
    return st2084_to_linear(
        _trims_on(linear_to_st2084(linear, 10000.0), tr, axis), 10000.0)


# -- the HDR10+ guided curve (selection 7) --------------------------------------

def _guided_scale(lum: torch.Tensor, disp: torch.Tensor, peak: torch.Tensor,
                  window) -> torch.Tensor:
    """The guided curve's scale of RGB from the BT.2020 luminance ``lum``
    (nits): the scene-peak-relative luminance through the window's knee +
    Bezier curve, rescaled to the display peak; below the knee the curve is
    linear, so the scale is its slope there (no 0/0 at black)."""
    from .hdr10plus import apply_hdr10plus_curve
    kx = float(window.knee_point_x)
    ky = float(window.knee_point_y)
    xn = lum / peak
    yn = apply_hdr10plus_curve(torch.clamp(xn, 0.0, 1.0), window)
    slope0 = (ky / kx) if kx > 1e-6 else 1.0
    return torch.where(xn <= max(kx, 1e-6), slope0 * disp / peak,
                       yn * disp / torch.clamp(xn * peak, min=1e-9))


def st2094_40_guided(color: torch.Tensor, disp, peak, window,
                     axis: int = -1) -> torch.Tensor:
    """ST 2094-40 (HDR10+) guided tone map, selection 7: scene luminance
    normalised to the scene peak runs through the metadata's knee + Bezier
    basis curve (:func:`~.hdr10plus.apply_hdr10plus_curve`), rescaled to
    the display peak, ratio-preserving on RGB.  ``disp``/``peak``: numbers
    or 0-d tensors; the curve's knee and anchors come from ``window`` (plan
    structure, like the DoVi reshape's).  Linear nits in and out."""
    d, pk = (x if isinstance(x, torch.Tensor) else
             torch.tensor(float(np.float32(x)), device=color.device)
             for x in (disp, peak))
    d, pk = d.to(color.device), pk.to(color.device)
    out = color * _guided_scale(_luma(color, axis), d, pk, window)
    return torch.where(d >= pk, color, out)


# -- the local tone map -----------------------------------------------------------

def _device_scalars(sc, like: torch.Tensor) -> list[torch.Tensor]:
    t = torch.tensor(np.asarray(sc, np.float32), device=like.device)
    return list(t.unbind())


def _host_scalars(sc) -> np.ndarray:
    if isinstance(sc, torch.Tensor):
        if sc.device.type != "cpu":
            raise TypeError(f"tone-map scalars on {sc.device}: pass host "
                            "values (reading them back would synchronise)")
        sc = sc.numpy()
    v = np.asarray(sc, np.float32).reshape(-1)
    if v.shape != (5,):
        raise ValueError(f"need 5 tone-map scalars, got {v.shape[0]}")
    return v


def local_tonemap_pq_from_scalars(pq_rgb: torch.Tensor, selection: int,
                                  sc: Sequence | np.ndarray,
                                  trims: DoviTrims | None = None,
                                  axis: int = -1,
                                  window=None) -> torch.Tensor:
    """Per-pixel half of the local tone map: ``sc`` the five float32 host
    scalars of :func:`local_tonemap_static_scalars` or
    :func:`local_tonemap_rt_scalars`.  Whether the display is at least as
    bright as the source peak (sc[0] >= sc[1] in float32) is decided on the
    host.  Selections 5 and 6 without trims run in the m1-power domain (a
    bright display leaves the PQ round trip there); everything else decodes
    to nits, runs the L2 trims (``trims`` with ``l2_enabled``), then the
    operator (7: the guided curve of ``window``; a bright display leaves
    the round trip through nits), and encodes.  The operations and their
    order are the tail kernels' (``csrc/tail.cuh``)."""
    if selection == HDR10PLUS_GUIDED and window is None:
        raise ValueError("selection 7 (the HDR10+ guided curve) needs the "
                         "plan's HDR10PlusWindow")
    v = _host_scalars(sc)
    l2 = _enabled(trims)
    if selection in (BT2390, ST2094_10) and not l2:
        if v[0] >= v[1]:
            return _passthrough_pq(pq_rgb)
        s = _device_scalars(v, pq_rgb)
        if selection == BT2390:
            return _bt2390_pq_p(pq_rgb, s[2], s[3], s[4], axis)
        return _st2094_10_pq_p(pq_rgb, s[2], s[3], s[4], axis)
    s = _device_scalars(v, pq_rgb)
    color = st2084_to_linear(pq_rgb, 10000.0)
    if l2:
        color = st2084_to_linear(_trims_on(
            linear_to_st2084(color, 10000.0),
            _device_scalars(trim_values(trims), pq_rgb), axis), 10000.0)
    if selection in (HDR10PLUS_GUIDED, BT2390, ST2094_10):
        if v[0] < v[1]:
            color = color * _linear_scale(selection, color, s, axis, window)
        return linear_to_st2084(color, 10000.0)
    disp, eff, fall_adj = s[0], s[1], s[2]
    c = torch.clamp(color / eff, 0.0, 1.0) * fall_adj
    return linear_to_st2084(_operator(selection, c, disp) * disp, 10000.0)


def _linear_scale(selection: int, color: torch.Tensor, s, axis: int,
                  window) -> torch.Tensor:
    """The scale of nits RGB of selections 7, 5 and 6 in their general
    (linear-domain) forms, below the source peak."""
    if selection == HDR10PLUS_GUIDED:
        return _guided_scale(_luma(color, axis), s[0], s[1], window)
    if selection == BT2390:
        max_pq, target_pq, ks = s[2], s[3], s[4]
        avg = _luma(color, axis)
        e1 = linear_to_st2084(avg, 10000.0)
        t = (e1 - ks) / torch.clamp(max_pq - ks, min=1e-6)
        t2, t3 = t * t, t * t * t
        e2s = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (max_pq - ks)
               + (-2 * t3 + 3 * t2) * target_pq)
        mapped = st2084_to_linear(torch.where(e1 > ks, e2s, e1), 10000.0)
        return torch.where(avg <= 1e-6, 1.0,
                           mapped / torch.clamp(avg, min=1e-6))
    c1, c2, c3 = s[2], s[3], s[4]
    xn = _luma(color, axis)
    yn = (c1 + c2 * xn) / (1.0 + c3 * xn)
    return torch.where(xn > 0.0, yn / torch.clamp(xn, min=1e-9), 1.0)


def local_tonemap_pq_rt(pq_rgb: torch.Tensor, selection: int, p: Mapping,
                        trims: DoviTrims | None = None, axis: int = -1,
                        window=None) -> torch.Tensor:
    """The local tone map with a serving call's HDR10 values ``p`` (the
    five :data:`HDR_KEYS`, host numbers): :func:`local_tonemap_rt_scalars`
    then :func:`local_tonemap_pq_from_scalars`.  A new scene is a new set
    of five scalars, nothing else."""
    return local_tonemap_pq_from_scalars(
        pq_rgb, selection, local_tonemap_rt_scalars(selection, p),
        trims=trims, axis=axis, window=window)


def local_tonemap_pq(pq_rgb: torch.Tensor, selection: int, p: HDRParams,
                     trims: DoviTrims | None = None, axis: int = -1,
                     window=None) -> torch.Tensor:
    """Full ps_hdr10_tonemap main() (ps_hdr10_tonemap.hlsl:265-331) with a
    plan's static metadata: PQ in, PQ out, the operator chosen by
    ``selection`` (ToneMapType, or 7 with an HDR10+ ``window``), R, G, B on
    ``axis``, the L2 ``trims`` first where enabled.  Its scalars are
    :func:`local_tonemap_static_scalars`, float64 on the host as the JAX
    package's ``local_tonemap_pq`` computes them."""
    return local_tonemap_pq_from_scalars(
        pq_rgb, selection, local_tonemap_static_scalars(selection, p),
        trims=trims, axis=axis, window=window)
