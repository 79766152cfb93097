"""HDR10+ (SMPTE ST 2094-40) dynamic metadata, for torch.

Port of ``videorenderer_tpu.ops.hdr10plus``.  The reference defines the
side-data struct (MediaSideDataHDR10Plus, Include/IMediaSideData.h:67-130)
but never consumes it; here the per-scene statistics drive tone mapping the
way Dolby Vision L1 does (ops/dovi_ext.py):

 * :func:`scene_peak_nits` — the scene's true peak from maxscl (or the
   99.98% distribution percentile when present), in place of the static
   mastering peak;
 * :func:`hdr_params_from_hdr10plus` — per-scene HDRParams for the local
   tone map (MaxCLL <- scene peak, MaxFALL <- average maxRGB), and the
   upgrade to the guided curve (selection 7) when the window carries one;
 * :func:`runtime_hdr_from_hdr10plus` — a serving call's ``rt["hdr"]``
   values, so a scene change rebuilds nothing;
 * :func:`merge_hdr10` — the output-side HDR10 static metadata;
 * :func:`apply_hdr10plus_curve` — the ST 2094-40 guided curve itself
   (knee + Nth-order Bernstein/Bezier basis curve) on torch tensors of
   normalised linear luminance; :func:`guided_constants` is its host half
   for the tail kernels (``csrc/tail.cuh``).

The host half is plain Python and numpy, the JAX module's; the metadata's
values follow the struct's comment ("rational values normalized as
double"): maxscl, average_maxrgb and the percentiles are linear [0, 1]
fractions of 10 000 nits; the knee and Bezier fields are normalised
already.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .tonemap import HDRParams

# the anchors ST 2094-40 allows a window (num_bezier_curve_anchors < 16), so
# a curve of order n <= 16 and n + 1 control-point coefficients
MAX_ANCHORS = 15
GUIDED_COEFFS = MAX_ANCHORS + 2


@dataclass(frozen=True)
class HDR10PlusWindow:
    """One processing window's transform parameters (window 0 = full frame;
    MediaSideDataHDR10Plus.windows[i], Include/IMediaSideData.h:78-114)."""

    maxscl: tuple[float, float, float] = (0.0, 0.0, 0.0)
    average_maxrgb: float = 0.0
    # (percentage, percentile-value) pairs, value in [0,1] of 10000 nits
    distribution_maxrgb: tuple[tuple[int, float], ...] = ()
    fraction_bright_pixels: float = 0.0
    tone_mapping_flag: int = 0
    knee_point_x: float = 0.0
    knee_point_y: float = 0.0
    bezier_curve_anchors: tuple[float, ...] = ()
    color_saturation_mapping_flag: int = 0
    color_saturation_weight: float = 1.0


@dataclass(frozen=True)
class HDR10PlusMetadata:
    """MediaSideDataHDR10Plus analogue (window list + target luminance)."""

    windows: tuple[HDR10PlusWindow, ...] = field(
        default_factory=lambda: (HDR10PlusWindow(),))
    targeted_system_display_maximum_luminance: float = 0.0


def _window0(meta: HDR10PlusMetadata) -> HDR10PlusWindow:
    return meta.windows[0] if meta.windows else HDR10PlusWindow()


def scene_peak_nits(meta: HDR10PlusMetadata) -> float:
    """Per-scene source peak: the highest maxRGB percentile at or above 99%
    when the distribution carries one (the conventional HDR10+ peak
    estimator; encoders list the percentiles in any order), otherwise
    max(maxscl); 0 when the metadata is empty."""
    w = _window0(meta)
    best = max((e for e in w.distribution_maxrgb if e[0] >= 99),
               key=lambda e: e[0], default=None)
    if best is not None:
        return float(best[1]) * 10000.0
    return float(max(w.maxscl)) * 10000.0


def scene_average_nits(meta: HDR10PlusMetadata) -> float:
    return float(_window0(meta).average_maxrgb) * 10000.0


def hdr_params_from_hdr10plus(meta: HDR10PlusMetadata, hdr10,
                              display_max_nits: float,
                              tonemap_type: int) -> tuple[HDRParams, int]:
    """Local-tone-map parameters with the scene statistics in place of the
    static mastering metadata (the DoVi-L1 pattern,
    ops/dovi_ext.hdr_params_from_extensions).  When the window carries a
    guided basis curve (tone_mapping_flag=1) the operator upgrades to
    selection 7, :func:`~.tonemap.st2094_40_guided`.  ``hdr10``: the
    source's ``pipeline.HDR10Metadata`` or None."""
    peak = scene_peak_nits(meta)
    avg = scene_average_nits(meta)
    mn = hdr10.mastering_min_nits if hdr10 is not None else 0.005
    if _window0(meta).tone_mapping_flag and peak > 0.0:
        tonemap_type = 7
    if peak <= 0.0:
        h = hdr10
        if h is None:
            from ..pipeline import HDR10Metadata
            h = HDR10Metadata()
        return (HDRParams(mastering_min_nits=h.mastering_min_nits,
                          mastering_max_nits=h.mastering_max_nits,
                          max_cll=h.max_cll, max_fall=h.max_fall,
                          display_max_nits=float(display_max_nits)),
                tonemap_type)
    return (HDRParams(mastering_min_nits=float(mn),
                      mastering_max_nits=float(peak),
                      max_cll=float(peak),
                      max_fall=float(avg) if avg > 0 else float(peak) * 0.4,
                      display_max_nits=float(display_max_nits)),
            tonemap_type)


def merge_hdr10(hdr10, meta: HDR10PlusMetadata):
    """Output-side HDR10 static metadata with the scene peak merged in (the
    analogue of the DoVi merge for the swap-chain metadata)."""
    from ..pipeline import HDR10Metadata
    peak = scene_peak_nits(meta)
    if hdr10 is None:
        hdr10 = HDR10Metadata()
    if peak <= 0.0:
        return hdr10
    return dataclasses.replace(
        hdr10, max_cll=max(hdr10.max_cll, peak),
        max_fall=max(hdr10.max_fall, scene_average_nits(meta)))


def runtime_hdr_from_hdr10plus(meta: HDR10PlusMetadata, hdr10,
                               display_max_nits: float) -> dict:
    """A serving call's ``rt["hdr"]`` values for a scene (float32 host
    numbers): nothing is rebuilt when they change."""
    p, _ = hdr_params_from_hdr10plus(meta, hdr10, display_max_nits, 0)
    return {
        "mastering_min_nits": np.float32(p.mastering_min_nits),
        "mastering_max_nits": np.float32(p.mastering_max_nits),
        "max_cll": np.float32(p.max_cll),
        "max_fall": np.float32(p.max_fall),
        "display_max_nits": np.float32(display_max_nits),
    }


def _ipow(x: torch.Tensor, e: int) -> torch.Tensor:
    """``x ** e`` for an integer e >= 0 by binary exponentiation, the
    products in the JAX package's order (``lax.integer_pow``)."""
    if e == 0:
        return torch.ones_like(x)
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e > 0:
            x = x * x
    return acc


def _curve(w: HDR10PlusWindow) -> tuple[float, float, list[float]]:
    """(kx, ky, the Bernstein coefficients C(n, k) * P_k, k = 0 .. n) of
    the window's curve: P_0 = 0, the anchors, P_n = 1."""
    anchors = tuple(float(a) for a in w.bezier_curve_anchors)
    if len(anchors) > MAX_ANCHORS:
        raise ValueError(f"ST 2094-40 allows at most {MAX_ANCHORS} Bezier "
                         f"anchors, got {len(anchors)}")
    n = len(anchors) + 1
    ctrl = (0.0,) + anchors + (1.0,)
    return (float(w.knee_point_x), float(w.knee_point_y),
            [math.comb(n, k) * ctrl[k] for k in range(n + 1)])


def apply_hdr10plus_curve(x: torch.Tensor, w: HDR10PlusWindow) -> torch.Tensor:
    """ST 2094-40 guided tone mapping on normalised linear luminance x in
    [0, 1] (source-peak relative): linear below the knee, an Nth-order
    Bernstein basis curve above it,

        y = ky + (1 - ky) * B((x - kx) / (1 - kx)),   x > kx
        y = x * ky / kx,                              x <= kx
        B(t) = sum_k C(N, k) t^k (1-t)^(N-k) * P_k,   P_0 = 0, P_N = 1,

    the window's anchors the interior control points.  Each term is
    ``C(n, k) * P_k * t**k * (1-t)**(n-k)`` in that order, ``t**k`` by
    repeated products and ``(1-t)**(n-k)`` by :func:`_ipow`; the knee's
    divisor is a 0-d tensor, so the division is a true one on the card
    too (``csrc/tail.cuh`` runs the same operations)."""
    if not w.tone_mapping_flag:
        return x
    kx, ky, coefs = _curve(w)
    n = len(coefs) - 1
    den = torch.tensor(float(np.float32(max(1.0 - kx, 1e-6))),
                       device=x.device)
    t = torch.clamp((x - kx) / den, 0.0, 1.0)
    omt = 1.0 - t
    acc = None
    tk = torch.ones_like(t)
    for k, coef in enumerate(coefs):
        if coef != 0.0:
            term = coef * tk * _ipow(omt, n - k)
            acc = term if acc is None else acc + term
        tk = tk * t
    bez = acc if acc is not None else torch.zeros_like(t)
    above = ky + (1.0 - ky) * bez
    below = x * (ky / max(kx, 1e-6)) if kx > 0 else torch.zeros_like(x)
    return torch.where(x <= kx, below, above)


def guided_constants(w: HDR10PlusWindow | None) -> np.ndarray:
    """The guided curve's host half for the tail kernels, float64 rounded
    to float32 as the torch version's Python numbers are: [flag, kx, ky,
    n, max(1 - kx, 1e-6), 1 - ky, the slope below the knee (0 when kx <=
    0), max(kx, 1e-6), the scale's slope at black (ky / kx, 1 when kx <=
    1e-6), then the GUIDED_COEFFS coefficients C(n, k) * P_k, zero
    padded].  Zeros without a window."""
    out = np.zeros(9 + GUIDED_COEFFS, np.float64)
    if w is None:
        return out.astype(np.float32)
    kx, ky, coefs = _curve(w)
    out[:9] = [1.0 if w.tone_mapping_flag else 0.0, kx, ky, len(coefs) - 1,
               max(1.0 - kx, 1e-6), 1.0 - ky,
               ky / max(kx, 1e-6) if kx > 0 else 0.0, max(kx, 1e-6),
               (ky / kx) if kx > 1e-6 else 1.0]
    out[9:9 + len(coefs)] = coefs
    return out.astype(np.float32)
