"""Dolby Vision extension-block metadata (ST 2094-10 levels 1/2/3/6).

Port of ``videorenderer_tpu.ops.dovi_ext`` (plain Python and numpy, the
JAX module's code).  Host-side, pure/deterministic: raw 12-bit extension fields from the RPU
(MediaSideDataDOVIMetadata.Extensions, Include/IMediaSideData.h:188-230)
resolve into the tone-map parameters and output HDR10 metadata, exactly as
CDX11VideoProcessor::CopySample / Render do:

 * L1 min/max/avg PQ (+ L3 offsets, value + offset - 2048) convert to linear
   nits and drive the local tone map's HDRParams — maxCLL takes the L1 max,
   maxFALL the L1 avg, and tone-map type 5 (BT.2390) upgrades to 6
   (ST 2094-10) when L1 is present
   (Source/DX11VideoProcessor.cpp:2357-2394, 2728-2732).
 * L2 trims select by the display's PQ distance to each block's
   target_max_pq: interpolate between the bracketing targets, toward the
   master (2048 = neutral) when the display is brighter than all targets,
   or clamp to the dimmest target (Source/DX11VideoProcessor.cpp:2396-2481);
   the /4096 ±0.5 cbuffer packing of SetDolbyVisionDynamicParams
   (Source/DX11VideoProcessor.cpp:954-959) lands in ops.tonemap.DoviTrims.
 * L6 overrides the mastering-display luminance (otherwise derived from
   ColorMetadata.source_min/max_pq) and CLL/FALL, which merge into the
   output-side HDR10 metadata (Source/DX11VideoProcessor.cpp:2485-2500,
   2645-2659, 2695-2703).

Everything here returns plain floats/dataclasses: per-scene RPU updates feed
a serving call's runtime values (pipeline.make_serving_fn's "hdr" and
"l2_trims") and rebuild nothing, the way the reference re-uploads cbuffers
per sample without recompiling shaders.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .tonemap import DoviTrims, HDRParams
from .transfer import (ST2084_C1, ST2084_C2, ST2084_C3, ST2084_M1, ST2084_M2)


def pq_to_nits(x: float) -> float:
    """PQ-encoded [0,1] -> linear nits (PqToLinearNits,
    Source/DX11VideoProcessor.cpp:2342-2347)."""
    x = float(x) ** (1.0 / ST2084_M2)
    x = max(x - ST2084_C1, 0.0) / (ST2084_C2 - ST2084_C3 * x)
    return (x ** (1.0 / ST2084_M1)) * 10000.0


def nits_to_pq(y: float) -> float:
    """Linear nits -> PQ-encoded [0,1] (LinearNitsToPq,
    Source/DX11VideoProcessor.cpp:2348-2355)."""
    y = max(float(y) / 10000.0, 0.0) ** ST2084_M1
    y = (ST2084_C1 + ST2084_C2 * y) / (1.0 + ST2084_C3 * y)
    return y ** ST2084_M2


@dataclass(frozen=True)
class L1Extension:
    """Per-scene content brightness, 12-bit PQ-coded (0..4095)."""

    min_pq: int
    max_pq: int
    avg_pq: int


@dataclass(frozen=True)
class L2Extension:
    """Per-target trim pass; raw 12-bit fields, 2048 = neutral."""

    target_max_pq: int
    trim_slope: int = 2048
    trim_offset: int = 2048
    trim_power: int = 2048
    trim_chroma_weight: int = 2048
    trim_saturation_gain: int = 2048


@dataclass(frozen=True)
class L3Extension:
    """Offsets applied to L1 (value + offset - 2048)."""

    min_pq_offset: int = 2048
    max_pq_offset: int = 2048
    avg_pq_offset: int = 2048


@dataclass(frozen=True)
class L6Extension:
    """HDR10-compatible mastering metadata override.  Units follow the DXGI
    HDR10 convention the reference stores them in: max_luminance in nits,
    min_luminance in 0.0001-nit steps, CLL/FALL in nits."""

    max_luminance: int = 0
    min_luminance: int = 0
    max_cll: int = 0
    max_fall: int = 0


@dataclass(frozen=True)
class DoviExtensions:
    """The per-frame extension set carried next to ops.dovi.DoviMetadata
    (one RPU's Extensions[] array + the ColorMetadata source luminance)."""

    l1: L1Extension | None = None
    l2: tuple[L2Extension, ...] = ()
    l3: L3Extension | None = None
    l6: L6Extension | None = None
    # ColorMetadata.source_max_pq / source_min_pq (12-bit PQ-coded)
    source_max_pq: int = 3079   # ~1000 nits
    source_min_pq: int = 7      # ~0.005 nits


def l1_nits(ext: DoviExtensions) -> tuple[int, int, int] | None:
    """Resolved L1 (+L3 offsets) in linear nits, truncated to ints exactly
    like the reference's UINT casts (Source/DX11VideoProcessor.cpp:2357-2381).
    None when no L1 block is present."""
    if ext.l1 is None:
        return None
    mn, mx, av = ext.l1.min_pq, ext.l1.max_pq, ext.l1.avg_pq
    if ext.l3 is not None:
        mn += ext.l3.min_pq_offset - 2048
        mx += ext.l3.max_pq_offset - 2048
        av += ext.l3.avg_pq_offset - 2048
    return (int(pq_to_nits(mn / 4095.0)), int(pq_to_nits(mx / 4095.0)),
            int(pq_to_nits(av / 4095.0)))


def select_l2_trims(ext: DoviExtensions,
                    display_max_nits: float) -> DoviTrims | None:
    """Scenario A/B/C trim selection (Source/DX11VideoProcessor.cpp:2396-2481)
    followed by the SetDolbyVisionDynamicParams cbuffer packing: raw/4096
    with the ±0.5 neutral shifts.  None when no L2 blocks are present."""
    if not ext.l2:
        return None
    display_pq = nits_to_pq(display_max_nits)
    lower = upper = None
    closest_lower = closest_upper = 1.0
    for blk in ext.l2:
        target_pq = blk.target_max_pq / 4095.0
        if target_pq <= display_pq:
            dist = display_pq - target_pq
            if dist < closest_lower:
                closest_lower, lower = dist, blk
        else:
            dist = target_pq - display_pq
            if dist < closest_upper:
                closest_upper, upper = dist, blk

    fields = ("trim_slope", "trim_offset", "trim_power",
              "trim_chroma_weight", "trim_saturation_gain")
    if lower is not None and upper is not None:
        # A: display between two targets — lerp by PQ position
        lo_pq = lower.target_max_pq / 4095.0
        up_pq = upper.target_max_pq / 4095.0
        w = ((display_pq - lo_pq) / (up_pq - lo_pq)) if up_pq != lo_pq else 0.0
        w = min(max(w, 0.0), 1.0)
        vals = {f: getattr(lower, f) + (getattr(upper, f)
                                        - getattr(lower, f)) * w
                for f in fields}
    elif lower is not None:
        # B: display brighter than all targets — lerp toward neutral at the
        # master's peak
        master_pq = ext.source_max_pq / 4095.0
        lo_pq = lower.target_max_pq / 4095.0
        w = ((display_pq - lo_pq) / (master_pq - lo_pq)) \
            if master_pq > lo_pq else 0.0
        w = min(max(w, 0.0), 1.0)
        vals = {f: getattr(lower, f) + (2048.0 - getattr(lower, f)) * w
                for f in fields}
    else:
        # C: display dimmer than all targets — clamp to the dimmest
        vals = {f: float(getattr(upper, f)) for f in fields}

    return DoviTrims(
        chroma_weight=vals["trim_chroma_weight"] / 4096.0 - 0.5,
        saturation_gain=vals["trim_saturation_gain"] / 4096.0 - 0.5,
        trim_slope=vals["trim_slope"] / 4096.0 + 0.5,
        trim_offset=vals["trim_offset"] / 4096.0 - 0.5,
        trim_power=vals["trim_power"] / 4096.0 + 0.5,
        l2_enabled=True,
    )


def mastering_nits(ext: DoviExtensions) -> tuple[float, float, float, float]:
    """(max_mastering, min_mastering, max_cll, max_fall) in nits, with the
    L6 override of the ColorMetadata-derived values
    (Source/DX11VideoProcessor.cpp:2485-2500).  Zeros mean "not present"
    (the merge below skips them), matching the reference's UINT fields."""
    max_m = float(int(pq_to_nits(ext.source_max_pq / 4095.0)))
    min_m = float(int(pq_to_nits(ext.source_min_pq / 4095.0) * 10000.0)) \
        / 10000.0
    cll = fall = 0.0
    if ext.l6 is not None:
        max_m = float(ext.l6.max_luminance)
        min_m = float(ext.l6.min_luminance) / 10000.0
        cll = float(ext.l6.max_cll)
        fall = float(ext.l6.max_fall)
    return max_m, min_m, cll, fall


def merge_hdr10(hdr10, ext: DoviExtensions):
    """Merge DoVi mastering metadata into HDR10 static metadata for the
    output side (swap-chain SetHDRMetaData analogue,
    Source/DX11VideoProcessor.cpp:2645-2659, defaults 2695-2703).

    ``hdr10``: pipeline.HDR10Metadata or None (no side data); returns an
    HDR10Metadata to program downstream.
    """
    from ..pipeline import HDR10Metadata
    max_m, min_m, cll, fall = mastering_nits(ext)
    if hdr10 is not None:
        return dataclasses.replace(
            hdr10,
            mastering_max_nits=max(hdr10.mastering_max_nits, max_m),
            mastering_min_nits=min_m if min_m else hdr10.mastering_min_nits,
            max_cll=cll if cll else hdr10.max_cll,
            max_fall=fall if fall else hdr10.max_fall,
        )
    return HDR10Metadata(
        mastering_max_nits=max_m if max_m else 1000.0,
        mastering_min_nits=min_m if min_m else 0.005,
        max_cll=cll if cll else 1000.0,
        max_fall=fall if fall else 400.0,
    )


def hdr_params_from_extensions(ext: DoviExtensions, hdr10,
                               display_max_nits: float,
                               tonemap_type: int) -> tuple[HDRParams, int]:
    """Local-tone-map parameters from the extension set: with L1 present the
    shader takes (L1.min, L1.max, L1.max, L1.avg) and type 5 upgrades to 6;
    otherwise the (merged) HDR10 mastering metadata applies
    (Source/DX11VideoProcessor.cpp:2728-2736)."""
    l1 = l1_nits(ext)
    if l1 is not None:
        mn, mx, av = l1
        return (HDRParams(mastering_min_nits=float(mn),
                          mastering_max_nits=float(mx),
                          max_cll=float(mx), max_fall=float(av),
                          display_max_nits=float(display_max_nits)),
                6 if tonemap_type == 5 else tonemap_type)
    h = merge_hdr10(hdr10, ext)
    return (HDRParams(mastering_min_nits=h.mastering_min_nits,
                      mastering_max_nits=h.mastering_max_nits,
                      max_cll=h.max_cll, max_fall=h.max_fall,
                      display_max_nits=float(display_max_nits)),
            tonemap_type)


def runtime_hdr_from_extensions(ext: DoviExtensions, hdr10,
                                display_max_nits: float) -> dict:
    """A serving call's per-scene ``rt["hdr"]`` values
    (ops.tonemap.local_tonemap_pq_rt): one host-side dict per RPU update,
    nothing rebuilt."""
    p, _ = hdr_params_from_extensions(ext, hdr10, display_max_nits, 0)
    return {
        "mastering_min_nits": np.float32(p.mastering_min_nits),
        "mastering_max_nits": np.float32(p.mastering_max_nits),
        "max_cll": np.float32(p.max_cll),
        "max_fall": np.float32(p.max_fall),
        "display_max_nits": np.float32(display_max_nits),
    }


def runtime_trims_from_extensions(ext: DoviExtensions,
                                  display_max_nits: float) -> dict | None:
    """A serving call's per-scene ``rt["l2_trims"]`` values: the selected
    trim pass as float32 host numbers (None when the scene has no L2
    blocks)."""
    t = select_l2_trims(ext, display_max_nits)
    if t is None:
        return None
    return {
        "chroma_weight": np.float32(t.chroma_weight),
        "saturation_gain": np.float32(t.saturation_gain),
        "trim_slope": np.float32(t.trim_slope),
        "trim_offset": np.float32(t.trim_offset),
        "trim_power": np.float32(t.trim_power),
    }
