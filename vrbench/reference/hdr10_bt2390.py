"""The reference chain of an HDR10 passthrough configuration with the
BT.2390 local tone map: normalise the codes, upsample the 4:2:0 chroma
bilinearly at MPEG-2 siting, the YCbCr -> RGB matrix, the resize of each
axis (the identity at 1:1), the PQ EOTF to nits, BT2390Tonemap for the
display's peak (Shaders/d3d11/ps_hdr10_tonemap.hlsl:66-117), the PQ OETF
and the 32 x 32 ordered dither to 10-bit codes.  The output stays BT.2020
PQ: no gamut change, no SDR gamma.

BT2390Tonemap, in nits, of a scene's HDR10 values:

- the safe MaxCLL: MaxCLL where it is above 10 nits, else the mastering
  peak where that is above 10, else 1000;
- where the display's peak is at least the safe MaxCLL, every pixel passes
  through unchanged;
- else ``max_pq`` and ``target_pq`` are the PQ codes of the safe MaxCLL
  and of the display's peak, the knee ``ks = max(0, 1.5 target_pq - 0.5
  max_pq)``; ``e1`` is the PQ code of the pixel's BT.2020 luma; above the
  knee the Hermite spline through (ks, ks) and (max_pq, target_pq) with
  ``t = (e1 - ks) / max(1e-6, max_pq - ks)`` maps it, at or below it is
  kept;
- RGB is scaled by the mapped luma in nits over the luma, by 1 where the
  luma is at most 1e-6 nits (hue-preserving).

Departures from the shader: everything in float64 (the shader computes in
float32); the passthrough is decided once a frame from the scene's values,
as the shader's constant buffer decides it for every pixel alike; negative
channels are clipped to 0 before the EOTF and the EOTF's denominator held
above 1e-6 (``oracle.pq_eotf``), so that no pixel reads a NaN; the PQ code
is clipped to [0, 1] before the dither.  The port rewrites the same step
in the m1-power domain (12 pows a pixel); the reference keeps the shader's
order.  A scene is the HDR10 values a sample's side data carries
(``mastering_min_nits``, ``mastering_max_nits``, ``max_cll``,
``max_fall``; DX11VideoProcessor.cpp:2232-2267), over the configuration's
``hdr10``; the display's peak is the setting ``hdr_display_max_nits``."""

from __future__ import annotations

import torch

from . import colour, scale
from .oracle import Arith, dither_codes, normalised, pq_eotf, pq_oetf

PQ_NITS = 10000.0   # nits of PQ's 1.0


def safe_max_cll(hdr: dict) -> float:
    """The peak the tone map works to: MaxCLL, else the mastering peak,
    else 1000 nits (each only above 10 nits)."""
    if hdr["max_cll"] > 10.0:
        return float(hdr["max_cll"])
    if hdr["mastering_max_nits"] > 10.0:
        return float(hdr["mastering_max_nits"])
    return 1000.0


def bt2390(nits: torch.Tensor, hdr: dict, display_nits: float,
           ar: Arith = Arith()) -> torch.Tensor:
    """BT2390Tonemap on (3, H, W) BT.2020 RGB in nits."""
    peak = safe_max_cll(hdr)
    if display_nits >= peak:
        return nits

    def pq(x: float) -> float:
        return pq_oetf(torch.tensor(x / PQ_NITS, dtype=torch.float64)).item()

    max_pq, target_pq = pq(peak), pq(display_nits)
    ks = max(0.0, 1.5 * target_pq - 0.5 * max_pq)
    avg = ar.einsum("k,khw->hw",
                    ar.const(colour.LUMA["BT_2020_NC"], nits.device), nits)
    e1 = pq_oetf(avg / PQ_NITS)
    t = (e1 - ks) / max(1e-6, max_pq - ks)
    t2, t3 = t * t, t * t * t
    spline = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (max_pq - ks)
              + (-2 * t3 + 3 * t2) * target_pq)
    mapped = pq_eotf(torch.where(e1 > ks, spline, e1)) * PQ_NITS
    gain = torch.where(avg <= 1e-6, torch.ones_like(avg),
                       mapped / torch.clamp(avg, min=1e-6))
    return nits * gain


def resize_axis(rgb: torch.Tensor, out_n: int, dim: int, s: dict,
                ar: Arith) -> torch.Tensor:
    """One axis resized (``dim`` -1: W, -2: H): nothing at the same size,
    the upscaling filter up to a 2:1 shrink where the setting
    ``interpolate_at_50pct`` holds (ResizeShaderPass's choice); a shrink
    past that would take a convolution filter the reference lacks."""
    n = rgb.shape[dim]
    if n == out_n:
        return rgb
    if n > out_n * (2 if s.get("interpolate_at_50pct", True) else 1):
        raise ValueError(f"{n} -> {out_n} takes the downscaling filter "
                         f"{s.get('downscaling')}, which the reference lacks")
    m = ar.const(scale.axis_matrix(s["upscaling"], n, out_n), rgb.device)
    eq = "chw,wx->chx" if dim == -1 else "chw,hy->cyw"
    return ar.einsum(eq, rgb, m)


def params(config: dict) -> dict:
    """The chain's parameters from the configuration's own settings; a
    setting the chain does not implement raises."""
    s, src, out = config["settings"], config["video_source"], config["output"]
    want = {"chroma_scaling": "BILINEAR", "convert_to_sdr": False,
            "hdr_passthrough": True, "hdr_local_tone_mapping": True,
            "hdr_local_tone_mapping_type": "BT2390", "use_dither": True}
    for k, v in want.items():
        if s.get(k) != v:
            raise ValueError(f"the reference runs {k}={v}, not {s.get(k)}")
    if (src["format"], src["transfer"], src["primaries"]) != \
            ("P010", "PQ", "BT_2020") or out["bits"] != 10 or \
            not out.get("hdr") or out.get("video_rect") is not None:
        raise ValueError("the reference runs P010 PQ BT.2020 sources to a "
                         "whole 10-bit PQ surface")
    return {"matrix": src["matrix"], "levels": src["levels"],
            "out_w": int(out["width"]), "out_h": int(out["height"]),
            "display_nits": float(s["hdr_display_max_nits"]),
            "hdr10": dict(src.get("hdr10") or {}), "settings": s,
            "bits": int(out["bits"])}


def render(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, cfg: dict,
           hdr: dict, ar: Arith = Arith()) -> torch.Tensor:
    """One frame (``cfg``: :func:`params`) under the HDR10 values ``hdr``
    -> (3, out_h, out_w) codes."""
    m, c = colour.yuv_to_rgb(cfg["matrix"], cfg["levels"])
    ycc = normalised(y, u, v, ar)
    rgb = ar.einsum("ij,jhw->ihw", ar.const(m, y.device), ycc) \
        + ar.const(c, y.device)[:, None, None]
    rgb = resize_axis(rgb, cfg["out_w"], -1, cfg["settings"], ar)
    rgb = resize_axis(rgb, cfg["out_h"], -2, cfg["settings"], ar)
    nits = bt2390(pq_eotf(rgb) * PQ_NITS, hdr, cfg["display_nits"], ar)
    return dither_codes(pq_oetf(nits / PQ_NITS), cfg["bits"])


def frame(config: dict, planes, scene, ar: Arith = Arith()) -> torch.Tensor:
    """The codes of one frame's (y, u, v) planes under the scene's HDR10
    values (the configuration's ``hdr10`` where the scene gives none)."""
    cfg = params(config)
    hdr = {**cfg["hdr10"], **(scene or {})}
    return render(*planes, cfg, hdr, ar)
