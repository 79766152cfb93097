"""Subtitle / OSD composition: alpha blending with dirty rects, on float
frames and on the packed dword surface, and the SDR-overlay-on-PQ
brightness compensation.  Port of ``videorenderer_tpu.ops.overlay``.

Reference equivalents:
 * subtitle alpha-blt quads (CDX11SubPic AlphaBlt, Source/SubPic/DX11SubPic.cpp)
   and the player-callback path DrawSubtitles
   (Source/DX11VideoProcessor.cpp:3247-3295)
 * IMFVideoMixerBitmap alpha-bitmap OSD (Source/DX11VideoProcessor.cpp:4553-4623)
 * ps_convert_bitmap_to_pq.hlsl — SDR OSD pre-compensated to PQ at
   100/50/30 nits (iHdrOsdBrightness), constants in TransferPQ
   (Source/DX11Helper.h:267-272)

Every function is functional, as the JAX ``.at[].set`` is: the blends write
into a clone of the frame or surface they are given, never into the
caller's tensor (a ``DeinterlaceSession`` or the caller may still hold it).
The packed surface is int32 with the alpha bits set, so ``>>`` is
arithmetic: every shift is masked, and nothing goes through
``torch.uint32``.
"""

from __future__ import annotations

import torch

from .transfer import linear_to_st2084, srgb_like_to_linear

# OSD nits per iHdrOsdBrightness setting (PropPage choices 100/50/30 nits)
OSD_NITS = (100.0, 50.0, 30.0)


def alpha_blend(base: torch.Tensor, overlay_rgb: torch.Tensor,
                overlay_alpha: torch.Tensor) -> torch.Tensor:
    """Straight (non-premultiplied) alpha blend: out = ov*a + base*(1-a).

    base: (..., 3, H, W); overlay_rgb: (3, H, W) or broadcastable;
    overlay_alpha: (H, W) or (1, H, W), in [0,1].
    """
    a = overlay_alpha
    if a.ndim == base.ndim - 1:
        a = a.unsqueeze(-3)
    return overlay_rgb * a + base * (1.0 - a)


def alpha_blend_premultiplied(base: torch.Tensor,
                              overlay_rgb_premul: torch.Tensor,
                              overlay_alpha: torch.Tensor) -> torch.Tensor:
    """Premultiplied blend (D3D SRC_ONE/INV_SRC_ALPHA, the subpic path):
    out = ov + base*(1-a)."""
    a = overlay_alpha
    if a.ndim == base.ndim - 1:
        a = a.unsqueeze(-3)
    return overlay_rgb_premul + base * (1.0 - a)


def _clip_rect(fh: int, fw: int, h: int, w: int, x: int, y: int):
    """The overlay clipped to the surface (ClipToSurface analogue,
    Source/Helper.cpp): (ox, oy, x, y, h, w), the overlay's first row and
    column inside the surface, the surface position and the clipped size
    (h or w <= 0 when nothing is visible)."""
    ox, oy = max(0, -x), max(0, -y)
    x, y = max(0, x), max(0, y)
    return ox, oy, x, y, min(h - oy, fh - y), min(w - ox, fw - x)


def blend_in_rect(base: torch.Tensor, overlay_rgb: torch.Tensor,
                  overlay_alpha: torch.Tensor, x: int, y: int,
                  premultiplied: bool = False) -> torch.Tensor:
    """Composite a small overlay at (x, y) — the dirty-rect path (ISubPic
    GetDirtyRect/AlphaBlt): only the overlay-sized region is blended, into a
    clone of ``base`` (``base`` is left as it was).  Overlays are clipped
    to the frame bounds, and ``base`` may have leading batch dims."""
    ox, oy, x, y, h, w = _clip_rect(base.shape[-2], base.shape[-1],
                                    overlay_alpha.shape[-2],
                                    overlay_alpha.shape[-1], x, y)
    if h <= 0 or w <= 0:
        return base
    ov_rgb = overlay_rgb[..., oy:oy + h, ox:ox + w]
    ov_a = overlay_alpha[..., oy:oy + h, ox:ox + w]
    blend = alpha_blend_premultiplied if premultiplied else alpha_blend
    out = base.clone()
    out[..., :, y:y + h, x:x + w] = blend(base[..., :, y:y + h, x:x + w],
                                          ov_rgb, ov_a)
    return out


# (max code, channel shifts, the alpha bits as a signed int32): the same
# constants as kernels/resize.pack_surface
_SURFACE_BITS = {"rgb10a2": (1023.0, (0, 10, 20), -1073741824),
                 "rgba8": (255.0, (0, 8, 16), -16777216)}


def _unpack_dwords(dwords: torch.Tensor, fmt: str) -> torch.Tensor:
    """(..., h, w) int32 packed dwords -> (..., 3, h, w) float [0,1]."""
    maxv, shifts, _ = _SURFACE_BITS[fmt]
    mask = int(maxv)
    chans = [((dwords >> s) & mask).to(torch.float32) / maxv for s in shifts]
    return torch.stack(chans, dim=-3)


def _pack_dwords(rgb: torch.Tensor, fmt: str) -> torch.Tensor:
    """(..., 3, h, w) float [0,1] -> (..., h, w) int32 packed dwords (the
    math of kernels/resize.pack_surface: ``clip(x)*maxv + 0.5`` truncated)."""
    maxv, shifts, alpha = _SURFACE_BITS[fmt]

    def q(x):
        return (torch.clamp(x, 0.0, 1.0) * maxv + 0.5).to(torch.int32)

    out = q(rgb[..., 0, :, :]) << shifts[0]
    for i in (1, 2):
        out = out | (q(rgb[..., i, :, :]) << shifts[i])
    return out | alpha


def blend_in_rect_packed(surface: torch.Tensor, overlay_rgb: torch.Tensor,
                         overlay_alpha: torch.Tensor, x: int, y: int,
                         fmt: str, premultiplied: bool = False
                         ) -> torch.Tensor:
    """:func:`blend_in_rect` on a packed R10G10B10A2/RGBA8 int32 dword
    surface (..., H, W) — the reference's semantics: subtitles, OSD and the
    alpha bitmap draw onto the swap-chain backbuffer *after* the dithered
    final pass (Source/DX11VideoProcessor.cpp:2741-2767), so the blend reads
    and rewrites quantized backbuffer codes.  Only the dirty rect is
    unpacked, blended in float, requantized (round to nearest, the ROP's
    UNORM write) and repacked, into a clone of ``surface`` (``surface`` is
    left as it was); the rest of the clone is the surface's dwords."""
    ox, oy, x, y, h, w = _clip_rect(surface.shape[-2], surface.shape[-1],
                                    overlay_alpha.shape[-2],
                                    overlay_alpha.shape[-1], x, y)
    if h <= 0 or w <= 0:
        return surface
    ov_rgb = overlay_rgb[..., oy:oy + h, ox:ox + w]
    ov_a = overlay_alpha[..., oy:oy + h, ox:ox + w]
    region = _unpack_dwords(surface[..., y:y + h, x:x + w], fmt)
    blend = alpha_blend_premultiplied if premultiplied else alpha_blend
    out = surface.clone()
    out[..., y:y + h, x:x + w] = _pack_dwords(blend(region, ov_rgb, ov_a),
                                              fmt)
    return out


def sdr_bitmap_to_pq(rgb: torch.Tensor, osd_brightness: int = 0
                     ) -> torch.Tensor:
    """ps_convert_bitmap_to_pq.hlsl: sRGB-encoded OSD -> PQ signal at the
    selected OSD luminance so overlays read correctly on an HDR pass-through
    output. linear = srgb^2.2 * (nits/10000) in PQ."""
    nits = OSD_NITS[max(0, min(2, osd_brightness))]
    lin = srgb_like_to_linear(rgb) * (nits / 10000.0)
    return linear_to_st2084(lin, 1.0)
