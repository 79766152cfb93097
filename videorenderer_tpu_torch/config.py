"""Configuration model for the PyTorch/CUDA port of the video renderer.

This mirrors the reference renderer's ``Settings_t`` struct and its enum
domains (reference: Source/IVideoRenderer.h:25-186) as frozen dataclasses and
``IntEnum``s.  The reference persists settings in the Windows registry
(Source/VideoRenderer.cpp:160-275,1273-1315); here persistence is a JSON file
with the same clamping-on-load behavior (``discard<int>`` analogue).

A ``Settings`` value (together with a ``SourceDescriptor``) fully determines
the planned pipeline and the kernel specialisation it launches, like the
reference's runtime HLSL codegen specializes a pixel shader per media type
(Source/Shaders.cpp:593-930).  Field for field the same as
``videorenderer_tpu.config`` (tests/test_torch_host.py checks it).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any


class TexFormat(enum.IntEnum):
    """Internal texture format choice (IVideoRenderer.h:25-30)."""

    AUTOINT = 0
    INT8 = 8
    INT10 = 10
    FLOAT16 = 16


class Deinterlacing(enum.IntEnum):
    """Deinterlacing mode (IVideoRenderer.h:32-36)."""

    DISABLE = 0
    ENABLE = 1
    HACK_FUTURE_FRAMES = 2


class SuperResolution(enum.IntEnum):
    """Learned/vendor super-resolution gating level (IVideoRenderer.h:38-45).

    In the reference this selects NVIDIA/Intel VP extensions size-gated by
    source size (Source/D3D11VP.cpp:804-844).  Here it gates the learned
    upscaler model (not yet ported).
    """

    DISABLE = 0
    SD = 1
    P720 = 2
    P1080 = 3
    P1440 = 4


class ChromaScaling(enum.IntEnum):
    """Chroma upsampling method (IVideoRenderer.h:47-52)."""

    NEAREST = 0
    BILINEAR = 1
    CATMULL_ROM = 2


class Upscaling(enum.IntEnum):
    """Upscaling interpolation filter (IVideoRenderer.h:54-62)."""

    NEAREST = 0
    MITCHELL = 1
    CATMULL_ROM = 2
    LANCZOS2 = 3
    LANCZOS3 = 4
    JINC2 = 5


class Downscaling(enum.IntEnum):
    """Downscaling convolution filter (IVideoRenderer.h:64-72)."""

    BOX = 0
    BILINEAR = 1
    HAMMING = 2
    BICUBIC = 3
    BICUBIC_SHARP = 4
    LANCZOS = 5


class SwapEffect(enum.IntEnum):
    """Present-queue mode analogue (IVideoRenderer.h:74-77).

    Maps to the output sink's buffering depth rather than a DXGI swap effect.
    """

    DISCARD = 0
    FLIP = 1


class HdrToggleDisplay(enum.IntEnum):
    """Display HDR on/off switching policy (IVideoRenderer.h:79-85)."""

    DISABLED = 0
    ON_FULLSCREEN = 1
    ON = 2
    ONOFF_FULLSCREEN = 3
    ONOFF = 4


class ToneMapType(enum.IntEnum):
    """Local HDR tone-map operator (Shaders/d3d11/ps_hdr10_tonemap.hlsl:20)."""

    ACES = 1
    REINHARD = 2
    HABLE = 3
    MOBIUS = 4
    BT2390 = 5
    ST2094_10 = 6


SDR_NITS_DEF = 125
SDR_NITS_MIN = 25
SDR_NITS_MAX = 400
SDR_NITS_STEP = 5

HDR_NITS_DEF = 1000
HDR_NITS_MIN = 100
HDR_NITS_MAX = 10000


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(v)))


@dataclass(frozen=True)
class VPEnableFormats:
    """Format allowlist for the fixed-function path (IVideoRenderer.h:97-102)."""

    nv12: bool = True
    p01x: bool = True
    yuy2: bool = True
    other: bool = True


@dataclass(frozen=True)
class Settings:
    """Full renderer settings — field-for-field port of ``Settings_t``
    (IVideoRenderer.h:104-186) with the same defaults (``SetDefault``,
    IVideoRenderer.h:140-185).  Windows-only fields keep their names so a
    reference user finds everything; fields that have no meaning off Windows are
    documented as accepted-but-advisory.
    """

    # Backend select: reference picks D3D11 vs D3D9 (VideoRenderer.cpp:284-303).
    # Here: True = the hand-written CUDA kernels for CUDA tensors, False =
    # the plain PyTorch composition (same math, fewer fusions).
    use_accel_backend: bool = True
    show_stats: bool = False
    resize_stats: int = 0
    tex_format: TexFormat = TexFormat.AUTOINT
    vp_formats: VPEnableFormats = field(default_factory=VPEnableFormats)
    vp_deinterlacing: Deinterlacing = Deinterlacing.ENABLE
    deint_double: bool = True
    vp_scaling: bool = True
    vp_superres: SuperResolution = SuperResolution.DISABLE
    vp_rtx_video_hdr: bool = False       # "RTX Video HDR" slot: learned SDR->HDR hook
    chroma_scaling: ChromaScaling = ChromaScaling.BILINEAR
    upscaling: Upscaling = Upscaling.CATMULL_ROM
    downscaling: Downscaling = Downscaling.HAMMING
    interpolate_at_50pct: bool = True
    use_dither: bool = True
    deint_blend: bool = False
    swap_effect: SwapEffect = SwapEffect.FLIP
    exclusive_fullscreen: bool = False   # advisory (no display attached)
    vblank_before_present: bool = False  # advisory
    adjust_present_time: bool = True
    reinit_by_display: bool = False      # advisory
    hdr_prefer_dovi: bool = False
    hdr_passthrough: bool = True
    hdr_toggle_display: HdrToggleDisplay = HdrToggleDisplay.DISABLED
    hdr_osd_brightness: int = 0          # 0=100 nits, 1=50, 2=30 (PropPage)
    convert_to_sdr: bool = True
    sdr_display_nits: int = SDR_NITS_DEF
    hdr_local_tone_mapping: bool = False
    hdr_local_tone_mapping_type: ToneMapType = ToneMapType.ACES
    hdr_display_max_nits: int = HDR_NITS_DEF

    def validate(self) -> "Settings":
        """Range-clamp like the registry loader (VideoRenderer.cpp:160-275)."""
        return dataclasses.replace(
            self,
            resize_stats=_clamp(self.resize_stats, 0, 1),
            hdr_osd_brightness=_clamp(self.hdr_osd_brightness, 0, 2),
            sdr_display_nits=_clamp(self.sdr_display_nits, SDR_NITS_MIN, SDR_NITS_MAX),
            hdr_display_max_nits=_clamp(
                self.hdr_display_max_nits, HDR_NITS_MIN, HDR_NITS_MAX
            ),
        )

    # -- persistence (registry analogue) ------------------------------------

    def to_dict(self) -> dict[str, Any]:
        def conv(v: Any) -> Any:
            if isinstance(v, enum.IntEnum):
                return int(v)
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
            return v

        return {f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Settings":
        kwargs: dict[str, Any] = {}
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
        enum_types = {
            "tex_format": TexFormat,
            "vp_deinterlacing": Deinterlacing,
            "vp_superres": SuperResolution,
            "chroma_scaling": ChromaScaling,
            "upscaling": Upscaling,
            "downscaling": Downscaling,
            "swap_effect": SwapEffect,
            "hdr_toggle_display": HdrToggleDisplay,
            "hdr_local_tone_mapping_type": ToneMapType,
        }
        for k, v in d.items():
            if k not in hints:
                continue  # forward compat: ignore unknown keys
            if k == "vp_formats" and isinstance(v, dict):
                kwargs[k] = VPEnableFormats(**v)
            elif k in enum_types:
                kwargs[k] = enum_types[k](v)
            else:
                kwargs[k] = v
        return cls(**kwargs).validate()

    # presentation-only fields: consumed host-side (OSD, pacing, display
    # control), never part of the traced computation
    _PRESENTATION_ONLY = ("show_stats", "resize_stats", "swap_effect",
                          "exclusive_fullscreen", "vblank_before_present",
                          "adjust_present_time", "reinit_by_display",
                          "hdr_toggle_display", "hdr_osd_brightness",
                          "hdr_prefer_dovi")

    def trace_relevant(self) -> "Settings":
        """These settings with presentation-only fields normalized to their
        defaults: two Settings whose ``trace_relevant()`` compare equal
        run the same computation.  The specialisation-key half of Configure's
        diff-and-minimal-rebuild (Source/DX11VideoProcessor.cpp:3812-4062) —
        toggling e.g. ``show_stats`` must never recompile the pipeline."""
        d = Settings()
        return dataclasses.replace(
            self, **{f: getattr(d, f) for f in self._PRESENTATION_ONLY})

    def save(self, path: str | os.PathLike[str]) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str | os.PathLike[str]) -> "Settings":
        with open(path) as f:
            return cls.from_dict(json.load(f))


DEFAULT_SETTINGS = Settings()
