"""HDR tone mapping on torch tensors: the Hable "Convert to SDR" curve
(Shaders/convert/hdr_tone_mapping.hlsl) and the HDR10 parameter block.

Port of the first part of ``videorenderer_tpu.ops.tonemap``; the six local
tone-map operators, ICtCp and the Dolby Vision trims come with the local
tone-mapping slice (ROADMAP, modules to port).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
