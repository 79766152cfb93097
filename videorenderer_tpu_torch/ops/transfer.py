"""Electro-optical transfer functions on torch tensors.

Ports of the reference's HLSL include library, as
``videorenderer_tpu.ops.transfer`` writes them:
 - SMPTE ST 2084 (PQ):  Shaders/convert/st2084.hlsl
 - ARIB STD-B67 (HLG):  Shaders/convert/hlg.hlsl
 - power gammas used by the convert-color codegen
   (Source/Shaders.cpp:893-922)

Elementwise over float32 tensors; ``csrc/rows3_tail.cu`` carries the same
formulas for its epilogue.
"""

from __future__ import annotations

import torch

# ST 2084 constants (Shaders/convert/st2084.hlsl:1-5)
ST2084_M1 = 2610.0 / (4096.0 * 4.0)
ST2084_M2 = (2523.0 / 4096.0) * 128.0
ST2084_C1 = 3424.0 / 4096.0
ST2084_C2 = (2413.0 / 4096.0) * 32.0
ST2084_C3 = (2392.0 / 4096.0) * 32.0


def pow_pos(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` for x >= 0 and a positive exponent, as
    ``exp2(e * log2(x))`` with a zero-base guard: the form the JAX package
    chose for its pow towers, kept so both packages round alike."""
    z = x <= 0.0
    r = torch.exp2(e * torch.log2(torch.where(z, torch.ones_like(x), x)))
    return torch.where(z, torch.zeros_like(x), r)


def st2084_to_linear(x: torch.Tensor, factor: float) -> torch.Tensor:
    """PQ EOTF (ST2084ToLinear, st2084.hlsl:9-16).  ``factor`` scales the
    decoded [0,1] signal: 10000/sdr_nits ("LuminanceScale",
    Source/DX11VideoProcessor.cpp:893) makes 1.0 the SDR white level.  The
    rational term's denominator is held above 1e-6, which keeps the EOTF
    total for overshoot inputs above ~1.995 where the HLSL gives NaN."""
    x = pow_pos(torch.clamp(x, min=0.0), 1.0 / ST2084_M2)
    x = torch.clamp(x - ST2084_C1, min=0.0) / torch.clamp(
        ST2084_C2 - ST2084_C3 * x, min=1e-6)
    x = pow_pos(x, 1.0 / ST2084_M1)
    return x * factor


def linear_to_st2084(x: torch.Tensor, divider: float) -> torch.Tensor:
    """PQ OETF (LinearToST2084, st2084.hlsl:18-25); the 1e30 cap keeps
    inf/inf out of the rational term."""
    x = pow_pos(torch.clamp(x / divider, 0.0, 1e30), ST2084_M1)
    x = (ST2084_C1 + ST2084_C2 * x) / (1.0 + ST2084_C3 * x)
    return pow_pos(x, ST2084_M2)


# HLG constants (Shaders/convert/hlg.hlsl:1-8)
_B67_A = 0.17883277
_B67_B = 0.28466892
_B67_C = 0.55991073
_B67_INV_R2 = 4.0

# BT.2020 luminance weights of the HLG OOTF
HLG_LUMA = (0.2627, 0.6780, 0.0593)


def inverse_hlg(x: torch.Tensor) -> torch.Tensor:
    """HLG inverse OETF (inverse_HLG, hlg.hlsl:1-11): signal -> scene light
    in [0,12]."""
    lo = x * x * _B67_INV_R2
    hi = torch.exp((x - _B67_C) / _B67_A) + _B67_B
    return torch.where(x <= 0.5, lo, hi)


def hlg_to_linear(rgb: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """HLG signal -> display light with the reference's OOTF (HLGtoLinear,
    hlg.hlsl:13-21): per-pixel BT.2020 luminance drives a system-gamma 1.2
    boost at a 2000-nit nominal display.  R, G, B are stacked on ``axis``."""
    rgb = inverse_hlg(rgb)
    r, g, b = (rgb.narrow(axis, i, 1) for i in range(3))
    w = HLG_LUMA
    ys = 2000.0 * (w[0] * r + w[1] * g + w[2] * b)
    return rgb * pow_pos(torch.clamp(ys, min=1e-7), 0.2)


def srgb_like_to_linear(x: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Simple power-law decode used by the fix/convert shaders
    (e.g. ps_fix_bt2020.hlsl: ``pow(color, 2.2)``)."""
    return pow_pos(torch.clamp(x, 0.0, 1.0), gamma)


def linear_to_srgb_like(x: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Power-law encode (``pow(color, 1/2.2)``, Source/Shaders.cpp:917-923)."""
    return pow_pos(torch.clamp(x, 0.0, 1.0), 1.0 / gamma)
