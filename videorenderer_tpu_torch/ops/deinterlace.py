"""Deinterlacing on torch tensors — port of
``videorenderer_tpu.ops.deinterlace``.

The reference delegates deinterlacing to the fixed-function GPU video
processor (rate-conversion caps selection, Source/D3D11VP.cpp:292-331;
past/future reference-frame rings, Source/D3D11VP.h:26-193; second-field
output via ``OutputIndex=1``, Source/D3D11VP.cpp:893-960) with a shader-path
fallback of blend deinterlacing inside the convert shader
(Source/Shaders.cpp:232-237).  Double-rate field output renders two frames
per input sample (Source/DX11VideoProcessor.cpp:2176-2197).

 * ``bob``        — per-field line doubling with linear interpolation
 * ``weave``      — no-op recombination
 * ``blend``      — field average (the reference's shader fallback)
 * ``motion_adaptive`` — weave where static, bob where moving, decided by a
   per-pixel temporal difference between the previous and next frames.

All functions take (..., H, W) planes and use the JAX package's full-array
formulation (two edge-clamped row shifts and a row-parity mask), in the same
operation order.  Field convention: ``top_field_first=True`` means field 0
is the top field (even rows) and renders first.
"""

from __future__ import annotations

import torch

from .chroma import blend_deinterlace_luma


def _bob_neighbors(frame: torch.Tensor, use_top: bool):
    """(up, dn) rows so that (up + dn) / 2 is bob's reconstruction at every
    opposite-field row: row r averages frame[r-1] and frame[r+1], with bob's
    field-internal clamping at the edges."""
    if use_top:
        up = torch.cat([frame[..., :1, :], frame[..., :-1, :]], dim=-2)
        # bottom clamp: the last odd row averages field row H-2 twice
        dn = torch.cat([frame[..., 1:, :], frame[..., -2:-1, :]], dim=-2)
    else:
        # top clamp: row 0 averages field row 1 twice
        up = torch.cat([frame[..., 1:2, :], frame[..., :-1, :]], dim=-2)
        dn = torch.cat([frame[..., 1:, :], frame[..., -1:, :]], dim=-2)
    return up, dn


def _opposite_mask(frame: torch.Tensor, use_top: bool) -> torch.Tensor:
    h = frame.shape[-2]
    rows = torch.arange(h, device=frame.device).view(h, 1)
    return (rows & 1) == (1 if use_top else 0)


def bob(frame: torch.Tensor, field: int,
        top_field_first: bool = True) -> torch.Tensor:
    """Line-doubling bob: keep the active field's rows, reconstruct the
    others as the mean of their vertical neighbours (edge-clamped).
    ``field``: 0 = first temporal field, 1 = second."""
    use_top = (field == 0) == top_field_first
    up, dn = _bob_neighbors(frame, use_top)
    return torch.where(_opposite_mask(frame, use_top), (up + dn) * 0.5, frame)


def weave(frame: torch.Tensor) -> torch.Tensor:
    """Identity — both fields belong to the same instant."""
    return frame


def blend(frame: torch.Tensor) -> torch.Tensor:
    """Field blend: y' = (2*y[r] + y[r-1] + y[r+1]) / 4, the convert-shader
    fallback, which the convert path runs on luma
    (:func:`..ops.chroma.blend_deinterlace_luma`, the one copy)."""
    return blend_deinterlace_luma(frame)


def motion_adaptive(frame: torch.Tensor, prev: torch.Tensor,
                    nxt: torch.Tensor, field: int,
                    top_field_first: bool = True,
                    threshold: float = 8.0 / 255.0) -> torch.Tensor:
    """Motion-adaptive deinterlace over a past/future window: weave where
    |next - prev| is small, bob where it is large, with a linear ramp of
    width ``threshold`` between them (motion in [thr, 2*thr] blends)."""
    use_top = (field == 0) == top_field_first
    up, dn = _bob_neighbors(frame, use_top)
    bob_rows = (up + dn) * 0.5
    motion = torch.abs(nxt - prev)
    alpha = torch.clamp((motion - threshold) / threshold, 0.0, 1.0)
    mixed = frame + (bob_rows - frame) * alpha
    return torch.where(_opposite_mask(frame, use_top), mixed, frame)


def double_rate_fields(frame: torch.Tensor, top_field_first: bool = True):
    """The two bob fields of double-rate output
    (Source/DX11VideoProcessor.cpp:2176-2197): field 0 at t, field 1 at
    t + duration/2."""
    return (bob(frame, 0, top_field_first), bob(frame, 1, top_field_first))
