"""Rotation and flip of rendered frames.

Port of ``videorenderer_tpu.ops.geometry`` (``rotate_flip``, ``rf_decompose``,
``transform_axis_maps``, ``rotated_size``, ``half_overunder_to_interlace``).  The reference exposes rotation and flip through
IExFilterConfig ("rotation", "flip", Source/VideoRenderer.cpp:1335-1559) and
applies them during the resize pass by vertex permutation (FillVertices,
Source/DX11VideoProcessor.cpp:130-179).  Here they are layout operations on
the last two (H, W) dims of a tensor; the one-pass Jinc2 kernel rides the
pure-transpose case as a transposed store (``kernels/jinc2.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def rotate_flip(x: torch.Tensor, rotation: int = 0,
                flip: bool = False) -> torch.Tensor:
    """Rotate by 0/90/180/270 degrees (clockwise, matching the renderer's
    display rotation) and/or mirror horizontally, on the last two (H, W)
    dims."""
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    if rotation == 90:
        x = torch.flip(x.transpose(-2, -1), dims=(-1,))
    elif rotation == 180:
        x = torch.flip(x, dims=(-2, -1))
    elif rotation == 270:
        x = torch.flip(x.transpose(-2, -1), dims=(-2,))
    if flip:
        x = torch.flip(x, dims=(-1,))
    return x


def rf_decompose(rotation: int, flip: bool) -> tuple[bool, bool, bool]:
    """:func:`rotate_flip` as (transpose, flip_rows, flip_cols), applied in
    that order."""
    tr, fr, fc = {0: (False, False, False), 90: (True, False, True),
                  180: (False, True, True), 270: (True, True, False)}[rotation]
    if flip:
        fc = not fc
    return tr, fr, fc


def transform_axis_maps(wy, wx, rotation: int, flip: bool):
    """Transform separable (row map, column map) (in, out) matrices so that
    running the pipeline on ``rotate_flip``-ed input planes with the
    returned maps gives ``rotate_flip`` of its output: for ``OUT = Wy^T P
    Wx`` and an axis permutation or reversal ``T``, ``T(OUT) = Wy'^T T(P)
    Wx'``, the transpose swapping the maps and each output axis's reversal
    reversing its map in both indices.  None maps (identity axes) stay
    None.  Host numpy, as in the JAX package; no path calls it (the port
    rotates the finished surface, or stores K6's output transposed)."""
    tr, fr, fc = rf_decompose(rotation, flip)
    if tr:
        wy, wx = wx, wy
    rr = lambda m: None if m is None else np.asarray(m)[::-1, ::-1]
    if fr:
        wy = rr(wy)
    if fc:
        wx = rr(wx)
    return wy, wx


def rotated_size(width: int, height: int, rotation: int) -> tuple[int, int]:
    """Source size after rotation (GetSourceRect swap,
    Source/VideoProcessor.cpp:30-50)."""
    if rotation in (90, 270):
        return height, width
    return width, height


def half_overunder_to_interlace(x: torch.Tensor) -> torch.Tensor:
    """Stereo3D half-over/under -> row-interlaced
    (ps_halfoverunder_to_interlace.hlsl): even output rows sample the top
    half, odd rows the bottom half, both at the output row's vertical
    position within the half."""
    half = x.shape[-2] // 2
    top = x[..., :half, :]
    bottom = x[..., half:half * 2, :]
    # output row r: source half-row r//2 from top (r even) / bottom (r odd)
    stacked = torch.stack([top, bottom], dim=-2)   # (..., half, 2, W)
    return stacked.reshape(x.shape[:-2] + (half * 2, x.shape[-1]))
