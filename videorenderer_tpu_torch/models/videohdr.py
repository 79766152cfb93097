"""Learned SDR->HDR inverse tone mapping — the "RTX Video HDR" slot; the
inference half of ``videorenderer_tpu.models.videohdr``.

The reference exposes NVIDIA's driver-side "TrueHDR" video processor
extension (SetRTXVideoHDR, Source/D3D11VP.cpp:846-891), gated to 8-bit SDR
sources being presented on an HDR display.  Here the model is explicit: a
compact conv net on a ``s2d``x space-to-depth grid predicts a per-pixel
log-gain over a deterministic inverse-tone-mapping base, producing BT.2020
PQ output.  The deterministic base (usable without trained weights) follows
the common inverse-Reinhard expansion: linearize sRGB, expand highlights
toward the display peak, convert 709->2020 primaries, encode PQ.

Weights are the JAX model's (:mod:`.checkpoint`), the first layer's input
channels in ``pixel_unshuffle``'s order as in :mod:`.superres`; the
gain's (d, e) channels are already ``pixel_shuffle``'s order for one
output channel.  :func:`apply_fn` is differentiable (its backward runs
through ``tanh``, ``exp`` and the PQ encode in float32); the trainer is
:func:`.hdr_train.train`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import csputils
from ..ops import transfer
from .superres import (conv, conv3x3, exact_convs, he_init, pad_to_grid,
                       row_valid_mask)


@dataclass(frozen=True)
class VideoHDRConfig:
    """The JAX model's shape: the convs run on an ``s2d``x space-to-depth
    grid (1080p -> 270 x 480, 48 input channels), predicting one log-gain
    per subpixel phase; the receptive field is 7 s2d x 7 s2d pixels."""
    channels: int = 64
    s2d: int = 4
    peak_nits: float = 1000.0
    sdr_nits: float = 203.0       # BT.2408 reference white
    dtype: torch.dtype = torch.bfloat16


def inverse_tonemap_base_linear(rgb_srgb: torch.Tensor, cfg: VideoHDRConfig,
                                axis: int = -3) -> torch.Tensor:
    """Deterministic SDR->HDR expansion up to linear BT.2020 nits: sRGB ->
    linear -> inverse-Reinhard highlight expansion to ``peak_nits`` ->
    BT.2020."""
    lin_n = transfer.srgb_like_to_linear(rgb_srgb)  # 0..1, 1 = SDR white
    # inverse Reinhard parameterized so SDR white lands on the display peak:
    # out = s*x / (1 - x*(1 - s/k)); x=1 -> k, slope ~s near black
    s, k = cfg.sdr_nits, cfg.peak_nits
    expanded = s * lin_n / torch.clamp(1.0 - lin_n * (1.0 - s / k),
                                       min=s / k)
    expanded = torch.clamp(expanded, max=k)
    gm = csputils.gamut_conversion_matrix(
        csputils.Primaries.BT_709, csputils.Primaries.BT_2020) \
        .astype(np.float32).tolist()
    r, g, b = (expanded.select(axis, i) for i in range(3))
    x = torch.stack([gm[i][0] * r + gm[i][1] * g + gm[i][2] * b
                     for i in range(3)], dim=axis)
    return torch.clamp(x, min=0.0)


def inverse_tonemap_base(rgb_srgb: torch.Tensor, cfg: VideoHDRConfig,
                         axis: int = -3) -> torch.Tensor:
    """Deterministic SDR->HDR expansion: sRGB -> linear nits -> inverse-
    Reinhard highlight expansion to ``peak_nits`` -> BT.2020 -> PQ."""
    return transfer.linear_to_st2084(
        inverse_tonemap_base_linear(rgb_srgb, cfg, axis=axis), 10000.0)


class VideoHDR(nn.Module):
    """3-layer s2d-grid gain net: 3 s2d^2 -> channels -> channels -> s2d^2
    (one log-gain per subpixel phase), 3x3 convs with padding 1; parameters
    in ``cfg.dtype``, zero until :func:`init_params` or
    :func:`~.checkpoint.load_params` fills them."""

    def __init__(self, cfg: VideoHDRConfig = VideoHDRConfig()):
        super().__init__()
        self.cfg = cfg
        k = cfg.s2d
        self.c1 = conv3x3(3 * k * k, cfg.channels, cfg.dtype)
        self.c2 = conv3x3(cfg.channels, cfg.channels, cfg.dtype)
        self.c3 = conv3x3(cfg.channels, k * k, cfg.dtype)
        self.requires_grad_(False)
        for p in self.parameters():
            p.zero_()


def init_params(generator: torch.Generator,
                cfg: VideoHDRConfig = VideoHDRConfig()) -> VideoHDR:
    """He-init c1 and c2, zero c3 (as the JAX ``init_params``): the
    untrained model reduces exactly to the deterministic base."""
    model = VideoHDR(cfg)
    he_init(model.c1, generator)
    he_init(model.c2, generator)
    return model


def _gain_s2d(model: VideoHDR, h0: torch.Tensor,
              row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(n, 3 k^2, hh, ww) s2d pixels in pixel_unshuffle's order -> (n, k^2,
    hh, ww) raw (pre-tanh) gain logits, channel order (d, e).
    ``row_mask`` (``superres.row_valid_mask``) zeroes each hidden conv's
    rows outside the frame (the sharded path)."""
    mk = (lambda a: a) if row_mask is None else (lambda a: a * row_mask)
    h = mk(torch.relu(conv(h0, model.c1)))
    h = mk(torch.relu(conv(h, model.c2)))
    return conv(h, model.c3)


def _enhance(model: VideoHDR, rgb_chw: torch.Tensor,
             row_valid=None) -> torch.Tensor:
    """The model's function, differentiable: (..., 3, H, W) sRGB in
    [0, 1] -> PQ/BT.2020 float32.  The gain logits on the s2d grid,
    depth-to-space, ``2 tanh`` as the log-gain, applied to the base
    expansion's linear light, then PQ.  ``row_valid``: the frame's (lo,
    hi) s2d rows for the sharded path."""
    cfg = model.cfg
    k = cfg.s2d
    x = rgb_chw.reshape((-1,) + rgb_chw.shape[-3:])
    in_h, in_w = x.shape[-2:]
    xp = pad_to_grid(x, k).to(cfg.dtype)
    row_mask = row_valid_mask(xp.shape[-2] // k, row_valid, cfg.dtype,
                              xp.device)
    with exact_convs():
        g = _gain_s2d(model, F.pixel_unshuffle(xp, k), row_mask)
    g = F.pixel_shuffle(g, k)[:, 0, :in_h, :in_w]   # (n, H, W)
    log_gain = torch.tanh(g.float()) * 2.0            # gain in [e^-2, e^2]
    base_lin = inverse_tonemap_base_linear(x.float(), cfg, axis=-3)
    out = transfer.linear_to_st2084(base_lin * torch.exp(log_gain)[:, None],
                                    10000.0)
    return out.reshape(rgb_chw.shape)


@torch.no_grad()
def enhance_plane_chw(model: VideoHDR, rgb_chw: torch.Tensor,
                      row_valid=None) -> torch.Tensor:
    """Pipeline hook: (..., 3, H, W) sRGB in [0, 1] -> PQ/BT.2020 float32 —
    the function of the JAX ``enhance_plane_chw`` (the model's function
    without a graph).  ``row_valid``: optional (lo, hi) s2d-row frame
    bounds for the sharded path (``superres.row_valid_mask``)."""
    return _enhance(model, rgb_chw, row_valid)


def apply_fn(model: VideoHDR, sdr_rgb_nhwc: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) sRGB in [0, 1] -> (N, H, W, 3) PQ/BT.2020 in [0, 1],
    the NHWC form of :func:`enhance_plane_chw` (the JAX ``apply_fn``);
    differentiable in the model's parameters."""
    return _enhance(model, sdr_rgb_nhwc.movedim(-1, -3)).movedim(-3, -1)
