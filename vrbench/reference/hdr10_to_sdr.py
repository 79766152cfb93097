"""The reference chain of an HDR10 configuration: normalise the codes,
upsample the 4:2:0 chroma bilinearly at MPEG-2 siting, the YCbCr -> RGB
matrix, the resize of each axis, the PQ EOTF with SDR white at
``sdr_display_nits``, Hable (white 4.8), BT.2020 -> BT.709, the 2.2 gamma
and the 32 x 32 ordered dither (Shaders.cpp:861-884, the tone-map and
convert shaders)."""

from __future__ import annotations

import torch

from . import colour
from .oracle import (Arith, dither_codes, normalised, pq_to_sdr, resize,
                     sdr_params)


def render(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, cfg: dict,
           ar: Arith = Arith()) -> torch.Tensor:
    """One frame (``cfg``: :func:`oracle.sdr_params`) -> (3, out_h, out_w)
    codes."""
    m, c = colour.yuv_to_rgb(cfg["matrix"], cfg["levels"])
    ycc = normalised(y, u, v, ar)
    rgb = ar.einsum("ij,jhw->ihw", ar.const(m, y.device), ycc) \
        + ar.const(c, y.device)[:, None, None]
    rgb = resize(rgb, cfg["out_w"], cfg["out_h"], cfg["filter"], ar)
    return dither_codes(pq_to_sdr(rgb, cfg["sdr_nits"], ar), cfg["bits"])


def frame(config: dict, planes, scene, ar: Arith = Arith()) -> torch.Tensor:
    """The codes of one frame's (y, u, v) planes; static metadata, so no
    scene."""
    return render(*planes, sdr_params(config), ar)
