"""The reference chain of a Dolby Vision configuration: the P010
normalisation and chroma upsample, then the Dolby Vision reshape of each
channel from a scene's curve coefficients (the piece is the count of
pivots at or below the signal; a piece is a quadratic or an MMR sum;
Shaders.cpp:531-589, 733-763), the RPU's YCbCr -> RGB matrix and offset,
the LMS step through the PQ curves (Shaders.cpp:824-859), the resize and
the PQ -> SDR tail of the HDR10 chain.  A scene is the RPU as the traffic
mix states it: ``curves``, ``ycc_to_rgb``, ``ycc_offset``,
``rgb_to_lms``."""

from __future__ import annotations

import numpy as np
import torch

from . import colour
from .oracle import (Arith, dither_codes, normalised, pq_eotf, pq_oetf,
                     pq_to_sdr, resize, sdr_params)


def reshape(ycc: torch.Tensor, curves: list, ar: Arith) -> torch.Tensor:
    """Each channel through its piecewise curve (``curves[c]``: ``pivots``
    and ``pieces``, each piece ``{"poly": [c0, c1, c2]}`` or ``{"mmr":
    {"const": c, "coef": [[3 linear + 4 cross weights] per order]}}``), on
    the signals clipped to [0, 1]; each result clipped to [0, 1]."""
    sig = torch.clamp(ycc, 0.0, 1.0)
    s0, s1, s2 = sig
    lin = sig
    cross = torch.stack([s0 * s1, s0 * s2, s1 * s2, s0 * s1 * s2])
    out = []
    for ch, curve in enumerate(curves):
        s = sig[ch]
        val = None
        piece = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
        for p in curve["pivots"]:
            piece += (s >= p).to(torch.int64)
        for k, spec in enumerate(curve["pieces"]):
            if "poly" in spec:
                c0, c1, c2 = spec["poly"]
                v = c0 + c1 * s + c2 * s * s
            else:
                v = spec["mmr"]["const"] + torch.zeros_like(s)
                for j, w in enumerate(spec["mmr"]["coef"]):
                    v = v + ar.einsum("k,khw->hw", ar.const(w[:3], s.device),
                                      lin ** (j + 1))
                    v = v + ar.einsum("k,khw->hw", ar.const(w[3:], s.device),
                                      cross ** (j + 1))
            val = v if val is None else torch.where(piece == k, v, val)
        out.append(torch.clamp(val, 0.0, 1.0))
    return torch.stack(out)


def render(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, cfg: dict,
           rpu: dict, ar: Arith = Arith()) -> torch.Tensor:
    """One frame (``cfg``: :func:`oracle.sdr_params`) with a scene's RPU ->
    (3, out_h, out_w) codes."""
    dev = y.device
    ycc = reshape(normalised(y, u, v, ar), rpu["curves"], ar)
    off = ar.const(rpu["ycc_offset"], dev)[:, None, None]
    rgb = ar.einsum("ij,jhw->ihw", ar.const(rpu["ycc_to_rgb"], dev), ycc - off)
    lms = colour.DOVI_LMS2RGB @ np.asarray(rpu["rgb_to_lms"], np.float64)
    rgb = pq_oetf(ar.einsum("ij,jhw->ihw", ar.const(lms, dev), pq_eotf(rgb)))
    rgb = resize(rgb, cfg["out_w"], cfg["out_h"], cfg["filter"], ar)
    return dither_codes(pq_to_sdr(rgb, cfg["sdr_nits"], ar), cfg["bits"])


def frame(config: dict, planes, scene, ar: Arith = Arith()) -> torch.Tensor:
    """The codes of one frame's (y, u, v) planes under the scene's RPU."""
    return render(*planes, sdr_params(config), scene, ar)
