"""The reference chain of an SDR configuration upscaled with Jinc2: the
8-bit codes normalised by 255, the 4:2:0 chroma upsampled bilinearly at
MPEG-2 siting, the YCbCr -> RGB matrix, MPC Video Renderer's one-pass 2D
Jinc2 with anti-ringing (Shaders/examples/resizer_onepass_jinc2.hlsl) and
the 32 x 32 ordered dither to 8-bit codes.  No transfer curve and no gamut
step: SDR BT.709 in, SDR out.

The Jinc2 pass, as the shader computes it for each output (j, i):

- its texel coordinate along each axis is ``(j + 0.5) * n_in / n_out``,
  its base texel ``floor(tex - 0.5)`` and its fraction ``tex - 0.5 -
  base``;
- the 4 x 4 taps sit at base - 1 .. base + 2 on both axes, the edge texels
  repeated (D3D CLAMP addressing);
- a tap's weight is ``sin(d wa) sin(d wb) / d**2`` of its distance ``d``
  from the output's position, ``wa = 0.416 pi``, ``wb = 0.985 pi``, and
  ``wa wb`` at ``d = 0``;
- the weighted sum over the weights' sum, then 0.8 of the way toward its
  clamp to the min and max of the centre 2 x 2 taps (``lerp(color,
  clamp(color, mn, mx), JINC2_AR_STRENGTH)``).

The resize pass runs only where ResizeShaderPass
(Source/DX11VideoProcessor.cpp:3120-3139) gives one 2D Jinc2 pass: both
axes up, a 2:1 shrink counting as up with ``interpolate_at_50pct``; the
chain refuses a shrink past that (the convolution filters), an axis kept
at its size, a placed video (``video_rect``) and any source but NV12
BT.709 at TV levels.

Departures from the shader: everything in float64 (the shader computes in
float32); the RGB between the convert and the pass is held unrounded,
where the renderer samples it from its intermediate texture; each
weight's distance is computed from the output's position and the tap's
offset directly, in the precision of the evaluation, where the shader
takes it from interpolated texture coordinates; the result is clipped to
[0, 1] and dithered here, as the renderer's final pass does after the
resize pass.  Weights come from the distances themselves: no tap tables,
no weight table, no classes.  Imports nothing of the program under
test."""

from __future__ import annotations

import math

import torch

from . import colour
from .oracle import Arith, dither_codes, upsample_420

WINDOW_SINC = 0.416
SINC = 0.985
AR_STRENGTH = 0.8
BLOCK_ROWS = 256    # output rows resampled at once (the taps' memory)
CENTRE = (5, 6, 9, 10)   # taps (1, 1), (1, 2), (2, 1), (2, 2) of the 4 x 4


def _role(n_in: int, n_out: int, k: int) -> str | None:
    if n_in == n_out:
        return None
    return "down" if n_in > k * n_out else "up"


def params(config: dict) -> dict:
    """The chain's parameters from the configuration's own settings; a
    setting or a geometry the chain does not implement raises."""
    s, src, out = config["settings"], config["video_source"], config["output"]
    want = {"upscaling": "JINC2", "chroma_scaling": "BILINEAR",
            "use_dither": True}
    for key, v in want.items():
        if s.get(key) != v:
            raise ValueError(f"the reference runs {key}={v}, not {s.get(key)}")
    if (src["format"], src["matrix"], src["levels"]) != \
            ("NV12", "BT_709", "TV"):
        raise ValueError("the reference runs NV12 BT.709 TV-range sources")
    if int(out["bits"]) != 8 or out.get("video_rect") is not None:
        raise ValueError("the reference runs a whole 8-bit surface")
    k = 2 if s.get("interpolate_at_50pct", True) else 1
    w, h = int(src["width"]), int(src["height"])
    ow, oh = int(out["width"]), int(out["height"])
    roles = (_role(w, ow, k), _role(h, oh, k))
    if roles != ("up", "up"):
        raise ValueError(f"{w} x {h} -> {ow} x {oh} takes the passes "
                         f"{roles}; the reference runs one 2D Jinc2 pass, "
                         "both axes up")
    return {"out_w": ow, "out_h": oh, "bits": 8}


def _axis(n_in: int, n_out: int, ar: Arith, device
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(base texel (n_out,) int64, fraction (n_out,)) of one axis."""
    tex = (torch.arange(n_out, dtype=ar.dtype, device=device) + 0.5) \
        * n_in / n_out
    base = torch.floor(tex - 0.5)
    return base.to(torch.int64), tex - 0.5 - base


def weight(d2: torch.Tensor) -> torch.Tensor:
    """The Jinc2 weight of a squared distance: sin(d wa) sin(d wb) / d**2,
    wa wb at 0."""
    wa, wb = WINDOW_SINC * math.pi, SINC * math.pi
    d = torch.sqrt(d2)
    zero = d2 == 0.0
    return torch.where(zero, torch.full_like(d2, wa * wb),
                       torch.sin(d * wa) * torch.sin(d * wb)
                       / torch.where(zero, torch.ones_like(d2), d2))


def jinc2(x: torch.Tensor, out_h: int, out_w: int, ar: Arith = Arith()
          ) -> torch.Tensor:
    """The one-pass Jinc2 with anti-ringing of (C, H, W) -> (C, out_h,
    out_w), a block of output rows at a time; the weighted sum of each
    output's 16 taps in one ``ar.einsum``."""
    h, w = x.shape[-2:]
    by, fy = _axis(h, out_h, ar, x.device)
    bx, fx = _axis(w, out_w, ar, x.device)
    cols = [torch.clamp(bx + o, 0, w - 1) for o in range(-1, 3)]
    out = []
    for r0 in range(0, out_h, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, out_h)
        taps, wts = [], []
        for jo in range(4):
            rows = x[:, torch.clamp(by[r0:r1] + jo - 1, 0, h - 1)]
            dy2 = (fy[r0:r1] - (jo - 1)) ** 2
            for io in range(4):
                taps.append(rows[:, :, cols[io]])
                wts.append(weight(dy2[:, None] + (fx - (io - 1))[None, :] ** 2))
        taps, wts = torch.stack(taps), torch.stack(wts)
        acc = ar.einsum("kchw,khw->chw", taps, wts) / wts.sum(0)
        centre = taps[list(CENTRE)]
        clamped = torch.minimum(torch.maximum(acc, centre.amin(0)),
                                centre.amax(0))
        out.append(acc + (clamped - acc) * AR_STRENGTH)
    return torch.cat(out, dim=-2)


def render(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, cfg: dict,
           ar: Arith = Arith()) -> torch.Tensor:
    """One frame (``cfg``: :func:`params`) -> (3, out_h, out_w) codes."""
    m, c = colour.yuv_to_rgb("BT_709", "TV", bits=8)
    n = 1.0 / 255.0
    ycc = torch.stack([y.to(ar.dtype) * n, upsample_420(u.to(ar.dtype) * n),
                       upsample_420(v.to(ar.dtype) * n)])
    rgb = ar.einsum("ij,jhw->ihw", ar.const(m, y.device), ycc) \
        + ar.const(c, y.device)[:, None, None]
    return dither_codes(jinc2(rgb, cfg["out_h"], cfg["out_w"], ar),
                        cfg["bits"])


def frame(config: dict, planes, scene, ar: Arith = Arith()) -> torch.Tensor:
    """The codes of one frame's (y, u, v) planes; an SDR source carries no
    per-scene metadata, so ``scene`` is unused."""
    return render(*planes, params(config), ar)
