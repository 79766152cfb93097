"""NV12 4:2:0 planes: 8-bit codes as uint8, luma drawn uniformly from the
traffic mix's ``y_codes`` and chroma from its ``c_codes``; a batch is
(y, u, v), each (n, H, W) or (n, H/2, W/2)."""

from __future__ import annotations

import torch


def _codes(shape, lo: int, hi: int, g: torch.Generator, device
           ) -> torch.Tensor:
    """Codes in [lo, hi] as uint8."""
    return torch.randint(lo, hi + 1, shape, generator=g, device=device,
                         dtype=torch.int32).to(torch.uint8)


def batch(config: dict, traffic: dict, n: int, g: torch.Generator, device
          ) -> tuple:
    src = config["video_source"]
    w, h = int(src["width"]), int(src["height"])
    (ylo, yhi), (clo, chi) = traffic["y_codes"], traffic["c_codes"]
    return (_codes((n, h, w), ylo, yhi, g, device),
            _codes((n, h // 2, w // 2), clo, chi, g, device),
            _codes((n, h // 2, w // 2), clo, chi, g, device))
