"""RGBA8 words as int32: R in bits 0-7, G in 8-15, B in 16-23, alpha in
24-31 at 255 (opaque)."""

from __future__ import annotations

import torch


def codes(words: torch.Tensor) -> torch.Tensor:
    """(H, W) words -> (3, H, W) int64 codes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(w >> (8 * i)) & 255 for i in range(3)])


def bad(words: torch.Tensor) -> int:
    """Words whose alpha byte is not 255."""
    return int((((words.to(torch.int64) & 0xFFFFFFFF) >> 24) != 255).sum()
               .item())


def pack(c: torch.Tensor) -> torch.Tensor:
    """(3, H, W) codes -> (H, W) words, alpha 255."""
    w = c[0] | (c[1] << 8) | (c[2] << 16) | (255 << 24)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
