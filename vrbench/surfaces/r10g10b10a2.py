"""R10G10B10A2 words as int32: R in bits 0-9, G in 10-19, B in 20-29, the
two alpha bits set (opaque)."""

from __future__ import annotations

import torch


def codes(words: torch.Tensor) -> torch.Tensor:
    """(H, W) words -> (3, H, W) int64 codes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(w >> (10 * i)) & 1023 for i in range(3)])


def bad(words: torch.Tensor) -> int:
    """Words whose alpha is not opaque."""
    return int((((words.to(torch.int64) & 0xFFFFFFFF) >> 30) != 3).sum()
               .item())


def pack(c: torch.Tensor) -> torch.Tensor:
    """(3, H, W) codes -> (H, W) words, alpha set."""
    w = c[0] | (c[1] << 10) | (c[2] << 20) | (3 << 30)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
