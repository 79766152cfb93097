"""Faults planted under the harness, in an entry's calls, for the tests
that see ``correct`` come out false:

- ``state_unchanged``: a call returns the state it was handed, the
  previous call's surface;
- ``half_batch``: half of the batch left out, its frames never rendered;
- ``answer_altered``: one frame of every call, one code of each colour
  off by one where it is produced;
- ``tile_misplaced``: one tile of one frame of every call (16 rows x 128
  columns at the frame's centre, a quarter of each side at most) holds the
  words of the tile to its left, as a store at a wrong offset writes;
- ``stale_scene`` (a mix with scenes): the first scene's metadata kept
  through every scene change.

The cells run on one card, so no exchange between cards can be left
out."""

from __future__ import annotations

import torch

from vrbench import spec
from vrbench.entries import common

FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "tile_misplaced")


def tile_misplaced(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    h, w = out.shape[-2:]
    th, tw = min(16, h // 4), min(128, w // 4)
    r, c = (h // 2) // th * th, (w // 2) // tw * tw
    out[-1, r:r + th, c:c + tw] = out[-1, r:r + th, c - tw:c]
    return out


def broken(fault: str, build):
    """``build`` whose entry's calls carry ``fault``."""
    def make(config, traffic, device):
        if fault == "stale_scene":
            traffic = dict(traffic, scenes=dict(traffic["scenes"],
                                                scale_step=0.0))
        entry = build(config, traffic, device)
        last = {}

        def call(planes, index, span):
            out = entry.call(planes, index)
            if fault == "state_unchanged":
                prev = last.get("out", torch.zeros_like(out))
                last["out"] = out
                return prev
            if fault == "half_batch":
                out = out.clone()
                out[out.shape[0] // 2:] = 0
            elif fault == "answer_altered":
                out = out.clone()
                out[-1] = out[-1] ^ (1 | (1 << 10) | (1 << 20))
            elif fault == "tile_misplaced":
                out = tile_misplaced(out)
            return out
        return common.Entry(call)
    return make


def plant(monkeypatch, cell: str, fault: str | None) -> None:
    """Builds cell ``cell``'s entry with ``fault`` from now on."""
    if fault is None:
        return
    mod = spec.module("entries", spec.load_cell(cell).config["entry"])
    monkeypatch.setattr(mod, "build", broken(fault, mod.build))


def faults_of(cell: str) -> list[str]:
    """The faults cell ``cell`` can have."""
    scenes = "scenes" in spec.load_cell(cell).traffic
    return list(FAULTS) + (["stale_scene"] if scenes else [])
