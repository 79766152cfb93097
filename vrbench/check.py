"""Whether the timed path's outputs are correct: the surfaces of calls made
inside the window against the plain reference, frame by frame, once the
window has closed.

The configuration names its reference chain (``reference/<chain>.py``)
and its surface (``surfaces/<format>.py``); the traffic mix gives each
call's scene.  Each number is the worst over the compared frames; the
check compares those that ``limits/<cell>.json`` names, each against its
limit, and reports the others:

- ``off_share_worst``: the share of colour channels whose code differs
  from the reference's code;
- ``far_share_worst``: the share of colour channels more than ``FAR``
  codes from the reference where the reference's code is at least ``LIT``
  (above near black, where the SDR gamma's slope turns the tap order's
  rounding into several codes);
- ``surface_bad``: surface words that break the format (summed over the
  frames; exact, limit 0).

Also reported: the frames and calls compared, the mean share of channels
off, the largest code gap and the largest above near black.
"""

from __future__ import annotations

import torch

from . import gen, spec
from .reference.oracle import Arith

FAR = 2
LIT = 32


def reference_frame(config: dict, traffic: dict, planes, frame: int,
                    call: int, ar: Arith = Arith()) -> torch.Tensor:
    """The reference's codes of frame ``frame`` of call ``call``, whose
    batch of planes is ``planes``."""
    chain = spec.module("reference", config["reference"])
    return chain.frame(config, tuple(p[frame] for p in planes),
                       gen.scene(traffic, gen.scene_of(traffic, call)), ar)


def frame_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """One frame's numbers from its (3, H, W) codes and the reference's."""
    gap = (got - ref).abs()
    lit = ref >= LIT
    return {"off_share_worst": (gap > 0).double().mean().item(),
            "far_share_worst": ((gap > FAR) & lit).double().mean().item(),
            "max_code_gap": int(gap.max().item()),
            "max_code_gap_lit": int((gap * lit).max().item())}


def compare(outputs: dict, pool, config: dict, traffic: dict,
            limits: dict) -> dict:
    """``outputs``: call index -> the program's batch of surfaces.  Returns
    {"correct", "numbers": {name: {"value", "limit"}}, "info"}."""
    surface = spec.module("surfaces", config["surface"])
    worst: dict = {}
    bad = frames = 0
    off_sum = 0.0
    for call in sorted(outputs):
        words = outputs[call]
        planes = pool[gen.planes_of(traffic, call)]
        for f in range(words.shape[0]):
            ref = reference_frame(config, traffic, planes, f, call)
            got = surface.codes(words[f]).to(ref.device)
            n = frame_numbers(got, ref)
            for k, v in n.items():
                worst[k] = max(worst.get(k, v), v)
            off_sum += n["off_share_worst"]
            bad += surface.bad(words[f])
            frames += 1
    worst["surface_bad"] = bad
    numbers = {k: {"value": worst.get(k), "limit": lim}
               for k, lim in limits.items()}
    correct = frames > 0 and all(n["value"] is not None
                                 and n["value"] <= n["limit"]
                                 for n in numbers.values())
    info = {k: v for k, v in worst.items() if k not in numbers}
    return {"correct": correct, "numbers": numbers,
            "info": {"frames": frames, "calls": sorted(outputs),
                     "off_share_mean": off_sum / frames if frames else None,
                     **info}}
