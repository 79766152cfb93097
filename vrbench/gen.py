"""The one traffic generator: it reads a traffic mix's data file
(``traffic/<name>.json``) and makes, from ``--seed``, the inputs and the
order of the calls.

A mix is a closed loop of calls that keeps ``depth`` calls in flight, each
call ``batch`` frames, taken in turn from a pool of ``pool`` distinct
batches that live on the device.  The frames are drawn by the module of
the configuration's source format (``frames/<format>.py``) from the mix's
parameters.  A mix with ``scenes`` carries per-scene metadata: scene ``i``
is the mix's ``scenes.data`` with every number under the keys listed in
``scenes.scaled`` times ``1 - scenes.scale_step * i``; a new scene begins
every ``scenes.calls`` calls, and ``scenes.count`` scenes cycle.

Every seed gives the same sizes, calls and scenes; the seed draws the
frames and which calls the check compares.
"""

from __future__ import annotations

import copy
import random

import torch

from . import spec


def make_pool(traffic: dict, config: dict, seed: int, device) -> list:
    """``pool`` batches of planes, drawn on ``device`` from one generator
    seeded with ``seed``, batch after batch."""
    frames = spec.module("frames", config["video_source"]["format"].lower())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [frames.batch(config, traffic, int(traffic["batch"]), g, device)
            for _ in range(int(traffic["pool"]))]


def planes_of(traffic: dict, call: int) -> int:
    """The pool batch of call ``call``."""
    return call % int(traffic["pool"])


def scene_of(traffic: dict, call: int) -> int | None:
    """The scene of call ``call``, None for a mix without scenes."""
    if "scenes" not in traffic:
        return None
    s = traffic["scenes"]
    return (call // int(s["calls"])) % int(s["count"])


def _scaled(x, f: float):
    if isinstance(x, list):
        return [_scaled(v, f) for v in x]
    if isinstance(x, dict):
        return {k: _scaled(v, f) for k, v in x.items()}
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return x * f
    return x


def scene(traffic: dict, index: int | None) -> dict | None:
    """Scene ``index``'s metadata (None for None)."""
    if index is None:
        return None
    s = traffic["scenes"]
    f = 1.0 - float(s["scale_step"]) * index
    data = copy.deepcopy(s["data"])
    for key in s["scaled"]:
        data[key] = _scaled(data[key], f)
    return data


def checked_calls(traffic: dict, seed: int) -> list[int]:
    """The calls of the window whose outputs the check compares, besides
    the window's last complete call: ``checked_calls`` distinct calls among
    the first ``check_from`` of the window, drawn from the seed; in a mix
    with scenes the first of them begins a scene other than the first."""
    rng = random.Random(int(seed))
    n, span = int(traffic["checked_calls"]), int(traffic["check_from"])
    calls = []
    if "scenes" in traffic:
        step = int(traffic["scenes"]["calls"])
        calls.append(step * rng.randrange(1, span // step))
    while len(calls) < n:
        k = rng.randrange(span)
        if k not in calls:
            calls.append(k)
    return sorted(calls)
