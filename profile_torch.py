#!/usr/bin/env python3
"""Where the device time of the port's configurations goes, on one NVIDIA
card.

    python3 profile_torch.py [c8] [letterbox] [c7] [c7plain] [c3sr] [c1vh]
                             [train_sr] [train_hdr]

Each configuration is driven as ``chip_smoke.py`` drives it (batch 16, or
c3sr's 8 and c1vh's 32, through the renderer with the shipped weights;
full width; train_sr and train_hdr: one step of the trainers' loop,
``models.optim.train_step``, at phases 39-40's width, batch and patch, on
one batch already on the card): a warm-up call, then ``CALLS`` calls back
to back under
``torch.profiler`` ending in one synchronise.  One JSON line each: the
traced window's span (host-marked), the union of the device's kernel
intervals over it (the busy share; in brackets the same union over the
device's own first-to-last span) and the device time by kernel, largest
first.  Then nvidia-smi's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import sys

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs
from videorenderer_tpu_torch import VideoProcessor, make_serving_fn
from videorenderer_tpu_torch.models import hdr_train, optim, sr_train
from videorenderer_tpu_torch.pipeline import plan_pipeline

CALLS = 4


def _short(name: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters: the first identifier followed by "<" or "("."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]",
                  name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def _union(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_calls(fn) -> dict:
    fn()                                          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events if e.name == "window")
    w0, w1 = window.time_range.start, window.time_range.end
    # the device's kernels and copies, not the annotations mirrored on the
    # device's timeline (the window's, the optimiser's step)
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "window" and not e.is_user_annotation
           and w0 <= e.time_range.start <= w1]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_kernel: dict = {}
    for e in dev:
        k = _short(e.name)
        by_kernel[k] = by_kernel.get(k, 0.0) + e.time_range.elapsed_us()
    busy = _union(spans)
    device_span = (max(b for _, b in spans) - min(a for a, _ in spans)
                   if spans else 0.0)
    total = sum(by_kernel.values()) or 1.0
    return {"calls": CALLS, "window_ms": (w1 - w0) / 1e3,
            "device_busy_share": busy / (w1 - w0),
            "device_busy_share_own_span": busy / device_span
            if device_span else 0.0,
            "device_ms_by_kernel": {k: v / 1e3 for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])},
            "device_share_by_kernel": {k: v / total for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])}}


def train_batch(dev, name: str):
    """(inputs, targets, step): a batch of phase 39's or 40's data on the
    card and a training step of the full-width model from init_params
    (float32 masters, Adam under the trainers' schedule)."""
    sr = name == "train_sr"
    cfg = cs.SR_TRAIN_CFG if sr else cs.VH_TRAIN_CFG
    mod = cs.sr_model if sr else cs.vh_model
    if sr:
        hr = sr_train.synth_frames(cs.SEED, cs.TRAIN_BATCH, cs.TRAIN_PATCH)
        x, y, loss_fn = sr_train.degrade(hr), hr, cs.sr_model.loss_fn
    else:
        hdr = hdr_train.synth_hdr_frames(cs.SEED, cs.TRAIN_BATCH,
                                         cs.TRAIN_PATCH, cfg)
        x, y = hdr_train.degrade_to_sdr(hdr, cfg), hdr_train.hdr_truth_pq(
            hdr, cfg)
        loss_fn = hdr_train.loss_fn
    model = mod.init_params(torch.Generator().manual_seed(cs.SEED), cfg) \
        .to(dev, torch.float32)
    opt = optim.Adam(model.parameters(), optim.lr_schedule(
        cs.TRAIN_STEPS, cs.TRAIN_LR, 0.3))
    return (torch.tensor(x, device=dev), torch.tensor(y, device=dev),
            optim.train_step(model, loss_fn, opt))


def main(names) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch.py needs an NVIDIA card")
    dev = torch.device("cuda")
    for name in names:
        if name == "c8":
            serve = make_serving_fn(plan_pipeline(*cs.c8_args(cs.dovi_meta())),
                                    pack_surface=True)
            batch = cs.p010_batch(cs.BATCH, cs.SEED + 20, dev)
            rt = {"dovi_curves": cs.dovi_rt(1)}
            out = profile_calls(lambda: serve(batch, rt))
        elif name in ("c7", "c7plain"):
            serve = make_serving_fn(
                plan_pipeline(*cs.c7_args(accel=name == "c7")),
                pack_surface=True)
            batch = cs.p010_batch(cs.BATCH, cs.SEED + 50, dev)
            rt = cs.c7_rt(1)
            out = profile_calls(lambda: serve(batch, rt))
        elif name == "letterbox":
            vp = VideoProcessor(
                cs.Settings(upscaling=cs.Upscaling.LANCZOS3,
                            convert_to_sdr=True),
                cs.SourceDescriptor(
                    format=cs.ColorFormat.P010, width=cs.W, height=cs.LB_H,
                    matrix=cs.CSP.BT_2020_NC, levels=cs.Levels.TV,
                    primaries=cs.Primaries.BT_2020, transfer=cs.TRC.PQ,
                    hdr10=cs.HDR10Metadata()),
                cs.OutputDescriptor(width=cs.OW, height=cs.OH, bits=10,
                                    video_rect=cs.LB_RECT),
                device=dev, pack_surface=True)
            batch = cs.p010_batch(cs.BATCH, cs.SEED + 30, dev, h=cs.LB_H)
            out = profile_calls(lambda: vp.process(batch))
        elif name in ("c3sr", "c1vh"):
            vr = cs.model_renderer(dev, name)[0]
            batch = cs.nv12_batch(cs.SR_BATCH if name == "c3sr"
                                  else cs.VH_BATCH, cs.SEED + 150, dev)
            out = profile_calls(lambda: vr.process_frame(batch))
        elif name in ("train_sr", "train_hdr"):
            batch = train_batch(dev, name)
            out = profile_calls(lambda: batch[2](batch[0], batch[1]))
        else:
            raise ValueError(f"unknown configuration {name!r}")
        print(json.dumps({"config": name, "batch": batch[0].shape[0],
                          **out}), flush=True)
    print(cs.smi())


if __name__ == "__main__":
    main(sys.argv[1:] or ["c8", "letterbox", "c7", "c7plain"])
