#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device   the card's name, and nvidia-smi's name and power limit;
  2. build    nvcc builds the kernels from videorenderer_tpu_torch/csrc;
  3. K1       banded W resize vs its plain version at the 4K headline shapes
              (mid16 codes within 1, float32 within 2e-5);
  4. K2       H resize + tail vs its plain version at the headline shapes,
              headline epilogue, R10G10B10A2 (within 1 code on < 2%);
  5. slice    VideoProcessor 4K P010 HDR10 -> 1080p SDR RGB10, three
              distinct batches of 16 frames and one of 1: >= 55 dB against
              the float64 oracle, K1 launched 3 times and K2 once per call,
              ms/frame of the kernel path and of the plain path;
  6. c1       1080p NV12 -> RGBA8 1:1 dithered (K2 reads the luma directly):
              >= 55 dB against the oracle.
Then the kernels' JSON line, nvidia-smi's line, and last the result line.
Any failure raises and the exit code is not 0.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videorenderer_tpu_torch import (ColorFormat, OutputDescriptor,  # noqa: E402
                                     Settings, SourceDescriptor,
                                     VideoProcessor)
from videorenderer_tpu_torch.config import ChromaScaling, Upscaling  # noqa: E402
from videorenderer_tpu_torch.csputils import CSP, Levels, Primaries, TRC  # noqa: E402
from videorenderer_tpu_torch.kernels import build  # noqa: E402
from videorenderer_tpu_torch.kernels import resize as rk  # noqa: E402
from videorenderer_tpu_torch.oracle import oracle  # noqa: E402
from videorenderer_tpu_torch.ops import chroma, scale  # noqa: E402
from videorenderer_tpu_torch.pipeline import (HDR10Metadata,  # noqa: E402
                                              _make_tail_epilogue,
                                              plan_pipeline)

DEVICE = "cuda"
W, H, OW, OH = 3840, 2160, 1920, 1080     # the headline: 4K -> 1080p
C1_W, C1_H = 1920, 1080                   # c1: 1080p 1:1
BATCH = 16
SEED = 0


def line(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of one ``fn()`` call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def p010_batch(batch: int, seed: int, dev):
    """TV-range 10-bit codes, MSB-aligned in uint16 (bench.py's frames)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(64, 941, (batch, H, W), dtype=np.uint16) << 6
    u = rng.integers(64, 961, (batch, H // 2, W // 2), dtype=np.uint16) << 6
    v = rng.integers(64, 961, (batch, H // 2, W // 2), dtype=np.uint16) << 6
    return tuple(torch.from_numpy(p).to(dev) for p in (y, u, v))


def codes(dwords: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., H, W) packed dwords -> (..., 3, H, W) int32 channel codes."""
    mask = (1 << bits) - 1
    return torch.stack([(dwords >> (bits * i)) & mask for i in range(3)], -3)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def headline_args():
    src = SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                           matrix=CSP.BT_2020_NC, levels=Levels.TV,
                           primaries=Primaries.BT_2020, transfer=TRC.PQ,
                           hdr10=HDR10Metadata())
    dst = OutputDescriptor(width=OW, height=OH, bits=10)
    return src, dst


def headline_settings(accel: bool) -> Settings:
    return Settings(upscaling=Upscaling.LANCZOS3,
                    chroma_scaling=ChromaScaling.BILINEAR,
                    convert_to_sdr=True, use_dither=True,
                    use_accel_backend=accel)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs an NVIDIA card: CUDA is not "
                           "available")
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    line("device", name=name, nvidia_smi=smi(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    t = time.perf_counter()
    lib = build.build()
    build.load()
    line("build", seconds=round(time.perf_counter() - t, 3), library=str(lib))

    # 3. K1 at the headline shapes: luma (B,2160,3840) and chroma
    #    (B,1080,1920) uint16 -> 1920 columns
    src, dst = headline_args()
    y, u, v = p010_batch(BATCH, SEED, dev)
    plan = plan_pipeline(headline_settings(True), src, dst)
    wx = scale.upscale_matrix(Upscaling.LANCZOS3, W, OW)
    wy = scale.upscale_matrix(Upscaling.LANCZOS3, H, OH)
    ux, uy = chroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, ChromaScaling.BILINEAR, plan.src.chroma_location)
    norm = 1.0 / 65535.0
    kw_y = rk.BandedMatrix(wx, pre_scale=norm)
    kw_c = rk.BandedMatrix(ux @ wx, pre_scale=norm)
    k1 = {"max_code_diff": 0, "max_abs_err": 0.0}
    mids = []
    for plane, mat in ((y, kw_y), (u, kw_c), (v, kw_c)):
        for mid16 in (True, False):
            got = rk.banded_resize_last_axis(plane, mat, mid16=mid16)
            torch.cuda.synchronize()
            ref = rk.banded_resize_last_axis_plain(plane, mat, mid16=mid16)
            err = (got.float() - ref.float()).abs().max().item()
            if mid16:
                k1["max_code_diff"] = max(k1["max_code_diff"], int(err))
                mids.append(got)
            else:
                k1["max_abs_err"] = max(k1["max_abs_err"], err)
            del got, ref
    if k1["max_code_diff"] > 1 or k1["max_abs_err"] > 2e-5:
        raise AssertionError(f"K1 disagrees with its plain version: {k1}")

    def k1_all(f):
        return lambda: [f(p, m, True) for p, m in ((y, kw_y), (u, kw_c),
                                                   (v, kw_c))]
    k1["ms"] = cuda_ms(k1_all(rk.banded_resize_last_axis))
    k1["plain_ms"] = cuda_ms(k1_all(rk.banded_resize_last_axis_plain))
    line("K1", batch=BATCH, tolerance="mid16 <= 1 code, f32 <= 2e-5", **k1)

    # 4. K2 at the headline shapes on the K1 mid16 planes, headline epilogue
    unscale = 1.0 / rk.MID16_SCALE
    kh_y = rk.BandedMatrix(wy, pre_scale=unscale)
    kh_c = rk.BandedMatrix(uy @ wy, pre_scale=unscale)
    epi = _make_tail_epilogue(plan)
    args = (*mids, kh_y, kh_c, OH, epi)
    got = rk.rows3_tail(*args, pack_format="rgb10a2")
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*args, pack_format="rgb10a2")
    d = (codes(got, 10) - codes(ref, 10)).abs()
    k2 = {"max_code_diff": int(d.max().item()),
          "frac_differing": float((d > 0).double().mean().item()),
          "alpha_ok": bool(torch.equal(got >> 30, ref >> 30))}
    del got, ref, d
    if k2["max_code_diff"] > 1 or k2["frac_differing"] >= 0.02 \
            or not k2["alpha_ok"]:
        raise AssertionError(f"K2 disagrees with its plain version: {k2}")
    k2["max_abs_err"] = k2["max_code_diff"] / 1023.0
    k2["ms"] = cuda_ms(lambda: rk.rows3_tail(*args, pack_format="rgb10a2"))
    k2["plain_ms"] = cuda_ms(
        lambda: rk.rows3_tail_plain(*args, pack_format="rgb10a2"))
    line("K2", batch=BATCH, tolerance="<= 1 code on < 2% of channels", **k2)
    del mids, args, y, u, v
    torch.cuda.empty_cache()

    # 5. the slice through VideoProcessor
    batches = [p010_batch(BATCH, SEED + 1 + i, dev) for i in range(3)]
    single = p010_batch(1, SEED + 4, dev)
    vp = VideoProcessor(headline_settings(True), src, dst, device=dev,
                        pack_surface=True)
    vp.process(batches[0])                      # warm-up, before the count
    torch.cuda.synchronize()
    rk.reset_launches()
    outs, times = [], []
    for b in batches + [single]:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = vp.process(b)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        outs.append(out)
    launches = dict(rk.launches)
    calls = len(batches) + 1
    if launches != {"banded_resize_last_axis": 3 * calls, "rows3_tail": calls}:
        raise AssertionError(f"main path launches {launches} for {calls} calls")
    for o, b in zip(outs, batches + [single]):
        if o.shape != (b[0].shape[0], OH, OW) or o.dtype != torch.int32:
            raise AssertionError(f"output {tuple(o.shape)} {o.dtype}")
    ref0 = oracle(batches[0][0][0], batches[0][1][0], batches[0][2][0], OW, OH)
    db = psnr(codes(outs[0][0], 10).double() / 1023.0, ref0)
    db_single = psnr(codes(outs[3][0], 10).double() / 1023.0,
                     oracle(single[0][0], single[1][0], single[2][0], OW, OH))
    del outs
    plain_vp = VideoProcessor(headline_settings(False), src, dst, device=dev,
                              pack_surface=True)
    plain_out = plain_vp.process(batches[0])
    db_plain = psnr(codes(plain_out[0], 10).double() / 1023.0, ref0)
    del plain_out
    ms_kernel = sum(times[:3]) / (3 * BATCH)
    ms_plain = cuda_ms(lambda: [plain_vp.process(b) for b in batches],
                       reps=1, warmup=0) / (3 * BATCH)
    if min(db, db_single, db_plain) < 55.0:
        raise AssertionError(f"PSNR below 55 dB: {db}, {db_single}, {db_plain}")
    line("slice", batch=BATCH, calls=calls, launches=launches,
         psnr_db=db, psnr_db_batch1=db_single, psnr_db_plain=db_plain,
         ms_per_frame=ms_kernel, plain_ms_per_frame=ms_plain,
         ms_batch1=times[3])
    del batches, single, plain_vp, vp
    torch.cuda.empty_cache()

    # 6. c1: 1080p NV12 -> RGBA8 1:1, dithered, packed
    rng = np.random.default_rng(SEED + 5)
    n12 = tuple(torch.from_numpy(p).to(dev) for p in (
        rng.integers(16, 236, (BATCH, C1_H, C1_W), dtype=np.uint8),
        rng.integers(16, 241, (BATCH, C1_H // 2, C1_W // 2), dtype=np.uint8),
        rng.integers(16, 241, (BATCH, C1_H // 2, C1_W // 2), dtype=np.uint8)))
    c1 = VideoProcessor(
        Settings(chroma_scaling=ChromaScaling.BILINEAR),
        SourceDescriptor(format=ColorFormat.NV12, width=C1_W, height=C1_H,
                         matrix=CSP.BT_709, levels=Levels.TV),
        OutputDescriptor(width=C1_W, height=C1_H, bits=8), device=dev,
        pack_surface=True)
    rk.reset_launches()
    out = c1.process(n12)
    torch.cuda.synchronize()
    c1_launches = dict(rk.launches)
    if c1_launches != {"banded_resize_last_axis": 2, "rows3_tail": 1}:
        raise AssertionError(f"c1 launches {c1_launches}")
    want = oracle(n12[0][0], n12[1][0], n12[2][0], C1_W, C1_H, bits_in=8,
                  matrix=CSP.BT_709, pq_to_sdr=False, dither_bits=8)
    db_c1 = psnr(codes(out[0], 8).double() / 255.0, want)
    if db_c1 < 55.0:
        raise AssertionError(f"c1 PSNR {db_c1} below 55 dB")
    c1_ms = cuda_ms(lambda: c1.process(n12)) / BATCH
    line("c1", batch=BATCH, psnr_db=db_c1, launches=c1_launches,
         ms_per_frame=c1_ms)

    kernels = [
        {"name": "banded_resize_last_axis", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/banded_resize.cu",
         "replaces": "videorenderer_tpu/kernels/resize_pallas.py:261",
         "launches": launches["banded_resize_last_axis"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "rows3_tail", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/rows3_tail.cu",
         "replaces": "videorenderer_tpu/kernels/resize_pallas.py:834",
         "launches": launches["rows3_tail"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
