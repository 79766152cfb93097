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
              >= 55 dB against the oracle;
  7. K6       raw NV12 -> Jinc2-upscaled RGBA8 vs its plain version on 2
              frames at the c3 shapes (1080p -> 4K), with and without the
              transposed store, and at c3rot's (2160 x 3840, 9/8 across,
              32/9 down, transposed) (within 1 code on < 1% of the
              channels);
  8. K5       float Jinc2 vs its plain version at (6, 1080, 1920) ->
              (2160, 3840), float (within 1e-5) and dithered (1 code, < 1%);
  9. c3       VideoProcessor 1080p NV12 -> 4K RGBA8 Jinc2, dithered, two
              distinct batches of 16: one K6 launch per call and nothing
              else, >= 55 dB against the float64 Jinc2 oracle, ms/frame;
 10. c3rot    make_frame_fn(plan, rotation=90, flip=True) of the 2160 x
              3840 plan: one K6 launch (the transposed store), bit-equal to
              the transposed unrotated surface, >= 55 dB against the
              rotated oracle;
 11. c3r270   the c3 plan with rotation 270: first its convert on 2 frames
              against the plain versions (K1 on the uint8 chroma, float
              within 2e-5; K2 with the colour matrix only, float within
              1e-5), then the route, K1 x2 + K2 x1 + K5 x1 per call and the
              rotation of the surface; >= 55 dB.
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
from videorenderer_tpu_torch.kernels import jinc2 as jk  # noqa: E402
from videorenderer_tpu_torch.kernels import resize as rk  # noqa: E402
from videorenderer_tpu_torch.oracle import oracle, oracle_jinc2  # noqa: E402
from videorenderer_tpu_torch.ops import chroma, scale  # noqa: E402
from videorenderer_tpu_torch.pipeline import (HDR10Metadata,  # noqa: E402
                                              _make_tail_epilogue,
                                              cmat_epilogue,
                                              make_frame_fn, plan_pipeline)

DEVICE = "cuda"
W, H, OW, OH = 3840, 2160, 1920, 1080     # the headline: 4K -> 1080p
C1_W, C1_H = 1920, 1080                   # c1: 1080p 1:1
C3_OW, C3_OH = 3840, 2160                 # c3: 1080p -> 4K Jinc2
PLAIN_FRAMES = 2                          # frames of the Jinc2 plain runs
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


def nv12_batch(batch: int, seed: int, dev):
    """TV-range 8-bit 1080p NV12 planes (c1, c3)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(p).to(dev) for p in (
        rng.integers(16, 236, (batch, C1_H, C1_W), dtype=np.uint8),
        rng.integers(16, 241, (batch, C1_H // 2, C1_W // 2), dtype=np.uint8),
        rng.integers(16, 241, (batch, C1_H // 2, C1_W // 2), dtype=np.uint8)))


def c3_args(rotated: bool = False):
    """c3 (bench_common.build_plan("c3")): 1080p NV12 BT.709 TV, Jinc2 to
    4K, ordered dither to 8 bits, bilinear chroma.  ``rotated``: the c3rot
    plan, a 2160-wide x 3840-high output (bench_configs.py:204-210)."""
    ow, oh = (C3_OH, C3_OW) if rotated else (C3_OW, C3_OH)
    return (Settings(upscaling=Upscaling.JINC2, use_dither=True,
                     chroma_scaling=ChromaScaling.BILINEAR),
            SourceDescriptor(format=ColorFormat.NV12, width=C1_W, height=C1_H,
                             matrix=CSP.BT_709, levels=Levels.TV),
            OutputDescriptor(width=ow, height=oh, bits=8))


def count_launches(fn):
    """Run ``fn`` with every launch count at 0 first; returns its result
    and the counts it made."""
    torch.cuda.synchronize()
    rk.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(rk.launches)


def only(**counts) -> dict:
    """The launch counts of a call that launches these kernels and no
    other."""
    return {k: counts.get(k, 0) for k in rk.launches}


def code_diff(a: torch.Tensor, b: torch.Tensor, bits: int) -> dict:
    d = (codes(a, bits) - codes(b, bits)).abs()
    return {"max_code_diff": int(d.max().item()),
            "frac_differing": float((d > 0).double().mean().item())}


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
    if launches != only(banded_resize_last_axis=3 * calls, rows3_tail=calls):
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
    if c1_launches != only(banded_resize_last_axis=2, rows3_tail=1):
        raise AssertionError(f"c1 launches {c1_launches}")
    want = oracle(n12[0][0], n12[1][0], n12[2][0], C1_W, C1_H, bits_in=8,
                  matrix=CSP.BT_709, pq_to_sdr=False, dither_bits=8)
    db_c1 = psnr(codes(out[0], 8).double() / 255.0, want)
    if db_c1 < 55.0:
        raise AssertionError(f"c1 PSNR {db_c1} below 55 dB")
    c1_ms = cuda_ms(lambda: c1.process(n12)) / BATCH
    line("c1", batch=BATCH, psnr_db=db_c1, launches=c1_launches,
         ms_per_frame=c1_ms)

    del n12, c1, out
    torch.cuda.empty_cache()

    # 7. K6 at the c3 shapes, kernel against plain on PLAIN_FRAMES frames
    plan3 = plan_pipeline(*c3_args())
    ux3, uy3 = chroma.chroma_upsample_matrices(
        C1_W // 2, C1_H // 2, 420, ChromaScaling.BILINEAR,
        plan3.src.chroma_location)
    cmat3 = np.concatenate([np.asarray(plan3.cmat_m, np.float32),
                            np.asarray(plan3.cmat_c, np.float32)[:, None]], 1)
    j2_epi = jk.dither_epilogue(8)
    small = nv12_batch(PLAIN_FRAMES, SEED + 6, dev)
    # as the staged path calls it: the chroma normalisation in the W taps
    k6_args = (*small, rk.BandedMatrix(uy3),
               rk.BandedMatrix(ux3, pre_scale=1 / 255.0), cmat3, C3_OH, C3_OW,
               1 / 255.0, 1.0)
    # c3rot's call: the 2160-wide x 3840-high plan (9/8 across, 32/9 down),
    # stored transposed
    k6_rot_args = (*k6_args[:6], C3_OW, C3_OH, *k6_args[8:])
    k6 = {"max_code_diff": 0, "frac_differing": 0.0}
    for a, transpose in ((k6_args, False), (k6_args, True),
                         (k6_rot_args, True)):
        kw = dict(epilogue=j2_epi, pack_format="rgba8", out_transpose=transpose)
        got = jk.jinc2_convert_fused(*a, **kw)
        torch.cuda.synchronize()
        ref = jk.jinc2_convert_fused_plain(*a, **kw)
        dd = code_diff(got, ref, 8)
        k6 = {k: max(k6[k], dd[k]) for k in k6}
        del got, ref
    if k6["max_code_diff"] > 1 or k6["frac_differing"] >= 0.01:
        raise AssertionError(f"K6 disagrees with its plain version: {k6}")
    k6["max_abs_err"] = k6["max_code_diff"] / 255.0
    kw = dict(epilogue=j2_epi, pack_format="rgba8")
    k6["ms"] = cuda_ms(lambda: jk.jinc2_convert_fused(*k6_args, **kw))
    k6["plain_ms"] = cuda_ms(
        lambda: jk.jinc2_convert_fused_plain(*k6_args, **kw), reps=2)
    line("K6", frames=PLAIN_FRAMES, cases="c3, c3 transposed, c3rot",
         tolerance="<= 1 code on < 1% of channels", **k6)
    del small, k6_args, k6_rot_args

    # 8. K5 at (6, 1080, 1920) -> (2160, 3840) float32
    rng = np.random.default_rng(SEED + 7)
    x5 = torch.from_numpy(rng.random((3 * PLAIN_FRAMES, C1_H, C1_W),
                                     dtype=np.float32)).to(dev)
    got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW)
    torch.cuda.synchronize()
    k5 = {"max_abs_err": (got - jk.jinc2_resize_fused_plain(
        x5, C3_OH, C3_OW)).abs().max().item()}
    got = jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi)
    torch.cuda.synchronize()
    ref = jk.jinc2_resize_fused_plain(x5, C3_OH, C3_OW, j2_epi)
    d = ((got - ref) * 255.0).abs().round()
    k5["max_code_diff"] = int(d.max().item())
    k5["frac_differing"] = float((d > 0).double().mean().item())
    del got, ref, d
    if k5["max_abs_err"] > 1e-5 or k5["max_code_diff"] > 1 \
            or k5["frac_differing"] >= 0.01:
        raise AssertionError(f"K5 disagrees with its plain version: {k5}")
    k5["ms"] = cuda_ms(lambda: jk.jinc2_resize_fused(x5, C3_OH, C3_OW, j2_epi))
    k5["plain_ms"] = cuda_ms(
        lambda: jk.jinc2_resize_fused_plain(x5, C3_OH, C3_OW, j2_epi), reps=2)
    line("K5", planes=3 * PLAIN_FRAMES,
         tolerance="float <= 1e-5; dithered <= 1 code on < 1%", **k5)
    del x5
    torch.cuda.empty_cache()

    # 9. c3 through VideoProcessor: two distinct batches of 16
    c3_batches = [nv12_batch(BATCH, SEED + 8 + i, dev) for i in range(2)]
    c3 = VideoProcessor(*c3_args(), device=dev, pack_surface=True)
    c3.process(c3_batches[0])                   # warm-up, before the count
    c3_times = []

    def c3_run():
        outs = []
        for b in c3_batches:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs.append(c3.process(b))
            t1.record()
            torch.cuda.synchronize()
            c3_times.append(t0.elapsed_time(t1))
        return outs

    c3_outs, c3_launches = count_launches(c3_run)
    if c3_launches != only(jinc2_convert_fused=len(c3_batches)):
        raise AssertionError(f"c3 launches {c3_launches}")
    for o in c3_outs:
        if o.shape != (BATCH, C3_OH, C3_OW) or o.dtype != torch.int32:
            raise AssertionError(f"c3 output {tuple(o.shape)} {o.dtype}")
    b0 = c3_batches[0]
    db_c3 = psnr(codes(c3_outs[0][0], 8).double() / 255.0,
                 oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OW, C3_OH))
    if db_c3 < 55.0:
        raise AssertionError(f"c3 PSNR {db_c3} below 55 dB")
    c3_ms = sum(c3_times) / (len(c3_times) * BATCH)
    line("c3", batch=BATCH, calls=len(c3_batches), launches=c3_launches,
         psnr_db=db_c3, ms_per_frame=c3_ms,
         ms_per_frame_back_to_back=cuda_ms(
             lambda: [c3.process(b) for b in c3_batches], reps=1,
             warmup=0) / (len(c3_batches) * BATCH))
    del c3_outs

    # 10. c3rot: the 2160 x 3840 plan, rotation 90 + flip (a pure transpose)
    plan_rot = plan_pipeline(*c3_args(rotated=True))
    rot_fn = make_frame_fn(plan_rot, pack_surface=True, rotation=90, flip=True)
    rot_fn(b0)                                  # warm-up, before the count
    rot_out, rot_launches = count_launches(lambda: rot_fn(b0))
    if rot_launches != only(jinc2_convert_fused=1):
        raise AssertionError(f"c3rot launches {rot_launches}")
    if rot_out.shape != (BATCH, C3_OH, C3_OW):
        raise AssertionError(f"c3rot output {tuple(rot_out.shape)}")
    flat = make_frame_fn(plan_rot, pack_surface=True)(b0)
    rot_bit_equal = bool(torch.equal(rot_out, flat.transpose(-2, -1)))
    del flat
    if not rot_bit_equal:
        raise AssertionError("c3rot is not the transposed unrotated surface")
    db_rot = psnr(codes(rot_out[0], 8).double() / 255.0,
                  oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OH, C3_OW,
                               rotation=90, flip=True))
    if db_rot < 55.0:
        raise AssertionError(f"c3rot PSNR {db_rot} below 55 dB")
    rot_ms = cuda_ms(lambda: rot_fn(b0), reps=3) / BATCH
    line("c3rot", batch=BATCH, launches=rot_launches, psnr_db=db_rot,
         bit_equal_to_transpose=rot_bit_equal, ms_per_frame=rot_ms)
    del rot_out

    # 11. c3 with rotation 270: the staged route K1 x2, K2, K5, then rotate.
    #     First its convert against the plain versions on PLAIN_FRAMES
    #     frames: K1 on the uint8 chroma (float out, the normalisation in
    #     the taps), then K2 reading the uint8 luma with the colour matrix
    #     only, float out (K5 at these shapes is phase 8)
    yc, uc, vc = (p[:PLAIN_FRAMES] for p in b0)
    kw_c3 = rk.BandedMatrix(ux3, pre_scale=1 / 255.0)
    conv = {"k1_max_abs_err": 0.0}
    for plane in (uc, vc):
        got = rk.banded_resize_last_axis(plane, kw_c3)
        torch.cuda.synchronize()
        ref = rk.banded_resize_last_axis_plain(plane, kw_c3)
        conv["k1_max_abs_err"] = max(conv["k1_max_abs_err"],
                                     (got - ref).abs().max().item())
        del got, ref
    uw = rk.banded_resize_last_axis_plain(uc, kw_c3)
    vw = rk.banded_resize_last_axis_plain(vc, kw_c3)
    k2_args = (yc, uw, vw, None, rk.BandedMatrix(uy3), C1_H,
               cmat_epilogue(cmat3))
    got = rk.rows3_tail(*k2_args, y_scale=1 / 255.0)
    torch.cuda.synchronize()
    ref = rk.rows3_tail_plain(*k2_args, y_scale=1 / 255.0)
    conv["k2_max_abs_err"] = (got - ref).abs().max().item()
    del got, ref, uw, vw, k2_args, yc, uc, vc
    if conv["k1_max_abs_err"] > 2e-5 or conv["k2_max_abs_err"] > 1e-5:
        raise AssertionError(
            f"the rotation-270 convert disagrees with its plain version: {conv}")
    line("c3r270_convert", frames=PLAIN_FRAMES,
         tolerance="K1 f32 <= 2e-5, K2 f32 <= 1e-5", **conv)

    r270_fn = make_frame_fn(plan3, pack_surface=True, rotation=270)
    r270_fn(b0)                                 # warm-up, before the count
    r270_out, r270_launches = count_launches(lambda: r270_fn(b0))
    if r270_launches != only(banded_resize_last_axis=2, rows3_tail=1,
                             jinc2_resize_fused=1):
        raise AssertionError(f"c3 rotation 270 launches {r270_launches}")
    db_270 = psnr(codes(r270_out[0], 8).double() / 255.0,
                  oracle_jinc2(b0[0][0], b0[1][0], b0[2][0], C3_OW, C3_OH,
                               rotation=270))
    if db_270 < 55.0:
        raise AssertionError(f"c3 rotation 270 PSNR {db_270} below 55 dB")
    r270_ms = cuda_ms(lambda: r270_fn(b0), reps=3) / BATCH
    line("c3r270", batch=BATCH, launches=r270_launches, psnr_db=db_270,
         ms_per_frame=r270_ms)
    del r270_out, c3_batches, b0
    torch.cuda.empty_cache()

    kernels = [
        {"name": "banded_resize_last_axis", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/banded_resize.cu",
         "replaces": "videorenderer_tpu/kernels/resize_pallas.py:261",
         "launches": launches["banded_resize_last_axis"],
         "max_abs_err": max(k1["max_abs_err"], conv["k1_max_abs_err"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "rows3_tail", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/rows3_tail.cu",
         "replaces": "videorenderer_tpu/kernels/resize_pallas.py:834",
         "launches": launches["rows3_tail"],
         "max_abs_err": max(k2["max_abs_err"], conv["k2_max_abs_err"]),
         "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
        {"name": "jinc2_resize_fused", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/jinc2_resize.cu",
         "replaces": "videorenderer_tpu/kernels/jinc2_pallas.py:242",
         "launches": r270_launches["jinc2_resize_fused"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"]},
        {"name": "jinc2_convert_fused", "route": "cuda",
         "source": "videorenderer_tpu_torch/csrc/jinc2_convert.cu",
         "replaces": "videorenderer_tpu/kernels/jinc2_pallas.py:705",
         "launches": (c3_launches["jinc2_convert_fused"]
                      + rot_launches["jinc2_convert_fused"]),
         "max_abs_err": k6["max_abs_err"], "ms": k6["ms"],
         "plain_ms": k6["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
