#!/usr/bin/env python3
"""Stage-level attribution of the fused chain on one NVIDIA card: the
PyTorch/CUDA port's counterpart of ``bench_headline_micro.py``.

    python3 torch_headline_micro.py [--batch 16] [--plan headline|c7]
                                    [--probe-wpass]

The stages are the dispatches of the fused kernel route (K1 then K2), each
timed alone on the same inputs:

  yW          K1 on the luma, float32 out (absent where the luma has no W
              map, as c7's: K2 then reads the raw luma directly)
  cW          K1 on both chroma planes (the chroma upsample composed with
              the resize), float32 out
  tail        K2 alone on the yW/cW planes: H taps, colour matrix, the
              transfer tower (corrections, tone map), dither and pack
  tailID      K2 with the colour matrix only, the same pack
  tailH       K2 with no colour matrix, correction, tone map or dither, the
              same pack: the H taps and the store alone
  tailNoPack  K2 with the whole tail, float32 RGB out
  full        the production chain (mid16 intermediates, packed)

One JSON line per stage, then the attribution: ``stages_sum_ms`` (yW + cW +
tail), ``full_ms``, ``tower_ms`` (tail - tailID), ``pack_ms`` (tail -
tailNoPack), and, with tailH, ``h_store_ms`` (tailH) and ``matrix_ms``
(tailID - tailH), all per frame.

``--probe-wpass`` takes the luma W pass apart instead:

  yW          the production K1, mid16 out
  yW1         K10 ``wpass_bf16``: one bf16 band product, float32 sum
  yWsplit     K10 ``wpass_floor``: every input byte read and rounded to
              bf16, the first W_out columns written as float32
  memcpy      a device-to-device ``copy_`` of the same input bytes: the
              memory rate a library copy reaches (a yardstick, not a port)

``--plan``: the headline (4K P010 PQ -> 1080p RGB10, Lanczos3, Hable,
dither) or c7 (4K P010 HDR10 -> 4K RGB10 PQ, the BT.2390 local tone map
with the plan's metadata; ``chip_smoke.c7_args``).  The inputs are
``chip_smoke.p010_batch`` frames from seed 0.  Device times from CUDA
events (``chip_smoke.cuda_ms``).  Ends with nvidia-smi's name and power
limit.  Raises without a card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs
from videorenderer_tpu_torch.config import TexFormat
from videorenderer_tpu_torch.kernels import probe as pk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.pipeline import (_make_fused_fn,
                                              _make_tail_epilogue,
                                              cmat_epilogue, fused_maps,
                                              fused_plane_pass, plan_pipeline,
                                              surface_pack_format)

PLANS = ("headline", "c7")
REPS = 8
MEMCPY_NOTE = ("torch copy_ of the same input bytes: the memory rate a "
               "library copy reaches (a yardstick, not a port)")


def plan_for(name: str, tex_format: TexFormat = TexFormat.AUTOINT):
    """The headline's or c7's plan, as ``chip_smoke.py`` drives it."""
    if name == "headline":
        return plan_pipeline(cs.headline_settings(True, tex_format),
                             *cs.headline_args())
    if name == "c7":
        return plan_pipeline(*cs.c7_args(tex_format=tex_format))
    raise ValueError(f"unknown plan {name!r}: one of {PLANS}")


def wpass_probe(y: torch.Tensor, mat: rk.BandedMatrix) -> dict:
    """The forms of the W-pass probe on uint16 luma ``y`` (..., W_in) with
    the W map ``mat`` (normalisation folded in), as zero-argument
    callables: yW, yW1, yWsplit and the memcpy yardstick."""
    copy = torch.empty_like(y)
    return {"yW": lambda: rk.banded_resize_last_axis(y, mat, mid16=True),
            "yW1": lambda: pk.wpass_bf16(y, mat),
            "yWsplit": lambda: pk.wpass_floor(y, mat.out_size),
            "memcpy": lambda: copy.copy_(y)}


def stages(plan, planes) -> dict:
    """The stages of ``plan``'s fused kernel route on ``planes`` (y, u, v),
    as zero-argument callables, built from :func:`pipeline.fused_maps` and
    :func:`pipeline.fused_plane_pass` as the route builds them, with float32
    W-pass outputs.  The W passes run once here; the tail stages read their
    outputs."""
    if plan.dovi is not None or plan.dst.video_rect is not None \
            or not plan.apply_matrix or not plan.settings.use_accel_backend:
        raise ValueError("the stage split takes a plan of the fused K1 + K2 "
                         "route (no Dolby Vision, no video_rect, a colour "
                         "matrix, use_accel_backend)")
    wx, wy, cwx, cwy, norm = fused_maps(plan)
    kw_y, kh_y, y_scale = fused_plane_pass(wx, wy, norm, False)
    kw_c, kh_c, c_scale = fused_plane_pass(cwx, cwy, norm, False)
    fmt = surface_pack_format(plan.dst)
    h_out = plan.dst.video_size[1]
    epi = _make_tail_epilogue(plan)
    epi_id = cmat_epilogue(np.concatenate(
        [np.asarray(plan.cmat_m, np.float32),
         np.asarray(plan.cmat_c, np.float32)[:, None]], 1))
    y, u, v = planes
    out = {}
    if kw_y is not None:
        out["yW"] = lambda: rk.banded_resize_last_axis(y, kw_y)
    if kw_c is not None:
        out["cW"] = lambda: (rk.banded_resize_last_axis(u, kw_c),
                             rk.banded_resize_last_axis(v, kw_c))
    yw = out["yW"]() if "yW" in out else y
    uw, vw = out["cW"]() if "cW" in out else (u, v)

    def tail(e, pack):
        return lambda: rk.rows3_tail(yw, uw, vw, kh_y, kh_c, h_out, e,
                                     y_scale=y_scale, c_scale=c_scale,
                                     pack_format=pack)

    out["tail"] = tail(epi, fmt)
    out["tailID"] = tail(epi_id, fmt)
    out["tailH"] = tail(h_only_epilogue(), fmt)
    out["tailNoPack"] = tail(epi, None)
    full = _make_fused_fn(plan, pack_format=fmt)
    out["full"] = lambda: full(planes)
    return out


def h_only_epilogue() -> rk.Epilogue:
    """The tailH stage's epilogue: the H-resized planes go out as R, G, B
    unchanged (no matrix, correction, tone map or dither)."""
    return rk.Epilogue(cmat=None, correction=rk.CORR_NONE,
                       luminance_scale=1.0, dither_bits=0,
                       gamut=np.eye(3, dtype=np.float32),
                       plain=lambda y, u, v: torch.stack([y, u, v], dim=-3))


def time_stages(fns: dict, reps: int = REPS) -> dict:
    """Device ms of one call of each stage (CUDA events, after a warm-up
    call)."""
    return {name: cs.cuda_ms(fn, reps=reps) for name, fn in fns.items()}


def stage_lines(ms: dict, batch: int, **info) -> list:
    """One JSON object per stage: ms per frame and frames per second."""
    return [{"stage": k, "ms_per_frame": v / batch, "fps": 1e3 * batch / v,
             "batch": batch, **info,
             **({"note": MEMCPY_NOTE} if k == "memcpy" else {})}
            for k, v in ms.items()]


def attribution(ms: dict, batch: int) -> dict:
    """Per frame: the stages' sum (yW + cW + tail), the full chain, the
    transfer tower (tail - tailID) and the pack (tail - tailNoPack); with
    tailH, the H taps and store (tailH) and the colour matrix (tailID -
    tailH)."""
    per = {k: v / batch for k, v in ms.items()}
    out = {"summary": "attribution",
           "stages_sum_ms": per.get("yW", 0.0) + per.get("cW", 0.0)
           + per["tail"],
           "full_ms": per["full"],
           "tower_ms": per["tail"] - per["tailID"],
           "pack_ms": per["tail"] - per["tailNoPack"]}
    if "tailH" in per:
        out.update(h_store_ms=per["tailH"],
                   matrix_ms=per["tailID"] - per["tailH"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--plan", choices=PLANS, default="headline")
    ap.add_argument("--probe-wpass", action="store_true",
                    help="take the luma W pass apart (yW, yW1, yWsplit, "
                         "memcpy) instead of the stage split")
    args = ap.parse_args(argv)
    plan = plan_for(args.plan)
    wx, _, _, _, norm = fused_maps(plan)
    if args.probe_wpass and wx is None:
        ap.error(f"--probe-wpass: the {args.plan} plan's luma has no W map")
    if not torch.cuda.is_available():
        raise RuntimeError("torch_headline_micro.py needs an NVIDIA card: "
                           "CUDA is not available")
    dev = torch.device("cuda")
    planes = cs.p010_batch(args.batch, cs.SEED, dev)
    info = {"plan": args.plan, "device": torch.cuda.get_device_name(0)}
    if args.probe_wpass:
        mat = rk.BandedMatrix(wx, pre_scale=norm)
        lines = stage_lines(time_stages(wpass_probe(planes[0], mat)),
                            args.batch, taps=mat.n_taps, **info)
    else:
        ms = time_stages(stages(plan, planes))
        lines = stage_lines(ms, args.batch, **info) + [
            {**attribution(ms, args.batch), **info}]
    for obj in lines:
        print(json.dumps(obj), flush=True)
    print(cs.smi())


if __name__ == "__main__":
    main()
