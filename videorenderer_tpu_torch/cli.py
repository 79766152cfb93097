"""Command-line interface: file-in/file-out processing, training and info
reporting — the standalone analogue of dropping the filter into a player
graph; the port of ``videorenderer_tpu.cli``.  Runs on the card unless
``--device cpu``.

Examples:
  python -m videorenderer_tpu_torch.cli process in.yuv --format NV12 \\
      --size 1920x1080 --out out.rgb --out-size 3840x2160 --out-bits 8 \\
      --upscaling LANCZOS3
  python -m videorenderer_tpu_torch.cli process clip.y4m --out out.rgb \\
      --out-size 3840x2160 --superres P1080 \\
      --superres-weights weights/superres_2x.npz --screenshot first.bmp
  python -m videorenderer_tpu_torch.cli info
  python -m videorenderer_tpu_torch.cli bench --frames 16
  python -m videorenderer_tpu_torch.cli train-superres --out sr.npz \\
      --steps 2000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .api import VideoRenderer
from .config import (ChromaScaling, Downscaling, Settings, SuperResolution,
                     ToneMapType, Upscaling)
from .csputils import CSP, TRC, ChromaLocation, Levels, Primaries
from .formats import ColorFormat
from .io.raw import RawVideoSink, RawVideoSource
from .pipeline import OutputDescriptor, SourceDescriptor
from .runner import DeinterlaceSession, run_clip, windowed_batches

def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def _enum(cls, name: str):
    key = name.upper().replace("-", "_")
    try:
        return cls[key]
    except KeyError:
        valid = ", ".join(m.name for m in cls)
        raise SystemExit(f"error: unknown {cls.__name__} '{name}' "
                         f"(valid: {valid})")


def _load_models(vr: VideoRenderer, args) -> None:
    """The learned models the flags ask for, loaded into ``vr``: the
    checkpoint given, or untrained weights (a zero tail: the nets then
    return their deterministic bases)."""
    from .models.checkpoint import load_params
    seed = torch.Generator().manual_seed(0)
    if args.videohdr or args.videohdr_weights:
        from .models.videohdr import VideoHDRConfig, init_params
        model = init_params(seed, VideoHDRConfig())
        if args.videohdr_weights:
            load_params(args.videohdr_weights, model)
        vr.set_videohdr_params(model)
    if args.superres:
        from .models.superres import SuperResConfig, init_params
        model = init_params(seed, SuperResConfig())
        if args.superres_weights:
            load_params(args.superres_weights, model)
        vr.set_superres_params(model)


def cmd_process(args) -> int:
    y4m = None
    if args.input.lower().endswith(".y4m"):
        from .io.y4m import Y4MSource
        y4m = Y4MSource(args.input)
        src_fmt = y4m.format
        w, h = y4m.width, y4m.height
        if args.fps == 24.0:
            args.fps = y4m.fps
    else:
        if not args.format or not args.size:
            raise SystemExit("error: --format and --size are required for "
                             "raw input (or use a .y4m file)")
        src_fmt = _enum(ColorFormat, args.format)
        w, h = _parse_size(args.size)
    ow, oh = _parse_size(args.out_size) if args.out_size else (w, h)

    settings = Settings(
        chroma_scaling=_enum(ChromaScaling, args.chroma),
        upscaling=_enum(Upscaling, args.upscaling),
        downscaling=_enum(Downscaling, args.downscaling),
        use_dither=not args.no_dither,
        convert_to_sdr=not args.hdr_passthrough,
        hdr_passthrough=args.hdr_passthrough,
        sdr_display_nits=args.sdr_nits,
        hdr_local_tone_mapping=args.tone_map is not None,
        hdr_local_tone_mapping_type=(_enum(ToneMapType, args.tone_map)
                                     if args.tone_map else ToneMapType.ACES),
        hdr_display_max_nits=args.display_nits,
    )
    src = SourceDescriptor(
        format=src_fmt, width=w, height=h,
        matrix=_enum(CSP, args.matrix) if args.matrix else CSP.AUTO,
        levels=_enum(Levels, args.levels) if args.levels else Levels.AUTO,
        primaries=(_enum(Primaries, args.primaries) if args.primaries
                   else Primaries.AUTO),
        transfer=_enum(TRC, args.transfer) if args.transfer else TRC.AUTO,
        chroma_location=(y4m.chroma_location if y4m is not None
                         else ChromaLocation.UNKNOWN),
        interlaced=args.deinterlace is not None,
    )
    dst = OutputDescriptor(width=ow, height=oh, bits=args.out_bits,
                           hdr=args.hdr_passthrough)
    if args.superres:
        settings = dataclasses.replace(
            settings, vp_superres=_enum(SuperResolution, args.superres))
    if args.videohdr or args.videohdr_weights:
        settings = dataclasses.replace(settings, vp_rtx_video_hdr=True)

    vr = VideoRenderer(settings, device=args.device)
    _load_models(vr, args)
    if args.rotation:
        vr.flt_set("rotation", args.rotation)
    if args.flip:
        vr.flt_set("flip", True)
    vr.open(src, dst)

    if args.srt:
        from .io.srt import load_srt
        vr.set_subtitle_provider(load_srt(args.srt), threaded=False)

    source = y4m if y4m is not None else RawVideoSource(
        args.input, src_fmt, w, h, pitch=args.pitch)
    n = len(source)
    if n == 0:
        print("no frames in input", file=sys.stderr)
        return 1
    planes = source.read_batch(0, n)

    if args.deinterlace is not None:
        # streaming per-field path with temporal window
        sess = DeinterlaceSession(vr._plan,
                                  double_rate=args.deinterlace == "double",
                                  device=vr.device)
        with RawVideoSink(args.out, bits=args.out_bits) as sink:
            t0 = time.perf_counter()
            for i in range(n):
                for out in sess.push(tuple(p[i] for p in planes)):
                    sink.present(out)
            for out in sess.flush():
                sink.present(out)
            fps = sink.frames / max(time.perf_counter() - t0, 1e-9)
        print(f"{sink.frames} fields -> {args.out} ({fps:.1f} fps)",
              file=sys.stderr)
        return 0

    if args.srt:
        # per-frame path so subtitles composite at the right times
        with RawVideoSink(args.out, bits=args.out_bits) as sink:
            for i in range(n):
                sink.present(vr.process_frame(tuple(p[i] for p in planes),
                                              time=i / args.fps))
        print(f"{n} frames -> {args.out}", file=sys.stderr)
        return 0

    with RawVideoSink(args.out, bits=args.out_bits) as sink:
        result = run_clip(vr._fn, windowed_batches(planes, args.batch),
                          device=vr.device)
        for out in result.outputs:
            sink.present(out)
    if args.screenshot:
        from .io.image import save_image
        first = result.outputs[0].cpu().numpy()
        save_image(args.screenshot, np.moveaxis(
            first[0] if first.ndim == 4 else first, 0, -1))
    print(f"{sink.frames} frames -> {args.out} "
          f"({result.fps:.1f} fps)", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    print(VideoRenderer(device=args.device).get_video_processor_info())
    return 0


def cmd_settings(args) -> int:
    """Show, save or edit settings — the property-page + registry analogue
    (Source/PropPage.cpp; Source/VideoRenderer.cpp:1273-1315)."""
    s = (Settings.load(args.file)
         if args.file and os.path.exists(args.file) and not args.reset
         else Settings())
    if args.edit:
        from .proppage import InfoPageModel, PropertyPageModel, run_tui
        if not sys.stdout.isatty():
            raise SystemExit("error: --edit needs an interactive terminal")
        model = PropertyPageModel(
            s, on_apply=(lambda v: v.save(args.file)) if args.file else None)
        info = InfoPageModel(
            lambda: VideoRenderer(model.value, device=args.device)
            .get_video_processor_info())
        s = run_tui(model, info=info)
    if args.set:
        d = s.to_dict()
        for kv in args.set:
            k, _, v = kv.partition("=")
            if k not in d:
                raise SystemExit(f"error: unknown setting '{k}' "
                                 f"(valid: {', '.join(d)})")
            cur = d[k]
            d[k] = (v.lower() in ("1", "true", "yes") if isinstance(cur, bool)
                    else int(v) if isinstance(cur, int) else v)
        s = Settings.from_dict(d)
    if args.file and (args.set or args.reset):
        s.save(args.file)
    print(json.dumps(s.to_dict(), indent=2))
    return 0


def cmd_bench(args) -> int:
    """The headline's stage split on the card (repo-root
    ``torch_headline_micro.py``: runs from a checkout's root only)."""
    try:
        import torch_headline_micro
    except ModuleNotFoundError as e:
        if e.name != "torch_headline_micro":
            raise
        print("error: bench runs torch_headline_micro.py from the root of a "
              "checkout; run it from there", file=sys.stderr)
        return 2
    torch_headline_micro.main(["--batch", str(args.frames)])
    return 0


def cmd_train_superres(args) -> int:
    """Train the learned 2x upscaler on synthetic frames degraded by the
    framework's own downscalers; writes a checkpoint usable with
    ``process --superres ... --superres-weights`` (in either package)."""
    from .models.checkpoint import load_params, save_params
    from .models.sr_train import (evaluate_psnr, natural_frames,
                                  synth_frames, train)
    from .models.superres import SuperResConfig, init_params

    cfg = SuperResConfig()
    n_real = int(args.frames * args.real_mix)
    n_nat = int(args.frames * args.natural_mix)
    data = synth_frames(seed=args.seed, n=args.frames - n_real - n_nat,
                        size=args.patch)
    if n_real or n_nat:
        from .models.real_eval import real_frames
        parts = [data]
        if n_nat:
            parts.append(natural_frames(seed=args.seed + 3, n=n_nat,
                                        size=args.patch))
        if n_real:
            parts.append(real_frames(n_real, args.patch,
                                     seed=args.seed + 1))
        rng = np.random.default_rng(args.seed + 5)
        data = rng.permutation(np.concatenate(parts))
    val = synth_frames(seed=args.seed + 777, n=16, size=args.patch)
    model = None
    if args.resume:
        model = load_params(args.resume,
                            init_params(torch.Generator().manual_seed(0),
                                        cfg))
    model, losses = train(cfg, steps=args.steps, batch=args.batch,
                          data_hr=data, seed=args.seed,
                          learning_rate=args.lr, log_every=args.log_every,
                          model=model, device=args.device)
    net_db, base_db = evaluate_psnr(model, val)
    save_params(args.out, model)
    result = {"steps": args.steps, "final_loss": losses[-1],
              "val_psnr_net_db": round(net_db, 2),
              "val_psnr_catmull_db": round(base_db, 2),
              "out": args.out}
    if n_real or n_nat:
        rval = real_frames(16, args.patch, seed=args.seed + 999)
        rnet, rbase = evaluate_psnr(model, rval)
        result["real_psnr_net_db"] = round(rnet, 2)
        result["real_psnr_catmull_db"] = round(rbase, 2)
    print(json.dumps(result))
    return 0


def cmd_train_videohdr(args) -> int:
    """Train the learned SDR->HDR gain net against the framework's own
    BT.2390 tone mapper (round-trip consistency); writes a checkpoint
    usable with ``process --videohdr-weights`` (in either package)."""
    from .models.checkpoint import load_params, save_params
    from .models.hdr_train import evaluate_pq_psnr, synth_hdr_frames, train
    from .models.videohdr import VideoHDRConfig, init_params

    cfg = VideoHDRConfig()
    data = synth_hdr_frames(seed=args.seed, n=args.frames, size=args.patch,
                            cfg=cfg)
    val = synth_hdr_frames(seed=args.seed + 777, n=16, size=args.patch,
                           cfg=cfg)
    model = None
    if args.resume:
        model = load_params(args.resume,
                            init_params(torch.Generator().manual_seed(0),
                                        cfg))
    model, losses = train(cfg, steps=args.steps, batch=args.batch,
                          hdr_nits=data, seed=args.seed,
                          learning_rate=args.lr, log_every=args.log_every,
                          model=model, device=args.device)
    net_db, base_db = evaluate_pq_psnr(model, val)
    save_params(args.out, model)
    print(json.dumps({"steps": args.steps, "final_loss": losses[-1],
                      "val_pq_psnr_net_db": round(net_db, 2),
                      "val_pq_psnr_base_db": round(base_db, 2),
                      "out": args.out}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="videorenderer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the card (default) or on the CPU")

    pp = sub.add_parser("process", help="process a raw video file")
    pp.add_argument("input")
    pp.add_argument("--format", default=None,
                    help="e.g. NV12, P010, YUY2 (auto for .y4m input)")
    pp.add_argument("--size", default=None, help="WxH (auto for .y4m)")
    pp.add_argument("--pitch", type=int, default=None,
                    help="bytes per luma row for padded-stride raw input "
                         "(negative = bottom-up rows)")
    pp.add_argument("--out", required=True)
    pp.add_argument("--out-size", default=None)
    pp.add_argument("--out-bits", type=int, default=8, choices=(8, 10, 16))
    pp.add_argument("--batch", type=int, default=8)
    pp.add_argument("--matrix", default=None, help="BT_709/BT_601/BT_2020_NC/...")
    pp.add_argument("--levels", default=None, help="TV/PC")
    pp.add_argument("--primaries", default=None)
    pp.add_argument("--transfer", default=None, help="BT_1886/PQ/HLG/...")
    pp.add_argument("--chroma", default="BILINEAR")
    pp.add_argument("--upscaling", default="CATMULL_ROM")
    pp.add_argument("--downscaling", default="HAMMING")
    pp.add_argument("--no-dither", action="store_true")
    pp.add_argument("--hdr-passthrough", action="store_true")
    pp.add_argument("--sdr-nits", type=int, default=125)
    pp.add_argument("--rotation", type=int, default=0)
    pp.add_argument("--flip", action="store_true")
    pp.add_argument("--deinterlace", choices=("single", "double"), default=None,
                    help="motion-adaptive deinterlace (double = double-rate)")
    pp.add_argument("--tone-map", default=None,
                    help="local HDR tone-map: ACES/REINHARD/HABLE/MOBIUS/BT2390/ST2094_10")
    pp.add_argument("--display-nits", type=int, default=1000)
    pp.add_argument("--srt", default=None, help="burn in subtitles from an SRT file")
    pp.add_argument("--fps", type=float, default=24.0,
                    help="frame rate for subtitle timing")
    pp.add_argument("--screenshot", default=None,
                    help="also save the first output frame as BMP (PNG with "
                         "Pillow)")
    pp.add_argument("--superres", default=None,
                    help="learned 2x upscaler gate level: SD/P720/P1080/P1440")
    pp.add_argument("--superres-weights", default=None,
                    help="trained checkpoint (.npz, e.g. "
                         "weights/superres_2x.npz); omit for untrained "
                         "weights (the nearest-upsampled base)")
    pp.add_argument("--videohdr", action="store_true",
                    help="learned SDR->HDR (RTX Video HDR slot); untrained "
                         "weights reduce to the deterministic inverse "
                         "tone map")
    pp.add_argument("--videohdr-weights", default=None,
                    help="trained checkpoint (.npz, e.g. "
                         "weights/videohdr.npz); implies --videohdr")
    device_flag(pp)
    pp.set_defaults(fn=cmd_process)

    pi = sub.add_parser("info", help="device / processor info")
    device_flag(pi)
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("settings", help="show/edit persisted settings")
    ps.add_argument("--file", default=None, help="settings JSON path")
    ps.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    ps.add_argument("--reset", action="store_true",
                    help="reset to defaults (Reset_Settings.cmd analogue)")
    ps.add_argument("--edit", action="store_true",
                    help="interactive property page (PropPage analogue)")
    device_flag(ps)
    ps.set_defaults(fn=cmd_settings)

    pb = sub.add_parser("bench", help="the headline's stage split on the "
                        "card (from a checkout's root only)")
    pb.add_argument("--frames", type=int, default=16)
    pb.set_defaults(fn=cmd_bench)

    pt = sub.add_parser("train-superres",
                        help="train the learned 2x upscaler (synthetic data)")
    pt.add_argument("--out", required=True, help="checkpoint .npz path")
    pt.add_argument("--steps", type=int, default=2000)
    pt.add_argument("--batch", type=int, default=16)
    pt.add_argument("--frames", type=int, default=256,
                    help="synthetic training frames")
    pt.add_argument("--patch", type=int, default=128, help="HR patch size")
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--resume", default=None, help="checkpoint to continue")
    pt.add_argument("--log-every", type=int, default=100)
    pt.add_argument("--real-mix", type=float, default=0.0,
                    help="fraction of training frames drawn from real-photo "
                         "crops (models/real_eval.py); also reports "
                         "real-content validation PSNR")
    pt.add_argument("--natural-mix", type=float, default=0.0,
                    help="fraction of training frames with generative "
                         "natural-image statistics (pink-noise spectra + "
                         "grain, sr_train.natural_frames); also reports "
                         "real-content validation PSNR")
    device_flag(pt)
    pt.set_defaults(fn=cmd_train_superres)

    pv = sub.add_parser("train-videohdr",
                        help="train the learned SDR->HDR gain net "
                             "(synthetic HDR, BT.2390 round trip)")
    pv.add_argument("--out", required=True, help="checkpoint .npz path")
    pv.add_argument("--steps", type=int, default=2000)
    pv.add_argument("--batch", type=int, default=16)
    pv.add_argument("--frames", type=int, default=256,
                    help="synthetic HDR training frames")
    pv.add_argument("--patch", type=int, default=128, help="patch size")
    pv.add_argument("--lr", type=float, default=1e-3)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--resume", default=None, help="checkpoint to continue")
    pv.add_argument("--log-every", type=int, default=100)
    device_flag(pv)
    pv.set_defaults(fn=cmd_train_videohdr)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, EOFError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
