"""videorenderer_tpu_torch.cli against videorenderer_tpu.cli: both CLIs on
the same raw NV12 / P010 and .y4m clips with the same flags (the port's
with ``--device cpu``), their output files compared channel by channel:
paths without a model within 1 code on >= 99.9% of the channels and at
most 3 (tests/test_torch_api.py's band), model paths (--superres,
--videohdr) >= 50 dB with codes at most 3 apart at 8 bits.  Also
``settings`` files equal, ``info``, the training commands (their checkpoints
processed by both CLIs) and the error exits."""

import json
import sys

import numpy as np
import pytest
import torch

from videorenderer_tpu.cli import main as jmain
from videorenderer_tpu.io.y4m import write_y4m

from videorenderer_tpu_torch.cli import main as tmain


def _nv12(path, w, h, frames, seed, pitch=None):
    rng = np.random.default_rng(seed)
    p = pitch or w
    bufs = []
    for _ in range(frames):
        y = rng.integers(16, 236, (h, p), np.uint8)
        uv = rng.integers(16, 241, (h // 2, p), np.uint8)
        bufs.append(y.tobytes() + uv.tobytes())
    path.write_bytes(b"".join(bufs))
    return str(path)


def _p010(path, w, h, frames, seed):
    rng = np.random.default_rng(seed)
    data = [np.concatenate([
        (rng.integers(64, 941, (h, w), np.uint16) << 6).reshape(-1),
        (rng.integers(64, 961, (h // 2, w), np.uint16) << 6).reshape(-1)])
        for _ in range(frames)]
    path.write_bytes(np.concatenate(data).tobytes())
    return str(path)


def _codes(path, bits):
    """(N * H * W, 3) channel codes of a raw RGB output file."""
    if bits == 10:
        d = np.fromfile(path, np.uint32)
        return np.stack([(d >> (10 * i)) & 1023 for i in range(3)], -1) \
            .astype(np.int64)
    return np.fromfile(path, np.uint8).reshape(-1, 3).astype(np.int64)


def _check(jpath, tpath, bits, model):
    j, t = _codes(jpath, bits), _codes(tpath, bits)
    assert j.shape == t.shape and j.size
    d = np.abs(j - t)
    if model:
        top = 2 ** bits - 1
        mse = np.mean(((j - t) / top) ** 2)
        assert mse == 0 or 10 * np.log10(1 / mse) >= 50.0
        assert (d / top * 255).max() <= 3.0, d.max()
    else:
        assert d.max() <= 3 and (d > 1).mean() <= 1e-3, (d.max(),
                                                          (d > 1).mean())


def _both(tmp_path, argv, out_bits=8, model=False):
    """Run both CLIs with ``argv`` (``{out}`` and ``{shot}`` filled per
    package); returns the two output paths."""
    outs = []
    for tag, main, extra in (("j", jmain, []), ("t", tmain,
                                                ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.rgb")
        args = [a.format(out=out, shot=str(tmp_path / f"{tag}.bmp"))
                for a in argv]
        assert main(args + extra) == 0
        outs.append(out)
    _check(*outs, out_bits, model)
    return outs


NV12 = ["--format", "NV12", "--size", "32x16", "--matrix", "BT_709"]
CASES = {
    "plain": ([], 8, False),
    "lanczos_up": (["--out-size", "64x32", "--upscaling", "LANCZOS3"], 8,
                   False),
    "rgb10_down": (["--out-size", "16x8", "--out-bits", "10"], 10, False),
    "rotation_flip": (["--rotation", "90", "--flip", "--out-size", "48x24"],
                      8, False),
    "batch2": (["--batch", "2", "--no-dither", "--chroma", "CATMULL_ROM"], 8,
               False),
    "deint_double": (["--deinterlace", "double", "--no-dither"], 8, False),
    "deint_single": (["--deinterlace", "single"], 8, False),
    "superres_untrained": (["--superres", "P1080", "--out-size", "64x32"], 8,
                           True),
    "superres_shipped": (["--superres", "P1080", "--out-size", "64x32",
                          "--superres-weights", "weights/superres_2x.npz"],
                         8, True),
    "videohdr_shipped": (["--videohdr-weights", "weights/videohdr.npz",
                          "--hdr-passthrough", "--out-bits", "10"], 10, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_process_nv12(tmp_path, case):
    argv, bits, model = CASES[case]
    clip = _nv12(tmp_path / "clip.nv12", 32, 16, 3, seed=len(case))
    _both(tmp_path, ["process", clip, "--out", "{out}"] + NV12 + argv,
          bits, model)


def test_process_pitch_and_srt(tmp_path):
    clip = _nv12(tmp_path / "clip.nv12", 32, 16, 3, seed=5, pitch=48)
    _both(tmp_path, ["process", clip, "--out", "{out}", "--pitch", "48"]
          + NV12)
    srt = tmp_path / "s.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:10,000\nHI\n")
    clip = _nv12(tmp_path / "clip2.nv12", 64, 32, 3, seed=6)
    _both(tmp_path, ["process", clip, "--out", "{out}", "--srt", str(srt),
                     "--no-dither", "--format", "NV12", "--size", "64x32",
                     "--matrix", "BT_709"])


@pytest.mark.parametrize("case", ["sdr", "passthrough_bt2390"])
def test_process_p010_hdr(tmp_path, case):
    clip = _p010(tmp_path / "clip.p010", 32, 16, 2, seed=7)
    argv = ["process", clip, "--out", "{out}", "--format", "P010", "--size",
            "32x16", "--transfer", "PQ", "--primaries", "BT_2020",
            "--matrix", "BT_2020_NC", "--out-size", "16x8"]
    if case == "sdr":
        _both(tmp_path, argv)
    else:
        _both(tmp_path, argv + ["--hdr-passthrough", "--tone-map", "BT2390",
                                "--display-nits", "600", "--out-bits", "10"],
              10)


def test_process_y4m_superres_screenshot(tmp_path):
    rng = np.random.default_rng(8)
    frames = [(rng.integers(16, 236, (16, 32), np.uint8),
               rng.integers(16, 241, (8, 16), np.uint8),
               rng.integers(16, 241, (8, 16), np.uint8)) for _ in range(3)]
    clip = str(tmp_path / "clip.y4m")
    write_y4m(clip, frames, 32, 16, fps=(30, 1))
    _both(tmp_path, ["process", clip, "--out", "{out}", "--out-size",
                     "64x32", "--superres", "P1080", "--superres-weights",
                     "weights/superres_2x.npz", "--screenshot", "{shot}",
                     "--matrix", "BT_709"], model=True)
    from PIL import Image
    j, t = (np.asarray(Image.open(tmp_path / f"{k}.bmp").convert("RGB"))
            .astype(np.int64) for k in "jt")
    assert t.shape == (32, 64, 3) and np.abs(j - t).max() <= 3
    first = _codes(str(tmp_path / "t.rgb"), 8)[:32 * 64].reshape(32, 64, 3)
    assert np.array_equal(first, t)          # the first output frame


def test_settings_files_equal(tmp_path, capsys):
    for tag, main in (("j", jmain), ("t", tmain)):
        f = str(tmp_path / f"{tag}.json")
        assert main(["settings", "--file", f, "--set", "upscaling=4",
                     "--set", "use_dither=false", "--set",
                     "vp_superres=2"]) == 0
    capsys.readouterr()
    j, t = (json.loads((tmp_path / f"{k}.json").read_text()) for k in "jt")
    assert j == t and t["upscaling"] == 4 and t["use_dither"] is False
    assert tmain(["settings", "--file", str(tmp_path / "t.json")]) == 0
    assert json.loads(capsys.readouterr().out) == t
    for tag, main in (("j", jmain), ("t", tmain)):
        assert main(["settings", "--file", str(tmp_path / f"{tag}.json"),
                     "--reset"]) == 0
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    with pytest.raises(SystemExit):
        tmain(["settings", "--set", "nope=1"])
    with pytest.raises(SystemExit):
        tmain(["settings", "--edit"])        # no interactive terminal


def _jax_train_keys(monkeypatch, capsys, tmp_path, cmd, extra):
    """The keys of the JAX CLI's JSON line for ``cmd`` with ``extra``
    flags, its training and evaluation stubbed (the keys depend on the
    flags only)."""
    import videorenderer_tpu.models.hdr_train as jh
    import videorenderer_tpu.models.sr_train as js
    for mod, name, ret in ((js, "train", (None, [0.5])),
                           (jh, "train", (None, [0.5])),
                           (js, "evaluate_psnr", (1.0, 2.0)),
                           (jh, "evaluate_pq_psnr", (1.0, 2.0))):
        monkeypatch.setattr(mod, name, lambda *a, _r=ret, **k: _r)
    monkeypatch.setattr("videorenderer_tpu.models.checkpoint.save_params",
                        lambda *a: None)
    assert jmain([cmd, "--out", str(tmp_path / "j.npz")] + extra) == 0
    return set(json.loads(capsys.readouterr().out.splitlines()[-1]))


def test_info_train_and_errors(tmp_path, capsys, monkeypatch):
    assert tmain(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "videorenderer_tpu_torch" in out and "Device: cpu" in out
    # both training commands on the CPU (2 steps), their JSON keys those of
    # the JAX CLI, then process with the checkpoint in both packages
    small = ["--steps", "2", "--frames", "4", "--patch", "32", "--batch",
             "2"]
    for cmd, extra, flags, bits in (
            ("train-superres", ["--natural-mix", "0.25"],
             ["--superres", "P1080", "--out-size", "64x32",
              "--superres-weights"], 8),
            ("train-videohdr", [], ["--hdr-passthrough", "--out-bits", "10",
                                    "--videohdr-weights"], 10)):
        ckpt = str(tmp_path / f"{cmd}.npz")
        assert tmain([cmd, "--out", ckpt, "--device", "cpu"] + small
                     + extra) == 0
        res = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert res["steps"] == 2 and np.isfinite(res["final_loss"])
        assert res["out"] == ckpt
        assert set(res) == _jax_train_keys(monkeypatch, capsys, tmp_path,
                                           cmd, small + extra)
        clip = _nv12(tmp_path / "c.nv12", 32, 16, 1, seed=1)
        _both(tmp_path, ["process", clip, *NV12, "--out", "{out}",
                         "--batch", "1", *flags, ckpt], bits, model=True)
    assert tmain(["process", str(tmp_path / "nothere.nv12"), "--out",
                  str(tmp_path / "x.rgb"), "--device", "cpu"] + NV12) == 2
    clip = _nv12(tmp_path / "c.nv12", 32, 16, 1, seed=1)
    with pytest.raises(SystemExit):
        tmain(["process", clip, "--format", "NOPE", "--size", "32x16",
               "--out", str(tmp_path / "x.rgb"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        tmain(["process", clip, "--out", str(tmp_path / "x.rgb"),
               "--bogus"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain(["info"])


def test_bench_outside_a_checkout_root(monkeypatch, capsys):
    """``bench`` runs the repo-root script: where it cannot be imported
    (an installed ``vrt-torch`` run elsewhere) the command exits 2 with a
    message, not a traceback."""
    monkeypatch.setitem(sys.modules, "torch_headline_micro", None)
    assert tmain(["bench", "--frames", "2"]) == 2
    assert "root of a checkout" in capsys.readouterr().err


@pytest.fixture
def smoke_on_cpu(monkeypatch):
    """chip_smoke at a small size on the CPU: the frames shrunk, the
    device syncs no-ops, a host timer for cuda_ms, and the kernel wrappers
    K1, K2, K7 and K9 counting their calls (their plain versions run on
    CPU tensors) as they count their launches on the card."""
    import chip_smoke as cs
    from videorenderer_tpu_torch.kernels import deint as dk
    from videorenderer_tpu_torch.kernels import resize as rk
    for name, val in (("W", 128), ("H", 64), ("OW", 64), ("OH", 32),
                      ("C1_W", 64), ("C1_H", 32), ("SR_BATCH", 2),
                      ("VH_BATCH", 3), ("CLI_SR_FRAMES", 2),
                      ("CLI_HEAD_FRAMES", 3), ("CLI_DEINT_FRAMES", 2),
                      ("PLAIN_FRAMES", 1)):
        monkeypatch.setattr(cs, name, val)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def host_ms(fn, reps=5, warmup=1):
        import time
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    for mod, name in ((rk, "banded_resize_last_axis"), (rk, "rows3_tail"),
                      (dk, "deint3_rows_dual"), (dk, "cols3_tail")):
        def counted(*a, _real=getattr(mod, name), _name=name, **kw):
            rk.launches[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return cs


def test_chip_smoke_k4_phase_rehearsal(smoke_on_cpu, monkeypatch, capsys):
    """Phase 19 end to end on the CPU at 128 x 64: K4 on the headline's,
    c7's and a 16 x 8 Lanczos thumbnail's maps (with the shared memory cut
    to 60000 bytes, the thumbnail's windows take the long-window route and
    the others the staged one, as the 160 x 90 thumbnail and the full-size
    plans do on the card), one K4 call a plan in the counted run, one a
    timed call on each route and tile shape that fits, the two-stage
    routes' K1 x3
    + K2; every band, bit-equality and digest of the line."""
    from videorenderer_tpu_torch.kernels import resize as rk
    cs = smoke_on_cpu
    monkeypatch.setattr(cs, "THUMB_W", 16)
    monkeypatch.setattr(cs, "THUMB_H", 8)
    monkeypatch.setattr(rk, "SMEM_BUDGET", 60000)
    routes = []

    def route(y_dtype, c_dtype, epi, long_window=False):
        routes.append(long_window)   # the library's query, stubbed
        return "long-window runtime" if long_window else "compiled"

    monkeypatch.setattr(rk, "mega3_tail_route", route)

    def counted(*a, _real=rk.mega3_tail, **kw):
        rk.launches["mega3_tail"] += 1
        return _real(*a, **kw)

    monkeypatch.setattr(rk, "mega3_tail", counted)
    k4, launches = cs.k4_phase("cpu")
    assert launches == cs.only(mega3_tail=3)
    assert routes == [False, False, False, False, True, True]
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith('{"phase": "K4"')]
    assert [line[k]["k4_route"][0] for k in ("headline", "c7", "thumb")] \
        == ["staged", "staged", "long-window"]
    for key in ("headline", "c7"):
        assert line[key]["long_window_bit_equal"]
        assert line[key]["tiles_bit_equal"]
        assert set(line[key]["tile_ms"]) <= {str(r) for r in cs.K4_TILES}
        assert line[key]["tile_ms"]
    assert "tile_ms" not in line["thumb"]
    for key in ("headline", "c7", "thumb"):
        c = line[key]
        assert c["vs_plain"]["max_code_diff"] == 0
        assert c["vs_two_stage_float16"]["max_code_diff"] <= 1
        assert len(c["digest"]) == len(c["cmat_digest"]) == 64
    assert k4["ms"] == line["headline"]["ms"] and k4["bound_ms"] > 0
    assert k4["max_abs_err"] == max(line[k]["max_abs_err"]
                                    for k in ("headline", "c7", "thumb"))


def test_chip_smoke_model_cli_phases_rehearsal(smoke_on_cpu, capsys):
    """Phases 36-38 end to end on the CPU: the launch counts of each path,
    every bit-equality, the PSNR bars and the CLI's files."""
    cs = smoke_on_cpu
    res = cs.model_cli_phases("cpu")
    two = cs.only(banded_resize_last_axis=2, rows3_tail=1)
    assert res["launches"] == {
        "c3sr": two, "c1vh": two, "cli_c3sr": two,
        "cli_headline": cs.only(banded_resize_last_axis=3, rows3_tail=1),
        "cli_c5": cs.only(deint3_rows_dual=2, cols3_tail=2)}
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    by = {d["phase"]: d for d in lines}
    assert by["c3sr"]["psnr_db"]["output"] >= 40.0
    assert by["c1vh"]["signal_info"]["transfer"] == "PQ"
    assert all(r["bit_equal_renderer"] for r in by["cli"]["runs"].values())
    assert by["cli"]["runs"]["c3sr"]["screenshot_equal_first_frame"]


def test_chip_smoke_train_phases_rehearsal(smoke_on_cpu, monkeypatch,
                                           capsys):
    """Phases 39-42 end to end on the CPU at tiny width: the trainers'
    checks, the one-rank mesh (gloo here) bit-equal to no mesh, and the
    train commands' checkpoints through ``process``."""
    import time

    class HostEvent:            # torch.cuda.Event on the host clock
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    cs = smoke_on_cpu
    for name, val in (("SR_TRAIN_CFG", cs.sr_model.SuperResConfig(
            channels=16, num_blocks=1, s2d=2)),
            ("VH_TRAIN_CFG", cs.vh_model.VideoHDRConfig(channels=8)),
            ("TRAIN_BATCH", 2), ("TRAIN_PATCH", 32), ("TRAIN_FRAMES", 8),
            ("TRAIN_STEPS", 16), ("TRAIN_TIMED_FROM", 2),
            ("TRAIN_VAL_FRAMES", 2), ("DP_STEPS", 2),
            ("CLI_TRAIN_STEPS", 2), ("CLI_TRAIN_FRAMES", 4)):
        monkeypatch.setattr(cs, name, val)

    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    res = cs.train_phases("cpu")
    two = cs.only(banded_resize_last_axis=2, rows3_tail=1)
    assert res["launches"]["train_cli_train-superres"] == two
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith('{"phase"')]
    by = {d["phase"]: d for d in lines}
    assert set(by) == {"train_sr", "train_hdr", "train_dp", "train_cli"}
    for key in ("train_sr", "train_hdr"):
        assert by[key]["first_max_rel"] == 0.0 and by[key]["master_float32"]
        assert len(by[key]["losses"]) == 16
        assert by[key]["ms_per_step"] > 0.0
        assert (by[key]["gflop_per_step"]
                < 3 * by[key]["forward_gflop_per_step"])
    assert by["train_dp"]["bit_equal_no_mesh"]
    assert by["train_dp"]["backend"] == "gloo"
    assert by["train_dp"]["group_destroyed"]
    for run in by["train_cli"]["runs"].values():
        assert run["keys_equal_jax_cli"] and run["bit_equal_renderer"]
        assert run["launches_equal_renderer"]


def test_chip_smoke_spatial_coverage_phases_rehearsal(smoke_on_cpu,
                                                      monkeypatch, capsys):
    """Phases 43-50 end to end on the CPU at small sizes: parallel/spatial
    on a gloo world of one (c6, its four shards one after another, c9, the
    Dolby Vision, learned and Jinc2 forms, the last two as four shards too,
    the Jinc2 form's K5 route on a letterboxed c3) and c2, c4; the launch
    counts, every bit-equality and the bands of each phase, K3, K5, K6 and
    K8 counting too (the kernels' plain versions, ``pipeline._on_card``
    true).  168 rows: four shards of the shipped SuperRes (40 halo rows)
    pad the surface to 176, as 1080 pads to 1088 on the card."""
    from videorenderer_tpu_torch import pipeline as tpipe
    from videorenderer_tpu_torch.kernels import deint as dk
    from videorenderer_tpu_torch.kernels import resize as rk
    cs = smoke_on_cpu
    # the Dolby Vision frame function picks K8 + K9 from the planes' device
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    for name, val in (("C6_BATCH", 2), ("C9_W", 256), ("C9_H", 128),
                      ("C9_OW", 128), ("C9_OH", 64), ("C9_BATCH", 1),
                      ("BATCH", 2), ("SR_BATCH", 1), ("C1_H", 168),
                      ("C3_OW", 128), ("C3_OH", 192),
                      ("J3_RECT", (0, 8, 128, 184))):
        monkeypatch.setattr(cs, name, val)
    from videorenderer_tpu_torch.kernels import jinc2 as jk
    for mod, name in ((rk, "banded_resize_rows"), (dk, "rows3_mid"),
                      (jk, "jinc2_convert_fused"),
                      (jk, "jinc2_resize_fused")):
        def counted(*a, _real=getattr(mod, name), _name=name, **kw):
            rk.launches[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    spa = cs.spatial_phases("cpu")
    cov = cs.coverage_phases("cpu")
    six = cs.only(banded_resize_last_axis=3, banded_resize_rows=3)
    assert spa["launches"] == {
        "c6": six, "c9": six, "spatial_dovi": six,
        "c6x4": cs.only(banded_resize_last_axis=24, banded_resize_rows=24),
        "spatial_sr": cs.only(banded_resize_last_axis=2,
                              banded_resize_rows=2),
        # the pad's luma map joins the chroma's; three passes settle the
        # net's halo, which reads the settled frame rows
        "spatial_srx4": cs.only(banded_resize_last_axis=24,
                                banded_resize_rows=36),
        "spatial_c3": cs.only(jinc2_convert_fused=1),
        "spatial_c3x4": cs.only(jinc2_convert_fused=8),
        "spatial_c3_placed": cs.only(banded_resize_last_axis=2,
                                     banded_resize_rows=2,
                                     jinc2_resize_fused=1),
        "spatial_c3_placedx4": cs.only(banded_resize_last_axis=24,
                                       banded_resize_rows=24,
                                       jinc2_resize_fused=12)}
    assert cov["launches"] == {
        "c2": cs.only(banded_resize_last_axis=6, rows3_tail=2),
        "c4": cs.only(banded_resize_last_axis=4, rows3_tail=2)}
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith('{"phase"')]
    by = {d["phase"]: d for d in lines}
    assert list(by) == ["c6", "c6x4", "c9", "spatial_dovi", "spatial_sr",
                        "spatial_c3", "spatial_c3_placed", "c2", "c4"]
    assert by["spatial_sr"]["x4_bit_equal_one_shard"]
    assert by["spatial_sr"]["x4_passes"] == 3
    assert by["spatial_c3_placed"]["x4_bit_equal_one_shard"]
    assert by["spatial_c3_placed"]["bars_packed_zero"]
    assert by["spatial_c3_placed"]["kernels"]["k5_max_abs_err"] == 0.0
    assert by["spatial_c3"]["bit_equal_unsharded_k6"]
    assert by["spatial_c3"]["x4_bit_equal_unsharded_k6"]
    assert by["c6"]["bit_equal_no_mesh"] and by["c9"]["bit_equal_no_mesh"]
    assert by["c6x4"]["bit_equal_one_shard"] and by["c6x4"]["passes"] == 2
    assert [s["rank"] for s in by["c6x4"]["shards"]] == [0, 1, 2, 3]
    assert spa["k3_shard"]["ms"] > 0.0 and spa["k3_shard"]["bound_ms"] > 0.0
    assert min(by[k]["psnr_db"] for k in ("c6", "c9", "spatial_dovi", "c2",
                                          "c4", "spatial_c3_placed")) >= 55.0


def test_chip_smoke_two_stage_phase_rehearsal(smoke_on_cpu, monkeypatch,
                                              capsys):
    """Phase 51 end to end on the CPU at 128 x 64 -> 64 x 32, batch 2: the
    two-stage Dolby Vision form's launch counts in each case (K1 x5 + K2's
    Dolby Vision route + K2 a call), the kernels against their plain
    versions, the PSNR bar, the band against the one-intermediate chain,
    the rect's bars; the switch restored after the phase."""
    import os
    import time
    from videorenderer_tpu_torch import pipeline as tpipe
    from videorenderer_tpu_torch.kernels import build
    from videorenderer_tpu_torch.kernels import deint as dk
    from videorenderer_tpu_torch.kernels import resize as rk

    class HostEvent:            # torch.cuda.Event on the host clock
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    cs = smoke_on_cpu
    monkeypatch.setattr(cs, "BATCH", 2)
    monkeypatch.setattr(cs, "C8_RECT", (8, 4, 56, 28))
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    lib = object()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(dk, "rows3_mid_route", lambda *a: "stub")
    monkeypatch.setattr(rk, "rows3_tail_route", lambda *a, **k: "stub")

    def counted(*a, _real=rk.rows3_tail_dovi, **kw):
        rk.launches["rows3_tail_dovi"] += 1
        return _real(*a, **kw)

    monkeypatch.setattr(rk, "rows3_tail_dovi", counted)
    monkeypatch.delenv("VRT_TPU_DOVI_MID", raising=False)
    res = cs.two_stage_phase("cpu")
    assert "VRT_TPU_DOVI_MID" not in os.environ
    per = {"c8": cs.C8_SCENES, "variant": 1, "c8x": cs.HDR_SCENES,
           "c8_rect": cs.C8_SCENES}
    assert res["launches"] == {
        k: cs.only(banded_resize_last_axis=5 * n, rows3_tail_dovi=n,
                   rows3_tail=n) for k, n in per.items()}
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith('{"phase": "c8_two_stage"')]
    for key in per:
        c = line[key]
        assert min(c["psnr_db"].values()) >= 55.0
        assert c["vs_mid_chain"]["max_code_diff"] <= 1
        assert c["kernels"]["stage_a_max_abs_err"] == 0.0
        assert len(c["digest"]) == len(c["kernels"]["stage_a_digest"]) == 64
    assert line["c8_rect"]["bars_black"]
    assert res["k2_dovi"]["bound_ms"] > 0.0 and res["k2_dovi"]["ms"] > 0.0
