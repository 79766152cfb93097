"""videorenderer_tpu_torch host planning against the JAX package: config
enums, colour matrices, axis and chroma matrices, the dither matrix, the
plan, the tap tables — all exactly equal — plus the port's import
isolation, the plans it once refused (now equal to the JAX plans) and its
device handling."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest
import torch

import videorenderer_tpu.config as jcfg
import videorenderer_tpu.csputils as jcsp
import videorenderer_tpu.formats as jfmt
import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import chroma as jchroma
from videorenderer_tpu.ops import dither as jdither
from videorenderer_tpu.ops import scale as jscale
from videorenderer_tpu.ops import tonemap as jtonemap

import videorenderer_tpu_torch.config as tcfg
import videorenderer_tpu_torch.csputils as tcsp
import videorenderer_tpu_torch.formats as tfmt
import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import dither as tdither
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import scale as tscale
from videorenderer_tpu_torch.ops import tonemap as ttonemap

import torch_hdr_cells as hdr_cells

REPO = Path(__file__).resolve().parent.parent

ENUMS = ["TexFormat", "Deinterlacing", "SuperResolution", "ChromaScaling",
         "Upscaling", "Downscaling", "SwapEffect", "HdrToggleDisplay",
         "ToneMapType"]
CSP_ENUMS = ["CSP", "Levels", "Primaries", "TRC", "ChromaLocation"]


@pytest.mark.parametrize("mod,name", [("cfg", n) for n in ENUMS]
                         + [("csp", n) for n in CSP_ENUMS]
                         + [("fmt", "ColorFormat"), ("fmt", "ColorSystem")])
def test_enums_equal(mod, name):
    j = {"cfg": jcfg, "csp": jcsp, "fmt": jfmt}[mod]
    t = {"cfg": tcfg, "csp": tcsp, "fmt": tfmt}[mod]
    assert ([(m.name, int(m)) for m in getattr(t, name)]
            == [(m.name, int(m)) for m in getattr(j, name)])


def test_settings_fields_and_defaults_equal():
    jt = {f.name: f.default for f in dataclasses.fields(jcfg.Settings)}
    tt = {f.name: f.default for f in dataclasses.fields(tcfg.Settings)}
    assert list(jt) == list(tt)
    assert tcfg.Settings().to_dict() == jcfg.Settings().to_dict()


def test_format_registry_equal():
    for f in jfmt.ColorFormat:
        if f == jfmt.ColorFormat.NONE:
            continue
        a = dataclasses.asdict(jfmt.get_format_info(f))
        b = dataclasses.asdict(tfmt.get_format_info(tfmt.ColorFormat(int(f))))
        assert {k: int(v) if hasattr(v, "value") else v for k, v in a.items()} \
            == {k: int(v) if hasattr(v, "value") else v for k, v in b.items()}


def test_surface_decoders_equal():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 2 ** 32, (7, 9), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(tfmt.unpack_rgb10(d), jfmt.unpack_rgb10(d))
    assert np.array_equal(tfmt.unpack_rgba8(d), jfmt.unpack_rgba8(d))


@pytest.mark.parametrize("space", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("levels,bits,procamp", [
    (1, 8, (0.0, 1.0, 0.0, 1.0)), (2, 10, (0.0, 1.0, 0.0, 1.0)),
    (1, 16, (0.1, 1.2, 0.3, 0.8))])
def test_csp_matrix_equal(space, levels, bits, procamp):
    br, co, hue, sat = procamp

    def cm(mod):
        p = mod.CSPParams(color=mod.Colorspace(mod.CSP(space), mod.Levels(levels)),
                          brightness=br, contrast=co, hue=hue, saturation=sat,
                          input_bits=bits, texture_bits=bits)
        return mod.get_csp_matrix(p)

    a, b = cm(jcsp), cm(tcsp)
    assert np.array_equal(a.m, b.m) and np.array_equal(a.c, b.c)


def test_gamut_matrix_equal():
    assert np.array_equal(tcsp.bt2020_to_bt709_matrix(),
                          jcsp.bt2020_to_bt709_matrix())


@pytest.mark.parametrize("method", ["NEAREST", "MITCHELL", "CATMULL_ROM",
                                    "LANCZOS2", "LANCZOS3"])
@pytest.mark.parametrize("sizes", [(3840, 1920), (960, 1920), (101, 67)])
def test_upscale_matrix_equal(method, sizes):
    a = jscale.upscale_matrix(jcfg.Upscaling[method], *sizes)
    b = tscale.upscale_matrix(tcfg.Upscaling[method], *sizes)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("method", list(tcfg.Downscaling.__members__))
def test_downscale_matrix_equal(method):
    a = jscale.downscale_matrix(jcfg.Downscaling[method], 3840, 1280)
    b = tscale.downscale_matrix(tcfg.Downscaling[method], 3840, 1280)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("sub", [420, 422, 444])
@pytest.mark.parametrize("method", ["NEAREST", "BILINEAR", "CATMULL_ROM"])
@pytest.mark.parametrize("loc", ["MPEG1", "MPEG2", "COSITED"])
def test_chroma_matrices_equal(sub, method, loc):
    a = jchroma.chroma_upsample_matrices(
        96, 54, sub, jcfg.ChromaScaling[method], jcsp.ChromaLocation[loc])
    b = tchroma.chroma_upsample_matrices(
        96, 54, sub, tcfg.ChromaScaling[method], tcsp.ChromaLocation[loc])
    for x, y in zip(a, b):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert np.array_equal(jchroma.blend_deinterlace_matrix(37),
                          tchroma.blend_deinterlace_matrix(37))


def test_bayer_matrix_equal():
    for n in (2, 8, 32):
        assert np.array_equal(tdither.bayer_matrix(n), jdither.bayer_matrix(n))


# --- the headline and c1 plans: matrices, plans and tap tables --------------

def _plans(mod_cfg, mod_csp, mod_pipe, mod_fmt):
    hl = mod_pipe.plan_pipeline(
        mod_cfg.Settings(upscaling=mod_cfg.Upscaling.LANCZOS3,
                         chroma_scaling=mod_cfg.ChromaScaling.BILINEAR,
                         convert_to_sdr=True, use_dither=True),
        mod_pipe.SourceDescriptor(
            format=mod_fmt.ColorFormat.P010, width=3840, height=2160,
            matrix=mod_csp.CSP.BT_2020_NC, levels=mod_csp.Levels.TV,
            primaries=mod_csp.Primaries.BT_2020, transfer=mod_csp.TRC.PQ,
            hdr10=mod_pipe.HDR10Metadata()),
        mod_pipe.OutputDescriptor(width=1920, height=1080, bits=10))
    c1 = mod_pipe.plan_pipeline(
        mod_cfg.Settings(chroma_scaling=mod_cfg.ChromaScaling.BILINEAR),
        mod_pipe.SourceDescriptor(format=mod_fmt.ColorFormat.NV12, width=1920,
                                  height=1080, matrix=mod_csp.CSP.BT_709,
                                  levels=mod_csp.Levels.TV),
        mod_pipe.OutputDescriptor(width=1920, height=1080, bits=8))
    return {"headline": hl, "c1": c1}


def _plane_matrices(scale, chroma, plan):
    """(W, H) matrices of the luma and the chroma planes, composed as the
    fused pipeline composes them."""
    s, src, dst = plan.settings, plan.src, plan.dst
    cx = scale.select_scaler(src.width, dst.width, s.upscaling, s.downscaling,
                             s.interpolate_at_50pct)
    cy = scale.select_scaler(src.height, dst.height, s.upscaling,
                             s.downscaling, s.interpolate_at_50pct)
    wx = scale.build_axis_matrix(cx, src.width, dst.width)
    wy = scale.build_axis_matrix(cy, src.height, dst.height)
    ux, uy = chroma.chroma_upsample_matrices(
        src.width // 2, src.height // 2, 420, s.chroma_scaling,
        src.chroma_location)
    comp = lambda a, b: a if b is None else (b if a is None else a @ b)
    return {"wx": wx, "wy": wy, "cwx": comp(ux, wx), "cwy": comp(uy, wy)}


@pytest.fixture(scope="module")
def both_plans():
    return (_plans(jcfg, jcsp, jpipe, jfmt), _plans(tcfg, tcsp, tpipe, tfmt))


@pytest.mark.parametrize("key", ["headline", "c1"])
def test_plan_equal(both_plans, key):
    jp, tp = both_plans[0][key], both_plans[1][key]
    assert np.array_equal(jp.cmat_m, tp.cmat_m)
    assert np.array_equal(jp.cmat_c, tp.cmat_c)
    for f in ("apply_matrix", "convert_to_sdr", "hlg_to_pq", "fix_bt2020_sdr",
              "sdr_gamma", "dither_bits", "src_rect"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert (dataclasses.asdict(jp.tonemap_params)
            == dataclasses.asdict(tp.tonemap_params))
    assert jpipe.surface_pack_format(jp.dst) == tpipe.surface_pack_format(tp.dst)


@pytest.mark.parametrize("key,which", [
    ("headline", "wx"), ("headline", "wy"), ("headline", "cwx"),
    ("headline", "cwy"), ("c1", "cwx"), ("c1", "cwy")])
@pytest.mark.parametrize("kb_align", [128, 16])
def test_tap_tables_from_both_packages(both_plans, key, which, kb_align):
    """The matrices are equal; the port's tap table of the matrix equals
    the one converted from the JAX package's band packing (128-aligned W
    windows and 16-aligned H windows); applying the table gives x @ mat."""
    jm = _plane_matrices(jscale, jchroma, both_plans[0][key])[which]
    tm = _plane_matrices(tscale, tchroma, both_plans[1][key])[which]
    assert np.array_equal(jm, tm)
    m32 = np.asarray(tm, np.float32)
    starts, taps = trk.plan_taps(m32)
    packed = jrp._pack_band(m32, kb_align=kb_align)
    s2, t2 = trk.taps_from_band_pack(*packed, w_out=m32.shape[1])
    assert np.array_equal(starts, s2) and np.array_equal(taps, t2)
    assert taps.shape[0] <= 16, "a band far wider than the filter"

    rng = np.random.default_rng(7)
    x = rng.random((3, m32.shape[0]))
    n_in = m32.shape[0]
    idx = starts[None, :] + np.arange(taps.shape[0])[:, None]
    xg = np.where(idx < n_in, x[:, np.minimum(idx, n_in - 1)], 0.0)
    got = (xg * taps).sum(axis=1)
    np.testing.assert_allclose(got, x @ m32.astype(np.float64), atol=1e-6)


def test_plan_taps_edge_cases():
    m = np.zeros((5, 3), np.float32)
    m[4, 0] = 1.0              # a band that ends at the last input
    m[[1, 3], 1] = 0.5         # a zero inside the band
    starts, taps = trk.plan_taps(m)   # column 2 has no weights
    assert starts.tolist() == [4, 1, 0]
    assert taps.shape == (3, 3)
    assert taps[:, 0].tolist() == [1.0, 0.0, 0.0]
    assert taps[:, 1].tolist() == [0.5, 0.0, 0.5]
    assert not taps[:, 2].any()


# --- what the port refuses, and its devices ---------------------------------

def _hl(**kw):
    settings = kw.pop("settings", tcfg.Settings())
    dst = kw.pop("dst", tpipe.OutputDescriptor(width=64, height=32, bits=10))
    src = tpipe.SourceDescriptor(
        format=kw.pop("format", tfmt.ColorFormat.P010), width=128, height=64,
        transfer=tcsp.TRC.PQ, primaries=tcsp.Primaries.BT_2020,
        matrix=tcsp.CSP.BT_2020_NC, **kw)
    return settings, src, dst


def _identity_dovi():
    return tdovi.DoviMetadata(
        curves=(tdovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.zeros(3),
        rgb_to_lms_matrix=np.linalg.inv(tdovi.DOVI_LMS2RGB))


def _formerly_unported(case: str, m: dict):
    """The plans the port refused before it carried the L2 trims, the
    extension blocks, HDR10+ and Dolby Vision's local tone map, in package
    ``m`` (tests/torch_hdr_cells.py's JAX or TORCH)."""
    pipe = m["pipe"]
    src = dict(dovi=hdr_cells.dovi_meta(m["dovi"]))
    if case == "dovi_trims":
        src["dovi_trims"] = m["tonemap"].DoviTrims(
            trim_slope=1.1, trim_power=0.9, saturation_gain=0.1,
            l2_enabled=True)
    elif case == "dovi_ext":
        src["dovi_ext"] = hdr_cells.dovi_extensions(m["ext"])
    elif case == "hdr10plus":
        src = dict(hdr10plus=hdr_cells.guided_meta(m["h10p"]))
    hdr = case in ("hdr10plus", "local_tonemap")
    settings = m["cfg"].Settings(hdr_local_tone_mapping=hdr,
                                 convert_to_sdr=not hdr,
                                 hdr_passthrough=hdr)
    return (settings,
            pipe.SourceDescriptor(
                format=m["fmt"].P010, width=128, height=64,
                transfer=m["csp"].TRC.PQ, primaries=m["csp"].Primaries.BT_2020,
                matrix=m["csp"].CSP.BT_2020_NC, hdr10=pipe.HDR10Metadata(),
                **src),
            pipe.OutputDescriptor(width=64, height=32, bits=10, hdr=hdr))


@pytest.mark.parametrize("case", ["dovi", "dovi_ext", "hdr10plus",
                                  "local_tonemap"])
def test_formerly_unported_plans_match_jax(case):
    """Dolby Vision's L2 trims, its extension blocks, HDR10+ and Dolby
    Vision with the local tone map (HDR output) now plan as in the JAX
    package: every plan field and the output signal equal."""
    case = "dovi_trims" if case == "dovi" else case
    jm = dict(hdr_cells.JAX, tonemap=jtonemap)
    tm = dict(hdr_cells.TORCH, tonemap=ttonemap)
    jplan = jpipe.plan_pipeline(*_formerly_unported(case, jm))
    tplan = tpipe.plan_pipeline(*_formerly_unported(case, tm))
    assert hdr_cells.plan_differences(jplan, tplan) == []
    assert (tpipe.output_signal_info(tplan).to_dict()
            == jpipe.output_signal_info(jplan).to_dict())
    assert tpipe.serving_rt_keys(tplan) == jpipe.serving_rt_keys(jplan)
    assert (tpipe.route_of(tplan) == "fused") == jpipe._can_fuse(jplan)
    assert ((tpipe.route_of(tplan) == "dovi_fused")
            == jpipe._can_split_fuse(jplan))


@pytest.mark.parametrize("case", [
    dict(format=tfmt.ColorFormat.Y16),
    dict(settings=tcfg.Settings(vp_scaling=False)),
    # Jinc2 in the shader order: the staged path, no K6 route
    dict(settings=tcfg.Settings(upscaling=tcfg.Upscaling.JINC2,
                                vp_scaling=False),
         dst=tpipe.OutputDescriptor(width=256, height=128, bits=10)),
    # Dolby Vision with placement: K9 with the rect's offset
    dict(dovi=_identity_dovi(),
         dst=tpipe.OutputDescriptor(width=64, height=32, bits=10,
                                    video_rect=(0, 0, 32, 32))),
], ids=["gray", "shader_order", "jinc2", "video_rect"])
def test_formerly_refused_plans_run(case):
    """GRAY sources, the shader order and Dolby Vision in a rect plan and
    render on the CPU: a frame of the output's size, every code finite."""
    settings, src, dst = _hl(**case)
    plan = tpipe.plan_pipeline(settings, src, dst)
    rng = np.random.default_rng(3)
    n = 1 if plan.info.cs_type == tfmt.ColorSystem.GRAY else 3
    planes = tuple(torch.from_numpy(
        rng.integers(0, 65535, (1, src.height // (1 + (i > 0)),
                                src.width // (1 + (i > 0))), np.uint16))
        for i in range(n))
    out = tpipe.make_frame_fn(plan)(planes)
    assert out.shape == (1, 3, dst.height, dst.width)
    assert torch.isfinite(out).all()


def test_rotation_refused():
    """Rotation and flip are ported; angles other than 0/90/180/270 are
    refused."""
    plan = tpipe.plan_pipeline(*_hl())
    tpipe.make_frame_fn(plan, rotation=90, flip=True)
    with pytest.raises(ValueError, match="rotation"):
        tpipe.make_frame_fn(plan, rotation=45)


@pytest.mark.parametrize("dst", [
    tpipe.OutputDescriptor(width=64, height=32, bits=10),             # 2020 fix
    tpipe.OutputDescriptor(width=64, height=32, bits=16)])            # 2020 fix
def test_kernel_tail_refuses_unported_corrections(dst):
    """The SDR BT.2020 fix is K2's (CORR_FIX_BT2020, its gamma by value
    with the launch): the kernel path plans it and matches the plain path;
    a correction the tail kernels do not carry is refused by the epilogue,
    not run elsewhere."""
    src = tpipe.SourceDescriptor(format=tfmt.ColorFormat.P010, width=128,
                                 height=64, transfer=tcsp.TRC.GAMMA28,
                                 primaries=tcsp.Primaries.BT_2020)
    # float output with float32 intermediates (FLOAT16), as the plain path
    float_out = dst.bits == 16
    tex = tcfg.TexFormat.FLOAT16 if float_out else tcfg.TexFormat.AUTOINT
    vp = tpipe.VideoProcessor(tcfg.Settings(tex_format=tex), src, dst,
                              device="cpu")
    epi = tpipe._make_tail_epilogue(vp.plan)
    assert epi.correction == trk.CORR_FIX_BT2020 and epi.sdr_gamma == 2.8
    assert epi.host_mats()[26] == np.float32(2.8)     # after cmat, gamut, tm
    rng = np.random.default_rng(4)
    planes = (rng.integers(0, 65535, (1, 64, 128), np.uint16),
              rng.integers(0, 65535, (1, 32, 64), np.uint16),
              rng.integers(0, 65535, (1, 32, 64), np.uint16))
    got = vp.process(planes)
    ref = tpipe.VideoProcessor(tcfg.Settings(use_accel_backend=False), src,
                               dst, device="cpu").process(planes)
    if float_out:
        assert (got - ref).abs().max() <= 1e-5
    else:       # tests/test_torch_slice.py's band for the kernel path
        d = ((got - ref).abs() * 1023).round()
        assert (d <= 1).float().mean() >= 0.999 and d.max() <= 3
    bad = dataclasses.replace(epi, correction=trk.CORR_FIX_BT2020 + 1)
    p = torch.zeros((1, 8, 8))
    with pytest.raises(NotImplementedError, match="correction"):
        trk.rows3_tail(p, p, p, None, None, 8, bad)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the absent-device path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.VideoProcessor(*_hl(), device="cuda")


def test_wrappers_refuse_other_devices():
    mat = trk.BandedMatrix(np.eye(4, dtype=np.float32))
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trk.banded_resize_last_axis(x, mat)


def test_build_names_library_by_sources_and_needs_nvcc(monkeypatch):
    from videorenderer_tpu_torch.kernels import build
    lib = build.library_path()
    assert lib.parent.parent == REPO / "videorenderer_tpu_torch" / "_build"
    assert lib == build.library_path()
    assert "videorenderer_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_import_keeps_jax_out():
    code = ("import sys, videorenderer_tpu_torch, videorenderer_tpu_torch.oracle, "
            "videorenderer_tpu_torch.kernels.build, "
            "videorenderer_tpu_torch.kernels.resize, "
            "videorenderer_tpu_torch.kernels.jinc2, "
            "videorenderer_tpu_torch.kernels.deint, "
            "videorenderer_tpu_torch.kernels.probe, torch_headline_micro, "
            "kernel_report, smoke_diff, chip_smoke, profile_torch, "
            "videorenderer_tpu_torch.ops.deinterlace, "
            "videorenderer_tpu_torch.ops.dovi, "
            "videorenderer_tpu_torch.runner, "
            "videorenderer_tpu_torch.ops.geometry, "
            "videorenderer_tpu_torch.api, videorenderer_tpu_torch.stats, "
            "videorenderer_tpu_torch.osd, videorenderer_tpu_torch.subtitles, "
            "videorenderer_tpu_torch.io.srt, videorenderer_tpu_torch.io.native, "
            "videorenderer_tpu_torch.ops.overlay, "
            "videorenderer_tpu_torch.kernels.unpack_device, "
            "videorenderer_tpu_torch.cli, videorenderer_tpu_torch.display, "
            "videorenderer_tpu_torch.proppage, "
            "videorenderer_tpu_torch.io.raw, videorenderer_tpu_torch.io.y4m, "
            "videorenderer_tpu_torch.io.image, "
            "videorenderer_tpu_torch.utils.trace, "
            "videorenderer_tpu_torch.models.checkpoint, "
            "videorenderer_tpu_torch.models.superres, "
            "videorenderer_tpu_torch.models.videohdr, "
            "videorenderer_tpu_torch.models.sr_train, "
            "videorenderer_tpu_torch.models.hdr_train, "
            "videorenderer_tpu_torch.models.real_eval, "
            "videorenderer_tpu_torch.models.optim, "
            "videorenderer_tpu_torch.parallel.mesh, "
            "videorenderer_tpu_torch.parallel.spatial; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('videorenderer_tpu.') or m == 'videorenderer_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    pkg = REPO / "videorenderer_tpu_torch"
    for p in pkg.rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or s.startswith(("import videorenderer_tpu ",
                                         "from videorenderer_tpu ",
                                         "from videorenderer_tpu.",
                                         "import videorenderer_tpu."))), \
                f"{p}: {line}"
