"""The two-stage Dolby Vision form (``VRT_TPU_DOVI_MID=0``) of
videorenderer_tpu_torch against the JAX package, on the CPU at small sizes:
the same metadata and frames (numpy, from a seed) through the JAX function
and its port.

 * K2's Dolby Vision route (``kernels/resize.rows3_tail_dovi``; its plain
   version on CPU tensors) against the JAX ``rows3_tail`` with the
   pipeline's stage-A epilogues, ``_epi_a`` (static curves) and
   ``_epi_a_rt`` (a scene's curves as runtime scalars), in interpret mode:
   c8's metadata and a variant where neither the reshape nor the LMS step
   folds; 4:2:0 (K1's float32 chroma through the H upsample), 4:4:4 (the
   raw chroma read directly) and the blend map.  Within ``A_TOL`` (1e-5),
   or ``A_LMS_TOL`` (1e-4) with the LMS step: K8's band.
 * The port's two-stage serving function (the kernel route, plain versions)
   against the JAX two-stage serving function in interpret mode, on the two
   cases of ``tests/test_pallas_resize.py`` (``rt["hdr"]`` with the local
   tone map; a two-piece polynomial luma curve and order-2 MMR chroma
   curves through the runtime scalars) and on c8, the variant, 4:4:4, the
   blend map, c8x (the L2 trims) and a placed plan: within ``SERVE_TOL``
   (2.5/1023, over 0.5/1023 on < 1% of the channels: that test's band).
 * The port with "0" against the port with "1" (the one-intermediate chain,
   K8 + K9): the same band.
 * The launch counts of both settings, placed plans included (the kernel
   wrappers counted; the CPU launches nothing).
 * The stage-A maps of every Dolby Vision plan built here and at c8's full
   size: K2's route is the staged one (``k2_route``), and the windows fit
   the Dolby Vision route's shared memory (``k2_dovi_smem_bytes``; it has
   no long-window route).

The JAX kernel paths run as the JAX tests run them on the CPU:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``, with ``VRT_TPU_DOVI_MID`` set.  The
port's kernel route is taken only for planes on a CUDA device; here the
tests patch ``pipeline._on_card`` to take it with the plain versions.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import chroma as jchroma

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import dovi as tdovi

from torch_hdr_cells import (JAX, TORCH, cell_args, dovi_extensions,
                             dovi_kind_meta as _meta)

# K2's Dolby Vision route against the JAX rows3_tail (float32 PQ values in
# [0, ~2]): the JAX kernel's split-bf16 H products; with the LMS step also
# XLA's float32 transcendentals in its PQ round trip (K8's band)
A_TOL = 1e-5
A_LMS_TOL = 1e-4
# the two-stage serving outputs (float, 10-bit dither): the band
# tests/test_pallas_resize.py holds the JAX two-stage form to against its
# XLA route: at most 2.5/1023, over 0.5/1023 on < 1% of the channels
SERVE_TOL = (2.5 / 1023, 0.5 / 1023, 0.01)


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix): each test gets its
    own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- metadata ----------------------------------------------------------------

# --- K2's Dolby Vision route against the JAX rows3_tail ------------------------

# geometry: (format, chroma path, blend map); 64 x 40 frames (40 rows: a
# height that is not a multiple of the kernel's 32-row tile)
A_CASES = {"420": ("P010", "map", False), "444": ("444", "direct", False),
           "blend": ("P010", "map", True), "nv12": ("NV12", "map", False)}


def _a_inputs(case: str, seed: int, w: int = 64, h: int = 40):
    """Stage A's inputs: the luma codes, the chroma as stage A reads it
    (K1's normalised float32 W upsample, or the raw 4:4:4 codes), the blend
    map, the chroma's H upsample and the normalisation."""
    fmt, chroma, blend = A_CASES[case]
    rng = np.random.default_rng(seed)
    if fmt == "NV12":
        norm, y = 1.0 / 255.0, rng.integers(16, 236, (2, h, w), np.uint8)
    else:
        norm = 1.0 / 65535.0
        y = rng.integers(64, 941, (2, h, w), np.uint16) << 6
    if chroma == "map":
        u, v = (rng.uniform(0.06, 0.94, (2, h // 2, w)).astype(np.float32)
                for _ in range(2))
        _, uy = jchroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, JAX["cfg"].ChromaScaling.BILINEAR,
            JAX["csp"].ChromaLocation.MPEG2)
        uy = np.asarray(uy, np.float32)
    else:
        u, v = ((rng.integers(64, 961, (2, h, w), np.uint16) << 6)
                for _ in range(2))
        uy = None
    by = (np.asarray(jchroma.blend_deinterlace_matrix(h), np.float32)
          if blend else None)
    return (y, u, v), by, uy, norm


def _jax_epilogue(jm, m, c, rt: bool):
    """The JAX pipeline's stage-A epilogue, _epi_a or _epi_a_rt
    (videorenderer_tpu/pipeline.py:1097-1111)."""
    jdovi = JAX["dovi"]
    if not rt:
        def epi_a(yt, ut, vt):
            comps = jdovi.reshape(jnp.stack([yt, ut, vt]), jm, axis=0)
            rgb = jnp.stack([m[i, 0] * comps[0] + m[i, 1] * comps[1]
                             + m[i, 2] * comps[2] + c[i] for i in range(3)])
            return jdovi.apply_lms_matrix(rgb, jm, axis=0)
        return epi_a
    struct = jdovi.curve_structure(jm)

    def epi_a_rt(yt, ut, vt, ref):
        yc, uc, vc = jdovi.reshape_tiles_from_scalars(
            (yt, ut, vt), lambda i: ref[i], 12, struct)
        rgb = jnp.stack([ref[4 * i] * yc + ref[4 * i + 1] * uc
                         + ref[4 * i + 2] * vc + ref[4 * i + 3]
                         for i in range(3)])
        return jdovi.apply_lms_matrix(rgb, jm, axis=0)
    return epi_a_rt


@pytest.mark.parametrize("rt", [False, True])
@pytest.mark.parametrize("kind", ["c8", "variant"])
@pytest.mark.parametrize("case", list(A_CASES))
def test_k2_dovi_plain_matches_jax_rows3_tail(case, kind, rt):
    (y, u, v), by, uy, norm = _a_inputs(case, 3)
    h = y.shape[-2]
    jm, tm = _meta(JAX, kind), _meta(TORCH, kind)
    m, c = JAX["dovi"].build_ycc_to_rgb_cmat(jm)
    m32, c32 = np.asarray(m, np.float32), np.asarray(c, np.float32)
    c_scale = None if uy is not None else norm
    scene = ({k: val * np.float32(0.98)
              for k, val in tdovi.pack_curves(tm).items()} if rt else None)
    rt_vec = None
    if rt:
        rt_vec = jnp.concatenate([
            jpipe._pack_cmat_rt(m32, c32),
            JAX["dovi"].flatten_curve_scalars(
                {k: jnp.asarray(val) for k, val in scene.items()},
                JAX["dovi"].curve_structure(jm))])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.rows3_tail(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), by, uy, h,
            _jax_epilogue(jm, m32, c32, rt), y_scale=norm, c_scale=c_scale,
            rt_scalars=rt_vec))
    got = trk.rows3_tail_dovi(
        t(y), t(u), t(v),
        None if by is None else trk.BandedMatrix(by, pre_scale=norm),
        None if uy is None else trk.BandedMatrix(uy), h,
        tdovi.mid_stage(tm, m, c, scene),
        y_scale=None if by is not None else norm, c_scale=c_scale)
    assert got.shape == ref.shape == (2, 3, h, y.shape[-1])
    assert all(got[:, i].is_contiguous() for i in range(3))
    tol = A_TOL if kind == "c8" else A_LMS_TOL
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_k2_dovi_plain_is_the_convert():
    """The plain version is K2's plain H contraction, then the torch convert
    of the plain route (reshape, colour matrix, LMS step), written out."""
    (y, u, v), _, uy, norm = _a_inputs("420", 4)
    tm = _meta(TORCH, "variant")
    m, c = tdovi.build_ycc_to_rgb_cmat(tm)
    got = trk.rows3_tail_dovi(t(y), t(u), t(v), None, trk.BandedMatrix(uy),
                              40, tdovi.mid_stage(tm, m, c), y_scale=norm)
    ycc = torch.stack([t(y).float() * np.float32(norm),
                       t(uy).T @ t(u), t(uy).T @ t(v)], dim=-3)
    rgb = tpipe._apply_cmat(np.float32(m), np.float32(c),
                            *tdovi.reshape(ycc, tm).unbind(-3))
    want = tdovi.apply_lms_matrix(rgb, tm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_k2_dovi_refuses_bad_input():
    (y, u, v), _, uy, norm = _a_inputs("420", 5)
    tm = _meta(TORCH, "c8")
    mid = tdovi.mid_stage(tm, *tdovi.build_ycc_to_rgb_cmat(tm))
    ty, tu, tv = t(y), t(u), t(v)
    kin = trk.BandedMatrix(uy)
    with pytest.raises(ValueError, match="no H matrix"):
        trk.rows3_tail_dovi(ty, tu, tv, None, None, 40, mid)
    with pytest.raises(ValueError, match="scale goes into"):
        trk.rows3_tail_dovi(ty, tu, tv, None, kin, 40, mid, c_scale=1.0)
    with pytest.raises(ValueError, match="share shape"):
        trk.rows3_tail_dovi(ty, tu, tv[..., :8, :], None, kin, 40, mid)
    cm = torch.zeros((1, 20, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trk.rows3_tail_dovi(torch.zeros((1, 40, 64), device="meta"), cm, cm,
                            None, kin, 40, mid)


# --- the serving function --------------------------------------------------------

# case: (metadata, format, w, h, ow, oh, output, rt); output "sdr" is c8's
# (PQ -> SDR, RGB10 dither), "hdr" the HDR passthrough with the BT.2390
# local tone map at 600 nits
HDR_RT = {"hdr": {"mastering_min_nits": 0.005, "mastering_max_nits": 2000.0,
                  "max_cll": 1500.0, "max_fall": 500.0,
                  "display_max_nits": 650.0}}
SERVE_CASES = {
    # tests/test_pallas_resize.py:486-554 and :557-603
    "hdr": ("c8", "P010", 64, 48, 128, 96, "hdr", "hdr"),
    "mmr": ("mmr", "P010", 64, 48, 32, 24, "sdr", "curves"),
    "c8": ("c8", "P010", 64, 32, 32, 16, "sdr", "curves"),
    "variant": ("variant", "P010", 64, 32, 32, 16, "sdr", "curves"),
    "444": ("variant", "YUV444P10", 64, 32, 32, 16, "sdr", None),
    "blend": ("c8", "P010", 64, 32, 32, 16, "sdr", None),
    "placed": ("variant", "P010", 64, 32, 48, 40, "sdr", "curves"),
    "c8x": ("c8x", "P010", 64, 32, 32, 16, "sdr", "trims"),
}


def _serve_args(m: dict, case: str, accel: bool = True):
    kind, fmt, w, h, ow, oh, out, _ = SERVE_CASES[case]
    if kind == "c8x":
        return cell_args(m, "c8x", w=w, h=h, ow=ow, oh=oh)
    cfg, csp, pipe = m["cfg"], m["csp"], m["pipe"]
    if out == "hdr":
        settings = cfg.Settings(
            convert_to_sdr=False, hdr_passthrough=True,
            hdr_local_tone_mapping=True,
            hdr_local_tone_mapping_type=cfg.ToneMapType.BT2390,
            hdr_display_max_nits=600, upscaling=cfg.Upscaling.CATMULL_ROM,
            use_accel_backend=accel)
    else:
        settings = cfg.Settings(convert_to_sdr=True,
                                upscaling=cfg.Upscaling.CATMULL_ROM,
                                deint_blend=case == "blend",
                                use_accel_backend=accel)
    src = pipe.SourceDescriptor(
        format=getattr(m["fmt"], fmt), width=w, height=h,
        matrix=csp.CSP.BT_2020_NC, levels=csp.Levels.TV,
        primaries=csp.Primaries.BT_2020, transfer=csp.TRC.PQ,
        dovi=_meta(m, kind), hdr10=pipe.HDR10Metadata(),
        interlaced=case == "blend")
    rect = (8, 4, 40, 20) if case == "placed" else None
    return settings, src, pipe.OutputDescriptor(width=ow, height=oh, bits=10,
                                                hdr=out == "hdr",
                                                video_rect=rect)


def _plans(case: str):
    return (jpipe.plan_pipeline(*_serve_args(JAX, case)),
            tpipe.plan_pipeline(*_serve_args(TORCH, case)))


def _frames(case: str, seed: int, n: int = 2):
    _, fmt, w, h, *_ = SERVE_CASES[case]
    rng = np.random.default_rng(seed)
    cw, ch = (w, h) if fmt == "YUV444P10" else (w // 2, h // 2)
    if fmt == "YUV444P10":   # 10-bit codes in the low bits
        return (rng.integers(64, 941, (n, h, w), np.uint16),
                *(rng.integers(64, 961, (n, ch, cw), np.uint16)
                  for _ in range(2)))
    return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
            *(rng.integers(64, 961, (n, ch, cw), np.uint16) << 6
              for _ in range(2)))


def _rt(m: dict, plan, case: str, scene: int = 1) -> dict:
    """The case's serving values of one scene: HDR10 values, curves scaled
    as chip_smoke.dovi_rt scales c8's scenes, or c8x's trims (and curves)."""
    what = SERVE_CASES[case][-1]
    if what == "hdr":
        return HDR_RT
    rt = {}
    if what in ("curves", "trims"):
        rt["dovi_curves"] = {
            k: v * np.float32(1.0 - 0.01 * scene)
            for k, v in m["dovi"].pack_curves(plan.dovi).items()}
    if what == "trims":
        rt["l2_trims"] = m["ext"].runtime_trims_from_extensions(
            dovi_extensions(m["ext"], max_pq=3079 - 120 * scene), 100.0)
    return rt


def _jax_two_stage(monkeypatch, jplan, planes, rt):
    """The JAX two-stage serving function in interpret mode."""
    jrt = dict(rt)
    if "dovi_curves" in jrt:
        jrt["dovi_curves"] = {k: jnp.asarray(v)
                              for k, v in jrt["dovi_curves"].items()}
    with monkeypatch.context() as mp:
        mp.setenv("VRT_TPU_DOVI_MID", "0")
        mp.setattr(jax, "default_backend", lambda: "tpu")
        fn = jpipe.make_serving_fn(jplan)
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(tuple(jnp.asarray(p) for p in planes), jrt))


def _port(monkeypatch, tplan, planes, rt, mid: str | None):
    """The port's serving function on its kernel route (plain versions),
    with VRT_TPU_DOVI_MID at ``mid`` (None: unset)."""
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    if mid is None:
        monkeypatch.delenv("VRT_TPU_DOVI_MID", raising=False)
    else:
        monkeypatch.setenv("VRT_TPU_DOVI_MID", mid)
    return tpipe.make_serving_fn(tplan)(tuple(t(p) for p in planes),
                                        rt).numpy()


def assert_serve_band(got, ref):
    max_d, step, frac = SERVE_TOL
    d = np.abs(got.astype(np.float64) - ref)
    assert got.shape == ref.shape
    assert d.max() <= max_d and (d > step).mean() < frac, (d.max(),
                                                           (d > step).mean())


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_two_stage_serving_matches_jax_two_stage(case, monkeypatch):
    jplan, tplan = _plans(case)
    planes = _frames(case, 31)
    ref = _jax_two_stage(monkeypatch, jplan, planes, _rt(JAX, jplan, case))
    got = _port(monkeypatch, tplan, planes, _rt(TORCH, tplan, case), "0")
    _, _, _, _, ow, oh, *_ = SERVE_CASES[case]
    assert got.shape == (2, 3, oh, ow)
    assert_serve_band(got, ref)
    if case == "placed":
        l, tp, r, b = tplan.dst.video_rect
        bars = np.ones((oh, ow), bool)
        bars[tp:b, l:r] = False
        assert not got[..., bars].any() and not ref[..., bars].any()


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_two_stage_matches_mid_chain(case, monkeypatch):
    """The port's two forms on the same call: "0" against "1"."""
    _, tplan = _plans(case)
    planes = _frames(case, 32)
    rt = _rt(TORCH, tplan, case)
    two = _port(monkeypatch, tplan, planes, rt, "0")
    one = _port(monkeypatch, tplan, planes, rt, "1")
    assert_serve_band(two, one)


def _counted(monkeypatch) -> list:
    calls = []
    for mod, name in ((trk, "banded_resize_last_axis"), (trk, "rows3_tail"),
                      (trk, "rows3_tail_dovi"), (trk, "banded_resize_rows"),
                      (tdk, "rows3_mid"), (tdk, "cols3_tail")):
        def wrap(*a, _o=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, wrap)
    return calls


K1 = "banded_resize_last_axis"


@pytest.mark.parametrize("case", ["c8", "placed", "hdr", "c8x"])
@pytest.mark.parametrize("mid", [None, "1", "0"])
def test_launch_counts(case, mid, monkeypatch):
    """Unset or "1": K1 x2 + K8 + K9 a call; "0": K1 ×2 + K2's Dolby
    Vision route, K1 x3 + K2 (placed plans too); the switch read at every
    call of one function."""
    _, tplan = _plans(case)
    planes = tuple(t(p) for p in _frames(case, 33))
    rt = _rt(TORCH, tplan, case)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    calls = _counted(monkeypatch)
    one = [K1, K1, "rows3_mid", "cols3_tail"]
    two = [K1, K1, "rows3_tail_dovi", K1, K1, K1, "rows3_tail"]
    for setting in (mid, "0" if mid != "0" else "1"):
        calls.clear()
        if setting is None:
            monkeypatch.delenv("VRT_TPU_DOVI_MID", raising=False)
        else:
            monkeypatch.setenv("VRT_TPU_DOVI_MID", setting)
        fn(planes, rt)
        assert calls == (two if setting == "0" else one)


def test_plain_routes_ignore_the_switch(monkeypatch):
    """The CPU (no card) and use_accel_backend off keep the plain route
    under either setting: no kernel wrapper is called."""
    _, tplan = _plans("c8")
    planes = tuple(t(p) for p in _frames("c8", 34))
    off = tpipe.plan_pipeline(*_serve_args(TORCH, "c8", accel=False))
    calls = _counted(monkeypatch)
    outs = []
    for setting in ("0", "1"):
        monkeypatch.setenv("VRT_TPU_DOVI_MID", setting)
        outs += [tpipe.make_serving_fn(tplan)(planes).numpy(),
                 tpipe.make_serving_fn(off)(planes).numpy()]
    assert calls == []
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


# --- the stage-A maps' routes ------------------------------------------------------

def _full_c8(**src):
    """c8 at its full size: 4K P010 Dolby Vision -> 1080p RGB10."""
    cfg, pipe = TORCH["cfg"], TORCH["pipe"]
    args = list(_serve_args(TORCH, "c8"))
    args[0] = dataclasses.replace(args[0], deint_blend=bool(src))
    args[1] = dataclasses.replace(args[1], width=3840, height=2160, **src)
    args[2] = pipe.OutputDescriptor(width=1920, height=1080, bits=10)
    assert cfg.Upscaling.CATMULL_ROM == args[0].upscaling
    return tpipe.plan_pipeline(*args)


def _stage_a_plans():
    plans = {case: _plans(case)[1] for case in SERVE_CASES}
    plans["c8_full"] = _full_c8()
    plans["c8_full_blend"] = _full_c8(interlaced=True)
    return plans


@pytest.mark.parametrize("case", list(SERVE_CASES) + ["c8_full",
                                                      "c8_full_blend"])
def test_stage_a_maps_take_the_staged_route(case):
    """Stage A's H maps (the chroma upsample, the blend map) reach a few
    rows an output row: K2's route for them is the staged one, and their
    windows fit the Dolby Vision route's shared memory (it has no
    long-window route)."""
    plan = _stage_a_plans()[case]
    kw_c, kin_y, kin_c, y_scale, c_scale = tpipe.dovi_kernel_maps(plan)
    y_size = 2 if plan.info.plane_bits > 8 else 1
    c_size = 4 if kw_c is not None else y_size
    mid = tdovi.mid_stage(plan.dovi, plan.cmat_m, plan.cmat_c)
    assert trk.k2_route(y_size, c_size, kin_y, kin_c) == "staged"
    assert trk.k2_dovi_smem_bytes(y_size, c_size, kin_y, kin_c,
                                  mid.host_values().size) <= trk.SMEM_BUDGET
    assert (kin_y is not None) == case.endswith("blend")
    assert (kin_c is None) == (case == "444")
    assert (y_scale is None) == (kin_y is not None)
    assert (c_scale is None) == (case != "444")


def test_k2_dovi_route_refuses_long_windows():
    """A map whose windows do not fit shared memory is refused (the wrapper
    raises on the card; there is no long-window route)."""
    # every output row reaches all 2160 input rows: a 553 KB window
    tall = trk.BandedMatrix(np.full((2160, 16), 1.0 / 2160, np.float32))
    assert trk.k2_dovi_smem_bytes(2, 4, tall, None, 21 + 9) \
        > trk.SMEM_BUDGET
    assert trk.k2_route(2, 4, tall, None) == "long-window"
