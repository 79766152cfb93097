"""Dolby Vision in videorenderer_tpu_torch (c8: 4K P010 DoVi -> 1080p SDR
RGB10, served with per-scene curves) against the JAX package, at small
sizes on the CPU: the same metadata and frames (numpy, from a seed) through
the JAX function and its port.

 * Host side of ``ops/dovi`` (metadata, RPU scaling, packed curves, the
   flat scalar layout, matrices): ``np.array_equal``.
 * The torch ``reshape``, ``reshape_dynamic``, ``apply_lms_matrix`` and
   ``reshape_from_scalars``: float32 rounding (1e-6 on [0, 1] signals;
   1e-4 for the LMS step's PQ round trip, whose float32 transcendentals
   differ between XLA and torch),
   for c8's identity metadata and a variant with a 2-piece polynomial on Y,
   a polynomial + MMR order-2 curve on Cb, an MMR order-3 curve on Cr and
   2% LMS crosstalk (so neither the reshape nor the LMS step folds away).
 * K8's plain version against the JAX ``rows3_mid`` in interpret mode:
   within ``K8_TOL`` (the JAX kernel's split-bf16 H products), static and
   runtime curves, with and without the in and out maps.
 * The DoVi paths end to end (``make_frame_fn``, ``make_serving_fn`` over
   two scenes): the port's kernel route (K1, K8, K9 as plain versions on
   the CPU) against the JAX kernel route, and the plain routes against the
   JAX XLA routes, in 10-bit codes; the bad-key error and the structure
   guard.
 * ``oracle_dovi`` against the JAX package's float64 serving output:
   >= 55 dB.

The JAX kernel paths run as the JAX tests run them on the CPU:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``.  The port's kernel route is taken
only for planes on a CUDA device; here the tests patch
``pipeline._on_card`` to take it with the plain versions.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.kernels import deint_pallas as jdp
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import chroma as jchroma
from videorenderer_tpu.ops import dovi as jdovi
from videorenderer_tpu.ops import scale as jscale

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.oracle import oracle_dovi

# K8's plain version against the JAX kernel (float32 PQ values in [0, ~2]):
# the JAX kernel's split-bf16 H products (in and out maps) and XLA's
# float32 transcendentals in the LMS step's PQ round trip; measured at most
# 4.1e-5 (the variant) and 1.1e-5 (c8), held at 1e-4
K8_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def codes10(x):
    d = np.asarray(x).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)], -3).astype(np.int64)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- metadata: c8's and a variant where nothing folds ------------------------

YCC_TO_RGB = np.array([[1, 0, 1.4746], [1, -0.164553, -0.571353],
                       [1, 1.8814, 0]])


def _fields(kind: str) -> dict:
    """The fields of a DoviMetadata, as numpy arrays and tuples."""
    identity = dict(pivots=(), method=(0,), poly=np.array([[0.0, 1.0, 0.0]]),
                    mmr_order=(), mmr_constant=(), mmr_coef=None)
    if kind == "c8":
        return dict(curves=(identity,) * 3, ycc_to_rgb_matrix=YCC_TO_RGB,
                    ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
                    rgb_to_lms_matrix=np.linalg.inv(jdovi.DOVI_LMS2RGB))
    rng = np.random.default_rng(21)
    y = dict(pivots=(0.45,), method=(0, 0),
             poly=np.array([[0.01, 0.95, 0.05], [-0.02, 1.05, -0.03]])
             + rng.uniform(-0.005, 0.005, (2, 3)),
             mmr_order=(), mmr_constant=(), mmr_coef=None)
    cb_coef = np.zeros((2, 3, 7))
    cb_coef[1, 0] = [0.0, 0.98, 0.0, 0.02, 0.0, -0.01, 0.0]
    cb_coef[1, 1] = [0.0, 0.01, 0.0, 0.0, 0.005, 0.0, 0.01]
    cb = dict(pivots=(0.5,), method=(0, 1),
              poly=np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
              mmr_order=(0, 2), mmr_constant=(0.0, 0.01), mmr_coef=cb_coef)
    cr_coef = np.zeros((1, 3, 7))
    cr_coef[0, 0] = [0.0, 0.0, 0.97, 0.0, 0.02, 0.01, 0.0]
    cr_coef[0, 1] = [0.0, 0.0, 0.02, 0.01, 0.0, 0.0, 0.0]
    cr_coef[0, 2] = [0.0, 0.0, 0.005, 0.0, 0.0, 0.0, 0.003]
    cr = dict(pivots=(), method=(1,), poly=np.array([[0.0, 1.0, 0.0]]),
              mmr_order=(3,), mmr_constant=(-0.005,), mmr_coef=cr_coef)
    crosstalk = 0.94 * np.eye(3) + 0.02
    return dict(curves=(y, cb, cr), ycc_to_rgb_matrix=YCC_TO_RGB,
                ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
                rgb_to_lms_matrix=np.linalg.inv(jdovi.DOVI_LMS2RGB)
                @ crosstalk)


def _metas(kind: str):
    """(JAX metadata, the port's) of the same fields; the port's is carried
    across with ``metadata_from_numpy``."""
    f = _fields(kind)
    jm = jdovi.DoviMetadata(
        curves=tuple(jdovi.ReshapeCurve(**c) for c in f["curves"]),
        ycc_to_rgb_matrix=f["ycc_to_rgb_matrix"],
        ycc_to_rgb_offset=f["ycc_to_rgb_offset"],
        rgb_to_lms_matrix=f["rgb_to_lms_matrix"])
    return jm, tdovi.metadata_from_numpy(dataclasses.asdict(jm))


def _scene(curves: dict, i: int) -> dict:
    """Scene i's values: every packed array times (1 - 0.01 i), as
    bench_common.dovi_rt makes c8's scenes."""
    return {k: v * np.float32(1.0 - 0.01 * i) for k, v in curves.items()}


KINDS = ["c8", "variant"]


# --- host side ---------------------------------------------------------------

def test_constants_equal():
    assert np.array_equal(tdovi.DOVI_LMS2RGB, jdovi.DOVI_LMS2RGB)
    ti, ji = tdovi.identity_curve(), jdovi.identity_curve()
    assert (ti.pivots, ti.method) == (ji.pivots, ji.method)
    assert np.array_equal(ti.poly, ji.poly)


def test_from_rpu_mapping_equal():
    rng = np.random.default_rng(3)
    n = 4
    raw = dict(num_pivots=n + 1, pivots=np.sort(rng.integers(0, 1024, n + 1)),
               mapping_idc=[0, 1, 0, 1], poly_order=[2, 0, 1, 0],
               poly_coef=rng.integers(-4096, 4096, (n, 3)).tolist(),
               mmr_order=[0, 3, 0, 2],
               mmr_constant=rng.integers(-512, 512, n).tolist(),
               mmr_coef=rng.integers(-2048, 2048, (n, 3, 7)).tolist(),
               bl_bit_depth=10, coef_log2_denom=23)
    a, b = jdovi.from_rpu_mapping(**raw), tdovi.from_rpu_mapping(**raw)
    for f in ("pivots", "method", "mmr_order", "mmr_constant"):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.poly, b.poly)
    assert np.array_equal(a.mmr_coef, b.mmr_coef)


@pytest.mark.parametrize("kind", KINDS)
def test_metadata_carried_across_and_host_side_equal(kind):
    jm, tm = _metas(kind)
    for a, b in zip(jm.curves, tm.curves):
        for f in ("pivots", "method", "mmr_order", "mmr_constant"):
            assert tuple(getattr(a, f)) == tuple(getattr(b, f)), f
        assert np.array_equal(a.poly, b.poly)
        assert (a.mmr_coef is None) == (b.mmr_coef is None)
        if a.mmr_coef is not None:
            assert np.array_equal(a.mmr_coef, b.mmr_coef)
    struct = jdovi.curve_structure(jm)
    assert tdovi.curve_structure(tm) == struct
    assert tdovi.curve_scalar_count(struct) == jdovi.curve_scalar_count(struct)
    jp, tp = jdovi.pack_curves(jm), tdovi.pack_curves(tm)
    assert set(jp) == set(tp)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k], jp[k]), k
    scene = _scene(tp, 2)
    assert np.array_equal(
        tdovi.flatten_curve_scalars(scene, struct),
        np.asarray(jdovi.flatten_curve_scalars(
            {k: jnp.asarray(v) for k, v in scene.items()}, struct)))
    for bc in ((0.0, 1.0), (0.1, 0.9)):
        for x, y in zip(tdovi.build_ycc_to_rgb_cmat(tm, *bc),
                        jdovi.build_ycc_to_rgb_cmat(jm, *bc)):
            assert np.array_equal(x, y)
    assert np.array_equal(tdovi.lms_pipeline_matrix(tm),
                          jdovi.lms_pipeline_matrix(jm))
    assert tdovi.lms_is_identity(tm) == (kind == "c8")


def test_pack_curves_structure_guard_matches_jax():
    jm, tm = _metas("c8")
    jv, tv = _metas("variant")
    struct = tdovi.curve_structure(tm)
    tdovi.pack_curves(tm, like=struct)
    with pytest.raises(ValueError, match="structure changed"):
        tdovi.pack_curves(tv, like=struct)
    with pytest.raises(ValueError, match="structure changed"):
        jdovi.pack_curves(jv, like=jdovi.curve_structure(jm))


def test_host_values_refuse_device_tensors():
    _, tm = _metas("c8")
    curves = {k: torch.from_numpy(v).to("meta")
              for k, v in tdovi.pack_curves(tm).items()}
    with pytest.raises(TypeError, match="host arrays"):
        tdovi.flatten_curve_scalars(curves, tdovi.curve_structure(tm))


# --- the torch side against JAX ------------------------------------------------

def _signal(seed, shape=(2, 3, 12, 16)):
    """ycc signals over [-0.05, 1.05]: the clamps and every piece occur."""
    return np.random.default_rng(seed).uniform(-0.05, 1.05, shape).astype(
        np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_reshape_matches_jax(kind):
    jm, tm = _metas(kind)
    x = _signal(1)
    ref = np.asarray(jdovi.reshape(jnp.asarray(x), jm, axis=-3))
    got = tdovi.reshape(t(x), tm, axis=-3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_reshape_dynamic_matches_jax(kind, structured):
    jm, tm = _metas(kind)
    x = _signal(2)
    scene = _scene(tdovi.pack_curves(tm), 3)
    if not structured:
        # the structure-free form reads is_mmr and mmr_order at run time
        scene = {**scene, **{k: tdovi.pack_curves(tm)[k]
                             for k in ("is_mmr", "mmr_order")}}
    struct = tdovi.curve_structure(tm) if structured else None
    ref = np.asarray(jdovi.reshape_dynamic(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in scene.items()},
        axis=-3, structure=struct))
    got = tdovi.reshape_dynamic(t(x), scene, axis=-3, structure=struct)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_lms_matrix_matches_jax(kind):
    jm, tm = _metas(kind)
    x = _signal(3) * np.float32(1.6)     # RPU-matrix outputs reach ~1.7
    ref = np.asarray(jdovi.apply_lms_matrix(jnp.asarray(x), jm, axis=-3))
    got = tdovi.apply_lms_matrix(t(x), tm, axis=-3).numpy()
    # XLA's and torch's float32 exp2/log2 differ by ulps, which the PQ round
    # trip amplifies (ROADMAP §3): measured 3.0e-5 (8.6e-6 on [0, 1])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 if kind == "variant" else 0)


@pytest.mark.parametrize("kind", KINDS)
def test_reshape_from_scalars_matches_jax(kind):
    jm, tm = _metas(kind)
    x = _signal(4, (3, 10, 14))
    struct = tdovi.curve_structure(tm)
    flat = tdovi.flatten_curve_scalars(_scene(tdovi.pack_curves(tm), 1),
                                       struct)
    ref = jdovi.reshape_tiles_from_scalars(
        [jnp.asarray(c) for c in x], lambda i: jnp.float32(flat[i]), 0, struct)
    got = tdovi.reshape_from_scalars([t(c) for c in x], flat, struct)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="curve scalars"):
        tdovi.reshape_from_scalars([t(c) for c in x], flat[:-1], struct)


# --- K8 ----------------------------------------------------------------------

# (format, width, height, in maps, out map): c8's form (luma read directly,
# chroma H upsample, 2:1 out), the blend map on the luma, no out map, the
# chroma read directly (a full-height chroma plane), and NV12 64x40 (chroma
# height 20, not a multiple of 16)
K8_CASES = {
    "c8": ("P010", 64, 32, "c", True),
    "blend": ("P010", 64, 32, "yc", True),
    "no_out": ("P010", 64, 32, "c", False),
    "direct_chroma": ("P010", 64, 32, "", True),
    "nv12_64x40": ("NV12", 64, 40, "c", True),
}


def _k8_inputs(case, seed):
    fmt, w, h, ins, out = K8_CASES[case]
    rng = np.random.default_rng(seed)
    if fmt == "P010":
        norm, y = 1.0 / 65535.0, (rng.integers(64, 941, (2, h, w),
                                               np.uint16) << 6)
    else:
        norm, y = 1.0 / 255.0, rng.integers(16, 236, (2, h, w), np.uint8)
    if "c" in ins:
        # the chroma after K1's W upsample: float32, normalised
        u, v = (rng.uniform(0.06, 0.94, (2, h // 2, w)).astype(np.float32)
                for _ in range(2))
        _, uy = jchroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, jcfg.ChromaScaling.BILINEAR,
            jcsp.ChromaLocation.MPEG2)
        uy = np.asarray(uy, np.float32)
    else:
        u, v = ((rng.integers(64, 961, (2, h, w), np.uint16) << 6)
                for _ in range(2))
        uy = None
    by = (np.asarray(jchroma.blend_deinterlace_matrix(h), np.float32)
          if "y" in ins else None)
    wy = (np.asarray(jscale.upscale_matrix(jcfg.Upscaling.CATMULL_ROM, h,
                                           h // 2), np.float32)
          if out else None)
    return (y, u, v), by, uy, wy, norm


def _jax_mid(jm, m, c, rt):
    """The DoVi mid_fn of the JAX _make_dovi_fused_fn, static or runtime."""
    if not rt:
        def mid(yt, ut, vt):
            comps = jdovi.reshape(jnp.stack([yt, ut, vt]), jm, axis=0)
            rgb = jnp.stack([m[i, 0] * comps[0] + m[i, 1] * comps[1]
                             + m[i, 2] * comps[2] + c[i] for i in range(3)])
            return jdovi.apply_lms_matrix(rgb, jm, axis=0)
        return mid
    struct = jdovi.curve_structure(jm)

    def mid_rt(yt, ut, vt, ref):
        yc, uc, vc = jdovi.reshape_tiles_from_scalars(
            (yt, ut, vt), lambda i: ref[i], 12, struct)
        rgb = jnp.stack([ref[4 * i] * yc + ref[4 * i + 1] * uc
                         + ref[4 * i + 2] * vc + ref[4 * i + 3]
                         for i in range(3)])
        return jdovi.apply_lms_matrix(rgb, jm, axis=0)
    return mid_rt


# every geometry with the variant (nothing folds), c8's own with both
K8_PARAMS = [(case, "variant") for case in K8_CASES] + [("c8", "c8"),
                                                        ("no_out", "c8")]


@pytest.mark.parametrize("rt", [False, True])
@pytest.mark.parametrize("case,kind", K8_PARAMS)
def test_k8_plain_matches_jax_kernel(case, kind, rt):
    (y, u, v), by, uy, wy, norm = _k8_inputs(case, 5)
    jm, tm = _metas(kind)
    m, c = jdovi.build_ycc_to_rgb_cmat(jm)
    m32, c32 = np.asarray(m, np.float32), np.asarray(c, np.float32)
    h_mid, h_out = y.shape[-2], (y.shape[-2] // 2 if wy is not None
                                 else y.shape[-2])
    c_scale = None if uy is not None else norm
    scene = _scene(tdovi.pack_curves(tm), 2) if rt else None
    rt_vec = None
    if rt:
        rt_vec = jnp.concatenate([
            jpipe._pack_cmat_rt(m32, c32),
            jdovi.flatten_curve_scalars(
                {k: jnp.asarray(val) for k, val in scene.items()},
                jdovi.curve_structure(jm))])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdp.rows3_mid(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), by, uy, h_mid,
            _jax_mid(jm, m32, c32, rt), wy, h_out,
            y_scale=norm, c_scale=c_scale, rt_scalars=rt_vec))
    got = tdk.rows3_mid(
        t(y), t(u), t(v),
        None if by is None else trk.BandedMatrix(by, pre_scale=norm),
        None if uy is None else trk.BandedMatrix(uy), h_mid,
        tdovi.mid_stage(tm, m, c, scene),
        None if wy is None else trk.BandedMatrix(wy), h_out,
        y_scale=None if by is not None else norm, c_scale=c_scale)
    got = torch.stack(got, dim=-3).numpy()
    assert got.shape == ref.shape == (2, 3, h_out, y.shape[-1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=K8_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_k8_plain_is_the_staged_convert(kind):
    """K8's plain version equals the chain it fuses, written out: the in
    maps, reshape, matrix and LMS step of ops/dovi, then the out map
    (float32 products in both, so within 1e-6)."""
    (y, u, v), _, uy, wy, norm = _k8_inputs("c8", 6)
    _, tm = _metas(kind)
    m, c = tdovi.build_ycc_to_rgb_cmat(tm)
    got = tdk.rows3_mid(t(y), t(u), t(v), None, trk.BandedMatrix(uy), 32,
                        tdovi.mid_stage(tm, m, c), trk.BandedMatrix(wy), 16,
                        y_scale=norm)
    assert all(g.is_contiguous() and g.shape == (2, 16, 64) for g in got)
    ycc = torch.stack([t(y).float() * np.float32(norm),
                       t(uy).T @ t(u), t(uy).T @ t(v)], dim=-3)
    rgb = tpipe._apply_cmat(np.float32(m), np.float32(c),
                            *tdovi.reshape(ycc, tm).unbind(-3))
    want = t(wy).T @ tdovi.apply_lms_matrix(rgb, tm)
    np.testing.assert_allclose(torch.stack(got, -3).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


def test_k8_wrapper_refuses_bad_input():
    (y, u, v), _, uy, wy, norm = _k8_inputs("c8", 7)
    _, tm = _metas("c8")
    mid = tdovi.mid_stage(tm, *tdovi.build_ycc_to_rgb_cmat(tm))
    ty, tu, tv = t(y), t(u), t(v)
    kin, kout = trk.BandedMatrix(uy), trk.BandedMatrix(wy)
    with pytest.raises(ValueError, match="no in map"):
        tdk.rows3_mid(ty, tu, tv, None, None, 32, mid, kout, 16)
    with pytest.raises(ValueError, match="in map"):
        tdk.rows3_mid(ty, tu, tv, kin, kin, 32, mid, kout, 16)
    with pytest.raises(ValueError, match="no out map"):
        tdk.rows3_mid(ty, tu, tv, None, kin, 32, mid, None, 16)
    with pytest.raises(ValueError, match="scale goes into"):
        tdk.rows3_mid(ty, tu, tv, None, kin, 32, mid, kout, 16, c_scale=1.0)
    with pytest.raises(ValueError, match="share shape"):
        tdk.rows3_mid(ty, tu, tv[..., :8, :], None, kin, 32, mid, kout, 16)
    meta = torch.zeros((1, 32, 64), device="meta")
    cm = torch.zeros((1, 16, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tdk.rows3_mid(meta, cm, cm, None, kin, 32, mid, kout, 16)


def test_mid_stage_layout():
    """The kernel's vectors: 12 + 9 + the curve scalars, and per channel the
    piece count, 8 kinds and 8 MMR orders."""
    _, tm = _metas("variant")
    st = tdovi.mid_stage(tm, *tdovi.build_ycc_to_rgb_cmat(tm))
    struct = tdovi.curve_structure(tm)
    vals = st.host_values()
    assert vals.dtype == np.float32
    assert vals.size == 21 + tdovi.curve_scalar_count(struct)
    assert np.array_equal(vals[12:21], st.lms.reshape(-1))
    hs = st.host_structure()
    assert hs.tolist()[1][:3] == [2, 0, 1] and hs[1, 9:11].tolist() == [0, 2]
    assert hs[2, 0] == 1 and hs[2, 1] == 1 and hs[2, 9] == 3
    _, c8 = _metas("c8")
    st8 = tdovi.mid_stage(c8, *tdovi.build_ycc_to_rgb_cmat(c8))
    assert st8.lms is None and not st8.host_values()[12:21].any()


# --- the paths -----------------------------------------------------------------

def _plan_args(cfg, csp, pipe, fmt, meta, *, fmt_name="P010", w=64, h=32,
               ow=32, oh=16, transfer="PQ", bits=10, **settings):
    settings.setdefault("convert_to_sdr", True)
    settings["upscaling"] = cfg.Upscaling.CATMULL_ROM
    return (cfg.Settings(**settings),
            pipe.SourceDescriptor(
                format=getattr(fmt, fmt_name), width=w, height=h,
                matrix=csp.CSP.BT_2020_NC, levels=csp.Levels.TV,
                primaries=csp.Primaries.BT_2020,
                transfer=getattr(csp.TRC, transfer), dovi=meta,
                hdr10=pipe.HDR10Metadata()),
            pipe.OutputDescriptor(width=ow, height=oh, bits=bits))


def _plans(kind, **kw):
    jm, tm = _metas(kind)
    return (jpipe.plan_pipeline(*_plan_args(jcfg, jcsp, jpipe, JFmt, jm, **kw)),
            tpipe.plan_pipeline(*_plan_args(tcfg, tcsp, tpipe, TFmt, tm, **kw)))


def _frame(kw, seed, n=2):
    w, h = kw.get("w", 64), kw.get("h", 32)
    rng = np.random.default_rng(seed)
    if kw.get("fmt_name", "P010") == "P010":
        return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
                rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6)
    return (rng.integers(16, 236, (n, h, w), dtype=np.uint8),
            rng.integers(16, 241, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(16, 241, (n, h // 2, w // 2), dtype=np.uint8))


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def assert_codes_close(got, ref, max_diff, frac):
    d = np.abs(codes10(got) - codes10(ref))
    assert got.shape == ref.shape
    assert d.max() <= max_diff and (d > 0).mean() <= frac, (d.max(),
                                                            (d > 0).mean())


@pytest.mark.parametrize("transfer", ["PQ", "HLG"])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_matches_jax(kind, transfer):
    """The RPU matrix replaces the standard one, DoVi always converts to SDR
    and a DoVi source marked HLG takes the PQ tail."""
    jplan, tplan = _plans(kind, transfer=transfer)
    assert np.array_equal(tplan.cmat_m, jplan.cmat_m)
    assert np.array_equal(tplan.cmat_c, jplan.cmat_c)
    for f in ("apply_matrix", "convert_to_sdr", "hlg_to_pq", "dither_bits"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.convert_to_sdr
    assert tpipe.route_of(tplan) == "dovi_fused"
    assert jpipe._can_split_fuse(jplan) and not jpipe._can_fuse(jplan)
    assert tpipe._make_tail_epilogue(tplan, with_cmat=False).correction \
        == trk.CORR_PQ_TO_SDR


# 10-bit codes, the port's kernel route (float32 sums) against the JAX
# kernel route (split-bf16 sums in K1, K8 and K9): a few values cross a
# dither step; measured at most 1 code on 0.55% of the channels (the JAX
# kernel route against its own XLA route: 1 code on 0.49%)
ROUTE_TOL = (1, 0.02)


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("case", ["c8", "variant", "variant_nv12"])
def test_dovi_kernel_route_matches_jax_kernel(case, pack, monkeypatch):
    kind = "c8" if case == "c8" else "variant"
    kw = dict(fmt_name="NV12", h=40, oh=24) if case.endswith("nv12") else {}
    jplan, tplan = _plans(kind, **kw)
    planes = _frame(kw, 8)
    jfn = jpipe.make_frame_fn(jplan, pack_surface=pack)
    if case == "variant_nv12":
        # here the JAX kernel route sits up to 15 codes from the JAX XLA
        # route on 0.65% of the channels (ROADMAP §3), and the port's
        # kernel route within 1 code of the XLA route: hold it to that
        ref = np.asarray(jfn(tuple(jnp.asarray(p) for p in planes)))
    else:
        ref = in_interpret(monkeypatch, lambda: jfn(
            tuple(jnp.asarray(p) for p in planes)))
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    got = tpipe.make_frame_fn(tplan, pack_surface=pack)(
        tuple(t(p) for p in planes)).numpy()
    if pack:
        assert_codes_close(got, ref, *ROUTE_TOL)
    else:
        d = np.abs(np.round((got.astype(np.float64) - ref) * 1023))
        assert d.max() <= ROUTE_TOL[0] and (d > 0).mean() <= ROUTE_TOL[1]


def test_dovi_kernel_route_calls(monkeypatch):
    """The kernel route is K1 on U and V, K8, K9 and nothing else (counted
    by wrapping the kernel wrappers: the CPU launches nothing)."""
    _, tplan = _plans("c8")
    calls = []
    for mod, name in ((trk, "banded_resize_last_axis"),
                      (trk, "banded_resize_rows"), (trk, "rows3_tail"),
                      (tdk, "rows3_mid"), (tdk, "cols3_tail")):
        orig = getattr(mod, name)

        def wrap(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, wrap)
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    fn(tuple(t(p) for p in _frame({}, 9)))
    assert calls == ["banded_resize_last_axis"] * 2 + ["rows3_mid",
                                                       "cols3_tail"]


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_dovi_plain_routes_match_jax_xla(kind, staged):
    """The plain route (CPU tensors) and the staged convert (fused=False)
    against the JAX XLA paths."""
    jplan, tplan = _plans(kind)
    planes = _frame({}, 10)
    fused = False if staged else None
    ref = np.asarray(jpipe.make_frame_fn(jplan, fused=fused,
                                         pack_surface=True)(
        tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, fused=fused, pack_surface=True)(
        tuple(t(p) for p in planes)).numpy()
    assert_codes_close(got, ref, 1, 0.01)


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("kind", KINDS)
def test_serving_two_scenes_match_jax(kind, route, monkeypatch):
    """make_serving_fn over two scenes (c8's dovi_rt scaling), one
    function: the port's route against the JAX package's."""
    jplan, tplan = _plans(kind)
    planes = _frame({}, 11)
    jfn = jpipe.make_serving_fn(jplan, pack_surface=True)
    if route == "kernel":
        monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    tfn = tpipe.make_serving_fn(tplan, pack_surface=True)
    assert tfn.allowed_rt_keys == jfn.allowed_rt_keys == {"cmat",
                                                          "dovi_curves"}
    assert tfn.dovi_structure == jfn.dovi_structure
    outs = []
    for i in (0, 3):
        scene = _scene(tfn.pack_curves(tplan.dovi), i)
        rt = {"dovi_curves": {k: jnp.asarray(v) for k, v in scene.items()}}
        if route == "kernel":
            ref = in_interpret(monkeypatch, lambda: jfn(
                tuple(jnp.asarray(p) for p in planes), rt))
        else:
            ref = np.asarray(jfn(tuple(jnp.asarray(p) for p in planes), rt))
        got = tfn(tuple(t(p) for p in planes), {"dovi_curves": scene}).numpy()
        assert_codes_close(got, ref, *(ROUTE_TOL if route == "kernel"
                                       else (1, 0.01)))
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])


def test_serving_runtime_matrix_matches_jax(monkeypatch):
    """A runtime colour matrix (ProcAmp) on the DoVi kernel route."""
    jplan, tplan = _plans("variant")
    planes = _frame({}, 12)
    m, c = jplan.cmat_m * 0.9, jplan.cmat_c + 0.01
    ref = in_interpret(monkeypatch, lambda: jpipe.make_serving_fn(
        jplan, pack_surface=True)(tuple(jnp.asarray(p) for p in planes),
                                  {"cmat": {"m": jnp.asarray(m),
                                            "c": jnp.asarray(c)}}))
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    got = fn(tuple(t(p) for p in planes), {"cmat": {"m": m, "c": c}}).numpy()
    assert_codes_close(got, ref, *ROUTE_TOL)
    assert not np.array_equal(got, fn(tuple(t(p) for p in planes)).numpy())


def test_serving_checks_keys_and_structure():
    _, tplan = _plans("c8")
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    planes = tuple(t(p) for p in _frame({}, 13))
    with pytest.raises(ValueError, match=r"accepts \['cmat', 'dovi_curves'\]"):
        fn(planes, {"hdr": {}})
    _, variant = _metas("variant")
    with pytest.raises(ValueError, match="structure changed"):
        fn.pack_curves(variant)
    # a plan without DoVi serves the matrix only
    _, hplan = _plans("c8")
    plain = tpipe.plan_pipeline(hplan.settings,
                                dataclasses.replace(hplan.src, dovi=None),
                                hplan.dst)
    sfn = tpipe.make_serving_fn(plain)
    assert sfn.allowed_rt_keys == {"cmat"} and sfn.dovi_structure is None
    assert not hasattr(sfn, "pack_curves")
    with pytest.raises(ValueError, match="dovi_curves"):
        sfn(planes, {"dovi_curves": {}})


@pytest.mark.parametrize("kind", KINDS)
def test_dovi_oracle_matches_jax_float64(kind):
    """As bench_oracle.py runs c8's reference: the JAX serving function at
    float64 on frame 0 with scene 1's curves."""
    jplan, tplan = _plans(kind)
    planes = tuple(p[0] for p in _frame({}, 14, n=1))
    jm, tm = _metas(kind)
    scene = _scene(tdovi.pack_curves(tm), 1)
    with jax.enable_x64(True):
        ref = np.asarray(jpipe.make_serving_fn(jplan, dtype=jnp.float64)(
            planes, {"dovi_curves": {k: jnp.asarray(v)
                                     for k, v in scene.items()}}))
    want = oracle_dovi(*(t(p) for p in planes), 32, 16, curves=scene,
                       structure=tdovi.curve_structure(tm),
                       ycc_to_rgb=tm.ycc_to_rgb_matrix,
                       ycc_offset=tm.ycc_to_rgb_offset,
                       lms=tdovi.lms_pipeline_matrix(tm)).numpy()
    assert want.shape == ref.shape == (3, 16, 32)
    assert psnr(want, ref) >= 55.0
