"""The HDR passthrough with the local tone map (c7: 4K P010 HDR10 ->
R10G10B10A2 PQ for a 600-nit display, BT.2390, served with per-scene HDR10
values) and kernel K4 (``mega3_tail``) in videorenderer_tpu_torch, against
the JAX package at small sizes on the CPU: the same inputs (numpy, from a
seed) through the JAX function and its port.

 * ``ops/transfer``'s m1-power halves of the PQ curve: within 2e-7 in
   float64; in float32 ``st2084_to_p`` within 5e-6 (see its test).
 * ``ops/tonemap``'s scalars: the serving (float32) scalars within 2
   float32 ulps of JAX, except ST 2094-10's spline coefficients (a 3x3
   solve through the knee's PQ decode turns 1-ulp differences of XLA's and
   torch's exp2/log2 into up to 55 ulps, 3.6e-6 relative: held at 2e-5
   relative); the static scalars equal ``_pq_encode_scalar``'s float64
   values rounded to float32.
 * The per-pixel tone map, selections 1-6, on PQ inputs in [0, 1.1]: the
   two packages' float32 exp2/log2 differ by ulps, and the m1-power domain
   amplifies them where ``st2084_to_p`` cancels, so within 4e-5 everywhere
   and 1e-5 on >= 99% of the values (measured: at most 1.7e-5, and 1e-5
   on >= 99.7%).
 * K2's plain version with c7's epilogue (static and serving) against the
   JAX ``rows3_tail`` in interpret mode; K4's plain version against the JAX
   ``mega3_tail`` (its split-bf16 products: 2e-4), against the float64
   composition (1e-5) and with c7's tail; the HLG -> PQ correction in K2;
   the c7 slice through ``make_serving_fn`` over two scenes on both routes:
   10-bit codes within 1 on >= 99.9% of the channels, none beyond 3.
 * ``oracle_c7`` against the JAX package's float64 serving output: >= 55 dB.
 * ``plan_pipeline``'s tone-map fields, and what stays refused.

The JAX kernel paths run as the JAX tests run them on the CPU:
``jax.default_backend`` patched to "tpu" inside
``pltpu.force_tpu_interpret_mode()``, with a fresh band cache per test.
The port's kernel route runs the plain versions on CPU tensors.
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
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import tonemap as jtm, transfer as jtr

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.oracle import oracle_c7
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import scale as tscale
from videorenderer_tpu_torch.ops import tonemap as ttm, transfer as ttr

W, H = 64, 36            # c7-shaped: P010 4:2:0, 1:1
NORM = 1.0 / 65535.0
UNSCALE = 1.0 / trk.MID16_SCALE


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def codes10(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)], -3).astype(np.int64)


def assert_codes_close(got, ref):
    """Within 1 code on >= 99.9% of the channels, none beyond 3."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    assert d.max() <= 3 and (d <= 1).mean() >= 0.999, (d.max(),
                                                       (d > 1).mean())


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


# c7 (bench_common.build_plan("c7")): mastering 4000 nits, MaxCLL 3000,
# MaxFALL 800, display 600; a scene of c7_rt(i); and a display at least as
# bright as the source peak (the passthrough)
C7 = dict(mastering_min_nits=0.005, mastering_max_nits=4000.0,
          max_cll=3000.0, max_fall=800.0, display_max_nits=600.0)
METAS = {"c7": C7,
         "scene3": dict(C7, mastering_max_nits=2000.0, max_cll=1500.0,
                        max_fall=450.0, display_max_nits=650.0),
         "passthrough": dict(C7, mastering_max_nits=1000.0, max_cll=800.0,
                             max_fall=300.0, display_max_nits=1000.0)}


def c7_rt(i: int) -> dict:
    """Scene i's HDR10 values (bench_common.c7_rt)."""
    return {"hdr": {"mastering_min_nits": 0.005,
                    "mastering_max_nits": 2000.0,
                    "max_cll": 1200.0 + 100.0 * i, "max_fall": 450.0,
                    "display_max_nits": 650.0}}


# --- ops/transfer and ops/tonemap ----------------------------------------------

@pytest.mark.parametrize("fn", ["st2084_to_p", "p_to_st2084"])
def test_m1_power_halves_match_jax(fn):
    """In float64 the two packages' formulas agree within 2e-7 on [0, 1.2].
    In float32, st2084_to_p's rational term cancels in its denominator
    (C2 - C3 x^(1/M2) falls to ~0.29 near PQ 0.6), so a 1-ulp difference
    between XLA's and torch's exp2/log2 moves p by up to ~4e-6; the band
    there is 5e-6, and p_to_st2084 (no cancellation) stays within 2e-7."""
    x = np.linspace(0.0, 1.2, 4097)
    with jax.enable_x64(True):
        ref64 = np.asarray(getattr(jtr, fn)(jnp.asarray(x)))
    got64 = getattr(ttr, fn)(t(x)).numpy()
    assert got64.dtype == np.float64
    assert np.abs(got64 - ref64).max() <= 2e-7

    x32 = x.astype(np.float32)
    got = getattr(ttr, fn)(t(x32)).numpy()
    ref = np.asarray(getattr(jtr, fn)(jnp.asarray(x32)))
    assert np.abs(got - ref).max() <= (5e-6 if fn == "st2084_to_p" else 2e-7)
    # and they compose to the EOTF / OETF at the 10000-nit scale
    if fn == "st2084_to_p":
        lin = ttr.pow_pos(t(got), 1.0 / ttr.ST2084_M1) * 10000.0
        assert torch.allclose(lin, ttr.st2084_to_linear(t(x32), 10000.0),
                              rtol=2e-6, atol=0)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("meta", list(METAS))
@pytest.mark.parametrize("sel", range(1, 7))
def test_rt_scalars_match_jax(sel, meta):
    m = METAS[meta]
    got = ttm.local_tonemap_rt_scalars(sel, m)
    ref = np.asarray(jtm.local_tonemap_rt_scalars(sel, m))
    assert got.dtype == np.float32 and got.shape == ref.shape == (5,)
    if sel == 6:
        assert _ulps(got[:2], ref[:2]).max() <= 2
        np.testing.assert_allclose(got[2:], ref[2:], rtol=2e-5, atol=1e-12)
    else:
        assert _ulps(got, ref).max() <= 2, (got, ref)


@pytest.mark.parametrize("meta", list(METAS))
@pytest.mark.parametrize("sel", range(1, 7))
def test_static_scalars_are_float64_rounded(sel, meta):
    p = jtm.HDRParams(**METAS[meta])
    got = ttm.local_tonemap_static_scalars(sel, ttm.HDRParams(**METAS[meta]))
    disp = p.display_max_nits
    if sel == 5:
        safe = p.max_cll
        mp, tp = jtm._pq_encode_scalar(safe), jtm._pq_encode_scalar(disp)
        want = [disp, safe, mp, tp, max(0.0, 1.5 * tp - 0.5 * mp)]
    elif sel == 6:
        want = [disp, p.max_cll, *(jtm._st2094_10_coeffs(p)
                                   if disp < p.max_cll else (0.0,) * 3)]
    else:
        base = max(disp, p.mastering_max_nits)
        want = [disp, min(base, p.max_cll), min(base / p.max_fall, 1.0), 0, 0]
    assert np.array_equal(got, np.asarray(want, np.float64).astype(np.float32))


def _pq(seed, shape=(2, 3, 12, 16)):
    return np.random.default_rng(seed).uniform(0.0, 1.1, shape).astype(
        np.float32)


def _close_pq(got, ref):
    d = np.abs(np.asarray(got, np.float64) - ref)
    assert d.max() <= 4e-5 and (d <= 1e-5).mean() >= 0.99, (
        d.max(), (d <= 1e-5).mean())


@pytest.mark.parametrize("route", ["static", "rt", "from_scalars"])
@pytest.mark.parametrize("meta", list(METAS))
@pytest.mark.parametrize("sel", range(1, 7))
def test_local_tonemap_matches_jax(sel, meta, route):
    x = _pq(sel)
    m = METAS[meta]
    if route == "static":
        got = ttm.local_tonemap_pq(t(x), sel, ttm.HDRParams(**m), axis=-3)
        ref = jtm.local_tonemap_pq(jnp.asarray(x), sel, jtm.HDRParams(**m),
                                   axis=-3)
    elif route == "rt":
        got = ttm.local_tonemap_pq_rt(t(x), sel, m, axis=-3)
        ref = jtm.local_tonemap_pq_rt(jnp.asarray(x), sel, m, axis=-3)
    else:
        sc = np.asarray(jtm.local_tonemap_rt_scalars(sel, m))
        got = ttm.local_tonemap_pq_from_scalars(t(x), sel, sc, axis=-3)
        ref = jtm.local_tonemap_pq_from_scalars(jnp.asarray(x), sel,
                                                jnp.asarray(sc), axis=-3)
    _close_pq(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("op", ["aces_film", "reinhard", "habel", "mobius"])
def test_operators_match_jax(op):
    """The four curves of selections 1-4 on normalised light in [0, 2]."""
    x = np.random.default_rng(9).uniform(0.0, 2.0, (3, 8, 16)).astype(
        np.float32)
    args = (600.0,) if op == "mobius" else ()
    got = getattr(ttm, op)(t(x), *args).numpy()
    ref = np.asarray(getattr(jtm, op)(jnp.asarray(x), *args))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("meta", list(METAS))
@pytest.mark.parametrize("op", ["bt2390", "st2094_10"])
def test_nits_domain_eetfs_match_jax(op, meta):
    """BT.2390 and ST 2094-10 in their nits formulation (the oracle's
    form), RGB on axis 0 in [0, 4000] nits."""
    x = np.random.default_rng(10).uniform(0.0, 4000.0, (3, 8, 16)).astype(
        np.float32)
    got = getattr(ttm, op)(t(x), ttm.HDRParams(**METAS[meta]), axis=0)
    ref = getattr(jtm, op)(jnp.asarray(x), jtm.HDRParams(**METAS[meta]),
                           axis=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


def test_passthrough_keeps_the_pq_round_trip():
    """A display at least as bright as the peak still runs p_to_st2084
    (st2084_to_p(x)), which is not the identity."""
    x = _pq(7)
    sc = ttm.local_tonemap_rt_scalars(5, METAS["passthrough"])
    got = ttm.local_tonemap_pq_from_scalars(t(x), 5, sc, axis=-3)
    assert torch.equal(got, ttr.p_to_st2084(ttr.st2084_to_p(t(x))))
    assert not torch.equal(got, t(x))


def test_tonemap_guided_and_trims_and_input_checks():
    """Selection 7 (with its HDR10+ window) and the L2 trims run on every
    route and agree with the JAX package within the per-pixel band above;
    the serving values' checks and the epilogue's still refuse bad input."""
    from videorenderer_tpu.ops import hdr10plus as jh10p
    from videorenderer_tpu_torch.ops import hdr10plus as th10p
    from torch_hdr_cells import guided_meta
    x = _pq(8)
    p = dict(C7)
    jw, tw = guided_meta(jh10p).windows[0], guided_meta(th10p).windows[0]
    ref = jtm.local_tonemap_pq(jnp.asarray(x), 7, jtm.HDRParams(**p),
                               axis=-3, window=jw)
    got = ttm.local_tonemap_pq(t(x), 7, ttm.HDRParams(**p), axis=-3,
                               window=tw)
    _close_pq(got.numpy(), np.asarray(ref))
    trims = dict(trim_slope=1.1, trim_offset=-0.02, trim_power=0.9,
                 saturation_gain=0.1, chroma_weight=0.05, l2_enabled=True)
    ref = jtm.local_tonemap_pq(jnp.asarray(x), 5, jtm.HDRParams(**p),
                               trims=jtm.DoviTrims(**trims), axis=-3)
    got = ttm.local_tonemap_pq(t(x), 5, ttm.HDRParams(**p),
                               trims=ttm.DoviTrims(**trims), axis=-3)
    _close_pq(got.numpy(), np.asarray(ref))
    with pytest.raises(TypeError, match="synchronise"):
        ttm.hdr_values({"max_cll": torch.tensor(1000.0, device="meta")})
    with pytest.raises(ValueError, match="unknown"):
        ttm.hdr_values({"maxcll": 1000.0})
    epi = trk.Epilogue(cmat=None, correction=trk.CORR_NONE,
                       luminance_scale=1.0, dither_bits=0,
                       gamut=np.eye(3, dtype=np.float32), plain=None,
                       tonemap=7)
    with pytest.raises(ValueError, match="window"):
        epi.validate()
    dataclasses.replace(epi, window=tw).validate()
    with pytest.raises(ValueError, match="trims"):
        dataclasses.replace(epi, tonemap=0,
                            trims=np.ones(5, np.float32)).validate()


# --- plans -------------------------------------------------------------------

def _c7_args(cfg, csp, pipe, fmt, *, transfer="PQ", display=600,
             sel="BT2390", local=True, max_cll=3000.0, w=W, h=H, **settings):
    return (cfg.Settings(convert_to_sdr=False, hdr_passthrough=True,
                         hdr_local_tone_mapping=local,
                         hdr_local_tone_mapping_type=cfg.ToneMapType[sel],
                         hdr_display_max_nits=display, **settings),
            pipe.SourceDescriptor(
                format=fmt.P010, width=w, height=h, matrix=csp.CSP.BT_2020_NC,
                primaries=csp.Primaries.BT_2020, transfer=csp.TRC[transfer],
                hdr10=pipe.HDR10Metadata(mastering_max_nits=4000.0,
                                         max_cll=max_cll, max_fall=800.0)),
            pipe.OutputDescriptor(width=w, height=h, bits=10, hdr=True))


def _plans(**kw):
    return (jpipe.plan_pipeline(*_c7_args(jcfg, jcsp, jpipe, JFmt, **kw)),
            tpipe.plan_pipeline(*_c7_args(tcfg, tcsp, tpipe, TFmt, **kw)))


PLANS = {"c7": {}, "hlg_local": dict(transfer="HLG", sel="ACES"),
         "brighter_display": dict(display=1500, max_cll=800.0),
         "st2094_10": dict(sel="ST2094_10", display=500),
         "no_local": dict(local=False)}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_tonemap_fields_match_jax(case):
    jplan, tplan = _plans(**PLANS[case])
    for f in ("local_tonemap", "tonemap_type", "hlg_to_pq", "convert_to_sdr",
              "apply_matrix", "dither_bits"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert (ttm.HDRParams(**vars(jplan.tonemap_params))
            == tplan.tonemap_params)
    assert tpipe.serving_rt_keys(tplan) == jpipe.serving_rt_keys(jplan)
    assert tpipe.route_of(tplan) == "fused" and jpipe._can_fuse(jplan)


def test_formerly_refused_tonemap_plans_match_jax():
    """c7's settings on a Dolby Vision source (its local tone map in K9's
    tail) and with HDR10+ metadata (selection 7) plan as in the JAX
    package: every plan field equal."""
    from videorenderer_tpu.ops import dovi as jdovi
    from videorenderer_tpu.ops import hdr10plus as jh10p
    from videorenderer_tpu_torch.ops import hdr10plus as th10p
    from torch_hdr_cells import dovi_meta, guided_meta, plan_differences
    jargs = _c7_args(jcfg, jcsp, jpipe, JFmt)
    targs = _c7_args(tcfg, tcsp, tpipe, TFmt)
    for jsrc, tsrc in (
            (dict(dovi=dovi_meta(jdovi)), dict(dovi=dovi_meta(tdovi))),
            (dict(hdr10plus=guided_meta(jh10p)),
             dict(hdr10plus=guided_meta(th10p)))):
        jplan = jpipe.plan_pipeline(
            jargs[0], dataclasses.replace(jargs[1], **jsrc), jargs[2])
        tplan = tpipe.plan_pipeline(
            targs[0], dataclasses.replace(targs[1], **tsrc), targs[2])
        assert plan_differences(jplan, tplan) == []
        assert tplan.local_tonemap


# --- K2 with c7's epilogue, and HLG -> PQ -------------------------------------

def _c7_frame(seed, n=2, w=W, h=H):
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6)


def _c7_maps():
    return tchroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, tcfg.ChromaScaling.BILINEAR,
        tcsp.ChromaLocation.MPEG2)


@pytest.mark.parametrize("route", ["static", "serving"])
def test_k2_plain_c7_epilogue_matches_pallas(route):
    """c7's K2 call: raw uint16 luma read directly, mid16 chroma with the
    H upsample, BT.2020 matrix, the BT.2390 tone map, 10-bit dither,
    RGB10; the serving route with scene 2's values."""
    jplan, tplan = _plans()
    _, uy = _c7_maps()
    rng = np.random.default_rng(21)
    y = _c7_frame(20)[0]
    u = rng.integers(1000, 15600, (2, H // 2, W)).astype(np.int16)
    v = rng.integers(1000, 15600, (2, H // 2, W)).astype(np.int16)
    jargs = (jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), None,
             np.asarray(uy, np.float32), H)
    rt = c7_rt(2)
    with pltpu.force_tpu_interpret_mode():
        if route == "static":
            ref = jrp.rows3_tail(*jargs, jpipe._make_tail_epilogue(jplan),
                                 y_scale=NORM, c_scale=UNSCALE,
                                 pack_format="rgb10a2")
        else:
            ref = jrp.rows3_tail(*jargs, jpipe._make_tail_epilogue_rt(jplan),
                                 y_scale=NORM, c_scale=UNSCALE,
                                 rt_scalars=jpipe._pack_rt_all(jplan, rt),
                                 pack_format="rgb10a2")
    epi = tpipe._make_tail_epilogue(
        tplan, rt=None if route == "static" else {"hdr": rt["hdr"]})
    assert epi.tonemap == 5 and epi.correction == trk.CORR_NONE
    got = trk.rows3_tail(t(y), t(u), t(v), None,
                         trk.BandedMatrix(uy, pre_scale=UNSCALE), H, epi,
                         y_scale=NORM, pack_format="rgb10a2")
    assert_codes_close(codes10(got.numpy()), codes10(np.asarray(ref)))


@pytest.mark.parametrize("local", [False, True])
def test_hlg_to_pq_kernel_route_matches_jax(local, monkeypatch):
    """HLG passthrough (with and without the local tone map) keeps K1 + K2:
    the port's kernel route (plain versions) against the JAX kernel route."""
    jplan, tplan = _plans(transfer="HLG", sel="BT2390", local=local)
    assert tplan.hlg_to_pq and tpipe._make_tail_epilogue(tplan).correction \
        == trk.CORR_HLG_TO_PQ
    planes = _c7_frame(22)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(
        tuple(t(p) for p in planes)).numpy()
    assert_codes_close(codes10(got), codes10(ref))


# --- K4 ----------------------------------------------------------------------

def _mega_inputs(kind):
    """The two geometries of tests/test_pallas_resize.py: 4:2:0 planes with
    a 2:1 Lanczos3 downscale, and NV12-shaped 1:1 (luma read directly,
    chroma upsampled only)."""
    if kind == "downscale":
        rng = np.random.default_rng(21)
        h, w, oh, ow = 256, 512, 128, 256
        y = (rng.integers(0, 1024, (2, h, w), np.uint16) << 6)
        u = (rng.integers(0, 1024, (2, h // 2, w // 2), np.uint16) << 6)
        v = (rng.integers(0, 1024, (2, h // 2, w // 2), np.uint16) << 6)
        wx = np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, w, ow))
        wy = np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, h, oh))
        ux, uy = tchroma.chroma_upsample_matrices(
            w // 2, h // 2, 420, tcfg.ChromaScaling.BILINEAR,
            tcsp.ChromaLocation.MPEG2)
        maps = (wx, np.asarray(ux @ wx, np.float32), wy,
                np.asarray(uy @ wy, np.float32))
        return (y, u, v), maps, oh, NORM
    rng = np.random.default_rng(22)
    h, w = 128, 256
    planes = (rng.integers(0, 256, (1, h, w), np.uint8),
              rng.integers(0, 256, (1, h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (1, h // 2, w // 2), np.uint8))
    ux, uy = tchroma.chroma_upsample_matrices(
        w // 2, h // 2, 420, tcfg.ChromaScaling.BILINEAR,
        tcsp.ChromaLocation.MPEG2)
    return planes, (None, ux, None, uy), h, 1 / 255.0


CMAT = np.asarray([[1.0, 0.0, 1.4, 0.0], [1.0, -0.2, -0.7, 0.0],
                   [1.0, 1.8, 0.0, 0.0]], np.float32)


def _port_mega(planes, maps, oh, norm, epilogue):
    mx_y, mx_c, my_y, my_c = maps
    (ky, hy), (kc, hc) = trk.mega_maps(mx_y, my_y, norm), trk.mega_maps(
        mx_c, my_c, norm)
    return trk.mega3_tail(*(t(p) for p in planes), ky, kc, hy, hc, oh,
                          epilogue, norm).numpy()


def _jax_mega(planes, maps, oh, norm, epi):
    f32 = [None if m is None else np.asarray(m, np.float32) for m in maps]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jrp.mega3_tail(*(jnp.asarray(p) for p in planes),
                                         *f32, oh, epi, norm))


@pytest.mark.parametrize("kind", ["downscale", "direct"])
def test_k4_plain_matches_pallas_and_float64(kind):
    planes, maps, oh, norm = _mega_inputs(kind)
    cmat = CMAT if kind == "downscale" else None
    epi = (tpipe.cmat_epilogue(cmat) if cmat is not None else
           trk.Epilogue(cmat=None, correction=trk.CORR_NONE,
                        luminance_scale=1.0, dither_bits=0,
                        gamut=np.eye(3, dtype=np.float32),
                        plain=lambda y, u, v: torch.stack([y, u, v], -3)))
    got = _port_mega(planes, maps, oh, norm, epi)

    def jepi(yt, ut, vt):
        if cmat is None:
            return jnp.stack([yt, ut, vt], axis=0)
        return jnp.stack([cmat[i, 0] * yt + cmat[i, 1] * ut + cmat[i, 2] * vt
                          for i in range(3)], axis=0)

    ref = _jax_mega(planes, maps, oh, norm, jepi)
    assert got.shape == ref.shape == (planes[0].shape[0], 3, oh,
                                      planes[0].shape[-1] if maps[0] is None
                                      else maps[0].shape[1])
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)

    def dense(p, a, b):
        x = p.astype(np.float64) * norm
        if a is not None:
            x = x @ np.asarray(a, np.float64)
        if b is not None:
            x = np.einsum("hH,bhw->bHw", np.asarray(b, np.float64), x)
        return x
    comps = [dense(planes[0], maps[0], maps[2]),
             dense(planes[1], maps[1], maps[3]),
             dense(planes[2], maps[1], maps[3])]
    m = np.eye(3) if cmat is None else cmat[:, :3].astype(np.float64)
    want = np.stack([sum(m[i, j] * comps[j] for j in range(3))
                     for i in range(3)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("route", ["static", "serving"])
def test_k4_plain_with_c7_tail_matches_pallas(route):
    """K4 at c7's geometry and tail (the BT.2390 tone map, 10-bit dither,
    float out): 10-bit codes against the JAX mega3_tail."""
    jplan, tplan = _plans()
    ux, uy = _c7_maps()
    planes = _c7_frame(23)
    maps = (None, ux, None, uy)
    rt = c7_rt(1)
    if route == "static":
        jepi, tepi = jpipe._make_tail_epilogue(jplan), \
            tpipe._make_tail_epilogue(tplan)
        ref = _jax_mega(planes, maps, H, NORM, jepi)
    else:
        f32 = [None if m is None else np.asarray(m, np.float32) for m in maps]
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jrp.mega3_tail(
                *(jnp.asarray(p) for p in planes), *f32, H,
                jpipe._make_tail_epilogue_rt(jplan), NORM,
                rt_scalars=jpipe._pack_rt_all(jplan, rt)))
        tepi = tpipe._make_tail_epilogue(tplan, rt={"hdr": rt["hdr"]})
    got = _port_mega(planes, maps, H, NORM, tepi)
    assert got.shape == ref.shape == (2, 3, H, W)
    assert_codes_close(np.round(got * 1023), np.round(ref * 1023))


def test_k4_refuses_bad_shapes():
    p = torch.zeros((1, 8, 8), dtype=torch.uint16)
    q = torch.zeros((1, 4, 4), dtype=torch.uint16)
    epi = tpipe.cmat_epilogue(CMAT)
    with pytest.raises(ValueError, match="W map"):
        trk.mega3_tail(p, q, q, None, None, None, None, 8, epi, NORM)
    kx = trk.BandedMatrix(np.ones((4, 8)) / 4)
    with pytest.raises(ValueError, match="H map"):
        trk.mega3_tail(p, q, q, None, kx, None, None, 8, epi, NORM)
    with pytest.raises(ValueError, match="share"):
        trk.mega3_tail(p, q, p, None, kx, None, None, 8, epi, NORM)


# --- the c7 slice -------------------------------------------------------------

@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_c7_serving_two_scenes_match_jax(route, monkeypatch):
    """make_serving_fn on the small c7 plan over two scenes (c7_rt(0), (3)):
    the port's kernel route (K1, K2 plain versions) against the JAX kernel
    route in interpret mode, the plain route against the JAX XLA route."""
    kw = {} if route == "kernel" else dict(use_accel_backend=False)
    jplan, tplan = _plans(**kw)
    planes = _c7_frame(24)
    tfn = tpipe.make_serving_fn(tplan, pack_surface=True)
    assert tfn.allowed_rt_keys == {"cmat", "hdr"}
    outs = []
    for i in (0, 3):
        rt = c7_rt(i)

        def jrun():
            return jpipe.make_serving_fn(jplan, pack_surface=True)(
                tuple(jnp.asarray(p) for p in planes), rt)
        ref = in_interpret(monkeypatch, jrun) if route == "kernel" else \
            np.asarray(jrun())
        got = tfn(tuple(t(p) for p in planes), rt).numpy()
        assert_codes_close(codes10(got), codes10(ref))
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])


def test_c7_serving_calls_and_guards(monkeypatch):
    """The kernel route is K1 on U and V and K2, nothing else; unknown keys
    and device tensors in rt["hdr"] raise."""
    _, tplan = _plans()
    calls = []
    for name in ("banded_resize_last_axis", "banded_resize_rows",
                 "rows3_tail", "mega3_tail"):
        orig = getattr(trk, name)

        def wrap(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(trk, name, wrap)
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    planes = tuple(t(p) for p in _c7_frame(25))
    fn(planes, c7_rt(1))
    assert calls == ["banded_resize_last_axis"] * 2 + ["rows3_tail"]
    with pytest.raises(ValueError, match=r"accepts \['cmat', 'hdr'\]"):
        fn(planes, {"dovi_curves": {}})
    with pytest.raises(TypeError, match="synchronise"):
        fn(planes, {"hdr": {"max_cll": torch.tensor(900.0, device="meta")}})


def test_c7_static_route_is_the_plans_metadata():
    """make_frame_fn (no rt) takes the static scalars; a serving call whose
    values equal the plan's takes the float32 ones: both within 1 code."""
    _, tplan = _plans()
    planes = tuple(t(p) for p in _c7_frame(26))
    static = tpipe.make_frame_fn(tplan, pack_surface=True)(planes).numpy()
    hdr = {k: getattr(tplan.tonemap_params, k) for k in ttm.HDR_KEYS}
    served = tpipe.make_serving_fn(tplan, pack_surface=True)(
        planes, {"hdr": hdr}).numpy()
    assert_codes_close(codes10(static), codes10(served))


def test_c7_oracle_matches_jax_float64():
    """As bench_oracle.py computes c7's reference: the JAX serving function
    at float64 on one frame with scene 0's values."""
    jplan, _ = _plans()
    planes = tuple(p[0] for p in _c7_frame(27, n=1))
    rt = c7_rt(0)
    with jax.enable_x64(True):
        ref = np.asarray(jpipe.make_serving_fn(jplan, dtype=jnp.float64)(
            planes, rt))
    h = rt["hdr"]
    want = oracle_c7(*(t(p) for p in planes), max_cll=h["max_cll"],
                     display_max_nits=h["display_max_nits"],
                     mastering_max_nits=h["mastering_max_nits"]).numpy()
    assert want.shape == ref.shape == (3, H, W)
    assert psnr(want, ref) >= 55.0
