"""HDR10+ (ST 2094-40) in videorenderer_tpu_torch against the JAX package,
on the CPU at small sizes: the same inputs (numpy, from a seed) through
the JAX function and its port.

 * The host half of ``ops/hdr10plus`` (a copy of the JAX module's code):
   scene peak and average, the parameter substitution and the upgrade to
   selection 7, the output-side merge, the serving values: equal.
 * ``apply_hdr10plus_curve`` and ``st2094_40_guided`` (nits in and out, no
   PQ curve between): within 2e-6 (measured bit-equal: the same float32
   operations in the same order, the Bernstein powers in
   ``lax.integer_pow``'s order).
 * Selection 7 through the static, serving (``_rt``) and ``_from_scalars``
   routes of the local tone map: PQ in and out, so the band of the other
   selections (tests/test_torch_tonemap.py): the two packages' float32
   exp2/log2 differ by ulps and the PQ curve amplifies them, within 4e-5
   everywhere and 1e-5 on >= 99% of the values.
 * c7p's plan (c7 with a guided window, tests/torch_hdr_cells.py): every
   field and ``output_signal_info`` equal to the JAX plan's; the frame and
   serving functions' plain versions against the JAX kernel route (Pallas
   in interpret mode) in the mid16 band (1 code on >= 99.9% of the
   channels, none beyond 3), FLOAT16 within 2e-5; the float64 oracle with
   the guided curve >= 55 dB against the JAX serving function in float64.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import hdr10plus as jh
from videorenderer_tpu.ops import tonemap as jtm

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.ops import hdr10plus as th
from videorenderer_tpu_torch.ops import tonemap as ttm
from videorenderer_tpu_torch.oracle import oracle_c7

from torch_hdr_cells import (JAX, TORCH, assert_mid16_band, cell_args,
                             guided_meta, p010, plain_value,
                             plan_differences, plans)

C7 = dict(mastering_min_nits=0.005, mastering_max_nits=4000.0,
          max_cll=4000.0, max_fall=500.0, display_max_nits=600.0)


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix): each test gets its
    own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def _window_kw(seed: int) -> dict:
    """A window's fields from a seed: 0-15 anchors (sorted), knees in
    [0, 0.6), percentiles around the 99% mark in any order."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 16))
    peak = float(rng.uniform(0.05, 0.6))
    pct = ((int(rng.integers(1, 99)), float(rng.uniform(0, peak))),
           (99, peak * 0.9), (99.98, peak))[:int(rng.integers(0, 4))]
    return dict(
        maxscl=tuple(float(v) for v in rng.uniform(0.01, peak, 3)),
        average_maxrgb=float(rng.uniform(0.0, 0.05)),
        distribution_maxrgb=tuple(pct[::-1] if seed % 2 else pct),
        tone_mapping_flag=int(seed % 5 != 4),
        knee_point_x=float(rng.uniform(0.0, 0.6)) if seed % 3 else 0.0,
        knee_point_y=float(rng.uniform(0.0, 0.6)),
        bezier_curve_anchors=tuple(float(v)
                                   for v in np.sort(rng.uniform(0, 1, n))))


def _metas(seed: int):
    kw = _window_kw(seed)
    return (jh.HDR10PlusMetadata(windows=(jh.HDR10PlusWindow(**kw),)),
            th.HDR10PlusMetadata(windows=(th.HDR10PlusWindow(**kw),)))


SEEDS = range(8)


# --- the host half -------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_host_functions_equal(seed):
    jm, tm = _metas(seed)
    assert th.scene_peak_nits(tm) == jh.scene_peak_nits(jm)
    assert th.scene_average_nits(tm) == jh.scene_average_nits(jm)
    for hdr10 in (None, (4000.0, 3000.0, 800.0)):
        jh10 = hdr10 and jpipe.HDR10Metadata(0.005, *hdr10)
        th10 = hdr10 and tpipe.HDR10Metadata(0.005, *hdr10)
        for sel in (1, 5, 6):
            jp, jt = jh.hdr_params_from_hdr10plus(jm, jh10, 600.0, sel)
            tp, tt = th.hdr_params_from_hdr10plus(tm, th10, 600.0, sel)
            assert tt == jt and plain_value(tp) == plain_value(jp)
        assert (plain_value(th.merge_hdr10(th10, tm))
                == plain_value(jh.merge_hdr10(jh10, jm)))
        jr = jh.runtime_hdr_from_hdr10plus(jm, jh10, 650.0)
        tr = th.runtime_hdr_from_hdr10plus(tm, th10, 650.0)
        assert list(tr) == list(jr)
        assert all(tr[k] == jr[k] and tr[k].dtype == jr[k].dtype for k in jr)


def test_empty_and_percentile_order():
    """Empty metadata keeps the static block; the highest percentile at or
    above 99 is the peak whatever the order (the JAX tests' cases)."""
    empty = th.HDR10PlusMetadata(windows=())
    assert th.scene_peak_nits(empty) == 0.0
    h = tpipe.HDR10Metadata(mastering_max_nits=4000.0, max_cll=4000.0)
    p, sel = th.hdr_params_from_hdr10plus(empty, h, 800.0, 5)
    assert (p.mastering_max_nits, sel) == (4000.0, 5)
    for order in (1, -1):
        m = th.HDR10PlusMetadata(windows=(th.HDR10PlusWindow(
            distribution_maxrgb=((99, 0.2), (99.98, 0.45))[::order]),))
        assert th.scene_peak_nits(m) == 4500.0


# --- the curve and the guided tone map -----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_curve_matches_jax(seed):
    jm, tm = _metas(seed)
    x = np.random.default_rng(seed + 50).uniform(0, 1, (3, 9, 17))
    x = np.concatenate([x.ravel(), [0.0, 1.0, tm.windows[0].knee_point_x]])
    x = x.astype(np.float32)
    ref = np.asarray(jh.apply_hdr10plus_curve(jnp.asarray(x), jm.windows[0]))
    got = th.apply_hdr10plus_curve(t(x), tm.windows[0]).numpy()
    assert np.abs(got - ref).max() <= 2e-6


def test_curve_refuses_too_many_anchors():
    w = th.HDR10PlusWindow(tone_mapping_flag=1, knee_point_x=0.1,
                           bezier_curve_anchors=(0.5,) * 16)
    with pytest.raises(ValueError, match="anchors"):
        th.apply_hdr10plus_curve(torch.zeros(3), w)


def _flush(v):
    """Subnormal float32 values to zero: XLA on the CPU flushes them, torch
    keeps them (and so does the card)."""
    return np.where(np.abs(v) < np.finfo(np.float32).tiny, 0.0, v)


@pytest.mark.parametrize("seed", SEEDS)
def test_ipow_is_lax_integer_pow(seed):
    """The products in lax.integer_pow's order: bit-equal up to XLA's
    flush of subnormal results (x**15 of x < 0.003 is below 1.2e-38)."""
    x = np.random.default_rng(seed).uniform(0, 1, 64).astype(np.float32)
    for e in range(17):
        ref = np.asarray(jax.lax.integer_pow(jnp.asarray(x), e))
        assert np.array_equal(_flush(th._ipow(t(x), e).numpy()), ref), e


@pytest.mark.parametrize("seed", SEEDS)
def test_guided_matches_jax(seed):
    jm, tm = _metas(seed)
    rng = np.random.default_rng(seed + 60)
    peak = max(th.scene_peak_nits(tm), 100.0)
    nits = (rng.uniform(0, 1, (3, 12, 20)) ** 3 * 1.2 * peak).astype(
        np.float32)
    for disp in (600.0, 2 * peak):
        ref = np.asarray(jtm.st2094_40_guided(jnp.asarray(nits), disp, peak,
                                              jm.windows[0], axis=0))
        got = ttm.st2094_40_guided(t(nits), disp, peak, tm.windows[0],
                                   axis=0).numpy()
        assert np.abs(got - ref).max() <= 2e-6 * max(disp, peak)


def test_guided_constants():
    """The tail kernels' block: the window's flag, knee, order, the knee's
    divisor, 1 - ky, the slopes, and C(n, k) P_k zero padded."""
    w = guided_meta(th).windows[0]
    g = th.guided_constants(w)
    n = 4
    want = [1, 0.25, 0.3, n, 0.75, 0.7, 0.3 / 0.25, 0.25, 0.3 / 0.25]
    want += [math.comb(n, k) * p
             for k, p in enumerate((0, 0.4, 0.7, 0.9, 1.0))]
    assert g.dtype == np.float32 and g.shape == (9 + th.GUIDED_COEFFS,)
    assert np.array_equal(g[:len(want)], np.asarray(want, np.float32))
    assert not g[len(want):].any()
    assert not th.guided_constants(None).any()
    flat = dataclasses.replace(w, knee_point_x=0.0)
    assert th.guided_constants(flat)[6] == 0.0      # no slope below a zero knee
    assert th.guided_constants(flat)[8] == 1.0


# --- selection 7 through the three tone-map routes -------------------------------

def _pq(seed, shape=(3, 16, 24)):
    return np.random.default_rng(seed).uniform(0.0, 1.1, shape).astype(
        np.float32)


def _close_pq(got, ref):
    d = np.abs(got - ref)
    assert d.max() <= 4e-5 and np.quantile(d, 0.99) <= 1e-5, (
        d.max(), np.quantile(d, 0.99))


@pytest.mark.parametrize("route", ["static", "rt", "from_scalars"])
@pytest.mark.parametrize("display", [600.0, 5000.0])
def test_selection7_routes_match_jax(route, display):
    jm, tm = guided_meta(jh), guided_meta(th)
    x = _pq(70)
    p = dict(C7, display_max_nits=display)
    jw, tw = jm.windows[0], tm.windows[0]
    if route == "static":
        ref = jtm.local_tonemap_pq(jnp.asarray(x), 7, jtm.HDRParams(**p),
                                   axis=0, window=jw)
        got = ttm.local_tonemap_pq(t(x), 7, ttm.HDRParams(**p), axis=0,
                                   window=tw)
    elif route == "rt":
        ref = jtm.local_tonemap_pq_rt(jnp.asarray(x), 7, p, axis=0,
                                      window=jw)
        got = ttm.local_tonemap_pq_rt(t(x), 7, p, axis=0, window=tw)
    else:
        sc = jtm.local_tonemap_rt_scalars(7, p)
        tsc = ttm.local_tonemap_rt_scalars(7, p)
        assert np.array_equal(tsc, np.asarray(sc))
        ref = jtm.local_tonemap_pq_from_scalars(jnp.asarray(x), 7, sc,
                                                axis=0, window=jw)
        got = ttm.local_tonemap_pq_from_scalars(t(x), 7, tsc, axis=0,
                                                window=tw)
    _close_pq(got.numpy(), np.asarray(ref))


def test_selection7_scalars_and_window_required():
    p = ttm.HDRParams(**C7)
    assert np.array_equal(ttm.local_tonemap_static_scalars(7, p),
                          np.asarray([600.0, 4000.0, 0, 0, 0], np.float32))
    with pytest.raises(ValueError, match="HDR10PlusWindow"):
        ttm.local_tonemap_pq(torch.zeros((3, 2, 2)), 7, p, axis=0)


# --- c7p: the plan and the pipeline ----------------------------------------------

def test_c7p_plan_matches_jax():
    jplan, tplan = plans("c7p")
    assert plan_differences(jplan, tplan) == []
    assert tplan.tonemap_type == 7 and tplan.hdr10plus_window is not None
    assert tpipe.serving_rt_keys(tplan) == jpipe.serving_rt_keys(jplan)
    assert (tpipe.output_signal_info(tplan).to_dict()
            == jpipe.output_signal_info(jplan).to_dict())
    epi = tpipe._make_tail_epilogue(tplan)
    assert epi.tonemap == 7 and epi.window is tplan.hdr10plus_window
    assert epi.trims is None


@pytest.mark.parametrize("geom", ["1:1", "2:1"])
def test_c7p_kernel_route_matches_jax_kernel(geom, monkeypatch):
    kw = {} if geom == "2:1" else dict(ow=64, oh=32)
    jplan, tplan = plans("c7p", **kw)
    planes = p010(80)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(
        tuple(t(p) for p in planes)).numpy()
    assert_mid16_band(got, ref)


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_c7p_serving_two_scenes_match_jax(route, monkeypatch):
    """make_serving_fn over two scenes of runtime_hdr_from_hdr10plus
    values (the scene peak moves): the kernel route against the JAX kernel
    route, the plain route (use_accel_backend off) against the JAX XLA
    route."""
    accel = route == "kernel"
    jplan = jpipe.plan_pipeline(*cell_args(JAX, "c7p"))
    tplan = tpipe.plan_pipeline(*cell_args(TORCH, "c7p"))
    if not accel:
        jplan = dataclasses.replace(jplan, settings=dataclasses.replace(
            jplan.settings, use_accel_backend=False))
        tplan = dataclasses.replace(tplan, settings=dataclasses.replace(
            tplan.settings, use_accel_backend=False))
    planes = p010(81)
    jfn = jpipe.make_serving_fn(jplan, pack_surface=True)
    tfn = tpipe.make_serving_fn(tplan, pack_surface=True)
    assert tfn.allowed_rt_keys == jfn.allowed_rt_keys == {"cmat", "hdr"}
    outs = []
    for peak in (0.4, 0.25):
        rt = {"hdr": th.runtime_hdr_from_hdr10plus(
            guided_meta(th, peak=peak), tplan.src.hdr10, 600.0)}
        jrt = {"hdr": jh.runtime_hdr_from_hdr10plus(
            guided_meta(jh, peak=peak), jplan.src.hdr10, 600.0)}
        call = lambda: jfn(tuple(jnp.asarray(p) for p in planes), jrt)
        ref = in_interpret(monkeypatch, call) if accel else np.asarray(call())
        got = tfn(tuple(t(p) for p in planes), rt).numpy()
        assert_mid16_band(got, ref)
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("geom", ["1:1", "2:1"])
def test_c7p_float16_matches_jax(geom, monkeypatch):
    """A FLOAT16 plan with float output (float32 intermediates, no
    quantization): the port's kernel route against the JAX kernel route.
    Within 2e-5 on >= 99% of the values; the tone map's PQ curve, not the
    sums, sets the rest: at most 4e-5, the per-pixel band of
    tests/test_torch_tonemap.py (measured at most 3.2e-5 at 1:1 and 1.9e-5
    at 2:1, ROADMAP's logged divergences)."""
    kw = dict(tex_format="FLOAT16", bits=16)
    if geom == "1:1":
        kw.update(ow=64, oh=32)
    jplan, tplan = plans("c7p", **kw)
    assert tplan.dither_bits == jplan.dither_bits == 0
    planes = p010(82)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(jplan)(
        tuple(jnp.asarray(p) for p in planes)))
    got = tpipe.make_frame_fn(tplan)(tuple(t(p) for p in planes)).numpy()
    d = np.abs(got - ref)
    assert d.max() <= 4e-5 and np.quantile(d, 0.99) <= 2e-5


def test_c7p_oracle_matches_jax_float64():
    """oracle_c7 with the window against the JAX serving function in
    float64 (one frame, the plan's scene peak)."""
    jplan, _ = plans("c7p", ow=64, oh=32)
    planes = tuple(p[0] for p in p010(84, n=1))
    p = jplan.tonemap_params
    rt = {"hdr": {k: getattr(p, k) for k in ttm.HDR_KEYS}}
    with jax.enable_x64(True):
        ref = np.asarray(jpipe.make_serving_fn(jplan, dtype=jnp.float64)(
            planes, rt))
    want = oracle_c7(*(t(x) for x in planes), max_cll=p.max_cll,
                     display_max_nits=p.display_max_nits,
                     mastering_max_nits=p.mastering_max_nits,
                     window=guided_meta(th).windows[0]).numpy()
    mse = np.mean((want - ref) ** 2)
    assert want.shape == ref.shape and 10 * np.log10(1 / mse) >= 55.0
