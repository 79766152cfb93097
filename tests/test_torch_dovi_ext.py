"""Dolby Vision extension blocks (L1/L2/L3/L6) and the L2 trims in
videorenderer_tpu_torch against the JAX package, on the CPU at small sizes:
the same inputs (numpy, from a seed) through the JAX function and its port.

 * ``ops/dovi_ext`` (a numpy copy of the JAX module): the PQ conversions,
   L1 (+L3), the L2 selection (scenarios A, B and C), the L6 merge, the
   tone map's parameters and the serving values: equal.
 * ``dolby_vision_trims`` on PQ values: within 2e-6 (measured 1.8e-7: the
   trims' powers are libm's and Sleef's).  Its nits form, ``apply_l2_trim``
   and ICtCp pass through the float32 PQ curve, whose exp2/log2 differ by
   ulps between XLA and torch: compared in the PQ domain, within 4e-5 and
   1e-5 on >= 99% of the values (tests/test_torch_tonemap.py's band); ICtCp
   and apply_l2_trim, whose rows cancel, as their test states.
 * The trims through the static, serving and ``_from_scalars`` routes of
   the local tone map for every selection (5 and 6 in their general
   forms, 7 with a guided window): the same band.
 * c8x and c8hdr (tests/torch_hdr_cells.py) and the plans of HDR10, HDR10+,
   DoVi with extensions, SDR and the SDR BT.2020 fix: every plan field and
   ``output_signal_info(plan).to_dict()`` equal to the JAX package's.
 * c8x, c8hdr, an HDR10 plan with L2 trims and Dolby Vision with HDR10+
   through the frame and serving functions: the port's plain versions
   against the JAX kernel route (Pallas in interpret mode) within the
   mid16 band (1 code on >= 99.9% of the channels, none beyond 3); the
   float64 oracle with the trims (c8x) and the HDR output (c8hdr) >= 55 dB
   against the JAX serving function in float64.
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
from videorenderer_tpu.ops import dovi_ext as jext
from videorenderer_tpu.ops import hdr10plus as jh
from videorenderer_tpu.ops import tonemap as jtm

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import dovi_ext as text
from videorenderer_tpu_torch.ops import hdr10plus as th
from videorenderer_tpu_torch.ops import tonemap as ttm
from videorenderer_tpu_torch.oracle import oracle_dovi

from torch_hdr_cells import (JAX, TORCH, assert_mid16_band, cell_args,
                             dovi_extensions, guided_meta, p010, plain_value,
                             plan_differences, plans)


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


def _pq64(nits):
    """float64 PQ code of nits (for comparing nits outputs where it
    matters: on the PQ scale)."""
    m1, m2 = 2610 / 16384, 2523 / 4096 * 128
    c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
    y = np.clip(np.asarray(nits, np.float64) / 10000.0, 0, None) ** m1
    return ((c1 + c2 * y) / (1 + c3 * y)) ** m2


def _close_pq(got, ref):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 4e-5 and np.quantile(d, 0.99) <= 1e-5, (
        d.max(), np.quantile(d, 0.99))


# --- ops/dovi_ext: the host half ----------------------------------------------

def _ext_fields(seed: int) -> dict:
    """An extension set's fields from a seed: L1 always or never, L3, L6
    and 0-4 L2 blocks at targets between 100 and 4000 nits."""
    rng = np.random.default_rng(seed)
    f = {"source_max_pq": int(rng.integers(2800, 3500)),
         "source_min_pq": int(rng.integers(0, 60))}
    if seed % 4 != 3:
        f["l1"] = dict(min_pq=int(rng.integers(0, 200)),
                       max_pq=int(rng.integers(2500, 3600)),
                       avg_pq=int(rng.integers(800, 2000)))
    if seed % 3 == 1:
        f["l3"] = dict(min_pq_offset=int(rng.integers(1900, 2200)),
                       max_pq_offset=int(rng.integers(1800, 2300)),
                       avg_pq_offset=int(rng.integers(1900, 2200)))
    if seed % 2:
        f["l6"] = dict(max_luminance=int(rng.integers(1000, 4000)),
                       min_luminance=int(rng.integers(1, 50)),
                       max_cll=int(rng.integers(0, 3000)) * (seed % 5 != 0),
                       max_fall=int(rng.integers(0, 500)))
    f["l2"] = [dict(target_max_pq=int(rng.integers(2000, 3500)),
                    **{k: int(rng.integers(1500, 2600)) for k in (
                        "trim_slope", "trim_offset", "trim_power",
                        "trim_chroma_weight", "trim_saturation_gain")})
               for _ in range(int(rng.integers(0, 5)))]
    return f


def _ext(m, f: dict):
    return m.DoviExtensions(
        l1=m.L1Extension(**f["l1"]) if "l1" in f else None,
        l2=tuple(m.L2Extension(**b) for b in f["l2"]),
        l3=m.L3Extension(**f["l3"]) if "l3" in f else None,
        l6=m.L6Extension(**f["l6"]) if "l6" in f else None,
        source_max_pq=f["source_max_pq"], source_min_pq=f["source_min_pq"])


def test_pq_conversions_equal():
    for code in range(0, 4096, 7):
        assert text.pq_to_nits(code / 4095.0) == jext.pq_to_nits(code / 4095.0)
    for nits in np.geomspace(1e-3, 1e4, 97):
        assert text.nits_to_pq(nits) == jext.nits_to_pq(nits)


@pytest.mark.parametrize("seed", range(12))
def test_host_functions_equal(seed):
    f = _ext_fields(seed)
    je, te = _ext(jext, f), _ext(text, f)
    assert text.l1_nits(te) == jext.l1_nits(je)
    assert text.mastering_nits(te) == jext.mastering_nits(je)
    for display in (100.0, 600.0, 1000.0, 4000.0):
        assert (plain_value(text.select_l2_trims(te, display))
                == plain_value(jext.select_l2_trims(je, display)))
        jt = jext.runtime_trims_from_extensions(je, display)
        tt = text.runtime_trims_from_extensions(te, display)
        assert plain_value(tt) == plain_value(jt)
    for h in (None, (0.01, 2000.0, 1500.0, 300.0)):
        jh10 = h and jpipe.HDR10Metadata(*h)
        th10 = h and tpipe.HDR10Metadata(*h)
        assert (plain_value(text.merge_hdr10(th10, te))
                == plain_value(jext.merge_hdr10(jh10, je)))
        for sel in (1, 5, 6):
            assert (plain_value(text.hdr_params_from_extensions(
                te, th10, 600.0, sel))
                == plain_value(jext.hdr_params_from_extensions(
                    je, jh10, 600.0, sel)))
        assert (plain_value(text.runtime_hdr_from_extensions(te, th10, 600.0))
                == plain_value(jext.runtime_hdr_from_extensions(je, jh10,
                                                                600.0)))


@pytest.mark.parametrize("display,scenario", [(100.0, "A"), (600.0, "A"),
                                              (4000.0, "B"), (50.0, "C")])
def test_l2_scenarios_equal(display, scenario):
    """c8x's three targets: between two (A), above all (B, toward neutral
    at the master), below all (C, the dimmest)."""
    je, te = dovi_extensions(jext), dovi_extensions(text)
    tt = text.select_l2_trims(te, display)
    assert plain_value(tt) == plain_value(jext.select_l2_trims(je, display))
    assert tt.l2_enabled
    if scenario == "C":
        assert tt.trim_slope == 1800 / 4096.0 + 0.5


# --- the trims, ICtCp -----------------------------------------------------------

TRIMS = dict(chroma_weight=0.05, saturation_gain=0.1, trim_slope=1.1,
             trim_offset=-0.02, trim_power=0.9, l2_enabled=True)


def _trim_sets():
    c8x = text.select_l2_trims(dovi_extensions(text), 100.0)
    return [TRIMS, {k: getattr(c8x, k) for k in TRIMS},
            dict(TRIMS, saturation_gain=0.0, chroma_weight=-0.1)]


def _nits(seed, shape=(3, 12, 20)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape) ** 3 * 4000).astype(np.float32)


@pytest.mark.parametrize("k", range(3))
def test_dolby_vision_trims_match_jax(k):
    kw = _trim_sets()[k]
    jt, tt = jtm.DoviTrims(**kw), ttm.DoviTrims(**kw)
    pq = np.random.default_rng(90 + k).uniform(0, 1, (3, 12, 20)).astype(
        np.float32)
    ref = jtm.dolby_vision_trims(jnp.asarray(pq), jt, axis=0, pq_input=True)
    got = ttm.dolby_vision_trims(t(pq), tt, axis=0, pq_input=True)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 2e-6
    nits = _nits(95 + k)
    ref = jtm.dolby_vision_trims(jnp.asarray(nits), jt, axis=0)
    got = ttm.dolby_vision_trims(t(nits), tt, axis=0)
    _close_pq(_pq64(got.numpy()), _pq64(np.asarray(ref)))


def test_ictcp_and_apply_l2_trim_match_jax():
    """ICtCp's rows difference PQ values (Ct, Cp up to 4.4x the PQ band;
    measured 3.5e-5); the way back within 1e-5 of each pixel's largest
    channel (measured 1.7e-6).  apply_l2_trim moves I against Ct and Cp, so
    the way back then cancels: within 1e-3 of the input pixel's largest
    channel, 5e-4 on >= 99% (measured 4.8e-4 and 2.6e-4)."""
    nits = _nits(100)
    ref = np.asarray(jtm.rgb_to_ictcp(jnp.asarray(nits), axis=0))
    got = ttm.rgb_to_ictcp(t(nits), axis=0).numpy()
    assert np.abs(got - ref).max() <= 4.4 * 4e-5
    back_j = np.asarray(jtm.ictcp_to_rgb(jnp.asarray(ref), axis=0))
    back_t = ttm.ictcp_to_rgb(t(ref), axis=0).numpy()
    scale = np.maximum(np.abs(back_j).max(0, keepdims=True), 1e-3)
    assert (np.abs(back_t - back_j) / scale).max() <= 1e-5
    scale = np.maximum(nits.max(0, keepdims=True), 1.0)
    for kw in _trim_sets():
        ref = np.asarray(jtm.apply_l2_trim(jnp.asarray(nits),
                                           jtm.DoviTrims(**kw), axis=0))
        got = ttm.apply_l2_trim(t(nits), ttm.DoviTrims(**kw), axis=0).numpy()
        rel = np.abs(got - ref) / scale
        assert rel.max() <= 1e-3 and np.quantile(rel, 0.99) <= 5e-4


C7 = dict(mastering_min_nits=0.005, mastering_max_nits=4000.0,
          max_cll=3000.0, max_fall=500.0, display_max_nits=600.0)


@pytest.mark.parametrize("route", ["static", "rt", "from_scalars"])
@pytest.mark.parametrize("sel", range(1, 8))
def test_trims_through_tonemap_routes_match_jax(sel, route):
    jt, tt = jtm.DoviTrims(**TRIMS), ttm.DoviTrims(**TRIMS)
    jw = guided_meta(jh).windows[0] if sel == 7 else None
    tw = guided_meta(th).windows[0] if sel == 7 else None
    x = np.random.default_rng(110 + sel).uniform(0, 1.1, (3, 12, 20)).astype(
        np.float32)
    if route == "static":
        ref = jtm.local_tonemap_pq(jnp.asarray(x), sel, jtm.HDRParams(**C7),
                                   trims=jt, axis=0, window=jw)
        got = ttm.local_tonemap_pq(t(x), sel, ttm.HDRParams(**C7), trims=tt,
                                   axis=0, window=tw)
    elif route == "rt":
        ref = jtm.local_tonemap_pq_rt(jnp.asarray(x), sel, C7, trims=jt,
                                      axis=0, window=jw)
        got = ttm.local_tonemap_pq_rt(t(x), sel, C7, trims=tt, axis=0,
                                      window=tw)
    else:
        sc = jtm.local_tonemap_rt_scalars(sel, C7)
        ref = jtm.local_tonemap_pq_from_scalars(jnp.asarray(x), sel, sc,
                                                trims=jt, axis=0, window=jw)
        got = ttm.local_tonemap_pq_from_scalars(
            t(x), sel, ttm.local_tonemap_rt_scalars(sel, C7), trims=tt,
            axis=0, window=tw)
    _close_pq(got.numpy(), np.asarray(ref))


def test_disabled_trims_leave_the_fast_paths():
    """Trims with l2_enabled False change nothing: selections 5 and 6 keep
    their m1-power forms, bit for bit."""
    x = t(np.random.default_rng(120).uniform(0, 1, (3, 8, 8)).astype(
        np.float32))
    off = ttm.DoviTrims(**dict(TRIMS, l2_enabled=False))
    for sel in (5, 6):
        sc = ttm.local_tonemap_static_scalars(sel, ttm.HDRParams(**C7))
        assert torch.equal(
            ttm.local_tonemap_pq_from_scalars(x, sel, sc, trims=off, axis=0),
            ttm.local_tonemap_pq_from_scalars(x, sel, sc, axis=0))


def test_serving_trim_values():
    tr = ttm.trims_from_values({k: np.float32(v) for k, v in TRIMS.items()
                                if k != "l2_enabled"})
    assert tr.l2_enabled and tr.trim_slope == float(np.float32(1.1))
    assert np.array_equal(ttm.trim_values(tr), np.asarray(
        [0.05, 0.1, 1.1, -0.02, 0.9], np.float32))
    with pytest.raises(ValueError, match="missing"):
        ttm.trims_from_values({"trim_slope": 1.0})
    with pytest.raises(TypeError, match="synchronise"):
        ttm.trims_from_values({k: torch.tensor(1.0, device="meta")
                               for k in ttm.TRIM_KEYS})


# --- plans and output_signal_info ------------------------------------------------

def _signal_cases():
    """(name, args builder) of the plans whose output signal is compared:
    HDR10 (c7), HDR10+ (c7p), DoVi with extensions to HDR and to SDR, SDR,
    the SDR BT.2020 fix."""
    def c7(m):
        return cell_args(m, "c7p", hdr10plus=None)

    def sdr(m, primaries="BT_709", transfer="BT_1886"):
        cfg, csp, pipe, fmt = m["cfg"], m["csp"], m["pipe"], m["fmt"]
        return (cfg.Settings(),
                pipe.SourceDescriptor(format=fmt.NV12, width=64, height=32,
                                      primaries=csp.Primaries[primaries],
                                      transfer=csp.TRC[transfer]),
                pipe.OutputDescriptor(width=32, height=16, bits=8))
    return {"hdr10": c7, "hdr10plus": lambda m: cell_args(m, "c7p"),
            "dovi_ext_hdr": lambda m: cell_args(m, "c8hdr"),
            "dovi_ext_sdr": lambda m: cell_args(m, "c8x"), "sdr": sdr,
            "bt2020_fix": lambda m: sdr(m, "BT_2020", "GAMMA22")}


@pytest.mark.parametrize("case", list(_signal_cases()))
def test_plans_and_output_signal_match_jax(case):
    make = _signal_cases()[case]
    jplan = jpipe.plan_pipeline(*make(JAX))
    tplan = tpipe.plan_pipeline(*make(TORCH))
    assert plan_differences(jplan, tplan) == []
    d = tpipe.output_signal_info(tplan).to_dict()
    assert d == jpipe.output_signal_info(jplan).to_dict()
    assert tpipe.OutputSignalInfo.from_dict(d).to_dict() == d
    assert tpipe.serving_rt_keys(tplan) == jpipe.serving_rt_keys(jplan)


def test_dovi_ext_plan_resolution():
    """c8x selects its trims for the 100-nit display, c8hdr for 600 nits
    with ST 2094-10 (the L1 upgrade of BT.2390) and the DoVi-merged output
    metadata; given trims win over the extension's."""
    _, x = plans("c8x")
    _, h = plans("c8hdr")
    assert x.dovi_trims.l2_enabled and not x.local_tonemap
    assert h.tonemap_type == 6 and h.local_tonemap
    assert h.output_hdr10 == text.merge_hdr10(tpipe.HDR10Metadata(),
                                              h.dovi_ext)
    assert "l2_trims" in tpipe.serving_rt_keys(x)
    assert tpipe.serving_rt_keys(h) == {"cmat", "hdr", "l2_trims",
                                        "dovi_curves"}
    given = ttm.DoviTrims(**TRIMS)
    plan = tpipe.plan_pipeline(*cell_args(TORCH, "c8x", dovi_trims=given))
    assert plan.dovi_trims is given
    epi = tpipe._make_tail_epilogue(plan, with_cmat=False)
    assert epi.trims_pq and np.array_equal(epi.trims, ttm.trim_values(given))


# --- the pipeline -------------------------------------------------------------------

PIPE_CASES = {
    "c8x": dict(cell="c8x"),
    "c8hdr": dict(cell="c8hdr"),
    # an HDR10 source with L2 trims: the linear trims in K2's tail
    "hdr10_trims": dict(cell="c7p", hdr10plus=None,
                        dovi_trims="TRIMS"),
    # Dolby Vision with HDR10+ (no extensions): the guided curve in K9
    "dovi_guided": dict(cell="c8hdr", dovi_ext=None, hdr10plus="GUIDED"),
}


def _case_plans(case: str, **kw):
    c = dict(PIPE_CASES[case], **kw)
    cell = c.pop("cell")
    jkw, tkw = dict(c), dict(c)
    for k, v in c.items():
        if v == "TRIMS":
            jkw[k], tkw[k] = jtm.DoviTrims(**TRIMS), ttm.DoviTrims(**TRIMS)
        elif v == "GUIDED":
            jkw[k], tkw[k] = guided_meta(jh), guided_meta(th)
    return (jpipe.plan_pipeline(*cell_args(JAX, cell, **jkw)),
            tpipe.plan_pipeline(*cell_args(TORCH, cell, **tkw)))


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_kernel_route_matches_jax_kernel(case, monkeypatch):
    jplan, tplan = _case_plans(case)
    assert plan_differences(jplan, tplan) == []
    planes = p010(130)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(tuple(jnp.asarray(p) for p in planes)))
    monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(
        tuple(t(p) for p in planes)).numpy()
    assert_mid16_band(got, ref)


def _scene_rt(m, plan, cell: str, i: int, tm=None) -> dict:
    """Scene i's serving values of a c8 cell in package ``m``: c8x takes
    the curves (scaled as chip_smoke.dovi_rt does) and the trims for the
    100-nit display, c8hdr the HDR10 values and the trims for 600 nits,
    from L1/L2 blocks that move with the scene."""
    ext = dovi_extensions(m["ext"], max_pq=3079 - 120 * i,
                          slope_100=1800 + 200 * i)
    display = 100.0 if cell == "c8x" else 600.0
    rt = {"l2_trims": m["ext"].runtime_trims_from_extensions(ext, display)}
    if cell == "c8x":
        rt["dovi_curves"] = {k: v * np.float32(1.0 - 0.01 * i) for k, v in
                             m["dovi"].pack_curves(plan.dovi).items()}
    else:
        rt["hdr"] = m["ext"].runtime_hdr_from_extensions(ext, plan.src.hdr10,
                                                        display)
    return rt


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("cell", ["c8x", "c8hdr"])
def test_serving_two_scenes_match_jax(cell, route, monkeypatch):
    """make_serving_fn over two scenes of curves or HDR10 values and trims,
    one function: the kernel route against the JAX kernel route, the plain
    route (use_accel_backend off) against the JAX XLA route."""
    accel = route == "kernel"
    jplan, tplan = plans(cell)
    if not accel:
        jplan, tplan = (dataclasses.replace(p, settings=dataclasses.replace(
            p.settings, use_accel_backend=False)) for p in (jplan, tplan))
    else:
        monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
    planes = p010(131)
    jfn = jpipe.make_serving_fn(jplan, pack_surface=True)
    tfn = tpipe.make_serving_fn(tplan, pack_surface=True)
    assert tfn.allowed_rt_keys == jfn.allowed_rt_keys
    outs = []
    for i in (0, 2):
        jrt = _scene_rt(JAX, jplan, cell, i)
        if "dovi_curves" in jrt:
            jrt["dovi_curves"] = {k: jnp.asarray(v)
                                  for k, v in jrt["dovi_curves"].items()}
        call = lambda: jfn(tuple(jnp.asarray(p) for p in planes), jrt)
        ref = in_interpret(monkeypatch, call) if accel else np.asarray(call())
        got = tfn(tuple(t(p) for p in planes),
                  _scene_rt(TORCH, tplan, cell, i)).numpy()
        assert_mid16_band(got, ref)
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])


def test_serving_refuses_trims_without_the_stage():
    _, tplan = plans("c8x", dovi_ext=None)
    fn = tpipe.make_serving_fn(tplan)
    with pytest.raises(ValueError, match="l2_trims"):
        fn(tuple(t(p) for p in p010(132)),
           {"l2_trims": {k: 1.0 for k in ttm.TRIM_KEYS}})


@pytest.mark.parametrize("cell", ["c8x", "c8hdr"])
def test_dovi_oracle_matches_jax_float64(cell):
    """oracle_dovi with the trims (c8x: PQ domain before PQ -> SDR; c8hdr:
    in nits, then ST 2094-10 for the HDR display) against the JAX serving
    function in float64 on one frame, the plan's values."""
    jplan, tplan = plans(cell)
    planes = tuple(p[0] for p in p010(133, n=1))
    with jax.enable_x64(True):
        ref = np.asarray(jpipe.make_serving_fn(jplan, dtype=jnp.float64)(
            planes, {}))
    tr = tplan.dovi_trims
    p = tplan.tonemap_params
    hdr_out = None if cell == "c8x" else dict(
        mastering_min_nits=p.mastering_min_nits, max_cll=p.max_cll,
        max_fall=p.max_fall, display_max_nits=p.display_max_nits)
    want = oracle_dovi(
        *(t(x) for x in planes), 32, 16,
        curves=tdovi.pack_curves(tplan.dovi),
        structure=tdovi.curve_structure(tplan.dovi),
        ycc_to_rgb=tplan.dovi.ycc_to_rgb_matrix,
        ycc_offset=tplan.dovi.ycc_to_rgb_offset,
        lms=tdovi.lms_pipeline_matrix(tplan.dovi),
        trims=[getattr(tr, k) for k in ttm.TRIM_KEYS],
        hdr_out=hdr_out).numpy()
    mse = np.mean((want - ref) ** 2)
    assert want.shape == ref.shape and 10 * np.log10(1 / mse) >= 55.0
