"""The rule by which each route of the port takes a serving call's tail
values, held to the JAX package's own choice.

A route takes the local tone map's five scalars either static (the plan's
metadata in float64 on the host: the JAX package's ``_local_tonemap``) or
as float32 serving scalars (the plan's metadata merged with ``rt["hdr"]``:
its ``_pack_rt_all``, or ``local_tonemap_pq_rt`` on its XLA routes), and
which of a call's ``rt`` key sets picks the serving ones differs by route
(``pipeline.RT_SCALARS``).  Each case runs one route of the port on the
CPU (the kernel routes through the wrappers' plain versions), captures the
epilogue, the mid stage or the scalars it hands its tail, and runs the JAX
package's serving function on the same plan and ``rt`` with its kernels
stubbed, stopping at the tail to read the choice it made there.  A Dolby
Vision route of the port also rebuilds its mid stage (K8's, or stage A's
in the two-stage form) for any ``rt``; where the JAX package keeps its
static stage A (no curves, no matrix), the rebuilt values are the static
ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu.kernels import deint_pallas as jdp
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import tonemap as jtm

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import tonemap as ttm

from torch_hdr_cells import JAX, TORCH, cell_args, p010

ROUTES = ("fused_kernel", "fused_plain", "dovi_mid", "dovi_two_stage",
          "staged")
KEY_SETS = ((), ("cmat",), ("hdr",), ("l2_trims",))
TRIMS = dict(chroma_weight=0.1, saturation_gain=0.05, trim_slope=0.9,
             trim_offset=0.02, trim_power=1.1)
SCENE_TRIMS = dict(chroma_weight=0.2, saturation_gain=0.1, trim_slope=1.1,
                   trim_offset=-0.01, trim_power=0.95)


class Stop(Exception):
    """Raised by the JAX package's stubbed tail once its choice is read."""


def _plans(route: str):
    """(JAX plan, port plan) of a route: c8hdr (Dolby Vision to a 600-nit
    display, the local tone map, L2 trims) for the Dolby Vision routes,
    else c7 (HDR10 to a 600-nit display, BT.2390) with enabled L2 trims,
    the kernels off for the plain route, the shader order for the staged
    one."""
    if route.startswith("dovi"):
        args = [cell_args(m, "c8hdr") for m in (JAX, TORCH)]
    else:
        args = [cell_args(m, "c7p", hdr10plus=None,
                          dovi_trims=m["pipe"].tonemap_ops.DoviTrims(
                              **TRIMS, l2_enabled=True))
                for m in (JAX, TORCH)]
        kw = {"fused_plain": dict(use_accel_backend=False),
              "staged": dict(vp_scaling=False)}.get(route, {})
        args = [(dataclasses.replace(a[0], **kw), *a[1:]) for a in args]
    return tuple(m["pipe"].plan_pipeline(*a)
                 for m, a in zip((JAX, TORCH), args))


def _rt(tplan, keys: tuple) -> dict:
    """A scene's values of ``keys``: a colour matrix, all five HDR10
    values (a brighter scene), the L2 trims."""
    values = {
        "cmat": {"m": np.asarray(tplan.cmat_m, np.float32) * 0.98,
                 "c": np.asarray(tplan.cmat_c, np.float32)},
        "hdr": dict({k: getattr(tplan.tonemap_params, k)
                     for k in ttm.HDR_KEYS}, max_cll=2000.0, max_fall=300.0),
        "l2_trims": SCENE_TRIMS,
    }
    return {k: values[k] for k in keys}


def _port(route, tplan, rt, monkeypatch):
    """Run the port's route without and then with ``rt``: (the scalars its
    tail took with ``rt``, whether they were the serving ones, the
    epilogue its tail kernel got or None, the mid stages of the two calls
    or None)."""
    made = []
    tonemap_scalars = tpipe._tonemap_scalars

    def spy_scalars(plan, hdr=None):
        out = tonemap_scalars(plan, hdr)
        made.append((hdr, out))
        return out

    seen = {}

    def capture(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            seen.setdefault(name, []).append(args[6])
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    taken = []
    from_scalars = ttm.local_tonemap_pq_from_scalars

    def spy_tail(rgb, selection, scalars, **kw):
        taken.append(scalars)
        return from_scalars(rgb, selection, scalars, **kw)

    monkeypatch.setattr(tpipe, "_tonemap_scalars", spy_scalars)
    monkeypatch.setattr(ttm, "local_tonemap_pq_from_scalars", spy_tail)
    for mod, name in ((trk, "rows3_tail"), (trk, "rows3_tail_dovi"),
                      (tdk, "rows3_mid"), (tdk, "cols3_tail")):
        capture(mod, name)
    if route.startswith("dovi"):
        monkeypatch.setattr(tpipe, "_on_card", lambda planes: True)
        monkeypatch.setenv("VRT_TPU_DOVI_MID",
                           "0" if route == "dovi_two_stage" else "1")
    fn = tpipe.make_serving_fn(tplan, pack_surface=True)
    planes = tuple(torch.from_numpy(p) for p in p010(5))
    fn(planes)
    taken.clear()
    fn(planes, rt)
    scalars = taken[-1]
    serving = [hdr is not None for hdr, out in made if out is scalars]
    assert len(serving) == 1
    epi = {"fused_kernel": "rows3_tail", "dovi_mid": "cols3_tail",
           "dovi_two_stage": "rows3_tail"}.get(route)
    mid = {"dovi_mid": "rows3_mid", "dovi_two_stage": "rows3_tail_dovi"}
    return (scalars, serving[0], None if epi is None else seen[epi][-1],
            seen[mid[route]] if route in mid else None)


def _jax(route, jplan, rt, monkeypatch):
    """The JAX package's choice for ``rt`` on the same route: (whether its
    tail takes the serving scalars, its serving scalars from
    ``_pack_rt_all``, whether it repacks its stage A)."""
    got = {}

    def tail(*args, rt_scalars=None, **kw):
        got["tail"] = rt_scalars
        raise Stop

    def stage_a(*args, rt_scalars=None, **kw):
        got["stage_a"] = rt_scalars
        return jnp.zeros((2, 3, 4, 4), jnp.float32)

    def xla(kind):
        def spy(*args, **kw):
            got["tail"] = kind
            raise Stop
        return spy

    monkeypatch.setattr(jpipe, "_local_tonemap", xla(None))
    monkeypatch.setattr(jtm, "local_tonemap_pq_rt", xla("serving"))
    monkeypatch.setattr(jrp, "banded_resize_last_axis", lambda p, *a, **k: p)
    if route == "dovi_two_stage":
        calls = iter((stage_a, tail))
        monkeypatch.setattr(jrp, "rows3_tail",
                            lambda *a, **k: next(calls)(*a, **k))
    else:
        monkeypatch.setattr(jrp, "rows3_tail", tail)
    monkeypatch.setattr(jdp, "rows3_mid", stage_a)
    monkeypatch.setattr(jdp, "cols3_tail", tail)
    monkeypatch.setenv("VRT_TPU_DOVI_MID",
                       "0" if route == "dovi_two_stage" else "1")
    if route in ("fused_kernel", "dovi_mid", "dovi_two_stage"):
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    fn = jpipe.make_serving_fn(jplan, pack_surface=True)
    with pytest.raises(Stop):
        fn(tuple(jnp.asarray(p) for p in p010(5)), rt)
    with_cmat = not route.startswith("dovi")
    tail_rt = {k: v for k, v in rt.items()
               if k in jpipe._rt_allowed_keys(jplan, with_cmat)}
    packed = np.asarray(jpipe._pack_rt_all(jplan, tail_rt,
                                           with_cmat=with_cmat))
    at = 0
    for name, n in jpipe._rt_layout(jplan, with_cmat):
        if name == "hdr":
            break
        at += n
    return (got["tail"] is not None, packed[at:at + 5],
            got.get("stage_a") is not None)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("keys", KEY_SETS, ids=lambda k: "+".join(k) or "none")
@pytest.mark.parametrize("route", ROUTES)
def test_route_takes_the_scalars_the_jax_package_takes(route, keys,
                                                       monkeypatch):
    jplan, tplan = _plans(route)
    assert tplan.local_tonemap and set(keys) <= tpipe.serving_rt_keys(tplan)
    rt = _rt(tplan, keys)
    want_serving, jax_scalars, jax_repacks = _jax(route, jplan, rt,
                                                  monkeypatch)
    monkeypatch.undo()
    scalars, serving, epi, mids = _port(route, tplan, rt, monkeypatch)

    assert serving == want_serving
    if serving:
        assert scalars.dtype == np.float32
        if tplan.tonemap_type == 6:
            assert _ulps(scalars[:2], jax_scalars[:2]).max() <= 2
            np.testing.assert_allclose(scalars[2:], jax_scalars[2:],
                                       rtol=2e-5, atol=1e-12)
        else:
            assert _ulps(scalars, jax_scalars).max() <= 2
    else:
        assert np.array_equal(scalars, ttm.local_tonemap_static_scalars(
            tplan.tonemap_type, tplan.tonemap_params))
    if epi is not None:
        assert epi.tonemap_scalars is scalars
        assert epi.tonemap == tplan.tonemap_type
    if mids is not None:
        static, mid = mids[0], mids[-1]
        assert (mid is not static) == bool(rt)
        if not jax_repacks:
            assert mid.structure == static.structure
            assert np.array_equal(mid.host_values(), static.host_values())
        assert jax_repacks == bool(rt.keys() & {"cmat", "dovi_curves"})
