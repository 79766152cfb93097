"""The benchmark's HDR10 passthrough cell ``hdr10_4k.bt2390_b16`` on the
CPU: the port's serving function for its configuration
(``vrbench/configs/hdr10_uhd_to_hdr600_bt2390.json``) against the plain
reference ``vrbench/reference/hdr10_bt2390.py`` at small sizes, the
reference against the JAX package's ``ops.tonemap.bt2390`` and the port's
``oracle.oracle_c7``, the chain's costs at full size, the traffic's
scenes, the entry adapter, the three readers the cell adds, and K2's
launch counter by route.

Tolerances of the port against the reference (float64), each frame:

* at most 2 codes in any channel: the port computes in float32 with the
  chroma's W pass in mid16 codes (2^-14 steps); 1 code is a dither
  threshold crossed, and the 2-code gaps lie where random codes reach
  past the scene's MaxCLL (up to ~28,000 nits), where the spline,
  extrapolated past ``max_pq``, steepens;
* at most 5% of the channels off the reference's code: the port reads
  1.0-2.3% at these sizes; the control (the reference in float32 with
  TF32 products) reads 14-20%, so it fails this one in every case.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrbench import gen, roofline, spec
from vrbench.costs import passthrough_mid16
from vrbench.entries import common, serving_hdr10
from vrbench.metrics import (bt2390_call_roofline_pct, call_roofline_pct,
                             k2_bt2390_roofline_pct, k2_roofline_pct,
                             tonemap_host_ms_per_call)
from vrbench.reference import hdr10_bt2390 as ref
from vrbench.reference.oracle import Arith
from vrbench.surfaces import r10g10b10a2 as surface
from vrbench.tests import faults
from vrbench.trace import Trace

from videorenderer_tpu.ops import tonemap as jax_tonemap
from videorenderer_tpu_torch import make_serving_fn, plan_pipeline
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.oracle import oracle_c7

CELL = "hdr10_4k.bt2390_b16"
MAX_GAP = 2
MAX_OFF = 0.05
CONTROL = Arith(torch.float32, tf32=True)


def cell():
    return spec.load_cell(CELL)


def config(w, h, ow, oh) -> dict:
    c = copy.deepcopy(cell().config)
    c["video_source"].update(width=w, height=h)
    c["output"].update(width=ow, height=oh)
    return c


def scenes() -> dict:
    """The traffic's first and sixth scenes and three beside them: the
    display at or above MaxCLL (passthrough), MaxCLL at most 10 (the
    mastering peak in its place) and both at most 10 (1000 nits)."""
    t = cell().traffic
    s0 = gen.scene(t, 0)
    return {"scene0": s0, "scene5": gen.scene(t, 5),
            "passthrough": dict(s0, max_cll=500.0),
            "mastering_peak": dict(s0, max_cll=5.0),
            "peak_1000": dict(s0, max_cll=5.0, mastering_max_nits=8.0)}


def planes(cfg: dict, n: int, seed: int):
    """``n`` frames of the cell's random codes, with a black 8 x 8 patch
    (luma 64, chroma 512: RGB 0, the tone map's gain of 1) in the top
    left of each."""
    g = torch.Generator().manual_seed(seed)
    y, u, v = spec.module("frames", "p010").batch(cfg, cell().traffic, n, g,
                                                 "cpu")
    y, u, v = y.clone(), u.clone(), v.clone()
    y[:, :8, :8] = 64 << 6
    u[:, :4, :4] = 512 << 6
    v[:, :4, :4] = 512 << 6
    return y, u, v


def serving_fn(cfg: dict):
    return make_serving_fn(plan_pipeline(serving_hdr10.settings(cfg),
                                         common.source(cfg),
                                         common.output(cfg)),
                           pack_surface=True)


def gaps(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    d = (got - want).abs()
    return int(d.max()), (d > 0).double().mean().item()


GEOMETRIES = {"1to1": (96, 54, 96, 54), "2to1": (128, 72, 64, 36)}


@pytest.mark.parametrize("scene", list(scenes()))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_port_matches_the_reference(geometry, scene):
    cfg = config(*GEOMETRIES[geometry])
    hdr = scenes()[scene]
    y, u, v = planes(cfg, 2, 7)
    out = serving_fn(cfg)((y, u, v), {"hdr": hdr})
    assert out.dtype == torch.int32 and surface.bad(out) == 0
    for f in range(2):
        want = ref.frame(cfg, (y[f], u[f], v[f]), hdr)
        gap, off = gaps(surface.codes(out[f]), want)
        assert gap <= MAX_GAP and off <= MAX_OFF, (f, gap, off)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_control_fails_a_tolerance(geometry):
    """The reference in float32 with TF32 products, in the port's place,
    is off by more than the tolerances allow in every scene."""
    cfg = config(*GEOMETRIES[geometry])
    y, u, v = planes(cfg, 1, 8)
    for name, hdr in scenes().items():
        want = ref.frame(cfg, (y[0], u[0], v[0]), hdr)
        control = ref.frame(cfg, (y[0], u[0], v[0]), hdr, CONTROL)
        gap, off = gaps(control, want)
        assert gap > MAX_GAP or off > MAX_OFF, (name, gap, off)


def test_every_branch_of_the_eetf_is_taken():
    """The planes reach both sides of the knee and past MaxCLL, and hold
    black pixels, whose gain is 1."""
    cfg = config(*GEOMETRIES["1to1"])
    y, u, v = planes(cfg, 1, 7)
    hdr = scenes()["scene0"]
    p = ref.params(cfg)
    m, c = ref.colour.yuv_to_rgb(p["matrix"], p["levels"])
    ycc = ref.normalised(y[0], u[0], v[0], Arith())
    rgb = torch.einsum("ij,jhw->ihw", torch.as_tensor(m), ycc) \
        + torch.as_tensor(c)[:, None, None]
    nits = ref.pq_eotf(rgb) * ref.PQ_NITS
    avg = torch.einsum("k,khw->hw", torch.tensor(ref.colour.LUMA["BT_2020_NC"],
                                                 dtype=torch.float64), nits)
    e1 = ref.pq_oetf(avg / ref.PQ_NITS)
    max_pq = ref.pq_oetf(torch.tensor(3000.0 / ref.PQ_NITS)).item()
    target_pq = ref.pq_oetf(torch.tensor(600.0 / ref.PQ_NITS)).item()
    ks = 1.5 * target_pq - 0.5 * max_pq
    assert (e1 <= ks).any() and (e1 > ks).any() and (e1 > max_pq).any()
    # the chroma's upsample reaches past the patch at its last row and
    # column
    assert (avg[:6, :6] <= 1e-6).all()
    out = ref.bt2390(nits, hdr, 600.0)
    assert torch.equal(out[:, :6, :6], nits[:, :6, :6])
    assert not torch.equal(out, nits)
    assert torch.equal(ref.bt2390(nits, scenes()["passthrough"], 600.0), nits)


@pytest.mark.parametrize("scene", list(scenes()))
def test_reference_equals_the_ports_oracle_c7(scene):
    cfg = config(*GEOMETRIES["1to1"])
    hdr = scenes()[scene]
    y, u, v = planes(cfg, 1, 9)
    mine = ref.frame(cfg, (y[0], u[0], v[0]), hdr)
    theirs = oracle_c7(y[0], u[0], v[0], max_cll=hdr["max_cll"],
                       display_max_nits=600.0,
                       mastering_max_nits=hdr["mastering_max_nits"])
    assert torch.equal(mine, torch.round(theirs * 1023).to(torch.int64))


@pytest.mark.parametrize("scene", list(scenes()))
def test_tone_map_equals_the_jax_packages(scene):
    """``bt2390`` on nits from 0 to 12,000 against the JAX package's
    ``ops.tonemap.bt2390`` in float64, within 1e-11 relative: the two
    encode the scalars by other float64 routes, and past MaxCLL the
    extrapolated spline takes their last bits to 2e-12."""
    hdr = scenes()[scene]
    rng = np.random.default_rng(11)
    nits = rng.random((3, 16, 24)) * 12000.0
    nits[:, :2, :2] = 0.0
    mine = ref.bt2390(torch.from_numpy(nits), hdr, 600.0).numpy()
    params = jax_tonemap.HDRParams(display_max_nits=600.0, **hdr)
    theirs = np.asarray(jax_tonemap.bt2390(jnp.asarray(nits), params, axis=0))
    np.testing.assert_allclose(mine, theirs, rtol=1e-11, atol=1e-9)


def test_safe_max_cll():
    assert ref.safe_max_cll({"max_cll": 3000, "mastering_max_nits": 4000}) \
        == 3000.0
    assert ref.safe_max_cll({"max_cll": 10, "mastering_max_nits": 4000}) \
        == 4000.0
    assert ref.safe_max_cll({"max_cll": 0, "mastering_max_nits": 10}) \
        == 1000.0


def test_reference_refuses_what_it_does_not_run():
    cfg = config(*GEOMETRIES["1to1"])
    for key, value in (("convert_to_sdr", True),
                       ("hdr_local_tone_mapping_type", "ACES")):
        bad = copy.deepcopy(cfg)
        bad["settings"][key] = value
        with pytest.raises(ValueError):
            ref.params(bad)
    y, u, v = planes(config(256, 72, 64, 72), 1, 1)
    with pytest.raises(ValueError):
        ref.frame(config(256, 72, 64, 72), (y[0], u[0], v[0]), None)


def test_k2_byte_bound_at_full_size():
    """K2 at the cell's shapes: the raw luma, the mid16 chroma and the
    surface of 16 frames, 1,061,683,200 bytes, bound at 0.317 ms by
    memory (its FLOPs, the chroma's H taps and the matrix, 0.05 ms)."""
    st = passthrough_mid16.stages(cell().config, cell().batch)
    nbytes, flops = st["K2"]
    assert nbytes == 16 * (3840 * 2160 * 2 + 2 * 1080 * 3840 * 2
                           + 3840 * 2160 * 4)
    assert round(1e3 * roofline.least_seconds(nbytes, flops), 3) == 0.317
    assert flops / roofline.PEAK_FP32_FLOPS_S < nbytes / roofline.PEAK_BYTES_S
    # K1: the two chroma planes only; the call: raw planes in, surface out
    assert st["K1"][0] == 16 * (2 * 1080 * 1920 * 2 + 2 * 1080 * 3840 * 2)
    assert st["call"][0] == 16 * (3840 * 2160 * 2 + 2 * 1080 * 1920 * 2
                                  + 3840 * 2160 * 4)
    assert st["call"][1] == st["K1"][1] + st["K2"][1]


def test_costs_charge_a_luma_w_pass_only_where_the_width_changes():
    small = passthrough_mid16.stages(config(128, 72, 64, 36), 2)
    same = passthrough_mid16.stages(config(128, 72, 128, 72), 2)
    luma_w = 2 * 72 * 128 * 2 + 2 * 72 * 64 * 2
    chroma = 2 * 2 * 36 * 64 * 2
    assert small["K1"][0] == chroma + 2 * 2 * 36 * 64 * 2 + luma_w
    assert same["K1"][0] == chroma + 2 * 2 * 36 * 128 * 2
    # K2 reads the luma's W pass at the output width, or the raw luma
    assert small["K2"][0] == 2 * 72 * 64 * 2 + 2 * 2 * 36 * 64 * 2 \
        + 2 * 36 * 64 * 4
    assert same["K2"][0] == 2 * 72 * 128 * 2 + 2 * 2 * 36 * 128 * 2 \
        + 2 * 72 * 128 * 4


def test_traffic_has_eight_scenes_above_the_display():
    t = cell().traffic
    assert t["scenes"]["count"] == 8 and t["scenes"]["calls"] == 4
    got = [gen.scene(t, i) for i in range(8)]
    assert [s["max_cll"] for s in got] == pytest.approx(
        [3000.0 * (1 - 0.06 * i) for i in range(8)])
    assert got[-1]["max_cll"] == pytest.approx(1740.0)
    assert [s["max_fall"] for s in got] == pytest.approx(
        [800.0 * (1 - 0.06 * i) for i in range(8)])
    assert {s["mastering_max_nits"] for s in got} == {4000}
    assert min(s["max_cll"] for s in got) > \
        cell().config["settings"]["hdr_display_max_nits"]
    assert [gen.scene_of(t, k) for k in (0, 3, 4, 31, 32)] == [0, 0, 1, 7, 0]


def test_stale_scene_keeps_the_first_scenes_values():
    seen = {}

    def build(config, traffic, device):
        seen["traffic"] = traffic
        return common.Entry(lambda planes, index, span: None)

    faults.broken("stale_scene", build)(cell().config, cell().traffic, "cpu")
    stale = seen["traffic"]
    assert all(gen.scene(stale, i) == gen.scene(cell().traffic, 0)
               for i in range(8))
    assert gen.scene(cell().traffic, 1) != gen.scene(cell().traffic, 0)


def test_entry_makes_a_scenes_values_at_its_first_call():
    c = cell()
    c.config = config(128, 72, 64, 36)
    entry = serving_hdr10.build(c.config, c.traffic, "cpu")
    opened = []

    def span(name):
        opened.append(name)
        return contextlib.nullcontext()

    entry.span = span
    y, u, v = planes(c.config, 2, 3)
    outs = [entry.call((y, u, v), k) for k in range(9)]
    assert opened == ["vrbench.scene_hdr"] * 3      # calls 0, 4, 8
    assert outs[0].shape == (2, 36, 64)
    assert torch.equal(outs[0], outs[3])
    assert not torch.equal(outs[3], outs[4])


def test_cell_reports_the_new_metrics_and_the_end_to_end_ones():
    c = cell()
    assert c.chips == 1
    assert {m["name"] for m in c.per_layer} == {
        "k2_bt2390_roofline_pct", "bt2390_call_roofline_pct",
        "tonemap_host_ms_per_call"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s",
                                                  "call_ms_p95", "setup_s"}
    bench = spec.load_json(spec.BENCHMARK)
    entry = next(x for x in bench["configs"]
                 if x["name"] == "hdr10_uhd_to_hdr600_bt2390")
    assert entry["source"] == c.config["source"] and entry["reduced"] == []


def test_roofline_readers_are_the_shared_ones():
    assert k2_bt2390_roofline_pct.read is k2_roofline_pct.read
    assert bt2390_call_roofline_pct.read is call_roofline_pct.read
    trace = Trace(window_s=1.0, calls=2,
                  device_ops=[("rows3_tail_kernel", 0.0, 0.004),
                              ("rows3_tail_kernel", 0.004, 0.008),
                              ("banded_resize_kernel", 0.008, 0.009)])
    costs = passthrough_mid16.stages(cell().config, 16)
    ctx = SimpleNamespace(trace=trace, costs=costs)
    # two calls' least K2 time over 8 ms of K2
    assert k2_bt2390_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * costs["K2"][0] / roofline.PEAK_BYTES_S / 0.008)
    assert bt2390_call_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * costs["call"][0] / roofline.PEAK_BYTES_S / 0.009)


T0 = 1_700_000_000_000_000_000


def test_tonemap_host_ms_per_call_reads_the_spans_in_root_calls(monkeypatch):
    from vrbench import program
    spans = [("vrt.call", 1, None, T0 + 310_000, T0 + 710_000),
             ("vrt.build.epilogue", 1, 1, T0 + 320_000, T0 + 420_000),
             ("vrt.tonemap_scalars", 1, 2, T0 + 330_000, T0 + 380_000),
             ("vrt.call", 4, None, T0 + 1_310_000, T0 + 1_610_000),
             ("vrt.tonemap_scalars", 4, 5, T0 + 1_320_000, T0 + 1_350_000),
             # outside every root call: not counted
             ("vrt.tonemap_scalars", 9, None, T0 + 1_700_000, T0 + 1_800_000)]
    trace = Trace(window_s=0.002, calls=2,
                  host_spans=[("vrbench.call", 0.000305, 0.000715),
                              ("vrbench.call", 0.001305, 0.001615)])
    ctx = SimpleNamespace(trace=trace)
    monkeypatch.setattr(program, "recorded", lambda: spans)
    # 0.05 + 0.03 ms over two calls
    assert tonemap_host_ms_per_call.read(ctx) == pytest.approx(0.04)
    monkeypatch.setattr(program, "recorded", lambda: None)
    assert tonemap_host_ms_per_call.read(ctx) is None
    assert tonemap_host_ms_per_call.read(SimpleNamespace(trace=None)) is None


def test_reference_imports_neither_jax_nor_the_port():
    root = str(spec.ROOT)
    code = (f"import sys; sys.path.insert(0, {root!r})\n"
            "import vrbench.reference.hdr10_bt2390, vrbench.costs."
            "passthrough_mid16\n"
            "import json; print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "videorenderer_tpu",
                        "videorenderer_tpu_torch"}


class FakeLib:
    def __init__(self):
        self.asked = []

    def vrt_rows3_tail_route(self, *args):
        self.asked.append(args)
        return b"long-window runtime" if args[-1] else b"c7 uint16/int16"


def test_k2_route_names_are_asked_once_a_key(monkeypatch):
    from videorenderer_tpu_torch.kernels import build
    lib = FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(rk, "_ROUTE_NAMES", {})
    cfg = config(*GEOMETRIES["1to1"])
    from videorenderer_tpu_torch import pipeline
    plan = plan_pipeline(serving_hdr10.settings(cfg), common.source(cfg),
                         common.output(cfg))
    epi = pipeline._make_tail_epilogue(plan, rt={"hdr": scenes()["scene0"]})
    for _ in range(3):
        assert rk.rows3_tail_route(torch.uint16, torch.int16, epi,
                                   "rgb10a2") == "c7 uint16/int16"
    assert rk.rows3_tail_route(torch.uint16, torch.int16, epi, "rgb10a2",
                               long_window=True) == "long-window runtime"
    assert len(lib.asked) == 2
    assert lib.asked[0][:-1] == rk.route_flags(torch.uint16, torch.int16,
                                               epi, "rgb10a2")


def test_redo_counters_register_and_reset(monkeypatch):
    """The c7 routes' redo counters (``rk.redo_counter``): one int64 a
    kernel and device, made at its first use and kept; ``redo_groups`` sums
    a kernel's over its devices, ``k2_redo_groups`` is K2's;
    ``reset_launches`` zeroes them and keeps them."""
    monkeypatch.setattr(rk, "redo_counters", {})
    assert rk.k2_redo_groups() == 0
    k2 = rk.redo_counter("rows3_tail", "cpu")
    assert k2.dtype == torch.int64 and k2.shape == (1,) and int(k2) == 0
    assert rk.redo_counter("rows3_tail", torch.device("cpu")) is k2
    k4 = rk.redo_counter("mega3_tail", "cpu")
    k2 += 7
    k4 += 2
    assert rk.k2_redo_groups() == 7 and rk.redo_groups("mega3_tail") == 2
    rk.reset_launches()
    assert rk.k2_redo_groups() == 0 and rk.redo_groups("mega3_tail") == 0
    assert rk.redo_counter("rows3_tail", "cpu") is k2
    assert set(rk.redo_counters) == {("rows3_tail", torch.device("cpu")),
                                     ("mega3_tail", torch.device("cpu"))}


def test_reset_launches_zeroes_k2s_routes():
    assert rk.route_launches["rows3_tail"] is rk.k2_route_launches
    rk.k2_route_launches["c7 uint16/int16"] = 3
    rk.k2_route_launches[rk.K2_LONG] = 1
    rk.reset_launches()
    assert set(rk.k2_route_launches.values()) == {0}
