"""The benchmark's Jinc2 upscale cell ``sdr1080_4k.jinc2_b16`` on the CPU:
the port's ``VideoProcessor.process`` for its configuration
(``vrbench/configs/sdr1080_nv12_to_uhd_jinc2.json``) against the plain
reference ``vrbench/reference/sdr_jinc2.py`` at small sizes, on K6's
plain version (``pipeline._on_card`` patched, the kernel route) and on the
torch route (K5's plain version); the reference against the port's
``oracle.oracle_jinc2`` and the JAX package's direct gather; the chain's
costs at full size; the frames, the surface and the traffic; the plan
against c3's; the three readers the cell adds; K6's launch counter by
route and the weight table's build span.

Tolerances of the port against the reference (float64), each frame:

* at most 1 code in any channel: the port computes in float32, so a value
  within float32 rounding of a dither threshold can land on either side;
  nothing in the chain (no transfer curve, no gamut step) amplifies that
  rounding into more than one step;
* at most 0.2% of the channels off the reference's code: the port reads
  0-3.3e-5 at these sizes; the control (the reference in float32 with
  TF32 products) reads 4-5%, so it fails this one in every case.
"""

from __future__ import annotations

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

import vrbench.run as run
from vrbench import check, gen, loop, program, roofline, spec
from vrbench.control import control_outputs
from vrbench.costs import jinc2_k6
from vrbench.entries import common
from vrbench.metrics import (call_roofline_pct, entry_host_ms_per_call,
                             jinc2_call_roofline_pct, jinc2_host_ms_per_call,
                             k6_roofline_pct)
from vrbench.reference import sdr_jinc2 as ref
from vrbench.reference.oracle import Arith
from vrbench.surfaces import rgba8
from vrbench.tests import faults
from vrbench.trace import Trace

from tests.torch_hdr_cells import plan_differences
from videorenderer_tpu.ops import scale as jax_scale
from videorenderer_tpu_torch import VideoProcessor, plan_pipeline
import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch.kernels import jinc2 as jk
from videorenderer_tpu_torch.kernels import resize as rk
from videorenderer_tpu_torch.oracle import oracle_jinc2
from videorenderer_tpu_torch.utils import trace

import bench_common

CELL = "sdr1080_4k.jinc2_b16"
MAX_GAP = 1
MAX_OFF = 0.002
CONTROL = Arith(torch.float32, tf32=True)
# (w, h, out_w, out_h): 2x up, 8/3 up, the shrunk cell's 2:1 (up with
# interpolate_at_50pct)
GEOMETRIES = {"2x": (64, 36, 128, 72), "8_3": (48, 30, 128, 80),
              "2to1": (128, 72, 64, 36)}


def cell():
    return spec.load_cell(CELL)


def config(w, h, ow, oh) -> dict:
    c = copy.deepcopy(cell().config)
    c["video_source"].update(width=w, height=h)
    c["output"].update(width=ow, height=oh)
    return c


def planes(cfg: dict, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return spec.module("frames", "nv12").batch(cfg, cell().traffic, n, g,
                                               "cpu")


def processor(cfg: dict) -> VideoProcessor:
    return VideoProcessor(common.settings(cfg), common.source(cfg),
                          common.output(cfg), device="cpu", pack_surface=True)


def gaps(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    d = (got - want).abs()
    return int(d.max()), (d > 0).double().mean().item()


@pytest.mark.parametrize("route", ["k6_plain", "torch"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_port_matches_the_reference(monkeypatch, geometry, route):
    cfg = config(*GEOMETRIES[geometry])
    if route == "k6_plain":
        monkeypatch.setattr(tpipe, "_on_card", lambda p: True)
    called = []
    monkeypatch.setattr(jk, "jinc2_convert_fused", lambda *a, **k: (
        called.append(1), jk.jinc2_convert_fused_plain(*a, **k))[1])
    vp = processor(cfg)
    assert tpipe.route_of(vp.plan) == "staged"
    y, u, v = planes(cfg, 2, 7)
    out = vp.process((y, u, v))
    # the kernel route is K6 alone; the torch route never calls it
    assert len(called) == (route == "k6_plain")
    assert out.dtype == torch.int32 and rgba8.bad(out) == 0
    for f in range(2):
        want = ref.frame(cfg, (y[f], u[f], v[f]), None)
        gap, off = gaps(rgba8.codes(out[f]), want)
        assert gap <= MAX_GAP and off <= MAX_OFF, (f, gap, off)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_control_fails_a_tolerance(geometry):
    """The reference in float32 with TF32 products, in the port's place,
    is off by more than the tolerances allow."""
    cfg = config(*GEOMETRIES[geometry])
    y, u, v = planes(cfg, 2, 8)
    for f in range(2):
        want = ref.frame(cfg, (y[f], u[f], v[f]), None)
        control = ref.frame(cfg, (y[f], u[f], v[f]), None, CONTROL)
        gap, off = gaps(control, want)
        assert gap > MAX_GAP or off > MAX_OFF, (f, gap, off)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_reference_equals_the_ports_oracle(seed):
    """Code for code against ``oracle_jinc2`` at 192 x 108 -> 512 x 288
    (8/3): the two run the same float64 chain, the reference summing its 16
    taps in one product where the oracle adds them in turn, so a value on a
    dither threshold may round either way: at most 1 code, on under 1e-5
    of the channels (4 of 442,368)."""
    cfg = config(192, 108, 512, 288)
    y, u, v = planes(cfg, 1, seed)
    mine = ref.frame(cfg, (y[0], u[0], v[0]), None)
    theirs = torch.round(oracle_jinc2(y[0], u[0], v[0], 512, 288) * 255)
    gap, off = gaps(mine, theirs.to(torch.int64))
    assert gap <= 1 and off < 1e-5, (gap, off)


@pytest.mark.parametrize("geometry", [(30, 48, 60, 96), (30, 48, 80, 128),
                                      (27, 48, 96, 54)])
def test_resample_equals_the_jax_packages_gather(geometry):
    """``sdr_jinc2.jinc2`` on float RGB against the JAX package's direct
    gather ``ops.scale._jinc2_gather`` in float32: within float32 rounding
    of values in [0, 1] (the gather's sinf and its sums)."""
    h, w, oh, ow = geometry
    x = np.random.default_rng(12).random((3, h, w)).astype(np.float32)
    mine = ref.jinc2(torch.from_numpy(x).double(), oh, ow).numpy()
    theirs = np.asarray(jax_scale._jinc2_gather(jnp.asarray(x), oh, ow))
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=2e-6)


def test_weight_is_the_shaders():
    d2 = torch.tensor([0.0, 0.25, 1.0, 2.0, 4.5], dtype=torch.float64)
    wa, wb = 0.416 * np.pi, 0.985 * np.pi
    d = np.sqrt(d2.numpy())
    want = np.where(d == 0, wa * wb, np.sin(d * wa) * np.sin(d * wb)
                    / np.where(d == 0, 1.0, d * d))
    assert np.allclose(ref.weight(d2).numpy(), want, rtol=1e-15, atol=0)


def test_reference_refuses_what_it_does_not_run():
    cfg = config(*GEOMETRIES["2x"])
    bad = []
    for group, key, value in (("settings", "upscaling", "LANCZOS3"),
                              ("settings", "interpolate_at_50pct", False),
                              ("video_source", "format", "P010"),
                              ("video_source", "matrix", "BT_2020_NC"),
                              ("video_source", "levels", "PC"),
                              ("output", "video_rect", [0, 0, 64, 36]),
                              ("output", "bits", 10)):
        c = copy.deepcopy(cfg if key != "interpolate_at_50pct"
                          else config(*GEOMETRIES["2to1"]))
        c[group][key] = value
        bad.append(c)
    bad += [config(129, 72, 64, 36),      # past 2:1: the convolution filter
            config(64, 36, 64, 72),       # the width kept at its size
            config(64, 72, 128, 30)]      # the height past 2:1
    for c in bad:
        with pytest.raises(ValueError):
            ref.params(c)
    assert ref.params(cfg) == {"out_w": 128, "out_h": 72, "bits": 8}


def test_costs_at_full_size():
    """K6 at the cell's shapes: the raw NV12 planes and the RGBA8 surface
    of 16 frames, 580,608,000 bytes (0.173 ms at 3.35 TB/s); 13.70 GFLOP,
    of which 12.74 G are the Jinc2's taps, bound at 0.20 ms by its
    FLOPs; the call is K6."""
    st = jinc2_k6.stages(cell().config, cell().batch)
    nbytes, flops = st["K6"]
    assert nbytes == 16 * (1920 * 1080 + 2 * 960 * 540 + 3840 * 2160 * 4) \
        == 580_608_000
    assert round(1e3 * nbytes / roofline.PEAK_BYTES_S, 3) == 0.173
    jinc2 = 96 * 16 * 3840 * 2160
    assert round(jinc2 / 1e9, 2) == 12.74
    # the chroma's W taps (one a even output, two an odd one, the last
    # output's two on one texel) and H taps (two an output, the edge rows'
    # two on one), two planes, two FLOPs a tap; the matrix 18 a pixel
    chroma = 2 * 16 * 2 * (540 * (960 + 2 * 959 + 1) + 1920 * (2 * 1080 - 2))
    assert flops == jinc2 + chroma + 18 * 16 * 1920 * 1080
    assert round(flops / 1e9, 2) == 13.70
    assert round(1e3 * roofline.least_seconds(nbytes, flops), 2) == 0.20
    assert flops / roofline.PEAK_FP32_FLOPS_S > nbytes / roofline.PEAK_BYTES_S
    assert st["call"] == st["K6"]


def plan_of(cfg: dict):
    return plan_pipeline(common.settings(cfg), common.source(cfg),
                         common.output(cfg))


def test_plan_is_c3s():
    plan = plan_of(cell().config)
    assert plan_differences(bench_common.build_plan("c3"), plan) == []
    assert tpipe.route_of(plan) == "staged"
    assert tpipe.kernels_allowed(plan)
    assert plan.dither_bits == 8


def test_frames_are_nv12_codes():
    cfg = config(*GEOMETRIES["8_3"])
    y, u, v = planes(cfg, 3, 2 ** 31 + 5)
    assert [p.dtype for p in (y, u, v)] == [torch.uint8] * 3
    assert y.shape == (3, 30, 48) and u.shape == v.shape == (3, 15, 24)
    lo, hi = cell().traffic["y_codes"]
    assert int(y.min()) >= lo and int(y.max()) <= hi
    lo, hi = cell().traffic["c_codes"]
    for p in (u, v):
        assert int(p.min()) >= lo and int(p.max()) <= hi
    # drawn over the whole range, and the same seed draws the same codes
    big = planes(config(256, 128, 512, 256), 1, 3)
    assert int(big[0].min()) == 16 and int(big[0].max()) == 235
    assert int(big[1].min()) == 16 and int(big[1].max()) == 240
    assert all(torch.equal(a, b) for a, b in
               zip(planes(cfg, 3, 2 ** 31 + 5), (y, u, v)))


def test_rgba8_round_trip_and_bad_words():
    c = torch.randint(0, 256, (3, 5, 7), generator=torch.Generator()
                      .manual_seed(1))
    c[:, 0, 0] = 255
    words = rgba8.pack(c)
    assert words.dtype == torch.int32 and torch.equal(rgba8.codes(words), c)
    assert rgba8.bad(words) == 0
    # the port's pack: R in bits 0-7, G 8-15, B 16-23, alpha 255
    rgb = c.to(torch.float32) / 255.0
    assert torch.equal(rk.pack_surface(rgb, "rgba8"), words)
    assert int(words[0, 0]) == -1            # 0xFFFFFFFF
    broken = words.clone()
    broken[1, 2] &= 0x00FFFFFF
    broken[3, 4] = 0
    assert rgba8.bad(broken) == 2


def test_traffic_has_no_scenes():
    c = cell()
    assert "scenes" not in c.traffic
    assert gen.scene_of(c.traffic, 5) is None and gen.scene(c.traffic, None) \
        is None
    assert faults.faults_of(CELL) == list(faults.FAULTS)
    assert (c.batch, c.traffic["depth"], c.traffic["pool"]) == (16, 8, 8)
    # the pool on the card: 8 batches of 16 NV12 frames, 398 MB
    assert 8 * 16 * (1920 * 1080 * 3 // 2) == 398_131_200


@pytest.fixture
def one_thread():
    """One torch thread, as the benchmark's own tests run the harness on
    the CPU: the test processes run side by side, and the window has to
    reach its seeded calls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["k6_plain", "torch"])
def test_small_run_of_the_cell_is_correct(monkeypatch, one_thread, route):
    """The harness's run of the cell at the CPU's size (the vrbench tests'
    shrink, 128 x 72 -> 64 x 36), on either route: ``correct``, with every
    checked call compared."""
    from vrbench.tests import small
    small.patch_small(monkeypatch)
    if route == "k6_plain":
        monkeypatch.setattr(tpipe, "_on_card", lambda p: True)
    lines = []
    info = SimpleNamespace(write=lines.append, flush=lambda: None)
    r = run.run_cell(CELL, 2 ** 31 + 11, 1.5, False, "cpu", loop.HostClock(),
                     start=0.0, info=info)
    assert r["correct"], r["checks"]
    checked = json.loads(next(ln for ln in lines if '"check"' in ln))
    assert checked["frames"] == 2 * 3
    assert r["checks"]["surface_bad"]["value"] == 0


def test_control_fails_the_cells_limits(monkeypatch, one_thread):
    from vrbench.tests import small
    small.patch_small(monkeypatch)
    c = spec.load_cell(CELL)
    for seed in (3, 2 ** 31 + 4):
        pool = gen.make_pool(c.traffic, c.config, seed, "cpu")
        outs = control_outputs(c, pool, gen.checked_calls(c.traffic, seed))
        verdict = check.compare(outs, pool, c.config, c.traffic, c.limits)
        assert not verdict["correct"], verdict
        assert verdict["numbers"]["off_share_worst"]["value"] > \
            c.limits["off_share_worst"]


def test_cell_reports_the_new_metrics_and_the_end_to_end_ones():
    c = cell()
    assert c.chips == 1
    assert {m["name"] for m in c.per_layer} == {
        "k6_roofline_pct", "jinc2_call_roofline_pct",
        "jinc2_host_ms_per_call"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s",
                                                  "call_ms_p95", "setup_s"}
    bench = spec.load_json(spec.BENCHMARK)
    entry = next(x for x in bench["configs"]
                 if x["name"] == "sdr1080_nv12_to_uhd_jinc2")
    assert entry["source"] == c.config["source"] and entry["reduced"] == []
    assert len(entry["source"]) == 197


def test_roofline_readers():
    assert jinc2_call_roofline_pct.read is call_roofline_pct.read
    assert jinc2_host_ms_per_call.read is entry_host_ms_per_call.read
    costs = jinc2_k6.stages(cell().config, 16)
    # two calls: K6 3 ms each, a stray table launch beside them
    trace_ = Trace(window_s=1.0, calls=2,
                   device_ops=[("jinc2_convert_kernel", 0.0, 0.003),
                               ("jinc2_convert_kernel", 0.003, 0.006),
                               ("jinc2_weight_table_kernel", 0.006, 0.0065)])
    ctx = SimpleNamespace(trace=trace_, costs=costs)
    least = roofline.least_seconds(*costs["K6"])
    assert k6_roofline_pct.read(ctx) == pytest.approx(100 * 2 * least / 0.006)
    assert jinc2_call_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * least / 0.0065)
    assert k6_roofline_pct.read(SimpleNamespace(trace=None, costs=costs)) \
        is None
    other = Trace(window_s=1.0, calls=2,
                  device_ops=[("rows3_tail_kernel", 0.0, 0.001)])
    assert k6_roofline_pct.read(SimpleNamespace(trace=other, costs=costs)) \
        is None


T0 = 1_700_000_000_000_000_000


def test_host_ms_per_call_reads_the_root_calls(monkeypatch):
    spans = [("vrt.call", 1, None, T0 + 310_000, T0 + 510_000),
             ("vrt.kernel.jinc2_convert_fused", 1, 0, T0 + 320_000,
              T0 + 500_000),
             ("vrt.call", 2, None, T0 + 1_310_000, T0 + 1_410_000)]
    trace_ = Trace(window_s=0.002, calls=2,
                   host_spans=[("vrbench.call", 0.000305, 0.000515),
                               ("vrbench.call", 0.001305, 0.001415)])
    ctx = SimpleNamespace(trace=trace_)
    monkeypatch.setattr(program, "recorded", lambda: spans)
    # 0.2 and 0.1 ms
    assert jinc2_host_ms_per_call.read(ctx) == pytest.approx(0.15)
    monkeypatch.setattr(program, "recorded", lambda: None)
    assert jinc2_host_ms_per_call.read(ctx) is None
    monkeypatch.setattr(program, "recorded", lambda: [])
    assert jinc2_host_ms_per_call.read(ctx) is None
    assert jinc2_host_ms_per_call.read(SimpleNamespace(trace=None)) is None


def test_reference_frames_and_surface_import_neither_jax_nor_the_port():
    root = str(spec.ROOT)
    code = (f"import sys; sys.path.insert(0, {root!r})\n"
            "import vrbench.reference.sdr_jinc2, vrbench.frames.nv12, "
            "vrbench.surfaces.rgba8, vrbench.costs.jinc2_k6\n"
            "import json; print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "videorenderer_tpu",
                        "videorenderer_tpu_torch"}


def test_reset_launches_zeroes_k6s_routes():
    assert rk.route_launches["jinc2_convert"] is rk.k6_route_launches
    rk.k6_route_launches["table"] = 3
    rk.k6_route_launches["per-output transposed"] = 1
    rk.reset_launches()
    assert set(rk.k6_route_launches.values()) == {0}


def k6_args(h, w, oh, ow):
    """uint8 NV12 planes and K6's arguments for (h, w) -> (oh, ow)."""
    cfg = config(w, h, ow, oh)
    plan = plan_of(cfg)
    maps = tpipe.PlanMaps(plan)
    kw_c = rk.BandedMatrix(maps.ux, pre_scale=maps.norm)
    kh_c = rk.BandedMatrix(maps.uy)
    cmat = np.concatenate([plan.cmat_m, plan.cmat_c[:, None]], 1)
    return planes(cfg, 1, 4), (kh_c, kw_c, cmat, oh, ow, maps.norm, 1.0)


@pytest.fixture
def launches_stubbed(monkeypatch):
    """K6's and the table kernel's wrappers take the kernel branch on the
    CPU with their launches recorded and not made (the outputs stay
    empty): the host side of a launch, its counters and spans."""
    made = []
    monkeypatch.setattr(rk, "_kernel_device", lambda *t: True)
    monkeypatch.setattr(rk, "_launch", lambda name, fn, dev, *a:
                        made.append(name))
    jk.clear_weight_tables()
    rk.reset_launches()
    yield made
    jk.clear_weight_tables()
    rk.reset_launches()


def k6_counts() -> dict:
    return {k: v for k, v in rk.k6_route_launches.items() if v}


def build_spans(fn) -> int:
    """The ``vrt.build.jinc2_table`` spans of ``fn()`` under a profiler."""
    trace.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    n = sum(s.name == "vrt.build.jinc2_table" for s in trace.spans())
    trace.clear_spans()
    return n


def test_k6_counts_its_routes_and_builds_a_table_once(launches_stubbed,
                                                       monkeypatch):
    (y, u, v), rest = k6_args(36, 64, 72, 128)
    call = lambda **kw: jk.jinc2_convert_fused(y, u, v, *rest,  # noqa: E731
                                               pack_format="rgba8", **kw)
    assert build_spans(call) == 1
    assert launches_stubbed == ["jinc2_weight_table", "jinc2_convert_fused"]
    assert k6_counts() == {"table": 1}
    assert build_spans(call) == 0
    assert build_spans(lambda: call(out_transpose=True)) == 0
    assert k6_counts() == {"table": 2, "table transposed": 1}
    # a band of rows 16-39 from source rows 4-23, its chroma rows 2-11
    # upsampled by a 10 -> 20 row map
    rows = jk.Jinc2Rows(full_h=36, full_out_h=72, out_row0=16, src_row0=4)
    band_y = rk.BandedMatrix(tpipe.PlanMaps(plan_of(config(64, 20, 128,
                                                           40))).uy)
    jk.jinc2_convert_fused(y[..., 4:24, :], u[..., 2:12, :], v[..., 2:12, :],
                           band_y, *rest[1:3], 24, 128, *rest[5:],
                           pack_format="rgba8", rows=rows)
    assert k6_counts() == {"table": 2, "table transposed": 1,
                           "table band": 1}
    monkeypatch.setattr(jk, "TABLE_CAP", 0)
    assert build_spans(call) == 0
    assert k6_counts()["per-output"] == 1
    assert launches_stubbed.count("jinc2_weight_table") == 1
    rk.reset_launches()
    assert k6_counts() == {}
