"""K10 (the W-pass probe) and the stage split of ``torch_headline_micro.py``
against ``bench_headline_micro.py``, at small sizes on the CPU.

 * K10's plain versions against the two Pallas bodies of
   ``bench_headline_micro._probe_wpass`` in interpret mode, captured by
   replacing the script's ``timeit`` with one call that keeps the result:
   ``wpass_floor`` bit-equal to ``ksplit``'s first W_out columns (the same
   bf16 rounding of exact codes); ``wpass_bf16`` within 1e-6 of ``k1``
   (outputs ~[-0.3, 1.3]; bf16 x bf16 products are exact in float32, only
   the order of the sum differs); the probe's ``yW`` within 1 mid16 code of
   the port's K1 (the JAX split-bf16 products, as in
   tests/test_torch_kernels.py).
 * The tap-table arithmetic of ``csrc/probe_wpass.cu``, replayed in torch,
   against the plain version: within 1e-6 (the order of the sum).
 * ``torch_headline_micro.stages`` against the script's stages
   (``:197-229``) run through the JAX kernels in interpret mode, on the
   same frames: the W passes within 2e-5 (K1's float band); ``tail`` and
   ``tailID`` (the script's ``epi_id``, written out as ``:217-220``) within
   1 code on < 2% of the channels, and ``tailNoPack`` (dithered float)
   within 1 code of 1/1023 on < 2% (K2's band), each JAX tail reading the
   port's W-pass outputs; ``full`` within 1 code on >= 99.9% of the
   channels and < 2% differing (the slice band of tests/test_torch_slice.py).
 * ``tail`` on the ``yW``/``cW`` outputs bit-equal to the FLOAT16
   ``make_frame_fn`` of the same plan: the same functions on the same
   float32 planes.
"""

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
from videorenderer_tpu.ops import chroma as jchroma, scale as jscale

import chip_smoke as cs
import torch_headline_micro as thm
import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.kernels import probe as pk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import scale as tscale

N16 = 1.0 / 65535.0
W, H, OW, OH = 256, 128, 128, 64          # the headline's shape, shrunk
BATCH = 2
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix): a new matrix of
    the same shape that reuses a freed one's id would hit a stale entry.
    Each test gets its own cache and leaves no entry behind."""
    monkeypatch.setattr(jrp, "_band_cache", {})


@pytest.fixture(scope="module")
def bhm():
    """bench_headline_micro, imported with JAX's compilation cache settings
    restored at once: the script points the cache at a directory outside
    the checkout when imported."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        import bench_headline_micro
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return bench_headline_micro


@pytest.fixture(scope="module")
def small():
    """chip_smoke's frame size shrunk to W x H -> OW x OH (c7 runs 1:1 at
    W x H), for ``torch_headline_micro.plan_for`` and ``p010_batch``."""
    with pytest.MonkeyPatch.context() as mp:
        for name, val in (("W", W), ("H", H), ("OW", OW), ("OH", OH)):
            mp.setattr(cs, name, val)
        yield


def _lanczos(n_in, n_out):
    return np.asarray(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3, n_in,
                                            n_out), np.float32)


def _chroma_w(n_c, n_out):
    ux, _ = tchroma.chroma_upsample_matrices(
        n_c, 8, 420, tcfg.ChromaScaling.BILINEAR, tcsp.ChromaLocation.MPEG2)
    return np.asarray(ux @ _lanczos(2 * n_c, n_out), np.float32)


# W_in -> W_out maps the probe can take (ksplit needs W_out <= W_in): the
# headline's 2:1 luma map, a composed chroma map, and an unaligned 600 ->
# 250 (the Pallas side pads to 640 columns and 256 outputs)
MATS = {"luma_2to1": lambda: _lanczos(512, 256),
        "chroma_up_down": lambda: _chroma_w(256, 256),
        "unaligned": lambda: _lanczos(600, 250)}


def _u16(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(64, 941, shape, dtype=np.uint16) << 6


@pytest.fixture(scope="module", params=list(MATS))
def probe_case(request, bhm):
    """(codes (2, 8, W_in), matrix, the probe's yW, yW1, yWsplit) with the
    Pallas outputs cut to (rows, W_out)."""
    mat = MATS[request.param]()
    x = _u16((2, 8, mat.shape[0]), seed=7)
    kept = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "_band_cache", {})
        mp.setattr(bhm, "timeit", lambda fn, args, iters=8, warmup=2:
                   kept.append(np.asarray(fn(*args))) or 1.0)
        with pltpu.force_tpu_interpret_mode():
            bhm._probe_wpass(jnp.asarray(x), mat, N16, 1)
    rows, w_out = 16, mat.shape[1]
    y_w, y_w1, y_split = kept
    return (x, mat, y_w, y_w1[:rows, :w_out].reshape(2, 8, w_out),
            y_split[:rows, :w_out].reshape(2, 8, w_out))


def test_wpass_floor_plain_bit_equal_to_ksplit(probe_case):
    x, mat, _, _, ref = probe_case
    got = pk.wpass_floor_plain(torch.from_numpy(x), mat.shape[1])
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)


def test_wpass_bf16_plain_matches_k1_body(probe_case):
    x, mat, _, ref, _ = probe_case
    got = pk.wpass_bf16_plain(torch.from_numpy(x),
                              trk.BandedMatrix(mat, pre_scale=N16))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-6


def test_probe_yw_matches_port_k1_mid16(probe_case):
    x, mat, ref, _, _ = probe_case
    got = trk.banded_resize_last_axis(torch.from_numpy(x),
                                      trk.BandedMatrix(mat, pre_scale=N16),
                                      mid16=True)
    assert got.dtype == torch.int16 and ref.dtype == np.int16
    assert np.abs(got.numpy().astype(np.int32) - ref).max() <= 1


@pytest.mark.parametrize("which", list(MATS))
def test_wpass_bf16_tap_table_replay(which):
    """What vrt_wpass_bf16 computes for each output, in torch: the sum over
    t of bf16(x[starts[j] + t]) * bf16(taps[t, j]), taps past the input
    edge skipped."""
    bm = trk.BandedMatrix(MATS[which](), pre_scale=N16)
    x = torch.from_numpy(_u16((3, bm.in_size), seed=8))
    xb = pk._bf16(x)
    taps = torch.from_numpy(bm.taps).to(torch.bfloat16).float()
    starts = torch.from_numpy(bm.starts).long()
    acc = torch.zeros((3, bm.out_size), dtype=torch.float32)
    for t in range(bm.n_taps):
        idx = starts + t
        ok = idx < bm.in_size
        acc += torch.where(ok, xb[:, idx.clamp(max=bm.in_size - 1)] * taps[t],
                           torch.zeros(()))
    assert torch.allclose(acc, pk.wpass_bf16_plain(x, bm), atol=1e-6, rtol=0)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    bm = trk.BandedMatrix(_lanczos(512, 256), pre_scale=N16)
    x = torch.from_numpy(_u16((2, 4, 512), seed=9))
    trk.reset_launches()
    assert torch.equal(pk.wpass_bf16(x, bm), pk.wpass_bf16_plain(x, bm))
    assert torch.equal(pk.wpass_floor(x, 300), pk.wpass_floor_plain(x, 300))
    assert pk.wpass_floor(x, 300).shape == (2, 4, 300)
    assert trk.launches["wpass_bf16"] == trk.launches["wpass_floor"] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    bm = trk.BandedMatrix(_lanczos(64, 32))
    x = torch.zeros((2, 64), dtype=torch.uint16)
    with pytest.raises(TypeError, match="uint16"):
        pk.wpass_bf16(x.to(torch.float32), bm)
    with pytest.raises(TypeError, match="uint16"):
        pk.wpass_floor(x.to(torch.int16), 32)
    with pytest.raises(ValueError, match="columns"):
        pk.wpass_bf16(torch.zeros((2, 60), dtype=torch.uint16), bm)
    for w_out in (0, 65):
        with pytest.raises(ValueError, match="w_out"):
            pk.wpass_floor(x, w_out)
    with pytest.raises(ValueError, match="no kernel"):
        pk.wpass_floor(torch.zeros((2, 64), dtype=torch.uint16,
                                   device="meta"), 32)


def test_wpass_probe_forms_on_cpu(small):
    plan = thm.plan_for("headline")
    wx, _, _, _, norm = tpipe.fused_maps(plan)
    bm = trk.BandedMatrix(wx, pre_scale=norm)
    y = cs.p010_batch(BATCH, 0, "cpu")[0]
    forms = thm.wpass_probe(y, bm)
    assert list(forms) == ["yW", "yW1", "yWsplit", "memcpy"]
    assert torch.equal(forms["yW"](),
                       trk.banded_resize_last_axis(y, bm, mid16=True))
    assert torch.equal(forms["yW1"](), pk.wpass_bf16_plain(y, bm))
    assert torch.equal(forms["yWsplit"](), pk.wpass_floor_plain(y, OW))
    assert torch.equal(forms["memcpy"](), y)


# --- the stage split ----------------------------------------------------------


def _jax_stages(planes, tw):
    """bench_headline_micro.py:154-234 at W x H -> OW x OH, the Pallas
    kernels in interpret mode (the caller patches the backend to "tpu" for
    ``full``): the W passes on the raw planes, and the tails on ``tw``, the
    port's W-pass outputs."""
    st = jcfg.Settings(upscaling=jcfg.Upscaling.LANCZOS3,
                       chroma_scaling=jcfg.ChromaScaling.BILINEAR,
                       convert_to_sdr=True, use_dither=True)
    src = jpipe.SourceDescriptor(
        format=JFmt.P010, width=W, height=H, matrix=jcsp.CSP.BT_2020_NC,
        levels=jcsp.Levels.TV, primaries=jcsp.Primaries.BT_2020,
        transfer=jcsp.TRC.PQ, hdr10=jpipe.HDR10Metadata())
    plan = jpipe.plan_pipeline(st, src,
                               jpipe.OutputDescriptor(width=OW, height=OH,
                                                      bits=10))
    cx = jscale.select_scaler(W, OW, st.upscaling, st.downscaling,
                              st.interpolate_at_50pct)
    cy = jscale.select_scaler(H, OH, st.upscaling, st.downscaling,
                              st.interpolate_at_50pct)
    wx = np.asarray(jscale.build_axis_matrix(cx, W, OW), np.float32)
    wy = np.asarray(jscale.build_axis_matrix(cy, H, OH), np.float32)
    ux, uy = jchroma.chroma_upsample_matrices(
        W // 2, H // 2, 420, st.chroma_scaling, src.chroma_location)
    cwx = np.asarray(jpipe._compose(ux, wx), np.float32)
    cwy = np.asarray(jpipe._compose(uy, wy), np.float32)
    y, u, v = (jnp.asarray(p) for p in planes)
    a, b, c = (jnp.asarray(p) for p in tw)
    epi = jpipe._make_tail_epilogue(plan)
    m = np.asarray(plan.cmat_m, np.float32)
    cc = np.asarray(plan.cmat_c, np.float32)

    def epi_id(yy, uu, vv):
        rgb = jnp.stack([m[i, 0] * yy + m[i, 1] * uu + m[i, 2] * vv + cc[i]
                         for i in range(3)], axis=0)
        return jnp.clip(rgb, 0.0, 1.0)

    fused = jpipe._make_fused_fn(plan, pack_format="rgb10a2")
    with pltpu.force_tpu_interpret_mode():
        out = {"yW": jrp.banded_resize_last_axis(y, wx, pre_scale=N16),
               "cW": (jrp.banded_resize_last_axis(u, cwx, pre_scale=N16),
                      jrp.banded_resize_last_axis(v, cwx, pre_scale=N16)),
               "tail": jrp.rows3_tail(a, b, c, wy, cwy, OH, epi,
                                      pack_format="rgb10a2"),
               "tailID": jrp.rows3_tail(a, b, c, wy, cwy, OH, epi_id,
                                        pack_format="rgb10a2"),
               "tailNoPack": jrp.rows3_tail(a, b, c, wy, cwy, OH, epi,
                                            pack_format=None),
               "full": fused((y, u, v))}
    return {k: (tuple(np.asarray(t) for t in o) if isinstance(o, tuple)
                else np.asarray(o)) for k, o in out.items()}


@pytest.fixture(scope="module")
def headline_stages(small):
    """The port's stage outputs on the headline plan and the JAX script's
    stages on the same frames."""
    planes = cs.p010_batch(BATCH, 0, "cpu")
    st = thm.stages(thm.plan_for("headline"), planes)
    ours = {k: f() for k, f in st.items()}
    tw = (ours["yW"], *ours["cW"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "_band_cache", {})
        mp.setattr(jax, "default_backend", lambda: "tpu")
        ref = _jax_stages([p.numpy() for p in planes],
                          [t.numpy() for t in tw])
    return ours, ref


def _codes10(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)]).astype(np.int32)


@pytest.mark.parametrize("stage", ["yW", "cW"])
def test_w_stages_match_jax_script(headline_stages, stage):
    ours, ref = headline_stages
    got, want = ((ours[stage],), (ref[stage],)) if stage == "yW" \
        else (ours[stage], ref[stage])
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 2e-5


@pytest.mark.parametrize("stage", ["tail", "tailID"])
def test_packed_tail_stages_match_jax_script(headline_stages, stage):
    ours, ref = headline_stages
    got, want = ours[stage].numpy(), ref[stage]
    assert got.dtype == np.int32 and got.shape == want.shape == (BATCH, OH, OW)
    assert np.array_equal(got.view(np.uint32) >> 30,
                          want.view(np.uint32) >> 30)
    d = np.abs(_codes10(got) - _codes10(want))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_unpacked_tail_stage_matches_jax_script(headline_stages):
    ours, ref = headline_stages
    got, want = ours["tailNoPack"].numpy(), ref["tailNoPack"]
    assert got.shape == want.shape == (BATCH, 3, OH, OW)
    d = np.round(np.abs(got - want) * 1023.0)
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_full_stage_matches_jax_script(headline_stages):
    ours, ref = headline_stages
    d = np.abs(_codes10(ours["full"].numpy()) - _codes10(ref["full"]))
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("name", thm.PLANS)
def test_tail_on_w_stages_equals_float16_frame_fn(small, name):
    """The stages run the fused route's own kernels: K2 on the float32 W
    outputs is the FLOAT16 route, bit for bit."""
    planes = cs.p010_batch(BATCH, 3, "cpu")
    st = thm.stages(thm.plan_for(name), planes)
    f16 = tpipe.make_frame_fn(thm.plan_for(name, tcfg.TexFormat.FLOAT16),
                              pack_surface=True)
    assert torch.equal(st["tail"](), f16(planes))


def test_stage_names_follow_the_plan(small):
    planes = cs.p010_batch(1, 4, "cpu")
    assert list(thm.stages(thm.plan_for("headline"), planes)) == [
        "yW", "cW", "tail", "tailID", "tailH", "tailNoPack", "full"]
    # c7's luma has no W map: K2 reads the raw plane directly
    assert list(thm.stages(thm.plan_for("c7"), planes)) == [
        "cW", "tail", "tailID", "tailH", "tailNoPack", "full"]


def test_stages_refuse_other_routes(small):
    placed = tpipe.plan_pipeline(
        cs.headline_settings(True), cs.headline_args()[0],
        tpipe.OutputDescriptor(width=OW, height=OH, bits=10,
                               video_rect=(0, 8, OW, OH - 8)))
    plain = tpipe.plan_pipeline(cs.headline_settings(False),
                                *cs.headline_args())
    planes = cs.p010_batch(1, 4, "cpu")
    for p in (placed, plain):
        with pytest.raises(ValueError, match="fused K1 \\+ K2"):
            thm.stages(p, planes)


def test_attribution_and_stage_lines():
    ms = {"yW": 2.0, "cW": 4.0, "tail": 10.0, "tailID": 3.0,
          "tailNoPack": 8.0, "full": 15.0}
    att = thm.attribution(ms, 2)
    assert att == {"summary": "attribution", "stages_sum_ms": 8.0,
                   "full_ms": 7.5, "tower_ms": 3.5, "pack_ms": 1.0}
    assert thm.attribution({k: v for k, v in ms.items() if k != "yW"},
                           2)["stages_sum_ms"] == 7.0
    lines = thm.stage_lines({"yW1": 4.0, "memcpy": 2.0}, 16, plan="headline")
    assert lines[0] == {"stage": "yW1", "ms_per_frame": 0.25, "fps": 4000.0,
                        "batch": 16, "plan": "headline"}
    assert "yardstick" in lines[1]["note"]


def test_script_refuses_without_a_card_and_bad_options(small):
    with pytest.raises(SystemExit):
        thm.main(["--plan", "c7", "--probe-wpass"])
    with pytest.raises(SystemExit):
        thm.main(["--plan", "c9"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the absent-device path is not reachable")
    for argv in ([], ["--probe-wpass"], ["--plan", "c7"]):
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            thm.main(argv)
