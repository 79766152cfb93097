"""videorenderer_tpu_torch.models (SuperRes, VideoHDR, checkpoints, the
evaluation data) and the renderer's model hooks against the JAX package on
the CPU.

Both packages get the same parameters: the shipped checkpoints, or random
ones drawn with numpy from a seed and written to one ``.npz`` that each
package's ``load_params`` reads (a nonzero tail, so the residual is
exercised).  Bands (the JAX package's own ``enhance_plane_chw`` folds the
base into the tail conv and rounds once where ``apply_fn`` and the port
round twice):
 * SuperRes: >= 50 dB, max |d| <= 2^-6 (measured against
   ``enhance_plane_chw`` 55.3-58.0 dB, max 2^-8 (2^-7 on one case); against
   ``apply_fn``, whose roundings the port follows, bit-equal in every case
   here);
 * VideoHDR: >= 80 dB, max |d| <= 1e-3 (measured 103-116 dB, max 3.7e-4
   on the shipped weights, 8.2e-6 on the random ones);
 * a zero tail gives exactly the base in both packages;
 * the renderer: model paths >= 50 dB with outputs <= 3 8-bit codes apart;
   the other paths the band of tests/test_torch_api.py (1 code on >= 99.9%
   of the channels, at most 3).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import videorenderer_tpu as J
import videorenderer_tpu.api as japi
from videorenderer_tpu.models import checkpoint as jck
from videorenderer_tpu.models import hdr_train as jhdr
from videorenderer_tpu.models import sr_train as jsr
from videorenderer_tpu.models import superres as jsres
from videorenderer_tpu.models import videohdr as jvh

import videorenderer_tpu_torch as T
import videorenderer_tpu_torch.api as tapi
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.models import checkpoint as tck
from videorenderer_tpu_torch.models import hdr_train as thdr
from videorenderer_tpu_torch.models import sr_train as tsr
from videorenderer_tpu_torch.models import superres as tsres
from videorenderer_tpu_torch.models import videohdr as tvh

SR_DB, SR_MAX = 50.0, 2.0 ** -6
VH_DB, VH_MAX = 80.0, 1e-3


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _band(a, b, db, max_abs):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a.astype(np.float64) - b).max()
    assert _psnr(a, b) >= db and d <= max_abs, (_psnr(a, b), d)


def _smooth(shape, seed):
    """Frames in [0, 1] with natural-ish local correlation."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (-1, -2):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, x)
    return np.clip(x * 1.1, 0.0, 1.0).astype(np.float32)


def _cfgs(kind, **kw):
    """(JAX config, port config) of one shape."""
    if kind == "sr":
        return jsres.SuperResConfig(**kw), tsres.SuperResConfig(**kw)
    return jvh.VideoHDRConfig(**kw), tvh.VideoHDRConfig(**kw)


def _models(kind, tmp_path, seed=None, **kw):
    """(JAX params, JAX cfg, port model, port cfg): the shipped checkpoint
    when ``seed`` is None, else random parameters from ``seed`` (a nonzero
    tail), through one .npz both packages load."""
    jcfg, tcfg = _cfgs(kind, **kw)
    jmod = jsres if kind == "sr" else jvh
    like = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    if seed is None:
        path = f"weights/{'superres_2x' if kind == 'sr' else 'videohdr'}.npz"
    else:
        rng = np.random.default_rng(seed)
        flat = {}
        for key, a in jck._flatten(like).items():
            if key.endswith("/b"):
                flat[key] = rng.normal(0, 0.05, a.shape).astype(np.float32)
            else:
                std = np.sqrt(2.0 / (9 * a.shape[2]))
                if key.startswith(("tail", "c3")):
                    std *= 0.1
                flat[key] = (rng.normal(0, 1, a.shape) * std).astype(
                    np.float32)
        path = str(tmp_path / f"{kind}.npz")
        np.savez(path, **flat)
    jp = jck.load_params(path, like)
    model = (tsres.SuperRes if kind == "sr" else tvh.VideoHDR)(tcfg)
    return jp, jcfg, tck.load_params(path, model), tcfg


SR_CASES = {
    "shipped": (None, {}, (2, 3, 64, 96)),
    "c8_b1_s2": (1, dict(channels=8, num_blocks=1, s2d=2), (2, 3, 18, 30)),
    "c16_b2_s4_odd": (2, dict(channels=16, num_blocks=2), (1, 3, 21, 37)),
    "s2d1": (3, dict(channels=8, num_blocks=1, s2d=1), (1, 3, 9, 11)),
    "scale3_odd": (4, dict(channels=8, num_blocks=1, s2d=2, scale=3),
                   (1, 3, 11, 13)),
}


@pytest.mark.parametrize("case", list(SR_CASES))
def test_superres_against_jax(tmp_path, case):
    seed, kw, shape = SR_CASES[case]
    jp, jcfg, model, tcfg = _models("sr", tmp_path, seed, **kw)
    x = _smooth(shape, seed=7)
    want = np.asarray(jsres.enhance_plane_chw(jp, jnp.asarray(x), jcfg))
    got = tsres.enhance_plane_chw(model, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _band(got, want, SR_DB, SR_MAX)
    # leading dims: one frame without a batch axis
    one = tsres.enhance_plane_chw(model, torch.from_numpy(x[0]))
    assert torch.equal(one, got[0])
    nhwc = np.moveaxis(x, 1, -1)
    _band(tsres.apply_fn(model, torch.from_numpy(nhwc.copy())),
          jsres.apply_fn(jp, jnp.asarray(nhwc), jcfg), SR_DB, SR_MAX)


VH_CASES = {
    "shipped": (None, {}, (2, 3, 64, 96)),
    "c8_odd": (5, dict(channels=8), (1, 3, 22, 35)),
    "c8_s2d2": (6, dict(channels=8, s2d=2, peak_nits=600.0), (2, 3, 12, 20)),
}


@pytest.mark.parametrize("case", list(VH_CASES))
def test_videohdr_against_jax(tmp_path, case):
    seed, kw, shape = VH_CASES[case]
    jp, jcfg, model, _ = _models("vh", tmp_path, seed, **kw)
    x = _smooth(shape, seed=8)
    want = np.asarray(jvh.enhance_plane_chw(jp, jnp.asarray(x), jcfg))
    got = tvh.enhance_plane_chw(model, torch.from_numpy(x))
    _band(got, want, VH_DB, VH_MAX)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    nhwc = np.moveaxis(x, 1, -1)
    _band(tvh.apply_fn(model, torch.from_numpy(nhwc.copy())),
          jvh.apply_fn(jp, jnp.asarray(nhwc), jcfg), VH_DB, VH_MAX)


def test_zero_tail_is_the_base():
    x = _smooth((2, 3, 14, 22), seed=9)
    g = torch.Generator().manual_seed(3)
    # SuperRes: the nearest-upsampled bf16 input, exactly, in both
    kw = dict(channels=8, num_blocks=1, s2d=2)
    jcfg, tcfg = _cfgs("sr", **kw)
    base = np.repeat(np.repeat(np.asarray(
        torch.from_numpy(x).bfloat16().float()), 2, -2), 2, -1)
    got = tsres.enhance_plane_chw(tsres.init_params(g, tcfg),
                                  torch.from_numpy(x))
    assert np.array_equal(got.numpy(), base)
    jout = jsres.enhance_plane_chw(
        jsres.init_params(jax.random.PRNGKey(1), jcfg), jnp.asarray(x), jcfg)
    assert np.array_equal(np.asarray(jout), base)
    # VideoHDR: the deterministic inverse tone map, exactly
    jcfg, tcfg = _cfgs("vh", channels=8)
    tx = torch.from_numpy(x)
    got = tvh.enhance_plane_chw(tvh.init_params(g, tcfg), tx)
    tbase = tvh.inverse_tonemap_base(tx, tcfg)
    assert torch.equal(got, tbase)
    jx = jnp.asarray(x)
    jout = jvh.enhance_plane_chw(jvh.init_params(jax.random.PRNGKey(1), jcfg),
                                 jx, jcfg)
    jbase = jvh.inverse_tonemap_base(jx, jcfg, axis=-3)
    assert np.array_equal(np.asarray(jout), np.asarray(jbase))
    _band(tbase, jbase, 100.0, 1e-5)
    lin = tvh.inverse_tonemap_base_linear(tx, tcfg)
    np.testing.assert_allclose(
        lin.numpy(), np.asarray(jvh.inverse_tonemap_base_linear(jx, jcfg)),
        rtol=1e-5, atol=1e-4)


def test_superres_gate_table():
    S = T.SuperResolution
    for level in S:
        for sw, sh, dw, dh in ((1920, 1080, 3840, 2160), (1920, 1080, 1920,
                                                          1080),
                               (640, 480, 1280, 960), (2560, 1440, 3840,
                                                       2160),
                               (1024, 576, 1024, 600), (3840, 2160, 7680,
                                                        4320)):
            assert tsres.superres_engages(level, sw, sh, dw, dh) == \
                jsres.superres_engages(getattr(J.SuperResolution, level.name),
                                       sw, sh, dw, dh)


def test_init_params_seeded_and_global_rng_untouched():
    cfg = tsres.SuperResConfig(channels=8, num_blocks=2)
    state = torch.get_rng_state()
    a = tsres.init_params(torch.Generator().manual_seed(5), cfg)
    b = tsres.init_params(torch.Generator().manual_seed(5), cfg)
    assert torch.equal(torch.get_rng_state(), state)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb) and va.dtype == torch.bfloat16
    assert not a.tail.weight.any() and not a.tail.bias.any()
    assert not any(p.requires_grad for p in a.parameters())
    std = a.body[0].c1.weight.float().std().item()
    assert abs(std - np.sqrt(2 / (9 * 8))) < 0.05
    v = tvh.init_params(torch.Generator().manual_seed(5), tvh.VideoHDRConfig())
    assert not v.c3.weight.any() and v.c1.weight.any()
    assert tuple(v.c1.weight.shape) == (64, 48, 3, 3)


def test_checkpoint_roundtrip_and_between_packages(tmp_path):
    """tests/test_checkpoint_trace.py's round trip, in the port and across
    the packages (either one's file loads in the other, equal)."""
    tcfg = tsres.SuperResConfig(channels=8, num_blocks=1)
    model = tsres.init_params(torch.Generator().manual_seed(0), tcfg)
    model.tail.weight.normal_(generator=torch.Generator().manual_seed(1))
    p = str(tmp_path / "sr.npz")
    tck.save_params(p, model)
    back = tck.load_params(p, tsres.SuperRes(tcfg))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    jcfg = jsres.SuperResConfig(channels=8, num_blocks=1)
    like = jsres.init_params(jax.random.PRNGKey(0), jcfg)
    jparams = jck.load_params(p, like)
    flat = jck._flatten(jparams)
    assert set(flat) == set(np.load(p).files)
    sd = tck.params_from_jax(flat)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    jp2 = str(tmp_path / "j.npz")
    jck.save_params(jp2, jparams)
    back = tck.load_params(jp2, tsres.SuperRes(tcfg))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    # the conversion pair: HWIO <-> OIHW, float32 in, float32 out
    rt = tck.params_to_jax(tck.params_from_jax(flat, dtype=torch.float32))
    assert all(np.array_equal(rt[k], flat[k]) for k in flat)
    assert sd["head.weight"].shape == (8, 48, 3, 3)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_params_from_jax_channel_order(k):
    """The conversion puts the JAX space-to-depth channel (di, dj, c) of
    the head's input, and the depth-to-space channel (d, e, c) of the
    tail's output, where pixel_unshuffle / pixel_shuffle put them:
    (c, di, dj) and (c, d, e); the body keeps its order."""
    s = 2
    kk = s * k
    cin, cout = 3 * k * k, 3 * kk * kk
    flat = {"head/w": np.zeros((3, 3, cin, 4), np.float32),
            "head/b": np.arange(4, dtype=np.float32),
            "tail/w": np.zeros((3, 3, 4, cout), np.float32),
            "tail/b": np.arange(cout, dtype=np.float32),
            "body/0/c1/w": np.zeros((3, 3, 4, 4), np.float32),
            "body/0/c1/b": np.arange(4, dtype=np.float32)}
    # tag each JAX channel with its own index
    flat["head/w"][1, 1] = np.arange(cin, dtype=np.float32)[:, None]
    flat["tail/w"][1, 1] = np.arange(cout, dtype=np.float32)[None, :]
    sd = tck.params_from_jax(flat, dtype=torch.float32)
    for n, got in ((k, sd["head.weight"][0, :, 1, 1]),
                   (kk, sd["tail.weight"][:, 0, 1, 1]),
                   (kk, sd["tail.bias"])):
        c, di, dj = np.meshgrid(np.arange(3), np.arange(n), np.arange(n),
                                indexing="ij")
        want = ((di * n + dj) * 3 + c).reshape(-1)
        assert np.array_equal(got.numpy(), want)
    assert torch.equal(sd["body.0.c1.bias"], torch.arange(4.0))
    back = tck.params_to_jax(sd)
    assert all(np.array_equal(back[key], flat[key]) for key in flat)
    with pytest.raises(ValueError, match="not a space-to-depth of RGB"):
        tck.params_from_jax({"head/w": np.zeros((3, 3, 5, 4), np.float32)})


def test_checkpoint_mismatch_errors(tmp_path):
    """tests/test_checkpoint_trace.py's shape mismatch, and a key mismatch,
    with the JAX loader's texts."""
    p = str(tmp_path / "sr.npz")
    tck.save_params(p, tsres.SuperRes(tsres.SuperResConfig(channels=8,
                                                           num_blocks=1)))
    for kw, text in ((dict(channels=16, num_blocks=1), "shape mismatch for"),
                     (dict(channels=8, num_blocks=2),
                      "checkpoint mismatch: missing=")):
        with pytest.raises(ValueError, match=text) as te:
            tck.load_params(p, tsres.SuperRes(tsres.SuperResConfig(**kw)))
        with pytest.raises(ValueError, match=text) as je:
            jck.load_params(p, jsres.init_params(
                jax.random.PRNGKey(0), jsres.SuperResConfig(**kw)))
        if "shape" in text:
            assert str(te.value) == str(je.value)


def test_exact_convs_guard():
    b = torch.backends.cudnn
    before = (b.enabled, b.benchmark, b.deterministic, b.allow_tf32)
    b.allow_tf32 = True
    try:
        with tsres.exact_convs():
            assert not b.allow_tf32 and b.enabled == before[0]
        assert b.allow_tf32
    finally:
        b.allow_tf32 = before[3]
    assert (b.enabled, b.benchmark, b.deterministic, b.allow_tf32) == before


def test_model_on_another_device_raises():
    model = tsres.SuperRes(tsres.SuperResConfig(channels=8, num_blocks=1))
    with pytest.raises(RuntimeError, match="move the model first"):
        tsres.enhance_plane_chw(model.to("meta"), torch.zeros(1, 3, 8, 8))
    vh = tvh.VideoHDR(tvh.VideoHDRConfig(channels=8)).to("meta")
    with pytest.raises(RuntimeError, match="move the model first"):
        tvh.enhance_plane_chw(vh, torch.zeros(1, 3, 8, 8))


def test_evaluation_data_equal_to_jax():
    assert np.array_equal(tsr.synth_frames(3, 5, 32),
                          jsr.synth_frames(3, 5, 32))
    assert np.array_equal(tsr.natural_frames(4, 3, 32),
                          jsr.natural_frames(4, 3, 32))
    hr = jsr.synth_frames(5, 3, 32)
    for m in (None, T.Downscaling.BOX, T.Downscaling.LANCZOS):
        jm = None if m is None else getattr(J.Downscaling, m.name)
        assert np.array_equal(tsr.degrade(hr, 2, m), jsr.degrade(hr, 2, jm))
    jcfg, tcfg = _cfgs("vh")
    hdr = thdr.synth_hdr_frames(6, 3, 32, tcfg)
    assert np.array_equal(hdr, jhdr.synth_hdr_frames(6, 3, 32, jcfg))
    # float32 transcendentals of two libraries (measured 3.0e-5, 8.3e-6)
    np.testing.assert_allclose(thdr.degrade_to_sdr(hdr, tcfg),
                               jhdr.degrade_to_sdr(hdr, jcfg), atol=1e-4)
    np.testing.assert_allclose(thdr.hdr_truth_pq(hdr, tcfg),
                               jhdr.hdr_truth_pq(hdr, jcfg), atol=3e-5)


def test_evaluation_psnr_against_jax(tmp_path):
    jp, jcfg, model, tcfg = _models("sr", tmp_path, 11, channels=8,
                                    num_blocks=1)
    hr = jsr.synth_frames(12, 3, 32)
    t, j = tsr.evaluate_psnr(model, hr), jsr.evaluate_psnr(jp, jcfg, hr)
    assert abs(t[0] - j[0]) < 0.05 and abs(t[1] - j[1]) < 1e-4, (t, j)
    jp, jcfg, model, tcfg = _models("vh", tmp_path, 12, channels=8)
    hdr = jhdr.synth_hdr_frames(13, 2, 32, jcfg)
    t = thdr.evaluate_pq_psnr(model, hdr)
    j = jhdr.evaluate_pq_psnr(jp, jcfg, hdr)
    assert abs(t[0] - j[0]) < 0.01 and abs(t[1] - j[1]) < 0.01, (t, j)


# ---------------------------------------------------------------- renderer

def _planes(w=32, h=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


def _e(mod, v):
    return getattr(getattr(mod, type(v).__name__), v.name)


def _pair(settings, dst, models, pack=False, src=None, setup=None):
    """(JAX renderer, port renderer) on the same settings and descriptors
    (the port's enums), each given the models ``models`` (a list of (JAX
    params, JAX cfg, port model, port cfg) with their kind) and opened."""
    out = []
    for mod, pk, kw in ((J, J, {}), (T, T, {"device": "cpu"})):
        st = pk.Settings(**{k: (_e(pk, v) if hasattr(v, "name") else v)
                            for k, v in settings.items()})
        vr = (japi.VideoRenderer if mod is J else tapi.VideoRenderer)(
            st, pack_surface=pack, **kw)
        for kind, (jp, jcfg, tm, tcfg) in models:
            hook = (vr.set_superres_params if kind == "sr"
                    else vr.set_videohdr_params)
            hook(*((jp, jcfg) if mod is J else (tm,)))
        if setup is not None:
            setup(vr, mod)
        s = dict(format=T.ColorFormat.NV12, width=32, height=16,
                 matrix=T.CSP.BT_709) | (src or {})
        vr.open(mod.SourceDescriptor(**{k: (_e(mod, v) if k == "format" else
                                            _e(mod.csputils, v)
                                            if hasattr(v, "name") else v)
                                        for k, v in s.items()}),
                mod.OutputDescriptor(**dst))
        out.append(vr)
    return out


def _model_band(jout, tout):
    _band(tout, jout, 50.0, 3.0 / 255.0)


def _code_band(jout, tout, bits=8):
    q = lambda a: np.round(np.asarray(a, np.float64) * (2 ** bits - 1))
    d = np.abs(q(jout) - q(tout))
    assert d.max() <= 3 and (d > 1).mean() <= 1e-3, (d.max(), (d > 1).mean())


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return {"sr": _models("sr", d, 21, channels=8, num_blocks=1, s2d=2),
            "vh": _models("vh", d, 22, channels=8)}


def test_superres_in_renderer(tiny_models):
    """tests/test_api_runner.py::test_superres_in_renderer on both
    packages: the net replaces the upscaler (the pipeline 1:1), the gate
    off falls back to the separable upscaler."""
    jv, tv = _pair(dict(vp_superres=T.SuperResolution.P1080, use_dither=False),
                   dict(width=64, height=32, bits=8),
                   [("sr", tiny_models["sr"])])
    assert jv._superres_engaged() and tv._superres_engaged()
    assert (tv._plan.dst.width, tv._plan.dst.height) == (32, 16)
    jo, to = (np.asarray(v.process_frame(_planes())) for v in (jv, tv))
    assert to.shape == (3, 32, 64)
    _model_band(jo, to)
    assert "SuperRes model: loaded (engaged: True)" in \
        tv.get_video_processor_info()
    for v in (jv, tv):
        v.set_settings(dataclasses.replace(
            v.settings, vp_superres=type(v.settings.vp_superres).DISABLE))
    assert not tv._superres_engaged()
    jo2, to2 = (np.asarray(v.process_frame(_planes())) for v in (jv, tv))
    _code_band(jo2, to2)
    assert np.abs(to - to2).max() > 1e-4


def test_videohdr_in_renderer(tiny_models):
    """tests/test_api_runner.py::test_videohdr_in_renderer on both
    packages, with the output signal info (PQ / BT.2020)."""
    jv, tv = _pair(dict(vp_rtx_video_hdr=True, hdr_passthrough=True,
                        convert_to_sdr=False, use_dither=False),
                   dict(width=32, height=16, bits=10, hdr=True),
                   [("vh", tiny_models["vh"])])
    assert tv._videohdr_engaged() and not tv._plan.dst.hdr
    jo, to = (np.asarray(v.process_frame(_planes())) for v in (jv, tv))
    assert to.shape == (3, 16, 32) and ((to >= 0) & (to <= 1)).all()
    _model_band(jo, to)
    ti, ji = tv.get_output_signal_info(), jv.get_output_signal_info()
    assert (ti.transfer, ti.primaries, ti.bits) == ("PQ", "BT_2020", 10)
    assert ti.to_dict() == ji.to_dict()
    assert "VideoHDR model: loaded (engaged: True)" in \
        tv.get_video_processor_info()
    # an SDR output leaves the model out
    jv2, tv2 = _pair(dict(vp_rtx_video_hdr=True),
                     dict(width=32, height=16, bits=8),
                     [("vh", tiny_models["vh"])])
    assert not tv2._videohdr_engaged()
    assert tv2.get_output_signal_info().to_dict() == \
        jv2.get_output_signal_info().to_dict()


FUZZ = np.random.default_rng(77)
FUZZ_TRIALS = [(int(FUZZ.choice([0, 90, 180, 270])), bool(FUZZ.integers(2)),
                int(FUZZ.integers(2)), bool(FUZZ.integers(2)),
                int(FUZZ.integers(4)), bool(FUZZ.integers(2)))
               for _ in range(12)]


@pytest.mark.parametrize("trial", range(12))
def test_model_composition_fuzz(tiny_models, trial):
    """tests/test_api_fuzz.py's 12 trials (rotation, flip, stereo, shader,
    mode 0 none / 1 SuperRes / 2 VideoHDR / 3 both, dither): the port's
    packed dwords equal the pack of its planar output, and its planar
    output matches the JAX renderer's (both models loaded in mode 3)."""
    rotation, flip, stereo, shader, mode, dither = FUZZ_TRIALS[trial]
    w, h = 32, 16
    st = dict(use_dither=dither)
    models = []
    if mode in (1, 3):
        st["vp_superres"] = T.SuperResolution.P1080
        models.append(("sr", tiny_models["sr"]))
    if mode in (2, 3):
        st["vp_rtx_video_hdr"] = True
        models.append(("vh", tiny_models["vh"]))
    dst = {0: dict(width=48, height=24, bits=8),
           1: dict(width=w * 2, height=h * 2, bits=8),
           2: dict(width=w, height=h, bits=10, hdr=True),
           3: dict(width=w * 2, height=h * 2, bits=10, hdr=True)}[mode]

    def setup(vr, mod):
        if rotation:
            vr.flt_set("rotation", rotation)
        if flip:
            vr.flt_set("flip", True)
        if stereo:
            vr.flt_set("stereo3dTransform", 1)
        if shader:
            lib = jnp if mod is J else torch
            clip = (lambda r: jnp.clip(r, 0.0, 1.0)) if mod is J else \
                (lambda r: torch.clamp(r, 0.0, 1.0))
            vr.flt_set("cmd_addPostScaleShader", lambda r: clip(r) ** 1.05)
            assert lib is not None

    jv, tv = _pair(st, dst, models, setup=setup)
    planes = _planes(w, h, seed=trial)
    jo, to = np.asarray(jv.process_frame(planes)), tv.process_frame(planes)
    assert to.shape == (3, dst["height"], dst["width"])
    assert torch.isfinite(to).all()
    if mode:
        _model_band(jo, to.numpy())
    else:
        _code_band(jo, to.numpy())
    tvp = _pair(st, dst, models, pack=True, setup=setup)[1]
    fmt = "rgb10a2" if dst["bits"] == 10 else "rgba8"
    assert torch.equal(tvp.process_frame(planes), trk.pack_surface(to, fmt))


@pytest.mark.parametrize("case", ["resample", "rotation90"])
def test_superres_resample_and_rotation(tiny_models, case):
    """A target that is not 2x gets the classical resample after the net
    (its dither moved after it); rotation 90 swaps the target."""
    dst = (dict(width=80, height=40, bits=8) if case == "resample"
           else dict(width=64, height=32, bits=8))

    def setup(vr, mod):
        if case == "rotation90":
            vr.flt_set("rotation", 90)

    jv, tv = _pair(dict(vp_superres=T.SuperResolution.P1080), dst,
                   [("sr", tiny_models["sr"])], setup=setup)
    # the pipeline-side target: 80 x 40, or 64 x 32 rotated to 32 x 64
    pw, ph = (80, 40) if case == "resample" else (32, 64)
    assert tv._superres_resample(pw, ph) is not None
    assert tv._superres_resample(64, 32) is None
    jo, to = (np.asarray(v.process_frame(_planes(seed=3))) for v in (jv, tv))
    assert to.shape == (3, dst["height"], dst["width"])
    _model_band(jo, to)


def test_models_in_settings_routed_deint(tiny_models):
    """An interlaced source with SuperRes: the session's fields take the
    float tail (the net, then the pack)."""
    jv, tv = _pair(dict(vp_superres=T.SuperResolution.P1080),
                   dict(width=64, height=32, bits=8),
                   [("sr", tiny_models["sr"])], pack=True,
                   src=dict(interlaced=True))
    outs = []
    for vr in (jv, tv):
        o = []
        for i in range(3):
            o += vr.process_frame(_planes(seed=10 + i))
        outs.append(o + vr.flush())
    assert len(outs[1]) == len(outs[0]) == 6
    for j, t in zip(*outs):
        assert t.shape == (32, 64) and t.dtype == torch.int32
        jc = np.stack([(np.asarray(j) >> (8 * i)) & 255 for i in range(3)])
        tc = np.stack([(t.numpy() >> (8 * i)) & 255 for i in range(3)])
        assert np.abs(jc.astype(int) - tc).max() <= 3


def test_model_hooks_cache_and_unload(tiny_models):
    tm = tiny_models["sr"][2]
    vr = tapi.VideoRenderer(T.Settings(vp_superres=T.SuperResolution.P1080),
                            device="cpu")
    vr.set_superres_params(tm)
    assert vr._superres is tm              # on the renderer's device: no copy
    vr.open(T.SourceDescriptor(format=T.ColorFormat.NV12, width=32, height=16,
                               matrix=T.CSP.BT_709),
            T.OutputDescriptor(width=64, height=32, bits=8))
    fn = vr._fn
    vr.set_superres_params(tm)             # the same model: a cache hit
    assert vr._fn is fn
    other = tsres.SuperRes(tm.cfg)
    vr.set_superres_params(other)          # another model: a rebuild
    assert vr._fn is not fn and vr._superres_engaged()
    vr.set_superres_params(None)
    assert not vr._superres_engaged() and vr._superres is None
    assert vr.process_frame(_planes()).shape == (3, 32, 64)
    assert "SuperRes model" not in vr.get_video_processor_info()
