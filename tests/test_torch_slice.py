"""The main path of videorenderer_tpu_torch end to end, at small sizes,
against the JAX package: the same frames (numpy, from a seed) through the
port's ``VideoProcessor(device="cpu")`` and the JAX ``make_frame_fn``.

 * The port's kernel path (the plain versions of K1 and K2 on the CPU)
   against the JAX kernel path (Pallas in interpret mode): the JAX kernels
   sum split-bf16 products, the port float32, so a few W-pass values round
   to neighbouring mid16 codes and a few H sums move by ~1e-5; the tail
   turns that into up to a few 10-bit codes where a saturated colour sits
   at the gamut edge (the 1/2.2 gamma is infinitely steep at black).  So:
   >= 99.9% of the channels within 1 code, none beyond 4, < 2% differing
   at all, and the two >= 70 dB apart.
 * The port's plain path (``use_accel_backend=False``) against the JAX XLA
   path: within 1 code on < 2% of the channels (measured: equal).
 * Both against ``bench.py::numpy_oracle`` (sizes shrunk): >= 55 dB.
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

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.oracle import oracle

W, H, OW, OH = 256, 128, 128, 64


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix): a new matrix of
    the same shape that reuses a freed one's id would hit a stale entry.
    Each test gets its own cache and leaves no entry behind."""
    monkeypatch.setattr(jrp, "_band_cache", {})


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def codes10(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)], -3).astype(np.int32)


def codes8(dwords):
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0xFF for s in (0, 8, 16)], -3).astype(np.int32)


@pytest.fixture(scope="module")
def bench_mod():
    # bench.py points JAX's compilation cache at a directory outside the
    # checkout when imported; keep that setting out of the test process
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        import bench
    return bench


@pytest.fixture()
def small_bench(bench_mod, monkeypatch):
    for name, val in (("W", W), ("H", H), ("OW", OW), ("OH", OH)):
        monkeypatch.setattr(bench_mod, name, val)
    return bench_mod


def _triple(cfg, csp, pipe, fmt, settings, *, fmt_name="P010", w=W, h=H,
            transfer="PQ", primaries="BT_2020", matrix="BT_2020_NC",
            bits=10, hdr=False, interlaced=False, src_rect=None):
    return (cfg.Settings(**settings),
            pipe.SourceDescriptor(
                format=getattr(fmt, fmt_name), width=w, height=h,
                matrix=csp.CSP[matrix], levels=csp.Levels.TV,
                primaries=csp.Primaries[primaries], transfer=csp.TRC[transfer],
                hdr10=pipe.HDR10Metadata(), interlaced=interlaced,
                src_rect=src_rect),
            pipe.OutputDescriptor(width=OW if w == W else w,
                                  height=OH if h == H else h, bits=bits,
                                  hdr=hdr))


HEADLINE = dict(upscaling="LANCZOS3", chroma_scaling="BILINEAR",
                convert_to_sdr=True, use_dither=True)


def _settings(mod, d):
    enums = {"upscaling": mod.Upscaling, "chroma_scaling": mod.ChromaScaling,
             "tex_format": mod.TexFormat}
    return {k: enums[k][v] if k in enums else v for k, v in d.items()}


def run_jax(settings, planes, kernel, monkeypatch, pack=True, **kw):
    s, src, dst = _triple(jcfg, jcsp, jpipe, JFmt, _settings(jcfg, settings),
                          **kw)
    if not kernel:
        s = jcfg.Settings(**{**s.__dict__, "use_accel_backend": False})
        fn = jpipe.make_frame_fn(jpipe.plan_pipeline(s, src, dst),
                                 pack_surface=pack)
        return np.asarray(fn(tuple(jnp.asarray(p) for p in planes)))
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        fn = jpipe.make_frame_fn(jpipe.plan_pipeline(s, src, dst),
                                 pack_surface=pack)
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(tuple(jnp.asarray(p) for p in planes)))


def run_port(settings, planes, kernel, pack=True, **kw):
    s, src, dst = _triple(tcfg, tcsp, tpipe, TFmt,
                          {**_settings(tcfg, settings),
                           "use_accel_backend": kernel}, **kw)
    vp = tpipe.VideoProcessor(s, src, dst, device="cpu", pack_surface=pack)
    return vp.process(planes).numpy()


@pytest.fixture(scope="module")
def frames(bench_mod):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_mod, "W", W)
        mp.setattr(bench_mod, "H", H)
        return bench_mod.make_frames(2, seed=0)


def test_slice_kernel_path_matches_jax_kernel_path(frames, small_bench,
                                                   monkeypatch):
    got = codes10(run_port(HEADLINE, frames, kernel=True))
    ref = codes10(run_jax(HEADLINE, frames, True, monkeypatch))
    assert got.shape == ref.shape == (2, 3, OH, OW)
    d = np.abs(got - ref)
    assert (d <= 1).mean() >= 0.999     # measured: 2 of 49,152 above 1
    assert d.max() <= 4                 # measured: 3
    assert (d > 0).mean() < 0.02
    assert psnr(got / 1023.0, ref / 1023.0) >= 70.0
    oracle_ref = small_bench.numpy_oracle(*(p[0] for p in frames))
    assert psnr(got[0] / 1023.0, oracle_ref) >= 55.0
    assert psnr(ref[0] / 1023.0, oracle_ref) >= 55.0


def test_slice_plain_path_matches_jax_xla_path(frames, small_bench,
                                               monkeypatch):
    got = codes10(run_port(HEADLINE, frames, kernel=False))
    ref = codes10(run_jax(HEADLINE, frames, False, monkeypatch))
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    oracle_ref = small_bench.numpy_oracle(*(p[0] for p in frames))
    assert psnr(got[0] / 1023.0, oracle_ref) >= 55.0


def test_port_oracle_agrees_on_the_slice(frames):
    got = codes10(run_port(HEADLINE, frames, kernel=True))
    ref = oracle(*(torch.from_numpy(p[0]) for p in frames), OW, OH).numpy()
    assert psnr(got[0] / 1023.0, ref) >= 55.0


@pytest.mark.parametrize("kernel", [True, False])
def test_float16_tex_format_float_output(frames, kernel, monkeypatch):
    """FLOAT16 keeps float32 W-pass planes and bits=16 means float output:
    no quantization anywhere.  The products' float32 rounding differs
    between the frameworks in the last bit, and the PQ EOTF multiplies that
    by up to ~400 (in either package it sits up to 5.4e-5 from float64): so
    >= 99.5% of the values within 1e-5 (measured 99.9%), all within 2e-4
    (measured 7.9e-5)."""
    st = dict(HEADLINE, tex_format="FLOAT16")
    got = run_port(st, frames, kernel=kernel, pack=False, bits=16)
    ref = run_jax(st, frames, False, monkeypatch, pack=False, bits=16)
    assert got.shape == ref.shape == (2, 3, OH, OW) and got.dtype == np.float32
    d = np.abs(got.astype(np.float64) - ref)
    assert (d <= 1e-5).mean() >= 0.995
    assert d.max() <= 2e-4


def _nv12(seed=5, w=128, h=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(16, 236, (2, h, w), dtype=np.uint8),
            rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8),
            rng.integers(16, 241, (2, h // 2, w // 2), dtype=np.uint8))


C1 = dict(chroma_scaling="BILINEAR")
C1_KW = dict(fmt_name="NV12", w=128, h=64, transfer="BT_1886",
             primaries="BT_709", matrix="BT_709", bits=8)


@pytest.mark.parametrize("kernel", [True, False])
def test_c1_plan_direct_read(kernel, monkeypatch):
    """1080p-class NV12 -> RGBA8 1:1 (c1, here 128x64): no luma matrix at
    all, so K2 reads the raw uint8 luma directly."""
    planes = _nv12()
    got = codes8(run_port(C1, planes, kernel=kernel, **C1_KW))
    ref = codes8(run_jax(C1, planes, kernel, monkeypatch, **C1_KW))
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    want = oracle(*(torch.from_numpy(p[0]) for p in planes), 128, 64,
                  bits_in=8, matrix=tcsp.CSP.BT_709, pq_to_sdr=False,
                  dither_bits=8).numpy()
    assert psnr(got[0] / 255.0, want) >= 55.0


@pytest.mark.parametrize("kernel", [True, False])
def test_hlg_to_sdr(frames, kernel, monkeypatch):
    kw = dict(transfer="HLG", bits=8)
    got = codes8(run_port(HEADLINE, frames, kernel=kernel, **kw))
    ref = codes8(run_jax(HEADLINE, frames, kernel, monkeypatch, **kw))
    d = np.abs(got - ref)
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("case", ["hlg_to_pq", "fix_bt2020_sdr"])
def test_plain_path_other_corrections(frames, case, monkeypatch):
    """The plain ``_corrections`` carries all three branches: float output
    against the JAX XLA path."""
    kw = (dict(transfer="HLG", bits=16, hdr=True) if case == "hlg_to_pq"
          else dict(transfer="BT_1886", bits=16))
    st = dict(HEADLINE, convert_to_sdr=False)
    got = run_port(st, frames, kernel=False, pack=False, **kw)
    ref = run_jax(st, frames, False, monkeypatch, pack=False, **kw)
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("kernel", [True, False])
def test_blend_deinterlace_fold(frames, kernel, monkeypatch):
    st = dict(HEADLINE, deint_blend=True)
    got = codes10(run_port(st, frames, kernel=kernel, interlaced=True))
    ref = codes10(run_jax(st, frames, kernel, monkeypatch, interlaced=True))
    d = np.abs(got - ref)
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("kernel", [True, False])
def test_src_rect_crop(frames, kernel, monkeypatch):
    """A source crop (SetSourcePosition): 200x96 of the 256x128 frame,
    scaled to the 128x64 output."""
    kw = dict(src_rect=(16, 8, 216, 104))
    got = codes10(run_port(HEADLINE, frames, kernel=kernel, **kw))
    ref = codes10(run_jax(HEADLINE, frames, kernel, monkeypatch, **kw))
    d = np.abs(got - ref)
    assert (d <= 1).mean() >= 0.999 and (d > 0).mean() < 0.02


def test_launch_counts_untouched_on_cpu(frames):
    """CPU tensors take the plain versions: no kernel launch is counted."""
    trk.reset_launches()
    run_port(HEADLINE, frames, kernel=True)
    assert trk.launches == {"banded_resize_last_axis": 0, "rows3_tail": 0}
