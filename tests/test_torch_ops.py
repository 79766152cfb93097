"""videorenderer_tpu_torch tail ops against the JAX originals, and the
torch float64 oracle against ``bench.py::numpy_oracle``.

Inputs are float32, made with numpy from a seed.  Tolerance: max abs
difference <= 1e-5 (relative to the output scale where that exceeds 1),
since the two frameworks' exp2/log2/exp differ in the last bits.  The two
PQ curves are ill-conditioned in float32 and get 3e-5 plus a check that the
port is no further from float64 than the original (see their docstrings).
The oracles: <= 1e-9, the same float64 math."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videorenderer_tpu import pipeline as jpipe
from videorenderer_tpu.ops import dither as jdither
from videorenderer_tpu.ops import tonemap as jtm
from videorenderer_tpu.ops import transfer as jtr

from videorenderer_tpu_torch import csputils as tcsp
from videorenderer_tpu_torch import pipeline as tpipe
from videorenderer_tpu_torch.oracle import oracle
from videorenderer_tpu_torch.ops import dither as tdither
from videorenderer_tpu_torch.ops import tonemap as ttm
from videorenderer_tpu_torch.ops import transfer as ttr

TOL = 1e-5


def _x(shape=(3, 40, 56), lo=-0.1, hi=1.1, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(t, j, tol=TOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.dtype == np.float32 and t.shape == j.shape
    assert np.abs(t.astype(np.float64) - j.astype(np.float64)).max() <= tol


@pytest.mark.parametrize("e", [1.0 / 2.2, 2.2, 0.2, 1.0 / 78.84375, 6.2777])
def test_pow_pos(e):
    x = _x(lo=-0.5, hi=1.5)
    _close(ttr.pow_pos(torch.from_numpy(x), e), jtr.pow_pos(jnp.asarray(x), e))


@pytest.mark.parametrize("factor", [1.0, 10000.0 / 125.0, 10000.0])
def test_st2084_to_linear(factor):
    """The PQ EOTF is ill-conditioned in float32: x**(1/78.84) lies within
    1e-2 of 1 before c1 is subtracted, so both implementations sit up to
    5.4e-5 (relative to ``factor``) from the float64 curve and 1.5e-5 from
    each other.  So: within 3e-5 of each other, relative to the output
    scale, and the port no further from float64 than the original."""
    x = _x()
    t = ttr.st2084_to_linear(torch.from_numpy(x), factor).numpy()
    j = np.asarray(jtr.st2084_to_linear(jnp.asarray(x), factor))
    _close(t, j, 3e-5 * factor)
    x64 = np.maximum(x.astype(np.float64), 0.0) ** (1.0 / ttr.ST2084_M2)
    x64 = (np.maximum(x64 - ttr.ST2084_C1, 0.0)
           / np.maximum(ttr.ST2084_C2 - ttr.ST2084_C3 * x64, 1e-6))
    ref = x64 ** (1.0 / ttr.ST2084_M1) * factor
    assert np.abs(t - ref).max() <= 1.1 * np.abs(j - ref).max() + 1e-7 * factor


@pytest.mark.parametrize("divider", [1000.0, 10000.0])
def test_linear_to_st2084(divider):
    """The OETF's last step raises to the 78.84th power, which multiplies
    a float32 rounding of its base by 78.84: within 3e-5 of each other and
    no further from float64 than the original."""
    x = _x(lo=0.0, hi=2000.0)
    t = ttr.linear_to_st2084(torch.from_numpy(x), divider).numpy()
    j = np.asarray(jtr.linear_to_st2084(jnp.asarray(x), divider))
    _close(t, j, 3e-5)
    p = (x.astype(np.float64) / divider) ** ttr.ST2084_M1
    ref = ((ttr.ST2084_C1 + ttr.ST2084_C2 * p)
           / (1.0 + ttr.ST2084_C3 * p)) ** ttr.ST2084_M2
    assert np.abs(t - ref).max() <= 1.1 * np.abs(j - ref).max() + 1e-7


def test_inverse_hlg():
    x = _x(lo=0.0, hi=1.0)
    _close(ttr.inverse_hlg(torch.from_numpy(x)), jtr.inverse_hlg(jnp.asarray(x)))


@pytest.mark.parametrize("axis", [0, -3])
def test_hlg_to_linear(axis):
    x = _x(lo=0.0, hi=1.0)
    t = ttr.hlg_to_linear(torch.from_numpy(x), axis=axis)
    j = jtr.hlg_to_linear(jnp.asarray(x), axis=axis)
    # up to ~12 * 2000**0.2 scene light: compare relative to the output scale
    _close(t, j, TOL * float(np.abs(np.asarray(j)).max()))


@pytest.mark.parametrize("gamma", [1.8, 2.2, 2.8])
def test_srgb_like(gamma):
    x = _x()
    _close(ttr.srgb_like_to_linear(torch.from_numpy(x), gamma),
           jtr.srgb_like_to_linear(jnp.asarray(x), gamma))
    _close(ttr.linear_to_srgb_like(torch.from_numpy(x), gamma),
           jtr.linear_to_srgb_like(jnp.asarray(x), gamma))


def test_hable():
    x = _x(lo=0.0, hi=80.0)
    _close(ttm.tonemap_hable_sdr(torch.from_numpy(x)),
           jtm.tonemap_hable_sdr(jnp.asarray(x)))
    assert ttm._HABLE_DIV == jtm._HABLE_DIV


def test_gamut_2020_to_709():
    x = _x(lo=0.0, hi=5.0)
    _close(tpipe._gamut_2020_to_709(torch.from_numpy(x), -3),
           jpipe._gamut_2020_to_709(jnp.asarray(x), -3))


@pytest.mark.parametrize("origin", [(0, 0), (5, 17), (32, 64)])
def test_bayer_field(origin):
    t = tdither.bayer_field(70, 45, *origin)
    j = jdither.bayer_field(70, 45, *origin)
    assert np.array_equal(t.numpy(), np.asarray(j))
    tiled = np.tile(tdither.bayer_matrix(), (4, 4))
    r0, c0 = origin
    assert np.array_equal(t.numpy(), tiled[r0 % 32:r0 % 32 + 70, c0 % 32:c0 % 32 + 45])


@pytest.mark.parametrize("bits", [8, 10])
def test_dither_and_quantize(bits):
    x = _x(lo=0.0, hi=1.0, shape=(2, 3, 40, 56))
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tdither.ordered_dither_iota(tx, bits),
           jdither.ordered_dither_iota(jx, bits))
    _close(tdither.ordered_dither(tx, bits, row_offset=7),
           jdither.ordered_dither(jx, bits, row_offset=7))
    _close(tdither.quantize(tx, bits), jdither.quantize(jx, bits))
    assert torch.equal(tdither.ordered_dither(tx, bits),
                       tdither.ordered_dither_iota(tx, bits))


@pytest.mark.parametrize("bits", [8, 10])
def test_random_dither_rule_equals_jax(bits, monkeypatch):
    """random_dither's rule, floor(img Q + U) requantized, equal to the JAX
    package's on the same uniform noise (JAX's own draw from its key, fed
    to the port in place of its generator's); the generator decides the
    noise."""
    x = _x(lo=0.0, hi=1.0, shape=(2, 3, 24, 40))
    key = jax.random.PRNGKey(bits)
    noise = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    want = np.asarray(jdither.random_dither(jnp.asarray(x), bits, key))
    with monkeypatch.context() as m:
        m.setattr(torch, "rand", lambda shape, generator, dtype, device:
                  torch.from_numpy(noise).to(dtype))
        got = tdither.random_dither(torch.from_numpy(x), bits,
                                    torch.Generator().manual_seed(0))
    assert np.array_equal(got.numpy(), want)
    tx = torch.from_numpy(x)
    a, b, c = (tdither.random_dither(tx, bits,
                                     torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    codes = a * (2 ** bits - 1)    # on the grid, up to the reciprocal's
    assert float((codes - torch.round(codes)).abs().max()) < 1e-3
    assert float((a - tx).abs().max()) <= 1.0 / (2 ** bits - 1)


@pytest.fixture(scope="module")
def bench_mod():
    # bench.py points JAX's compilation cache at a directory outside the
    # checkout when imported; keep that setting out of the test process
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        import bench
    return bench


def test_oracle_matches_bench_numpy_oracle(bench_mod, monkeypatch):
    w, h, ow, oh = 96, 64, 48, 32
    for name, val in (("W", w), ("H", h), ("OW", ow), ("OH", oh)):
        monkeypatch.setattr(bench_mod, name, val)
    y, u, v = (p[0] for p in bench_mod.make_frames(1, seed=3))
    ref = bench_mod.numpy_oracle(y, u, v)
    got = oracle(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
                 ow, oh).numpy()
    assert got.shape == ref.shape == (3, oh, ow)
    assert np.abs(got - ref).max() <= 1e-9


def test_oracle_sdr_plan_is_matrix_and_dither():
    """The c1 form (8-bit BT.709 TV, 1:1, no tone map): the colour matrix
    and the ordered dither, nothing else."""
    rng = np.random.default_rng(4)
    y = rng.integers(16, 236, (32, 64), dtype=np.uint8)
    u = rng.integers(16, 241, (16, 32), dtype=np.uint8)
    v = rng.integers(16, 241, (16, 32), dtype=np.uint8)
    got = oracle(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
                 64, 32, bits_in=8, matrix=tcsp.CSP.BT_709, pq_to_sdr=False,
                 dither_bits=8).numpy()
    cm = tcsp.get_csp_matrix(tcsp.CSPParams(
        color=tcsp.Colorspace(tcsp.CSP.BT_709, tcsp.Levels.TV),
        input_bits=8, texture_bits=8))
    # pixel (0, 0): chroma sample (0, 0) exactly (MPEG-2 even phase, top edge
    # clamp), dither value of pattern cell (0, 0)
    yuv = np.array([y[0, 0], u[0, 0], v[0, 0]], np.float64) / 255.0
    rgb = cm.m @ yuv + cm.c
    d = tdither.bayer_matrix()[0, 0]
    want = np.floor(np.clip(rgb, 0, 1) * 255 + d) / 255
    np.testing.assert_allclose(got[:, 0, 0], want, atol=1e-12)
