"""videorenderer_tpu_torch.ops.overlay (and ops.geometry's stereo transform)
against the JAX package on the same seeded inputs, on the CPU.

Bands: the blends, the dword unpack and pack are bit-equal to the JAX
package's (on XLA's CPU backend no FMA contraction moves a code: the
measured share of differing channels is 0), on both surface formats, with
rects clipped at every edge and leading batch dims; the input surface or
frame is never written.  ``sdr_bitmap_to_pq`` goes through two pow
implementations: within 2e-5.  The port oracle's float64 packed blend
(c5s's reference) equals bench_common.np_blend_packed_codes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from videorenderer_tpu.ops import geometry as jgeo
from videorenderer_tpu.ops import overlay as jov

from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import geometry as tgeo
from videorenderer_tpu_torch.ops import overlay as tov

FMTS = ["rgba8", "rgb10a2"]
# (x, y) of a 20 x 30 overlay on a 40 x 56 surface: inside, clipped at the
# top-left, at the bottom-right, straddling one edge, fully outside
RECTS = [(5, 3), (-4, -2), (40, 30), (50, -5), (60, 50), (-30, 0)]
LEADS = [(), (3,)]


def _surface(rng, fmt, lead, h=40, w=56):
    """Random codes of every channel with the format's alpha bits set (the
    int32 is negative: the arithmetic shift must be masked)."""
    alpha = jov._SURFACE_BITS[fmt][2]
    return (rng.integers(0, 1 << 30, lead + (h, w)).astype(np.int32)
            | np.int32(alpha))


def _overlay(rng, h=20, w=30):
    return (rng.random((3, h, w), np.float32),
            rng.random((h, w), np.float32))


@pytest.mark.parametrize("premul", [False, True])
@pytest.mark.parametrize("lead", LEADS, ids=["single", "batch3"])
@pytest.mark.parametrize("fmt", FMTS)
def test_blend_in_rect_packed_bit_equal(fmt, lead, premul):
    rng = np.random.default_rng(len(lead) * 7 + premul)
    codes = _surface(rng, fmt, lead)
    ov_rgb, ov_a = _overlay(rng)
    for x, y in RECTS:
        want = np.asarray(jov.blend_in_rect_packed(
            jnp.asarray(codes), jnp.asarray(ov_rgb), jnp.asarray(ov_a),
            x=x, y=y, fmt=fmt, premultiplied=premul))
        surf = torch.from_numpy(codes.copy())
        got = tov.blend_in_rect_packed(
            surf, torch.from_numpy(ov_rgb), torch.from_numpy(ov_a), x=x,
            y=y, fmt=fmt, premultiplied=premul)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((x, y)))
        np.testing.assert_array_equal(surf.numpy(), codes)   # untouched


@pytest.mark.parametrize("premul", [False, True])
@pytest.mark.parametrize("lead", LEADS, ids=["single", "batch3"])
def test_blend_in_rect_bit_equal(lead, premul):
    rng = np.random.default_rng(11 + len(lead))
    base = rng.random(lead + (3, 40, 56), np.float32)
    ov_rgb, ov_a = _overlay(rng)
    for x, y in RECTS:
        want = np.asarray(jov.blend_in_rect(
            jnp.asarray(base), jnp.asarray(ov_rgb), jnp.asarray(ov_a), x=x,
            y=y, premultiplied=premul))
        frame = torch.from_numpy(base.copy())
        got = tov.blend_in_rect(frame, torch.from_numpy(ov_rgb),
                                torch.from_numpy(ov_a), x=x, y=y,
                                premultiplied=premul)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((x, y)))
        np.testing.assert_array_equal(frame.numpy(), base)


@pytest.mark.parametrize("alpha_shape", [(12, 10), (1, 12, 10)])
@pytest.mark.parametrize("fn", ["alpha_blend", "alpha_blend_premultiplied"])
def test_alpha_blends_bit_equal(fn, alpha_shape):
    rng = np.random.default_rng(3)
    base = rng.random((2, 3, 12, 10), np.float32)
    ov = rng.random((3, 12, 10), np.float32)
    a = rng.random(alpha_shape, np.float32)
    for b in (base, base[0]):
        want = np.asarray(getattr(jov, fn)(jnp.asarray(b), jnp.asarray(ov),
                                           jnp.asarray(a)))
        got = getattr(tov, fn)(torch.from_numpy(b), torch.from_numpy(ov),
                               torch.from_numpy(a))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lead", LEADS, ids=["single", "batch3"])
@pytest.mark.parametrize("fmt", FMTS)
def test_dword_unpack_and_pack_bit_equal(fmt, lead):
    rng = np.random.default_rng(5)
    codes = _surface(rng, fmt, lead, 9, 13)
    un = tov._unpack_dwords(torch.from_numpy(codes), fmt)
    np.testing.assert_array_equal(
        un.numpy(), np.asarray(jov._unpack_dwords(jnp.asarray(codes), fmt)))
    # values around every rounding boundary, and out of range
    rgb = np.concatenate([rng.random(lead + (3, 9, 13), np.float32) * 1.2
                          - 0.1, un.numpy()], axis=-1)
    got = tov._pack_dwords(torch.from_numpy(rgb), fmt)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jov._pack_dwords(jnp.asarray(rgb), fmt)))
    # the same math as the kernels' surface pack
    assert torch.equal(got, trk.pack_surface(torch.from_numpy(rgb), fmt))
    # decoded codes repack to themselves
    assert torch.equal(tov._pack_dwords(un, fmt), torch.from_numpy(codes))


@pytest.mark.parametrize("brightness", [0, 1, 2, 7])
def test_sdr_bitmap_to_pq(brightness):
    rng = np.random.default_rng(brightness)
    rgb = rng.random((3, 16, 24), np.float32)
    want = np.asarray(jov.sdr_bitmap_to_pq(jnp.asarray(rgb), brightness))
    got = tov.sdr_bitmap_to_pq(torch.from_numpy(rgb), brightness).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", [(3, 16, 24), (2, 3, 17, 8), (1, 5)])
def test_half_overunder_to_interlace_equal(shape):
    x = np.random.default_rng(1).random(shape, np.float32)
    np.testing.assert_array_equal(
        tgeo.half_overunder_to_interlace(torch.from_numpy(x)).numpy(),
        np.asarray(jgeo.half_overunder_to_interlace(jnp.asarray(x))))


def test_oracle_blend_and_c5s_overlay_equal_bench_common():
    """The port oracle's float64 packed blend equals
    bench_common.np_blend_packed_codes, and chip_smoke's c5s subtitle
    bitmap and placement are bench_common's."""
    import bench_common as bc
    import chip_smoke as cs
    from videorenderer_tpu_torch.oracle import blend_packed_codes

    assert (cs.SUB_W, cs.SUB_H, cs.SUB_X, cs.SUB_Y) == (
        bc.SUB_W, bc.SUB_H, bc.SUB_X, bc.SUB_Y)
    for a, b in zip(cs.subtitle_overlay(), bc.subtitle_overlay()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(8)
    for bits in (8, 10):
        maxv = 2 ** bits - 1
        codes = rng.integers(0, maxv + 1, (3, 30, 40)) / maxv
        ov_rgb = rng.random((3, 9, 13))
        ov_a = rng.random((9, 13))
        want = bc.np_blend_packed_codes(codes, ov_rgb, ov_a, 20, 11, bits)
        got = blend_packed_codes(torch.from_numpy(codes), ov_rgb, ov_a, 20,
                                 11, bits)
        np.testing.assert_array_equal(got.numpy(), want)
