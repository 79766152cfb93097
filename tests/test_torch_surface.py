"""The last public names of the JAX package that the port computes under
another name or not at all before, each held against the JAX function on
the CPU as the JAX package's own tests hold it:

 * ``ops/scale.band_diagonals``: the same diagonals (``np.array_equal``),
   None for a non-square or a wide band (``tests/test_scale.py:164-169``);
   ``stencil_resize_last_axis`` and ``stencil_resize_rows`` on the composed
   chroma upsample x Lanczos3 maps at net scale 1: within 1e-6 of the JAX
   stencils (float32 products summed in the same order), within 1e-5 of
   the float64 product (``tests/test_scale.py:141-161``'s band);
 * ``ops/geometry.transform_axis_maps``: the same maps for every rotation
   and flip, and the algebra ``rotate_flip(Wy^T P Wx) == Wy'^T
   rotate_flip(P) Wx'`` within 1e-12 (``tests/test_rotation_fused.py:24-41``);
 * ``ops/dovi.reshape_tiles_from_scalars`` (over the port's
   ``reshape_from_scalars``), with the coefficients read at an offset as
   the kernels read them: within 1e-6;
 * ``models/superres.apply_fn_chw``: the JAX ``apply_fn_chw`` on the same
   parameters within 2 bf16 ulps of the output's magnitude (the JAX fold
   of the base into the tail conv rounds once where the port rounds twice:
   ``tests/test_models.py:65-90``'s band), and the port's ``apply_fn``
   with its axes moved, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videorenderer_tpu.config import (ChromaScaling as JChroma,
                                      Upscaling as JUp)
from videorenderer_tpu.csputils import ChromaLocation as JLoc
from videorenderer_tpu.models import checkpoint as jck
from videorenderer_tpu.models import superres as jsres
from videorenderer_tpu.ops import chroma as jchroma
from videorenderer_tpu.ops import dovi as jdovi
from videorenderer_tpu.ops import geometry as jgeo
from videorenderer_tpu.ops import scale as jscale

from videorenderer_tpu_torch.models import checkpoint as tck
from videorenderer_tpu_torch.models import superres as tsres
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import geometry as tgeo
from videorenderer_tpu_torch.ops import scale as tscale

from torch_hdr_cells import JAX, TORCH, dovi_kind_meta as _meta


def _composed_maps():
    """The composed chroma upsample x Lanczos3 downscale at net scale 1 (the
    4K -> 1080p chroma case, at 64 x 32 chroma), float64."""
    ux, uy = jchroma.chroma_upsample_matrices(64, 32, 420, JChroma.BILINEAR,
                                              JLoc.MPEG2)
    cwx = np.asarray(ux) @ jscale.upscale_matrix(JUp.LANCZOS3, 128, 64)
    cwy = np.asarray(uy) @ jscale.upscale_matrix(JUp.LANCZOS3, 64, 32)
    return cwx, cwy


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_band_diagonals_equal_to_jax(dtype):
    for mat in _composed_maps():
        mat = mat.astype(dtype)
        want, got = jscale.band_diagonals(mat), tscale.band_diagonals(mat)
        assert want is not None and list(got) == list(want)
        for off in want:
            assert got[off].dtype == want[off].dtype
            assert np.array_equal(got[off], want[off])
        assert tscale.band_diagonals(mat, max_band=2) is None \
            and jscale.band_diagonals(mat, max_band=2) is None


def test_band_diagonals_rejects_wide_or_nonsquare():
    up = np.asarray(jscale.upscale_matrix(JUp.LANCZOS3, 64, 128))
    assert tscale.band_diagonals(up) is None           # non-square
    assert tscale.band_diagonals(np.ones((64, 64))) is None   # full band
    assert tscale.band_diagonals(np.zeros((8, 8))) is None


@pytest.mark.parametrize("batch", [(), (2,)])
def test_stencil_resize_matches_jax(batch):
    cwx, cwy = _composed_maps()
    dx, dy = tscale.band_diagonals(cwx), tscale.band_diagonals(cwy)
    x = np.random.default_rng(0).random(batch + (32, 64)).astype(np.float32)
    want = np.asarray(jscale.stencil_resize_rows(
        jscale.stencil_resize_last_axis(jnp.asarray(x), dx), dy))
    got = tscale.stencil_resize_rows(
        tscale.stencil_resize_last_axis(torch.from_numpy(x), dx), dy)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ref = np.einsum("...hw,wW,hH->...HW", x.astype(np.float64), cwx, cwy)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the row form alone, and a uint8 plane converted first
    codes = np.random.default_rng(1).integers(0, 256, (32, 64), np.uint8)
    np.testing.assert_allclose(
        tscale.stencil_resize_rows(torch.from_numpy(codes), dy).numpy(),
        np.asarray(jscale.stencil_resize_rows(jnp.asarray(codes), dy)),
        rtol=0, atol=1e-4)


ALL_RF = [(r, f) for r in (0, 90, 180, 270) for f in (False, True)]


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_transform_axis_maps_matches_jax(rotation, flip):
    rng = np.random.default_rng(rotation + flip)
    hi, ho, wi, wo = 6, 9, 5, 7
    wy = rng.standard_normal((hi, ho))
    wx = rng.standard_normal((wi, wo))
    p = rng.standard_normal((hi, wi))
    wy2, wx2 = tgeo.transform_axis_maps(wy, wx, rotation, flip)
    jwy2, jwx2 = jgeo.transform_axis_maps(wy, wx, rotation, flip)
    assert np.array_equal(wy2, jwy2) and np.array_equal(wx2, jwx2)
    out = torch.from_numpy(wy.T @ p @ wx)
    ref = tgeo.rotate_flip(out, rotation, flip).numpy()
    p2 = tgeo.rotate_flip(torch.from_numpy(p), rotation, flip).numpy()
    np.testing.assert_allclose(np.asarray(wy2).T @ p2 @ np.asarray(wx2),
                               ref, rtol=0, atol=1e-12)
    assert tgeo.transform_axis_maps(None, None, rotation, flip) == (None,
                                                                     None)


def test_reshape_tiles_from_scalars_matches_jax():
    """Identity curves and the variant's pieces (2-piece polynomial on Y,
    polynomial + MMR order 2 on Cb, MMR order 3 on Cr), the coefficients
    read at offset 12 as the stage-A epilogue reads them."""
    rng = np.random.default_rng(4)
    sig = [rng.uniform(-0.05, 1.05, (3, 10, 14)).astype(np.float32)
           for _ in range(3)]
    for kind in ("c8", "variant", "mmr"):
        jm, tm = _meta(JAX, kind), _meta(TORCH, kind)
        struct = tdovi.curve_structure(tm)
        flat = tdovi.flatten_curve_scalars(tdovi.pack_curves(tm), struct)
        vec = np.concatenate([np.arange(12, dtype=np.float32), flat])
        want = jdovi.reshape_tiles_from_scalars(
            [jnp.asarray(c) for c in sig], lambda i: jnp.float32(vec[i]), 12,
            jdovi.curve_structure(jm))
        got = tdovi.reshape_tiles_from_scalars(
            [torch.from_numpy(c) for c in sig], lambda i: vec[i], 12, struct)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("h,w,s2d", [(16, 16, 4), (18, 22, 4), (12, 20, 2)])
def test_superres_apply_fn_chw_matches_jax(tmp_path, h, w, s2d):
    """tests/test_models.py:65-90's cases: a 16-channel, 2-block net with a
    nonzero tail and bias, the pad-and-crop case included; the same
    parameters in both packages through one .npz."""
    jcfg = jsres.SuperResConfig(channels=16, num_blocks=2, scale=2, s2d=s2d)
    params = jsres.init_params(jax.random.PRNGKey(3), jcfg)
    params["tail"]["w"] = (jax.random.normal(
        jax.random.PRNGKey(4), params["tail"]["w"].shape) * 0.05
    ).astype(jcfg.dtype)
    params["tail"]["b"] = (jax.random.normal(
        jax.random.PRNGKey(5), params["tail"]["b"].shape) * 0.05
    ).astype(jcfg.dtype)
    path = str(tmp_path / "sr.npz")
    np.savez(path, **{k: np.asarray(v, np.float32)
                      for k, v in jck._flatten(params).items()})
    jp = jck.load_params(path, params)
    model = tck.load_params(path, tsres.SuperRes(tsres.SuperResConfig(
        channels=16, num_blocks=2, scale=2, s2d=s2d)))
    x = np.random.default_rng(7).random((2, 3, h, w)).astype(np.float32)
    want = np.asarray(jsres.apply_fn_chw(jp, jnp.asarray(x), jcfg))
    got = tsres.apply_fn_chw(model, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape \
        == (2, 3, 2 * h, 2 * w)
    tol = 2.0 ** -8 * 2.0 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)
    nhwc = tsres.apply_fn(model, torch.from_numpy(np.moveaxis(x, 1, -1)
                                                  .copy()))
    assert torch.equal(got, nhwc.movedim(-1, 1))
