"""videorenderer_tpu_torch.parallel.spatial's frame forms (fused, Dolby
Vision and Jinc2) on gloo groups of 2 and 4 CPU ranks, against
videorenderer_tpu.parallel.spatial on the conftest's 8-device CPU mesh:
the port's counterpart of tests/test_spatial.py, case for case, plus the
host planning held ``np.array_equal`` to the JAX package's.

All cases of this file run in one spawned group per rank count (their side:
tests/torch_spatial_workers.py, no JAX; file:// rendezvous, every wait
bounded by TIMEOUT_S); each test reads its case.  Bands:
 * the stitched ranks bit-equal to the one-rank output of the same plan
   (rank 0 makes it in the same single-threaded process), and to every
   rank's all-gathered surface (``gather_rows``);
 * against the port's unsharded ``make_frame_fn``: K2's kernel-against-
   plain band, <= 1 code on < 2% of the channels;
 * against the JAX ``make_spatial_frame_fn`` (XLA route, 4 shards): the
   fused form within 1 code on >= 99.9% of the channels, at most 3
   (tests/test_torch_fused.py's band: the port's kernel route keeps int16
   "mid16" W-pass intermediates where the JAX XLA route keeps float32);
   on ``TexFormat.FLOAT16`` (float32 intermediates in both) more than
   half a code on < 0.1%, at most 1.5 (tests/test_fused.py's band); the
   Dolby Vision form the JAX test's own band (<= 1.5/255, > 0.5/255 on
   < 1e-3);
 * the mid16 route on one shard against the JAX Pallas route in interpret
   mode, as tests/test_spatial.py's ``test_spatial_mid16_interpret``.
The widths are multiples of 16, as the JAX test's are: the CPU's
vectorised elementwise loops then take no scalar remainder inside a shard.
The one-pass Jinc2 form: on its K6 route every rank's rows equal the
one-device K6's (the kernels' plain versions, ``pipeline._on_card`` true
in the rank that makes them), on its K5 route K2's band; against the JAX
low-rank form at most 1 code, on < 0.7% of the channels (twice the 0.35%
the port's one-device Jinc2 sits from the JAX one at the placed case; the
JAX test's > 0.5/255 on < 1e-3 is between two JAX forms).
"""

import functools
import multiprocessing as mp
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JMesh

import torch_spatial_workers as workers
import videorenderer_tpu.parallel.spatial as jsp
import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.kernels import resize_pallas as jrp
from videorenderer_tpu.ops import dovi as jdovi
from videorenderer_tpu.ops import scale as jscale

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.parallel import mesh as tpm
from videorenderer_tpu_torch.parallel import spatial as tsp

TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    """resize_pallas caches band packings by id(matrix) (ROADMAP §3): each
    test gets its own cache."""
    monkeypatch.setattr(jrp, "_band_cache", {})


# ---------------------------------------------------------------------------
# the cases: both packages' descriptors of one plan, and its planes
# ---------------------------------------------------------------------------


def _dovi_meta(mod):
    """tests/test_spatial.py's ``_dovi_poly_meta`` in either package."""
    curve = mod.ReshapeCurve(pivots=(0.5,), method=(0, 0),
                             poly=np.array([[0.02, 0.9, 0.1],
                                            [0.0, 1.05, -0.05]]))
    return mod.DoviMetadata(
        curves=(curve, mod.identity_curve(), mod.identity_curve()),
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(mod.DOVI_LMS2RGB))


HDR_SRC = dict(matrix="BT_2020_NC", levels="TV", primaries="BT_2020",
               transfer="PQ")


def _descs(pkg, fmt, w, h, ow, oh, settings, src, dst):
    """(Settings, SourceDescriptor, OutputDescriptor) of one package; enum
    values by member name (the packages' enums are distinct classes)."""
    cfg, csp, pipe, F, dov = pkg
    enums = {"matrix": csp.CSP, "levels": csp.Levels,
             "primaries": csp.Primaries, "transfer": csp.TRC,
             "upscaling": cfg.Upscaling, "tex_format": cfg.TexFormat}
    sk = {k: getattr(enums[k], v) if k in enums else v
          for k, v in settings.items()}
    rk_ = {k: v for k, v in ({"matrix": "BT_709"} | src).items()
           if k != "dovi"}
    rk_ = {k: getattr(enums[k], v) if k in enums else v
           for k, v in rk_.items()}
    if src.get("dovi"):
        rk_["dovi"] = _dovi_meta(dov)
    return (cfg.Settings(**sk),
            pipe.SourceDescriptor(format=getattr(F, fmt), width=w, height=h,
                                  **rk_),
            pipe.OutputDescriptor(width=ow, height=oh, **dst))


JPKG = (jcfg, jcsp, jpipe, JFmt, jdovi)
TPKG = (tcfg, tcsp, tpipe, TFmt, tdovi)


def _planes(fmt, w, h, seed, batch=None):
    """tests/test_spatial.py's planes: NV12 uniform 8-bit codes, P010
    TV-range 10-bit codes (MSB-aligned), Y8 one plane."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    if fmt == "P010":
        return (rng.integers(64, 941, lead + (h, w), np.uint16) << 6,
                rng.integers(64, 961, lead + (h // 2, w // 2), np.uint16) << 6,
                rng.integers(64, 961, lead + (h // 2, w // 2), np.uint16) << 6)
    if fmt == "Y8":
        return (rng.integers(0, 256, lead + (h, w), np.uint8),)
    return (rng.integers(0, 256, lead + (h, w), np.uint8),
            rng.integers(0, 256, lead + (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, lead + (h // 2, w // 2), np.uint8))


def _case(fmt, w, h, ow, oh, settings=None, src=None, dst=None, seed=0,
          batch=None, pack=False, unsharded=False):
    settings, src = settings or {}, src or {}
    dst = {"bits": 8} | (dst or {})
    return dict(fmt=fmt, geo=(w, h, ow, oh), settings=settings, src=src,
                dst=dst, planes=_planes(fmt, w, h, seed, batch), pack=pack,
                unsharded=unsharded)


DOVI = dict(HDR_SRC, dovi=True)
CASES = {
    # tests/test_spatial.py:29-48
    **{f"size_{oh}x{ow}": _case("NV12", 64, 64, ow, oh,
                                dict(use_dither=False))
       for oh, ow in ((64, 128), (32, 32), (128, 256))},
    "src_rect": _case("NV12", 64, 64, 96, 96, src=dict(src_rect=(8, 4, 56, 52)),
                      seed=2),
    "video_rect": _case("NV12", 64, 64, 128, 96,
                        dst=dict(video_rect=(24, 20, 104, 84)), seed=3),
    "dither_hdr": _case("P010", 64, 32, 32, 16, dict(upscaling="LANCZOS3"),
                        HDR_SRC, dict(bits=10), seed=1),
    "pack": _case("NV12", 64, 32, 128, 64, seed=61, pack=True),
    "pack_plain": _case("NV12", 64, 32, 128, 64, seed=61),
    "pad_1080p": _case("NV12", 128, 108, 64, 54, dict(upscaling="LANCZOS3"),
                       seed=7),
    "pad_batched": _case("NV12", 64, 52, 64, 52, seed=8, batch=2),
    "pad_batched_packed": _case("NV12", 64, 52, 64, 52, seed=8, batch=2,
                                pack=True),
    "float16": _case("NV12", 64, 48, 128, 96,
                     dict(upscaling="LANCZOS3", tex_format="FLOAT16"),
                     seed=31),
    "gray": _case("Y8", 64, 64, 96, 48, seed=5),
    # tests/test_spatial.py:290-356
    **{f"dovi_{o}": _case("P010", 32, 32, o, o, dict(use_dither=False), DOVI,
                          seed=11) for o in (64, 32, 16)},
    "dovi_vrect": _case("P010", 32, 32, 96, 64, dict(use_dither=True), DOVI,
                        dict(video_rect=(16, 12, 80, 60)), seed=12),
    "dovi_vrect_packed": _case("P010", 32, 32, 96, 64, dict(use_dither=True),
                               DOVI, dict(video_rect=(16, 12, 80, 60)),
                               seed=12, pack=True),
    "dovi_pad": _case("P010", 32, 28, 64, 56, dict(use_dither=False), DOVI,
                      seed=13),
    # tests/test_spatial.py:359-411, and the K6 route with the mesh's pad
    # rows, and the K5 route with PQ -> SDR
    "jinc2": _case("NV12", 64, 64, 128, 128,
                   dict(upscaling="JINC2", use_dither=False), seed=21,
                   unsharded=True),
    "jinc2_vrect": _case("NV12", 64, 64, 128, 96, dict(upscaling="JINC2"),
                         dst=dict(video_rect=(24, 4, 112, 92)), seed=22,
                         batch=2, unsharded=True),
    "jinc2_pad_packed": _case("NV12", 64, 52, 128, 98,
                              dict(upscaling="JINC2"), seed=23, pack=True,
                              unsharded=True),
    "jinc2_hdr": _case("P010", 64, 32, 128, 64,
                       dict(upscaling="JINC2", convert_to_sdr=True), HDR_SRC,
                       dict(bits=10), seed=24, unsharded=True),
}
HALO_X = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)


def _plans(name):
    c = CASES[name]
    w, h, ow, oh = c["geo"]
    j = _descs(JPKG, c["fmt"], w, h, ow, oh, c["settings"], c["src"], c["dst"])
    t = _descs(TPKG, c["fmt"], w, h, ow, oh, c["settings"], c["src"], c["dst"])
    return jpipe.plan_pipeline(*j), tpipe.plan_pipeline(*t), t


def run_ranks(n, tmp_path):
    """Every case of this file on ``n`` gloo ranks; each rank's results."""
    cases = [(name, "frame", dict(zip(("settings", "src", "dst"),
                                      _plans(name)[2]),
                                  planes=c["planes"], pack=c["pack"],
                                  unsharded=c["unsharded"]))
             for name, c in CASES.items()]
    cases.append(("halo", "halo", dict(x=HALO_X, rows=2)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run,
                         args=(cases, r, n, f"file://{tmp_path}/store",
                               str(tmp_path))) for r in range(n)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks {hung} of {n} still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * n
    return [torch.load(tmp_path / f"spatial_{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """``gloo(n)``: the ranks' results of every case, one spawn per n."""
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = run_ranks(n, tmp_path_factory.mktemp(f"gloo{n}"))
        return runs[n]
    return get


@functools.cache
def jax_spatial(name, n=4):
    """The JAX package's spatial output of a case on n CPU devices."""
    c = CASES[name]
    jplan = _plans(name)[0]
    mesh = JMesh(np.array(jax.devices()[:n]), ("spatial",))
    sp = jsp.pad_shard_planes_rows(jplan, mesh, c["planes"])
    return np.asarray(jax.jit(jsp.make_spatial_frame_fn(
        jplan, mesh, pack_surface=c["pack"]))(sp))


def port_unsharded(name):
    c = CASES[name]
    tplan = _plans(name)[1]
    return tpipe.make_frame_fn(tplan, pack_surface=c["pack"])(
        tuple(torch.from_numpy(p) for p in c["planes"])).numpy()


def _levels(name):
    return 1023 if CASES[name]["dst"]["bits"] == 10 else 255


def codes(x, levels, packed):
    """Channel codes of a float surface (..., 3, H, W) or of packed dwords
    (..., H, W) -> (..., 3, H, W)."""
    x = np.asarray(x)
    if not packed:
        return np.round(x.astype(np.float64) * levels).astype(np.int64)
    bits = 10 if levels == 1023 else 8
    return np.stack([(x.astype(np.int64) >> (bits * i)) & levels
                     for i in range(3)], -3)


def k2_band(got, ref, levels, packed):
    """<= 1 code on < 2% of the channels (K2 against its plain version)."""
    d = np.abs(codes(got, levels, packed) - codes(ref, levels, packed))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())


def jax_band(got, ref, levels, packed):
    """1 code on >= 99.9% of the channels, at most 3."""
    d = np.abs(codes(got, levels, packed) - codes(ref, levels, packed))
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3, (d.max(),
                                                       (d > 1).mean())


def f32_band(got, ref):
    """tests/test_fused.py's band: > 0.5/255 on < 0.1%, at most 1.5/255."""
    d = np.abs(np.asarray(got, np.float64) - ref)
    assert (d > 0.5 / 255).mean() < 1e-3 and d.max() <= 1.5 / 255


def stitched(gloo, name, n):
    """The case's stitched surface on n ranks, after the checks every case
    shares: each rank's gathered surface is the stitched one, the stitched
    one is the one-rank output bit for bit."""
    res = gloo(n)
    got = torch.cat([r[name]["rows"] for r in res], dim=-2)
    for r in res:
        assert torch.equal(r[name]["gathered"], got)
    # the one-rank surface has the output's rows; n ranks may pad it
    one = res[0][name]["one"]
    oh = one.shape[-2]
    assert got.shape[:-2] == one.shape[:-2] and got.shape[-1] == one.shape[-1]
    assert torch.equal(got[..., :oh, :], one)
    return got.numpy()


def check_fused(gloo, name, n):
    """A fused case: the shared checks, the unsharded port, the JAX
    package; returns the surface cropped to the output's height."""
    c = CASES[name]
    oh = c["geo"][3]
    got = stitched(gloo, name, n)
    levels, packed = _levels(name), c["pack"]
    k2_band(got[..., :oh, :], port_unsharded(name), levels, packed)
    want = jax_spatial(name)[..., :oh, :]
    assert got[..., :oh, :].shape == want.shape
    jax_band(got[..., :oh, :], want, levels, packed)
    return got


NS = [2, 4]


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------


MAPS = [(m, i, o) for m in ("LANCZOS3", "CATMULL_ROM", "MITCHELL")
        for i, o in ((64, 128), (128, 64), (64, 64 * 3), (96, 32))]


@pytest.mark.parametrize("method,h_in,h_out", MAPS)
def test_required_halo_and_shard_mats_equal_jax(method, h_in, h_out):
    """tests/test_spatial.py:20-26 (halo math), on more maps: the halo, the
    per-shard blocks and the embedding equal to the JAX package's."""
    mat = jscale.upscale_matrix(getattr(jcfg.Upscaling, method), h_in, h_out)
    mat = np.asarray(mat)
    for n in (1, 2, 4, 8):
        if h_in % n or h_out % n:
            continue
        h = tsp.required_halo(mat, n)
        assert h == jsp.required_halo(mat, n)
        for a, b in zip(tsp._shard_row_mats(mat, n, h),
                        jsp._shard_row_mats(mat, n, h)):
            assert np.array_equal(a, b)
    if (method, h_in, h_out) == ("LANCZOS3", 64, 128):
        assert 1 <= tsp.required_halo(mat, 4) <= 8
    e = dict(in_total=h_in + 8, in_off=3, out_total=h_out + 5, out_off=2)
    assert np.array_equal(tsp._embed(mat, **e), jsp._embed(mat, **e))
    assert tsp._embed(mat) is mat or np.array_equal(tsp._embed(mat), mat)


@pytest.mark.parametrize("name", ["pad_1080p", "pad_batched", "dovi_pad",
                                  "src_rect", "gray", "video_rect"])
def test_padded_heights_and_stage_a_equal_jax(name):
    jplan, tplan, _ = _plans(name)
    for n in (1, 2, 4, 8):
        for unit in (1, 2, 4):
            assert (tsp.spatial_padded_heights(tplan, n, unit)
                    == jsp.spatial_padded_heights(jplan, n, unit))
        assert tsp._stage_a_height(tplan, n) == jsp._stage_a_height(jplan, n)
        for pad in (True, False):
            try:
                want = jsp._check_divisible(jplan, n, pad, jplan.dst.height)
            except ValueError as e:
                with pytest.raises(ValueError, match="not divisible"):
                    tsp._check_divisible(tplan, n, pad, tplan.dst.height)
                assert "not divisible" in str(e)
                continue
            assert tsp._check_divisible(tplan, n, pad,
                                        tplan.dst.height) == want
    assert tsp.spatial_padded_heights(_plans("pad_1080p")[1], 8) == (112, 56)


JINC2_GEOS = [(64, 64, 128, 128), (64, 64, 128, 96), (64, 64, 128, 16),
              (64, 64, 64, 64), (64, 64, 32, 32), (64, 48, 64, 96)]


@pytest.mark.parametrize("geo", JINC2_GEOS)
def test_jinc2_spatial_ok_equals_jax(geo):
    w, h, ow, oh = geo
    for extra in ({}, dict(vp_scaling=False)):
        st = dict(upscaling="JINC2") | extra
        j = jpipe.plan_pipeline(*_descs(JPKG, "NV12", w, h, ow, oh, st, {},
                                        {"bits": 8}))
        t = tpipe.plan_pipeline(*_descs(TPKG, "NV12", w, h, ow, oh, st, {},
                                        {"bits": 8}))
        assert tsp._jinc2_spatial_ok(t) == jsp._jinc2_spatial_ok(j)


# ---------------------------------------------------------------------------
# the halo source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_halo_from_blocks_is_the_exchange(gloo, n):
    """What halo_exchange delivers on each rank equals halo_from_blocks cut
    from every rank's block (drive_shards_locally's halo source)."""
    hs = 32 // n
    blocks = [torch.from_numpy(HALO_X[r * hs:(r + 1) * hs]) for r in range(n)]
    for r, res in enumerate(gloo(n)):
        assert torch.equal(res["halo"], tsp.halo_from_blocks(blocks, r, 2))


@pytest.mark.parametrize("name", ["size_64x128", "video_rect", "dovi_vrect",
                                  "pad_1080p", "jinc2_pad_packed",
                                  "jinc2_vrect"])
def test_drive_shards_locally_equals_gloo(gloo, name):
    """drive_shards_locally (no collective, the halos cut from the other
    ranks' blocks) gives the 4 ranks' rows bit for bit, the Dolby Vision
    form's dependent stage-B halo included."""
    c = CASES[name]
    tplan = _plans(name)[1]
    outs = tsp.drive_shards_locally(
        lambda sh: tsp.make_spatial_frame_fn(tplan, sh, pack_surface=c["pack"]),
        lambda r: tsp.pad_shard_planes_rows(tplan, tsp.Shard(r, 4),
                                            c["planes"]), 4)
    for r, res in enumerate(gloo(4)):
        assert torch.equal(outs[r], res[name]["rows"])


# ---------------------------------------------------------------------------
# the fused form (tests/test_spatial.py:29-251)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("out_size", ["64x128", "32x32", "128x256"])
def test_spatial_matches_single(gloo, out_size, n):
    check_fused(gloo, f"size_{out_size}", n)


@pytest.mark.parametrize("n", NS)
def test_spatial_src_rect_exact(gloo, n):
    check_fused(gloo, "src_rect", n)


@pytest.mark.parametrize("n", NS)
def test_spatial_video_rect_exact(gloo, n):
    """video_rect: H output embedding + row mask + W pad give the FillBlack
    surface, the dither's phase included (the rect's top, 20, is not a
    multiple of the 32-row pattern)."""
    got = check_fused(gloo, "video_rect", n)
    assert got.shape == (3, 96, 128)
    assert np.all(got[:, :20] == 0) and np.all(got[:, 84:] == 0)
    assert np.all(got[..., :24] == 0) and np.all(got[..., 104:] == 0)


def test_spatial_guards():
    """Clear errors for plans that cannot shard, as the JAX package's."""
    mesh = tsp.Shard(0, 4)
    p60 = _descs(TPKG, "NV12", 64, 60, 64, 64, {}, {}, {"bits": 8})
    with pytest.raises(ValueError, match="not divisible"):
        tsp.make_spatial_frame_fn(tpipe.plan_pipeline(*p60), mesh,
                                  pad_to_mesh=False)
    p66 = _descs(TPKG, "NV12", 64, 64, 64, 66, {}, {}, {"bits": 8})
    with pytest.raises(ValueError, match="not divisible"):
        tsp.make_spatial_frame_fn(tpipe.plan_pipeline(*p66), mesh,
                                  pad_to_mesh=False)
    shader = _descs(TPKG, "NV12", 64, 64, 64, 64, dict(vp_scaling=False), {},
                    {"bits": 8})
    with pytest.raises(ValueError, match="fusable"):
        tsp.make_spatial_frame_fn(tpipe.plan_pipeline(*shader), mesh)
    with pytest.raises(ValueError, match="surf_row_unit"):
        tsp.make_spatial_frame_fn(_plans("dovi_32")[1], mesh, surf_row_unit=2)
    # a halo wider than a shard (the video rect's embedded map on 8 shards)
    with pytest.raises(ValueError, match="halo rows but each shard"):
        tsp.make_spatial_frame_fn(_plans("video_rect")[1], tsp.Shard(0, 8))
    with pytest.raises(ValueError, match="split over"):
        tsp.shard_planes_rows(tsp.Shard(0, 4),
                              (np.zeros((30, 8), np.uint8),))


@pytest.mark.parametrize("n", NS)
def test_spatial_dither_and_hdr(gloo, n):
    """P010 PQ -> SDR 10-bit with the ordered dither: the shards keep the
    unsharded pattern phase."""
    check_fused(gloo, "dither_hdr", n)


@pytest.mark.parametrize("n", NS)
def test_spatial_pack_surface(gloo, n):
    """The ranks' packed surface equals packing the unpacked one."""
    packed = check_fused(gloo, "pack", n)
    plain = check_fused(gloo, "pack_plain", n)
    assert packed.shape == (64, 128)
    assert np.array_equal(packed, trk.pack_surface(torch.from_numpy(plain),
                                                   "rgba8").numpy())


@pytest.mark.parametrize("n", NS + [8])
def test_spatial_pad_and_crop_1080p(gloo, n):
    """1080p geometry / 10 (128 x 108 -> 64 x 54): heights that do not
    split pad with zero-weight rows; the cropped surface is the unsharded
    one and the pad rows are black.  Eight shards (1088 / 544 rows at
    1080p) run on one device through drive_shards_locally."""
    if n == 8:
        c, tplan = CASES["pad_1080p"], _plans("pad_1080p")[1]
        outs = tsp.drive_shards_locally(
            lambda sh: tsp.make_spatial_frame_fn(tplan, sh),
            lambda r: tsp.pad_shard_planes_rows(tplan, tsp.Shard(r, 8),
                                                c["planes"]), 8)
        got = torch.cat(outs, dim=-2).numpy()
        assert got.shape[-2] == 56
        k2_band(got[..., :54, :], port_unsharded("pad_1080p"), 255, False)
        jax_band(got, jax_spatial("pad_1080p", 8), 255, False)
        assert got.shape == jax_spatial("pad_1080p", 8).shape
    else:
        got = check_fused(gloo, "pad_1080p", n)
    assert np.all(got[..., 54:, :] == 0)


@pytest.mark.parametrize("n", NS)
def test_spatial_pad_batched_and_packed(gloo, n):
    """Pad-and-crop with a batch dim (52 rows: 4 shards pad 52 / 26 to 56 /
    28) and the packed surface."""
    got = check_fused(gloo, "pad_batched", n)
    packed = check_fused(gloo, "pad_batched_packed", n)
    assert np.array_equal(packed, trk.pack_surface(torch.from_numpy(got),
                                                   "rgba8").numpy())


def test_spatial_single_shard_fast_path():
    """A one-device mesh (a world of one from make_mesh, gloo) takes the
    fast path with no collective: bit-equal to the port's unsharded frame
    function, dither included, packed too."""
    c, tplan = CASES["pad_batched"], _plans("pad_batched")[1]
    planes = tuple(torch.from_numpy(p) for p in c["planes"])
    mesh = tpm.make_mesh(axis="spatial", device="cpu")
    try:
        assert mesh.size == 1
        sp = tsp.shard_planes_rows(mesh, planes)
        got = tsp.make_spatial_frame_fn(tplan, mesh)(sp)
        packed = tsp.make_spatial_frame_fn(tplan, mesh, pack_surface=True)(sp)
        assert tsp.gather_rows(mesh, got) is got
    finally:
        mesh.destroy()
    ref = tpipe.make_frame_fn(tplan)(planes)
    assert torch.equal(got, ref)
    assert torch.equal(packed, trk.pack_surface(ref, "rgba8"))


def test_spatial_float16_and_gray(gloo):
    """float32 W-pass intermediates (FLOAT16) against the JAX XLA route, in
    test_fused's float band; a GRAY source (K1 then K3 on its one plane)."""
    for n in NS:
        got = stitched(gloo, "float16", n)
        f32_band(got, jax_spatial("float16"))
        k2_band(got, port_unsharded("float16"), 255, False)
        check_fused(gloo, "gray", n)


def test_spatial_mid16_interpret(monkeypatch):
    """The mid16 route (int16 W-pass codes, the unscale in the H tables) on
    one shard against the JAX package's Pallas route in interpret mode on a
    one-device mesh, and against the CPU's staged plan (the band of
    tests/test_spatial.py:426-463)."""
    w, h, ow, oh = 64, 48, 128, 96
    st = dict(use_dither=False, upscaling="LANCZOS3")
    jd = _descs(JPKG, "NV12", w, h, ow, oh, st, {}, {"bits": 8})
    td = _descs(TPKG, "NV12", w, h, ow, oh, st, {}, {"bits": 8})
    planes = _planes("NV12", w, h, 31)
    got = tsp.make_spatial_frame_fn(tpipe.plan_pipeline(*td), tsp.Shard(0, 1))(
        tuple(torch.from_numpy(p) for p in planes)).numpy()
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        mesh = JMesh(np.array(jax.devices()[:1]), ("spatial",))
        with pltpu.force_tpu_interpret_mode():
            interp = np.asarray(jsp.make_spatial_frame_fn(
                jpipe.plan_pipeline(*jd), mesh)(jsp.shard_planes_rows(
                    mesh, tuple(jnp.asarray(p) for p in planes))))
    jax_band(got, interp, 255, False)
    jst = dict(st, use_accel_backend=False)
    staged = np.asarray(jpipe.make_frame_fn(jpipe.plan_pipeline(
        *_descs(JPKG, "NV12", w, h, ow, oh, jst, {}, {"bits": 8})))(planes))
    d = np.abs(got - staged)
    assert d.max() <= 1.5 / 255 and (d > 0.5 / 255).mean() < 0.02


# ---------------------------------------------------------------------------
# Dolby Vision (tests/test_spatial.py:290-356)
# ---------------------------------------------------------------------------


def check_dovi(gloo, name, n):
    c = CASES[name]
    got = stitched(gloo, name, n)
    oh = c["geo"][3]
    k2_band(got[..., :oh, :], port_unsharded(name), _levels(name), c["pack"])
    want = jax_spatial(name)[..., :oh, :]
    assert got[..., :oh, :].shape == want.shape
    if c["pack"]:
        jax_band(got[..., :oh, :], want, _levels(name), True)
    else:
        d = np.abs(got[..., :oh, :].astype(np.float64) - want)
        assert (d > 0.5 / 255).mean() < 1e-3 and d.max() <= 1.5 / 255
    return got


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("out", [64, 32, 16])
def test_spatial_dovi_matches_single(gloo, out, n):
    """The split-fused chain under sharding: the reshape, matrix and LMS
    step are row-local, only the chroma upsample's and the resize's H
    contractions exchange halos."""
    assert tpipe.route_of(_plans(f"dovi_{out}")[1]) == "dovi_fused"
    check_dovi(gloo, f"dovi_{out}", n)


@pytest.mark.parametrize("n", NS)
def test_spatial_dovi_vrect_dither_and_pack(gloo, n):
    """Placement, ordered dither and the packed surface under sharding;
    the black fill outside the rect is exact."""
    got = check_dovi(gloo, "dovi_vrect", n)
    assert np.all(got[..., :12, :] == 0) and np.all(got[..., 60:, :] == 0)
    assert np.all(got[..., :16] == 0)
    packed = check_dovi(gloo, "dovi_vrect_packed", n)
    assert np.array_equal(packed, trk.pack_surface(torch.from_numpy(got),
                                                   "rgba8").numpy())


@pytest.mark.parametrize("n", NS)
def test_spatial_dovi_pad_and_crop(gloo, n):
    """Chroma heights that do not split (14 rows) take the pad-and-crop
    fallback."""
    got = check_dovi(gloo, "dovi_pad", n)
    assert np.all(got[..., 56:, :] == 0)


# ---------------------------------------------------------------------------
# Jinc2 (tests/test_spatial.py:359-423): the direct form, K6 or K5 on a band
# ---------------------------------------------------------------------------


def check_jinc2(gloo, name, n, k6):
    """A Jinc2 case: the shared checks; against the one-device frame
    function on the kernel route (K6: bit-equal, every rank's rows the
    unsharded K6's; K5 after the convert: K2's band), and the JAX
    package's spatial low-rank form: at most 1 code, on < 0.7% of the
    channels, twice the 0.35% by which the port's one-device Jinc2 already
    sits 1 code from the JAX one at the placed case (the same channels its
    spatial form flips).  The JAX test's tighter band (> 0.5/255 on
    < 1e-3) is between two JAX forms."""
    c = CASES[name]
    oh = c["geo"][3]
    got = stitched(gloo, name, n)
    one_device = gloo(n)[0][name]["unsharded"].numpy()
    if k6:
        assert np.array_equal(got[..., :oh, :], one_device)
    else:
        k2_band(got[..., :oh, :], one_device, _levels(name), c["pack"])
    want = jax_spatial(name)[..., :oh, :]
    d = np.abs(codes(got[..., :oh, :], _levels(name), c["pack"])
               - codes(want, _levels(name), c["pack"]))
    assert d.max() <= 1 and (d > 0).mean() < 0.007, (d.max(), (d > 0).mean())
    return got


@pytest.mark.parametrize("n", NS)
def test_spatial_jinc2_matches_single(gloo, n):
    """The one-pass Jinc2 upscale sharded in the direct form: K6 on each
    rank's band of rows, bit-equal to one rank and to the one-device K6."""
    check_jinc2(gloo, "jinc2", n, k6=True)


@pytest.mark.parametrize("n", NS)
def test_spatial_jinc2_vrect_and_batch(gloo, n):
    """Placement and a batch dim: the convert at source resolution, K5 on
    the band, the torch tail; the bars exactly black."""
    got = check_jinc2(gloo, "jinc2_vrect", n, k6=False)
    assert got.shape == (2, 3, 96, 128)
    assert np.all(got[..., :4, :] == 0) and np.all(got[..., :24] == 0)


@pytest.mark.parametrize("n", NS)
def test_spatial_jinc2_pad_packed_and_hdr(gloo, n):
    """K6's packed surface on a height the mesh pads (98 rows, 100 on 4
    shards: the pad rows the packed zero), and PQ -> SDR at 10 bits on the
    K5 route."""
    got = check_jinc2(gloo, "jinc2_pad_packed", n, k6=True)
    assert np.all(got[..., 98:, :] == trk.PACKED_ZERO["rgba8"])
    check_jinc2(gloo, "jinc2_hdr", n, k6=False)


def test_spatial_jinc2_plans_equal_jax():
    """The plans the JAX package shards in its Jinc2 form are the port's."""
    for geo, vrect in (((64, 64, 128, 128), None),
                       ((64, 64, 128, 96), (24, 4, 112, 92))):
        w, h, ow, oh = geo
        dst = {"bits": 8} | ({"video_rect": vrect} if vrect else {})
        t = tpipe.plan_pipeline(*_descs(TPKG, "NV12", w, h, ow, oh,
                                        dict(upscaling="JINC2"), {}, dst))
        j = jpipe.plan_pipeline(*_descs(JPKG, "NV12", w, h, ow, oh,
                                        dict(upscaling="JINC2"), {}, dst))
        assert jsp._jinc2_spatial_ok(j) and tsp._jinc2_spatial_ok(t)
        assert tpipe.route_of(t) != "fused"


def test_spatial_jinc2_mixed_axes_raise():
    """Mixed Jinc2-up / convolution-down axes stay on one device: the JAX
    package's error."""
    args = ("NV12", 64, 64, 128, 16, dict(upscaling="JINC2"), {}, {"bits": 8})
    with pytest.raises(ValueError, match="fusable"):
        tsp.make_spatial_frame_fn(tpipe.plan_pipeline(*_descs(TPKG, *args)),
                                  tsp.Shard(0, 4))
    with pytest.raises(ValueError, match="fusable"):
        jsp.make_spatial_frame_fn(
            jpipe.plan_pipeline(*_descs(JPKG, *args)),
            JMesh(np.array(jax.devices()[:4]), ("spatial",)))
