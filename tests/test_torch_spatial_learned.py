"""videorenderer_tpu_torch.parallel.spatial's learned-model form
(``make_spatial_learned_fn``) and the models' ``row_valid`` on gloo groups
of 2 and 4 CPU ranks, against videorenderer_tpu.parallel.spatial and the
JAX models on the conftest's 8-device CPU mesh: the port's counterpart of
tests/test_spatial.py:466-625.

Both packages get the same parameters (random ones drawn with numpy from a
seed, biases included, written to one ``.npz`` that each package's
``load_params`` reads; or the shipped checkpoints).  Bands:
 * the stitched ranks bit-equal to the one-rank output (rank 0 makes it in
   the same single-threaded process, tests/torch_spatial_workers.py);
 * the halo math of one block (zeroed rows outside the frame, ``row_valid``)
   bit-equal to the whole frame's rows, float32 and bfloat16;
 * against the JAX package the model bands of tests/test_torch_models.py,
   SuperRes >= 50 dB, VideoHDR >= 80 dB, on float surfaces; a packed RGB10
   surface rounds those differences to codes, so it holds the band of
   tests/test_spatial.py's packed VideoHDR case (<= 0.02, >= 60 dB);
 * ``row_valid=None`` and bounds that cover the block leave the hooks'
   output as it was (phases 36-37's digests).
"""

import multiprocessing as mp
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_spatial_workers as workers
import videorenderer_tpu.parallel.spatial as jsp
import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.models import checkpoint as jck
from videorenderer_tpu.models import superres as jsres
from videorenderer_tpu.models import videohdr as jvh

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.models import checkpoint as tck
from videorenderer_tpu_torch.models import superres as tsres
from videorenderer_tpu_torch.models import videohdr as tvh
from videorenderer_tpu_torch.parallel import spatial as tsp

TIMEOUT_S = 180
SR_DB, VH_DB = 50.0, 80.0
NS = [2, 4]


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _params(kind, seed, tmp, **kw):
    """(JAX params, JAX cfg, port cfg, port state dict): the shipped
    checkpoint when ``seed`` is None, else random weights and biases."""
    jmod, tmod = (jsres, tsres) if kind == "superres" else (jvh, tvh)
    jc = (jsres.SuperResConfig if kind == "superres"
          else jvh.VideoHDRConfig)(**kw)
    tc = (tsres.SuperResConfig if kind == "superres"
          else tvh.VideoHDRConfig)(**kw)
    like = jmod.init_params(jax.random.PRNGKey(0), jc)
    if seed is None:
        path = ("weights/superres_2x.npz" if kind == "superres"
                else "weights/videohdr.npz")
    else:
        # tests/test_torch_models.py's draw: biases N(0, 0.05), He weights,
        # the last conv's a tenth of that
        rng = np.random.default_rng(seed)
        flat = {}
        for k, a in jck._flatten(like).items():
            std = 0.05 if k.endswith("/b") else np.sqrt(2 / (9 * a.shape[2]))
            if k.startswith(("tail", "c3")) and not k.endswith("/b"):
                std *= 0.1
            flat[k] = (rng.normal(0, 1, a.shape) * std).astype(np.float32)
        path = str(tmp / f"{kind}_{seed}.npz")
        np.savez(path, **flat)
    model = (tsres.SuperRes if kind == "superres" else tvh.VideoHDR)(tc)
    return (jck.load_params(path, like), jc, tc,
            tck.load_params(path, model).state_dict())


def _nv12(w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


# name: (kind, param seed (None: shipped), cfg, w, h, bits, pack, plane seed)
CASES = {
    # tests/test_spatial.py:472-506
    "sr": ("superres", 21, dict(channels=8, num_blocks=1, scale=2, s2d=2),
           64, 48, 8, False, 11),
    # :551-598 (44 rows: 4 shards x s2d 2 pad to 48)
    "vh_packed": ("videohdr", 9, dict(channels=8, s2d=2), 64, 44, 10, True,
                  13),
    "vh": ("videohdr", 9, dict(channels=8, s2d=2), 64, 44, 10, False, 13),
    # the shipped models: SuperRes's halo is 40 rows, so 160 rows on 4
    "sr_shipped": ("superres", None, {}, 64, 160, 8, False, 14),
    "vh_shipped": ("videohdr", None, {}, 64, 48, 10, True, 15),
}


def _plans(w, h, bits):
    """The 1:1 convert under the net, float32 W-pass intermediates in both
    packages (``TexFormat.FLOAT16``: the JAX XLA route's arithmetic; the
    mid16 route is held against the JAX package in
    tests/test_torch_spatial.py)."""
    def one(cfg, csp, pipe, fmt):
        return pipe.plan_pipeline(
            cfg.Settings(tex_format=cfg.TexFormat.FLOAT16),
            pipe.SourceDescriptor(format=fmt.NV12, width=w, height=h,
                                  matrix=csp.CSP.BT_709),
            pipe.OutputDescriptor(width=w, height=h, bits=bits))
    return one(jcfg, jcsp, jpipe, JFmt), one(tcfg, tcsp, tpipe, TFmt)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("params")
    out = {}
    for name, (kind, seed, kw, w, h, bits, pack, ps) in CASES.items():
        jp, jc, tc, state = _params(kind, seed, tmp, **kw)
        jplan, tplan = _plans(w, h, bits)
        out[name] = dict(kind=kind, jp=jp, jc=jc, tc=tc, state=state,
                         jplan=jplan, tplan=tplan, planes=_nv12(w, h, ps),
                         pack=pack, bits=bits, h=h)
    return out


def run_ranks(cases, n, tmp_path):
    work = [(name, "learned",
             dict(kind=c["kind"], cfg=c["tc"], state=c["state"],
                  settings=c["tplan"].settings, src=c["tplan"].src,
                  dst=c["tplan"].dst, planes=c["planes"], pack=c["pack"]))
            for name, c in cases.items()]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run,
                         args=(work, r, n, f"file://{tmp_path}/store",
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
def gloo(cases, tmp_path_factory):
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = run_ranks(cases, n, tmp_path_factory.mktemp(f"gl{n}"))
        return runs[n]
    return get


def stitched(gloo, name, n):
    res = gloo(n)
    got = torch.cat([r[name]["rows"] for r in res], dim=-2)
    for r in res:
        assert torch.equal(r[name]["gathered"], got)
    one = res[0][name]["one"]
    oh = one.shape[-2]
    assert got.shape[-1] == one.shape[-1] and torch.equal(got[..., :oh, :],
                                                          one)
    return got


def _model(c):
    m = (tsres.SuperRes if c["kind"] == "superres" else tvh.VideoHDR)(c["tc"])
    m.load_state_dict(c["state"])
    return m


def _decoded(x, c):
    """A learned output as floats: packed dwords decoded to codes / 1023,
    or the float surface."""
    x = np.asarray(x)
    if not c["pack"]:
        return x.astype(np.float64)
    lv = (1 << c["bits"]) - 1
    return np.stack([(x.astype(np.int64) >> (c["bits"] * i)) & lv
                     for i in range(3)], -3) / lv


@pytest.fixture(scope="module")
def jax_out(cases):
    """``jax_out(name)``: the JAX package's sharded form on 4 CPU devices."""
    outs = {}

    def get(name):
        if name not in outs:
            c = cases[name]
            mesh = JMesh(np.array(jax.devices()[:4]), ("spatial",))
            fn = jax.jit(jsp.make_spatial_learned_fn(
                c["jplan"], mesh, c["jp"], c["jc"], c["kind"],
                pack_surface=c["pack"]))
            outs[name] = np.asarray(fn(jsp.pad_shard_planes_rows(
                c["jplan"], mesh, c["planes"])))
        return outs[name]
    return get


def check_learned(cases, gloo, jax_out, name, n):
    """The shared checks, the port's unsharded composition, the JAX
    package's sharded form (model bands); returns the stitched surface."""
    c = cases[name]
    got = stitched(gloo, name, n)
    scale = c["tc"].scale if c["kind"] == "superres" else 1
    oh = c["h"] * scale
    model = _model(c)
    net = (tsres if c["kind"] == "superres" else tvh).enhance_plane_chw
    ref = net(model, tpipe.make_frame_fn(c["tplan"])(
        tuple(torch.from_numpy(p) for p in c["planes"])))
    if c["pack"]:
        ref = trk.pack_surface(ref, tpipe.surface_pack_format(
            c["tplan"].dst))
    db = SR_DB if c["kind"] == "superres" else VH_DB
    assert _psnr(_decoded(got[..., :oh, :], c), _decoded(ref, c)) >= db
    want = jax_out(name)[..., :oh, :]
    assert got[..., :oh, :].shape == want.shape
    a, b = _decoded(got[..., :oh, :], c), _decoded(want, c)
    if c["pack"]:
        # a packed surface rounds the net's output to codes: the band of
        # tests/test_spatial.py's packed VideoHDR case
        assert np.abs(a - b).max() <= 0.02 and _psnr(a, b) >= 60.0
    else:
        assert _psnr(a, b) >= db
    return got


# ---------------------------------------------------------------------------
# planning and the hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("superres", {}), ("superres", dict(num_blocks=1, s2d=2)),
    ("superres", dict(num_blocks=8, s2d=4)), ("videohdr", {}),
    ("videohdr", dict(s2d=2))])
def test_model_receptive_radius_equals_jax(tmp_path, kind, kw):
    jp, _, tc, state = _params(kind, 3, tmp_path, channels=8, **kw)
    model = (tsres.SuperRes if kind == "superres" else tvh.VideoHDR)(tc)
    model.load_state_dict(state)
    r = tsp.model_receptive_radius_s2d(model)
    assert r == jsp.model_receptive_radius_s2d(jp)
    assert tsp.model_receptive_radius_s2d(state) == r


@pytest.mark.parametrize("kind", ["superres", "videohdr"])
def test_row_valid_against_jax_and_default(tmp_path, kind):
    """The hooks' ``row_valid`` against the JAX models' on one halo-extended
    block (rows outside the frame zeroed), in the model bands; bounds that
    cover the block give the output without bounds, bit for bit."""
    kw = (dict(channels=8, num_blocks=1, s2d=2) if kind == "superres"
          else dict(channels=8, s2d=2))
    jp, jc, tc, state = _params(kind, 5, tmp_path, **kw)
    model = (tsres.SuperRes if kind == "superres" else tvh.VideoHDR)(tc)
    model.load_state_dict(state)
    tm, jm = (tsres, jsres) if kind == "superres" else (tvh, jvh)
    x = np.random.default_rng(4).random((2, 3, 20, 32)).astype(np.float32)
    x[:, :, :6] = 0.0                       # the block's rows above the frame
    got = tm.enhance_plane_chw(model, torch.from_numpy(x), row_valid=(3, 10))
    want = np.asarray(jm.enhance_plane_chw(jp, jnp.asarray(x), jc,
                                           row_valid=(3, 10)))
    assert _psnr(got, want) >= (SR_DB if kind == "superres" else VH_DB)
    plain = tm.enhance_plane_chw(model, torch.from_numpy(x))
    assert torch.equal(tm.enhance_plane_chw(model, torch.from_numpy(x),
                                            row_valid=(0, 10)), plain)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_learned_videohdr_halo_math_exact(tmp_path, dtype):
    """tests/test_spatial.py:509-548: the net on each halo-extended block,
    rows outside the frame zeroed and ``row_valid`` given, reproduces the
    whole frame's rows bit for bit, the edge blocks included (each conv's
    rows outside the frame are zeroed again, so they carry no relu(bias));
    and the JAX package's float32 blocks within the VideoHDR band."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp, jc, tc, state = _params("videohdr", 9, tmp_path, channels=8, s2d=2)
    tc = tvh.VideoHDRConfig(channels=8, s2d=2, dtype=dtype)
    model = tvh.VideoHDR(tc)
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    jc = jvh.VideoHDRConfig(channels=8, s2d=2, dtype=jdt)
    h, w = 48, 64
    x = torch.from_numpy(np.random.default_rng(13).random((3, h, w))
                         .astype(np.float32))
    full = tvh.enhance_plane_chw(model, x)
    halo = tsp.model_receptive_radius_s2d(model) * tc.s2d
    assert halo == 6
    n, hs = 4, h // 4
    for i in range(n):
        lo, hi = i * hs - halo, (i + 1) * hs + halo
        ext = torch.zeros((3, hs + 2 * halo, w))
        g0, g1 = max(lo, 0), min(hi, h)
        ext[:, g0 - lo:g1 - lo] = x[:, g0:g1]
        rv = (-lo // tc.s2d, (h - lo) // tc.s2d)
        y = tvh.enhance_plane_chw(model, ext, row_valid=rv)
        assert torch.equal(y[:, halo:halo + hs], full[:, i * hs:(i + 1) * hs])
        if dtype == torch.float32:
            want = np.asarray(jvh.enhance_plane_chw(
                jp, jnp.asarray(ext.numpy()), jc, row_valid=rv))
            assert _psnr(y, want) >= VH_DB


# ---------------------------------------------------------------------------
# the sharded learned form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_spatial_learned_superres_exact(cases, gloo, jax_out, n):
    """The halo-extended per-shard trunk: n ranks bit-equal to one."""
    got = check_learned(cases, gloo, jax_out, "sr", n)
    assert got.shape == (3, 96, 128)


@pytest.mark.parametrize("n", NS)
def test_spatial_learned_videohdr_packed_band(cases, gloo, jax_out, n):
    """VideoHDR with the packed RGB10 surface on a height the mesh pads (44
    rows, 48 on 4 shards): the pad rows black (alpha bits only), the rest
    the one-rank surface, and the float form beside it."""
    got = check_learned(cases, gloo, jax_out, "vh_packed", n).numpy()
    pad = got[44:].view(np.uint32)
    assert np.all(pad & 0x3FFFFFFF == 0)
    fl = check_learned(cases, gloo, jax_out, "vh", n)
    assert np.array_equal(got[:44], trk.pack_surface(fl[..., :44, :],
                                                     "rgb10a2").numpy())


@pytest.mark.parametrize("n", NS)
def test_spatial_learned_shipped_models(cases, gloo, jax_out, n):
    """The shipped checkpoints (SuperRes: 4 blocks at s2d 4, 40 halo rows;
    VideoHDR: s2d 4, 12 halo rows) sharded, bit-equal to one rank."""
    check_learned(cases, gloo, jax_out, "sr_shipped", n)
    check_learned(cases, gloo, jax_out, "vh_shipped", n)


def test_spatial_learned_guards(tmp_path):
    """tests/test_spatial.py:601-624: the s2d-divisibility and halo-size
    guards raise with guidance, as the JAX package's; an unknown kind
    raises."""
    _, tplan = _plans(64, 44, 8)
    model = tsres.SuperRes(tsres.SuperResConfig(channels=8, num_blocks=1,
                                                scale=2, s2d=8))
    with pytest.raises(ValueError, match="divisible by cfg.s2d"):
        tsp.make_spatial_learned_fn(tplan, tsp.Shard(0, 4), model, "superres")
    deep = tsres.SuperRes(tsres.SuperResConfig(channels=8, num_blocks=8,
                                               scale=2, s2d=4))
    with pytest.raises(ValueError, match="halo rows"):
        tsp.make_spatial_learned_fn(_plans(64, 48, 8)[1], tsp.Shard(0, 4),
                                    deep, "superres")
    with pytest.raises(ValueError, match="unknown learned-model kind"):
        tsp.make_spatial_learned_fn(_plans(64, 48, 8)[1], tsp.Shard(0, 1),
                                    deep, "denoise")


def test_drive_shards_locally_learned(cases, gloo):
    """drive_shards_locally gives the 4 ranks' rows of the learned form."""
    c = cases["sr"]
    model = _model(c)
    outs = tsp.drive_shards_locally(
        lambda sh: tsp.make_spatial_learned_fn(c["tplan"], sh, model,
                                               "superres"),
        lambda r: tsp.pad_shard_planes_rows(c["tplan"], tsp.Shard(r, 4),
                                            c["planes"]), 4)
    for r, res in enumerate(gloo(4)):
        assert torch.equal(outs[r], res["sr"]["rows"])
