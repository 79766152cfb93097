"""videorenderer_tpu_torch.parallel.mesh on gloo groups of 2 and 4 CPU
processes against videorenderer_tpu.parallel.mesh on the conftest's
8-device CPU mesh, and the trainers' ``mesh=`` (data parallelism).

Each case starts its ranks with the spawn method (their side is
tests/torch_mesh_workers.py, which imports no JAX) and bounds the wait
for them, so that a hang fails the test instead of stalling the suite.
Bands: ``halo_exchange``, ``shard_batch`` and ``jit_frame_parallel``
bit-equal; ``spatial_resize_rows`` within float32 rounding of JAX's (the
band of the rank's rows is one product in both); data-parallel training
replicated bit for bit across ranks, each step's loss within 1% of the
one-process run and of the JAX ``train(mesh=...)`` (the trajectory band of
tests/test_torch_train.py).
"""

import multiprocessing as mp
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_workers as workers
from videorenderer_tpu.models import checkpoint as jck
from videorenderer_tpu.models import hdr_train as jhdr
from videorenderer_tpu.models import sr_train as jsr
from videorenderer_tpu.models import superres as jsres
from videorenderer_tpu.models import videohdr as jvh
from videorenderer_tpu.parallel import mesh as jpm

import videorenderer_tpu_torch as T
from videorenderer_tpu_torch.models import checkpoint as tck
from videorenderer_tpu_torch.models import hdr_train as thdr
from videorenderer_tpu_torch.models import sr_train as tsr
from videorenderer_tpu_torch.models import superres as tsres
from videorenderer_tpu_torch.models import videohdr as tvh
from videorenderer_tpu_torch.ops import scale as tscale
from videorenderer_tpu_torch.parallel import mesh as pm
from videorenderer_tpu_torch.pipeline import make_frame_fn, plan_pipeline

TIMEOUT_S = 90


def run_ranks(case, n, tmp_path, **kw):
    """``case`` on ``n`` gloo ranks; each rank's saved result, in order."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run,
                         args=(case, r, n, f"file://{tmp_path}/store",
                               str(tmp_path), kw)) for r in range(n)]
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
    return [torch.load(tmp_path / f"{case}_{r}.pt", weights_only=False)
            for r in range(n)]


def jax_sharded(fn, n, x):
    from jax import shard_map
    mesh = jpm.make_mesh(n)
    f = shard_map(fn, mesh=mesh, in_specs=P("data", None),
                  out_specs=P("data", None))
    return np.asarray(jax.jit(f)(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P("data", None)))))


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_blocks(tmp_path, n):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    planes = (np.arange(8 * 4 * 2, dtype=np.uint8).reshape(8, 4, 2),
              np.arange(8 * 2, dtype=np.uint16).reshape(8, 2))
    res = run_ranks("shard", n, tmp_path, x=x, planes=planes)
    k = 8 // n
    for r, got in enumerate(res):
        block = torch.from_numpy(x[r * k:(r + 1) * k])
        assert torch.equal(got["dict"]["x"], block)
        assert isinstance(got["dict"]["pair"], tuple)
        assert torch.equal(got["dict"]["pair"][1], block[:, :1])
        assert isinstance(got["tuple"], tuple)
        for p, g in zip(planes, got["tuple"]):
            assert g.dtype == torch.from_numpy(p).dtype
            assert np.array_equal(g.numpy(), p[r * k:(r + 1) * k])


@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_equals_jax(tmp_path, n):
    """tests/test_parallel.py's case: 32 x 4 rows in n shards, 2 halo rows
    each side, bit-equal to the JAX shard_map, and the edge clamp."""
    halo, hs = 2, 32 // n
    x = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    got = np.concatenate([t.numpy() for t in
                          run_ranks("halo", n, tmp_path, x=x, halo=halo)])
    want = jax_sharded(lambda v: jpm.halo_exchange(v, halo, "data"), n, x)
    assert got.shape == (n * (hs + 2 * halo), 4)
    assert np.array_equal(got, want)
    # each shard is its rows with its neighbours' (clamped at the edges)
    for r in range(n):
        rows = np.clip(np.arange(r * hs - halo, (r + 1) * hs + halo), 0, 31)
        assert np.array_equal(got[r * (hs + 2 * halo):
                                  (r + 1) * (hs + 2 * halo)], x[rows])


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_resize_rows_equals_jax(tmp_path, n):
    mat = tscale.upscale_matrix(T.Upscaling.LANCZOS3, 64, 128)
    halo = 6
    x = np.random.default_rng(n).random((64, 16)).astype(np.float32)
    got = np.concatenate([t.numpy() for t in run_ranks(
        "resize", n, tmp_path, x=x, mat=mat, halo=halo)])
    want = jax_sharded(
        lambda v: jpm.spatial_resize_rows(v, mat, halo, "data"), n, x)
    assert got.shape == want.shape == (128, 16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, mat.T @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_jit_frame_parallel_equals_one_process(tmp_path, n):
    """tests/test_parallel.py's frame-parallel case with the port's
    make_frame_fn (the kernels' plain versions on the CPU): every rank
    holds the whole batch, bit-equal to one process's."""
    w, h, b = 32, 16, 8
    src = T.SourceDescriptor(format=T.ColorFormat.NV12, width=w, height=h,
                             matrix=T.CSP.BT_709)
    dst = T.OutputDescriptor(width=w, height=h, bits=8)
    settings = T.Settings(use_dither=False)
    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (b, h, w), np.uint8),
              rng.integers(0, 256, (b, h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (b, h // 2, w // 2), np.uint8))
    ref = make_frame_fn(plan_pipeline(settings, src, dst))(
        tuple(torch.from_numpy(p) for p in planes))
    for got in run_ranks("frame", n, tmp_path, planes=planes,
                         settings=settings, src=src, dst=dst):
        assert got.shape == ref.shape and torch.equal(got, ref)


def _band(losses, ref):
    rel = np.abs(np.asarray(losses) - ref) / np.asarray(ref)
    assert rel.max() <= 0.01, rel


@pytest.mark.parametrize("kind", ["sr", "hdr"])
def test_data_parallel_train_two_ranks(tmp_path, monkeypatch, kind):
    steps, batch, lr = 10, 8, 2e-3
    key = jax.random.PRNGKey(0)
    if kind == "sr":
        jcfg = jsres.SuperResConfig(channels=16, num_blocks=1, s2d=2)
        tcfg = tsres.SuperResConfig(channels=16, num_blocks=1, s2d=2)
        data = jsr.synth_frames(5, 16, 32)
        jparams = jsres.init_params(key, jcfg)
        tmod, arrays = tsr, None
    else:
        jcfg, tcfg = jvh.VideoHDRConfig(channels=8), tvh.VideoHDRConfig(
            channels=8)
        data = jhdr.synth_hdr_frames(5, 16, 32, jcfg)
        jparams = jvh.init_params(key, jcfg)
        tmod = thdr
        # both packages train on the same SDR inputs and PQ truths
        arrays = (jhdr.degrade_to_sdr(data, jcfg),
                  jhdr.hdr_truth_pq(data, jcfg))
        monkeypatch.setattr(thdr, "degrade_to_sdr", lambda h, c: arrays[0])
        monkeypatch.setattr(thdr, "hdr_truth_pq", lambda h, c: arrays[1])
    state = tck.params_from_jax(jck._flatten(jparams), torch.float32)
    res = run_ranks("train", 2, tmp_path, kind=kind, cfg=tcfg, steps=steps,
                    batch=batch, data=data, lr=lr, state=state,
                    arrays=arrays)
    for k, v in res[0]["state"].items():
        assert v.dtype == torch.float32 and torch.equal(res[1]["state"][k], v)
    assert res[0]["losses"] == res[1]["losses"]
    model = (tsres.SuperRes if kind == "sr" else tvh.VideoHDR)(tcfg)
    model.load_state_dict(state)
    _, one = tmod.train(tcfg, steps, batch, data, seed=0, learning_rate=lr,
                        model=model, device="cpu")
    _band(res[0]["losses"], one)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("data",))
    jtrain = jsr.train if kind == "sr" else jhdr.train
    _, jl = jtrain(jcfg, steps, batch, data, seed=0, learning_rate=lr,
                   mesh=jmesh)
    _band(res[0]["losses"], jl)


def test_one_rank_mesh_equals_no_mesh():
    """A world of one started by make_mesh (gloo, a FileStore): training
    with it is bit-equal to training without; destroy() ends the group."""
    import torch.distributed as dist
    cfg = tsres.SuperResConfig(channels=8, num_blocks=1, s2d=2)
    data = tsr.synth_frames(5, 8, 32)
    model = tsres.init_params(torch.Generator().manual_seed(0), cfg)
    a, la = tsr.train(cfg, 4, 4, data, model=model, device="cpu")
    mesh = pm.make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.axis) == (0, 1, "data")
        assert dist.get_backend() == "gloo"
        b, lb = tsr.train(cfg, 4, 4, data, model=model, mesh=mesh,
                          device="cpu")
    finally:
        mesh.destroy()
    assert not dist.is_initialized()
    assert la == lb
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v)
    # the caller's model is not changed
    assert model.head.weight.dtype == torch.bfloat16


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="one process each"):
        pm.make_mesh(4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.make_mesh()
    mesh = pm.make_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="asked for in a world of 1"):
            pm.make_mesh(2, device="cpu")
        two = pm.Mesh(mesh.group, 0, 2, "data", mesh.device)
        with pytest.raises(ValueError, match="not a multiple"):
            pm.shard_batch(two, np.zeros((3, 2)))
        with pytest.raises(ValueError, match="do not split"):
            pm.spatial_resize_rows(torch.zeros(3, 4), np.zeros((6, 3)), 1,
                                   two)
        with pytest.raises(ValueError, match="not a multiple"):
            tsr.train(tsres.SuperResConfig(channels=8, num_blocks=1, s2d=2),
                      1, 3, tsr.synth_frames(1, 4, 16), mesh=two,
                      device="cpu")
    finally:
        mesh.destroy()
