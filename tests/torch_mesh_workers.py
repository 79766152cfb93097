"""The rank side of tests/test_torch_mesh.py: each case runs in one
process of a gloo group on the CPU and saves what the test compares.
This module imports no JAX, so that the ranks start quickly."""

import torch
import torch.distributed as dist

from videorenderer_tpu_torch.parallel import mesh as pm


def shard(mesh, x, planes):
    return {"dict": pm.shard_batch(mesh, {"x": x, "pair": (x, x[:, :1])}),
            "tuple": pm.shard_batch(mesh, planes)}


def halo(mesh, x, halo):
    return pm.halo_exchange(pm.shard_batch(mesh, x), halo, mesh)


def resize(mesh, x, mat, halo):
    # rows are dim -2: shard a (H, W) frame's rows as the batch of shard_batch
    return pm.spatial_resize_rows(pm.shard_batch(mesh, x), mat, halo, mesh)


def frame(mesh, planes, settings, src, dst):
    from videorenderer_tpu_torch.pipeline import make_frame_fn, plan_pipeline
    fn = make_frame_fn(plan_pipeline(settings, src, dst))
    return pm.jit_frame_parallel(fn, mesh)(tuple(torch.as_tensor(p)
                                                 for p in planes))


def train(mesh, kind, cfg, steps, batch, data, lr, state, arrays=None):
    if kind == "sr":
        from videorenderer_tpu_torch.models import sr_train as t
        from videorenderer_tpu_torch.models.superres import SuperRes as M
    else:
        from videorenderer_tpu_torch.models import hdr_train as t
        from videorenderer_tpu_torch.models.videohdr import VideoHDR as M
        if arrays is not None:          # the test's SDR inputs and truths
            t.degrade_to_sdr = lambda h, c: arrays[0]
            t.hdr_truth_pq = lambda h, c: arrays[1]
    model = M(cfg)
    model.load_state_dict(state)
    model, losses = t.train(cfg, steps, batch, data, seed=0,
                            learning_rate=lr, mesh=mesh, model=model,
                            device="cpu")
    return {"losses": losses, "state": model.state_dict()}


CASES = {"shard": shard, "halo": halo, "resize": resize, "frame": frame,
         "train": train}


def run(case, rank, size, init, out, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        mesh = pm.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (rank, size,
                                                            "cpu")
        torch.save(CASES[case](mesh, **kw), f"{out}/{case}_{rank}.pt")
        # no rank leaves before every rank has joined: a rank that exits
        # while another is still connecting to it fails that one's init
        dist.barrier()
    finally:
        dist.destroy_process_group()
