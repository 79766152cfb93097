"""The rank side of tests/test_torch_spatial.py and
tests/test_torch_spatial_learned.py: each rank of a gloo group on the CPU
runs every case of its list, one after another, and saves what the tests
compare (its rows, the all-gathered surface, and on rank 0 the one-rank
output of the same plan, made in the same single-threaded process).  This
module imports no JAX, so that the ranks start quickly."""

import torch
import torch.distributed as dist

from videorenderer_tpu_torch.parallel import mesh as pm
from videorenderer_tpu_torch.parallel import spatial as sp
from videorenderer_tpu_torch.pipeline import plan_pipeline


def _rows_and_one(mesh, plan, build, planes):
    rows = build(mesh)(sp.pad_shard_planes_rows(plan, mesh, planes))
    out = {"rows": rows, "gathered": sp.gather_rows(mesh, rows)}
    if mesh.rank == 0:
        one = sp.Shard(0, 1)
        out["one"] = build(one)(sp.pad_shard_planes_rows(plan, one, planes))
    return out


def frame(mesh, settings, src, dst, planes, pack=False, unsharded=False):
    """``unsharded``: rank 0 also makes the one-device frame function's
    output on the kernel route (``pipeline._on_card`` true: the kernels'
    plain versions, as the card takes the kernels)."""
    from videorenderer_tpu_torch import pipeline
    plan = plan_pipeline(settings, src, dst)
    out = _rows_and_one(
        mesh, plan,
        lambda m: sp.make_spatial_frame_fn(plan, m, pack_surface=pack),
        planes)
    if unsharded and mesh.rank == 0:
        on_card, pipeline._on_card = pipeline._on_card, lambda p: True
        try:
            out["unsharded"] = pipeline.make_frame_fn(
                plan, pack_surface=pack)(tuple(torch.as_tensor(p)
                                               for p in planes))
        finally:
            pipeline._on_card = on_card
    return out


def learned(mesh, kind, cfg, state, settings, src, dst, planes, pack=False):
    from videorenderer_tpu_torch.models.superres import SuperRes
    from videorenderer_tpu_torch.models.videohdr import VideoHDR
    model = (SuperRes if kind == "superres" else VideoHDR)(cfg)
    model.load_state_dict(state)
    plan = plan_pipeline(settings, src, dst)
    return _rows_and_one(
        mesh, plan,
        lambda m: sp.make_spatial_learned_fn(plan, m, model, kind,
                                             pack_surface=pack),
        planes)


def halo(mesh, x, rows):
    return pm.halo_exchange(sp.shard_planes_rows(mesh, (x,))[0], rows, mesh)


KINDS = {"frame": frame, "learned": learned, "halo": halo}


def run(cases, rank, size, init, out):
    """``cases``: (name, kind, kwargs) triples; saves {name: result}."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        mesh = pm.make_mesh(axis="spatial", device="cpu")
        assert (mesh.rank, mesh.size) == (rank, size)
        torch.save({name: KINDS[kind](mesh, **kw) for name, kind, kw in cases},
                   f"{out}/spatial_{rank}.pt")
        # no rank leaves before every rank has joined: a rank that exits
        # while another is still connecting to it fails that one's init
        dist.barrier()
    finally:
        dist.destroy_process_group()
