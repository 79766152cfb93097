"""Multi-device scale-out over ``torch.distributed`` — the port of
``videorenderer_tpu.parallel.mesh``.

JAX runs one process over many devices; here one process drives one device,
and a :class:`Mesh` names the process group the ranks form, along one axis:

 * **data (frame) parallelism** — :func:`shard_batch` gives rank r the r-th
   contiguous block of the batch dimension (JAX's ``P(axis)``), and
   :func:`jit_frame_parallel` runs a frame function on the rank's block and
   all-gathers the result, so that every rank holds the whole batch, as a
   JAX global array reads.  The trainers' ``mesh=`` splits each step's
   batch the same way (:func:`..models.optim.fit`).
 * **spatial parallelism** — :func:`halo_exchange` extends a row-sharded
   block with halo rows from its ring neighbours (paired sends and
   receives; edge rows replicated at the global boundary), and
   :func:`spatial_resize_rows` resamples the rows of a row-sharded tensor
   from its halo-extended block.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  A default
group of the other backend is refused, never swapped.  A mesh's ranks are
the first ``size`` ranks of the default group, so a rank of the mesh is
also its global rank.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..pipeline import check_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """One axis of ``size`` processes, this one ``rank``, each on its own
    ``device``; ``group`` is their process group."""
    group: object
    rank: int
    size: int
    axis: str
    device: torch.device
    store_dir: str | None = None      # set when make_mesh started the world

    def destroy(self) -> None:
        """Destroy the mesh's group: the default group only where
        :func:`make_mesh` started it (a world of one), a subgroup always."""
        if self.store_dir is not None:
            dist.destroy_process_group()
            shutil.rmtree(self.store_dir, ignore_errors=True)
        elif self.group is not dist.group.WORLD:
            dist.destroy_process_group(self.group)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device="cuda") -> Mesh:
    """The mesh of the initialised default group (all of it, or a new group
    of its first ``n_devices`` ranks: every rank must call this), each rank
    on its own device: ``cuda:LOCAL_RANK`` (the rank where the variable is
    unset), or the CPU.  With no group initialised, a world of one is
    started from a ``FileStore`` in a temporary directory; more devices
    need one process each, started by the caller."""
    device = check_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    store_dir = None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs one "
                             "process each, with the default group "
                             "initialised in each")
        store_dir = tempfile.mkdtemp(prefix="vrt_mesh_")
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          1), rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default group runs {dist.get_backend()}; a "
                         f"mesh on {device.type} needs {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = world if n_devices is None else n_devices
    if not 1 <= size <= world:
        raise ValueError(f"{size} devices asked for in a world of {world}")
    group = (dist.group.WORLD if size == world
             else dist.new_group(list(range(size))))
    if rank >= size:
        raise ValueError(f"rank {rank} is not in the mesh of the first "
                         f"{size} ranks")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, axis, device, store_dir)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """Each (B, ...) tensor or array of ``tree`` (nested dicts, lists and
    tuples) as this rank's block of B / size rows, on the mesh's device;
    B must be a multiple of the mesh's size."""
    def put(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                             f"mesh's {mesh.size} ranks")
        k = x.shape[0] // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)
    return _tree_map(put, tree)


def _all_gather(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous(), group=mesh.group)
    return torch.cat(parts)


def jit_frame_parallel(frame_fn, mesh: Mesh):
    """``frame_fn`` over the mesh: each rank runs it on its block of the
    batch (:func:`shard_batch`), and every output tensor is all-gathered
    along dim 0, so every rank returns the whole batch's result."""
    def fn(planes):
        out = frame_fn(shard_batch(mesh, planes))
        return _tree_map(lambda y: _all_gather(y, mesh), out)
    return fn


# ---------------------------------------------------------------------------
# spatial sharding with halo exchange
# ---------------------------------------------------------------------------


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """A row-sharded block (..., Hs, W) extended with ``halo`` rows from
    each neighbour on the ring (edge-replicated at the global boundary):
    the last rows go to the next rank, the first rows to the previous."""
    if halo == 0:
        return x
    n, r = mesh.size, mesh.rank
    send_down = x[..., -halo:, :].contiguous()
    send_up = x[..., :halo, :].contiguous()
    from_prev, from_next = torch.empty_like(send_down), torch.empty_like(
        send_up)
    if n > 1:
        nxt, prv = (r + 1) % n, (r - 1) % n
        ops = [dist.P2POp(dist.isend, send_down, nxt, mesh.group, tag=0),
               dist.P2POp(dist.irecv, from_prev, prv, mesh.group, tag=0),
               dist.P2POp(dist.isend, send_up, prv, mesh.group, tag=1),
               dist.P2POp(dist.irecv, from_next, nxt, mesh.group, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    edge = (*x.shape[:-2], halo, x.shape[-1])
    top = x[..., :1, :].expand(edge) if r == 0 else from_prev
    bottom = x[..., -1:, :].expand(edge) if r == n - 1 else from_next
    return torch.cat([top, x, bottom], dim=-2)


def spatial_resize_rows(x: torch.Tensor, mat_full: np.ndarray, halo: int,
                        mesh: Mesh) -> torch.Tensor:
    """Row-axis resize of a row-sharded tensor (..., H_in / size, W): the
    rank's slice of output rows from its halo-extended input rows.
    ``mat_full``: the (H_in, H_out) global weight matrix; H_in and H_out
    must be multiples of the mesh's size.  The rank's band of it (rows of
    the halo outside the frame zero) is one matrix product."""
    n, r = mesh.size, mesh.rank
    h_in, h_out = mat_full.shape
    if h_in % n or h_out % n:
        raise ValueError(f"{h_in} -> {h_out} rows do not split over "
                         f"{n} ranks")
    hs_in, hs_out = h_in // n, h_out // n
    ext = halo_exchange(x, halo, mesh)       # (..., hs_in + 2 halo, W)
    rows = np.arange(r * hs_in - halo, (r + 1) * hs_in + halo)
    inside = (rows >= 0) & (rows < h_in)
    band = np.zeros((rows.size, hs_out))
    band[inside] = mat_full[rows[inside], r * hs_out:(r + 1) * hs_out]
    m = torch.as_tensor(band, dtype=x.dtype, device=x.device)
    return torch.matmul(ext.movedim(-2, -1), m).movedim(-1, -2)
