"""The trainers' optimiser: ``optax.adam`` under optax's piecewise-constant
learning-rate schedule, with float32 master weights, and the loop both
trainers (:func:`.sr_train.train`, :func:`.hdr_train.train`) run, data
parallel over a :class:`~videorenderer_tpu_torch.parallel.mesh.Mesh`.

The arithmetic is optax's as XLA compiles the JAX trainers' jitted step,
so that the same gradients move the same float32 parameters alike in both
packages: the moments ``(1 - b) g^k + b m`` in float32 with the first
product fused into the add, the bias corrections ``1 - b^t`` of the
incremented count in double precision rounded once to float32,
``u = m / (bc1 (sqrt(v / bc2) + eps))`` (XLA folds optax's
``(m / bc1) / (sqrt(v / bc2) + eps)`` so), then ``p + u (-lr_t)`` as one
fused multiply-add.  Each of the three emulations (the fused adds, the
correctly rounded sqrt) is needed to stay within 2 float32 ulps of the
jitted optax step on the same gradients: plain float32 in optax's order
lands up to 3224 ulps off over 10 steps, and leaving out the moments'
fused adds, the sqrt's float64 or the update's fused add alone up to 2362,
33 and 8184 ulps (``report()`` in ``tests/test_torch_train.py``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..pipeline import check_device

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults (eps_root 0)


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict[int, float]):
    """``optax.piecewise_constant_schedule`` as a plain function of the
    0-based update index: ``init_value`` times every scale whose boundary
    the index has reached.  Boundaries are dict keys, so two equal ones
    given in a dict literal are one (the trainers' schedule at 1 or 2
    steps decays once)."""
    items = sorted(boundaries_and_scales.items())
    if any(scale < 0.0 for _, scale in items):
        raise ValueError("piecewise_constant_schedule expects non-negative "
                         "scale factors")

    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in items:
            if count >= boundary:
                v = scale * v
        return v

    return schedule


def lr_schedule(steps: int, learning_rate: float, lr_decay: float):
    """The trainers' schedule: ``lr_decay`` at 60% and again at 85% of
    ``steps`` (the JAX trainers' dict literal)."""
    return piecewise_constant_schedule(
        learning_rate, {int(steps * 0.6): lr_decay,
                        int(steps * 0.85): lr_decay})


class Adam(torch.optim.Optimizer):
    """``optax.adam(schedule)`` (B1, B2, EPS; eps_root 0): float32 first
    and second moments, bias corrections from the incremented count, the
    update ``-schedule(count) m_hat / (sqrt(v_hat) + EPS)`` added to each
    parameter.  :meth:`step` reads each parameter's ``grad``."""

    def __init__(self, params, schedule):
        super().__init__(params, {})
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            corr = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.device not in corr:
                    # device scalars: a true division (CUDA divides by a
                    # host scalar through its reciprocal)
                    corr[p.device] = tuple(
                        torch.full((), 1.0 - b ** self.count,
                                   dtype=torch.float32, device=p.device)
                        for b in (B1, B2))
                bc1, bc2 = corr[p.device]
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad.float()
                mu = _fma(g, 1 - B1, B1 * state["mu"])
                nu = _fma(g * g, 1 - B2, B2 * state["nu"])
                state["mu"], state["nu"] = mu, nu
                # float32's sqrt correctly rounded from float64's (torch's
                # vectorised float32 sqrt on the CPU is not)
                root = torch.sqrt((nu / bc2).double()).float()
                p.copy_(_fma(mu / (bc1 * (root + EPS)), -lr, p))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a b + c`` for float32 ``a``, ``c`` and ``b`` rounded to float32,
    with one rounding: the product is exact in float64."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def value_and_grad(loss_fn, model: nn.Module, *args):
    """``loss_fn(model, *args)`` and its gradient in each of the model's
    parameters (``model.parameters()`` order), as ``jax.value_and_grad``;
    the parameters' ``requires_grad`` is left as it was."""
    params = list(model.parameters())
    flags = [p.requires_grad for p in params]
    with torch.enable_grad():
        try:
            for p in params:
                p.requires_grad_(True)
            loss = loss_fn(model, *args)
            grads = torch.autograd.grad(loss, params)
        finally:
            for p, flag in zip(params, flags):
                p.requires_grad_(flag)
    return loss.detach(), grads


def fit(model: nn.Module, loss_fn, inputs: np.ndarray, targets: np.ndarray,
        steps: int, batch: int, seed: int, learning_rate: float,
        lr_decay: float, mesh, log_every: int, device):
    """Adam on float32 master weights (a copy of ``model``; the model still
    computes in its config's dtype) over ``steps`` batches of ``batch``
    (inputs, targets) pairs; returns (model, losses).

    The data go to the device once.  Step s takes the indices
    ``rng.integers(0, n, batch)`` of ``np.random.default_rng(seed + 1)``,
    the JAX trainers' batches.  With ``mesh`` (one process per device, the
    data parallel layout of the JAX trainers' mesh) each rank takes its
    contiguous block of the batch; the float32 gradients are summed over
    the ranks and divided by their number before the same Adam step on
    every rank, so the parameters stay replicated; the loss is the mean
    over the ranks.  The losses stay on the device until the end."""
    device = check_device(device)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"mesh on {mesh.device}, training on {device}")
        if batch % mesh.size:
            raise ValueError(f"batch {batch} is not a multiple of the "
                             f"mesh's {mesh.size} ranks")
        device = mesh.device
    x = torch.tensor(inputs, device=device)
    y = torch.tensor(targets, device=device)
    model = copy.deepcopy(model).to(device=device, dtype=torch.float32)
    model.requires_grad_(False)
    step = train_step(model, loss_fn,
                      Adam(model.parameters(),
                           lr_schedule(steps, learning_rate, lr_decay)),
                      mesh)
    rng = np.random.default_rng(seed + 1)
    n = inputs.shape[0]
    idx = torch.tensor(np.array([rng.integers(0, n, batch)
                                 for _ in range(steps)],
                                np.int64).reshape(steps, batch),
                       device=device)
    lo, hi = 0, batch
    if mesh is not None:
        lo = mesh.rank * (batch // mesh.size)
        hi = lo + batch // mesh.size
    losses = []
    for s in range(steps):
        ib = idx[s, lo:hi]
        loss = step(x[ib], y[ib])
        if log_every and (s % log_every == 0 or s == steps - 1):
            print(f"step {s:5d}  loss {loss.item():.5f}", flush=True)
        losses.append(loss)
    for p in model.parameters():
        p.grad = None
    return model, torch.stack(losses).tolist() if losses else []


def train_step(model: nn.Module, loss_fn, opt: torch.optim.Optimizer,
               mesh=None):
    """One step of :func:`fit`'s loop as a function of a batch (inputs,
    targets): the loss and the gradients (over ``mesh``, their float32 sum
    over the ranks divided by their number, and the mean loss), then
    ``opt``'s step.  Returns the loss, on the device."""
    params = list(model.parameters())

    def step(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        loss, grads = value_and_grad(loss_fn, model, xb, yb)
        if mesh is not None:
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss[None]])
            dist.all_reduce(flat, group=mesh.group)
            flat = flat / mesh.size
            loss = flat[-1]
            grads = flat[:-1].split([p.numel() for p in params])
        for p, g in zip(params, grads):
            p.grad = g.view(p.shape)
        opt.step()
        return loss

    return step
