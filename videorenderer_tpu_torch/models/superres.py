"""Learned super-resolution — the "SuperRes" slot of the fixed-function VP;
the inference half of ``videorenderer_tpu.models.superres``.

The reference enables vendor super-resolution blocks (NVIDIA SuperRes GUID /
Intel VPE, Source/D3D11VP.cpp:712-844) gated by source size per the
``SUPERRES_*`` setting.  Here the model is explicit: an ESPCN-style residual
conv net in a ``s2d``x space-to-depth domain with pixel-shuffle upsampling,
predicting a residual over the nearest-upsampled frame, in bfloat16.

The parameters are those of the JAX model, flattened under the same keys
(:mod:`.checkpoint`), so the shipped ``weights/superres_2x.npz`` loads in
both packages.  The model holds its weights in the channel order of
``pixel_unshuffle`` / ``pixel_shuffle``; the checkpoint loader permutes
the JAX order into it once.

Training: :func:`apply_fn` and its channels-first form :func:`apply_fn_chw`
are differentiable (the inference hook :func:`enhance_plane_chw` is the
same arithmetic under ``no_grad``), and
:func:`loss_fn`, :func:`sgd_train_step` and :func:`init_opt_state` are the
JAX package's; the Adam trainer is :func:`.sr_train.train`.  A model whose
parameters are float32 (the trainers' master weights) still computes in
``cfg.dtype``: :func:`conv` casts each weight to the activations' dtype.

Size gating mirrors SetSuperRes (Source/D3D11VP.cpp:804-844): a level only
engages when the source is at most the level's resolution class and the
target is larger.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SuperResolution
from .optim import value_and_grad

# max source size per gating level (Source/D3D11VP.cpp:806-836 classes)
_GATE_LIMITS = {
    SuperResolution.SD: (1024, 576),
    SuperResolution.P720: (1280, 720),
    SuperResolution.P1080: (1920, 1080),
    SuperResolution.P1440: (2560, 1440),
}


def superres_engages(level: SuperResolution, src_w: int, src_h: int,
                     dst_w: int, dst_h: int) -> bool:
    """Size gate: level covers the source size AND we are upscaling."""
    if level == SuperResolution.DISABLE:
        return False
    lw, lh = _GATE_LIMITS[level]
    return src_w <= lw and src_h <= lh and (dst_w > src_w or dst_h > src_h)


@dataclass(frozen=True)
class SuperResConfig:
    """The JAX model's shape: the conv stack runs on a ``s2d``x
    space-to-depth grid (1080p -> 270 x 480) with ``channels``-wide
    activations, and the tail pixel-shuffles by ``scale * s2d`` straight
    back to output resolution.  ``dtype``: activations and weights (the
    JAX config's bfloat16)."""
    channels: int = 128
    num_blocks: int = 4
    scale: int = 2           # output upscale factor
    s2d: int = 4             # space-to-depth factor for the conv domain
    dtype: torch.dtype = torch.bfloat16


@contextlib.contextmanager
def exact_convs():
    """cuDNN without TF32 for the enclosed convs, so that a float32 config
    computes in float32 (the default lets cuDNN round float32 convs'
    operands to TF32); the other cuDNN flags stay as they are."""
    b = torch.backends.cudnn
    with b.flags(enabled=b.enabled, benchmark=b.benchmark,
                 deterministic=b.deterministic, allow_tf32=False):
        yield


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """3x3 'same' conv in ``x``'s dtype, then the bias added in that dtype
    (the JAX ``_conv``: the conv rounds, then the bias add rounds)."""
    w, b = layer.weight, layer.bias
    if w.device != x.device:
        raise RuntimeError(f"model weights on {w.device}, input on "
                           f"{x.device}: move the model first")
    return F.conv2d(x, w.to(x.dtype), padding=1) + b.to(x.dtype)[:, None, None]


def pad_to_grid(x: torch.Tensor, k: int) -> torch.Tensor:
    """Edge-pad the last two axes up to multiples of ``k``."""
    ph, pw = (-x.shape[-2]) % k, (-x.shape[-1]) % k
    if not (ph or pw):
        return x
    lead = x.shape[:-3]
    y = F.pad(x.reshape((-1,) + x.shape[-3:]), (0, pw, 0, ph),
              mode="replicate")
    return y.reshape(lead + y.shape[-3:])


def conv3x3(cin: int, cout: int, dtype: torch.dtype) -> nn.Conv2d:
    """A 3x3 conv layer made without the default initialisation (which
    would draw from the global generator): uninitialised, on the CPU."""
    return nn.Conv2d(cin, cout, 3, padding=1, device="meta",
                     dtype=dtype).to_empty(device="cpu")


class _Block(nn.Module):
    def __init__(self, ch: int, dtype: torch.dtype):
        super().__init__()
        self.c1 = conv3x3(ch, ch, dtype)
        self.c2 = conv3x3(ch, ch, dtype)


class SuperRes(nn.Module):
    """Head (3 s2d^2 -> channels), ``num_blocks`` residual blocks of two
    3x3 convs, tail (channels -> 3 (scale s2d)^2), all 3x3 with padding 1;
    parameters in ``cfg.dtype``, zero until :func:`init_params` or
    :func:`~.checkpoint.load_params` fills them."""

    def __init__(self, cfg: SuperResConfig = SuperResConfig()):
        super().__init__()
        self.cfg = cfg
        k, kk = cfg.s2d, cfg.scale * cfg.s2d
        self.head = conv3x3(3 * k * k, cfg.channels, cfg.dtype)
        self.body = nn.ModuleList(_Block(cfg.channels, cfg.dtype)
                                  for _ in range(cfg.num_blocks))
        self.tail = conv3x3(cfg.channels, 3 * kk * kk, cfg.dtype)
        self.requires_grad_(False)
        for p in self.parameters():
            p.zero_()


def init_params(generator: torch.Generator,
                cfg: SuperResConfig = SuperResConfig()) -> SuperRes:
    """He-init conv stack (normal, std sqrt(2 / (9 cin)), zero biases) with
    the tail exactly zero, as the JAX ``init_params``: the residual starts
    at zero, so an untrained net IS the nearest-upsampled base."""
    model = SuperRes(cfg)
    for name, layer in model.named_modules():
        if isinstance(layer, nn.Conv2d) and name != "tail":
            he_init(layer, generator)
    return model


def he_init(layer: nn.Conv2d, generator: torch.Generator) -> None:
    """Weights drawn normal with std sqrt(2 / (9 cin)) in float32, then
    rounded to the layer's dtype."""
    w = layer.weight
    w.copy_(torch.randn(w.shape, generator=generator)
            * float(np.sqrt(2.0 / (9 * w.shape[1]))))


def row_valid_mask(hh: int, row_valid, dtype: torch.dtype,
                   device) -> torch.Tensor | None:
    """(hh, 1) 0/1 mask of the s2d-grid rows inside ``row_valid=(lo, hi)``
    (the block's own rows), or None without bounds (the JAX
    ``_row_valid_mask``).  The spatially sharded path
    (``parallel/spatial.make_spatial_learned_fn``) zeroes each conv's
    output rows outside the frame with it, which gives the whole frame's
    zero padding at the frame's edges layer by layer: without it, halo
    rows outside the frame carry relu(bias) activations that the whole
    frame never has, and the edge shards drift."""
    if row_valid is None:
        return None
    lo, hi = row_valid
    r = torch.arange(hh, device=device)
    return ((r >= lo) & (r < hi)).to(dtype)[:, None]


def _trunk(model: SuperRes, h0: torch.Tensor,
           row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Head + residual body + tail on s2d-grid features (N, C, hh, ww);
    ``row_mask`` (:func:`row_valid_mask`) zeroes the head's, each block's
    and each residual's rows outside the frame."""
    mk = (lambda a: a) if row_mask is None else (lambda a: a * row_mask)
    h = mk(torch.relu(conv(h0, model.head)))
    for blk in model.body:
        r = mk(torch.relu(conv(h, blk.c1)))
        h = h + mk(conv(r, blk.c2))
    return conv(h, model.tail)


def _enhance(model: SuperRes, rgb_chw: torch.Tensor,
             row_valid=None) -> torch.Tensor:
    """The model's function, differentiable: (..., 3, H, W) float in
    [0, 1] -> (..., 3, H s, W s) float32.  Space-to-depth by ``s2d``, the
    trunk, depth-to-space by ``scale s2d``, plus the nearest-upsampled base
    (added in the model's dtype).  Sizes that are not multiples of ``s2d``
    are edge-padded to the grid and cropped.  ``row_valid``: the frame's
    (lo, hi) s2d rows for the sharded path (:func:`row_valid_mask`)."""
    cfg = model.cfg
    k, s = cfg.s2d, cfg.scale
    lead, (in_h, in_w) = rgb_chw.shape[:-3], rgb_chw.shape[-2:]
    x = pad_to_grid(rgb_chw.reshape((-1,) + rgb_chw.shape[-3:]), k)
    x = x.to(cfg.dtype)
    n, _, hp, wp = x.shape
    row_mask = row_valid_mask(hp // k, row_valid, cfg.dtype, x.device)
    with exact_convs():
        res = _trunk(model, F.pixel_unshuffle(x, k) if k > 1 else x,
                     row_mask)
    res = F.pixel_shuffle(res, s * k)                # (n, 3, hp s, wp s)
    # the nearest-upsampled base, added by broadcasting
    out = (res.view(n, 3, hp, s, wp, s) + x.view(n, 3, hp, 1, wp, 1)) \
        .view(n, 3, hp * s, wp * s).float()
    return out[..., :in_h * s, :in_w * s].reshape(
        lead + (3, in_h * s, in_w * s))


@torch.no_grad()
def enhance_plane_chw(model: SuperRes, rgb_chw: torch.Tensor,
                      row_valid=None) -> torch.Tensor:
    """Pipeline hook: (..., 3, H, W) float in [0, 1] -> (..., 3, H s, W s)
    float32 — the function of the JAX ``enhance_plane_chw`` (the model's
    function without a graph).  ``row_valid``: optional (lo, hi) s2d-row
    frame bounds for the sharded path (:func:`row_valid_mask`)."""
    return _enhance(model, rgb_chw, row_valid)


def apply_fn(model: SuperRes, lr_rgb: torch.Tensor) -> torch.Tensor:
    """lr_rgb: (N, H, W, 3) in [0, 1] -> (N, H scale, W scale, 3) float32,
    the NHWC form of :func:`enhance_plane_chw` (the JAX ``apply_fn``);
    differentiable in the model's parameters."""
    return _enhance(model, lr_rgb.movedim(-1, -3)).movedim(-3, -1)


def apply_fn_chw(model: SuperRes, rgb_chw: torch.Tensor,
                 row_valid=None) -> torch.Tensor:
    """(N, 3, H, W) in [0, 1] -> (N, 3, H scale, W scale) float32: the
    channels-first form of :func:`apply_fn` (the JAX ``apply_fn_chw``,
    whose tail-conv fold of the base and bias rounds once where this, like
    ``apply_fn``, rounds twice: within 2 bf16 ulps of it);
    differentiable in the model's parameters.  ``row_valid``: as
    :func:`enhance_plane_chw`'s."""
    return _enhance(model, rgb_chw, row_valid)


def charbonnier(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Charbonnier loss (smooth L1), ``mean(sqrt(d^2 + eps^2))`` with eps
    1e-3, as the JAX ``loss_fn``s compute it."""
    eps = 1e-3
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def loss_fn(model: SuperRes, lr: torch.Tensor, hr: torch.Tensor
            ) -> torch.Tensor:
    """Charbonnier loss of :func:`apply_fn` against HR (N, H s, W s, 3) —
    standard for SR training."""
    return charbonnier(apply_fn(model, lr), hr)


def init_opt_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """Float32 zeros for each parameter: the momentum of
    :func:`sgd_train_step`."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in model.named_parameters()}


def sgd_train_step(model: SuperRes, opt_state: dict, lr_batch: torch.Tensor,
                   hr_batch: torch.Tensor, learning_rate: float = 1e-3):
    """One momentum-SGD step (momentum 0.9, float32), in place: each
    parameter keeps its dtype, rounded once from the float32 update, as the
    JAX ``sgd_train_step``.  Returns (model, opt_state, loss) with the loss
    before the step."""
    loss, grads = value_and_grad(loss_fn, model, lr_batch, hr_batch)
    with torch.no_grad():
        for (name, p), g in zip(model.named_parameters(), grads):
            m = 0.9 * opt_state[name] + g.float()
            opt_state[name] = m
            p.copy_(p.float() - learning_rate * m)
    return model, opt_state, loss
