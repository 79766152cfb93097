"""Model parameter checkpoints — the port of
``videorenderer_tpu.models.checkpoint``, on the same files.

A checkpoint is a plain ``.npz`` of float32 arrays keyed by the JAX
parameter pytree's paths (``head/w``, ``body/0/c1/b``, ``tail/w``, ...;
conv weights HWIO).  A model of this package keeps the same layers under
the ``state_dict`` keys ``head.weight``, ``body.0.c1.bias``, ...  (conv
weights OIHW): :func:`params_from_jax` and :func:`params_to_jax` convert
between the two, so the JAX package and this one load the same files and
can be given the same parameters.

The conversion also reorders the channels that meet a space-to-depth of
RGB.  The JAX models order them (di, dj, c) on the way in and (d, e, c) on
the way out; ``pixel_unshuffle`` and ``pixel_shuffle`` order them
(c, di, dj) and (c, d, e).  This module is the only one that knows the
JAX order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

_LEAF = {"w": "weight", "b": "bias"}
_KEY = {v: k for k, v in _LEAF.items()}
# layers whose input channels are a space-to-depth of RGB (SuperRes' head,
# VideoHDR's first conv) and whose output channels are a depth-to-space
# of RGB (SuperRes' tail; VideoHDR's last conv has one output channel,
# already in pixel_shuffle's order)
_S2D_IN = ("head", "c1")
_S2D_OUT = ("tail",)


def s2d_order(n: int) -> torch.Tensor:
    """For each of the ``n`` = 3 k^2 channels of ``pixel_unshuffle(x, k)``
    of an RGB x, (c, di, dj), the JAX space-to-depth channel (di, dj, c)
    it is; the same map takes the JAX depth-to-space order (d, e, c) to
    ``pixel_shuffle``'s."""
    k = math.isqrt(n // 3)
    if 3 * k * k != n:
        raise ValueError(f"{n} channels are not a space-to-depth of RGB")
    c, di, dj = np.meshgrid(np.arange(3), np.arange(k), np.arange(k),
                            indexing="ij")
    return torch.from_numpy(((di * k + dj) * 3 + c).reshape(-1))


def _reorder(name: str, t: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``t``, the weight or bias of layer ``name`` in the JAX channel
    order, in the shuffles' order (or back, when ``inverse``)."""
    layer, leaf = name.rsplit(".", 1)
    for dim, layers in ((1, _S2D_IN), (0, _S2D_OUT)):
        if layer in layers and (leaf == "weight" or dim == 0):
            idx = s2d_order(t.shape[dim])
            t = t.index_select(dim, torch.argsort(idx) if inverse else idx)
    return t


def params_from_jax(flat: dict, dtype: torch.dtype = torch.bfloat16
                    ) -> dict[str, torch.Tensor]:
    """Flat JAX parameters (path -> array, HWIO conv weights) -> a
    ``state_dict`` (OIHW conv weights, the shuffles' channel order) in
    ``dtype``."""
    out = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        name = ".".join(path + [_LEAF[leaf]])
        t = torch.tensor(np.asarray(arr, np.float32))
        if leaf == "w":
            t = t.permute(3, 2, 0, 1)
        out[name] = _reorder(name, t, False).contiguous().to(dtype)
    return out


def params_to_jax(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: float32 numpy arrays (numpy
    has no bfloat16), HWIO conv weights, under the JAX paths."""
    out = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = _reorder(key, t.detach().float().cpu(), True)
        if leaf == "weight":
            a = a.permute(2, 3, 1, 0)
        out["/".join(path + [_KEY[leaf]])] = a.contiguous().numpy()
    return out


def save_params(path: str, model: nn.Module) -> None:
    np.savez(path, **params_to_jax(model.state_dict()))


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load a checkpoint into ``model`` (its keys and shapes validated, the
    values rounded to the model's dtype); returns the model."""
    data = np.load(path)
    like = params_to_jax(model.state_dict())
    if set(data.files) != set(like):
        missing = set(like) - set(data.files)
        extra = set(data.files) - set(like)
        raise ValueError(f"checkpoint mismatch: missing={missing} "
                         f"extra={extra}")
    for key in sorted(like):          # the JAX pytree's order
        leaf = like[key]
        if data[key].shape != leaf.shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{data[key].shape} vs {leaf.shape}")
    model.load_state_dict(params_from_jax({k: data[k] for k in like},
                                          dtype=torch.float32))
    return model
