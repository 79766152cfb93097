"""VideoHDR training: synthetic HDR scenes, the training loop and the
PQ-PSNR gate — the port of ``videorenderer_tpu.models.hdr_train``.

The objective is round-trip consistency against the framework's own tone
mapper: HDR scenes in linear nits are tone-mapped to SDR with the
pipeline's BT.2390 EETF + gamma encode, and the gain net must recover the
original HDR from that SDR, scored in PQ space.

 * :func:`synth_hdr_frames` — procedural HDR content (numpy, equal to the
   JAX package's for the same seed): a diffuse SDR-range base plus
   specular highlights, bright sky bands and emissive glyphs;
 * :func:`degrade_to_sdr` — HDR nits -> SDR sRGB via ``ops.tonemap.bt2390``
   + ``transfer.linear_to_srgb_like``;
 * :func:`hdr_truth_pq` — the true PQ/BT.2020 encoding;
 * :func:`loss_fn`, :func:`train` — Charbonnier in PQ, Adam with float32
   master weights (:mod:`.optim`), optionally data parallel over a mesh
   of processes, as :func:`.sr_train.train`;
 * :func:`evaluate_pq_psnr` — PQ-domain PSNR of the net vs the
   deterministic inverse-Reinhard base.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import csputils
from ..ops import tonemap, transfer
from .optim import fit
from .sr_train import psnr, synth_frames
from .superres import charbonnier
from .videohdr import VideoHDR, VideoHDRConfig, apply_fn, init_params


# ---------------------------------------------------------------- data

def synth_hdr_frames(seed: int, n: int, size: int,
                     cfg: VideoHDRConfig = VideoHDRConfig()) -> np.ndarray:
    """(n, size, size, 3) float32 linear-light frames in BT.709 primaries,
    absolute nits in [0, cfg.peak_nits].  Diffuse content sits in the SDR
    range (<= cfg.sdr_nits); highlights reach the peak."""
    rng = np.random.default_rng(seed)
    base = synth_frames(seed=seed + 1, n=n, size=size)       # [0,1] diffuse
    out = base * cfg.sdr_nits
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:      # specular highlights: small bright gaussians
            for _ in range(rng.integers(2, 7)):
                cx, cy = rng.uniform(0, 1, 2)
                sig = rng.uniform(0.01, 0.08)
                amp = rng.uniform(0.3, 1.0) * cfg.peak_nits
                g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig * sig))
                tint = rng.uniform(0.7, 1.0, 3)
                out[i] += amp * g[..., None] * tint
        elif kind == 1:    # bright sky band (smooth vertical gradient)
            top = rng.uniform(0.3, 1.0) * cfg.peak_nits
            frac = rng.uniform(0.2, 0.6)
            band = np.clip(1.0 - yy / frac, 0.0, 1.0) ** 2
            tint = rng.uniform(0.8, 1.0, 3)
            out[i] += top * band[..., None] * tint
        else:              # emissive rectangles (signage/OSD-like)
            for _ in range(rng.integers(2, 8)):
                w = int(rng.integers(2, size // 4))
                h = int(rng.integers(2, size // 4))
                x0 = int(rng.integers(0, size - w))
                y0 = int(rng.integers(0, size - h))
                out[i, y0:y0 + h, x0:x0 + w] += \
                    rng.uniform(0.2, 1.0, 3) * cfg.peak_nits
    return np.clip(out, 0.0, cfg.peak_nits).astype(np.float32)


def degrade_to_sdr(hdr_nits: np.ndarray,
                   cfg: VideoHDRConfig = VideoHDRConfig()) -> np.ndarray:
    """HDR linear nits -> SDR sRGB [0,1] through the framework's own
    BT.2390 EETF (hue-preserving roll-off to the SDR white level) and
    gamma encode — the same math the pipeline's HDR->SDR path runs."""
    p = tonemap.HDRParams(mastering_max_nits=cfg.peak_nits,
                          max_cll=cfg.peak_nits,
                          display_max_nits=cfg.sdr_nits)
    sdr_nits = tonemap.bt2390(torch.from_numpy(hdr_nits), p, axis=-1)
    lin = torch.clamp(sdr_nits / cfg.sdr_nits, 0.0, 1.0)
    return transfer.linear_to_srgb_like(lin).numpy().astype(np.float32)


def hdr_truth_pq(hdr_nits: np.ndarray,
                 cfg: VideoHDRConfig = VideoHDRConfig()) -> np.ndarray:
    """Ground-truth PQ/BT.2020 encoding of BT.709-primaries linear nits
    (the net's output domain, matching ``videohdr.inverse_tonemap_base``)."""
    gm = np.asarray(csputils.gamut_conversion_matrix(
        csputils.Primaries.BT_709, csputils.Primaries.BT_2020), np.float32)
    x = np.maximum(hdr_nits @ gm.T, 0.0)
    return transfer.linear_to_st2084(torch.from_numpy(x), 10000.0) \
        .numpy().astype(np.float32)


# ---------------------------------------------------------------- training

def loss_fn(model: VideoHDR, sdr: torch.Tensor, pq_truth: torch.Tensor
            ) -> torch.Tensor:
    """Charbonnier in PQ space (the output/perceptual domain)."""
    return charbonnier(apply_fn(model, sdr), pq_truth)


def train(cfg: VideoHDRConfig, steps: int, batch: int, hdr_nits: np.ndarray,
          seed: int = 0, learning_rate: float = 1e-3, lr_decay: float = 0.3,
          mesh=None, log_every: int = 0, model: VideoHDR | None = None,
          device="cuda") -> tuple[VideoHDR, list[float]]:
    """Adam with float32 master weights on ``device``; returns (model,
    losses).  The SDR inputs and PQ truths are made on the host once;
    ``model``, ``mesh`` and the schedule as :func:`.sr_train.train`."""
    if model is None:
        model = init_params(torch.Generator().manual_seed(seed), cfg)
    return fit(model, loss_fn, degrade_to_sdr(hdr_nits, cfg),
               hdr_truth_pq(hdr_nits, cfg), steps, batch, seed,
               learning_rate, lr_decay, mesh, log_every, device)


# ---------------------------------------------------------------- evaluation

@torch.no_grad()
def evaluate_pq_psnr(model: VideoHDR,
                     hdr_val: np.ndarray) -> tuple[float, float]:
    """(net PQ-PSNR, deterministic-base PQ-PSNR) against the true HDR on
    held-out frames.  Both run the full apply path on the model's device;
    the base is the zero-initialized net (exactly ``inverse_tonemap_base``)."""
    cfg, dev = model.cfg, model.c1.weight.device
    sdr = torch.from_numpy(degrade_to_sdr(hdr_val, cfg)).to(dev)
    truth = hdr_truth_pq(hdr_val, cfg)
    pred = apply_fn(model, sdr).cpu().numpy()
    base_model = init_params(torch.Generator().manual_seed(0), cfg).to(dev)
    base = apply_fn(base_model, sdr).cpu().numpy()
    return psnr(pred, truth), psnr(base, truth)
