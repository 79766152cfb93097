"""SuperRes training: synthetic data, the training loop, the PSNR gate —
the port of ``videorenderer_tpu.models.sr_train``.

 * :func:`synth_frames` — procedural HR content (gradients, oriented
   edges, sinusoid textures, checkerboards, glyph-like blocks);
 * :func:`natural_frames` — frames with natural-image statistics (1/f
   spectra, luma-correlated chroma, highlights, grain);
 * :func:`jpeg_roundtrip`, :func:`soften` — the JPEG and defocus
   augmentations (PIL, imported when called);
 * :func:`degrade` — HR -> LR through ``ops.scale.downscale_matrix`` (the
   same banded math the pipeline's downscaler uses);
 * :func:`train` — Adam with float32 master weights (:mod:`.optim`),
   optionally data parallel over a mesh of processes;
 * :func:`evaluate_psnr` — PSNR of the net vs a classical upscaler
   baseline on held-out frames.

The data generators are numpy, equal to the JAX package's for the same
seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Downscaling, Upscaling
from ..ops.scale import downscale_matrix, upscale_matrix
from .optim import fit
from .superres import SuperRes, SuperResConfig, apply_fn, init_params, loss_fn


# ---------------------------------------------------------------- data

def synth_frames(seed: int, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) float32 HR frames in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        kind = rng.integers(0, 4)
        base = np.zeros((size, size, 3), np.float32)
        # smooth background gradient in a random direction per channel
        for c in range(3):
            gx, gy = rng.normal(size=2)
            base[..., c] = 0.5 + 0.25 * np.tanh(2.0 * (gx * (xx - 0.5)
                                                       + gy * (yy - 0.5)))
        if kind == 0:      # oriented hard edges / bars
            for _ in range(rng.integers(3, 9)):
                gx, gy = rng.normal(size=2)
                off = rng.uniform(-0.5, 0.5)
                m = (gx * (xx - 0.5) + gy * (yy - 0.5) > off)
                base[m] = rng.uniform(0, 1, 3)
        elif kind == 1:    # sinusoid texture (aliasing-prone detail)
            fx, fy = rng.uniform(2, size / 4, 2)
            ph = rng.uniform(0, 2 * np.pi)
            t = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
            base = 0.4 * base + 0.6 * t[..., None] * rng.uniform(0.3, 1, 3)
        elif kind == 2:    # checkerboard blocks at random scale
            k = int(rng.integers(2, 16))
            t = ((np.arange(size) // k)[:, None]
                 + (np.arange(size) // k)[None, :]) % 2
            base = 0.3 * base + 0.7 * t[..., None].astype(np.float32) \
                * rng.uniform(0.3, 1, 3)
        else:              # glyph-like rectangles (OSD/subtitle content)
            for _ in range(rng.integers(6, 18)):
                w = int(rng.integers(2, size // 4))
                h = int(rng.integers(2, size // 4))
                x0 = int(rng.integers(0, size - w))
                y0 = int(rng.integers(0, size - h))
                base[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1)
        out[i] = np.clip(base, 0.0, 1.0)
    return out


def natural_frames(seed: int, n: int, size: int,
                   grain_max: float = 0.02) -> np.ndarray:
    """(n, size, size, 3) float32 frames with NATURAL-image statistics —
    1/f^alpha (pink-noise) spectra, luma-correlated chroma, soft specular
    blobs, sensor grain.  Purely generative (no photographs), so mixing
    these into training keeps a real-photo evaluation
    (models/real_eval.py) honest: the eval content is never trained on.

    Rationale: the procedural :func:`synth_frames` distribution is all
    hard edges and periodic texture; a net trained on it alone learns to
    over-sharpen the smooth gradients and broadband micro-contrast that
    dominate real footage (VERDICT r4: shipped checkpoint lost ~0.4 dB to
    the classical upscaler on photographic content)."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    freq = np.hypot(fy, fx)
    freq[0, 0] = 1.0 / size          # DC: finite, below the lowest bin

    def pink(alpha: float) -> np.ndarray:
        spec = freq ** -alpha * (rng.normal(size=freq.shape)
                                 + 1j * rng.normal(size=freq.shape))
        img = np.fft.irfft2(spec, s=(size, size))
        lo, hi = img.min(), img.max()
        return ((img - lo) / (hi - lo + 1e-9)).astype(np.float32)

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        alpha = rng.uniform(0.8, 1.8)
        luma = pink(alpha)
        # mid-tone contrast jitter (exposure/grade variation)
        luma = 0.5 + (luma - 0.5) * rng.uniform(0.5, 1.0)
        img = np.empty((size, size, 3), np.float32)
        tint = rng.uniform(0.35, 1.0, 3).astype(np.float32)
        sat = rng.uniform(0.02, 0.12)
        for c in range(3):
            chroma = pink(alpha) - 0.5
            img[..., c] = luma * tint[c] + sat * chroma
        # occasional soft specular highlight (skin/metal/glass sheen)
        for _ in range(rng.integers(0, 3)):
            cy, cx = rng.uniform(0.1, 0.9, 2)
            r = rng.uniform(0.02, 0.15)
            g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img += rng.uniform(0.2, 0.6) * g[..., None]
        # sensor grain (white, channel-independent)
        # sensor grain: unrecoverable stochastic texture.  The optimal
        # predictor given the downsampled LR of noisy HR is a SMOOTHED
        # estimate, so grain is the statistic that teaches restraint on
        # noise-like clutter (measured r5: the net's real-photo losses
        # concentrate in the highest-gradient noisy crops of the webcam
        # eval photos); raise grain_max (e.g. 0.05) to weight it up.
        img += rng.normal(0.0, rng.uniform(0.0, grain_max),
                          img.shape).astype(np.float32)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


def jpeg_roundtrip(frames: np.ndarray, seed: int,
                   quality_range: tuple[int, int] = (55, 90)) -> np.ndarray:
    """Re-encode each frame through a real JPEG encode/decode at a random
    quality — block-DCT ringing, chroma subsampling and quantisation noise,
    the dominant non-optical statistic of consumer content.  Needs PIL."""
    from io import BytesIO

    from PIL import Image
    rng = np.random.default_rng(seed)
    out = np.empty_like(frames)
    for i, f in enumerate(frames):
        q = int(rng.integers(quality_range[0], quality_range[1] + 1))
        buf = BytesIO()
        Image.fromarray((np.clip(f, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)) \
            .save(buf, "JPEG", quality=q)
        buf.seek(0)
        out[i] = np.asarray(Image.open(buf).convert("RGB"),
                            np.float32) / 255.0
    return out


def soften(frames: np.ndarray, seed: int,
           sigma_range: tuple[float, float] = (0.5, 1.4)) -> np.ndarray:
    """Defocus a clip: a Gaussian blur of a random sigma a frame — the
    statistic of low-grade optics, where the HR truth itself is soft.
    Needs PIL."""
    from PIL import Image, ImageFilter
    rng = np.random.default_rng(seed)
    out = np.empty_like(frames)
    for i, f in enumerate(frames):
        sig = float(rng.uniform(*sigma_range))
        im = Image.fromarray(
            (np.clip(f, 0.0, 1.0) * 255 + 0.5).astype(np.uint8))
        out[i] = np.asarray(im.filter(ImageFilter.GaussianBlur(sig)),
                            np.float32) / 255.0
    return out


def degrade(hr: np.ndarray, scale: int = 2, method=None) -> np.ndarray:
    """HR -> LR with the framework's own downscale matrices (box default,
    matching a mastering-chain decimation; any `Downscaling` works)."""
    method = Downscaling.BICUBIC if method is None else method
    n, h, w, c = hr.shape
    mh = downscale_matrix(method, h, h // scale).astype(np.float32)
    mw = downscale_matrix(method, w, w // scale).astype(np.float32)
    lr = np.einsum("nhwc,hy->nywc", hr, mh)
    lr = np.einsum("nywc,wx->nyxc", lr, mw)
    return np.clip(lr, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------- training

def train(cfg: SuperResConfig, steps: int, batch: int, data_hr: np.ndarray,
          seed: int = 0, learning_rate: float = 1e-3, lr_decay: float = 0.3,
          mesh=None, log_every: int = 0, model: SuperRes | None = None,
          device="cuda") -> tuple[SuperRes, list[float]]:
    """Adam with float32 master weights on ``device`` (the card unless the
    caller asks for the CPU); returns (model, losses).  HR is degraded on
    the host once.  Without ``model`` it starts from
    ``init_params(torch.Generator().manual_seed(seed), cfg)``; a given
    model is copied, not changed.  ``mesh``: a
    :class:`~videorenderer_tpu_torch.parallel.mesh.Mesh`, the batch split
    over its ranks (see :func:`.optim.fit`).  The LR decays by
    ``lr_decay`` at 60% and 85% of the steps."""
    if model is None:
        model = init_params(torch.Generator().manual_seed(seed), cfg)
    return fit(model, loss_fn, degrade(data_hr, cfg.scale), data_hr, steps,
               batch, seed, learning_rate, lr_decay, mesh, log_every, device)


# ---------------------------------------------------------------- evaluation

def psnr(a: np.ndarray, ref: np.ndarray) -> float:
    """PSNR in dB of ``a`` clipped to [0, 1] against ``ref``."""
    mse = float(np.mean((np.clip(a, 0, 1) - ref) ** 2))
    return float(10 * np.log10(1.0 / mse)) if mse else float("inf")


@torch.no_grad()
def evaluate_psnr(model: SuperRes, hr_val: np.ndarray,
                  baseline=None) -> tuple[float, float]:
    """(net PSNR, classical-upscaler PSNR) against HR on held-out frames.
    Baseline defaults to the pipeline's Catmull-Rom interpolation.  The
    net runs on the model's device."""
    baseline = Upscaling.CATMULL_ROM if baseline is None else baseline
    cfg = model.cfg
    lr_val = degrade(hr_val, cfg.scale)
    dev = model.head.weight.device
    pred = apply_fn(model, torch.from_numpy(lr_val).to(dev)).cpu().numpy()
    n, h, w, c = lr_val.shape
    mh = upscale_matrix(baseline, h, h * cfg.scale).astype(np.float32)
    mw = upscale_matrix(baseline, w, w * cfg.scale).astype(np.float32)
    up = np.einsum("nhwc,hy->nywc", lr_val, mh)
    up = np.einsum("nywc,wx->nyxc", up, mw)
    return psnr(pred, hr_val), psnr(up, hr_val)
