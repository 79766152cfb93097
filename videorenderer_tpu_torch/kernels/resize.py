"""The two kernels of the main path — K1, the banded W-axis resize, and K2,
the H-axis resize with the whole per-pixel tail — with their plain PyTorch
versions, the tap-table planning they share, and the surface packer.

Replaces ``videorenderer_tpu/kernels/resize_pallas.py``:
``banded_resize_last_axis`` (K1, ``csrc/banded_resize.cu``) and
``rows3_tail`` (K2, ``csrc/rows3_tail.cu``).

The Pallas kernels packed each banded (in, out) matrix into 128-aligned
windows and split the products into bf16 halves, for the TPU's lane tiling
and its bf16 matrix unit.  Here every output column (K1) or row (K2) keeps
its own contiguous tap range instead: a start index and T float32 weights,
zero-padded to the matrix's widest band (:func:`plan_taps`).  The kernels
run T fp32 FMAs per output, so there is no bf16 split error at all.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Each launch adds one to ``launches[name]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import build

MID16_SCALE = 16384.0
"""W-pass intermediates may be int16 codes round(value * 16384) ("mid16"):
2^-14 steps, about 16x finer than the reference's 10-bit UNORM intermediate
textures, and half the bytes of float32.  Callers guard the range: the
column L1 norm of the matrix times 16384 must stay within int16."""

TILE_N = 128   # the JAX packing's output tile, for :func:`taps_from_band_pack`

DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2,
               torch.float32: 3}

CORR_NONE, CORR_PQ_TO_SDR, CORR_HLG_TO_SDR = 0, 1, 2
PACK_CODES = {None: 0, "rgb10a2": 1, "rgba8": 2}

launches = {"banded_resize_last_axis": 0, "rows3_tail": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# tap tables
# ---------------------------------------------------------------------------


def plan_taps(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output tap table of an (in, out) matrix: ``starts`` (out,) int32,
    the first input index with a nonzero weight, and ``taps`` (T, out)
    float32 with ``taps[t, j] = mat[starts[j] + t, j]`` (zero past the
    matrix), T the widest nonzero band of any column.  Then
    ``out[j] = sum_t x[starts[j] + t] * taps[t, j]`` is ``x @ mat``.  A column
    without weights gets start 0 and zero taps."""
    mat = np.asarray(mat, np.float32)
    n_in, n_out = mat.shape
    nz = mat != 0
    has = nz.any(axis=0)
    lo = np.where(has, nz.argmax(axis=0), 0)
    hi = np.where(has, n_in - nz[::-1].argmax(axis=0), 1)
    n_taps = int(max(1, (hi - lo).max()))
    idx = lo[None, :] + np.arange(n_taps)[:, None]
    cols = np.arange(n_out)[None, :]
    taps = np.where(idx < n_in, mat[np.minimum(idx, n_in - 1), cols], 0.0)
    return lo.astype(np.int32), np.ascontiguousarray(taps, np.float32)


def taps_from_band_pack(starts: np.ndarray, bands: np.ndarray, kb: int,
                        w_in_pad: int, w_out: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The tap table of a matrix packed by the JAX package's
    ``resize_pallas._pack_band`` (``starts`` (J,), ``bands`` (J, kb, 128)):
    unpack the 128-wide tiles into the dense (w_in_pad, w_out) matrix and
    plan it.  Equal to :func:`plan_taps` of the original matrix, since the
    packing covers every nonzero and the padding rows are zero."""
    dense = np.zeros((w_in_pad, w_out), np.float32)
    for j, s in enumerate(np.asarray(starts, np.int64)):
        c0 = j * TILE_N
        n = min(TILE_N, w_out - c0)
        rows = min(kb, w_in_pad - int(s))
        dense[s:s + rows, c0:c0 + n] = bands[j, :rows, :n]
    return plan_taps(dense)


class BandedMatrix:
    """An (in, out) resize matrix with its normalisation folded in, in the
    two forms the main path applies: dense float32 (the plain versions) and
    the tap table of :func:`plan_taps` (the kernels).  Each form is copied
    to a device once, at its first use there."""

    def __init__(self, mat: np.ndarray, pre_scale: float | None = None):
        m = np.asarray(mat, np.float32)
        if pre_scale is not None:
            m = m * np.float32(pre_scale)
        self.dense = m
        self.in_size, self.out_size = m.shape
        self.starts, self.taps = plan_taps(m)
        self._on: dict = {}

    @property
    def n_taps(self) -> int:
        return self.taps.shape[0]

    def _get(self, key: str, arr: np.ndarray, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get((key, device))
        if t is None:
            t = torch.from_numpy(arr).to(device)
            self._on[(key, device)] = t
        return t

    def dense_on(self, device) -> torch.Tensor:
        return self._get("dense", self.dense, device)

    def taps_on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (self._get("starts", self.starts, device),
                self._get("taps", self.taps, device))


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------


def _no_tf32() -> None:
    # the plain versions' products must keep float32 rounding on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_plane(name: str, p: torch.Tensor) -> None:
    if p.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {p.dtype} not one of "
                        f"{list(DTYPE_CODES)}")
    if p.dim() < 2:
        raise ValueError(f"{name}: need (..., H, W), got {tuple(p.shape)}")


def _kernel_device(*ps: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); anything else raises."""
    dev = ps[0].device
    for p in ps:
        if p.device != dev:
            raise ValueError(f"planes on different devices: {p.device} "
                             f"and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for p in ps:
        if not p.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.vrt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
    launches[name] += 1


# ---------------------------------------------------------------------------
# K1: banded resize along the last axis
# ---------------------------------------------------------------------------


def _quant_mid16(x: torch.Tensor) -> torch.Tensor:
    # round half to even, as jnp.round and the kernel's __float2int_rn
    return torch.round(x * MID16_SCALE).to(torch.int32).to(torch.int16)


def banded_resize_last_axis_plain(x: torch.Tensor, mat: BandedMatrix,
                                  mid16: bool = False) -> torch.Tensor:
    """Plain K1: one dense float32 product, then the optional mid16 codes."""
    _no_tf32()
    out = x.to(torch.float32) @ mat.dense_on(x.device)
    return _quant_mid16(out) if mid16 else out


def banded_resize_last_axis(x: torch.Tensor, mat: BandedMatrix,
                            mid16: bool = False) -> torch.Tensor:
    """Resize ``x`` (..., W_in) — raw uint8/uint16 planes, int16 or float32
    — along its last axis by ``mat`` (whose normalisation is folded in).
    Returns float32 (..., W_out), or with ``mid16`` int16 codes
    round(value * MID16_SCALE).

    Kernel K1 (``csrc/banded_resize.cu``), replacing
    ``resize_pallas.banded_resize_last_axis``.  Bound by device memory (6
    FMAs per ~4 bytes at the headline shapes): one thread per output pixel
    runs T fp32 FMAs over its contiguous taps, each input byte read from
    device memory once (measured on an H100: 28% of peak bandwidth)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not one of {list(DTYPE_CODES)}")
    if x.shape[-1] != mat.in_size:
        raise ValueError(f"x has {x.shape[-1]} columns, the matrix "
                         f"takes {mat.in_size}")
    if not _kernel_device(x):
        return banded_resize_last_axis_plain(x, mat, mid16)
    rows = x.numel() // mat.in_size
    if rows == 0 or rows >= 2 ** 31 or mat.out_size >= 128 * 65535:
        raise ValueError(f"K1 cannot take {rows} rows x {mat.out_size} "
                         "output columns")
    out = torch.empty(x.shape[:-1] + (mat.out_size,),
                      dtype=torch.int16 if mid16 else torch.float32,
                      device=x.device)
    starts, taps = mat.taps_on(x.device)
    _launch("banded_resize_last_axis", "vrt_banded_resize", x.device,
            x.data_ptr(), DTYPE_CODES[x.dtype], starts.data_ptr(),
            taps.data_ptr(), out.data_ptr(), int(mid16), rows,
            mat.in_size, mat.out_size, mat.n_taps)
    return out


# ---------------------------------------------------------------------------
# K2: H resize of three planes + colour matrix + corrections + dither + pack
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Epilogue:
    """What K2 runs on each output pixel after the H pass: the parameters of
    the kernel's specialisation, and ``plain``, the same computation in
    torch for the plain version ((..., H, W) x 3 -> (..., 3, H, W)).

    ``cmat``: (3, 4) float32 rows (m0 m1 m2 c), or None when the planes are
    R, G, B already.  ``correction``: CORR_NONE, CORR_PQ_TO_SDR or
    CORR_HLG_TO_SDR, the SDR conversions using ``luminance_scale`` and the
    (3, 3) BT.2020 -> BT.709 ``gamut`` matrix.  ``dither_bits``: +b ordered
    dither to b bits, -b round to b bits, 0 none (float output); b is 8 or
    10."""

    cmat: np.ndarray | None
    correction: int
    luminance_scale: float
    dither_bits: int
    gamut: np.ndarray
    plain: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

    def validate(self) -> None:
        if self.correction not in (CORR_NONE, CORR_PQ_TO_SDR, CORR_HLG_TO_SDR):
            raise NotImplementedError(
                f"K2 epilogue: correction {self.correction} is not ported")
        if self.dither_bits not in (0, 8, 10, -8, -10):
            raise NotImplementedError(
                f"K2 epilogue: dither_bits {self.dither_bits} is not ported")
        if self.cmat is not None and np.shape(self.cmat) != (3, 4):
            raise ValueError(f"cmat must be (3, 4), got {np.shape(self.cmat)}")


def pack_surface(rgb: torch.Tensor, fmt: str) -> torch.Tensor:
    """Pack (..., 3, H, W) float [0,1] into (..., H, W) int32 surface dwords,
    R10G10B10A2 or RGBA8 (the swap-chain backbuffer formats,
    Source/DX11VideoProcessor.cpp:1490-1530): ``(clip(x)*1023 + 0.5)``
    truncated per channel, alpha opaque.  Same math as the JAX package's
    ``pack_surface_tiles`` and ``pipeline._pack_surface_xla``."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    if fmt == "rgb10a2":
        scale, shift, alpha = 1023.0, 10, -1073741824   # A2 = 3: 0xC0000000
    elif fmt == "rgba8":
        scale, shift, alpha = 255.0, 8, -16777216       # A8 = 255: 0xFF000000
    else:
        raise ValueError(f"unknown surface format {fmt!r}")

    def q(x):
        return (torch.clamp(x, 0.0, 1.0) * scale + 0.5).to(torch.int32)

    return q(r) | (q(g) << shift) | (q(b) << (2 * shift)) | alpha


def _h_plain(p: torch.Tensor, mat: BandedMatrix | None,
             scale: float | None) -> torch.Tensor:
    pf = p.to(torch.float32)
    if mat is None:
        return pf if scale is None else pf * float(np.float32(scale))
    return mat.dense_on(p.device).T @ pf


def rows3_tail_plain(y, u, v, my: BandedMatrix | None,
                     mc: BandedMatrix | None, h_out: int, epilogue: Epilogue,
                     y_scale: float | None = None, c_scale: float | None = None,
                     pack_format: str | None = None) -> torch.Tensor:
    """Plain K2: each plane's H contraction as a dense float32 product (or
    the direct read times its scale), the torch epilogue, the pack."""
    _no_tf32()
    rgb = epilogue.plain(_h_plain(y, my, y_scale), _h_plain(u, mc, c_scale),
                         _h_plain(v, mc, c_scale))
    return rgb if pack_format is None else pack_surface(rgb, pack_format)


def rows3_tail(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               my: BandedMatrix | None, mc: BandedMatrix | None, h_out: int,
               epilogue: Epilogue, y_scale: float | None = None,
               c_scale: float | None = None,
               pack_format: str | None = None) -> torch.Tensor:
    """H-resize the (luma, chroma, chroma) planes, then run the epilogue.

    ``y`` (..., Hy, W), ``u``/``v`` (..., Hc, W): mid16 int16, float32 or raw
    uint8/uint16.  ``my`` (Hy, h_out) / ``mc`` (Hc, h_out): the H matrices
    with their scale folded in, or None for a plane read directly — its
    height is then h_out and ``y_scale``/``c_scale`` scale it.  Returns
    (..., 3, h_out, W) float32, or with ``pack_format`` ("rgb10a2"/"rgba8")
    (..., h_out, W) int32 dwords.

    Kernel K2 (``csrc/rows3_tail.cu``), replacing
    ``resize_pallas.rows3_tail``.  One thread per output pixel runs the H
    taps of all three planes (coalesced over W), the colour matrix, the
    corrections, the dither from the global row and column, and the store,
    so no intermediate RGB reaches device memory.  That makes its bytes
    small; measured on an H100 it is bound by the ~20 accurate
    transcendental calls per pixel of the PQ/Hable/gamma tail (8% of peak
    bandwidth)."""
    epilogue.validate()
    if pack_format not in PACK_CODES:
        raise NotImplementedError(f"K2: pack format {pack_format!r}")
    for name, p in (("y", y), ("u", u), ("v", v)):
        _check_plane(name, p)
    if u.shape != v.shape or u.dtype != v.dtype:
        raise ValueError("u and v must share shape and dtype")
    lead, (hy, w) = y.shape[:-2], y.shape[-2:]
    hc = u.shape[-2]
    if u.shape[:-2] != lead or u.shape[-1] != w:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch or width")
    for name, mat, h_in, scale in (("y", my, hy, y_scale),
                                   ("c", mc, hc, c_scale)):
        if mat is None and h_in != h_out:
            raise ValueError(f"{name}: no H matrix, so its height {h_in} "
                             f"must be h_out {h_out}")
        if mat is not None and (mat.in_size, mat.out_size) != (h_in, h_out):
            raise ValueError(f"{name}: H matrix {mat.in_size}->"
                             f"{mat.out_size} for {h_in}->{h_out}")
        if mat is not None and scale is not None:
            raise ValueError(f"{name}: a scale goes into the H matrix, not "
                             "beside it")
    if not _kernel_device(y, u, v):
        return rows3_tail_plain(y, u, v, my, mc, h_out, epilogue, y_scale,
                                c_scale, pack_format)
    batch = y.numel() // (hy * w) if y.numel() else 0
    if batch == 0 or batch > 65535 or h_out > 65535:
        raise ValueError(f"K2 cannot take batch {batch} x {h_out} rows")
    if pack_format is None:
        out = torch.empty(lead + (3, h_out, w), dtype=torch.float32,
                          device=y.device)
    else:
        out = torch.empty(lead + (h_out, w), dtype=torch.int32,
                          device=y.device)
    cm = (np.zeros((3, 4), np.float32) if epilogue.cmat is None
          else np.asarray(epilogue.cmat, np.float32))
    host_mats = np.ascontiguousarray(np.concatenate(
        [cm.reshape(-1), np.asarray(epilogue.gamut, np.float32).reshape(-1)]))

    def taps(mat):   # (starts, taps, T) pointers; NULL and T = 0: no matrix
        if mat is None:
            return None, None, 0
        s, t = mat.taps_on(y.device)
        return s.data_ptr(), t.data_ptr(), mat.n_taps

    _launch("rows3_tail", "vrt_rows3_tail", y.device,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, hy, hc, w, h_out,
            *taps(my), *taps(mc),
            1.0 if y_scale is None else float(y_scale),
            1.0 if c_scale is None else float(c_scale),
            host_mats.ctypes.data, int(epilogue.cmat is not None),
            epilogue.correction, float(epilogue.luminance_scale),
            epilogue.dither_bits, PACK_CODES[pack_format], out.data_ptr())
    return out
