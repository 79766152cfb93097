"""K10, the W-pass probe of the headline stage split: two kernels that take
a W pass apart, with their plain PyTorch versions.

Replaces ``bench_headline_micro.py: _probe_wpass`` (``csrc/probe_wpass.cu``),
which times two Pallas bodies beside the production W pass (K1):

* :func:`wpass_bf16` (its ``k1``, "yW1"): one band product of the
  bf16-rounded raw codes with the bf16-rounded taps, summed in float32 —
  K1's work without its float32 precision;
* :func:`wpass_floor` (its ``ksplit``, "yWsplit"): every input byte read and
  rounded to bf16, the first ``w_out`` columns written as float32 — the
  floor of a W pass's read + convert + write.

Both kernels are bound by device memory.  The probe measures and adds
nothing to the renderer: no pipeline path calls them.  As in
``kernels/resize.py``, a wrapper given a CPU tensor runs the plain version,
given a CUDA tensor launches the kernel or raises, and each launch adds one
to ``resize.launches[name]``.
"""

from __future__ import annotations

import torch

from .resize import (K1_SPAN, BandedMatrix, _kernel_device, _launch,
                     _no_tf32, k1_rows, k1_smem_bytes, kernel_span)

FLOOR_MAX_WIDTH = 16384   # kTileElems: the widest row a floor block stages


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), back in float32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _check_u16(x: torch.Tensor) -> None:
    if x.dtype != torch.uint16:
        raise TypeError(f"x: the probe reads uint16 codes, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x: need (..., W) codes, got {tuple(x.shape)}")


def _bf16_taps_on(mat: BandedMatrix, device) -> torch.Tensor:
    """The tap table rounded to bf16, as its int16 bit patterns (the
    kernel reads them as ``__nv_bfloat16``), copied to ``device`` once."""
    bits = torch.from_numpy(mat.taps).to(torch.bfloat16).view(torch.int16)
    return mat._get("taps_bf16", bits.numpy(), device)


# ---------------------------------------------------------------------------
# yW1: the single bf16 band product
# ---------------------------------------------------------------------------


def wpass_bf16_plain(x: torch.Tensor, mat: BandedMatrix) -> torch.Tensor:
    """Plain ``wpass_bf16``: the bf16-rounded planes times the bf16-rounded
    dense matrix, one float32 product (TF32 off)."""
    _no_tf32()
    return _bf16(x) @ _bf16(mat.dense_on(x.device))


@kernel_span("wpass_bf16")
def wpass_bf16(x: torch.Tensor, mat: BandedMatrix) -> torch.Tensor:
    """W pass of raw uint16 codes ``x`` (..., W_in) by ``mat`` (its
    normalisation folded in) with both operands rounded to bf16 and the sum
    in float32: (..., W_out) float32.  A bf16 x bf16 product is exact in
    float32, so only the order of the sum differs from the Pallas ``k1``.

    Kernel K10 ``vrt_wpass_bf16`` (``csrc/probe_wpass.cu``), on K1's
    design: a block stages :func:`resize.k1_rows` rows of the input span
    its K1_SPAN output columns reach in shared memory (16-byte copies);
    each thread keeps its 2 columns' starts and bf16 taps in registers for
    all those rows and stores its 2 outputs at once."""
    _check_u16(x)
    if x.shape[-1] != mat.in_size:
        raise ValueError(f"x has {x.shape[-1]} columns, the matrix "
                         f"takes {mat.in_size}")
    if not _kernel_device(x):
        return wpass_bf16_plain(x, mat)
    rows = x.numel() // mat.in_size
    lo, win = mat.row_windows(K1_SPAN, x.device)
    block_rows = k1_rows(2, win)
    if block_rows is None or rows >= 2 ** 31 \
            or mat.out_size > K1_SPAN * 65535:
        raise ValueError(f"K10 cannot take {rows} rows x {mat.out_size} "
                         f"output columns (a span of {win} input columns "
                         f"needs {k1_smem_bytes(2, win, 1)} bytes a row)")
    out = torch.empty(x.shape[:-1] + (mat.out_size,), dtype=torch.float32,
                      device=x.device)
    starts, _ = mat.taps_on(x.device)
    taps = _bf16_taps_on(mat, x.device)
    _launch("wpass_bf16", "vrt_wpass_bf16", x.device, x.data_ptr(),
            starts.data_ptr(), taps.data_ptr(), lo.data_ptr(), win,
            out.data_ptr(), rows, mat.in_size, mat.out_size, mat.n_taps,
            block_rows)
    return out


# ---------------------------------------------------------------------------
# yWsplit: the read + convert + write floor
# ---------------------------------------------------------------------------


def wpass_floor_plain(x: torch.Tensor, w_out: int) -> torch.Tensor:
    """Plain ``wpass_floor``: the first ``w_out`` columns, through bf16."""
    return _bf16(x[..., :w_out])


@kernel_span("wpass_floor")
def wpass_floor(x: torch.Tensor, w_out: int) -> torch.Tensor:
    """float32(bf16(x)) of the first ``w_out`` columns of raw uint16 codes
    ``x`` (..., W_in): (..., w_out) float32, bit-equal to the Pallas
    ``ksplit``'s first ``w_out`` columns.

    Kernel K10 ``vrt_wpass_floor`` (``csrc/probe_wpass.cu``): each block
    stages the whole width of a few rows in shared memory as bf16, then
    writes their first ``w_out`` columns, so every input byte is read."""
    _check_u16(x)
    w_in = x.shape[-1]
    if not 0 < w_out <= w_in:
        raise ValueError(f"w_out {w_out} must lie in [1, {w_in}]")
    if not _kernel_device(x):
        return wpass_floor_plain(x, w_out)
    rows = x.numel() // w_in
    if w_in > FLOOR_MAX_WIDTH or rows >= 2 ** 31:
        raise ValueError(f"K10 cannot stage {rows} rows of {w_in} columns")
    out = torch.empty(x.shape[:-1] + (w_out,), dtype=torch.float32,
                      device=x.device)
    _launch("wpass_floor", "vrt_wpass_floor", x.device, x.data_ptr(),
            out.data_ptr(), rows, w_in, w_out)
    return out
