"""Builds the CUDA kernels of ``videorenderer_tpu_torch/csrc`` and loads them.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds,
one process per ``.cu`` file, all started together, and links the objects
into one shared library, loaded with ``ctypes``: every pointer and the
stream pass as ``c_void_p``, ints as ``c_int``, floats as ``c_float``.  Each
entry point returns ``cudaGetLastError()`` after its launch; the wrappers
raise on anything but 0, with ``vrt_error_string``'s text.

The library goes to ``videorenderer_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), named by a hash of the sources, headers and flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing is
built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry point, in the order of its parameters
SIGNATURES = {
    # x, x_dtype, starts, taps, span_lo, win, out, mid16, rows (64-bit),
    # w_in, w_out, n_taps, rows_per_block, stream
    "vrt_banded_resize": (_P, _I, _P, _P, _P, _I, _P, _I, _L, _I, _I, _I,
                          _I, _P),
    # y, y_dtype, u, v, c_dtype, batch, hy, hc, w, h_out, tile_rows, the
    # (starts, taps, n_taps, tile_lo, win) of the y and c H maps, y_scale,
    # c_scale, mats (host: cmat 12, gamut 9, tone map 5 floats, the SDR
    # BT.2020 fix's gamma, trims 5 + mode, the guided curve's 26
    # constants; kernels/resize.Epilogue.host_mats), apply_matrix,
    # correction, tonemap,
    # luminance_scale, dither_bits, pack, surface_h, surface_w, off_y,
    # off_x, long_window, redo_groups (device int64 or NULL), out, stream
    "vrt_rows3_tail": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                       _F, _F, _P, _I, _I, _I, _F, _I, _I,
                       _I, _I, _I, _I, _I, _P, _P, _P),
    # y, y_dtype, u, v, c_dtype, batch, hy, hc, w, h_out, tile_rows, the
    # (starts, taps, n_taps, tile_lo, win) of the y and c H maps, y_scale,
    # c_scale, vals (host), n_vals, structure (host), lms_identity, out,
    # stream
    "vrt_rows3_tail_dovi": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                            _F, _F, _P, _I, _P, _I, _P, _P),
    # y, y_dtype, u, v, c_dtype, batch, h, wy, wc, w_out, tile_rows, the
    # (starts, taps, n_taps, tile_lo, win) of the y and c W maps, y_scale,
    # c_scale, mats (host), apply_matrix, correction, tonemap,
    # luminance_scale, dither_bits, pack, surface_h, surface_w, off_y,
    # off_x, long_window, out, stream
    "vrt_cols3_tail": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                       _F, _F, _P, _I, _I, _I, _F, _I, _I,
                       _I, _I, _I, _I, _I, _P, _P),
    # y, y_dtype, u, v, c_dtype, batch, hy, wy, hc, wc, h_out, w_out,
    # tile_rows, chunk_rows, the (starts, taps, n_taps, span_lo, span) of
    # the W maps of y and c, the (starts, taps, n_taps, tile_lo, win) of
    # their H maps, y_scale, c_scale, mats (host, 59 floats), apply_matrix,
    # correction, tonemap, luminance_scale, dither_bits, long_window,
    # redo_groups (device int64 or NULL), out, stream
    "vrt_mega3_tail": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                       _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                       _F, _F, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P),
    # x, x_dtype, starts, taps, tile_lo, win, out, batch, h_in, h_out, w,
    # n_taps, tile_rows, long_window, stream
    "vrt_banded_resize_rows": (_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                               _I, _I, _I, _P),
    # y, y_dtype, u, v, c_dtype, batch, hy, hc, w, h_mid, h_out,
    # tile_rows, the (starts, taps, n_taps, lo, win) of the y and c in maps,
    # (starts, taps, n_taps) of the out map, tile_lo, win, y_scale,
    # c_scale, vals (host), n_vals, structure (host), lms_identity,
    # long_window, redo_groups (device int64 or NULL), out, stream
    "vrt_rows3_mid": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I,
                      _P, _I, _F, _F, _P, _I, _P, _I, _I, _P, _P, _P),
    # planes (host array of 9 pointers), dtype, batch, hy, wy, hc, wc,
    # h_out, tile_rows, the (starts, taps, n_taps, tile_lo, win) of the y
    # and c H maps, thr, top_field_first, long_window, out_y, out_u, out_v,
    # stream
    "vrt_deint3_rows_dual": (_P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _I, _P, _I, _P, _P, _I, _P, _I,
                             _F, _I, _I, _P, _P, _P, _P),
    # x, planes, h, w, oh, ow, by, d2y, bx, d2x, row_cls, col_cls, table
    # (NULL: per-output weights), n_col_cls, win_h (0: taps through L1),
    # pitch, dither_bits, row0, out, stream
    "vrt_jinc2_resize": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P, _P),
    # y, u, v, dtype, batch, h, w, ch, cw, oh, ow, by, d2y, bx, d2x,
    # ux_starts, ux_taps, n_ux, uy_starts, uy_taps, n_uy, y_scale, c_scale,
    # cmat (host, 12 floats), dither_bits, row0, pack, transpose, win_h,
    # win_w, row_cls, col_cls, table (NULL: per-output weights), n_col_cls,
    # out, stream
    "vrt_jinc2_convert": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _F, _F,
                          _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
                          _P),
    # d2y (4, n_row_cls), n_row_cls, d2x (4, n_col_cls), n_col_cls, table,
    # stream
    "vrt_jinc2_weight_table": (_P, _I, _P, _I, _P, _P),
    # x, starts, taps (bf16), span_lo, win, out, rows, w_in, w_out, n_taps,
    # rows_per_block, stream
    "vrt_wpass_bf16": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # x, out, rows, w_in, w_out, stream
    "vrt_wpass_floor": (_P, _P, _I, _I, _I, _P),
    # x, n (64-bit), e, checked, exact, ok (uint8), v, stream
    "vrt_checked_pow": (_P, _L, _F, _P, _P, _P, _P, _P),
}
# entry points that return a string, not an error code
STRING_SIGNATURES = {
    "vrt_error_string": (_I,),
    # y_dtype, c_dtype, apply_matrix, correction, tonemap, trims,
    # dither_bits, pack, long_window (kernels/resize.route_flags)
    "vrt_rows3_tail_route": (_I, _I, _I, _I, _I, _I, _I, _I, _I),
    # the same flags, for K9
    "vrt_cols3_tail_route": (_I, _I, _I, _I, _I, _I, _I, _I, _I),
    # the same flags without the pack (K4 stores planar float), for K4
    "vrt_mega3_tail_route": (_I, _I, _I, _I, _I, _I, _I, _I),
    # y_dtype, c_dtype, vals (host), n_vals, structure (host), lms_identity
    "vrt_rows3_mid_route": (_I, _I, _P, _I, _P, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libvrt_kernels.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails.  No process outlives the call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")


def build() -> Path:
    """Compile the sources unless a library of this exact source set
    exists; returns its path.  The library is written under a temporary
    name and renamed, so a reader never sees half a file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        objs = [os.path.join(tmp_dir, src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                  for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(tmp_dir, out.name)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            for name, args in STRING_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_char_p
            _lib = lib
        return _lib
