"""Builds the CUDA kernels of ``videorenderer_tpu_torch/csrc`` and loads them.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
into one shared library, loaded with ``ctypes``: every pointer and the
stream pass as ``c_void_p``, ints as ``c_int``, floats as ``c_float``.  Each
entry point returns ``cudaGetLastError()`` after its launch; the wrappers
raise on anything but 0, with ``vrt_error_string``'s text.

The library goes to ``videorenderer_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing is built at
import: the first kernel launch builds.
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
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point, in the order of its parameters
SIGNATURES = {
    # x, x_dtype, starts, taps, out, mid16, rows, w_in, w_out, n_taps, stream
    "vrt_banded_resize": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # y, y_dtype, u, v, c_dtype, batch, hy, hc, w, h_out,
    # starts_y, taps_y, n_taps_y, starts_c, taps_c, n_taps_c,
    # y_scale, c_scale, cmat (host, 12 floats), apply_matrix, correction,
    # luminance_scale, dither_bits, pack, out, stream
    "vrt_rows3_tail": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _I, _P, _P, _I,
                       _F, _F, _P, _I, _I, _F, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libvrt_kernels.so"


def build() -> Path:
    """Compile the sources unless a library of this exact source set
    exists; returns its path.  The library is written under a temporary
    name and renamed, so a reader never sees half a file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
            lib.vrt_error_string.argtypes = [ctypes.c_int]
            lib.vrt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
