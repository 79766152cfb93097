"""ctypes bindings for the native frame-repack library (native/frame_copy.cpp)
— the runtime analogue of the reference's SIMD copier dispatch
(GetCopyPlaneFunction, Source/Helper.cpp:377-412).

The library is built on demand with ``make -C native`` (g++ -O3
-march=native) and loaded lazily; all entry points gracefully return None
when the toolchain or library is unavailable, and
:func:`videorenderer_tpu_torch.formats.unpack_frame` unpacks with numpy
instead.  A copy of ``videorenderer_tpu.io.native`` over the same library
(``native/``, shared by both packages); host code only.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libvrt_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        src = _NATIVE_DIR / "frame_copy.cpp"
        stale = (not _LIB_PATH.exists()
                 or (src.exists()
                     and src.stat().st_mtime > _LIB_PATH.stat().st_mtime))
        if stale:
            # (re)build: the library is never committed (it's -march=native,
            # so a foreign prebuilt .so could SIGILL), and source edits must
            # not be masked by a stale binary
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
    except Exception:
        _lib = None
        return None

    u8 = ctypes.POINTER(ctypes.c_uint8)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    f32 = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    sz = ctypes.c_size_t
    sigs = {
        "vrt_nv12_split": (u8, i, i, u8, u8, u8),
        "vrt_nv12_split_p": (u8, i, i, i, u8, u8, u8),
        "vrt_p010_split": (u16, i, i, u16, u16, u16),
        "vrt_p210_split": (u16, i, i, u16, u16, u16),
        "vrt_p01x_split_p": (u16, i, i, i, i, u16, u16, u16),
        "vrt_yuy2_to_planar": (u8, i, i, u8, u8, u8),
        "vrt_yuy2_to_planar_p": (u8, i, i, i, u8, u8, u8),
        "vrt_uyvy_to_planar": (u8, i, i, u8, u8, u8),
        "vrt_uyvy_to_planar_p": (u8, i, i, i, u8, u8, u8),
        "vrt_y210_to_planar": (u16, i, i, u16, u16, u16),
        "vrt_y210_to_planar_p": (u16, i, i, i, u16, u16, u16),
        "vrt_v210_to_planar": (u32, i, i, u16, u16, u16),
        "vrt_v210_to_planar_p": (u32, i, i, i, u16, u16, u16),
        "vrt_shift10to16": (u16, u16, sz),
        "vrt_rgb24_to_planar": (u8, i, i, u8, u8, u8),
        "vrt_rgb24_to_planar_p": (u8, i, i, i, u8, u8, u8),
        "vrt_bgra32_to_planar": (u8, i, i, u8, u8, u8),
        "vrt_bgra32_to_planar_p": (u8, i, i, i, u8, u8, u8),
        "vrt_r210_to_planar": (u32, i, i, u16, u16, u16),
        "vrt_r210_to_planar_p": (u32, i, i, i, u16, u16, u16),
        "vrt_pack_rgb8": (f32, f32, f32, u8, sz),
        "vrt_pack_rgb10": (f32, f32, f32, u32, sz),
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _checked_src(buf: np.ndarray, required: int) -> np.ndarray | None:
    """Contiguous byte view of ``buf`` iff it holds at least ``required``
    bytes; a short buffer returns None so callers fall back to the numpy
    unpackers, which raise a clean ValueError instead of letting the C side
    read out of bounds."""
    src = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    if src.nbytes < required:
        return None
    return src


def nv12_split(buf: np.ndarray, w: int, h: int, pitch: int | None = None):
    """``pitch``: bytes per luma row for pitched decoder buffers — repacks
    straight to planar with no intermediate repitch copy (the reference's
    copiers take src_pitch, Source/Helper.cpp:414-428)."""
    lib = _load()
    if lib is None:
        return None
    p = pitch if pitch is not None else w
    if p < w:
        return None
    src = _checked_src(buf, p * h + p * (h // 2 - 1) + w if pitch
                       else w * h * 3 // 2)
    if src is None:
        return None
    y = np.empty((h, w), np.uint8)
    u = np.empty((h // 2, w // 2), np.uint8)
    v = np.empty((h // 2, w // 2), np.uint8)
    lib.vrt_nv12_split_p(_ptr(src, ctypes.c_uint8), w, h, p,
                         _ptr(y, ctypes.c_uint8), _ptr(u, ctypes.c_uint8),
                         _ptr(v, ctypes.c_uint8))
    return y, u, v


def p010_split(buf: np.ndarray, w: int, h: int, subsampling_h: int = 2,
               pitch: int | None = None):
    lib = _load()
    if lib is None:
        return None
    ch = h // subsampling_h
    p = pitch if pitch is not None else 2 * w
    if p < 2 * w or p % 2:
        return None
    src = _checked_src(buf, p * h + p * (ch - 1) + 2 * w if pitch
                       else 2 * w * h + 2 * w * ch)
    if src is None:
        return None
    src = src.view(np.uint16)
    y = np.empty((h, w), np.uint16)
    u = np.empty((ch, w // 2), np.uint16)
    v = np.empty((ch, w // 2), np.uint16)
    lib.vrt_p01x_split_p(_ptr(src, ctypes.c_uint16), w, h, p, subsampling_h,
                         _ptr(y, ctypes.c_uint16), _ptr(u, ctypes.c_uint16),
                         _ptr(v, ctypes.c_uint16))
    return y, u, v


def packed422_to_planar(buf: np.ndarray, w: int, h: int, kind: str,
                        pitch: int | None = None):
    lib = _load()
    if lib is None:
        return None
    if kind in ("yuy2", "uyvy"):
        p = pitch if pitch is not None else 2 * w
        if p < 2 * w:
            return None
        src = _checked_src(buf, p * (h - 1) + 2 * w)
        if src is None:
            return None
        y = np.empty((h, w), np.uint8)
        u = np.empty((h, w // 2), np.uint8)
        v = np.empty((h, w // 2), np.uint8)
        fn = (lib.vrt_yuy2_to_planar_p if kind == "yuy2"
              else lib.vrt_uyvy_to_planar_p)
        fn(_ptr(src, ctypes.c_uint8), w, h, p, _ptr(y, ctypes.c_uint8),
           _ptr(u, ctypes.c_uint8), _ptr(v, ctypes.c_uint8))
        return y, u, v
    if kind == "y210":
        p = pitch if pitch is not None else 4 * w
        if p < 4 * w or p % 2:
            return None
        src = _checked_src(buf, p * (h - 1) + 4 * w)
        if src is None:
            return None
        src = src.view(np.uint16)
        y = np.empty((h, w), np.uint16)
        u = np.empty((h, w // 2), np.uint16)
        v = np.empty((h, w // 2), np.uint16)
        lib.vrt_y210_to_planar_p(_ptr(src, ctypes.c_uint16), w, h, p,
                                 _ptr(y, ctypes.c_uint16),
                                 _ptr(u, ctypes.c_uint16),
                                 _ptr(v, ctypes.c_uint16))
        return y, u, v
    if kind == "v210":
        # 128-byte-aligned rows: 6 px / 16 bytes (vrt_v210_to_planar)
        tight = ((w + 47) // 48) * 128
        p = pitch if pitch is not None else tight
        if p < tight or p % 4:
            return None
        src = _checked_src(buf, p * (h - 1) + tight)
        if src is None:
            return None
        src = src.view(np.uint32)
        y = np.empty((h, w), np.uint16)
        u = np.empty((h, w // 2), np.uint16)
        v = np.empty((h, w // 2), np.uint16)
        lib.vrt_v210_to_planar_p(_ptr(src, ctypes.c_uint32), w, h, p,
                                 _ptr(y, ctypes.c_uint16),
                                 _ptr(u, ctypes.c_uint16),
                                 _ptr(v, ctypes.c_uint16))
        return y, u, v
    return None


def rgb_to_planar(buf: np.ndarray, w: int, h: int, kind: str,
                  pitch: int | None = None):
    """``pitch`` may be negative for bottom-up DIB rows (the RGB formats;
    the reference starts at srcData + srcPitch*(1 - lines),
    Source/DX11VideoProcessor.cpp:1245-1248)."""
    lib = _load()
    if lib is None:
        return None
    if kind in ("rgb24", "bgra32"):
        bpp = 3 if kind == "rgb24" else 4
        p = pitch if pitch is not None else bpp * w
        if abs(p) < bpp * w:
            return None
        src = _checked_src(buf, abs(p) * (h - 1) + bpp * w)
        if src is None:
            return None
        r = np.empty((h, w), np.uint8)
        g = np.empty((h, w), np.uint8)
        b = np.empty((h, w), np.uint8)
        fn = (lib.vrt_rgb24_to_planar_p if kind == "rgb24"
              else lib.vrt_bgra32_to_planar_p)
        fn(_ptr(src, ctypes.c_uint8), w, h, p, _ptr(r, ctypes.c_uint8),
           _ptr(g, ctypes.c_uint8), _ptr(b, ctypes.c_uint8))
        return r, g, b
    if kind == "r210":
        p = pitch if pitch is not None else 4 * w
        if p < 4 * w or p % 4:
            return None
        src = _checked_src(buf, p * (h - 1) + 4 * w)
        if src is None:
            return None
        src = src.view(np.uint32)
        r = np.empty((h, w), np.uint16)
        g = np.empty((h, w), np.uint16)
        b = np.empty((h, w), np.uint16)
        lib.vrt_r210_to_planar_p(_ptr(src, ctypes.c_uint32), w, h, p,
                                 _ptr(r, ctypes.c_uint16),
                                 _ptr(g, ctypes.c_uint16),
                                 _ptr(b, ctypes.c_uint16))
        return r, g, b
    return None


def pack_rgb8(rgb_hwc_or_chw: np.ndarray, chw: bool = True) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(rgb_hwc_or_chw, dtype=np.float32)
    if not chw:
        x = np.moveaxis(x, -1, 0)
        x = np.ascontiguousarray(x)
    c, h, w = x.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.vrt_pack_rgb8(_ptr(x[0], ctypes.c_float), _ptr(x[1], ctypes.c_float),
                      _ptr(x[2], ctypes.c_float),
                      _ptr(out, ctypes.c_uint8), h * w)
    return out


def pack_rgb10(rgb_chw: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(rgb_chw, dtype=np.float32)
    c, h, w = x.shape
    out = np.empty((h, w), np.uint32)
    lib.vrt_pack_rgb10(_ptr(x[0], ctypes.c_float), _ptr(x[1], ctypes.c_float),
                       _ptr(x[2], ctypes.c_float),
                       _ptr(out, ctypes.c_uint32), h * w)
    return out
