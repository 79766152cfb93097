"""Pixel-format registry and the surface decoders.

The registry is a port of the reference's ``ColorFormat_t`` enum
(Source/Helper.h:84-125) and its conversion table ``s_FmtConvMapping``
(Source/Helper.cpp:309-359), row for row the same as
``videorenderer_tpu.formats``.  Frames arrive as **canonical planar
textures**: 2D ``uint8`` or ``uint16`` planes, 10-bit data MSB-aligned into
16 bits, normalised by 255 / 65535 on the device like D3D UNORM sampling.

The host half is a numpy copy of the JAX package's: :class:`PlanarFrame`,
:func:`unpack_frame` (the SIMD copiers' analogue, through the native
library of :mod:`.io.native` where it is built, numpy otherwise), pitched
and bottom-up buffers (:func:`repitch`), and the screenshot packers
(``pack_rgb8``/``pack_rgb10``/``pack_rgb16``, ``rgb10_dwords_to_bgr48``).
The device unpackers are :mod:`.kernels.unpack_device`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class ColorFormat(enum.IntEnum):
    """Port of ``ColorFormat_t`` (Source/Helper.h:84-125)."""

    NONE = 0
    NV12 = enum.auto()
    P010 = enum.auto()
    P016 = enum.auto()
    YUY2 = enum.auto()
    UYVY = enum.auto()
    P210 = enum.auto()
    P216 = enum.auto()
    Y210 = enum.auto()
    Y216 = enum.auto()
    V210 = enum.auto()
    AYUV = enum.auto()
    Y410 = enum.auto()
    Y416 = enum.auto()
    YV12 = enum.auto()
    YV16 = enum.auto()
    YV24 = enum.auto()
    YUV420P8 = enum.auto()
    YUV422P8 = enum.auto()
    YUV444P8 = enum.auto()
    YUV420P10 = enum.auto()
    YUV420P16 = enum.auto()
    YUV422P10 = enum.auto()
    YUV422P16 = enum.auto()
    YUV444P10 = enum.auto()
    YUV444P16 = enum.auto()
    GBRP8 = enum.auto()
    GBRP10 = enum.auto()
    GBRP16 = enum.auto()
    RGB24 = enum.auto()
    XRGB32 = enum.auto()
    ARGB32 = enum.auto()
    R210 = enum.auto()
    RGB48 = enum.auto()
    BGR48 = enum.auto()
    BGRA64 = enum.auto()
    B64A = enum.auto()
    Y8 = enum.auto()
    Y10 = enum.auto()
    Y16 = enum.auto()


class ColorSystem(enum.IntEnum):
    """Port of ``ColorSystem_t`` (Source/Helper.h:127-131)."""

    YUV = 0
    RGB = 1
    GRAY = 2


@dataclass(frozen=True)
class FormatInfo:
    """Descriptor row — port of ``FmtConvParams_t`` (Source/Helper.h:151-165),
    keeping the fields that are meaningful off-Windows.

    ``pack_size``/``pitch_coeff`` follow the reference's buffer-size rules
    (pitch = width * pack_size; buffer = pitch * height * pitch_coeff / 2).
    ``plane_bits`` is the canonical texture depth (8 or 16) after unpacking,
    i.e. the UNORM normalization is ``/ (2**plane_bits - 1)``.
    """

    cformat: ColorFormat
    name: str
    pack_size: float        # bytes per pixel of the packed representation
    pitch_coeff: int        # total buffer = width*pack_size*height*pitch_coeff/2
    cs_type: ColorSystem
    subsampling: int        # 420 / 422 / 444 / 400
    depth: int              # CDepth: effective bit depth fed to the matrix
    plane_bits: int         # 8 or 16: canonical texture depth after unpack

    @property
    def chroma_div(self) -> tuple[int, int]:
        """(div_w, div_h) of chroma planes vs luma (DX11PlaneConfig div)."""
        if self.cs_type != ColorSystem.YUV:
            return (1, 1)
        return {420: (2, 2), 422: (2, 1), 444: (1, 1), 400: (1, 1)}[self.subsampling]

    @property
    def num_planes(self) -> int:
        if self.cs_type == ColorSystem.GRAY:
            return 1
        return 3

    def plane_shapes(self, width: int, height: int) -> list[tuple[int, int]]:
        if self.cs_type == ColorSystem.GRAY:
            return [(height, width)]
        dw, dh = self.chroma_div
        if self.cs_type == ColorSystem.YUV:
            return [(height, width), (height // dh, width // dw), (height // dh, width // dw)]
        return [(height, width)] * 3

    def buffer_size(self, width: int, height: int) -> int:
        return int(width * self.pack_size) * height * self.pitch_coeff // 2


# Registry — one row per format, mirroring s_FmtConvMapping
# (Source/Helper.cpp:309-359). plane_bits follows the D3D plane format column:
# R8 planes -> 8, R16/R16G16/RGBA16/RGB10A2 planes -> 16.
_T = FormatInfo
FORMATS: dict[ColorFormat, FormatInfo] = {f.cformat: f for f in [
    _T(ColorFormat.NV12,      "NV12",      1,   3, ColorSystem.YUV, 420,  8,  8),
    _T(ColorFormat.P010,      "P010",      2,   3, ColorSystem.YUV, 420, 16, 16),
    _T(ColorFormat.P016,      "P016",      2,   3, ColorSystem.YUV, 420, 16, 16),
    _T(ColorFormat.YUY2,      "YUY2",      2,   2, ColorSystem.YUV, 422,  8,  8),
    _T(ColorFormat.UYVY,      "UYVY",      2,   2, ColorSystem.YUV, 422,  8,  8),
    _T(ColorFormat.P210,      "P210",      2,   4, ColorSystem.YUV, 422, 16, 16),
    _T(ColorFormat.P216,      "P216",      2,   4, ColorSystem.YUV, 422, 16, 16),
    _T(ColorFormat.Y210,      "Y210",      4,   2, ColorSystem.YUV, 422, 10, 16),
    _T(ColorFormat.Y216,      "Y216",      4,   2, ColorSystem.YUV, 422, 16, 16),
    _T(ColorFormat.V210,      "v210",      8/3, 2, ColorSystem.YUV, 422, 10, 16),
    _T(ColorFormat.AYUV,      "AYUV",      4,   2, ColorSystem.YUV, 444,  8,  8),
    _T(ColorFormat.Y410,      "Y410",      4,   2, ColorSystem.YUV, 444, 10, 16),
    _T(ColorFormat.Y416,      "Y416",      8,   2, ColorSystem.YUV, 444, 16, 16),
    _T(ColorFormat.YV12,      "YV12",      1,   3, ColorSystem.YUV, 420,  8,  8),
    _T(ColorFormat.YV16,      "YV16",      1,   4, ColorSystem.YUV, 422,  8,  8),
    _T(ColorFormat.YV24,      "YV24",      1,   6, ColorSystem.YUV, 444,  8,  8),
    _T(ColorFormat.YUV420P8,  "YUV420P8",  1,   3, ColorSystem.YUV, 420,  8,  8),
    _T(ColorFormat.YUV422P8,  "YUV422P8",  1,   4, ColorSystem.YUV, 422,  8,  8),
    _T(ColorFormat.YUV444P8,  "YUV444P8",  1,   6, ColorSystem.YUV, 444,  8,  8),
    _T(ColorFormat.YUV420P10, "YUV420P10", 2,   3, ColorSystem.YUV, 420, 10, 16),
    _T(ColorFormat.YUV420P16, "YUV420P16", 2,   3, ColorSystem.YUV, 420, 16, 16),
    _T(ColorFormat.YUV422P10, "YUV422P10", 2,   4, ColorSystem.YUV, 422, 10, 16),
    _T(ColorFormat.YUV422P16, "YUV422P16", 2,   4, ColorSystem.YUV, 422, 16, 16),
    _T(ColorFormat.YUV444P10, "YUV444P10", 2,   6, ColorSystem.YUV, 444, 10, 16),
    _T(ColorFormat.YUV444P16, "YUV444P16", 2,   6, ColorSystem.YUV, 444, 16, 16),
    _T(ColorFormat.GBRP8,     "GBRP8",     1,   6, ColorSystem.RGB, 444,  8,  8),
    _T(ColorFormat.GBRP10,    "GBRP10",    2,   6, ColorSystem.RGB, 444, 10, 16),
    _T(ColorFormat.GBRP16,    "GBRP16",    2,   6, ColorSystem.RGB, 444, 16, 16),
    _T(ColorFormat.RGB24,     "RGB24",     3,   2, ColorSystem.RGB, 444,  8,  8),
    _T(ColorFormat.XRGB32,    "RGB32",     4,   2, ColorSystem.RGB, 444,  8,  8),
    _T(ColorFormat.ARGB32,    "ARGB32",    4,   2, ColorSystem.RGB, 444,  8,  8),
    _T(ColorFormat.R210,      "r210",      4,   2, ColorSystem.RGB, 444, 10, 16),
    _T(ColorFormat.RGB48,     "RGB48",     6,   2, ColorSystem.RGB, 444, 16, 16),
    _T(ColorFormat.BGR48,     "BGR48",     6,   2, ColorSystem.RGB, 444, 16, 16),
    _T(ColorFormat.BGRA64,    "BGRA64",    8,   2, ColorSystem.RGB, 444, 16, 16),
    _T(ColorFormat.B64A,      "b64a",      8,   2, ColorSystem.RGB, 444, 16, 16),
    _T(ColorFormat.Y8,        "Y8",        1,   2, ColorSystem.GRAY, 400,  8,  8),
    _T(ColorFormat.Y10,       "Y10",       2,   2, ColorSystem.GRAY, 400, 10, 16),
    _T(ColorFormat.Y16,       "Y16",       2,   2, ColorSystem.GRAY, 400, 16, 16),
]}


def get_format_info(fmt: ColorFormat) -> FormatInfo:
    """Port of ``GetFmtConvParams`` (Source/Helper.cpp:366-370)."""
    return FORMATS[fmt]


@dataclass
class PlanarFrame:
    """Canonical unpacked frame: planes in texture representation.

    ``planes`` are 2D numpy arrays, uint8 or uint16, ordered (Y,U,V), (R,G,B)
    or (Y,) per the format's color system.  Values follow D3D UNORM texture
    semantics — normalize by ``2**info.plane_bits - 1`` on device.
    """

    info: FormatInfo
    width: int
    height: int
    planes: tuple[np.ndarray, ...]


# ---------------------------------------------------------------------------
# unpackers (host side; numpy-vectorized analogues of the SIMD copiers)
# ---------------------------------------------------------------------------

def _as_u8(buf: bytes | np.ndarray) -> np.ndarray:
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) else buf
    return a.reshape(-1).view(np.uint8)


def _shift10to16(p: np.ndarray) -> np.ndarray:
    """10-bit LSB data -> MSB-aligned 16-bit (CopyPlane10to16, value << 6)."""
    return (p.astype(np.uint16) << 6)


def _unpack_biplanar(buf, w, h, dtype, div_h):
    a = _as_u8(buf).view(dtype)
    y = a[: w * h].reshape(h, w)
    ch = h // div_h
    uv = a[w * h: w * h + w * ch].reshape(ch, w // 2, 2)
    return y, uv[..., 0], uv[..., 1]


def _unpack_planar(buf, w, h, dtype, div_w, div_h, order=(0, 1, 2)):
    a = _as_u8(buf).view(dtype)
    cw, ch = w // div_w, h // div_h
    p0 = a[: w * h].reshape(h, w)
    p1 = a[w * h: w * h + cw * ch].reshape(ch, cw)
    p2 = a[w * h + cw * ch: w * h + 2 * cw * ch].reshape(ch, cw)
    planes = [p0, p1, p2]
    return tuple(planes[i] for i in order)


# ---------------------------------------------------------------------------
# pitched (strided) buffers — real decoder output pads rows to alignment
# boundaries; the reference negotiates the pitch and every copier honors it
# (srcPitch through GetCopyPlaneFunction, Source/Helper.cpp:377-428;
# per-plane pitch rules in MemCopyToTexSrcVideo,
# Source/DX11VideoProcessor.cpp:1213-1252)
# ---------------------------------------------------------------------------

# formats whose buffer is luma rows followed by interleaved-chroma rows at
# the same pitch
_BIPLANAR = frozenset({ColorFormat.NV12, ColorFormat.P010, ColorFormat.P016,
                       ColorFormat.P210, ColorFormat.P216})
# three separate planes; chroma pitch = luma pitch / div_chroma_w
_PLANAR3 = frozenset({
    ColorFormat.YV12, ColorFormat.YV16, ColorFormat.YV24,
    ColorFormat.YUV420P8, ColorFormat.YUV422P8, ColorFormat.YUV444P8,
    ColorFormat.YUV420P10, ColorFormat.YUV420P16,
    ColorFormat.YUV422P10, ColorFormat.YUV422P16,
    ColorFormat.YUV444P10, ColorFormat.YUV444P16,
    ColorFormat.GBRP8, ColorFormat.GBRP10, ColorFormat.GBRP16,
})


def plane_segments(info: FormatInfo, w: int, h: int) -> list[tuple[int, int, int]]:
    """Pitched-buffer row structure: [(rows, tight_row_bytes, pitch_div)]
    per stored plane, where a segment's actual pitch is the negotiated luma
    pitch // pitch_div (the MemCopyToTexSrcVideo rules)."""
    f = info.cformat
    it = int(info.pack_size)
    if f in _BIPLANAR:
        dh = info.chroma_div[1]
        return [(h, w * it, 1), (h // dh, w * it, 1)]
    if f in _PLANAR3:
        dw, dh = info.chroma_div
        cw, ch = w // dw, h // dh
        return [(h, w * it, 1), (ch, cw * it, dw), (ch, cw * it, dw)]
    if f == ColorFormat.V210:
        return [(h, ((w + 47) // 48) * 128, 1)]
    return [(h, int(w * info.pack_size), 1)]


def default_pitch(info: FormatInfo, w: int) -> int:
    """Tightly-packed luma/packed-row pitch in bytes."""
    return plane_segments(info, w, 1)[0][1]


def repitch(fmt: ColorFormat, buf, w: int, h: int, pitch: int) -> np.ndarray:
    """Strip row padding from a pitched frame buffer -> tightly-packed bytes
    the unpackers consume.  Negative pitch = bottom-up rows (DIB RGB
    convention; the reference starts at ``srcData + srcPitch*(1 - lines)``,
    Source/DX11VideoProcessor.cpp:1245-1248)."""
    info = FORMATS[fmt]
    a = _as_u8(buf)
    segs = plane_segments(info, w, h)
    if pitch < 0:
        if len(segs) != 1:
            raise ValueError("negative (bottom-up) pitch is only defined "
                             "for packed single-plane formats")
        rows, tight, _ = segs[0]
        p = -pitch
        if p < tight:
            raise ValueError(f"|pitch| {p} < row size {tight}")
        if a.size < p * (rows - 1) + tight:
            raise ValueError("buffer too small for pitched frame")
        view = np.lib.stride_tricks.as_strided(a, shape=(rows, tight),
                                               strides=(p, 1))
        return np.ascontiguousarray(view[::-1]).reshape(-1)
    parts = []
    off = 0
    for rows, tight, div in segs:
        p = pitch // div
        if p < tight:
            raise ValueError(f"pitch {pitch} too small: plane rows need "
                             f"{tight * div} bytes")
        if a.size < off + p * (rows - 1) + tight:
            raise ValueError("buffer too small for pitched frame")
        view = np.lib.stride_tricks.as_strided(a[off:], shape=(rows, tight),
                                               strides=(p, 1))
        parts.append(np.ascontiguousarray(view).reshape(-1))
        off += p * rows
    return np.concatenate(parts)


def pitched_buffer_size(fmt: ColorFormat, w: int, h: int, pitch: int) -> int:
    """Total bytes of one frame at the given luma pitch."""
    return sum((abs(pitch) // div) * rows
               for rows, _, div in plane_segments(FORMATS[fmt], w, h))


# Native (C++) repack acceleration — the SIMD-copier dispatch analogue.
# Set False to force the pure-numpy path.
USE_NATIVE = True


def _try_native(fmt: ColorFormat, buf, w: int, h: int,
                pitch: int | None = None):
    if not USE_NATIVE:
        return None
    try:
        from .io import native
    except Exception:
        return None
    if not native.available():
        return None
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(
        buf, (bytes, bytearray, memoryview)) else np.asarray(buf)
    F = ColorFormat
    if fmt == F.NV12:
        return native.nv12_split(a, w, h, pitch=pitch)
    if fmt in (F.P010, F.P016):
        return native.p010_split(a, w, h, 2, pitch=pitch)
    if fmt in (F.P210, F.P216):
        return native.p010_split(a, w, h, 1, pitch=pitch)
    if fmt == F.YUY2:
        return native.packed422_to_planar(a, w, h, "yuy2", pitch=pitch)
    if fmt == F.UYVY:
        return native.packed422_to_planar(a, w, h, "uyvy", pitch=pitch)
    if fmt in (F.Y210, F.Y216):
        return native.packed422_to_planar(a, w, h, "y210", pitch=pitch)
    if fmt == F.V210:
        return native.packed422_to_planar(a, w, h, "v210", pitch=pitch)
    if fmt == F.RGB24:
        return native.rgb_to_planar(a, w, h, "rgb24", pitch=pitch)
    if fmt in (F.XRGB32, F.ARGB32):
        return native.rgb_to_planar(a, w, h, "bgra32", pitch=pitch)
    if fmt == F.R210:
        return native.rgb_to_planar(a, w, h, "r210", pitch=pitch)
    return None


def unpack_frame(fmt: ColorFormat, buf: bytes | np.ndarray, width: int,
                 height: int, pitch: int | None = None) -> PlanarFrame:
    """Unpack raw frame bytes into canonical planes.

    Replacement for the copy-function dispatch ``GetCopyPlaneFunction``
    (Source/Helper.cpp:377-412) plus the per-format ``MemCopyToTexSrcVideo``
    plane split (Source/DX11VideoProcessor.cpp:1213-1252).  Hot formats
    dispatch to the native C++ library when built; numpy otherwise.

    ``pitch``: bytes per luma/packed row when the buffer has padded strides
    (real decoder output); None or the tight pitch means packed rows.
    Negative = bottom-up rows (DIB RGB).
    """
    info = FORMATS[fmt]
    w, h = width, height
    F = ColorFormat

    if pitch is not None and pitch != default_pitch(info, w):
        # pitched native fast path: the *_p copiers take src_pitch directly
        # (Source/Helper.cpp:414-428) — no intermediate repitch copy
        native_planes = _try_native(fmt, buf, w, h, pitch=pitch)
        if native_planes is not None:
            return PlanarFrame(info=info, width=w, height=h,
                               planes=tuple(native_planes))
        buf = repitch(fmt, buf, w, h, pitch)

    native_planes = _try_native(fmt, buf, w, h)
    if native_planes is not None:
        return PlanarFrame(info=info, width=w, height=h,
                           planes=tuple(native_planes))

    if fmt in (F.NV12,):
        y, u, v = _unpack_biplanar(buf, w, h, np.uint8, 2)
        planes = (y, u, v)
    elif fmt in (F.P010, F.P016):
        y, u, v = _unpack_biplanar(buf, w, h, np.uint16, 2)
        planes = (y, u, v)
    elif fmt in (F.P210, F.P216):
        y, u, v = _unpack_biplanar(buf, w, h, np.uint16, 1)
        planes = (y, u, v)
    elif fmt == F.YUY2:  # Y0 U Y1 V
        a = _as_u8(buf).reshape(h, w // 2, 4)
        y = a[..., 0::2].reshape(h, w)
        planes = (y, a[..., 1], a[..., 3])
    elif fmt == F.UYVY:  # U Y0 V Y1
        a = _as_u8(buf).reshape(h, w // 2, 4)
        y = a[..., 1::2].reshape(h, w)
        planes = (y, a[..., 0], a[..., 2])
    elif fmt in (F.Y210, F.Y216):  # 16-bit Y0 U Y1 V (Y210: 10-bit MSB-aligned)
        a = _as_u8(buf).view(np.uint16).reshape(h, w // 2, 4)
        y = a[..., 0::2].reshape(h, w)
        planes = (y, a[..., 1], a[..., 3])
    elif fmt == F.V210:
        planes = _unpack_v210(buf, w, h)
    elif fmt == F.AYUV:  # byte order V U Y A (MSDN AYUV layout)
        a = _as_u8(buf).reshape(h, w, 4)
        planes = (a[..., 2], a[..., 1], a[..., 0])
    elif fmt == F.Y410:  # dword: U(0-9) Y(10-19) V(20-29) A(30-31)
        a = _as_u8(buf).view(np.uint32).reshape(h, w)
        u = _shift10to16((a & 0x3FF).astype(np.uint16))
        y = _shift10to16(((a >> 10) & 0x3FF).astype(np.uint16))
        v = _shift10to16(((a >> 20) & 0x3FF).astype(np.uint16))
        planes = (y, u, v)
    elif fmt == F.Y416:  # u16 x4: U Y V A
        a = _as_u8(buf).view(np.uint16).reshape(h, w, 4)
        planes = (a[..., 1], a[..., 0], a[..., 2])
    elif fmt in (F.YV12,):  # planar, V before U (Source/Helper.cpp:159-165 swizzle)
        planes = _unpack_planar(buf, w, h, np.uint8, 2, 2, order=(0, 2, 1))
    elif fmt == F.YV16:
        planes = _unpack_planar(buf, w, h, np.uint8, 2, 1, order=(0, 2, 1))
    elif fmt == F.YV24:
        planes = _unpack_planar(buf, w, h, np.uint8, 1, 1, order=(0, 2, 1))
    elif fmt == F.YUV420P8:
        planes = _unpack_planar(buf, w, h, np.uint8, 2, 2)
    elif fmt == F.YUV422P8:
        planes = _unpack_planar(buf, w, h, np.uint8, 2, 1)
    elif fmt == F.YUV444P8:
        planes = _unpack_planar(buf, w, h, np.uint8, 1, 1)
    elif fmt in (F.YUV420P10, F.YUV420P16):
        planes = _unpack_planar(buf, w, h, np.uint16, 2, 2)
        if fmt == F.YUV420P10:
            planes = tuple(_shift10to16(p) for p in planes)
    elif fmt in (F.YUV422P10, F.YUV422P16):
        planes = _unpack_planar(buf, w, h, np.uint16, 2, 1)
        if fmt == F.YUV422P10:
            planes = tuple(_shift10to16(p) for p in planes)
    elif fmt in (F.YUV444P10, F.YUV444P16):
        planes = _unpack_planar(buf, w, h, np.uint16, 1, 1)
        if fmt == F.YUV444P10:
            planes = tuple(_shift10to16(p) for p in planes)
    elif fmt in (F.GBRP8, F.GBRP10, F.GBRP16):
        dtype = np.uint8 if fmt == F.GBRP8 else np.uint16
        g, b, r = _unpack_planar(buf, w, h, dtype, 1, 1)
        if fmt == F.GBRP10:
            r, g, b = _shift10to16(r), _shift10to16(g), _shift10to16(b)
        planes = (r, g, b)
    elif fmt == F.RGB24:  # BGR byte order (DIB convention, CopyFrameRGB24)
        a = _as_u8(buf).reshape(h, w, 3)
        planes = (a[..., 2], a[..., 1], a[..., 0])
    elif fmt in (F.XRGB32, F.ARGB32):  # BGRA byte order
        a = _as_u8(buf).reshape(h, w, 4)
        planes = (a[..., 2], a[..., 1], a[..., 0])
    elif fmt == F.R210:  # big-endian dword, 2b pad | R10 | G10 | B10 (CopyFrameR210)
        a = _as_u8(buf).view(np.uint32).reshape(h, w).byteswap()
        r = _shift10to16(((a >> 20) & 0x3FF).astype(np.uint16))
        g = _shift10to16(((a >> 10) & 0x3FF).astype(np.uint16))
        b = _shift10to16((a & 0x3FF).astype(np.uint16))
        planes = (r, g, b)
    elif fmt == F.RGB48:  # u16 R G B (CopyFrameRGB48)
        a = _as_u8(buf).view(np.uint16).reshape(h, w, 3)
        planes = (a[..., 0], a[..., 1], a[..., 2])
    elif fmt == F.BGR48:  # u16 B G R (CopyFrameBGR48)
        a = _as_u8(buf).view(np.uint16).reshape(h, w, 3)
        planes = (a[..., 2], a[..., 1], a[..., 0])
    elif fmt == F.BGRA64:  # u16 B G R A (CopyFrameBGRA64)
        a = _as_u8(buf).view(np.uint16).reshape(h, w, 4)
        planes = (a[..., 2], a[..., 1], a[..., 0])
    elif fmt == F.B64A:  # big-endian u16 A R G B (CopyFrameB64A)
        a = _as_u8(buf).view(np.uint16).reshape(h, w, 4).byteswap()
        planes = (a[..., 1], a[..., 2], a[..., 3])
    elif fmt == F.Y8:
        planes = (_as_u8(buf)[: w * h].reshape(h, w),)
    elif fmt in (F.Y10, F.Y16):
        p = _as_u8(buf).view(np.uint16)[: w * h].reshape(h, w)
        planes = (_shift10to16(p) if fmt == F.Y10 else p,)
    else:
        raise ValueError(f"unsupported format: {fmt!r}")

    planes = tuple(np.ascontiguousarray(p) for p in planes)
    return PlanarFrame(info=info, width=w, height=h, planes=planes)


def _unpack_v210(buf, w, h) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """v210: 6 pixels per 16 bytes; each dword packs three 10-bit values
    (little-endian, bits 0-9 / 10-19 / 20-29) in the component sequence
    U0 Y0 V0 | Y1 U2 Y2 | V2 Y3 U4 | Y4 V4 Y5  (CopyFrameV210,
    Source/Helper.cpp:703-760 converts this to Y210; we go straight to
    planar 16-bit MSB-aligned).
    """
    row_dwords = ((w + 47) // 48) * 32  # 128-byte aligned rows
    a = _as_u8(buf).view(np.uint32).reshape(h, row_dwords)
    c0 = (a & 0x3FF).astype(np.uint16)
    c1 = ((a >> 10) & 0x3FF).astype(np.uint16)
    c2 = ((a >> 20) & 0x3FF).astype(np.uint16)
    # per group of 4 dwords: components [U0 Y0 V0][Y1 U2 Y2][V2 Y3 U4][Y4 V4 Y5]
    g = row_dwords // 4
    c0 = c0.reshape(h, g, 4)
    c1 = c1.reshape(h, g, 4)
    c2 = c2.reshape(h, g, 4)
    y = np.empty((h, g, 6), np.uint16)
    y[..., 0] = c1[..., 0]
    y[..., 1] = c0[..., 1]
    y[..., 2] = c2[..., 1]
    y[..., 3] = c1[..., 2]
    y[..., 4] = c0[..., 3]
    y[..., 5] = c2[..., 3]
    u = np.empty((h, g, 3), np.uint16)
    u[..., 0] = c0[..., 0]
    u[..., 1] = c1[..., 1]
    u[..., 2] = c2[..., 2]
    v = np.empty((h, g, 3), np.uint16)
    v[..., 0] = c2[..., 0]
    v[..., 1] = c0[..., 2]
    v[..., 2] = c1[..., 3]
    y = y.reshape(h, g * 6)[:, :w]
    u = u.reshape(h, g * 3)[:, : w // 2]
    v = v.reshape(h, g * 3)[:, : w // 2]
    return _shift10to16(y), _shift10to16(u), _shift10to16(v)


# ---------------------------------------------------------------------------
# output packers (screenshot/sink path analogues:
# ConvertR10G10B10A2toBGR32/48/64, Source/Helper.cpp:828-900)
# ---------------------------------------------------------------------------

def pack_rgb8(rgb: np.ndarray) -> np.ndarray:
    """float RGB [0,1] (H,W,3) -> interleaved uint8 (H,W,3)."""
    return np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)


def pack_rgb10(rgb: np.ndarray) -> np.ndarray:
    """float RGB [0,1] (H,W,3) -> R10G10B10A2 dwords (H,W) uint32."""
    q = np.clip(np.rint(rgb * 1023.0), 0, 1023).astype(np.uint32)
    return q[..., 0] | (q[..., 1] << 10) | (q[..., 2] << 20) | np.uint32(0xC0000000)


def unpack_rgb10(dwords: np.ndarray) -> np.ndarray:
    """R10G10B10A2 dwords -> float RGB [0,1] (H,W,3)."""
    r = (dwords & 0x3FF).astype(np.float32)
    g = ((dwords >> 10) & 0x3FF).astype(np.float32)
    b = ((dwords >> 20) & 0x3FF).astype(np.float32)
    return np.stack([r, g, b], axis=-1) / 1023.0


def pack_rgb16(rgb: np.ndarray) -> np.ndarray:
    """float RGB [0,1] (H,W,3) -> interleaved uint16 (H,W,3)."""
    return np.clip(np.rint(rgb * 65535.0), 0, 65535).astype(np.uint16)


def rgb10_dwords_to_bgr48(dwords: np.ndarray) -> np.ndarray:
    """R10G10B10A2 dwords (H,W) -> interleaved BGR48 uint16 (H,W,3), the
    10-bit codes MSB-aligned (<<6) in B,G,R channel order — exactly
    ConvertR10G10B10A2toBGR48 (Source/Helper.cpp:836-857), the reference's
    10-bit GetDisplayedImage conversion
    (Source/DX11VideoProcessor.cpp:3622-3696)."""
    d = dwords.astype(np.uint32)
    b = ((d >> 20) & 0x3FF).astype(np.uint16) << 6
    g = ((d >> 10) & 0x3FF).astype(np.uint16) << 6
    r = (d & 0x3FF).astype(np.uint16) << 6
    return np.stack([b, g, r], axis=-1)


def unpack_rgba8(dwords: np.ndarray) -> np.ndarray:
    """Packed RGBA8 dwords (H,W) -> float RGB [0,1] (H,W,3)."""
    d = dwords.astype(np.uint32)
    r = (d & 0xFF).astype(np.float32)
    g = ((d >> 8) & 0xFF).astype(np.float32)
    b = ((d >> 16) & 0xFF).astype(np.float32)
    return np.stack([r, g, b], axis=-1) / 255.0
