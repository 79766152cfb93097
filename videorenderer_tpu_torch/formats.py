"""Pixel-format registry and the surface decoders.

The registry is a port of the reference's ``ColorFormat_t`` enum
(Source/Helper.h:84-125) and its conversion table ``s_FmtConvMapping``
(Source/Helper.cpp:309-359), row for row the same as
``videorenderer_tpu.formats``.  Frames arrive as **canonical planar
textures**: 2D ``uint8`` or ``uint16`` planes, 10-bit data MSB-aligned into
16 bits, normalised by 255 / 65535 on the device like D3D UNORM sampling.
The host-side unpackers of packed formats are not ported yet (ROADMAP:
device ingest).
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


# decoders of the packed output surfaces (the pipeline's pack_surface output)

def unpack_rgb10(dwords: np.ndarray) -> np.ndarray:
    """R10G10B10A2 dwords -> float RGB [0,1] (H,W,3)."""
    r = (dwords & 0x3FF).astype(np.float32)
    g = ((dwords >> 10) & 0x3FF).astype(np.float32)
    b = ((dwords >> 20) & 0x3FF).astype(np.float32)
    return np.stack([r, g, b], axis=-1) / 1023.0


def unpack_rgba8(dwords: np.ndarray) -> np.ndarray:
    """Packed RGBA8 dwords (H,W) -> float RGB [0,1] (H,W,3)."""
    d = dwords.astype(np.uint32)
    r = (d & 0xFF).astype(np.float32)
    g = ((d >> 8) & 0xFF).astype(np.float32)
    b = ((d >> 16) & 0xFF).astype(np.float32)
    return np.stack([r, g, b], axis=-1) / 255.0
