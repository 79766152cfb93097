"""Device-side packed-format unpacking (v210 / Y210 / biplanar UV split /
packed RGB) — the port of ``videorenderer_tpu.kernels.unpack_device``.

A production ingest path ships the *packed* bytes to the card (the smallest
transfer) and unpacks there, the analogue of the reference sampling packed
textures on the GPU (Source/Shaders.cpp:82-529) instead of repacking on the
CPU (Source/Helper.cpp:703-760 CopyFrameV210,
Source/DX11VideoProcessor.cpp:1213-1252 plane binding).  Like the JAX
file's ``jnp`` ops, these are plain torch bit operations on the tensor's
own device: slices and reshapes for the byte-aligned formats, masks and
shifts for the 10-bit ones.

Every unpacker takes a flat (..., n_words) buffer of the format's word
(``DEVICE_BUFFER_DTYPE``; the signed type of the same size works too) and
returns contiguous planes of the dtype and values the host
:func:`~videorenderer_tpu_torch.formats.unpack_frame` gives: uint8 for
the 8-bit formats, uint16 for the others (10-bit codes MSB-aligned, <<6).
No unsigned arithmetic runs: 16- and 32-bit words are read through their
signed views, widened and masked after every shift, the big-endian words
of r210 and b64a are byte-swapped as bytes, and 16-bit planes are made as
int16 and viewed as uint16.
"""

from __future__ import annotations

import numpy as np
import torch

# the signed view of each word type (uint8 stays uint8)
_SIGNED = {torch.uint8: torch.uint8, torch.int8: torch.uint8,
           torch.uint16: torch.int16, torch.int16: torch.int16,
           torch.uint32: torch.int32, torch.int32: torch.int32}


def _signed(buf: torch.Tensor) -> torch.Tensor:
    return buf.view(_SIGNED[buf.dtype])


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int16 words, or int32 codes in [0, 65535], -> a contiguous uint16
    plane with the same 16 bits."""
    if x.dtype != torch.int16:
        x = x.to(torch.int16)       # keeps the low 16 bits
    return x.contiguous().view(torch.uint16)


def _plane(x: torch.Tensor) -> torch.Tensor:
    """A slice of the buffer as a contiguous plane of its format's dtype."""
    return _u16(x) if x.dtype == torch.int16 else x.contiguous()


def _shift10to16(v: torch.Tensor) -> torch.Tensor:
    """10-bit codes (int32) -> MSB-aligned 16-bit (the <<6 texture
    convention)."""
    return _u16(v << 6)


def _byteswap(words: torch.Tensor) -> torch.Tensor:
    """Reverse the bytes of each int16/int32 word (big-endian containers)."""
    n = words.element_size()
    b = words.contiguous().view(torch.uint8)
    b = b.reshape(b.shape[:-1] + (-1, n)).flip(-1).reshape(b.shape)
    return b.view(words.dtype)


def v210_unpack_device(dwords: torch.Tensor, width: int):
    """(..., row_dwords) v210 rows -> (Y, U, V) uint16 MSB-aligned planes
    ((..., W), (..., W/2), (..., W/2)).

    v210 packs 6 pixels per 4 dwords with the component sequence
    U0 Y0 V0 | Y1 U2 Y2 | V2 Y3 U4 | Y4 V4 Y5 (10 bits each, little-endian).
    """
    d = _signed(dwords)
    lead = d.shape[:-1]
    groups = d.shape[-1] // 4
    d = d.reshape(lead + (groups, 4))
    c0 = d & 0x3FF
    c1 = (d >> 10) & 0x3FF
    c2 = (d >> 20) & 0x3FF
    y = torch.stack([c1[..., 0], c0[..., 1], c2[..., 1],
                     c1[..., 2], c0[..., 3], c2[..., 3]], dim=-1)
    u = torch.stack([c0[..., 0], c1[..., 1], c2[..., 2]], dim=-1)
    v = torch.stack([c2[..., 0], c0[..., 2], c1[..., 3]], dim=-1)
    y = y.reshape(lead + (groups * 6,))[..., :width]
    u = u.reshape(lead + (groups * 3,))[..., :width // 2]
    v = v.reshape(lead + (groups * 3,))[..., :width // 2]
    return _shift10to16(y), _shift10to16(u), _shift10to16(v)


def y210_unpack_device(words: torch.Tensor, width: int):
    """(..., W*2) Y210/Y216 rows (Y0 U Y1 V) -> (Y, U, V) uint16 planes."""
    w = _signed(words)
    lead = w.shape[:-1]
    q = w.reshape(lead + (width // 2, 4))
    y = q[..., 0::2].reshape(lead + (width,))
    return _plane(y), _plane(q[..., 1]), _plane(q[..., 3])


def ayuv_unpack_device(buf: torch.Tensor, width: int, height: int):
    """(..., H*W*4) uint8 AYUV (byte order V U Y A, MSDN layout) ->
    (Y, U, V) uint8 planes (the reference samples it on the GPU,
    Source/Shaders.cpp:120-127)."""
    a = buf.reshape(buf.shape[:-1] + (height, width, 4))
    return _plane(a[..., 2]), _plane(a[..., 1]), _plane(a[..., 0])


def y410_unpack_device(dwords: torch.Tensor, width: int, height: int):
    """(..., H*W) Y410 dwords (U 0-9 | Y 10-19 | V 20-29 | A) -> (Y, U, V)
    uint16 MSB-aligned planes."""
    d = _signed(dwords)
    d = d.reshape(d.shape[:-1] + (height, width))
    u = _shift10to16(d & 0x3FF)
    y = _shift10to16((d >> 10) & 0x3FF)
    v = _shift10to16((d >> 20) & 0x3FF)
    return y, u, v


def y416_unpack_device(words: torch.Tensor, width: int, height: int):
    """(..., H*W*4) Y416 (U Y V A) -> (Y, U, V) uint16 planes."""
    w = _signed(words)
    a = w.reshape(w.shape[:-1] + (height, width, 4))
    return _plane(a[..., 1]), _plane(a[..., 0]), _plane(a[..., 2])


def rgb24_unpack_device(buf: torch.Tensor, width: int, height: int):
    """(..., H*W*3) uint8 BGR (DIB convention, CopyFrameRGB24
    Source/Helper.cpp:430-470) -> (R, G, B) uint8 planes."""
    a = buf.reshape(buf.shape[:-1] + (height, width, 3))
    return _plane(a[..., 2]), _plane(a[..., 1]), _plane(a[..., 0])


def bgra32_unpack_device(buf: torch.Tensor, width: int, height: int):
    """(..., H*W*4) uint8 BGRA/BGRX -> (R, G, B) uint8 planes."""
    a = buf.reshape(buf.shape[:-1] + (height, width, 4))
    return _plane(a[..., 2]), _plane(a[..., 1]), _plane(a[..., 0])


def rgb48_unpack_device(words: torch.Tensor, width: int, height: int,
                        order: str = "rgb"):
    """(..., H*W*3) RGB48/BGR48 -> (R, G, B) uint16 planes
    (CopyFrameRGB48/CopyFrameBGR48, Source/Helper.cpp:472-530)."""
    w = _signed(words)
    a = w.reshape(w.shape[:-1] + (height, width, 3))
    if order == "bgr":
        return _plane(a[..., 2]), _plane(a[..., 1]), _plane(a[..., 0])
    return _plane(a[..., 0]), _plane(a[..., 1]), _plane(a[..., 2])


def bgra64_unpack_device(words: torch.Tensor, width: int, height: int):
    """(..., H*W*4) BGRA64 -> (R, G, B) uint16 planes."""
    w = _signed(words)
    a = w.reshape(w.shape[:-1] + (height, width, 4))
    return _plane(a[..., 2]), _plane(a[..., 1]), _plane(a[..., 0])


def b64a_unpack_device(words: torch.Tensor, width: int, height: int):
    """(..., H*W*4) b64a (big-endian A R G B, CopyFrameB64A) -> (R, G, B)
    uint16 planes."""
    sw = _byteswap(_signed(words))
    a = sw.reshape(sw.shape[:-1] + (height, width, 4))
    return _plane(a[..., 1]), _plane(a[..., 2]), _plane(a[..., 3])


def r210_unpack_device(dwords: torch.Tensor, width: int, height: int):
    """(..., H*W) r210 big-endian dwords -> (R, G, B) uint16 MSB-aligned
    planes (CopyFrameR210, Source/Helper.cpp:762-790)."""
    sw = _byteswap(_signed(dwords))
    d = sw.reshape(sw.shape[:-1] + (height, width))
    r = _shift10to16((d >> 20) & 0x3FF)
    g = _shift10to16((d >> 10) & 0x3FF)
    b = _shift10to16(d & 0x3FF)
    return r, g, b


def p01x_split_device(buf: torch.Tensor, width: int, height: int,
                      div_h: int = 2):
    """(..., H*W + (H//div_h)*W) biplanar buffer (NV12 uint8; P010/P016/
    P210/P216 16-bit words) -> (Y, U, V) planes."""
    b = _signed(buf)
    lead = b.shape[:-1]
    ysize = width * height
    y = b[..., :ysize].reshape(lead + (height, width))
    uv = b[..., ysize:].reshape(lead + (height // div_h, width // 2, 2))
    return _plane(y), _plane(uv[..., 0]), _plane(uv[..., 1])


def nv12_split_device(buf: torch.Tensor, width: int, height: int):
    """(..., H*W*3/2) uint8/uint16 NV12/P010 buffer -> (Y, U, V) planes (the
    JAX package's name for :func:`p01x_split_device` with 4:2:0 chroma)."""
    return p01x_split_device(buf, width, height)


def yuy2_unpack_device(buf: torch.Tensor, width: int, height: int,
                       order: str = "yuy2"):
    """(..., H*W*2) uint8 YUY2 (Y0 U Y1 V) or UYVY (U Y0 V Y1) -> planar."""
    lead = buf.shape[:-1]
    q = buf.reshape(lead + (height, width // 2, 4))
    if order == "uyvy":
        y = torch.stack([q[..., 1], q[..., 3]], dim=-1)
        u, v = q[..., 0], q[..., 2]
    else:
        y = torch.stack([q[..., 0], q[..., 2]], dim=-1)
        u, v = q[..., 1], q[..., 3]
    return y.reshape(lead + (height, width)), _plane(u), _plane(v)


def _v210_frame(buf, w, h):
    row_dwords = ((w + 47) // 48) * 32
    return v210_unpack_device(buf.reshape(buf.shape[:-1] + (h, row_dwords)),
                              w)


def _y210_frame(buf, w, h):
    return y210_unpack_device(buf.reshape(buf.shape[:-1] + (h, w * 2)), w)


_DEVICE_UNPACKERS = {
    "NV12": p01x_split_device,
    "P010": p01x_split_device,
    "P016": p01x_split_device,
    "P210": lambda b, w, h: p01x_split_device(b, w, h, 1),
    "P216": lambda b, w, h: p01x_split_device(b, w, h, 1),
    "YUY2": yuy2_unpack_device,
    "UYVY": lambda b, w, h: yuy2_unpack_device(b, w, h, "uyvy"),
    "Y210": _y210_frame,
    "Y216": _y210_frame,
    "v210": _v210_frame,
    "AYUV": ayuv_unpack_device,
    "Y410": y410_unpack_device,
    "Y416": y416_unpack_device,
    "RGB24": rgb24_unpack_device,
    "RGB32": bgra32_unpack_device,
    "ARGB32": bgra32_unpack_device,
    "RGB48": rgb48_unpack_device,
    "BGR48": lambda b, w, h: rgb48_unpack_device(b, w, h, "bgr"),
    "BGRA64": bgra64_unpack_device,
    "b64a": b64a_unpack_device,
    "r210": r210_unpack_device,
}

# numpy view dtype of the flat per-frame buffer each unpacker expects
DEVICE_BUFFER_DTYPE = {
    "NV12": np.uint8, "P010": np.uint16, "P016": np.uint16,
    "P210": np.uint16, "P216": np.uint16,
    "YUY2": np.uint8, "UYVY": np.uint8,
    "Y210": np.uint16, "Y216": np.uint16, "v210": np.uint32,
    "AYUV": np.uint8, "Y410": np.uint32, "Y416": np.uint16,
    "RGB24": np.uint8, "RGB32": np.uint8, "ARGB32": np.uint8,
    "RGB48": np.uint16, "BGR48": np.uint16, "BGRA64": np.uint16,
    "b64a": np.uint16, "r210": np.uint32,
}


def has_device_unpacker(fmt_name: str) -> bool:
    return fmt_name in _DEVICE_UNPACKERS


def unpack_frame_device(fmt_name: str, buf: torch.Tensor, width: int,
                        height: int):
    """Dispatch the device-side unpack by ColorFormat name over a flat
    (..., n_words) buffer on any device; raises KeyError for formats
    without a device unpacker (use the host path).  The Y210/P010-class
    10-bit formats come out MSB-aligned already (the container stores them
    so); Y410/v210/r210 shift in-op."""
    fn = _DEVICE_UNPACKERS.get(fmt_name)
    if fn is None:
        raise KeyError(f"no device unpacker for {fmt_name}")
    return fn(buf, width, height)
