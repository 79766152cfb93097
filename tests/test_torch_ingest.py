"""Ingest in videorenderer_tpu_torch against the JAX package, on the CPU:
the host half of ``formats`` (``unpack_frame`` of every ColorFormat, tight,
pitched and bottom-up, with and without the native library; ``repitch``,
the pitch helpers and the screenshot packers) ``np.array_equal`` to the JAX
package's; each of the 21 device unpackers of ``kernels/unpack_device``
equal to the JAX ``unpack_frame_device`` and to the host ``unpack_frame``
(dtype and values, words with the top bit set, a leading batch dim); and
``VideoProcessor.process_packed`` equal to ``process(unpack_frame(...))``,
bit for bit, on the device unpackers' formats and on one with none.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import videorenderer_tpu.formats as jfmt
from videorenderer_tpu.kernels import unpack_device as jud

import videorenderer_tpu_torch.formats as tfmt
from videorenderer_tpu_torch import (OutputDescriptor, Settings,
                                     SourceDescriptor, VideoProcessor)
from videorenderer_tpu_torch.csputils import CSP
from videorenderer_tpu_torch.kernels import unpack_device as tud

ALL = [f for f in tfmt.ColorFormat if f != tfmt.ColorFormat.NONE]
W, H = 48, 16


def _jf(f):
    return jfmt.ColorFormat(int(f))


def _tight(fmt, seed=0, w=W, h=H):
    info = tfmt.get_format_info(fmt)
    nbytes = sum(r * t for r, t, _ in tfmt.plane_segments(info, w, h))
    return np.random.default_rng(int(fmt) + seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def _pad(fmt, tight, pad, w=W, h=H):
    """tests/test_all_formats.py's padding: ``pad`` junk bytes a row per
    segment (chroma segments pad/div)."""
    info = tfmt.get_format_info(fmt)
    a = np.frombuffer(tight, np.uint8)
    rng = np.random.default_rng(99)
    parts, off = [], 0
    for rows, trow, div in tfmt.plane_segments(info, w, h):
        seg = rng.integers(0, 256, (rows, trow + pad // div), np.uint8)
        seg[:, :trow] = a[off:off + rows * trow].reshape(rows, trow)
        parts.append(seg.reshape(-1))
        off += rows * trow
    return (np.concatenate(parts).tobytes(),
            tfmt.plane_segments(info, w, h)[0][1] + pad)


def _equal_frames(got, want):
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fmt", ALL, ids=[f.name for f in ALL])
def test_unpack_frame_equal(fmt, native, monkeypatch):
    monkeypatch.setattr(tfmt, "USE_NATIVE", native)
    monkeypatch.setattr(jfmt, "USE_NATIVE", native)
    tight = _tight(fmt)
    _equal_frames(tfmt.unpack_frame(fmt, tight, W, H),
                  jfmt.unpack_frame(_jf(fmt), tight, W, H))
    padded, pitch = _pad(fmt, tight, 64)
    got = tfmt.unpack_frame(fmt, padded, W, H, pitch=pitch)
    _equal_frames(got, jfmt.unpack_frame(_jf(fmt), padded, W, H, pitch=pitch))
    _equal_frames(got, tfmt.unpack_frame(fmt, tight, W, H))
    np.testing.assert_array_equal(
        tfmt.repitch(fmt, padded, W, H, pitch),
        jfmt.repitch(_jf(fmt), padded, W, H, pitch))
    info, jinfo = tfmt.get_format_info(fmt), jfmt.get_format_info(_jf(fmt))
    assert tfmt.plane_segments(info, W, H) == jfmt.plane_segments(jinfo, W, H)
    assert tfmt.default_pitch(info, W) == jfmt.default_pitch(jinfo, W)
    assert (tfmt.pitched_buffer_size(fmt, W, H, pitch)
            == jfmt.pitched_buffer_size(_jf(fmt), W, H, pitch))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fmt", ["RGB24", "XRGB32", "ARGB32", "R210",
                                 "RGB48", "B64A", "YUY2"])
def test_unpack_bottom_up_equal(fmt, native, monkeypatch):
    monkeypatch.setattr(tfmt, "USE_NATIVE", native)
    monkeypatch.setattr(jfmt, "USE_NATIVE", native)
    f = tfmt.ColorFormat[fmt]
    tight = _tight(f, 5)
    row = tfmt.default_pitch(tfmt.get_format_info(f), W)
    for pitch in (-row, -(row + 32)):
        buf = (tight if pitch == -row
               else _pad(f, tight, 32)[0])
        got = tfmt.unpack_frame(f, buf, W, H, pitch=pitch)
        _equal_frames(got, jfmt.unpack_frame(_jf(f), buf, W, H, pitch=pitch))
        np.testing.assert_array_equal(
            tfmt.repitch(f, buf, W, H, pitch),
            jfmt.repitch(_jf(f), buf, W, H, pitch))


@pytest.mark.parametrize("args,match", [
    ((tfmt.ColorFormat.NV12, b"\0" * 100, 48, 16, 64), "too small"),
    ((tfmt.ColorFormat.NV12, b"\0" * 4608, 48, 16, 32), "pitch"),
    ((tfmt.ColorFormat.NV12, b"\0" * 4608, 48, 16, -48), "bottom-up"),
    ((tfmt.ColorFormat.RGB24, b"\0" * 4608, 48, 16, -100), "row size")])
def test_pitched_errors_equal(args, match):
    fmt, buf, w, h, pitch = args
    with pytest.raises(ValueError, match=match):
        tfmt.repitch(fmt, buf, w, h, pitch)
    with pytest.raises(ValueError, match=match):
        jfmt.repitch(_jf(fmt), buf, w, h, pitch)


def test_screenshot_packers_equal():
    rng = np.random.default_rng(2)
    rgb = rng.random((7, 9, 3), np.float32) * 1.2 - 0.1
    for name in ("pack_rgb8", "pack_rgb10", "pack_rgb16"):
        a, b = getattr(tfmt, name)(rgb), getattr(jfmt, name)(rgb)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    d = rng.integers(0, 2 ** 32, (7, 9), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tfmt.rgb10_dwords_to_bgr48(d),
                                  jfmt.rgb10_dwords_to_bgr48(d))
    np.testing.assert_array_equal(
        tfmt.rgb10_dwords_to_bgr48(tfmt.pack_rgb10(rgb)),
        jfmt.rgb10_dwords_to_bgr48(jfmt.pack_rgb10(rgb)))
    frame = tfmt.unpack_frame(tfmt.ColorFormat.NV12,
                              _tight(tfmt.ColorFormat.NV12), W, H)
    assert isinstance(frame, tfmt.PlanarFrame) and frame.width == W


DEVICE = sorted(tud._DEVICE_UNPACKERS)


def test_device_unpacker_registry_equal():
    assert DEVICE == sorted(jud._DEVICE_UNPACKERS)
    assert tud.DEVICE_BUFFER_DTYPE == jud.DEVICE_BUFFER_DTYPE
    assert all(tud.has_device_unpacker(n) for n in DEVICE)
    assert not tud.has_device_unpacker("YV12")
    with pytest.raises(KeyError):
        tud.unpack_frame_device("YV12", torch.zeros(8, dtype=torch.uint8),
                                4, 2)


@pytest.mark.parametrize("name", DEVICE)
def test_device_unpacker_equal(name):
    """Random bytes (every word's top bit occurs), one frame and a batch of
    2: the port's planes equal the JAX unpacker's and the host
    unpack_frame's, in dtype and values; the signed view of the buffer
    gives the same planes."""
    fmt = next(f for f in ALL if tfmt.get_format_info(f).name == name)
    dt = tud.DEVICE_BUFFER_DTYPE[name]
    frames = [_tight(fmt, s) for s in (0, 1)]
    host = [tfmt.unpack_frame(fmt, f, W, H).planes for f in frames]
    words = np.stack([np.frombuffer(f, dt) for f in frames])
    for buf, want in ((words[0], host[0]), (words, None)):
        got = tud.unpack_frame_device(name, torch.from_numpy(buf.copy()),
                                      W, H)
        jgot = jud.unpack_frame_device(name, jnp.asarray(buf), W, H)
        sdt = {np.uint16: np.int16, np.uint32: np.int32}.get(dt, dt)
        signed = tud.unpack_frame_device(
            name, torch.from_numpy(buf.view(sdt).copy()), W, H)
        assert len(got) == len(jgot) == 3
        for i, (g, j, s) in enumerate(zip(got, jgot, signed)):
            g, s = g.numpy(), s.numpy()
            j = np.asarray(j)
            ref = (np.stack([h[i] for h in host]) if want is None
                   else want[i])
            assert g.dtype == ref.dtype == j.dtype == s.dtype, name
            assert g.flags.c_contiguous
            np.testing.assert_array_equal(g, j, err_msg=name)
            np.testing.assert_array_equal(g, ref, err_msg=name)
            np.testing.assert_array_equal(s, ref, err_msg=name)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_nv12_split_device_equals_jax(dt):
    """nv12_split_device (the JAX package's name) on an NV12 or P010 buffer,
    one frame and a batch of 2: the JAX function's planes, value for
    value."""
    rng = np.random.default_rng(3)
    buf = rng.integers(0, np.iinfo(dt).max + 1, (2, W * H * 3 // 2),
                       dtype=np.uint32).astype(dt)
    for b in (buf[0], buf):
        got = tud.nv12_split_device(torch.from_numpy(b.copy()), W, H)
        jgot = jud.nv12_split_device(jnp.asarray(b), W, H)
        for g, j in zip(got, jgot):
            assert g.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_device_unpacker_top_bits():
    """r210 and b64a words with the top bit set, and v210/Y410 dwords with
    the padding bits set: the byte swaps and masks are those of numpy's
    unsigned words."""
    w, h = 48, 2
    for name, dt in (("r210", np.uint32), ("b64a", np.uint16),
                     ("Y410", np.uint32), ("v210", np.uint32)):
        fmt = next(f for f in ALL if tfmt.get_format_info(f).name == name)
        n = len(_tight(fmt, 0, w, h)) // np.dtype(dt).itemsize
        words = np.full(n, np.iinfo(dt).max, dt)
        words[1::3] = np.iinfo(dt).max >> 1
        words[2::3] = (np.iinfo(dt).max >> 1) + 1
        host = tfmt.unpack_frame(fmt, words.tobytes(), w, h).planes
        got = tud.unpack_frame_device(name, torch.from_numpy(words), w, h)
        for g, r in zip(got, host):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


PACKED = ["NV12", "P010", "YUY2", "UYVY", "Y210", "V210", "AYUV", "Y410",
          "RGB24", "RGB48", "B64A", "R210", "YV12"]


@pytest.mark.parametrize("fmt", PACKED)
def test_process_packed_equals_process(fmt):
    """process_packed (the bytes to the device, unpacked there; YV12 has
    no device unpacker and unpacks on the host) bit-equal to
    process(unpack_frame(...).planes), on bytes, a numpy array and a
    tensor."""
    f = tfmt.ColorFormat[fmt]
    src = SourceDescriptor(format=f, width=W, height=H, matrix=CSP.BT_709)
    vp = VideoProcessor(Settings(), src,
                        OutputDescriptor(width=64, height=24, bits=10),
                        device="cpu", pack_surface=True)
    raw = _tight(f, 3)
    want = vp.process(tfmt.unpack_frame(f, raw, W, H).planes)
    assert torch.equal(vp.process_packed(raw), want)
    name = tfmt.get_format_info(f).name
    if tud.has_device_unpacker(name):
        arr = np.frombuffer(raw, tud.DEVICE_BUFFER_DTYPE[name]).copy()
        assert torch.equal(vp.process_packed(arr), want)
        two = np.stack([arr, np.frombuffer(_tight(f, 4), arr.dtype)])
        got2 = vp.process_packed(torch.from_numpy(two))
        assert torch.equal(got2[0], want)
        assert torch.equal(got2[1], vp.process(tfmt.unpack_frame(
            f, _tight(f, 4), W, H).planes))
