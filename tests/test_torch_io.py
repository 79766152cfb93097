"""videorenderer_tpu_torch.io.{raw,y4m,image} against the JAX package's
io modules on the same files: the planes read are ``np.array_equal``, the
files written byte-equal (raw RGB8/RGB10/RGB16 sinks, their signal-info
sidecars, y4m, BMP), including padded and bottom-up pitch, y4m header
fields and frame-level parameters, and the sink taking tensors."""

import json

import numpy as np
import pytest
import torch

import videorenderer_tpu as J
import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu.io import image as jimage
from videorenderer_tpu.io import raw as jraw
from videorenderer_tpu.io import y4m as jy4m

import videorenderer_tpu_torch as T
from videorenderer_tpu_torch.io import image as timage
from videorenderer_tpu_torch.io import raw as traw
from videorenderer_tpu_torch.io import y4m as ty4m


def _clip(path, fmt, w, h, frames, seed, pitch=None):
    """A raw clip of random bytes in ``fmt``'s layout (``pitch``: the luma
    row stride, negative for bottom-up rows)."""
    info = T.get_format_info(getattr(T.ColorFormat, fmt))
    n = (T.formats.pitched_buffer_size(info.cformat, w, h, pitch)
         if pitch is not None else info.buffer_size(w, h))
    data = np.random.default_rng(seed).integers(0, 256, frames * n, np.uint8)
    path.write_bytes(data.tobytes())
    return str(path)


@pytest.mark.parametrize("fmt,w,h,pitch", [
    ("NV12", 32, 16, None), ("NV12", 32, 16, 48), ("P010", 16, 8, 64),
    ("YUY2", 16, 8, None), ("YUV420P8", 32, 16, None), ("Y8", 24, 8, 32),
    ("XRGB32", 8, 4, -48), ("RGB24", 8, 6, 28), ("V210", 48, 4, None)],
    ids=lambda v: str(v))
def test_raw_source(tmp_path, fmt, w, h, pitch):
    path = _clip(tmp_path / "c.raw", fmt, w, h, 3, seed=len(fmt) + w,
                 pitch=pitch)
    js = jraw.RawVideoSource(path, getattr(J.ColorFormat, fmt), w, h, pitch)
    ts = traw.RawVideoSource(path, getattr(T.ColorFormat, fmt), w, h, pitch)
    assert (len(ts), ts.frame_bytes) == (len(js), js.frame_bytes) \
        and len(ts) == 3
    for a, b in zip(js, ts):
        assert len(a.planes) == len(b.planes)
        for pa, pb in zip(a.planes, b.planes):
            assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
    for start, count in ((0, 3), (1, 5)):
        for pa, pb in zip(js.read_batch(start, count),
                          ts.read_batch(start, count)):
            assert np.array_equal(pa, pb)
    with pytest.raises(EOFError):
        ts.read_batch(3, 1)


def test_prefetching_source():
    src = traw.PrefetchingSource(lambda i: i * i, 5, depth=2)
    assert list(src) == [0, 1, 4, 9, 16]

    def fail(i):
        if i == 2:
            raise ValueError("bad batch")
        return i

    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for item in traw.PrefetchingSource(fail, 4):
            got.append(item)
    assert got == [0, 1]


@pytest.mark.parametrize("bits", [8, 10, 16])
def test_raw_sink_bytes_and_sidecar(tmp_path, bits):
    rng = np.random.default_rng(bits)
    frames = rng.uniform(-0.1, 1.1, (3, 3, 6, 10)).astype(np.float32)
    jinfo = jpipe.OutputSignalInfo(width=10, height=6, bits=bits,
                                   primaries="BT_2020", transfer="PQ",
                                   hdr10=jpipe.HDR10Metadata(max_cll=900.0))
    tinfo = T.OutputSignalInfo(width=10, height=6, bits=bits,
                               primaries="BT_2020", transfer="PQ",
                               hdr10=T.HDR10Metadata(max_cll=900.0))
    jp, tp = str(tmp_path / "j.rgb"), str(tmp_path / "t.rgb")
    with jraw.RawVideoSink(jp, bits=bits, signal_info=jinfo) as sink:
        sink.present(frames[0])
        sink.present(frames[1:])
    with traw.RawVideoSink(tp, bits=bits, signal_info=tinfo) as sink:
        sink.present(torch.from_numpy(frames[0]))    # a tensor
        sink.present(frames[1:])                     # a batch, numpy
    assert sink.frames == 3
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    with open(jp + ".json") as a, open(tp + ".json") as b:
        assert json.load(a) == json.load(b)
    back = traw.read_sink_signal_info(tp)
    assert back == tinfo
    assert jraw.read_sink_signal_info(tp).to_dict() == back.to_dict()


def test_raw_sink_dict_info_and_no_sidecar(tmp_path):
    p = str(tmp_path / "o.rgb")
    with traw.RawVideoSink(p, bits=8) as sink:
        sink.present(np.zeros((3, 2, 2), np.float32))
    assert not (tmp_path / "o.rgb.json").exists()
    d = {"width": 2, "height": 2, "bits": 8, "primaries": "BT_709",
         "transfer": "SRGB"}
    with traw.RawVideoSink(p, bits=8, signal_info=d) as sink:
        sink.present(np.zeros((3, 2, 2), np.float32))
    assert json.loads((tmp_path / "o.rgb.json").read_text()) == dict(
        d, frames=1)


def _y4m_frames(cspace, w, h, n, seed):
    rng = np.random.default_rng(seed)
    cw, ch = {"444": (w, h), "422": (w // 2, h), "mono": (0, 0)}.get(
        cspace.replace("p10", ""), (w // 2, h // 2))
    dt, hi = (np.uint16, 1024) if "p10" in cspace else (np.uint8, 256)
    return [tuple(rng.integers(0, hi, s, dt) for s in
                  ([(h, w)] + ([(ch, cw)] * 2 if cw else [])))
            for _ in range(n)]


@pytest.mark.parametrize("cspace", ["420mpeg2", "420jpeg", "420paldv", "422",
                                    "444", "420p10", "mono"])
def test_y4m_roundtrip(tmp_path, cspace):
    w, h = 16, 8
    frames = _y4m_frames(cspace, w, h, 3, seed=len(cspace))
    jp, tp = str(tmp_path / "j.y4m"), str(tmp_path / "t.y4m")
    jy4m.write_y4m(jp, frames, w, h, fps=(30000, 1001), cspace=cspace)
    ty4m.write_y4m(tp, frames, w, h, fps=(30000, 1001), cspace=cspace)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    js, ts = jy4m.Y4MSource(tp), ty4m.Y4MSource(tp)
    for f in ("width", "height", "fps_num", "fps_den", "interlaced",
              "frame_bytes", "num_frames", "fps"):
        assert getattr(ts, f) == getattr(js, f), f
    assert (ts.format.name, ts.chroma_location.name) == (
        js.format.name, js.chroma_location.name)
    for a, b in zip(js, ts):
        assert all(np.array_equal(x, y) for x, y in zip(a.planes, b.planes))
    for x, y in zip(js.read_batch(1, 2), ts.read_batch(1, 2)):
        assert np.array_equal(x, y)


def test_y4m_frame_params_and_errors(tmp_path):
    w, h = 16, 8
    frames = _y4m_frames("420mpeg2", w, h, 3, seed=1)
    path = tmp_path / "p.y4m"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 It A1:1\n".encode())
        for planes in frames:
            f.write(b"FRAME Ip\n")              # a frame-level parameter
            for p in planes:
                f.write(p.tobytes())
    src = ty4m.Y4MSource(str(path))
    assert len(src) == 3 and src.interlaced and src.fps == 25.0
    assert src.format == T.ColorFormat.YUV420P8    # C absent: 420
    batch = src.read_batch(1, 2)
    assert np.array_equal(batch[2][1], frames[2][2])
    assert np.array_equal(batch[0][0],
                          jy4m.Y4MSource(str(path)).read_batch(1, 2)[0][0])
    with pytest.raises(EOFError):
        src.read_batch(3, 1)
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"RIFF....")
    with pytest.raises(ValueError, match="YUV4MPEG2"):
        ty4m.Y4MSource(str(bad))
    bad.write_bytes(b"YUV4MPEG2 W4 H4 C411\n")
    with pytest.raises(ValueError, match="C411"):
        ty4m.Y4MSource(str(bad))
    bad.write_bytes(b"YUV4MPEG2 W4 H2 C444\nFRAME\n" + bytes(24)
                    + b"JUNK\n" + bytes(24))
    with pytest.raises(ValueError, match="FRAME"):
        list(ty4m.Y4MSource(str(bad)))


@pytest.mark.parametrize("w", [5, 8])          # padded rows, then none
def test_bmp_bytes(tmp_path, w):
    rgb = np.random.default_rng(w).integers(0, 256, (7, w, 3), np.uint8)
    jp, tp = str(tmp_path / "j.bmp"), str(tmp_path / "t.bmp")
    jimage.save_bmp(jp, rgb)
    timage.save_bmp(tp, rgb)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(tp).convert("RGB")), rgb)


def test_save_image_float_and_png(tmp_path):
    f = np.random.default_rng(3).uniform(-0.2, 1.2, (4, 6, 3)) \
        .astype(np.float32)
    for ext in ("bmp", "png"):
        jp, tp = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
        jimage.save_image(jp, f)
        timage.save_image(tp, f)
        from PIL import Image
        assert np.array_equal(np.asarray(Image.open(jp).convert("RGB")),
                              np.asarray(Image.open(tp).convert("RGB")))
    with open(tmp_path / "j.bmp", "rb") as a, \
            open(tmp_path / "t.bmp", "rb") as b:
        assert a.read() == b.read()
