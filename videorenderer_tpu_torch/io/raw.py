"""Raw frame IO: file sources and sinks — a copy of
``videorenderer_tpu.io.raw`` over the port's :mod:`..formats`.

The reference receives decoded frames from a DirectShow graph and presents
to a swap chain; the standalone equivalents are raw-file sources (any of
the 38 registry formats, fixed frame size) and file sinks with the same
buffering semantics as the swap-chain modes (SWAPEFFECT_Discard = depth 1,
Flip = queued).  Sources yield numpy planes; the sink takes numpy arrays or
tensors on any device (a CUDA tensor is copied to the host explicitly).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..formats import (ColorFormat, PlanarFrame, get_format_info, pack_rgb8,
                       pack_rgb10, pack_rgb16, pitched_buffer_size,
                       unpack_frame)


@dataclass
class RawVideoSource:
    """Iterate PlanarFrames from a raw (headerless) video file —
    the analogue of the upstream decoder connection.

    ``pitch``: bytes per luma/packed row for padded-stride files (decoder
    dumps; negative = bottom-up rows); None = tightly packed."""

    path: str
    format: ColorFormat
    width: int
    height: int
    pitch: int | None = None

    def __post_init__(self):
        self.info = get_format_info(self.format)
        if self.pitch is not None:
            self.frame_bytes = pitched_buffer_size(
                self.format, self.width, self.height, self.pitch)
        else:
            self.frame_bytes = self.info.buffer_size(self.width, self.height)
        self.num_frames = os.path.getsize(self.path) // self.frame_bytes

    def __len__(self) -> int:
        return self.num_frames

    def _unpack(self, buf: bytes) -> PlanarFrame:
        return unpack_frame(self.format, buf, self.width, self.height,
                            pitch=self.pitch)

    def __iter__(self) -> Iterator[PlanarFrame]:
        with open(self.path, "rb") as f:
            while True:
                buf = f.read(self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    return
                yield self._unpack(buf)

    def read_batch(self, start: int, count: int) -> tuple[np.ndarray, ...]:
        """Stacked plane arrays (count, ...) for batched processing."""
        frames = []
        with open(self.path, "rb") as f:
            f.seek(start * self.frame_bytes)
            for _ in range(count):
                buf = f.read(self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    break
                frames.append(self._unpack(buf))
        if not frames:
            raise EOFError("no frames")
        return tuple(np.stack([fr.planes[i] for fr in frames])
                     for i in range(len(frames[0].planes)))


class PrefetchingSource:
    """Background-thread batch prefetcher over any batch-producing callable —
    the host-feed analogue of the decoder thread delivering into Receive():
    unpacking/disk IO for batch k+1 overlaps device compute on batch k.
    ``produce`` must not touch the device: the thread only reads and
    unpacks on the host."""

    def __init__(self, produce, num_batches: int, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc = None

        def worker():
            try:
                for i in range(num_batches):
                    self._q.put(produce(i))
            except Exception as e:  # surfaced on the next __next__
                self._exc = e
            self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._exc is not None:
                    raise self._exc
                return
            yield item


class RawVideoSink:
    """Write processed (…,3,H,W) float frames to a raw file in RGB8 /
    RGB10 (A2R10G10B10 dwords) / RGB16 — the Present analogue.

    ``signal_info`` (pipeline.OutputSignalInfo or its dict) is persisted as
    a ``<path>.json`` sidecar on close — the SetColorSpace1/SetHDRMetaData
    analogue (Source/DX11VideoProcessor.cpp:2629-2739): raw RGB files carry
    no header, so the colorspace/transfer + HDR10 mastering/CLL tags ride
    alongside for the downstream consumer."""

    def __init__(self, path: str, bits: int = 8, signal_info=None):
        self.path = path
        self.bits = bits
        self.signal_info = signal_info
        self._f = open(path, "wb")
        self.frames = 0

    def present(self, rgb_chw) -> None:
        """``rgb_chw``: a numpy array or a tensor on any device (moved to
        the host here, once per call)."""
        if isinstance(rgb_chw, torch.Tensor):
            rgb_chw = rgb_chw.detach().cpu().numpy()
        img = np.moveaxis(np.asarray(rgb_chw), -3, -1)
        if img.ndim == 3:
            img = img[None]
        for fr in img:
            if self.bits == 8:
                self._f.write(pack_rgb8(fr).tobytes())
            elif self.bits == 10:
                self._f.write(pack_rgb10(fr).tobytes())
            else:
                self._f.write(pack_rgb16(fr).tobytes())
            self.frames += 1

    def close(self) -> None:
        self._f.close()
        if self.signal_info is not None:
            info = self.signal_info
            d = info if isinstance(info, dict) else info.to_dict()
            d = dict(d, frames=self.frames)
            with open(self.path + ".json", "w") as f:
                json.dump(d, f, indent=1)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_sink_signal_info(path: str):
    """Load the OutputSignalInfo sidecar written by RawVideoSink."""
    from ..pipeline import OutputSignalInfo
    with open(path + ".json") as f:
        return OutputSignalInfo.from_dict(json.load(f))
