"""YUV4MPEG2 (.y4m) reader and writer — a copy of
``videorenderer_tpu.io.y4m`` over the port's :mod:`..formats`: clips
produced by ffmpeg (``-f yuv4mpegpipe``) feed the pipeline directly.  The
reference receives decoded frames from the DirectShow graph; standalone,
y4m is the lingua franca for raw video exchange.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..csputils import ChromaLocation
from ..formats import ColorFormat, get_format_info, unpack_frame

# y4m colourspace tag -> (ColorFormat, chroma location)
_CSPACE = {
    "420": (ColorFormat.YUV420P8, ChromaLocation.MPEG2),       # = 420jpeg hist.
    "420jpeg": (ColorFormat.YUV420P8, ChromaLocation.MPEG1),   # center siting
    "420mpeg2": (ColorFormat.YUV420P8, ChromaLocation.MPEG2),  # left siting
    "420paldv": (ColorFormat.YUV420P8, ChromaLocation.COSITED),
    "422": (ColorFormat.YUV422P8, ChromaLocation.UNKNOWN),
    "444": (ColorFormat.YUV444P8, ChromaLocation.UNKNOWN),
    "420p10": (ColorFormat.YUV420P10, ChromaLocation.MPEG2),
    "422p10": (ColorFormat.YUV422P10, ChromaLocation.UNKNOWN),
    "444p10": (ColorFormat.YUV444P10, ChromaLocation.UNKNOWN),
    "mono": (ColorFormat.Y8, ChromaLocation.UNKNOWN),
}


@dataclass
class Y4MSource:
    """Header-parsed y4m file; iterate PlanarFrames or read stacked batches."""

    path: str

    def __post_init__(self):
        with open(self.path, "rb") as f:
            header = f.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 file")
        self._data_start = len(header)
        self.width = self.height = 0
        self.fps_num, self.fps_den = 25, 1
        self.interlaced = False
        cspace = "420"
        for tok in header.decode("ascii", "replace").split()[1:]:
            key, val = tok[0], tok[1:]
            if key == "W":
                self.width = int(val)
            elif key == "H":
                self.height = int(val)
            elif key == "F":
                num, den = val.split(":")
                self.fps_num, self.fps_den = int(num), int(den)
            elif key == "I":
                self.interlaced = val in ("t", "b")
            elif key == "C":
                cspace = val
        if cspace not in _CSPACE:
            raise ValueError(f"unsupported y4m colourspace C{cspace}")
        self.format, self.chroma_location = _CSPACE[cspace]
        info = get_format_info(self.format)
        self.frame_bytes = info.buffer_size(self.width, self.height)
        # the spec allows frame-level parameters ("FRAME Ixxx\n"); measure
        # the first marker's actual length instead of assuming b"FRAME\n"
        # (writers keep it constant per stream, which the seek math needs)
        with open(self.path, "rb") as f:
            f.seek(self._data_start)
            first = f.readline()
        self._marker_len = len(first) if first.startswith(b"FRAME") else 6
        payload = os.path.getsize(self.path) - self._data_start
        self.num_frames = payload // (self.frame_bytes + self._marker_len)

    @property
    def fps(self) -> float:
        return self.fps_num / self.fps_den

    def _read_frame(self, f):
        line = f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("corrupt y4m: missing FRAME marker")
        buf = f.read(self.frame_bytes)
        if len(buf) < self.frame_bytes:
            return None
        return unpack_frame(self.format, buf, self.width, self.height)

    def __iter__(self) -> Iterator:
        with open(self.path, "rb") as f:
            f.seek(self._data_start)
            while True:
                fr = self._read_frame(f)
                if fr is None:
                    return
                yield fr

    def __len__(self) -> int:
        return self.num_frames

    def read_batch(self, start: int, count: int):
        frames = []
        with open(self.path, "rb") as f:
            f.seek(self._data_start
                   + start * (self.frame_bytes + self._marker_len))
            for _ in range(count):
                fr = self._read_frame(f)
                if fr is None:
                    break
                frames.append(fr)
        if not frames:
            raise EOFError("no frames")
        return tuple(np.stack([fr.planes[i] for fr in frames])
                     for i in range(len(frames[0].planes)))


def write_y4m(path: str, planes_seq, width: int, height: int,
              fps=(25, 1), cspace: str = "420mpeg2") -> None:
    """Minimal writer (for tests / round-tripping): each item of
    ``planes_seq`` is one frame's planes (numpy arrays) in file order."""
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{width} H{height} "
                f"F{fps[0]}:{fps[1]} Ip A1:1 C{cspace}\n".encode())
        for planes in planes_seq:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(np.ascontiguousarray(p).tobytes())
