"""Subtitle subsystem — a copy of ``videorenderer_tpu.subtitles`` with its
composition in torch.

Reference equivalents (Source/SubPic/, ~2.9 kLoC):
 * ``ISubPic`` (timed bitmap with dirty rect) -> :class:`SubPic`
 * ``ISubPicProvider``                        -> :class:`SubtitleProvider`
 * ``CSubPicQueue`` — background thread pre-rendering upcoming subpics into
   a bounded deque with condition variables and drop/blocking lookup
   (Source/SubPic/SubPicQueueImpl.h:128-173) -> :class:`SubPicQueue`
 * ``CSubPicQueueNoThread`` (render on demand,
   SubPicQueueImpl.h:175-195) -> :class:`SubPicQueueNoThread`
 * the XySubFilter push bridge (ISubRenderConsumer2,
   Source/SubPic/XySubPic*.cpp) -> :class:`PushSubtitleBridge`

The queues hold numpy bitmaps only: the worker thread of
:class:`SubPicQueue` rasterises host-side and never touches a device (the
reference does the same: CPU ``MemPic_t``, then a texture upload,
Source/SubPic/DX11SubPic.cpp).  The upload happens on the render thread, in
:func:`composite` or the renderer's overlay pass, onto the frame's device,
and the blend is :func:`videorenderer_tpu_torch.ops.overlay.blend_in_rect`.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Protocol

import numpy as np
import torch


@dataclass
class SubPic:
    """A rendered subtitle picture (ISubPic analogue): premultiplied-free
    RGBA bitmap + placement + validity window [start, stop) in seconds."""

    rgb: np.ndarray        # (3, h, w) float32 [0,1]
    alpha: np.ndarray      # (h, w) float32 [0,1]
    x: int
    y: int
    start: float
    stop: float

    def covers(self, t: float) -> bool:
        return self.start <= t < self.stop


class SubtitleProvider(Protocol):
    """ISubPicProvider analogue: render the subpic(s) for a time."""

    def render(self, t: float) -> list[SubPic]: ...
    def next_change(self, t: float) -> float | None: ...


@dataclass
class TextEvent:
    start: float
    stop: float
    text: str
    x: int = 0
    y: int = 0


class TextSubtitleProvider:
    """Simple provider over timed text events (SRT-like), rasterized with
    the OSD glyph atlas."""

    def __init__(self, events: Iterable[TextEvent], size: int = 24):
        self.events = sorted(events, key=lambda e: e.start)
        self._starts = [e.start for e in self.events]
        self.size = size

    def render(self, t: float) -> list[SubPic]:
        from .osd import render_text
        out = []
        for e in self.events:
            if e.start <= t < e.stop:
                alpha = render_text(e.text, self.size).astype(np.float32) / 255.0
                rgb = np.broadcast_to(alpha[None], (3,) + alpha.shape).copy()
                out.append(SubPic(rgb=rgb, alpha=alpha, x=e.x, y=e.y,
                                  start=e.start, stop=e.stop))
        return out

    def next_change(self, t: float) -> float | None:
        times = sorted({e.start for e in self.events} | {e.stop for e in self.events})
        i = bisect.bisect_right(times, t)
        return times[i] if i < len(times) else None


class SubPicQueueNoThread:
    """Render-on-demand queue (CSubPicQueueNoThread)."""

    def __init__(self, provider: SubtitleProvider):
        self.provider = provider
        self._cache: list[SubPic] = []
        self._valid: tuple[float, float] | None = None  # [t0, t1) render window

    def lookup(self, t: float) -> list[SubPic]:
        if self._valid and self._valid[0] <= t < self._valid[1]:
            return self._cache
        self._cache = self.provider.render(t)
        nxt = self.provider.next_change(t)
        self._valid = (t, nxt if nxt is not None else float("inf"))
        return self._cache

    def invalidate(self, t: float = 0.0) -> None:
        self._cache = []
        self._valid = None

    def stop(self) -> None:
        pass


class SubPicQueue:
    """Background pre-rendering queue (CSubPicQueue): a worker thread renders
    upcoming subpics ahead of playback into a bounded deque; lookup returns
    the newest subpics covering t, dropping expired entries."""

    def __init__(self, provider: SubtitleProvider, max_ahead: int = 8):
        self.provider = provider
        self.max_ahead = max_ahead
        self._queue: deque[tuple[float, list[SubPic]]] = deque()
        self._cv = threading.Condition()
        self._now = 0.0
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        t = 0.0
        while True:
            with self._cv:
                while not self._stop and len(self._queue) >= self.max_ahead:
                    self._cv.wait()
                if self._stop:
                    return
                t = max(t, self._now)
            pics = self.provider.render(t)
            nxt = self.provider.next_change(t)
            t1 = nxt if nxt is not None else float("inf")
            with self._cv:
                self._queue.append((t, t1, pics))
                self._cv.notify_all()
            if nxt is None:
                # nothing scheduled ahead: wait for playback to move
                with self._cv:
                    while not self._stop and self._now <= t:
                        self._cv.wait()
                    if self._stop:
                        return
                    t = self._now
            else:
                t = nxt

    def lookup(self, t: float) -> list[SubPic]:
        with self._cv:
            self._now = t
            # drop expired windows, find the one covering t
            while self._queue and self._queue[0][1] <= t:
                self._queue.popleft()
            # pure CV signaling (no polling waits in the worker): notify
            # AFTER the pops so a full-queue wait sees the freed slots, and
            # after _now moved so the idle wait sees playback progress.
            self._cv.notify_all()
            for t0, t1, pics in self._queue:
                if t0 <= t < t1:
                    return [p for p in pics if p.covers(t)]
        # miss: render synchronously (blocking lookup semantics,
        # CSubPicQueue fallback path)
        return [p for p in self.provider.render(t) if p.covers(t)]

    def invalidate(self, t: float = 0.0) -> None:
        with self._cv:
            self._queue.clear()
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=2.0)


class PushSubtitleBridge:
    """XySubFilter-style push model (ISubRenderConsumer2 bridge,
    Source/SubPic/XySubPicProvider.cpp): an external renderer delivers
    finished frames; we adapt them to the provider interface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._current: list[SubPic] = []

    def deliver(self, pics: list[SubPic]) -> None:
        with self._lock:
            self._current = pics

    def render(self, t: float) -> list[SubPic]:
        with self._lock:
            return [p for p in self._current if p.covers(t)]

    def next_change(self, t: float) -> float | None:
        return None


def composite(frame_chw: torch.Tensor, pics: list[SubPic]) -> torch.Tensor:
    """Blend subpics onto a (…,3,H,W) frame on the frame's device: each
    bitmap is uploaded there (on the calling thread) and blended into a new
    tensor; ``frame_chw`` itself is left as it was."""
    from .ops.overlay import blend_in_rect
    out = frame_chw
    for p in pics:
        out = blend_in_rect(
            out, torch.as_tensor(p.rgb, device=frame_chw.device),
            torch.as_tensor(p.alpha, device=frame_chw.device), x=p.x, y=p.y)
    return out
