"""Frame statistics & timing — a numpy/stdlib copy of
``videorenderer_tpu.stats``, the port of the reference's metrics layer.

Reference equivalents:
 * ``CFrameStats`` — 301-sample timestamp ring with robust average frame
   duration and a 10-frame fast-change detector (Source/FrameStats.h:79-128)
 * ``CDrawStats``  — drawn-fps + drop counters (Source/FrameStats.h:130-143)
 * ``CRenderStats`` — per-stage tick counters copy/paint/present, sync
   offset (Source/FrameStats.h:145-173)
 * ``CMovingAverage`` — sync-offset graph window (Source/FrameStats.h:175-223)
 * ``GetPreciseTick``/QPC (Source/Times.h:23-26)

These are host-side (QPC-style instrumentation around the device calls);
the stats OSD rendering lives in :mod:`videorenderer_tpu_torch.osd`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def precise_tick() -> float:
    """Monotonic seconds (GetPreciseTick analogue)."""
    return time.perf_counter()


class FrameTimestamps:
    """Timestamp ring (CFrameTimestamps, Source/FrameStats.h:28-77)."""

    INTERVAL = 1_000_000_0  # unused placeholder to mirror 1s in 100ns units

    def __init__(self, size: int = 301):
        self._size = size
        self._ts: list[float] = []
        self._frames = 0

    def add(self, ts: float) -> None:
        self._frames += 1
        self._ts.append(ts)
        if len(self._ts) > self._size:
            self._ts.pop(0)

    @property
    def frames(self) -> int:
        return self._frames

    def average_duration(self) -> float:
        """Average over the ring (robust: uses the whole window)."""
        if len(self._ts) < 2:
            return 0.0
        return (self._ts[-1] - self._ts[0]) / (len(self._ts) - 1)

    def fps(self) -> float:
        d = self.average_duration()
        return 1.0 / d if d > 0 else 0.0


class FrameStats(FrameTimestamps):
    """Input-frame statistics with the fast-change detector: if the last 10
    intervals disagree with the long average by >1%, restart the window
    (CFrameStats logic, Source/FrameStats.h:79-128)."""

    CHANGE_FRAMES = 10

    def add(self, ts: float) -> None:
        if len(self._ts) > self.CHANGE_FRAMES:
            recent = self._ts[-self.CHANGE_FRAMES:]
            recent_avg = (recent[-1] - recent[0]) / (len(recent) - 1)
            long_avg = self.average_duration()
            if long_avg > 0 and abs(recent_avg - long_avg) > 0.01 * long_avg:
                self._ts = self._ts[-self.CHANGE_FRAMES:]
        super().add(ts)


def _std_dev(n: int, sum_sq: float, total: float) -> float:
    """Per-frame standard-deviation estimate, the CBaseVideoRenderer2
    GetStdDev formula (Source/renbase2.h:190-201):
    sqrt((sum_sq - total^2/(n-1)) / (n-2)), 0 while n <= 3."""
    if n <= 3:
        return 0.0
    var = (sum_sq - total * total / (n - 1)) / (n - 2)
    return var ** 0.5 if var > 0 else 0.0


@dataclass
class DrawStats:
    """Drawn-frame accounting (CDrawStats, Source/FrameStats.h:130-143)
    plus the inter-frame time accumulators behind IQualProp's get_Jitter
    (m_iSumFrameTime/m_iSumSqFrameTime, Source/renbase2.cpp:196-202)."""

    frames: int = 0
    drops: int = 0
    fails: int = 0
    _ring: FrameTimestamps = field(default_factory=FrameTimestamps)
    _last_ts: float | None = None
    _sum_frame_s: float = 0.0
    _sum_sq_frame_s: float = 0.0

    def frame_drawn(self, ts: float | None = None) -> None:
        self.frames += 1
        ts = ts if ts is not None else precise_tick()
        if self._last_ts is not None:
            dt = ts - self._last_ts
            self._sum_frame_s += dt
            self._sum_sq_frame_s += dt * dt
        self._last_ts = ts
        self._ring.add(ts)

    def fps(self) -> float:
        return self._ring.fps()

    def jitter(self) -> float:
        """Standard deviation of the inter-frame draw time, seconds
        (IQualProp get_Jitter, Source/renbase2.cpp:962-974)."""
        return _std_dev(self.frames, self._sum_sq_frame_s, self._sum_frame_s)


@dataclass
class RenderStats:
    """Per-stage timing accumulators (CRenderStats,
    Source/FrameStats.h:145-173): seconds spent in host->device copy,
    compute ('paint'), and readback/present, plus failure/skip counters and
    the latest A/V sync offset."""

    copy_s: float = 0.0
    paint_s: float = 0.0
    present_s: float = 0.0
    failed: int = 0
    dropped2: int = 0
    skipped_interval: int = 0
    sync_offset_s: float = 0.0
    # lateness accumulators for IQualProp get_AvgSyncOffset /
    # get_DevSyncOffset (m_iTotAcc/m_iSumSqAcc, Source/renbase2.cpp:185-188)
    sync_count: int = 0
    _sum_sync_s: float = 0.0
    _sum_sq_sync_s: float = 0.0

    def record_sync_offset(self, offset_s: float) -> None:
        self.sync_offset_s = offset_s
        self.sync_count += 1
        self._sum_sync_s += offset_s
        self._sum_sq_sync_s += offset_s * offset_s

    def avg_sync_offset(self) -> float:
        if self.sync_count < 2:
            return 0.0
        # the reference averages over (frames drawn - 1), renbase2.cpp:861
        return self._sum_sync_s / (self.sync_count - 1)

    def dev_sync_offset(self) -> float:
        """Std dev of the sync offset, seconds (IQualProp
        get_DevSyncOffset, Source/renbase2.cpp:951-959)."""
        return _std_dev(self.sync_count, self._sum_sq_sync_s,
                        self._sum_sync_s)

    def reset(self) -> None:
        self.copy_s = self.paint_s = self.present_s = 0.0
        self.failed = self.dropped2 = self.skipped_interval = 0
        self.sync_offset_s = 0.0
        self.sync_count = 0
        self._sum_sync_s = self._sum_sq_sync_s = 0.0


class MovingAverage:
    """Fixed-window moving average for the sync-offset graph
    (CMovingAverage, Source/FrameStats.h:175-223)."""

    def __init__(self, size: int):
        self._vals = [0.0] * size
        self._i = 0
        self._sum = 0.0
        self._filled = 0

    def add(self, v: float) -> None:
        self._sum += v - self._vals[self._i]
        self._vals[self._i] = v
        self._i = (self._i + 1) % len(self._vals)
        self._filled = min(self._filled + 1, len(self._vals))

    def average(self) -> float:
        return self._sum / max(1, self._filled)

    def values(self) -> list[float]:
        """Window contents in chronological order (for the graph polyline)."""
        return self._vals[self._i:] + self._vals[:self._i]


@dataclass
class Metrics:
    """The bundle a processor/session exposes (IQualProp analogue,
    renbase2.h:206-211 — drawn frames, avg frame rate, jitter, sync
    offsets — plus the stats-OSD fields)."""

    input_stats: FrameStats = field(default_factory=FrameStats)
    draw_stats: DrawStats = field(default_factory=DrawStats)
    render_stats: RenderStats = field(default_factory=RenderStats)
    sync_graph: MovingAverage = field(default_factory=lambda: MovingAverage(120))

    def snapshot(self) -> dict:
        return {
            "input_fps": self.input_stats.fps(),
            "draw_fps": self.draw_stats.fps(),
            "frames_drawn": self.draw_stats.frames,
            "frames_dropped": self.draw_stats.drops,
            "frames_failed": self.render_stats.failed,
            "copy_ms": self.render_stats.copy_s * 1e3,
            "paint_ms": self.render_stats.paint_s * 1e3,
            "present_ms": self.render_stats.present_s * 1e3,
            "sync_offset_ms": self.render_stats.sync_offset_s * 1e3,
            "avg_sync_offset_ms": self.sync_graph.average() * 1e3,
            # IQualProp parity (Source/renbase2.h:206-211): std dev of the
            # inter-frame draw time / of the recorded sync offsets
            "jitter_ms": self.draw_stats.jitter() * 1e3,
            "dev_sync_offset_ms": self.render_stats.dev_sync_offset() * 1e3,
        }
