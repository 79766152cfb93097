"""Clip runner: batched, double-buffered frame streaming with temporal
state — the port of ``videorenderer_tpu.runner``.

The reference's streaming loop (Receive -> CopySample -> Render -> Present,
Source/DX11VideoProcessor.cpp:2143-2200) overlaps CPU upload with GPU work
through the swap-chain queue.  Here:

 * frames are processed in **batches** (clips) — throughput over latency;
 * :func:`run_clip` issues batch k+1's host->device transfer before batch
   k's compute is awaited: on a card through two pinned host staging
   buffers and a side copy stream (:class:`Stager`), so the copy overlaps
   the compute;
 * deinterlacing keeps a past/future frame window across batch boundaries
   (the reference's reference-frame ring, Source/D3D11VP.h:26-193) in
   :class:`DeinterlaceSession`, a host-side sliding window of torch tensors
   feeding the deinterlace functions of :mod:`.pipeline`;
 * A/V-sync accounting (drop-late-frame logic, renbase2.h:46-68 /
   SyncFrameToStreamTime, Source/VideoProcessor.cpp:258-271) is reproduced
   for real-time mode in :class:`PresentClock` (host code, a copy of the
   JAX package's).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .pipeline import (check_device, make_deint_fields_fn,
                       make_deint_frame_fn)
from .stats import Metrics, precise_tick


@dataclass
class ClipResult:
    outputs: list           # list of device tensors (one per batch)
    frames: int
    seconds: float

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0


class Stager:
    """Host->device transfer of plane batches for :func:`run_clip`.

    On a card each plane goes through one of two pinned host buffers (the
    slots alternate batch by batch) and is copied on a side stream; the
    compute stream waits for the copy's event before it reads the batch, and
    the batch's tensors are recorded on the compute stream for the caching
    allocator.  A slot is refilled only after its previous copy has
    finished.  (Without pinned memory a ``non_blocking`` copy from pageable
    numpy memory is synchronous and nothing overlaps.)  On the CPU a batch
    is ``torch.as_tensor``.  Tensors already on the device pass through."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(device)
            self._slots: list[dict] = [{}, {}]   # plane index -> pinned
            self._done: list = [None, None]       # each slot's copy event
            self._k = 0

    def put(self, batch) -> tuple:
        """Issue the transfer of one batch: (its device tensors, the copy's
        event or None)."""
        if not self._cuda:
            return tuple(torch.as_tensor(p, device=self.device)
                         for p in batch), None
        slot = self._k % 2
        self._k += 1
        if self._done[slot] is not None:
            self._done[slot].synchronize()    # the slot's last copy is over
        pinned = self._slots[slot]
        out = []
        with torch.cuda.stream(self._stream):
            for i, p in enumerate(batch):
                if isinstance(p, torch.Tensor) and p.device == self.device:
                    out.append(p)
                    continue
                a = np.ascontiguousarray(p)
                buf = pinned.get(i)
                if buf is None or buf.shape != a.shape \
                        or buf.numpy().dtype != a.dtype:
                    buf = pinned[i] = torch.from_numpy(a).pin_memory()
                else:
                    np.copyto(buf.numpy(), a)
                d = torch.empty(buf.shape, dtype=buf.dtype,
                                device=self.device)
                d.copy_(buf, non_blocking=True)
                out.append(d)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._done[slot] = ev
        return tuple(out), ev

    def ready(self, staged: tuple) -> tuple:
        """The tensors of :meth:`put`'s result, once the compute stream
        waits for their copy (and they are recorded on that stream)."""
        planes, ev = staged
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            for t in planes:
                t.record_stream(stream)
        return planes


def run_clip(frame_fn: Callable, batches: Iterable[tuple], *,
             device: torch.device | str = "cuda",
             metrics: Metrics | None = None) -> ClipResult:
    """Stream plane batches through a frame function with transfer/compute
    overlap: batch k+1's transfer is issued before batch k's compute is
    awaited (:class:`Stager`).  ``batches``: an iterable of plane tuples
    (numpy arrays, leading batch dim).  ``device``: the card unless the
    caller asks for the CPU; a CUDA device with no CUDA raises.  The time
    covers the last output's completion."""
    device = check_device(device)
    stager = Stager(device)
    outputs = []
    n_frames = 0
    it = iter(batches)

    t0 = precise_tick()
    first = next(it, None)
    if first is None:
        return ClipResult([], 0, 0.0)
    current = stager.put(first)
    while True:
        # issue the next transfer before waiting on compute
        nxt = next(it, None)
        pending = stager.put(nxt) if nxt is not None else None
        planes = stager.ready(current)
        outputs.append(frame_fn(planes))
        n_frames += planes[0].shape[0] if planes[0].ndim > 2 else 1
        if metrics is not None:
            metrics.draw_stats.frame_drawn()
        if pending is None:
            break
        current = pending
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return ClipResult(outputs, n_frames, precise_tick() - t0)


def windowed_batches(planes: tuple[np.ndarray, ...], batch: int,
                     halo: int = 0) -> Iterator[tuple]:
    """Split (N, ...) plane arrays into batches with ``halo`` overlap frames
    on each side (temporal window for motion-adaptive deinterlacing)."""
    n = planes[0].shape[0]
    for start in range(0, n, batch):
        lo = max(0, start - halo)
        hi = min(n, start + batch + halo)
        yield tuple(p[lo:hi] for p in planes)


class DeinterlaceSession:
    """Streaming motion-adaptive deinterlacing with one frame of lookahead.

    push() returns 0..2 outputs per input frame (2 with ``double_rate``:
    field 0, then field 1 rendered at +duration/2); flush() drains the last
    frame with a clamped window.  push_batch()/flush_batch() do the same on
    batches of frames: one step is one concatenation per plane of the last
    two frames and the new batch, and the (prev, cur, next) batches are
    leading-dim slices of it (no copies); with ``double_rate`` the step is
    K7 ×1 + K9 ×1 on a card.  Use one API or the other, not both.

    Every pushed plane (tensor or numpy array) is moved to ``device``, the
    card unless the caller asks for the CPU; a CUDA device with no CUDA
    raises, as :class:`~.pipeline.VideoProcessor` does.  ``post``: an
    optional per-output function (geometry, user shaders) applied to every
    output."""

    def __init__(self, plan, double_rate: bool = True,
                 top_field_first: bool = True, pack_surface: bool = False,
                 post: Callable | None = None, *,
                 device: torch.device | str = "cuda"):
        self.device = check_device(device)
        self.double_rate = double_rate
        if double_rate:
            inner = make_deint_fields_fn(plan, top_field_first=top_field_first,
                                         pack_surface=pack_surface)
        else:
            one = make_deint_frame_fn(plan, field=0,
                                      top_field_first=top_field_first,
                                      pack_surface=pack_surface)

            def inner(p, c, n):
                return (one(p, c, n),)
        self._inner = inner
        self._post = post
        self._window: list[tuple] = []   # [prev, cur, next]
        self._tail: tuple | None = None   # batched mode: last 2 stream frames

    def reset(self) -> None:
        """Drop the temporal window (a stream discontinuity or
        re-configuration — the reference resets its reference-frame ring)."""
        self._window = []
        self._tail = None

    def _put(self, planes) -> tuple:
        return tuple(torch.as_tensor(p, device=self.device) for p in planes)

    def _emit(self, prev, cur, nxt) -> list:
        outs = self._inner(prev, cur, nxt)
        return [self._post(o) if self._post is not None else o for o in outs]

    def push(self, planes) -> list:
        if self._tail is not None:
            raise RuntimeError("this session is in batched mode "
                               "(push_batch/flush_batch); do not mix APIs")
        self._window.append(self._put(planes))
        if len(self._window) == 1:
            return []
        if len(self._window) == 2:
            # first frame: prev clamps to itself
            a, b = self._window
            return self._emit(a, a, b)
        self._window = self._window[-3:]
        a, b, c = self._window
        return self._emit(a, b, c)

    def flush(self) -> list:
        if self._tail is not None:
            raise RuntimeError("this session is in batched mode; "
                               "use flush_batch()")
        if not self._window:
            return []
        if len(self._window) == 1:
            a = self._window[0]
            return self._emit(a, a, a)
        a, b = self._window[-2:]
        return self._emit(a, b, b)

    def push_batch(self, planes) -> list:
        """``planes``: plane tensors (or arrays) with a leading frame dim
        (B, ...).  Returns the output batches (field 0, then field 1 with
        ``double_rate``) of every input frame whose one-frame lookahead is
        available; the rest come with the next call or flush_batch().  The
        kept tail is a view of this step's window, which it keeps alive
        until the next step."""
        if self._window:
            raise RuntimeError("this session is in streaming mode "
                               "(push/flush); do not mix APIs")
        planes = self._put(planes)
        if self._tail is None:
            # stream start: the first frame's prev clamps to itself
            arr = tuple(torch.cat([p[:1], p]) for p in planes)
        else:
            arr = tuple(torch.cat([t, p]) for t, p in zip(self._tail, planes))
        m = arr[0].shape[0]
        outs = []
        if m >= 3:
            outs = self._emit(tuple(p[0:m - 2] for p in arr),
                              tuple(p[1:m - 1] for p in arr),
                              tuple(p[2:m] for p in arr))
        self._tail = tuple(p[-2:] for p in arr)
        return outs

    def flush_batch(self) -> list:
        """Drain the final frame (next clamps to the last frame)."""
        if self._window:
            raise RuntimeError("this session is in streaming mode; "
                               "use flush()")
        if self._tail is None:
            return []
        prev = tuple(p[0:1] for p in self._tail)
        cur = tuple(p[1:2] for p in self._tail)
        self._tail = None
        return self._emit(prev, cur, cur)


@dataclass
class QualityMessage:
    """Upstream quality notification (the IQualityControl ``Notify`` payload,
    Source/renbase2.cpp:363-476): advises the supplier/decoder to degrade or
    improve.  ``kind`` is "famine" (the time is going elsewhere — supplier
    should cheapen) or "flood" (rendering dominates — we degrade);
    ``proportion`` is the per-mille rate request clamped to [500, 2000]
    (1000 = keep rate, <1000 = slow down / drop quality, >1000 = speed up);
    ``late_s`` is the lateness estimate including half the average render
    time."""

    kind: str
    proportion: int
    late_s: float
    timestamp_s: float


class QualityManager:
    """The base renderer's full quality-management loop
    (CBaseVideoRenderer2::ShouldDrawSampleNow + SendQuality,
    Source/renbase2.cpp:363-753, renbase2.h:46-148), in float seconds.

    Per frame, :meth:`should_draw` decides **draw now / wait until due /
    drop**, maintaining the same state machine as the reference:

     * an ~8 ms monitor-latency bias on presentation times;
     * ``earliness``: after a drop the next frame plays early, then slides
       gracefully back to normal timing (-12 %/frame);
     * ``wait_avg`` / ``frame_avg`` / ``render_avg`` EWMAs (period 4, the
       DirectShow AVGPERIOD) deciding whether dropping would even help;
     * the supplier-feedback channel: a famine/flood :class:`QualityMessage`
       per frame via ``quality_sink`` — return True from the sink to signal
       "supplier is handling quality" (frames are then tolerated up to 4
       durations late before dropping, and play very early after the
       supplier drops one).

    Drops and lateness flow into an attached :class:`~videorenderer_tpu_torch.
    stats.Metrics` (drop counter + sync-offset accumulators -> stats OSD).
    """

    AVG_PERIOD = 4              # DirectShow AVGPERIOD
    MONITOR_BIAS_S = 0.008      # refresh-wait compensation (renbase2.cpp:500)

    def __init__(self, quality_sink: Callable | None = None,
                 metrics: "Metrics | None" = None):
        self.quality_sink = quality_sink
        self.metrics = metrics
        self.supplier_handling_quality = False
        self.last_quality: QualityMessage | None = None
        self.dropped = 0
        self.drawn = 0
        self.reset_streaming_times()

    def reset_streaming_times(self) -> None:
        """ResetStreamingTimes (Source/renbase2.cpp:61-86)."""
        self.last_draw = -1.001    # "ages ago": first frame always draws
        self.render_avg = 0.0
        self.render_last = 0.0
        self.frame_avg = -1.0      # <0 == unset
        self.duration = 0.0
        self.wait_avg = 0.0
        self.n_normal = 0          # -1 == just dropped a frame
        self.earliness = 0.0
        self._render_start = 0.0
        self._stamp_for_perf = 0.0

    # -- render-time measurement (OnRenderStart/End, renbase2.cpp:243-268) --

    def on_render_start(self, now: float | None = None) -> None:
        self._render_start = precise_tick() if now is None else now

    def on_render_end(self, now: float | None = None) -> None:
        """Fold the just-measured render time into ``render_avg`` unless it
        is a >32x spike (thread-interruption noise, renbase2.cpp:255-268)."""
        tr = (precise_tick() if now is None else now) - self._render_start
        p = self.AVG_PERIOD
        if tr < self.render_avg * 32 or tr < self.render_last * 32:
            self.render_avg = (tr + (p - 1) * self.render_avg) / p
        self.render_last = tr

    # -- supplier feedback (SendQuality, renbase2.cpp:363-476) ---------------

    def _send_quality(self, late: float, real_stream: float) -> bool:
        if self.frame_avg < 0 or self.frame_avg > 2 * self.render_avg:
            kind = "famine"       # time mostly spent outside rendering
        else:
            kind = "flood"        # rendering dominates
        proportion = 1000
        if self.frame_avg < 0:
            pass                  # not enough data — leave it alone
        elif late > 0:
            # catch up over the next second; don't go below half rate
            proportion = max(500, 1000 - int(late * 1000))
        elif self.wait_avg > 0.002 and late < -0.002:
            # consistently early: cautiously ask for more, aim at 2 ms wait
            if self.wait_avg >= self.frame_avg:
                proportion = 2000
            elif self.frame_avg + 0.002 > self.wait_avg:
                proportion = int(
                    1000 * (self.frame_avg
                            / (self.frame_avg + 0.002 - self.wait_avg)))
            else:
                proportion = 2000
            proportion = min(proportion, 2000)
        msg = QualityMessage(kind, proportion, late + self.render_avg / 2,
                             real_stream)
        self.last_quality = msg
        if self.quality_sink is not None:
            return bool(self.quality_sink(msg))
        return False

    def _record(self, accuracy: float, frame: float) -> None:
        """RecordFrameLateness analogue: feed the per-frame lateness into the
        sync-offset accumulators and graph (renbase2.cpp:185-202)."""
        self.drawn += 1
        if self.metrics is not None:
            self.metrics.render_stats.record_sync_offset(accuracy)
            self.metrics.sync_graph.add(accuracy)

    # -- the decision (ShouldDrawSampleNow, renbase2.cpp:489-753) ------------

    def should_draw(self, start: float, end: float, now: float,
                    discontinuity: bool = False) -> tuple[str, float]:
        """Decide the fate of a frame stamped [``start``, ``end``) with the
        stream clock at ``now`` (all seconds, any common epoch).  Returns
        ``(decision, adjusted_start)`` with decision one of ``"draw"``
        (render immediately), ``"wait"`` (render at ``adjusted_start`` —
        possibly pulled early by the earliness ramp), ``"drop"``.
        ``discontinuity``: the supplier flagged this sample as following a
        gap (it dropped one)."""
        p = self.AVG_PERIOD
        if start >= self.MONITOR_BIAS_S:
            start -= self.MONITOR_BIAS_S
            end -= self.MONITOR_BIAS_S
        self._stamp_for_perf = start
        true_late = now - start
        late = true_late
        self.supplier_handling_quality = self._send_quality(late, now)
        duration = end - start

        # major frame-rate change: reset the average to the new rate
        t = self.duration / 32
        if duration > self.duration + t or duration < self.duration - t:
            self.frame_avg = duration
            self.duration = duration

        just_dropped = ((self.supplier_handling_quality and discontinuity)
                        or self.n_normal == -1)

        # earliness slide (slow -> fast machine mode, renbase2.cpp:567-575)
        if late > 0:
            self.earliness = 0.0
        elif late >= self.earliness or just_dropped:
            self.earliness = late
        else:
            self.earliness -= self.earliness / 8

        # prospective wait average (never mix in a negative wait)
        wait_avg_new = (max(-late, 0.0) + self.wait_avg * (p - 1)) / p
        frame = min(now - self.last_draw, 1.0)

        draw = (
            # dropping won't help: render time is a small fraction of the
            # inter-frame time
            3 * self.render_avg <= self.frame_avg
            # or the frame is still timely enough (4 durations of grace when
            # the supplier handles quality)
            or (late <= duration * 4 if self.supplier_handling_quality
                else late * 2 < duration)
            # or we usually wait >8 ms — this lateness is just a glitch
            or self.wait_avg > 0.008
            # or nothing has been drawn for over a second (don't look hung)
            or (now - self.last_draw) > 1.0)
        if not draw:
            # drop it; draw the next one early
            self.wait_avg = wait_avg_new
            self.n_normal = -1
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.draw_stats.drops += 1
            return ("drop", start)

        # slow-machine mode: play it AT ONCE if we are playing catch-up or
        # running below the true frame rate (but never when grossly early)
        play_asap = just_dropped or (
            self.frame_avg > duration + duration / 16
            and late > -duration * 10)
        if late < -0.9:
            play_asap = False

        if play_asap:
            self.n_normal = 0
            # zero wait: don't let supplier-drop oscillation fake spare time
            self.wait_avg = self.wait_avg * (p - 1) / p
            self.frame_avg = (frame + self.frame_avg * (p - 1)) / p
            self._record(true_late, frame)
            self.last_draw = now
            if self.earliness > late:
                self.earliness = late
            return ("draw", start)

        self.n_normal += 1
        # exiting slow-machine mode leaves a long real gap; record the ideal
        # rate instead so we don't bounce straight back in
        self.frame_avg = duration
        # play it early by the (negative) earliness, at most one frame
        start += max(self.earliness, -self.frame_avg)
        delay = -true_late
        self.wait_avg = wait_avg_new
        if delay > 0:     # we are going to wait
            frame = start - self.last_draw
            self.last_draw = start
            self._record(start - self._stamp_for_perf, frame)
            return ("wait", start)
        self.last_draw = now
        self._record(true_late, frame)
        return ("draw", start)


class PresentClock:
    """Real-time presentation pacing: decides drop/render per frame like the
    base renderer's quality management (renbase2.h:46-148) and sleeps to the
    stream time (SyncFrameToStreamTime, Source/VideoProcessor.cpp:258-271).

    :meth:`schedule` is the full quality-managed path (earliness ramp,
    famine/flood supplier feedback via ``quality_sink``, drop accounting into
    ``metrics``); :meth:`should_drop` is the simple drop-if-late rule kept
    for callers that manage their own waiting."""

    def __init__(self, fps: float, adjust_present_time: bool = True,
                 quality_sink: Callable | None = None,
                 metrics: "Metrics | None" = None):
        self.frame_duration = 1.0 / fps
        self.adjust = adjust_present_time
        self.start: float | None = None
        self.dropped = 0
        self.rendered = 0
        self.quality = QualityManager(quality_sink=quality_sink,
                                      metrics=metrics)

    def schedule(self, frame_index: int, discontinuity: bool = False) -> bool:
        """Quality-managed scheduling of frame ``frame_index``: runs the
        renbase2 decision, sleeps when the verdict is "wait" (honoring the
        earliness pull-forward), and returns True when the frame should be
        rendered (False == dropped).  Call ``quality.on_render_start/end``
        around the actual render to feed the degrade decision."""
        if self.start is None:
            self.start = precise_tick()
        due = frame_index * self.frame_duration
        now = precise_tick() - self.start
        decision, adj_start = self.quality.should_draw(
            due, due + self.frame_duration, now, discontinuity)
        if decision == "drop":
            self.dropped += 1
            return False
        if decision == "wait" and self.adjust:
            delay = adj_start - (precise_tick() - self.start)
            if delay > 0:
                time.sleep(delay)
        self.rendered += 1
        return True

    def should_drop(self, frame_index: int) -> bool:
        """True if the frame's presentation time has already passed by more
        than one frame duration (drop-if-late,
        Source/DX11VideoProcessor.cpp:2176-2197)."""
        if self.start is None:
            self.start = precise_tick()
            return False
        due = self.start + frame_index * self.frame_duration
        late = precise_tick() - due
        if late > self.frame_duration:
            self.dropped += 1
            return True
        return False

    def wait_for(self, frame_index: int) -> float:
        """Sleep until the frame is due; returns the sync offset (s)."""
        if self.start is None:
            self.start = precise_tick()
        due = self.start + frame_index * self.frame_duration
        now = precise_tick()
        if self.adjust and due > now:
            time.sleep(due - now)
        self.rendered += 1
        return precise_tick() - due
