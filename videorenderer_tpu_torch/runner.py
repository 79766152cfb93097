"""Streaming deinterlacing with temporal state — the port of
``videorenderer_tpu.runner.DeinterlaceSession``.

The reference keeps a past/future reference-frame ring for its
fixed-function deinterlacer (Source/D3D11VP.h:26-193); here a host-side
sliding window of torch tensors feeds the deinterlace functions of
:mod:`.pipeline`.  ``run_clip``, ``QualityManager`` and ``PresentClock`` are
not ported yet (ROADMAP.md, modules to port, item 9).
"""

from __future__ import annotations

from typing import Callable

import torch

from .pipeline import (check_device, make_deint_fields_fn,
                       make_deint_frame_fn)


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
