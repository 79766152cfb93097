"""Display/output-target model — the DisplayConfig + HDR-toggle analogue;
a copy of ``videorenderer_tpu.display`` over the port's ``config.py``.

The reference queries per-display capabilities via QueryDisplayConfig
(resolution, refresh, bit depth, color encoding, HDR support/enabled/ACM —
Source/DisplayConfig.{h,cpp}) and can switch Windows' HDR mode per the
``iHdrToggleDisplay`` policy (HandleHDRToggle,
Source/DX11VideoProcessor.cpp:1588-1740), restoring the original state on
teardown.

A processing engine has no physical display; the equivalent is the *output
target* descriptor that the sink advertises (file/stream container
capabilities).  This module keeps the same state machine so players built
on the framework get identical semantics: policy evaluation, toggle
bookkeeping, and restore-on-close.
"""

from __future__ import annotations

from dataclasses import dataclass

from .config import HdrToggleDisplay


@dataclass
class DisplayConfig:
    """Per-target capability record (DisplayConfig_t analogue,
    Source/DisplayConfig.h:74-137)."""

    name: str = "sink0"
    width: int = 3840
    height: int = 2160
    refresh_num: int = 60000
    refresh_den: int = 1001
    bit_depth: int = 10
    hdr_supported: bool = True
    hdr_enabled: bool = False
    acm_enabled: bool = False   # Windows 11 Auto Color Management analogue

    @property
    def refresh_hz(self) -> float:
        return self.refresh_num / self.refresh_den

    def hdr_support(self) -> bool:
        return self.hdr_supported

    def hdr_on(self) -> bool:
        return self.hdr_enabled


class HdrToggleController:
    """HandleHDRToggle port: decides whether to switch the target's HDR mode
    for a given source, tracks which targets we changed, and restores the
    original state on close (the per-display saved-state maps,
    Source/DX11VideoProcessor.h:196-197)."""

    def __init__(self, display: DisplayConfig):
        self.display = display
        self._start_state = display.hdr_enabled
        self._we_toggled = False

    def evaluate(self, policy: HdrToggleDisplay, source_is_hdr: bool,
                 fullscreen: bool = True) -> bool:
        """Returns True if the display HDR mode changed."""
        want_on = source_is_hdr
        changed = False
        if policy == HdrToggleDisplay.DISABLED:
            return False
        allow_here = policy in (HdrToggleDisplay.ON, HdrToggleDisplay.ONOFF) \
            or fullscreen
        if not allow_here or not self.display.hdr_supported:
            return False
        allow_off = policy in (HdrToggleDisplay.ONOFF,
                               HdrToggleDisplay.ONOFF_FULLSCREEN)
        if want_on and not self.display.hdr_enabled:
            self.display.hdr_enabled = True
            self._we_toggled = True
            changed = True
        elif not want_on and self.display.hdr_enabled and allow_off \
                and self._we_toggled:
            self.display.hdr_enabled = False
            changed = True
        return changed

    def restore(self) -> None:
        """Restore the display's original HDR state (destructor behavior,
        Source/DX11VideoProcessor.cpp:453-463)."""
        if self._we_toggled:
            self.display.hdr_enabled = self._start_state
            self._we_toggled = False
