"""Interactive settings property page — the Main PropPage analogue; a
copy of ``videorenderer_tpu.proppage`` over the port's ``config.py``.

The reference's main property page (Source/PropPage.cpp:60-470) presents
every ``Settings_t`` field grouped by subsystem, with enable/disable
dependencies (e.g. the VP-format checkboxes grey out when the D3D11 backend
is off), steppered sliders (SDR display nits in steps of 5), hint text, and
Default/Apply actions that push the new settings into the running filter
(``pFilter->SetSettings``).

Here the same surface is a terminal UI (curses) over a *testable* model:
:class:`PropertyPageModel` holds the field table, the dependency rules and
the edit operations; :func:`run_tui` is a thin interactive shell on top.
The CLI exposes it as ``vrt-torch settings --edit``.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Callable

from .config import (ChromaScaling, Deinterlacing, Downscaling,
                     HDR_NITS_MAX, HDR_NITS_MIN, HdrToggleDisplay,
                     SDR_NITS_MAX, SDR_NITS_MIN, SDR_NITS_STEP, Settings,
                     SuperResolution, SwapEffect, TexFormat, ToneMapType,
                     Upscaling, VPEnableFormats)


@dataclass(frozen=True)
class FieldSpec:
    """One row of the page: a settings field (or VPEnableFormats subfield,
    spelled ``vp_formats.nv12``) plus its presentation."""

    name: str
    label: str
    group: str
    hint: str
    kind: str                  # "bool" | "enum" | "int"
    enum_type: type | None = None
    int_range: tuple[int, int, int] | None = None   # (lo, hi, step)


# Groups and rows mirror the reference page layout (PropPage.cpp:86-140);
# hint text is ours.
FIELDS: tuple[FieldSpec, ...] = (
    FieldSpec("use_accel_backend", "Use accelerated backend", "Renderer",
              "Hand-written CUDA kernels; off = their plain PyTorch "
              "versions (same math).", "bool"),
    FieldSpec("show_stats", "Show statistics", "Renderer",
              "Overlay the frame/render statistics panel.", "bool"),
    FieldSpec("resize_stats", "Resize statistics", "Renderer",
              "0 = fixed-size stats font, 1 = scale with the window.",
              "int", int_range=(0, 1, 1)),
    FieldSpec("tex_format", "Texture format", "Renderer",
              "Internal working precision; AUTOINT picks per source depth.",
              "enum", enum_type=TexFormat),
    FieldSpec("swap_effect", "Present mode", "Renderer",
              "Output sink buffering depth (flip = double-buffered).",
              "enum", enum_type=SwapEffect),
    FieldSpec("adjust_present_time", "Adjust present time", "Renderer",
              "Schedule presents against the frame clock.", "bool"),
    FieldSpec("exclusive_fullscreen", "Exclusive fullscreen", "Renderer",
              "Advisory on this backend (no display attached).", "bool"),
    FieldSpec("vblank_before_present", "Wait for VBlank", "Renderer",
              "Advisory on this backend (no display attached).", "bool"),
    FieldSpec("reinit_by_display", "Reinit on display change", "Renderer",
              "Advisory on this backend (no display attached).", "bool"),

    FieldSpec("vp_formats.nv12", "VP: NV12", "Video processor",
              "Allow the accelerated path for NV12 sources.", "bool"),
    FieldSpec("vp_formats.p01x", "VP: P010/P016", "Video processor",
              "Allow the accelerated path for P010/P016 sources.", "bool"),
    FieldSpec("vp_formats.yuy2", "VP: YUY2", "Video processor",
              "Allow the accelerated path for YUY2 sources.", "bool"),
    FieldSpec("vp_formats.other", "VP: other formats", "Video processor",
              "Allow the accelerated path for all other formats.", "bool"),
    FieldSpec("vp_deinterlacing", "Deinterlacing", "Video processor",
              "Motion-adaptive deinterlacing of interlaced sources.",
              "enum", enum_type=Deinterlacing),
    FieldSpec("deint_double", "Double frame rate", "Video processor",
              "Emit both fields (50/60p out from 25/30i).", "bool"),
    FieldSpec("vp_scaling", "VP scaling order", "Video processor",
              "Resize before corrections (fixed-function order); off = "
              "shader order (corrections at source resolution).", "bool"),
    FieldSpec("vp_superres", "Super resolution", "Video processor",
              "Learned upscaler, gated by source size class.",
              "enum", enum_type=SuperResolution),
    FieldSpec("vp_rtx_video_hdr", "Video HDR (learned)", "Video processor",
              "Learned SDR->HDR model on 8-bit SDR sources.", "bool"),

    FieldSpec("chroma_scaling", "Chroma scaling", "Scaling",
              "Chroma upsampling filter and siting.", "enum",
              enum_type=ChromaScaling),
    FieldSpec("upscaling", "Upscaling", "Scaling",
              "Interpolation filter when output exceeds source.",
              "enum", enum_type=Upscaling),
    FieldSpec("downscaling", "Downscaling", "Scaling",
              "Convolution filter when source exceeds output.",
              "enum", enum_type=Downscaling),
    FieldSpec("interpolate_at_50pct", "Downscale from 2x only", "Scaling",
              "Use the interpolation filter until the source is more than "
              "2x the output (the 50% rule).", "bool"),
    FieldSpec("use_dither", "Dithering", "Scaling",
              "Ordered dither when quantizing to 8/10 bits.", "bool"),
    FieldSpec("deint_blend", "Blend deinterlacing", "Scaling",
              "Cheap field blend for interlaced 4:2:0 sources.", "bool"),

    FieldSpec("convert_to_sdr", "Convert HDR to SDR", "HDR",
              "Tone-map PQ/HLG/DoVi sources for SDR displays.", "bool"),
    FieldSpec("sdr_display_nits", "SDR display nits", "HDR",
              "Brightness the SDR display maps 1.0 to.", "int",
              int_range=(SDR_NITS_MIN, SDR_NITS_MAX, SDR_NITS_STEP)),
    FieldSpec("hdr_passthrough", "HDR passthrough", "HDR",
              "Send PQ/BT.2020 to HDR-capable sinks untouched.", "bool"),
    FieldSpec("hdr_prefer_dovi", "Prefer Dolby Vision", "HDR",
              "Order DoVi above HDR10 when both are present (profile 7/8).",
              "bool"),
    FieldSpec("hdr_toggle_display", "Toggle display HDR", "HDR",
              "Switch the display's HDR mode on playback.", "enum",
              enum_type=HdrToggleDisplay),
    FieldSpec("hdr_osd_brightness", "HDR OSD brightness", "HDR",
              "0 = 100 nits, 1 = 50, 2 = 30.", "int", int_range=(0, 2, 1)),
    FieldSpec("hdr_local_tone_mapping", "Local tone mapping", "HDR",
              "Tone-map HDR passthrough toward the display's peak.", "bool"),
    FieldSpec("hdr_local_tone_mapping_type", "Tone-map operator", "HDR",
              "Operator for local tone mapping.", "enum",
              enum_type=ToneMapType),
    FieldSpec("hdr_display_max_nits", "HDR display max nits", "HDR",
              "Peak brightness of the HDR display.", "int",
              int_range=(HDR_NITS_MIN, HDR_NITS_MAX, 100)),
)


def _get(settings: Settings, name: str):
    if "." in name:
        a, b = name.split(".", 1)
        return getattr(getattr(settings, a), b)
    return getattr(settings, name)


def _set(settings: Settings, name: str, value) -> Settings:
    if "." in name:
        a, b = name.split(".", 1)
        sub = dataclasses.replace(getattr(settings, a), **{b: value})
        return dataclasses.replace(settings, **{a: sub})
    return dataclasses.replace(settings, **{name: value})


class PropertyPageModel:
    """State + edit operations of the settings page, UI-independent.

    ``on_apply`` receives the validated Settings (the ``SetSettings`` push
    into the running renderer, PropPage.cpp::OnApplyChanges).
    """

    def __init__(self, settings: Settings | None = None,
                 on_apply: Callable[[Settings], None] | None = None):
        self.initial = settings or Settings()
        self.value = self.initial
        self.on_apply = on_apply
        self.fields = FIELDS

    # -- dependency rules (the EnableWindow graph, PropPage.cpp:141-176) ----

    def enabled(self, spec: FieldSpec) -> bool:
        s = self.value
        if spec.name.startswith("vp_formats.") or spec.name in (
                "vp_deinterlacing", "deint_double", "vp_superres",
                "vp_rtx_video_hdr"):
            return s.use_accel_backend
        if spec.name == "sdr_display_nits":
            return s.convert_to_sdr
        if spec.name in ("hdr_local_tone_mapping_type",
                         "hdr_display_max_nits"):
            return s.hdr_local_tone_mapping
        if spec.name == "hdr_osd_brightness":
            return s.hdr_toggle_display != HdrToggleDisplay.DISABLED \
                or s.hdr_passthrough
        return True

    # -- edits ---------------------------------------------------------------

    @property
    def dirty(self) -> bool:
        return self.value != self.initial

    def display(self, spec: FieldSpec) -> str:
        v = _get(self.value, spec.name)
        if spec.kind == "bool":
            return "[x]" if v else "[ ]"
        if spec.kind == "enum":
            return v.name
        return str(v)

    def toggle(self, spec: FieldSpec) -> None:
        if spec.kind == "bool" and self.enabled(spec):
            self.value = _set(self.value, spec.name,
                              not _get(self.value, spec.name))

    def step(self, spec: FieldSpec, direction: int) -> None:
        """Cycle an enum or step an int by its increment (sliders/combos)."""
        if not self.enabled(spec):
            return
        v = _get(self.value, spec.name)
        if spec.kind == "bool":
            self.toggle(spec)
        elif spec.kind == "enum":
            members = list(spec.enum_type)
            i = (members.index(v) + direction) % len(members)
            self.value = _set(self.value, spec.name, members[i])
        else:
            lo, hi, st = spec.int_range
            self.value = _set(self.value, spec.name,
                              max(lo, min(hi, v + direction * st)))

    def set_value(self, name: str, value) -> None:
        spec = next(f for f in self.fields if f.name == name)
        if spec.kind == "enum":
            value = spec.enum_type(value)
        elif spec.kind == "int":
            lo, hi, _ = spec.int_range
            value = max(lo, min(hi, int(value)))
        else:
            value = bool(value)
        self.value = _set(self.value, name, value)

    def reset(self) -> None:
        """The Default button (PropPage.cpp::OnButtonDefault)."""
        self.value = Settings()

    def cancel(self) -> None:
        self.value = self.initial

    def apply(self) -> Settings:
        self.value = self.value.validate()
        self.initial = self.value
        if self.on_apply is not None:
            self.on_apply(self.value)
        return self.value


class InfoPageModel:
    """Read-only Info property page (CVRInfoPPage, Source/PropPage.cpp:
    the second page shows the GetVPInfo report in a scrollable edit box).

    ``provider`` returns the report text; it is called lazily on first view
    (and again on refresh) so constructing the model costs nothing when the
    user never opens the page."""

    def __init__(self, provider: Callable[[], str]):
        self.provider = provider
        self.scroll = 0
        self._lines: "list[str] | None" = None

    @property
    def lines(self) -> "list[str]":
        if self._lines is None:
            self.refresh()
        return self._lines

    def refresh(self) -> None:
        try:
            text = self.provider()
        except Exception as e:          # never crash the page on a bad probe
            text = f"(info unavailable: {e})"
        self._lines = text.splitlines() or [""]
        self.scroll = min(self.scroll, max(0, len(self._lines) - 1))

    def scroll_by(self, delta: int) -> None:
        self.scroll = min(max(0, self.scroll + delta),
                          max(0, len(self.lines) - 1))

    def visible(self, rows: int) -> "list[str]":
        return self.lines[self.scroll:self.scroll + rows]


def run_tui(model: PropertyPageModel,
            info: "InfoPageModel | None" = None) -> Settings:
    """Curses shell: arrows navigate, space toggles, left/right steps,
    'd' defaults, 'a'/enter applies, 'q' quits (applies if dirty).
    With ``info``, Tab switches between the Main and Info pages
    (the two ISpecifyPropertyPages pages of the reference)."""
    import curses

    def draw_info(scr):
        h, w = scr.getmaxyx()
        scr.addnstr(0, 0, "videorenderer_tpu_torch info — ↑/↓ scroll, "
                    "r refresh, Tab settings, q quit", w - 1, curses.A_BOLD)
        for i, line in enumerate(info.visible(h - 3)):
            scr.addnstr(2 + i, 0, line, w - 1)

    def main(scr):
        curses.curs_set(0)
        sel = 0
        page = 0
        while True:
            if info is not None and page == 1:
                scr.erase()
                draw_info(scr)
                scr.refresh()
                ch = scr.getch()
                if ch in (ord("q"), 27):
                    if model.dirty:
                        model.apply()
                    return
                if ch == 9:
                    page = 0
                elif ch == curses.KEY_UP:
                    info.scroll_by(-1)
                elif ch == curses.KEY_DOWN:
                    info.scroll_by(+1)
                elif ch == ord("r"):
                    info.refresh()
                continue
            scr.erase()
            h, w = scr.getmaxyx()
            scr.addnstr(0, 0, "videorenderer_tpu_torch settings — space "
                        "toggle, ←/→ change, d default, a apply, "
                        + ("Tab info, " if info is not None else "")
                        + "q quit", w - 1,
                        curses.A_BOLD)
            row = 2
            group = None
            positions = []
            for spec in model.fields:
                if spec.group != group:
                    group = spec.group
                    if row < h - 1:
                        scr.addnstr(row, 0, f"── {group} ──", w - 1,
                                    curses.A_UNDERLINE)
                    row += 1
                positions.append((row, spec))
                row += 1
            for i, (r, spec) in enumerate(positions):
                if r >= h - 2:
                    break
                attr = curses.A_REVERSE if i == sel else curses.A_NORMAL
                if not model.enabled(spec):
                    attr |= curses.A_DIM
                line = f"  {spec.label:<28} {model.display(spec)}"
                scr.addnstr(r, 0, line, w - 1, attr)
            hint = model.fields[sel].hint
            status = "modified" if model.dirty else "saved"
            if h > 3:
                scr.addnstr(h - 2, 0, hint, w - 1, curses.A_DIM)
                scr.addnstr(h - 1, 0, f"[{status}]", w - 1)
            scr.refresh()
            ch = scr.getch()
            if ch in (ord("q"), 27):
                if model.dirty:
                    model.apply()
                return
            if ch == 9 and info is not None:
                page = 1
            elif ch == curses.KEY_UP:
                sel = (sel - 1) % len(model.fields)
            elif ch == curses.KEY_DOWN:
                sel = (sel + 1) % len(model.fields)
            elif ch == ord(" "):
                model.toggle(model.fields[sel])
            elif ch == curses.KEY_LEFT:
                model.step(model.fields[sel], -1)
            elif ch == curses.KEY_RIGHT:
                model.step(model.fields[sel], +1)
            elif ch == ord("d"):
                model.reset()
            elif ch in (ord("a"), 10, 13):
                model.apply()

    curses.wrapper(main)
    return model.value
