"""Minimal SRT subtitle parser feeding the subtitle subsystem.

The reference consumes subtitles from external DirectShow filters
(XySubFilter et al.); standalone, a basic SRT loader makes
:class:`videorenderer_tpu_torch.subtitles.TextSubtitleProvider` usable
directly.  A copy of ``videorenderer_tpu.io.srt``.
"""

from __future__ import annotations

import re

from ..subtitles import TextEvent, TextSubtitleProvider

_TIME = re.compile(
    r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
_TAGS = re.compile(r"<[^>]+>|\{[^}]*\}")


def _secs(h, m, s, ms) -> float:
    return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000.0


def parse_srt(text: str) -> list[TextEvent]:
    events: list[TextEvent] = []
    blocks = re.split(r"\n\s*\n", text.strip().replace("\r\n", "\n"))
    for block in blocks:
        lines = [ln for ln in block.split("\n") if ln.strip()]
        if not lines:
            continue
        ti = 0
        if lines[0].strip().isdigit():
            ti = 1
        if ti >= len(lines):
            continue
        m = _TIME.search(lines[ti])
        if not m:
            continue
        start = _secs(*m.groups()[:4])
        stop = _secs(*m.groups()[4:])
        body = _TAGS.sub("", "\n".join(lines[ti + 1:])).strip()
        if body:
            events.append(TextEvent(start=start, stop=stop, text=body))
    return events


def load_srt(path: str, size: int = 24, encoding: str = "utf-8-sig"
             ) -> TextSubtitleProvider:
    with open(path, encoding=encoding, errors="replace") as f:
        return TextSubtitleProvider(parse_srt(f.read()), size=size)
