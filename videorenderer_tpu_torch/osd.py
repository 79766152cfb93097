"""On-screen display: font atlas, stats panel, sync-offset graph — a numpy
copy of ``videorenderer_tpu.osd``.

Reference equivalents:
 * GDI-rasterized glyph atlas ``CFontBitmapGDI`` (Source/D3DUtil/FontBitmap.h)
   -> here a Pillow-rasterized atlas (host-side, cached numpy), with a
   built-in 5x7 fallback when Pillow is unavailable
 * ``CD3D11Font::Draw2DText`` textured-quad text (Source/D3DUtil/D3D11Font.cpp)
   -> glyph blit into an RGBA overlay plane composited on device
 * stats background/graph geometry ``CD3D11Rectangle/Polyline`` incl.
   ``AddGFPoints`` sync-graph plotting (Source/D3DUtil/D3D11Geometry.h:58-147)
 * the stats text block itself (DrawStats,
   Source/DX11VideoProcessor.cpp:4383-4514)

The overlay bitmap is built host-side (it changes once per frame and is tiny
relative to video), then uploaded and alpha-blended on the renderer's device
via :func:`videorenderer_tpu_torch.ops.overlay.blend_in_rect` (or its packed
form).
"""

from __future__ import annotations

import functools

import numpy as np

try:
    from PIL import Image, ImageDraw, ImageFont
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


@functools.cache
def glyph_atlas(size: int = 16) -> dict:
    """Rasterize ASCII 32..126 into a {char: (h, w) uint8 alpha} atlas."""
    chars = [chr(c) for c in range(32, 127)]
    if _HAVE_PIL:
        try:
            font = ImageFont.load_default(size=size)
        except TypeError:  # older Pillow
            font = ImageFont.load_default()
        atlas = {}
        for ch in chars:
            bbox = font.getbbox(ch)
            w = max(1, int(bbox[2]))
            h = size + 4
            img = Image.new("L", (w, h), 0)
            ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
            atlas[ch] = np.asarray(img, dtype=np.uint8)
        return atlas
    # Pillow-free fallback: the bundled 5x7 bitmap font, scaled to ~size
    # (legible stats text instead of filled boxes)
    scale = max(1, size // 8)
    atlas = {}
    for ch in chars:
        g = _FONT5X7.get(ch)
        if g is None:
            g = _FONT5X7.get(ch.upper())
        if g is None:
            bits = np.zeros((7, 5), np.uint8) if ch == " " else \
                np.pad(np.ones((5, 3), np.uint8), ((1, 1), (1, 1)))
        else:
            bits = g
        img = np.kron(bits, np.ones((scale, scale), np.uint8)) * 255
        # 1-pixel-scaled letter spacing column
        atlas[ch] = np.pad(img, ((0, scale), (0, scale)))
    return atlas


def _f57(*rows: str) -> np.ndarray:
    """7 strings of 5 chars ('#' = on) -> (7, 5) uint8 bitmap."""
    return np.array([[1 if c == "#" else 0 for c in r.ljust(5)]
                     for r in rows], np.uint8)


# classic 5x7 glyph set (the stats panel's working set; other characters
# fall back to a box) — replaces the illegible filled-box fallback
_FONT5X7 = {
    " ": _f57("", "", "", "", "", "", ""),
    "0": _f57(" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "),
    "1": _f57("  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),
    "2": _f57(" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"),
    "3": _f57(" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "),
    "4": _f57("   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "),
    "5": _f57("#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "),
    "6": _f57(" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "),
    "7": _f57("#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "),
    "8": _f57(" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "),
    "9": _f57(" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "),
    "A": _f57(" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"),
    "B": _f57("#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "),
    "C": _f57(" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "),
    "D": _f57("#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "),
    "E": _f57("#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"),
    "F": _f57("#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "),
    "G": _f57(" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ####"),
    "H": _f57("#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"),
    "I": _f57(" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),
    "J": _f57("  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "),
    "K": _f57("#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"),
    "L": _f57("#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"),
    "M": _f57("#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"),
    "N": _f57("#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"),
    "O": _f57(" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "),
    "P": _f57("#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "),
    "Q": _f57(" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"),
    "R": _f57("#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"),
    "S": _f57(" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "),
    "T": _f57("#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "),
    "U": _f57("#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "),
    "V": _f57("#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "),
    "W": _f57("#   #", "#   #", "#   #", "# # #", "# # #", "# # #", " # # "),
    "X": _f57("#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"),
    "Y": _f57("#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "),
    "Z": _f57("#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"),
    ":": _f57("", "  #  ", "  #  ", "", "  #  ", "  #  ", ""),
    ".": _f57("", "", "", "", "", " ##  ", " ##  "),
    ",": _f57("", "", "", "", " ##  ", "  #  ", " #   "),
    "-": _f57("", "", "", "#####", "", "", ""),
    "+": _f57("", "  #  ", "  #  ", "#####", "  #  ", "  #  ", ""),
    "(": _f57("   # ", "  #  ", " #   ", " #   ", " #   ", "  #  ", "   # "),
    ")": _f57(" #   ", "  #  ", "   # ", "   # ", "   # ", "  #  ", " #   "),
    "%": _f57("##   ", "##  #", "   # ", "  #  ", " #   ", "#  ##", "   ##"),
    "/": _f57("    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "),
    "=": _f57("", "", "#####", "", "#####", "", ""),
    "#": _f57(" # # ", " # # ", "#####", " # # ", "#####", " # # ", " # # "),
    "_": _f57("", "", "", "", "", "", "#####"),
    "'": _f57("  #  ", "  #  ", "", "", "", "", ""),
    "!": _f57("  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "", "  #  "),
    "?": _f57(" ### ", "#   #", "    #", "   # ", "  #  ", "", "  #  "),
    "[": _f57(" ### ", " #   ", " #   ", " #   ", " #   ", " #   ", " ### "),
    "]": _f57(" ### ", "   # ", "   # ", "   # ", "   # ", "   # ", " ### "),
    "<": _f57("   # ", "  #  ", " #   ", "#    ", " #   ", "  #  ", "   # "),
    ">": _f57(" #   ", "  #  ", "   # ", "    #", "   # ", "  #  ", " #   "),
    "*": _f57("", "# # #", " ### ", "#####", " ### ", "# # #", ""),
}


def render_text(text: str, size: int = 16) -> np.ndarray:
    """Rasterize a multi-line string to a (H, W) uint8 alpha bitmap."""
    atlas = glyph_atlas(size)
    lines = text.split("\n")
    line_h = max(g.shape[0] for g in atlas.values())
    width = max(1, max(sum(atlas.get(c, atlas[" "]).shape[1] for c in line)
                       for line in lines))
    out = np.zeros((line_h * len(lines), width), np.uint8)
    for li, line in enumerate(lines):
        x = 0
        for c in line:
            g = atlas.get(c, atlas[" "])
            out[li * line_h: li * line_h + g.shape[0], x:x + g.shape[1]] = \
                np.maximum(out[li * line_h: li * line_h + g.shape[0],
                               x:x + g.shape[1]], g)
            x += g.shape[1]
    return out


def draw_polyline(canvas: np.ndarray, points: list[tuple[int, int]],
                  value: int = 255) -> None:
    """Integer Bresenham polyline into a uint8 canvas (the sync-offset graph
    polyline, CD3D11Polyline/AddGFPoints analogue)."""
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        dx = abs(x1 - x0)
        dy = -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        x, y = x0, y0
        while True:
            if 0 <= y < canvas.shape[0] and 0 <= x < canvas.shape[1]:
                canvas[y, x] = value
            if x == x1 and y == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x += sx
            if e2 <= dx:
                err += dx
                y += sy


def render_stats_overlay(stats: dict, graph_values: list[float] | None = None,
                         size: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Build the stats panel (text + optional sync graph) as an RGBA-style
    pair (rgb (3,H,W) float in [0,1], alpha (H,W) float) for on-device
    compositing.  Text layout mirrors DrawStats
    (Source/DX11VideoProcessor.cpp:4452-4460)."""
    text = (
        f"Frames: {stats.get('frames_drawn', 0)}  "
        f"Dropped: {stats.get('frames_dropped', 0)}  "
        f"Failed: {stats.get('frames_failed', 0)}\n"
        f"Input fps: {stats.get('input_fps', 0.0):6.2f}   "
        f"Draw fps: {stats.get('draw_fps', 0.0):6.2f}\n"
        f"Copy: {stats.get('copy_ms', 0.0):6.2f} ms  "
        f"Paint: {stats.get('paint_ms', 0.0):6.2f} ms  "
        f"Present: {stats.get('present_ms', 0.0):6.2f} ms\n"
        f"Sync offset: {stats.get('sync_offset_ms', 0.0):+6.2f} ms "
        f"(avg {stats.get('avg_sync_offset_ms', 0.0):+6.2f} "
        f"dev {stats.get('dev_sync_offset_ms', 0.0):6.2f})\n"
        f"Jitter: {stats.get('jitter_ms', 0.0):6.2f} ms"
    )
    alpha = render_text(text, size).astype(np.float32) / 255.0

    if graph_values:
        gh, gw = 64, max(len(graph_values), 2)
        canvas = np.zeros((gh, gw), np.uint8)
        vmax = max(1e-9, max(abs(v) for v in graph_values))
        pts = [(i, int(gh / 2 - (v / vmax) * (gh / 2 - 1)))
               for i, v in enumerate(graph_values)]
        draw_polyline(canvas, pts)
        canvas[gh // 2, :] = 80  # zero axis
        graph = canvas.astype(np.float32) / 255.0
        w = max(alpha.shape[1], graph.shape[1])
        merged = np.zeros((alpha.shape[0] + gh + 4, w), np.float32)
        merged[:alpha.shape[0], :alpha.shape[1]] = alpha
        merged[alpha.shape[0] + 4:, :graph.shape[1]] = graph
        alpha = merged

    # white text over a semi-transparent dark panel
    panel_alpha = np.maximum(alpha, 0.55)
    rgb = np.broadcast_to(alpha[None], (3,) + alpha.shape).astype(np.float32)
    return rgb, panel_alpha
