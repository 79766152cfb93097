#!/usr/bin/env python3
"""Registers, spills, occupancy and the per-pixel SASS counts of kernels K1
(``banded_resize.cu``), K2 (``rows3_tail*.cu``, its Dolby Vision route
``rows3_tail_dovi*.cu`` too), K3
(``banded_resize_rows.cu``), K4 (``mega3_tail*.cu``), K5
(``jinc2_resize.cu``), K6 (``jinc2_convert.cu``), K7
(``deint3_rows_dual.cu``), K8 (``rows3_mid*.cu``), K9 (``cols3_tail*.cu``)
and K10 (``probe_wpass.cu``), on a machine with the CUDA toolkit.

    python3 kernel_report.py [--csrc DIR] [--launch NAME=THREADS,SMEM ...]
                             [--pixels NAME=N ...]

For each source, ``nvcc`` with the package's own flags
(``kernels/build.NVCC_FLAGS``) plus ``-cubin -lineinfo -Xptxas -v`` gives
every kernel instantiation's registers a thread, stack and spill bytes;
``nvdisasm --print-line-info-inline`` then attributes each SASS instruction
to the source lines it came from.  ``-lineinfo`` adds line tables only; the
report also counts each function's instructions in the package's own built
library (``cuobjdump -sass``) and says whether the counts match.

Per function it prints one JSON line:
  * ``registers``, ``stack_bytes``, ``spill_store_bytes``,
    ``spill_load_bytes`` (ptxas);
  * ``blocks_per_sm``: resident blocks an SM holds at ``--launch``'s block
    size and dynamic shared memory (by default K4's staged kernel at the
    headline's tile (its c7 route at c7's) and its long-window kernel at
    the 160 x 90 Lanczos thumbnail's chunks, K10's ``wpass_bf16`` at the
    headline luma's span and ``wpass_floor`` with its 32 KB tile, the
    long-window kernels of
    K2, K3, K7, K8 and K9 at 256 threads and none, K7's and K9's at c5,
    K9's c8 route's and K8's at c8 (its heavy routes' at 16-row tiles),
    K6's at c3, K5's at c3r270 (c3's geometry), K3's on the letterbox's
    luma map, from ``kernels/deint``'s, ``kernels/jinc2``'s and
    ``kernels/resize``'s formulas on those maps; 128 threads and none for
    the others) (the occupancy calculator's rules:
    registers allocated per warp in units of 256, 64 warps, 32 blocks and
    228 KB of shared memory an SM, 1 KB reserved a block), and
    ``warps_per_sm``;
  * ``instructions``: the function's SASS instructions, ``branches`` its
    BRA and ``fchk`` its FCHK instructions (each __fdiv_rn's range check,
    with its branch to the slow path); ``tail``: those
    whose source location, or any function they were inlined from, lies in
    ``tail.cuh`` or ``epilogue.cuh`` (the colour matrix, correction, tone
    map, quantization and pack); ``tail_second_pass``: those among them
    inlined through ``tail_exact`` (``route.cuh``, shared by K2 and K9;
    the one-pixel pass a compiled
    route runs only when CheckedDiv refuses a group); ``tail_mufu``: the
    MUFU instructions among them; ``h_pass_ffma``: the FFMAs attributed to
    the kernel's own source;
  * for K2 (``rows3_tail``), K4 (``mega3_tail``) and K9 (``cols3_tail``),
    the issue bound of the tail at their cells (PIXELS: K2 and K4 at the
    headline, 16 x 1080 x 1920 pixels, and c7, 16 x 2160 x 3840; K9 at c5,
    both fields of 16 frames,
    32 x 1080 x 1920, and c8, 16 x 1080 x 1920): tail instructions a pixel
    x pixels / (132 SMs x 4 schedulers x 32 lanes x the SM clock), and the
    MUFU part at 16 a clock an SM;
  * for K8, K6 and K5, ``parts``: the static instructions and MUFU of each
    per-pixel part, those whose source location, or any function they were
    inlined from, lies in the part's functions (PARTS: K8's ``mid`` and
    K2's Dolby Vision route's ``convert``, the DoVi convert of
    ``dovi_mid.cuh``; K6's and K5's ``weights``,
    ``jinc2.cuh``'s per-output weights, which the table route does not
    compute, and ``resolve``, the taps' weighted sums and anti-ringing;
    K5's ``quantize``, the dither or rounding of ``epilogue.cuh``), each
    also a pixel (over the pixels a thread makes in one pass, PART_GROUP:
    4 for K8's c8 route, K6 and K5's table routes, 1 for K8's routes that
    convert one pixel at a time, K5's per-output routes and the
    one-output-a-thread K5 that the tiled one replaced)
    and as an issue bound at the part's cell (PART_PIXELS: K8's mid pixels
    at c8, 16 x 2160 x 3840; K6's outputs at c3, 16 x 2160 x 3840; K5's at
    c3r270, 48 planes of 2160 x 3840); and ``per_pixel``, all of the
    function's static instructions over the same pass, with its issue
    bound (an upper estimate: it holds the set-up and staging a block runs
    once beside the passes it repeats);
  * for K2, K4 and K8 (and K2's Dolby Vision route), the ``pow`` part:
    the instructions inlined from the tail's pows (tail.cuh's pow_pos, and
    the checked pow of the c7 routes and of K8's LMS route, CheckedPow with
    log2_normal, and pow_of where the sources have them), their
    ``second_pass`` share, and ``per_pixel``, counted as the tail's
    instructions a pixel are (below).  K8's second pass is the LMS steps
    its LMS route runs again exactly for a group the range flag refused
    (dovi_mid.cuh: dovi_mid_group's ``if (!div.ok)`` block); its parts'
    ``per_pixel`` leave that pass out, and its LMS-step parts (``lms``,
    ``pow``, ``divisions``: a loop that is not unrolled, kLmsLanes pixels
    a pass, read from dovi_mid.cuh as ``lms_lanes``) count over that
    loop's pass (``mid`` too for its LMS steps);
  * ``sass_sha256``: a digest of the function's SASS instructions (opcodes
    and operands, without addresses and line information, the labels and
    subroutines nvdisasm numbers over the whole cubin renumbered within
    the function, its own name in a return written ``<self>``), so that
    two trees' reports show which functions' code is the same (a kernel
    that gains a parameter it does not read keeps its digest, though its
    mangled name changes).
  Instructions a pixel are the static
    ``tail`` count without the second pass over ``--pixels`` (the pixels a
    thread makes in one unrolled pass: 4 for K2's, K4's and K9's kernels
    unless given), or the whole ``tail`` where a function has only the one-pixel
    pass.  That is the dynamic count where the tail is one straight route
    (no runtime flags); a runtime-flag instantiation holds every route, so
    its static count is not one route's.  The MUFU count still holds the
    second pass's.
Then one line with the card's name, power limit and SM clocks
(``nvidia-smi``).  The clock used is ``clocks.max.sm``, so the bound is the
least time.  Needs ``nvcc``, ``nvdisasm`` and ``cuobjdump``; runs without a
card (then no clock line and no bound).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from videorenderer_tpu_torch.kernels import build  # noqa: E402

SOURCE_GLOBS = ("banded_resize.cu", "rows3_tail*.cu", "deint3_rows_dual.cu",
                "cols3_tail*.cu", "rows3_mid*.cu", "jinc2_convert.cu",
                "jinc2_resize.cu", "banded_resize_rows.cu", "mega3_tail*.cu",
                "probe_wpass.cu")
TAIL_FILES = ("tail.cuh", "epilogue.cuh")
SMS, SCHEDULERS, LANES, MUFU_PER_CLK = 132, 4, 32, 16
# the cells each tail kernel's issue bound is given at, by source prefix
PIXELS = {"rows3_tail_dovi": {},   # no tail: its convert is a part
          "rows3_tail": {"headline": 16 * 1080 * 1920,
                         "c7": 16 * 2160 * 3840},
          "mega3_tail": {"headline": 16 * 1080 * 1920,
                         "c7": 16 * 2160 * 3840},
          "cols3_tail": {"c5": 32 * 1080 * 1920, "c8": 16 * 1080 * 1920}}
# the pixels a thread makes in one pass of the compiled routes (K4: both
# its kernels)
GROUP = {"rows3_tail_kernel": 4, "cols3_tail_kernel": 4, "mega3_tail": 4}
# c8's K9 route as the demangled name spells it (route.cuh: C8)
C8_ROUTE = "Route<0, 1, 0, 1, 1>"
# K4's staged kernel on c7's route (route.cuh: C7Float), likewise
K4_C7_ROUTE = "mega3_tail_kernel<vrt::Route<1, 0, 5, 1, 0,"
# the per-pixel parts of K8, K6 and K5, by source prefix: part -> (the
# files that may define its functions, the first one that does counting;
# the functions whose inlined instructions it counts)
_JINC2_PARTS = {"weights": (("jinc2.cuh",), ("jinc2_weight", "jinc2_weights")),
                "resolve": (("jinc2.cuh",), ("jinc2_resolve",))}
_DOVI_PART = (("dovi_mid.cuh", "rows3_mid.cuh", "rows3_mid.cu"),
              ("dovi_mid", "dovi_mid_group", "reshape", "reshape_group",
               "mmr", "mmr_fixed", "lms_step", "lms_lanes"))
# the convert's own parts (dovi_mid.cuh): the reshape; the RPU matrix and
# the LMS step (the PQ EOTFs, the LMS matrix, the PQ OETFs), as the spans
# from a line that matches the first pattern to the next that matches the
# second; and the divisions, every instruction inlined from ExactDiv's or
# CheckedDiv's operator (tail.cuh)
_DOVI_PARTS = {
    "reshape": (("dovi_mid.cuh",), ("reshape", "reshape_group", "mmr",
                                    "mmr_fixed")),
    "rpu": (("dovi_mid.cuh",), ((r"P\.vals \+ 4 \* i\b", r"m\[3\]\)"),)),
    "lms": (("dovi_mid.cuh",), ((r"pq_to_linear\(",
                                 r"fmaxf\(vrt::dot3\(m\[0\], m\[1\], m\[2\], "
                                 r"x\["),)),
    "divisions": (("tail.cuh",), ((r"^struct ExactDiv\b", r"^};"),
                                  (r"^struct CheckedDiv\b", r"^};")))}
# the tail's pows (tail.cuh): pow_pos (libdevice's log2f and exp2f), and
# where the sources have them the checked pow of the c7 routes (CheckedPow,
# log2_normal) and the policy's dispatch (pow_of)
_POW_PART = (("tail.cuh",), ("pow_pos", "log2_normal",
                             (r"^struct CheckedPow\b", r"^};"),
                             (r"^__device__ __forceinline__ float pow_of\(",
                              r"^}")))
PARTS = {"rows3_mid": {"mid": _DOVI_PART, **_DOVI_PARTS, "pow": _POW_PART},
         "rows3_tail_dovi": {"convert": _DOVI_PART, **_DOVI_PARTS,
                             "pow": _POW_PART},
         "rows3_tail": {"pow": _POW_PART},
         "mega3_tail": {"pow": _POW_PART},
         "jinc2_convert": _JINC2_PARTS,
         "jinc2_resize": {**_JINC2_PARTS,
                          "quantize": (("epilogue.cuh",),
                                       ("quantize", "bayer", "clip01"))}}
# K8's staged kernel on its LMS route, which converts 4 adjacent columns a
# thread side by side (rows3_mid.cuh: LmsMid; --part-group
# "<this>=1" for a tree that converts one pixel a thread there)
K8_LMS_ROUTE = "rows3_mid_kernel<vrt::dovi::MidRoute<1, -1>"
# the pixels of each part's cell, and the pixels a thread converts in one
# pass (by name substring; K8's c8 route as the demangled name spells it,
# rows3_mid.cuh: C8Mid; K5's table routes, kWeights 1, unroll their 4
# outputs, its per-output routes and the one-output-a-thread kernel it
# replaced make one at a time; 1 where none matches)
PART_PIXELS = {"rows3_mid": {"c8": 16 * 2160 * 3840,
                             # p5's converts a call: 16-row tiles convert
                             # 34 mid rows for 32
                             "p5": 16 * 2160 * 3840 * 34 // 32},
               "rows3_tail_dovi": {"c8": 16 * 2160 * 3840},
               "jinc2_convert": {"c3": 16 * 2160 * 3840},
               "jinc2_resize": {"c3r270": 48 * 2160 * 3840}}
PART_GROUP = {"MidRoute<0, 1>": 4, K8_LMS_ROUTE: 4,
              "jinc2_convert_kernel": 4, "jinc2_resize_kernel<1,": 4}
# K8's heavy routes as the demangled names spell them (LmsMid, RuntimeMid;
# K2's Dolby Vision route on the same routes is not K8's)
K8_HEAVY_ROUTES = (K8_LMS_ROUTE,
                   "rows3_mid_kernel<vrt::dovi::MidRoute<-1, -1>")
# the long-window kernels' names: rows3_tail_long_kernel,
# cols3_tail_long_kernel, deint3_long_kernel, banded_resize_rows_long_kernel,
# rows3_mid_long_kernel
LONG_WINDOW = "_long_kernel"


def default_launches() -> list[tuple[str, tuple[int, int]]]:
    """(name substring, (threads, dynamic shared memory)) of K4's kernels
    (:func:`k4_launches`), K10's, the long-window kernels (no shared
    memory), and K7 and K9 at the cells their paths run, from
    kernels/deint's formulas on c5's and c8's maps; the first substring a
    function's name contains applies."""
    from videorenderer_tpu_torch import config as C, csputils as S
    from videorenderer_tpu_torch.kernels import deint as dk
    from videorenderer_tpu_torch.kernels import resize as rk
    from videorenderer_tpu_torch.ops import chroma, scale
    wy = scale.upscale_matrix(C.Upscaling.LANCZOS3, 2160, 1080)
    wx = scale.upscale_matrix(C.Upscaling.LANCZOS3, 3840, 1920)
    ux, uy = chroma.chroma_upsample_matrices(
        1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    from videorenderer_tpu_torch.kernels import jinc2 as jk
    k8x = rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.CATMULL_ROM, 3840,
                                               1920))
    k8h = rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.CATMULL_ROM, 2160,
                                               1080))
    n16 = 1 / 65535.0
    k4 = k4_launches(wx, wy, ux, uy, n16)
    kw = rk.BandedMatrix(wx, pre_scale=n16)
    span = kw.row_windows(rk.K1_SPAN)[1]
    return [
        # K4 (before the long-window entry, whose name its long-window
        # kernel's contains) and K10
        *k4,
        ("wpass_bf16_kernel", (128, rk.k1_smem_bytes(
            2, span, rk.k1_rows(2, span)))),
        ("wpass_floor_kernel", (256, 32768)),   # its static tile
        # the long-window routes of K2, K3, K7, K8 and K9: 256 threads, no
        # shared memory (matched before the staged kernels' routes)
        (LONG_WINDOW, (256, 0)),
        ("deint3_kernel", (256, dk.k7_smem_bytes(
            2, rk.BandedMatrix(wy, pre_scale=n16),
            rk.BandedMatrix(uy @ wy, pre_scale=n16)))),
        (C8_ROUTE, (256, dk.k9_smem_bytes(4, 4, k8x, k8x))),
        ("cols3_tail_kernel", (256, dk.k9_smem_bytes(
            4, 4, rk.BandedMatrix(wx), rk.BandedMatrix(ux @ wx)))),
        # K8 at c8: uint16 luma read directly, the chroma upsample's H map
        # on float32 chroma; the heavy routes (the variant's 69 curve
        # scalars; the LMS route's tiles, the runtime route's 16 rows)
        # before c8's light one (30, 32-row tiles)
        *((r, (256, dk.k8_smem_bytes(2, 4, None, rk.BandedMatrix(uy), k8h,
                                     2160, 69, rows)))
          for r, rows in zip(K8_HEAVY_ROUTES,
                             (getattr(dk, "K8_LMS_TILE_ROWS",
                                      dk.K8_HEAVY_TILE_ROWS),
                              dk.K8_HEAVY_TILE_ROWS))),
        ("rows3_mid_kernel", (256, dk.k8_smem_bytes(
            2, 4, None, rk.BandedMatrix(uy), k8h, 2160, 30))),
        # K2's Dolby Vision route at c8's stage A (c8's 30 scalars)
        ("rows3_tail_dovi_kernel", (256, rk.k2_dovi_smem_bytes(
            2, 4, None, rk.BandedMatrix(uy), 30))),
        ("jinc2_convert_kernel", (256, jk.k6_smem_bytes(1080, 1920, 2160,
                                                        3840, False))),
        ("jinc2_resize_kernel", (256, jk.k5_window(1080, 1920, 2160,
                                                   3840)[2])),
        ("banded_resize_rows_kernel", (256, rk.k3_smem_bytes(
            4, rk.BandedMatrix(scale.upscale_matrix(C.Upscaling.LANCZOS3,
                                                    1608, 804))))),
    ]

def k4_launches(wx, wy, ux, uy, norm) -> list[tuple[str, tuple[int, int]]]:
    """K4's kernels at the shared memory kernels/resize.k4_route and
    k4_smem_bytes give: the staged kernel at the headline's maps (the W and
    H maps ``wx``, ``wy``, the chroma composed with the upsample ``ux``,
    ``uy``), its c7 route at c7's (luma direct, the chroma upsample) and
    the long-window kernel at the headline source to a 160 x 90 Lanczos
    thumbnail; 256 threads."""
    from videorenderer_tpu_torch import config as C, csputils as S
    from videorenderer_tpu_torch.kernels import resize as rk
    from videorenderer_tpu_torch.ops import chroma, scale

    def smem(mx_y, my_y, mx_c, my_c):
        (ky, hy), (kc, hc) = (rk.mega_maps(mx_y, my_y, norm),
                              rk.mega_maps(mx_c, my_c, norm))
        route, rows, chunk = rk.k4_route(2, 2, ky, kc, hy, hc)
        return 256, rk.k4_smem_bytes(2, 2, ky, kc, hy, hc, rows, chunk,
                                     route == "long-window")

    tx = scale.downscale_matrix(C.Downscaling.LANCZOS, 3840, 160)
    ty = scale.downscale_matrix(C.Downscaling.LANCZOS, 2160, 90)
    tux, tuy = chroma.chroma_upsample_matrices(
        1920, 1080, 420, C.ChromaScaling.BILINEAR, S.ChromaLocation.MPEG2)
    return [("mega3_tail_long_kernel", smem(tx, ty, tux @ tx, tuy @ ty)),
            (K4_C7_ROUTE, smem(None, None, ux, uy)),
            ("mega3_tail_kernel", smem(wx, wy, ux @ wx, uy @ wy))]


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);")
_FILE = re.compile(r'"([^"]+)"')


def _tool(name: str) -> str:
    for c in (shutil.which(name),
              os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", name)):
        if c and os.path.exists(c):
            return c
    raise RuntimeError(f"{name} not found")


def ptxas_info(log: str) -> dict:
    """Registers, stack and spill bytes of each entry function."""
    info, cur = {}, None
    for ln in log.splitlines():
        m = _ENTRY.search(ln)
        if m:
            cur = m.group(1)
            info[cur] = {}
            continue
        if cur is None:
            continue
        m = _PROPS.search(ln)
        if m:
            info[cur].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = _REGS.search(ln)
        if m:
            info[cur]["registers"] = int(m.group(1))
    return info


def second_pass_lines(csrc: Path) -> tuple:
    """(file, first line, last line) of tail_exact, the one-pixel tail that
    a compiled route runs only for a group CheckedDiv refused (and the
    runtime route runs for every pixel): in route.cuh, which K2 and K9
    share, or in rows3_tail.cuh in sources that keep it there; (None, 0,
    -1) where the sources have none."""
    for name in ("route.cuh", "rows3_tail.cuh"):
        src = csrc / name
        if not src.exists():
            continue
        lines = src.read_text().splitlines()
        first = next((i for i, ln in enumerate(lines, 1)
                      if "void tail_exact(" in ln), None)
        if first is None:
            continue
        last = next(i for i, ln in enumerate(lines, 1)
                    if i > first and ln == "}")
        return src.name, first, last
    return None, 0, -1


# the LMS steps that K8's LMS route runs again exactly, one pixel at a
# time, for a group whose range flag is false (dovi_mid.cuh:
# dovi_mid_group)
_LMS_REDO = (("dovi_mid.cuh",), ((r"^  if \(!div\.ok\) \{", r"^  \}$"),))


def lms_second_pass_lines(csrc: Path) -> tuple:
    """(file, first line, last line) of K8's second pass, the block of
    dovi_mid_group that runs a refused group's LMS steps again exactly;
    (None, 0, -1) where the sources have none."""
    found = function_lines(csrc, *_LMS_REDO)
    return found[0] if found else (None, 0, -1)


# the second pass of each source prefix's kernels (default: tail_exact)
SECOND_PASS = {"rows3_mid": lms_second_pass_lines,
               "rows3_tail_dovi": lms_second_pass_lines}


def function_lines(csrc: Path, names: tuple, funcs: tuple) -> list:
    """(file, first line, last line) of each function of ``funcs`` defined
    in the first file of ``names`` under ``csrc`` that defines any: from
    the line that starts with its signature (the name then "(", not
    indented) to the first line that is "}" alone.  An entry of ``funcs``
    that is a (start, end) pair of patterns stands for every span from a
    line that matches ``start`` to the first line from there on that
    matches ``end``."""
    for name in names:
        found = _function_lines(csrc, name, funcs)
        if found:
            return found
    return []


def _function_lines(csrc: Path, name: str, funcs: tuple) -> list:
    src = csrc / name
    if not src.exists():
        return []
    lines = src.read_text().splitlines()
    out = []
    for fn in funcs:
        if isinstance(fn, tuple):
            start, end = (re.compile(p) for p in fn)
            for i, ln in enumerate(lines, 1):
                if start.search(ln):
                    last = next(j for j, x in enumerate(lines, 1) if j >= i
                                and end.search(x))
                    out.append((name, i, last))
            continue
        pat = re.compile(r"\b" + re.escape(fn) + r"\(")
        for i, ln in enumerate(lines, 1):
            if not pat.search(ln) or ln.strip().startswith(("//", "return")) \
                    or ln.startswith(" "):
                continue
            last = next(j for j, x in enumerate(lines, 1) if j > i
                        and x == "}")
            out.append((name, i, last))
            break
    return out


_AT = re.compile(r'"([^"]+)", line (\d+)')


def sass_counts(text: str, second: tuple = (None, 0, -1),
                parts: dict | None = None) -> dict:
    """Per function: instructions, tail instructions (and those inlined
    through ``second``, the second pass), tail MUFU, and the FFMAs outside
    the tail files, from nvdisasm output with inline line info; and for
    each part of ``parts`` (name -> line ranges of function_lines) the
    instructions and MUFU inlined from those ranges."""
    parts = parts or {}
    out, fn, locs, chain = {}, None, set(), False
    for ln in text.splitlines():
        s = ln.strip()
        m = re.match(r"^\.text\.(\S+):$", s)
        if m:
            fn, locs, chain = m.group(1), set(), False
            out[fn] = {"instructions": 0, "branches": 0, "fchk": 0,
                       "tail": 0, "tail_mufu": 0, "tail_second_pass": 0,
                       "h_pass_ffma": 0}
            if parts:
                out[fn]["parts"] = {
                    p: {"instructions": 0, "mufu": 0,
                        **({"second_pass": 0} if second[0] else {})}
                    for p in parts}
            continue
        if s.startswith("//##"):
            # one comment line per inlining level, innermost first
            if not chain:
                locs = set()
            locs |= {(os.path.basename(f), int(n)) for f, n in _AT.findall(s)}
            chain = True
            continue
        m = _INSN.search(ln)
        if fn is None or not m:
            continue
        chain = False
        op = m.group(1).split()
        op = op[1] if op[0].startswith("@") and len(op) > 1 else op[0]
        c = out[fn]
        c["instructions"] += 1
        c["branches"] += op == "BRA"
        c["fchk"] += op == "FCHK"
        in_second = any(f == second[0] and second[1] <= n <= second[2]
                        for f, n in locs)
        if any(f in TAIL_FILES for f, _ in locs):
            c["tail"] += 1
            c["tail_mufu"] += op.startswith("MUFU")
            c["tail_second_pass"] += in_second
        elif op.startswith("FFMA"):
            c["h_pass_ffma"] += 1
        for p, ranges in parts.items():
            if any(f == rf and a <= n <= b for f, n in locs
                   for rf, a, b in ranges):
                c["parts"][p]["instructions"] += 1
                c["parts"][p]["mufu"] += op.startswith("MUFU")
                if second[0]:
                    c["parts"][p]["second_pass"] += in_second
    return out


# the names nvdisasm numbers across a whole cubin, so that one function's
# numbers move with the functions before it: branch labels and the
# internal subroutines (__fdiv_rn's slow path)
_NUMBERED = re.compile(r"\.L_x_\d+|\$__internal_\d+_")


def sass_digests(text: str) -> dict:
    """Per function of nvdisasm output: the SHA-256 of its instructions'
    text, one line each with the whitespace collapsed (no addresses, no
    line information), each numbered label or subroutine name replaced by
    the order of its first use in the function, and the function's own
    name (the target of a return from a subroutine) by ``<self>``."""
    out, fn, names = {}, None, {}
    for ln in text.splitlines():
        m = re.match(r"^\.text\.(\S+):$", ln.strip())
        if m:
            fn, names = m.group(1), {}
            out[fn] = hashlib.sha256()
            continue
        m = _INSN.search(ln)
        if fn is not None and m:
            insn = _NUMBERED.sub(
                lambda x: f"<{names.setdefault(x.group(0), len(names))}>",
                " ".join(m.group(1).split())).replace(fn, "<self>")
            out[fn].update((insn + "\n").encode())
    return {k: h.hexdigest() for k, h in out.items()}


def library_counts(lib: Path) -> dict:
    """Instructions of each function in the built library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn and _INSN.search(ln):
            out[fn] += 1
    return out


def demangle(names: list[str]) -> dict:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, res)) if len(res) == len(names) else \
        {n: n for n in names}


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = -(-threads // 32)
    regs_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // regs_warp) // warps if regs_warp else 32
    by_smem = (228 * 1024) // (smem + 1024)
    return max(0, min(32, 64 // warps, by_regs, by_smem))


def smi() -> dict:
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
             "clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit, cmax, csm = [x.strip() for x in
                              q.stdout.splitlines()[0].split(",")]
    return {"name": name, "power_limit_w": float(limit),
            "clock_max_mhz": float(cmax), "clock_sm_mhz": float(csm)}


def _pairs(items: list[str], conv) -> dict:
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        out[k] = conv(v)
    return out


# the parts of K8's LMS route inside its LMS-step loop, which is not
# unrolled and converts kLmsLanes pixels a pass (dovi_mid.cuh: lms_lanes)
LMS_LOOP_PARTS = ("lms", "pow", "divisions")


def lms_lanes(csrc: Path) -> int | None:
    """dovi_mid.cuh's kLmsLanes under ``csrc``: the pixels a pass of K8's
    LMS-step loop converts; None where the sources have none."""
    src = csrc / "dovi_mid.cuh"
    m = src.exists() and re.search(r"^constexpr int kLmsLanes = (\d+);",
                                   src.read_text(), re.M)
    return int(m.group(1)) if m else None


def parts_per_pixel(parts: dict, grp: int, lanes: int | None = None) -> None:
    """Each part's static instructions a pixel, without the second pass
    where there is one, and its MUFU a pixel, in place: over the ``grp``
    pixels a pass converts; given ``lanes`` (K8's LMS route), the parts of
    LMS_LOOP_PARTS over the ``lanes`` pixels of their loop's pass, and the
    whole convert (``mid``) as its LMS steps so plus the rest over
    ``grp``."""
    def first(c):
        return c["instructions"] - c.get("second_pass", 0)

    for p, c in parts.items():
        n = lanes if lanes and p in LMS_LOOP_PARTS else grp
        c["per_pixel"] = first(c) / n
        c["mufu_per_pixel"] = c["mufu"] / n
    if lanes and "mid" in parts and "lms" in parts:
        mid, lms = parts["mid"], parts["lms"]
        mid["per_pixel"] = (first(mid) - first(lms)) / grp + first(lms) / lanes
        mid["mufu_per_pixel"] = (mid["mufu"] - lms["mufu"]) / grp \
            + lms["mufu"] / lanes


def part_groups(given: dict) -> dict:
    """The pixels a thread converts in one pass of the parts of the kernels
    whose name contains each key: ``given`` (--part-group) matched first,
    then PART_GROUP."""
    out = dict(given)
    for k, v in PART_GROUP.items():
        out.setdefault(k, v)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=build.CSRC)
    ap.add_argument("--launch", action="append", metavar="NAME=THREADS,SMEM",
                    help="block size and dynamic shared memory of the "
                         "kernels whose name contains NAME")
    ap.add_argument("--pixels", action="append", metavar="NAME=N",
                    help="pixels a thread makes in one pass of the kernels "
                         "whose name contains NAME")
    ap.add_argument("--part-group", action="append", metavar="NAME=N",
                    help="pixels a thread converts in one pass of the parts "
                         "of the kernels whose name contains NAME")
    args = ap.parse_args(argv)
    launch = list(_pairs(args.launch,
                         lambda v: tuple(int(x) for x in v.split(","))
                         ).items()) + default_launches()
    pixels = {**GROUP, **_pairs(args.pixels, int)}
    part_group = part_groups(_pairs(args.part_group, int))
    dev = smi()
    lib_counts = {}
    if args.csrc.resolve() == build.CSRC.resolve():
        lib_counts = library_counts(build.build())
    nvcc, nvdisasm = _tool("nvcc"), _tool("nvdisasm")
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted({p.name for g in SOURCE_GLOBS
                           for p in args.csrc.glob(g)}):
            cubin = os.path.join(tmp, src + ".cubin")
            res = subprocess.run(
                [nvcc, *[f for f in build.NVCC_FLAGS if f not in
                         ("-Xcompiler", "-fPIC")],
                 "-cubin", "-lineinfo", "-Xptxas", "-v",
                 str(args.csrc / src), "-o", cubin],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc {src}:\n{res.stderr}")
            regs = ptxas_info(res.stderr + res.stdout)
            text = subprocess.run([nvdisasm, "--print-line-info-inline",
                                   cubin], capture_output=True, text=True,
                                  check=True).stdout
            prefix = next((k for k in PARTS if src.startswith(k)), None)
            parts = {p: function_lines(args.csrc, files, fns)
                     for p, (files, fns) in PARTS.get(prefix, {}).items()}
            second = SECOND_PASS.get(prefix, second_pass_lines)(args.csrc)
            counts = sass_counts(text, second, parts)
            digests = sass_digests(text)
            names = demangle(sorted(regs))
            for fn in sorted(regs):
                nice = names[fn]
                # cu++filt spells template ints "(int)0", c++filt "0"
                bare = nice.replace("(int)", "")
                threads, smem = next((v for k, v in launch if k in bare),
                                     (128, 0))
                ppt = next((v for k, v in pixels.items() if k in nice), 1)
                r = {"source": src, "function": nice, **regs[fn],
                     **counts.get(fn, {}), "threads": threads,
                     "dynamic_smem": smem, "pixels_per_thread": ppt,
                     "sass_sha256": digests.get(fn)}
                r["blocks_per_sm"] = blocks_per_sm(r.get("registers", 0),
                                                   threads, smem)
                r["warps_per_sm"] = r["blocks_per_sm"] * (-(-threads // 32))
                if fn in lib_counts:
                    r["library_instructions"] = lib_counts[fn]
                    r["same_as_library"] = lib_counts[fn] == r.get(
                        "instructions")
                cells = next((c for k, c in PIXELS.items()
                              if src.startswith(k)), None)
                if cells and r.get("tail"):
                    # a compiled route's tail (and its parts, the pows) for
                    # ppt pixels, without its rare second pass; else one
                    # pixel at a time
                    first = r["tail"] - r["tail_second_pass"]
                    for c in r.get("parts", {}).values():
                        c["per_pixel"] = ((c["instructions"]
                                           - c.get("second_pass", 0)) / ppt
                                          if first else c["instructions"])
                if cells and dev and r.get("tail"):
                    clk = dev["clock_max_mhz"] * 1e6
                    per = first / ppt if first else r["tail"]
                    mufu = r["tail_mufu"] / (ppt if first else 1)
                    r["tail_per_pixel"] = per
                    r["tail_mufu_per_pixel"] = mufu
                    for cell, n in cells.items():
                        r[f"issue_bound_ms_{cell}"] = 1e3 * per * n / (
                            SMS * SCHEDULERS * LANES * clk)
                        r[f"mufu_bound_ms_{cell}"] = 1e3 * mufu * n / (
                            SMS * MUFU_PER_CLK * clk)
                if "parts" in r and not cells:
                    grp = next((v for k, v in part_group.items()
                                if k in bare), 1)
                    r["part_pixels_per_pass"] = grp
                    r["per_pixel"] = r["instructions"] / grp
                    for cell, n in (PART_PIXELS.get(prefix, {}).items()
                                    if dev else ()):
                        r[f"issue_bound_ms_{cell}"] = 1e3 * r[
                            "per_pixel"] * n / (SMS * SCHEDULERS * LANES
                                                * dev["clock_max_mhz"] * 1e6)
                    lanes = (lms_lanes(args.csrc) if K8_LMS_ROUTE in bare
                             else None)
                    if lanes:
                        r["lms_lanes"] = lanes
                    parts_per_pixel(r["parts"], grp, lanes)
                    for p, c in r["parts"].items():
                        for cell, n in (PART_PIXELS.get(prefix, {}).items()
                                        if dev else ()):
                            clk = dev["clock_max_mhz"] * 1e6
                            c[f"issue_bound_ms_{cell}"] = 1e3 * c[
                                "per_pixel"] * n / (SMS * SCHEDULERS * LANES
                                                    * clk)
                print(json.dumps(r), flush=True)
    print(json.dumps({"device": dev}), flush=True)


if __name__ == "__main__":
    main()
