"""The kernels of the separable resize — K1, the banded W-axis resize, K3,
the banded H-axis resize, K2, the H-axis resize with the whole per-pixel
tail, and K4, both resizes and the tail in one kernel — with their plain
PyTorch versions, the tap-table planning they share, and the surface
packer.

Replaces ``videorenderer_tpu/kernels/resize_pallas.py``:
``banded_resize_last_axis`` (K1, ``csrc/banded_resize.cu``),
``banded_resize_rows`` (K3, ``csrc/banded_resize_rows.cu``),
``rows3_tail`` (K2, ``csrc/rows3_tail.cu``; with the Dolby Vision convert
as its epilogue, :func:`rows3_tail_dovi`, ``csrc/rows3_tail_dovi.cu``) and
``mega3_tail`` (K4, ``csrc/mega3_tail.cu``).

The Pallas kernels packed each banded (in, out) matrix into 128-aligned
windows and split the products into bf16 halves, for the TPU's lane tiling
and its bf16 matrix unit.  Here every output column (K1) or row (K2) keeps
its own contiguous tap range instead: a start index and T float32 weights,
zero-padded to the matrix's widest band (:func:`plan_taps`).  The kernels
run T fp32 FMAs per output, so there is no bf16 split error at all.

K1, K2, K3 and K4 are tiled for the H100: a block stages the window of
inputs its outputs' taps reach (:meth:`BandedMatrix.row_windows`) in shared
memory with 16-byte copies, and each thread makes several outputs with
vector stores.  :func:`k1_smem_bytes`, :func:`k2_smem_bytes`,
:func:`k3_smem_bytes` and :func:`k4_smem_bytes` give a block's shared
memory.  A map whose window does not fit SMEM_BUDGET (a strong downscale: a
thumbnail of a 4K frame) takes fewer rows a block (K1, K3) or a
long-window route (K2, K3: the same kernel reading its taps through the
read-only cache; K4: the rows streamed through a ring, the H sums in
registers; each bit-equal to its staged route; :func:`k2_route`,
:func:`k3_route`, :func:`k4_route`), so no map is refused for its shared
memory.  What bounds each is in their docstrings and in
``PERF.md`` section 6.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Each launch adds one to ``launches[name]``,
and each call of a wrapper is the span ``vrt.kernel.<name>``
(:func:`kernel_span`, ``utils/trace``) from its entry to its return.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import build
from ..ops.dovi import MidStage
from ..ops.hdr10plus import guided_constants
from ..utils import trace

MID16_SCALE = 16384.0
"""W-pass intermediates may be int16 codes round(value * 16384) ("mid16"):
2^-14 steps, about 16x finer than the reference's 10-bit UNORM intermediate
textures, and half the bytes of float32.  Callers guard the range: the
column L1 norm of the matrix times 16384 must stay within int16."""

TILE_N = 128   # the JAX packing's output tile, for :func:`taps_from_band_pack`

SMEM_BUDGET = 232448
"""Shared memory a block of K1, K2 or K3 may use: the H100's 227 KB a block
(kSmemBudget in csrc/banded_resize.cu, csrc/rows3_tail.cu and
csrc/banded_resize_rows.cu).  A map whose staged window needs more is
refused before the launch."""
K1_SPAN = 256      # output columns a K1 block makes (kSpan)
K1_ROWS = 16       # rows a K1 block makes (rows_per_block)
K2_TILE_COLS = 128  # output columns a K2 block makes (kTileCols)
K2_TILE_ROWS = 32   # output rows a K2 block makes (tile_rows)
K3_TILE_COLS = 128  # output columns a K3 block makes (kTileCols)
K3_TILE_ROWS = 32   # output rows a K3 block makes where its window fits
K2_LONG_WINDOW = False
"""True forces K2's long-window route on every map (its outputs are the
staged route's bit for bit; ``chip_smoke.py`` compares the two)."""
K3_LONG_WINDOW = False
"""The same for K3."""

DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2,
               torch.float32: 3}

CORR_NONE, CORR_PQ_TO_SDR, CORR_HLG_TO_SDR, CORR_HLG_TO_PQ = 0, 1, 2, 3
CORR_FIX_BT2020 = 4
PACK_CODES = {None: 0, "rgb10a2": 1, "rgba8": 2}
# the dword of a black pixel (0, 0, 0) with opaque alpha: a placed surface's
# bars (int32, as pack_surface returns them)
PACKED_ZERO = {"rgb10a2": -1073741824, "rgba8": -16777216}

# launches of every kernel of the package, by name ("rows3_tail_dovi" is
# K2's Dolby Vision route, csrc/rows3_tail_dovi.cu; K5 and K6 are
# kernels/jinc2.py's, with K6's weight tables, K7, K8 and K9
# kernels/deint.py's, K10's two forms kernels/probe.py's)
launches = {"banded_resize_last_axis": 0, "rows3_tail": 0,
            "rows3_tail_dovi": 0, "banded_resize_rows": 0,
            "jinc2_resize_fused": 0, "jinc2_convert_fused": 0,
            "jinc2_weight_table": 0,
            "deint3_rows_dual": 0, "rows3_mid": 0, "cols3_tail": 0,
            "mega3_tail": 0, "wpass_bf16": 0, "wpass_floor": 0}


# launches by route of the kernels that count them, by kernel
# (kernels/deint's K8, "rows3_mid", K2, "rows3_tail", and kernels/jinc2's
# K6, "jinc2_convert": their routes' names)
route_launches: dict[str, dict[str, int]] = {}
K2_LONG = "long-window"
k2_route_launches = route_launches.setdefault("rows3_tail", {})
"""K2's launches by :func:`rows3_tail_route`'s name of the compiled or
runtime route each took, or ``K2_LONG``; keys appear at their first launch
and are reset with ``launches`` (:func:`reset_launches`)."""
k6_route_launches = route_launches.setdefault("jinc2_convert", {})
"""K6's launches by the weight route each took (``kernels/jinc2
.weight_route``: "table" or "per-output"), with " transposed" for a
transposed store and " band" for a band of a frame's rows; keys appear at
their first launch and are reset with ``launches``."""


redo_counters: dict[tuple[str, torch.device], torch.Tensor] = {}
"""The groups of 4 pixels that the routes under ``csrc/tail.cuh``'s
CheckedPow ran again exactly, by kernel and device: the c7 routes
(``csrc/route.cuh``'s Policy) of K2 ("rows3_tail") and K4 ("mega3_tail"),
and K8's LMS route ("rows3_mid", ``csrc/dovi_mid.cuh``).  One int64 on the
device each, to which the kernel adds (:func:`redo_counter`); read with
:func:`redo_groups`, zeroed with ``launches`` (:func:`reset_launches`)."""


def reset_launches() -> None:
    for counter in (launches, *route_launches.values()):
        for k in counter:
            counter[k] = 0
    for c in redo_counters.values():
        c.zero_()


def redo_counter(name: str, device) -> torch.Tensor:
    """The redo counter of kernel ``name`` on ``device``, made at its first
    use."""
    key = (name, torch.device(device))
    c = redo_counters.get(key)
    if c is None:
        c = redo_counters[key] = torch.zeros(1, dtype=torch.int64,
                                             device=key[1])
    return c


def redo_groups(name: str) -> int:
    """The groups kernel ``name``'s checked routes ran again exactly since
    the last reset, over every device (reads the counters: a sync of
    each)."""
    return sum(int(c.item()) for (n, _), c in redo_counters.items()
               if n == name)


def k2_redo_groups() -> int:
    """K2's (:func:`rows3_tail`'s) redone groups: :func:`redo_groups`."""
    return redo_groups("rows3_tail")


def kernel_span(name: str):
    """Decorator of a kernel wrapper: each call inside the span
    ``vrt.kernel.<name>``, ``name`` a key of :data:`launches`."""
    if name not in launches:
        raise KeyError(f"{name!r} is not a kernel of the launch counter")
    return trace.spanned("vrt.kernel." + name)


# ---------------------------------------------------------------------------
# tap tables
# ---------------------------------------------------------------------------


def plan_taps(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output tap table of an (in, out) matrix: ``starts`` (out,) int32,
    the first input index with a nonzero weight, and ``taps`` (T, out)
    float32 with ``taps[t, j] = mat[starts[j] + t, j]`` (zero past the
    matrix), T the widest nonzero band of any column.  Then
    ``out[j] = sum_t x[starts[j] + t] * taps[t, j]`` is ``x @ mat``.  A column
    without weights gets start 0 and zero taps."""
    mat = np.asarray(mat, np.float32)
    n_in, n_out = mat.shape
    nz = mat != 0
    has = nz.any(axis=0)
    lo = np.where(has, nz.argmax(axis=0), 0)
    hi = np.where(has, n_in - nz[::-1].argmax(axis=0), 1)
    n_taps = int(max(1, (hi - lo).max()))
    idx = lo[None, :] + np.arange(n_taps)[:, None]
    cols = np.arange(n_out)[None, :]
    taps = np.where(idx < n_in, mat[np.minimum(idx, n_in - 1), cols], 0.0)
    return lo.astype(np.int32), np.ascontiguousarray(taps, np.float32)


def taps_from_band_pack(starts: np.ndarray, bands: np.ndarray, kb: int,
                        w_in_pad: int, w_out: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The tap table of a matrix packed by the JAX package's
    ``resize_pallas._pack_band`` (``starts`` (J,), ``bands`` (J, kb, 128)):
    unpack the 128-wide tiles into the dense (w_in_pad, w_out) matrix and
    plan it.  Equal to :func:`plan_taps` of the original matrix, since the
    packing covers every nonzero and the padding rows are zero."""
    dense = np.zeros((w_in_pad, w_out), np.float32)
    for j, s in enumerate(np.asarray(starts, np.int64)):
        c0 = j * TILE_N
        n = min(TILE_N, w_out - c0)
        rows = min(kb, w_in_pad - int(s))
        dense[s:s + rows, c0:c0 + n] = bands[j, :rows, :n]
    return plan_taps(dense)


class BandedMatrix:
    """An (in, out) resize matrix with its normalisation folded in, in the
    two forms the main path applies: dense float32 (the plain versions) and
    the tap table of :func:`plan_taps` (the kernels).  Each form is copied
    to a device once, at its first use there."""

    def __init__(self, mat: np.ndarray, pre_scale: float | None = None):
        m = np.asarray(mat, np.float32)
        if pre_scale is not None:
            m = m * np.float32(pre_scale)
        self.dense = m
        self.in_size, self.out_size = m.shape
        self.starts, self.taps = plan_taps(m)
        self._on: dict = {}
        self._windows: dict = {}

    @property
    def n_taps(self) -> int:
        return self.taps.shape[0]

    def _get(self, key: str, arr: np.ndarray, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get((key, device))
        if t is None:
            with trace.span("vrt.build.upload"):
                t = torch.from_numpy(arr).to(device)
            self._on[(key, device)] = t
        return t

    def dense_on(self, device) -> torch.Tensor:
        return self._get("dense", self.dense, device)

    def taps_on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (self._get("starts", self.starts, device),
                self._get("taps", self.taps, device))

    def row_windows(self, tile: int, device=None
                    ) -> tuple[torch.Tensor | np.ndarray, int]:
        """The inputs (rows of the matrix: input rows of K2's and K4's H
        maps, input columns of K1's W maps) each tile of ``tile``
        consecutive outputs reaches: the first input of each tile's window
        (int32, on ``device``, or a numpy array without one) and the inputs
        of the widest window."""
        key = f"windows{tile}"
        if key not in self._windows:
            with trace.span("vrt.build.windows"):
                hi = np.minimum(self.starts + self.n_taps, self.in_size)
                lo_t, hi_t = [], []
                for j in range(0, self.out_size, tile):
                    lo_t.append(int(self.starts[j:j + tile].min()))
                    hi_t.append(int(hi[j:j + tile].max()))
                self._windows[key] = (np.asarray(lo_t, np.int32),
                                      max(h - l for l, h in zip(lo_t, hi_t)))
        lo, win = self._windows[key]
        return (lo if device is None else self._get(key, lo, device)), win


def k1_smem_bytes(itemsize: int, win: int, rows: int = K1_ROWS) -> int:
    """Shared memory of a K1 block: ``rows`` rows of the widest span of
    ``win`` input columns, from a start rounded down to 16 bytes
    (pitch_of, csrc/banded_resize.cu)."""
    chunk = 16 // itemsize
    return rows * ((win + 2 * chunk - 2) // chunk * chunk) * itemsize


def k1_rows(itemsize: int, win: int) -> int | None:
    """The rows of a K1 block: K1_ROWS, halved until the block's spans fit
    SMEM_BUDGET (a float32 4K plane to a thumbnail's width: 16 rows of a
    3840-column span need 240 KB); None where not even one row fits."""
    rows = K1_ROWS
    while rows >= 1:
        if k1_smem_bytes(itemsize, win, rows) <= SMEM_BUDGET:
            return rows
        rows //= 2
    return None


def k2_smem_bytes(y_itemsize: int, c_itemsize: int, my: BandedMatrix | None,
                  mc: BandedMatrix | None,
                  tile_rows: int = K2_TILE_ROWS) -> int:
    """Shared memory of a K2 block (Layout, csrc/rows3_tail.cu): the windows
    of y, u and v over K2_TILE_COLS columns (a plane read directly has
    none), then each map's taps and starts for ``tile_rows`` rows."""
    total = 0
    for mat, itemsize, planes in ((my, y_itemsize, 1), (mc, c_itemsize, 2)):
        if mat is not None:
            win = mat.row_windows(tile_rows)[1]
            total += planes * win * K2_TILE_COLS * itemsize
            total += 4 * tile_rows * (mat.n_taps + 1)
    return total


def k3_smem_bytes(itemsize: int, mat: BandedMatrix,
                  tile_rows: int = K3_TILE_ROWS) -> int:
    """Shared memory of a K3 block (smem_bytes, csrc/banded_resize_rows.cu):
    the window of input rows a tile of ``tile_rows`` output rows reaches
    over K3_TILE_COLS columns, then the tile's taps and starts."""
    win = mat.row_windows(tile_rows)[1]
    return win * K3_TILE_COLS * itemsize + 4 * tile_rows * (mat.n_taps + 1)


def k3_tile_rows(itemsize: int, mat: BandedMatrix) -> int | None:
    """The output rows of a K3 tile: K3_TILE_ROWS, halved until the block's
    shared memory fits SMEM_BUDGET; None where not even one row fits."""
    rows = K3_TILE_ROWS
    while rows >= 1:
        if k3_smem_bytes(itemsize, mat, rows) <= SMEM_BUDGET:
            return rows
        rows //= 2
    return None


def k3_route(itemsize: int, mat: BandedMatrix) -> tuple[str, int]:
    """K3's route and tile rows for a map: ("staged", :func:`k3_tile_rows`)
    where the window fits at some tile, else ("long-window",
    K3_TILE_ROWS), the kernel that stages nothing (also with
    K3_LONG_WINDOW)."""
    rows = None if K3_LONG_WINDOW else k3_tile_rows(itemsize, mat)
    return ("long-window", K3_TILE_ROWS) if rows is None else ("staged", rows)


def k2_route(y_itemsize: int, c_itemsize: int, my: BandedMatrix | None,
             mc: BandedMatrix | None) -> str:
    """K2's route for these maps: "staged" where the windows of a
    K2_TILE_ROWS tile fit SMEM_BUDGET (:func:`k2_smem_bytes`), else
    "long-window", the kernel that reads its taps through the read-only
    cache (also with K2_LONG_WINDOW).  Both give the same bits."""
    if K2_LONG_WINDOW or k2_smem_bytes(y_itemsize, c_itemsize, my,
                                       mc) > SMEM_BUDGET:
        return "long-window"
    return "staged"


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------


def _no_tf32() -> None:
    # the plain versions' products must keep float32 rounding on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_plane(name: str, p: torch.Tensor) -> None:
    if p.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {p.dtype} not one of "
                        f"{list(DTYPE_CODES)}")
    if p.dim() < 2:
        raise ValueError(f"{name}: need (..., H, W), got {tuple(p.shape)}")


def _kernel_device(*ps: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); anything else raises."""
    dev = ps[0].device
    for p in ps:
        if p.device != dev:
            raise ValueError(f"planes on different devices: {p.device} "
                             f"and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for p in ps:
        if not p.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.vrt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
    launches[name] += 1


# ---------------------------------------------------------------------------
# K1: banded resize along the last axis
# ---------------------------------------------------------------------------


def _quant_mid16(x: torch.Tensor) -> torch.Tensor:
    # round half to even, as jnp.round and the kernel's __float2int_rn
    return torch.round(x * MID16_SCALE).to(torch.int32).to(torch.int16)


def banded_resize_last_axis_plain(x: torch.Tensor, mat: BandedMatrix,
                                  mid16: bool = False) -> torch.Tensor:
    """Plain K1: one dense float32 product, then the optional mid16 codes."""
    _no_tf32()
    out = x.to(torch.float32) @ mat.dense_on(x.device)
    return _quant_mid16(out) if mid16 else out


@kernel_span("banded_resize_last_axis")
def banded_resize_last_axis(x: torch.Tensor, mat: BandedMatrix,
                            mid16: bool = False) -> torch.Tensor:
    """Resize ``x`` (..., W_in) — raw uint8/uint16 planes, int16 or float32
    — along its last axis by ``mat`` (whose normalisation is folded in).
    Returns float32 (..., W_out), or with ``mid16`` int16 codes
    round(value * MID16_SCALE).

    Kernel K1 (``csrc/banded_resize.cu``), replacing
    ``resize_pallas.banded_resize_last_axis``.  Bound by device memory (6
    FMAs per ~4 bytes at the headline shapes).  A block stages K1_ROWS rows
    of the input span its K1_SPAN output columns reach in shared memory
    (16-byte copies); each thread keeps its 2 columns' starts and taps in
    registers for all those rows and stores its 2 outputs at once; a span
    too wide for K1_ROWS rows takes fewer (:func:`k1_rows`), so only a span
    of one row over SMEM_BUDGET (~58000 float32 columns) raises ValueError.
    Measured on one
    NVIDIA H100 80GB HBM3 at 700 W: 50% of the byte bound on the headline's
    three planes (``PERF.md`` section 6)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not one of {list(DTYPE_CODES)}")
    if x.shape[-1] != mat.in_size:
        raise ValueError(f"x has {x.shape[-1]} columns, the matrix "
                         f"takes {mat.in_size}")
    if not _kernel_device(x):
        return banded_resize_last_axis_plain(x, mat, mid16)
    rows = x.numel() // mat.in_size
    if rows == 0 or -(-rows // K1_ROWS) >= 2 ** 31 \
            or mat.out_size > K1_SPAN * 65535:
        raise ValueError(f"K1 cannot take {rows} rows x {mat.out_size} "
                         "output columns")
    lo, win = mat.row_windows(K1_SPAN, x.device)
    block_rows = k1_rows(x.element_size(), win)
    if block_rows is None:
        raise ValueError(f"K1: a span of {win} input columns needs "
                         f"{k1_smem_bytes(x.element_size(), win, 1)} bytes "
                         f"of shared memory, over {SMEM_BUDGET}")
    out = torch.empty(x.shape[:-1] + (mat.out_size,),
                      dtype=torch.int16 if mid16 else torch.float32,
                      device=x.device)
    starts, taps = mat.taps_on(x.device)
    _launch("banded_resize_last_axis", "vrt_banded_resize", x.device,
            x.data_ptr(), DTYPE_CODES[x.dtype], starts.data_ptr(),
            taps.data_ptr(), lo.data_ptr(), win, out.data_ptr(), int(mid16),
            rows, mat.in_size, mat.out_size, mat.n_taps, block_rows)
    return out


# ---------------------------------------------------------------------------
# K3: banded resize along the H axis
# ---------------------------------------------------------------------------


def banded_resize_rows_plain(x: torch.Tensor, mat: BandedMatrix
                             ) -> torch.Tensor:
    """Plain K3: one dense float32 product from the left."""
    _no_tf32()
    return _h_plain(x, mat, None)


@kernel_span("banded_resize_rows")
def banded_resize_rows(x: torch.Tensor, mat: BandedMatrix) -> torch.Tensor:
    """Resize ``x`` (..., H_in, W) — raw uint8/uint16 planes, int16 or
    float32 — along its second-to-last axis by ``mat`` (whose normalisation
    is folded in).  Returns float32 (..., H_out, W).

    Kernel K3 (``csrc/banded_resize_rows.cu``), replacing
    ``resize_pallas.banded_resize_rows`` and its packed form.  Bound by
    device memory.  K2's H pass for one plane: a block makes
    :func:`k3_tile_rows` output rows x K3_TILE_COLS columns, stages the
    window of input rows its taps reach and the tile's starts and taps in
    shared memory (16-byte copies), and each thread sums the taps of 4
    consecutive columns and stores them with one vector store.  A map whose
    window does not fit SMEM_BUDGET even at one row a tile (over ~450
    float32 taps an output) takes the long-window route
    (:func:`k3_route`): the same sums with every tap read through the
    read-only cache, bit-equal."""
    _check_plane("x", x)
    if x.shape[-2] != mat.in_size:
        raise ValueError(f"x has {x.shape[-2]} rows, the matrix takes "
                         f"{mat.in_size}")
    if not _kernel_device(x):
        return banded_resize_rows_plain(x, mat)
    h_in, w = x.shape[-2:]
    batch = x.numel() // (h_in * w) if x.numel() else 0
    if batch == 0 or batch * mat.out_size >= 2 ** 31 \
            or w >= K3_TILE_COLS * 65535:
        raise ValueError(f"K3 cannot take batch {batch} x {mat.out_size} "
                         f"rows x {w} columns")
    route, tile_rows = k3_route(x.element_size(), mat)
    long_window = route == "long-window"
    lo, win = mat.row_windows(tile_rows, x.device)
    out = torch.empty(x.shape[:-2] + (mat.out_size, w), dtype=torch.float32,
                      device=x.device)
    starts, taps = mat.taps_on(x.device)
    _launch("banded_resize_rows", "vrt_banded_resize_rows", x.device,
            x.data_ptr(), DTYPE_CODES[x.dtype], starts.data_ptr(),
            taps.data_ptr(), lo.data_ptr(), win, out.data_ptr(), batch, h_in,
            mat.out_size, w, mat.n_taps, tile_rows, int(long_window))
    return out


# ---------------------------------------------------------------------------
# K2: H resize of three planes + colour matrix + corrections + dither + pack
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Epilogue:
    """What K2 (and K9, K4) runs on each output pixel after the resize: the
    parameters of the kernel's specialisation, and ``plain``, the same
    computation in torch for the plain version ((..., H, W) x 3 ->
    (..., 3, H, W)).

    ``cmat``: (3, 4) float32 rows (m0 m1 m2 c), or None when the planes are
    R, G, B already.  ``correction``: CORR_NONE, CORR_PQ_TO_SDR,
    CORR_HLG_TO_SDR, CORR_HLG_TO_PQ or CORR_FIX_BT2020, the SDR conversions
    using ``luminance_scale`` and the (3, 3) BT.2020 -> BT.709 ``gamut``
    matrix, the SDR BT.2020 fix ``sdr_gamma``, the source's power gamma,
    which rides the launch by value.  ``tonemap``: the local tone map's
    selection (1-7, ``ops/tonemap``; 0 none) and ``tonemap_scalars`` its
    five float32 scalars, likewise; selection 7 runs the HDR10+ guided
    curve of ``window`` (an ``ops.hdr10plus.HDR10PlusWindow``).
    ``trims``: the five float32 Dolby Vision L2 trim scalars
    (``ops.tonemap.trim_values``), or None for no trims; with ``trims_pq``
    they run on the PQ signal before PQ -> SDR (the correction), else in
    nits before the local tone map.  An epilogue with trims or selection 7
    takes the tail kernels' extended runtime route (``csrc/route.cuh``'s
    ``RuntimeExtended``).  ``dither_bits``: +b ordered
    dither to b bits, -b round to b bits, 0 none (float output); b is 8 or
    10."""

    cmat: np.ndarray | None
    correction: int
    luminance_scale: float
    dither_bits: int
    gamut: np.ndarray
    plain: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    tonemap: int = 0
    tonemap_scalars: np.ndarray = field(
        default_factory=lambda: np.zeros(5, np.float32))
    sdr_gamma: float = 2.2
    trims: np.ndarray | None = None
    trims_pq: bool = False
    window: object | None = None

    def validate(self) -> None:
        if self.correction not in (CORR_NONE, CORR_PQ_TO_SDR, CORR_HLG_TO_SDR,
                                   CORR_HLG_TO_PQ, CORR_FIX_BT2020):
            raise NotImplementedError(
                f"K2 epilogue: correction {self.correction} is not ported")
        if self.tonemap not in range(8):
            raise ValueError(
                f"K2 epilogue: tone map selection {self.tonemap} is not one "
                "of 0-7")
        if (self.tonemap == 7) != (self.window is not None):
            raise ValueError("K2 epilogue: selection 7 and an HDR10+ window "
                             "come together")
        if self.trims is not None and np.shape(self.trims) != (5,):
            raise ValueError("trims must hold 5 values, got "
                             f"{np.shape(self.trims)}")
        if self.trims is not None and not self.trims_pq and not self.tonemap:
            raise ValueError("linear-domain trims run before a local tone "
                             "map, and this epilogue has none")
        if self.trims is not None and self.trims_pq \
                and self.correction != CORR_PQ_TO_SDR:
            raise ValueError("PQ-domain trims run before PQ -> SDR, and this "
                             "epilogue's correction is another")
        if np.shape(self.tonemap_scalars) != (5,):
            raise ValueError("tonemap_scalars must hold 5 values, got "
                             f"{np.shape(self.tonemap_scalars)}")
        if self.dither_bits not in (0, 8, 10, -8, -10):
            raise NotImplementedError(
                f"K2 epilogue: dither_bits {self.dither_bits} is not ported")
        if self.cmat is not None and np.shape(self.cmat) != (3, 4):
            raise ValueError(f"cmat must be (3, 4), got {np.shape(self.cmat)}")

    def host_mats(self) -> np.ndarray:
        """The 59 floats the tail kernels take in host memory: the
        colour matrix (zeros without one), the gamut matrix, the tone-map
        scalars, the SDR BT.2020 fix's gamma (27 floats); then the trims'
        five scalars, their mode (0 none, 1 PQ domain, 2 linear) and the
        guided curve's constants (``ops.hdr10plus.guided_constants``)."""
        cm = (np.zeros((3, 4), np.float32) if self.cmat is None
              else np.asarray(self.cmat, np.float32))
        trims = (np.zeros(5, np.float32) if self.trims is None
                 else np.asarray(self.trims, np.float32).reshape(-1))
        mode = 0 if self.trims is None else 1 if self.trims_pq else 2
        return np.ascontiguousarray(np.concatenate(
            [cm.reshape(-1), np.asarray(self.gamut, np.float32).reshape(-1),
             np.asarray(self.tonemap_scalars, np.float32).reshape(-1),
             np.asarray([self.sdr_gamma], np.float32), trims,
             np.asarray([mode], np.float32),
             guided_constants(self.window)]))

    def launch_args(self, mats: np.ndarray) -> tuple:
        """(mats pointer, apply_matrix, correction, tonemap,
        luminance_scale), the tail's arguments of every kernel entry point
        that ends in it; ``mats`` is :meth:`host_mats`, kept alive by the
        caller for the call."""
        return (mats.ctypes.data, int(self.cmat is not None), self.correction,
                self.tonemap, float(self.luminance_scale))


def pack_surface(rgb: torch.Tensor, fmt: str) -> torch.Tensor:
    """Pack (..., 3, H, W) float [0,1] into (..., H, W) int32 surface dwords,
    R10G10B10A2 or RGBA8 (the swap-chain backbuffer formats,
    Source/DX11VideoProcessor.cpp:1490-1530): ``(clip(x)*1023 + 0.5)``
    truncated per channel, alpha opaque.  Same math as the JAX package's
    ``pack_surface_tiles`` and ``pipeline._pack_surface_xla``."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    if fmt == "rgb10a2":
        scale, shift, alpha = 1023.0, 10, -1073741824   # A2 = 3: 0xC0000000
    elif fmt == "rgba8":
        scale, shift, alpha = 255.0, 8, -16777216       # A8 = 255: 0xFF000000
    else:
        raise ValueError(f"unknown surface format {fmt!r}")

    def q(x):
        return (torch.clamp(x, 0.0, 1.0) * scale + 0.5).to(torch.int32)

    return q(r) | (q(g) << shift) | (q(b) << (2 * shift)) | alpha


def check_place(place: tuple | None, h: int, w: int) -> tuple:
    """(surface_h, surface_w, off_y, off_x) of an output of h x w pixels:
    ``place`` checked to hold it, or the output's own surface."""
    if place is None:
        return h, w, 0, 0
    sh, sw, oy, ox = (int(x) for x in place)
    if oy < 0 or ox < 0 or oy + h > sh or ox + w > sw:
        raise ValueError(f"a {h} x {w} video at ({oy}, {ox}) does not fit "
                         f"a {sh} x {sw} surface")
    return sh, sw, oy, ox


def fill_bars(out: torch.Tensor, place: tuple, h: int, w: int,
              pack_format: str | None) -> torch.Tensor:
    """Write the bars of ``out`` (..., surface_h, surface_w) dwords, or
    (..., 3, surface_h, surface_w) float, around the h x w video at
    ``place``: the packed zero (black, opaque), or zeros for float; the
    rect is left as it is."""
    sh, sw, oy, ox = place
    fill = 0.0 if pack_format is None else PACKED_ZERO[pack_format]
    out[..., :oy, :] = fill
    out[..., oy + h:, :] = fill
    out[..., oy:oy + h, :ox] = fill
    out[..., oy:oy + h, ox + w:] = fill
    return out


def place_output(video: torch.Tensor, place: tuple | None,
                 pack_format: str | None) -> torch.Tensor:
    """An unplaced output (..., h, w) dwords or (..., 3, h, w) float put
    into its surface at ``place`` with the bars of :func:`fill_bars`: the
    plain versions' placement (the JAX package's ``_final_pass`` places
    before the pack, and a packed black pixel is the packed zero)."""
    h, w = video.shape[-2:]
    sh, sw, oy, ox = check_place(place, h, w)
    if place is None:
        return video
    out = video.new_empty(video.shape[:-2] + (sh, sw))
    fill_bars(out, (sh, sw, oy, ox), h, w, pack_format)
    out[..., oy:oy + h, ox:ox + w] = video
    return out


def _taps_args(mat: BandedMatrix | None, device) -> tuple:
    """(starts, taps, T) of a map for a kernel call; NULL and T = 0: no
    map."""
    if mat is None:
        return None, None, 0
    s, t = mat.taps_on(device)
    return s.data_ptr(), t.data_ptr(), mat.n_taps


def _h_plain(p: torch.Tensor, mat: BandedMatrix | None,
             scale: float | None) -> torch.Tensor:
    pf = p.to(torch.float32)
    if mat is None:
        return pf if scale is None else pf * float(np.float32(scale))
    return mat.dense_on(p.device).T @ pf


def _check_rows3(y, u, v, my: BandedMatrix | None, mc: BandedMatrix | None,
                 h_out: int, y_scale: float | None, c_scale: float | None
                 ) -> None:
    """K2's checks of its planes and H maps (every route)."""
    for name, p in (("y", y), ("u", u), ("v", v)):
        _check_plane(name, p)
    if u.shape != v.shape or u.dtype != v.dtype:
        raise ValueError("u and v must share shape and dtype")
    lead, (hy, w) = y.shape[:-2], y.shape[-2:]
    hc = u.shape[-2]
    if u.shape[:-2] != lead or u.shape[-1] != w:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch or width")
    for name, mat, h_in, scale in (("y", my, hy, y_scale),
                                   ("c", mc, hc, c_scale)):
        if mat is None and h_in != h_out:
            raise ValueError(f"{name}: no H matrix, so its height {h_in} "
                             f"must be h_out {h_out}")
        if mat is not None and (mat.in_size, mat.out_size) != (h_in, h_out):
            raise ValueError(f"{name}: H matrix {mat.in_size}->"
                             f"{mat.out_size} for {h_in}->{h_out}")
        if mat is not None and scale is not None:
            raise ValueError(f"{name}: a scale goes into the H matrix, not "
                             "beside it")


def _k2_batch(y: torch.Tensor, h_out: int) -> int:
    """The frames of a K2 launch (its grid's z); ValueError past the grid's
    limits."""
    hy, w = y.shape[-2:]
    batch = y.numel() // (hy * w) if y.numel() else 0
    if batch == 0 or batch > 65535 or -(-h_out // K2_TILE_ROWS) > 65535:
        raise ValueError(f"K2 cannot take batch {batch} x {h_out} rows")
    return batch


def rows3_tail_plain(y, u, v, my: BandedMatrix | None,
                     mc: BandedMatrix | None, h_out: int, epilogue: Epilogue,
                     y_scale: float | None = None, c_scale: float | None = None,
                     pack_format: str | None = None,
                     place: tuple | None = None) -> torch.Tensor:
    """Plain K2: each plane's H contraction as a dense float32 product (or
    the direct read times its scale), the torch epilogue, the pack, then
    the placement (:func:`place_output`)."""
    _no_tf32()
    rgb = epilogue.plain(_h_plain(y, my, y_scale), _h_plain(u, mc, c_scale),
                         _h_plain(v, mc, c_scale))
    out = rgb if pack_format is None else pack_surface(rgb, pack_format)
    return place_output(out, place, pack_format)


@kernel_span("rows3_tail")
def rows3_tail(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               my: BandedMatrix | None, mc: BandedMatrix | None, h_out: int,
               epilogue: Epilogue, y_scale: float | None = None,
               c_scale: float | None = None,
               pack_format: str | None = None,
               place: tuple | None = None) -> torch.Tensor:
    """H-resize the (luma, chroma, chroma) planes, then run the epilogue.

    ``y`` (..., Hy, W), ``u``/``v`` (..., Hc, W): mid16 int16, float32 or raw
    uint8/uint16.  ``my`` (Hy, h_out) / ``mc`` (Hc, h_out): the H matrices
    with their scale folded in, or None for a plane read directly — its
    height is then h_out and ``y_scale``/``c_scale`` scale it.  Returns
    (..., 3, h_out, W) float32, or with ``pack_format`` ("rgb10a2"/"rgba8")
    (..., h_out, W) int32 dwords.  ``place`` (surface_h, surface_w, off_y,
    off_x): the output is a surface of that size with the video's row r,
    column c at (off_y + r, off_x + c) and the bars black (the packed zero
    of :data:`PACKED_ZERO`, or zeros for float); the dither keeps the
    video's rows and columns, as the reference dithers before it places.

    Kernel K2 (``csrc/rows3_tail.cu``), replacing
    ``resize_pallas.rows3_tail``.  A block makes K2_TILE_ROWS output rows x
    K2_TILE_COLS columns: it stages the window of input rows its tile's
    taps reach in shared memory (16-byte copies), then each thread runs the
    H taps of 4 consecutive columns, the colour matrix, the corrections,
    the local tone map, the dither from the global row and column and one
    vector store, so no intermediate RGB reaches device memory.  The tail's
    route is compiled in for the paths' epilogues (:func:`rows3_tail_route`
    names it; each launch adds one to :data:`k2_route_launches` under that
    name, or under ``K2_LONG``).  A placed output goes straight into its
    surface, 16-byte stores where the column offset is a multiple of 4,
    scalar stores otherwise; torch writes only the bars.  A map whose
    window does not fit SMEM_BUDGET takes the long-window route
    (:func:`k2_route`): the same sums, tail and store with every tap read
    through the read-only cache, bit-equal, on the runtime tail.  Measured
    on one NVIDIA H100 80GB HBM3 at 700 W, the H taps
    and the store reach 61% (headline) and 79% (c7) of their byte bound;
    the tail, 65% and 86% of K2's time, is bound by its instruction issue
    (96% of that bound at the headline; ``PERF.md`` section 6).  The c7
    routes take their pows without libdevice's arms for non-normal values,
    under the group's one range flag (``csrc/route.cuh``'s CheckedPow), and
    add the groups they run again exactly to :func:`redo_counter`'s."""
    epilogue.validate()
    if pack_format not in PACK_CODES:
        raise NotImplementedError(f"K2: pack format {pack_format!r}")
    _check_rows3(y, u, v, my, mc, h_out, y_scale, c_scale)
    lead, (hy, w) = y.shape[:-2], y.shape[-2:]
    hc = u.shape[-2]
    surface = check_place(place, h_out, w)
    if not _kernel_device(y, u, v):
        return rows3_tail_plain(y, u, v, my, mc, h_out, epilogue, y_scale,
                                c_scale, pack_format, place)
    batch = _k2_batch(y, h_out)
    long_window = k2_route(y.element_size(), u.element_size(), my,
                           mc) == "long-window"
    sh, sw = surface[:2]
    if pack_format is None:
        out = torch.empty(lead + (3, sh, sw), dtype=torch.float32,
                          device=y.device)
    else:
        out = torch.empty(lead + (sh, sw), dtype=torch.int32,
                          device=y.device)
    if place is not None:
        fill_bars(out, surface, h_out, w, pack_format)
    mats = epilogue.host_mats()

    def h_args(mat):    # (starts, taps, T, tile_lo, win); none: read directly
        if mat is None:
            return None, None, 0, None, 0
        lo, win = mat.row_windows(K2_TILE_ROWS, y.device)
        return (*_taps_args(mat, y.device), lo.data_ptr(), win)

    _launch("rows3_tail", "vrt_rows3_tail", y.device,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, hy, hc, w, h_out, K2_TILE_ROWS,
            *h_args(my), *h_args(mc),
            1.0 if y_scale is None else float(y_scale),
            1.0 if c_scale is None else float(c_scale),
            *epilogue.launch_args(mats), epilogue.dither_bits,
            PACK_CODES[pack_format], *surface, int(long_window),
            redo_counter("rows3_tail", y.device).data_ptr(), out.data_ptr())
    route = K2_LONG if long_window else _route_name(
        route_flags(y.dtype, u.dtype, epilogue, pack_format), False)
    k2_route_launches[route] = k2_route_launches.get(route, 0) + 1
    return out


def route_flags(y_dtype: torch.dtype, c_dtype: torch.dtype,
                epilogue: Epilogue, pack_format: str | None) -> tuple:
    """The flags by which the tail kernels (K2, K9) pick a compiled route:
    (y dtype code, c dtype code, matrix, correction, tone map, trims,
    dither bits, pack code).  No compiled route has trims or selection 7,
    so such an epilogue takes the runtime route."""
    return (DTYPE_CODES[y_dtype], DTYPE_CODES[c_dtype],
            int(epilogue.cmat is not None), epilogue.correction,
            epilogue.tonemap, int(epilogue.trims is not None),
            epilogue.dither_bits, PACK_CODES[pack_format])


def rows3_tail_route(y_dtype: torch.dtype, c_dtype: torch.dtype,
                     epilogue: Epilogue, pack_format: str | None,
                     long_window: bool = False) -> str:
    """The K2 instantiation a launch with these plane dtypes, epilogue and
    pack takes: the name of its compiled route, "runtime" for the staged
    one that reads the tail's flags (every epilogue with trims or the
    guided curve), or with ``long_window`` (the route :func:`k2_route`
    picks for a map whose windows do not fit) "long-window runtime"
    (vrt_rows3_tail_route over :func:`route_flags`; loads the kernel
    library, so it needs the CUDA toolkit)."""
    return _route_name(route_flags(y_dtype, c_dtype, epilogue, pack_format),
                       long_window)


_ROUTE_NAMES: dict[tuple, str] = {}


def _route_name(flags: tuple, long_window: bool) -> str:
    """vrt_rows3_tail_route's name for ``flags``, asked of the library once
    a key."""
    key = (*flags, bool(long_window))
    name = _ROUTE_NAMES.get(key)
    if name is None:
        name = _ROUTE_NAMES[key] = build.load().vrt_rows3_tail_route(
            *flags, int(long_window)).decode()
    return name


# ---------------------------------------------------------------------------
# K2's Dolby Vision route: H resize of three planes + the DoVi convert
# ---------------------------------------------------------------------------

DOVI_CURVES_BYTES = 320   # the curve structure K8 and this route copy
                          # (3 Curve structs, csrc/dovi_mid.cuh)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def k2_dovi_smem_bytes(y_itemsize: int, c_itemsize: int,
                       my: BandedMatrix | None, mc: BandedMatrix | None,
                       n_vals: int) -> int:
    """Shared memory of a block of K2's Dolby Vision route (DoviLayout,
    csrc/rows3_tail_dovi.cuh): K2's windows, taps and starts
    (:func:`k2_smem_bytes`), then the ``n_vals`` curve scalars and the
    curve structure, each rounded up to 16 bytes.  The route has no
    long-window form (stage A's maps, the chroma upsample and the blend
    map, reach a few rows an output row): a launch over SMEM_BUDGET is
    refused."""
    return (_up16(k2_smem_bytes(y_itemsize, c_itemsize, my, mc))
            + _up16(4 * n_vals) + DOVI_CURVES_BYTES)


def rows3_tail_dovi_plain(y, u, v, my: BandedMatrix | None,
                          mc: BandedMatrix | None, h_out: int,
                          mid: MidStage, y_scale: float | None = None,
                          c_scale: float | None = None) -> torch.Tensor:
    """Plain K2 Dolby Vision route: each plane's H contraction as a dense
    float32 product (or the direct read times its scale), then
    :meth:`MidStage.plain`; (..., 3, h_out, W) with each channel
    contiguous, as the kernel returns it."""
    _no_tf32()
    rgb = mid.plain(_h_plain(y, my, y_scale), _h_plain(u, mc, c_scale),
                    _h_plain(v, mc, c_scale))
    return torch.stack(rgb).movedim(0, -3)


@kernel_span("rows3_tail_dovi")
def rows3_tail_dovi(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    my: BandedMatrix | None, mc: BandedMatrix | None,
                    h_out: int, mid: MidStage, y_scale: float | None = None,
                    c_scale: float | None = None) -> torch.Tensor:
    """H-resize the (luma, chroma, chroma) planes and run the Dolby Vision
    convert ``mid`` (reshape, RPU matrix, LMS step) on each output pixel:
    stage A of the two-stage Dolby Vision form.

    The planes and maps as :func:`rows3_tail` takes them.  Returns the PQ
    R, G, B as (..., 3, h_out, W) float32 whose channels ``out[..., i, :,
    :]`` are each contiguous (the three planes of one (3, ..., h_out, W)
    buffer), so that stage B's K1 reads each without a copy.  The values
    in ``mid`` (the matrix and a scene's curves) ride the launch by value:
    a new scene rebuilds nothing.

    Kernel K2's Dolby Vision route (``csrc/rows3_tail_dovi.cu``),
    replacing ``resize_pallas.rows3_tail`` with the DoVi epilogues
    ``_epi_a`` and ``_epi_a_rt``.  K2's tiles (staged windows, 4 columns a
    thread), then the convert of ``csrc/dovi_mid.cuh``, which K8 runs too,
    on the route K8 would take for these dtypes and ``mid``
    (:func:`~.deint.rows3_mid_route` names it).  It has no long-window
    route: a map whose windows do not fit SMEM_BUDGET raises ValueError
    (:func:`k2_dovi_smem_bytes`), as does a grid past its limits."""
    _check_rows3(y, u, v, my, mc, h_out, y_scale, c_scale)
    if not _kernel_device(y, u, v):
        return rows3_tail_dovi_plain(y, u, v, my, mc, h_out, mid, y_scale,
                                     c_scale)
    batch = _k2_batch(y, h_out)
    lead, (hy, w) = y.shape[:-2], y.shape[-2:]
    vals, struct = mid.host_values(), mid.host_structure()
    need = k2_dovi_smem_bytes(y.element_size(), u.element_size(), my, mc,
                              vals.size)
    if need > SMEM_BUDGET:
        raise ValueError(f"K2's Dolby Vision route: the H maps' windows "
                         f"need {need} bytes of shared memory, over "
                         f"{SMEM_BUDGET}; it has no long-window route")
    dev = y.device

    def h_args(mat):    # (starts, taps, T, tile_lo, win); none: read directly
        if mat is None:
            return None, None, 0, None, 0
        lo, win = mat.row_windows(K2_TILE_ROWS, dev)
        return (*_taps_args(mat, dev), lo.data_ptr(), win)

    out = torch.empty((3,) + lead + (h_out, w), dtype=torch.float32,
                      device=dev)
    _launch("rows3_tail_dovi", "vrt_rows3_tail_dovi", dev,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, hy, u.shape[-2], w, h_out,
            K2_TILE_ROWS, *h_args(my), *h_args(mc),
            1.0 if y_scale is None else float(y_scale),
            1.0 if c_scale is None else float(c_scale),
            vals.ctypes.data, vals.size, struct.ctypes.data,
            int(mid.lms is None), out.data_ptr())
    return out.movedim(0, -3)


# ---------------------------------------------------------------------------
# K4: W map + H map of three planes + the tail, in one kernel
# ---------------------------------------------------------------------------

K4_TILE_COLS = 128     # output columns of a K4 block (kTileCols,
                       # csrc/mega3_tail.cuh)
K4_TILE_ROWS = 64      # the most output rows of a staged K4 tile
K4_MIN_TILE_ROWS = 8   # the fewest: one a row of threads (kRowThreads)
K4_LONG_TILE_ROWS = 16  # output rows of a long-window tile (kLongTileRows)
K4_CHUNK_ROWS = 16     # raw input rows a chunk of K4's long-window ring,
                       # at most
K4_RING_SLOTS = 3      # chunks of that ring (kRingSlots)
K4_BLOCKS_PER_SM = 3   # staged blocks an SM holds at the kernel's launch
                       # bounds (registers), where shared memory allows
K4_LONG_WINDOW = False
"""True forces K4's long-window route on every map (its outputs are the
staged route's bit for bit; ``chip_smoke.py`` compares the two)."""


def _k4_pitch_bytes(itemsize: int, mx: BandedMatrix | None) -> int:
    """Bytes a staged row of one plane takes in a K4 block (pitch_of,
    mega3_tail.cuh): the W map's widest span over K4_TILE_COLS outputs from
    a start rounded down to 16 bytes, or the strip's own columns."""
    if mx is None:
        return K4_TILE_COLS * itemsize
    chunk = 16 // itemsize
    span = mx.row_windows(K4_TILE_COLS)[1]
    return (span + 2 * chunk - 2) // chunk * chunk * itemsize


def k4_smem_bytes(y_itemsize: int, c_itemsize: int,
                  mx_y: BandedMatrix | None, mx_c: BandedMatrix | None,
                  my_y: BandedMatrix | None, my_c: BandedMatrix | None,
                  tile_rows: int, chunk_rows: int = 0,
                  long_window: bool = False) -> int:
    """Shared memory of a K4 block (Layout, csrc/mega3_tail.cuh).  Staged:
    each plane's raw window (the H map's widest window at ``tile_rows``, or
    ``tile_rows`` rows without one, x its pitch), its W-passed window (the
    same rows x K4_TILE_COLS floats) and each H map's taps and starts.
    Long-window: the ring of K4_RING_SLOTS chunks of ``chunk_rows`` raw
    rows as wide as the widest staged plane's, then one chunk of W-passed
    rows.  A plane with neither map is read directly and takes none."""
    planes = [(mx, my, size, n) for mx, my, size, n in
              ((mx_y, my_y, y_itemsize, 1), (mx_c, my_c, c_itemsize, 2))
              if mx is not None or my is not None]
    frow = 4 * K4_TILE_COLS
    if long_window:
        row = max([_k4_pitch_bytes(size, mx) for mx, _, size, _ in planes],
                  default=0)
        return (K4_RING_SLOTS * row + frow) * chunk_rows
    total = 0
    for mx, my, size, n in planes:
        rows = tile_rows if my is None else my.row_windows(tile_rows)[1]
        total += n * rows * (_k4_pitch_bytes(size, mx) + frow)
    for my in (my_y, my_c):
        if my is not None:
            total += 4 * tile_rows * (my.n_taps + 1)
    return total


def k4_route(y_itemsize: int, c_itemsize: int, mx_y: BandedMatrix | None,
             mx_c: BandedMatrix | None, my_y: BandedMatrix | None,
             my_c: BandedMatrix | None) -> tuple[str, int, int | None]:
    """K4's route, tile rows and ring chunk rows for these maps: "staged"
    (chunk rows 0: each plane's whole window at once) at the most tile rows
    (K4_TILE_ROWS down to K4_MIN_TILE_ROWS in steps of 8) whose layout
    (:func:`k4_smem_bytes`) lets K4_BLOCKS_PER_SM blocks share an SM, else
    fits SMEM_BUDGET; else "long-window" at K4_LONG_TILE_ROWS, the kernel
    that streams the rows through a ring and keeps no window (also with
    K4_LONG_WINDOW), with the most chunk rows (K4_CHUNK_ROWS halved) that
    let two blocks share an SM, else that fit.  Both routes give the same
    bits.  Chunk rows None: not even the long-window route's three raw rows
    fit (a span of ~19000 float32 columns)."""
    sizes, maps = (y_itemsize, c_itemsize), (mx_y, mx_c, my_y, my_c)
    tiles = range(K4_TILE_ROWS, K4_MIN_TILE_ROWS - 1, -8)
    for budget in ((SMEM_BUDGET // K4_BLOCKS_PER_SM - 1024, SMEM_BUDGET)
                   if not K4_LONG_WINDOW else ()):
        for rows in tiles:
            if k4_smem_bytes(*sizes, *maps, rows) <= budget:
                return "staged", rows, 0
    chunks = [K4_CHUNK_ROWS >> i for i in range(K4_CHUNK_ROWS.bit_length())]
    for budget in (SMEM_BUDGET // 2 - 1024, SMEM_BUDGET):
        for cr in chunks:
            if k4_smem_bytes(*sizes, *maps, K4_LONG_TILE_ROWS, cr,
                             long_window=True) <= budget:
                return "long-window", K4_LONG_TILE_ROWS, cr
    return "long-window", K4_LONG_TILE_ROWS, None


def mega_maps(mx: np.ndarray | None, my: np.ndarray | None,
              norm: float | None) -> tuple:
    """One plane's (W map, H map) as :class:`BandedMatrix` objects, the
    normalisation placed as the JAX ``_MegaPlane`` places it: in the W map,
    else in the H map.  :func:`mega3_tail` takes them, and so do K1 then K3
    on the placed route.  A plane with neither map is scaled by ``norm``
    where it is read."""
    kw = None if mx is None else BandedMatrix(mx, pre_scale=norm)
    kh = None if my is None else BandedMatrix(
        my, pre_scale=norm if mx is None else None)
    return kw, kh


def _mega_plane_plain(p: torch.Tensor, mx: BandedMatrix | None,
                      my: BandedMatrix | None,
                      norm: float | None) -> torch.Tensor:
    x = p.to(torch.float32)
    if mx is None and my is None:
        return x if norm is None else x * float(np.float32(norm))
    if mx is not None:
        x = x @ mx.dense_on(p.device)
    return x if my is None else my.dense_on(p.device).T @ x


def mega3_tail_plain(y, u, v, mx_y: BandedMatrix | None,
                     mx_c: BandedMatrix | None, my_y: BandedMatrix | None,
                     my_c: BandedMatrix | None, h_out: int,
                     epilogue: Epilogue,
                     norm: float | None = None) -> torch.Tensor:
    """Plain K4: per plane the W map, then the H map, each a dense float32
    product (a plane with neither map times ``norm``), then the torch
    epilogue."""
    _no_tf32()
    return epilogue.plain(_mega_plane_plain(y, mx_y, my_y, norm),
                          _mega_plane_plain(u, mx_c, my_c, norm),
                          _mega_plane_plain(v, mx_c, my_c, norm))


@kernel_span("mega3_tail")
def mega3_tail(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               mx_y: BandedMatrix | None, mx_c: BandedMatrix | None,
               my_y: BandedMatrix | None, my_c: BandedMatrix | None,
               h_out: int, epilogue: Epilogue,
               norm: float | None = None) -> torch.Tensor:
    """The whole fused pipeline in one kernel: raw (luma, chroma, chroma)
    planes -> W map -> H map -> epilogue (colour matrix, correction, local
    tone map, quantization) -> (..., 3, h_out, w_out) float32.

    ``y`` (..., Hy, Wy), ``u``/``v`` (..., Hc, Wc): uint8, uint16, int16 or
    float32.  ``mx_*`` (W_in, w_out) and ``my_*`` (H_in, h_out): the maps,
    or None where a plane keeps that axis; the normalisation goes into the
    first map that touches a plane (:func:`mega_maps`), and ``norm`` scales
    a plane with neither.  ``epilogue`` is K2's, so a serving call's colour
    matrix and tone-map scalars come with it.  No pack.

    Kernel K4 (``csrc/mega3_tail.cu``), replacing
    ``resize_pallas.mega3_tail``.  A block makes :func:`k4_route`'s tile
    rows x K4_TILE_COLS columns: it copies each plane's raw window (the
    input rows its H taps reach, over the columns its W taps reach) into
    shared memory at once (16-byte copies, one commit group a plane),
    W-passes it into a float window there with each thread's taps in
    registers, then runs the H taps, the tail of a route compiled for the
    headline, c7 and the colour matrix alone (:func:`mega3_tail_route`; the
    runtime route for the rest) and 16-byte stores; no intermediate plane
    reaches device memory.  A map whose windows do not fit SMEM_BUDGET
    even at K4_MIN_TILE_ROWS (a thumbnail of a 4K frame) takes the
    long-window route: the rows streamed through a ring of three chunks,
    each thread's H sums in registers as they pass, bit-equal.  Either
    route is one launch.  Measured on one NVIDIA H100 80GB HBM3 at 700 W:
    1.68 ms for 16 headline frames, 1.00 of it the input, W, H and stores
    alone, the rest the tail (``PERF.md`` section 6)."""
    epilogue.validate()
    for name, p in (("y", y), ("u", u), ("v", v)):
        _check_plane(name, p)
    if u.shape != v.shape or u.dtype != v.dtype:
        raise ValueError("u and v must share shape and dtype")
    lead, (hy, wy), (hc, wc) = y.shape[:-2], y.shape[-2:], u.shape[-2:]
    if u.shape[:-2] != lead:
        raise ValueError(f"y {tuple(y.shape)} and u {tuple(u.shape)} differ "
                         "in batch")
    w_out = wy if mx_y is None else mx_y.out_size
    for name, mx, my, h_in, w_in in (("y", mx_y, my_y, hy, wy),
                                     ("c", mx_c, my_c, hc, wc)):
        if (w_in if mx is None else mx.out_size) != w_out or (
                mx is not None and mx.in_size != w_in):
            raise ValueError(f"{name}: W map for {w_in} -> {w_out} columns "
                             "does not fit")
        if (h_in if my is None else my.out_size) != h_out or (
                my is not None and my.in_size != h_in):
            raise ValueError(f"{name}: H map for {h_in} -> {h_out} rows "
                             "does not fit")
    if not _kernel_device(y, u, v):
        return mega3_tail_plain(y, u, v, mx_y, mx_c, my_y, my_c, h_out,
                                epilogue, norm)
    batch = y.numel() // (hy * wy) if y.numel() else 0
    route, tile_rows, chunk_rows = k4_route(y.element_size(),
                                            u.element_size(), mx_y, mx_c,
                                            my_y, my_c)
    if batch == 0 or batch > 65535 or -(-h_out // tile_rows) > 65535 \
            or chunk_rows is None:
        raise ValueError(f"K4 cannot take batch {batch} x {h_out} rows x "
                         f"{w_out} columns of these maps")
    dev = y.device

    def w_args(mx):   # (starts, taps, T, strip_lo, span); none: T = 0
        if mx is None:
            return None, None, 0, None, 0
        lo, span = mx.row_windows(K4_TILE_COLS, dev)
        return (*_taps_args(mx, dev), lo.data_ptr(), span)

    def h_args(my):   # (starts, taps, T, tile_lo, win); none: T = 0
        if my is None:
            return None, None, 0, None, 0
        lo, win = my.row_windows(tile_rows, dev)
        return (*_taps_args(my, dev), lo.data_ptr(), win)

    def direct_scale(mx, my):   # the scale of a plane read without maps
        return float(norm) if mx is None and my is None and norm else 1.0

    out = torch.empty(lead + (3, h_out, w_out), dtype=torch.float32,
                      device=dev)
    mats = epilogue.host_mats()
    _launch("mega3_tail", "vrt_mega3_tail", dev,
            y.data_ptr(), DTYPE_CODES[y.dtype], u.data_ptr(), v.data_ptr(),
            DTYPE_CODES[u.dtype], batch, hy, wy, hc, wc, h_out, w_out,
            tile_rows, chunk_rows, *w_args(mx_y), *w_args(mx_c),
            *h_args(my_y), *h_args(my_c), direct_scale(mx_y, my_y),
            direct_scale(mx_c, my_c), *epilogue.launch_args(mats),
            epilogue.dither_bits, int(route == "long-window"),
            redo_counter("mega3_tail", dev).data_ptr(), out.data_ptr())
    return out


def mega3_tail_route(y_dtype: torch.dtype, c_dtype: torch.dtype,
                     epilogue: Epilogue, long_window: bool = False) -> str:
    """The K4 instantiation a launch with these plane dtypes and epilogue
    takes: the name of its compiled route, "runtime" for the staged one
    that reads the tail's flags, or with ``long_window`` (the route
    :func:`k4_route` picks for a map whose windows do not fit)
    "long-window runtime" (vrt_mega3_tail_route over :func:`route_flags`
    without the pack; loads the kernel library, so it needs the CUDA
    toolkit)."""
    return build.load().vrt_mega3_tail_route(
        *route_flags(y_dtype, c_dtype, epilogue, None)[:7],
        int(long_window)).decode()
