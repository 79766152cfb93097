"""The two kernels of the Jinc2 upscale path — K5, the one-pass 2D Jinc2
resample of float planes, and K6, raw Y/U/V to the finished Jinc2-upscaled
surface — with their plain PyTorch versions.

Replaces ``videorenderer_tpu/kernels/jinc2_pallas.py``:
``jinc2_resize_fused`` (K5, ``csrc/jinc2_resize.cu``) and
``jinc2_convert_fused`` (K6, ``csrc/jinc2_convert.cu``).

The Pallas kernels expanded the non-separable Jinc2 weights into a low-rank
sum of separable banded matrices (an SVD with a 1e-4 singular-value cutoff)
because Mosaic has no gather and the TPU's matrix unit wants products.  The
port computes the resample directly, as the JAX package's ``_jinc2_gather``
does: for each output its 16 source taps (clamped to the plane), the 16
weights ``g(d2y + d2x)`` from the per-axis tables of
``ops/scale.jinc2_axis_tables``, the weight-sum normalisation, and the
anti-ringing lerp toward the centre 2x2 min/max.  So the port agrees with
the JAX gather to float32 rounding, and with the JAX kernels within their
cutoff band (about 1e-3 at the rotation geometry, exact rank at 2x).

An output's 16 weights depend only on its row's and its column's d2
vectors, which repeat with the axes' phase periods.  Both kernels read them
from a table of the geometry's distinct (row class, column class) pairs
(:func:`axis_classes`, :func:`_weight_table`), built on the card by one
launch at the geometry's first K5 or K6 call and shared by the two; a
geometry whose table would pass TABLE_CAP computes each output's weights
(:func:`weight_route`).  The table holds the weights the per-output route
computes, bit for bit.

Both kernels can make a band of a larger frame's rows from a block of its
source rows (:class:`Jinc2Rows`, a row shard of ``parallel/spatial``):
the band's rows of the frame's tap tables, its weight table and the
dither's pattern at the frame's rows, so the band's outputs are the frame's
bit for bit.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Each launch adds one to the launch counter
that every kernel of the package shares, ``kernels.resize.launches``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import dither as dither_ops
from ..ops import scale as scale_ops
from ..utils import trace
from . import resize as rk

TILE = 32                       # K6's output tile edge (csrc/jinc2_convert.cu)
K5_TILE_ROWS = 32               # K5's output tile (csrc/jinc2_resize.cu)
K5_TILE_COLS = 128
_SMEM_LIMIT = 227 * 1024        # shared memory one block may use on Hopper
_K6_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 3}
TABLE_ENTRY = 20
"""Floats of one entry of a weight table (kJ2Entry, csrc/jinc2.cuh): the 16
weights row-major (jo * 4 + io), their sum, 3 zeros, read as five 16-byte
loads."""
TABLE_CAP = 4 << 20
"""Bytes of a weight table above which K5 and K6 compute each output's
weights (their per-output route): a geometry with no short phase period on
both axes, where a table would hold about one entry per output."""


@dataclass(frozen=True)
class Jinc2Epilogue:
    """What K5 and K6 run on each output after anti-ringing: ``dither_bits``
    +b ordered dither to b bits (the 32x32 pattern at the output's global
    row and column), -b round to b bits, 0 none; b is 8 or 10.  ``plain``
    is the same step in torch on a whole (..., H, W) output, for the plain
    versions."""

    dither_bits: int
    plain: Callable[..., torch.Tensor]

    def validate(self) -> None:
        if self.dither_bits not in (0, 8, 10, -8, -10):
            raise NotImplementedError(
                f"Jinc2 epilogue: dither_bits {self.dither_bits} is not ported")


def dither_epilogue(dither_bits: int) -> Jinc2Epilogue:
    """The final pass of ``pipeline._final_pass`` as a Jinc2 epilogue:
    ordered dither (+b) or rounding (-b) of the clipped output; 0 leaves
    the output as it is.  ``plain(x, row0)``: the pattern's row at x's
    row 0."""
    def plain(x: torch.Tensor, row0: int = 0) -> torch.Tensor:
        if dither_bits == 0:
            return x
        x = torch.clamp(x, 0.0, 1.0)
        if dither_bits < 0:
            return dither_ops.quantize(x, -dither_bits)
        return dither_ops.ordered_dither_iota(x, dither_bits, row0=row0)

    epi = Jinc2Epilogue(dither_bits=dither_bits, plain=plain)
    epi.validate()
    return epi


@dataclass(frozen=True)
class Jinc2Rows:
    """A launch that makes output rows ``out_row0`` .. ``out_row0 + out_h``
    of the ``full_h -> full_out_h`` row geometry, from a block of source
    rows whose first is the geometry's row ``src_row0`` (it may be
    negative, or past the end: the block holds the clamped rows the frame's
    taps would read).  Every tap row of those outputs lies in the block."""
    full_h: int
    full_out_h: int
    out_row0: int
    src_row0: int


def _band_base(h: int, out_h: int, rows: Jinc2Rows | None) -> np.ndarray:
    """The first tap row of each output row of a launch (int, numpy),
    relative to its block of source rows; checked to reach only rows of
    the block."""
    if rows is None:
        return scale_ops.jinc2_axis_tables(h, out_h)[0]
    base, _ = scale_ops.jinc2_axis_tables(rows.full_h, rows.full_out_h)
    o0 = rows.out_row0
    if o0 < 0 or o0 + out_h > rows.full_out_h:
        raise ValueError(f"rows {o0} .. {o0 + out_h} are not rows of a "
                         f"{rows.full_out_h}-row output")
    band = base[o0:o0 + out_h] - rows.src_row0
    if band.size and (band.min() < 1 or band.max() + 2 > h - 1):
        raise ValueError(f"the taps of rows {o0} .. {o0 + out_h} reach past "
                         f"the {h} source rows from row {rows.src_row0}")
    return band


def _row_tables(h: int, out_h: int, rows: Jinc2Rows | None, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(base (out_h,) int32, d2 (4, out_h) float32) of a launch's rows on
    ``device``: the geometry's tables, or the band's rows of the frame's
    with the bases relative to the block."""
    if rows is None:
        return _axis_on(h, out_h, device)
    by, dy = _axis_on(rows.full_h, rows.full_out_h, device)
    o0 = rows.out_row0
    band = torch.tensor(_band_base(h, out_h, rows), dtype=torch.int32,
                        device=device)
    return band, dy[:, o0:o0 + out_h].contiguous()


def _row_geometry(h: int, out_h: int, rows: Jinc2Rows | None
                  ) -> tuple[int, int, int]:
    """(rows of the frame's source, rows of the frame's output, the frame
    row of output row 0): the geometry whose weight table a launch reads
    and its dither's origin."""
    if rows is None:
        return h, out_h, 0
    return rows.full_h, rows.full_out_h, rows.out_row0


@functools.lru_cache(maxsize=32)
def _axis_on(in_size: int, out_size: int, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One axis's Jinc2 tables (base (out,) int32, d2 (4, out) float32) on
    ``device``, uploaded once."""
    base, d2 = scale_ops.jinc2_axis_tables(in_size, out_size)
    return torch.tensor(base, device=device), torch.tensor(d2, device=device)


@functools.lru_cache(maxsize=32)
def axis_classes(in_size: int, out_size: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The distinct d2 4-vectors of one axis's Jinc2 table
    (``ops/scale.jinc2_axis_tables``), compared bit for bit: ``classes``
    (out,) int32, the index of each output's vector, and ``d2`` (4, n)
    float32, the vectors themselves, so that ``d2[:, classes]`` is the
    axis's d2 table exactly.  The count is the axis's phase period at the
    usual scalings (2 at 2x, 9 at 1920 -> 2160, 32 at 1080 -> 3840), but
    nothing here assumes it.  Read-only arrays, cached."""
    _, d2 = scale_ops.jinc2_axis_tables(in_size, out_size)
    keys = np.ascontiguousarray(d2.T).view(np.uint32)
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    classes = inv.reshape(-1).astype(np.int32)
    reps = np.ascontiguousarray(d2[:, first])
    classes.flags.writeable = False
    reps.flags.writeable = False
    return classes, reps


def weight_table_bytes(h: int, w: int, out_h: int, out_w: int) -> int:
    """Bytes of the weight table of (h, w) -> (out_h, out_w): an entry of
    TABLE_ENTRY floats for every pair of a row class and a column class."""
    return (axis_classes(h, out_h)[1].shape[1]
            * axis_classes(w, out_w)[1].shape[1] * TABLE_ENTRY * 4)


def weight_route(h: int, w: int, out_h: int, out_w: int) -> str:
    """Where K5 and K6 take an output's weights at this geometry: "table"
    (read from the geometry's table) unless the table would pass
    TABLE_CAP, then "per-output" (each output computes its own)."""
    return ("table" if weight_table_bytes(h, w, out_h, out_w) <= TABLE_CAP
            else "per-output")


def _weight(d2: torch.Tensor) -> torch.Tensor:
    """The Jinc2 weight g(d2) in float32 torch, as the plain versions
    compute it: sin(d*wa)*sin(d*wb)/d2, wa*wb at 0."""
    wa = scale_ops._JINC2_WINDOW_SINC * np.pi
    wb = scale_ops._JINC2_SINC * np.pi
    d = torch.sqrt(d2)
    zero = d2 == 0.0
    return torch.where(zero, wa * wb, torch.sin(d * wa) * torch.sin(d * wb)
                       / torch.where(zero, 1.0, d2))


def jinc2_weight_table_plain(dy: torch.Tensor, dx: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of the weight table: for row-class d2 vectors ``dy``
    (4, n_row_cls) and column-class vectors ``dx`` (4, n_col_cls), float32
    (n_row_cls, n_col_cls, TABLE_ENTRY): each pair's 16 weights by the plain
    versions' torch math (:func:`_weight`), their sum in tap order, 3
    zeros."""
    cols, wsum = [], None
    for jo in range(4):
        for io in range(4):
            wgt = _weight(dy[jo][:, None] + dx[io][None, :])
            cols.append(wgt)
            wsum = wgt if wsum is None else wsum + wgt
    zero = torch.zeros_like(wsum)
    return torch.stack(cols + [wsum, zero, zero, zero], dim=-1)


@rk.kernel_span("jinc2_weight_table")
def jinc2_weight_table(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The weight table of the class vectors ``dy`` (4, n_row_cls) and
    ``dx`` (4, n_col_cls), float32: (n_row_cls, n_col_cls, TABLE_ENTRY).

    Kernel ``vrt_jinc2_weight_table`` (``csrc/jinc2_convert.cu``), one
    thread an entry calling ``jinc2.cuh``'s ``jinc2_weights``, the
    function the per-output routes of K5 and K6 call, so the entries are
    the weights they would compute for those outputs, bit for bit.  A CPU
    tensor takes the plain version; each launch adds one to
    ``launches["jinc2_weight_table"]``."""
    for name, t in (("dy", dy), ("dx", dx)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 4 \
                or t.shape[1] == 0 or not t.is_contiguous():
            raise ValueError(f"weight table: {name} must be contiguous "
                             f"float32 (4, n), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not rk._kernel_device(dy, dx):
        return jinc2_weight_table_plain(dy, dx)
    n_r, n_c = dy.shape[1], dx.shape[1]
    if n_r * n_c >= 2 ** 31:
        raise ValueError(f"weight table: {n_r} x {n_c} entries")
    table = torch.empty((n_r, n_c, TABLE_ENTRY), dtype=torch.float32,
                        device=dy.device)
    rk._launch("jinc2_weight_table", "vrt_jinc2_weight_table", dy.device,
               dy.data_ptr(), n_r, dx.data_ptr(), n_c, table.data_ptr())
    return table


@functools.lru_cache(maxsize=32)
def _weight_table(h: int, out_h: int, w: int, out_w: int,
                  device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row classes, column classes, table) of one geometry on ``device``:
    the table is built there by :func:`jinc2_weight_table` at the
    geometry's first K5 or K6 call and kept, so the two kernels share it.
    A build (a miss of the cache: the classes, their upload and the table's
    launch) runs inside the span ``vrt.build.jinc2_table``."""
    with trace.span("vrt.build.jinc2_table"):
        rcls, rrep = axis_classes(h, out_h)
        ccls, crep = axis_classes(w, out_w)
        table = jinc2_weight_table(torch.tensor(rrep, device=device),
                                   torch.tensor(crep, device=device))
        return (torch.tensor(rcls, device=device),
                torch.tensor(ccls, device=device), table)


def clear_weight_tables() -> None:
    """Drop every cached weight table: the next K5 or K6 call of each
    geometry builds its table again."""
    _weight_table.cache_clear()


def _jinc2_plain(x: torch.Tensor, out_h: int, out_w: int,
                 rows: Jinc2Rows | None = None) -> torch.Tensor:
    """Direct 4x4-tap Jinc2 with anti-ringing of float32 (..., H, W), a port
    of the JAX package's ``ops/scale._jinc2_gather``: one gathered
    (..., out_h, out_w) tensor and one weight field per tap; ``rows``: a
    band of a larger frame (:class:`Jinc2Rows`)."""
    h, w = x.shape[-2], x.shape[-1]
    by, dy = _row_tables(h, out_h, rows, x.device)
    bx, dx = _axis_on(w, out_w, x.device)
    tap_rows = [torch.clamp(by + o, 0, h - 1) for o in range(-1, 3)]
    cols = [torch.clamp(bx + o, 0, w - 1) for o in range(-1, 3)]

    out = wsum = None
    center = []
    for jo, r in enumerate(tap_rows):
        xr = torch.index_select(x, -2, r)
        for io, c in enumerate(cols):
            tap = torch.index_select(xr, -1, c)
            if jo in (1, 2) and io in (1, 2):
                center.append(tap)
            wgt = _weight(dy[jo][:, None] + dx[io][None, :])
            term = tap * wgt
            out = term if out is None else out + term
            wsum = wgt if wsum is None else wsum + wgt
    out = out / wsum
    mn = torch.minimum(torch.minimum(center[0], center[1]),
                       torch.minimum(center[2], center[3]))
    mx = torch.maximum(torch.maximum(center[0], center[1]),
                       torch.maximum(center[2], center[3]))
    clamped = torch.minimum(torch.maximum(out, mn), mx)
    return out + (clamped - out) * scale_ops._JINC2_AR_STRENGTH


# ---------------------------------------------------------------------------
# K5: the 2D Jinc2 resample of float planes
# ---------------------------------------------------------------------------


def jinc2_resize_fused_plain(x: torch.Tensor, out_h: int, out_w: int,
                             epilogue: Jinc2Epilogue | None = None,
                             rows: Jinc2Rows | None = None) -> torch.Tensor:
    """Plain K5: the direct gather, then the epilogue."""
    out = _jinc2_plain(x, out_h, out_w, rows)
    return out if epilogue is None else epilogue.plain(
        out, _row_geometry(x.shape[-2], out_h, rows)[2])


@functools.lru_cache(maxsize=32)
def _window(in_size: int, out_size: int, tile: int = TILE) -> int:
    """The largest source window (taps of ``tile`` consecutive outputs)
    along an axis."""
    return _window_of(scale_ops.jinc2_axis_tables(in_size, out_size)[0], tile)


def _window_of(base: np.ndarray, tile: int) -> int:
    """The largest source window of ``tile`` consecutive outputs whose
    first tap rows are ``base``."""
    first = np.arange(0, base.size, tile)
    last = np.minimum(first + tile, base.size) - 1
    return int((base[last] - base[first]).max()) + 4


def k5_window(h: int, w: int, out_h: int, out_w: int,
              rows: Jinc2Rows | None = None) -> tuple[int, int, int]:
    """(rows, pitch, shared-memory bytes) of a K5 block's staged source
    window: the rows and columns the taps of a K5_TILE_ROWS x K5_TILE_COLS
    output tile reach at most (:func:`_window`; for a band of rows, its
    own tiles'), each row staged from a column rounded down to 4 floats, so
    ``pitch`` is the columns plus 3, rounded up to 4."""
    win_h = (_window(h, out_h, K5_TILE_ROWS) if rows is None else
             _window_of(_band_base(h, out_h, rows), K5_TILE_ROWS))
    pitch = -(-(_window(w, out_w, K5_TILE_COLS) + 3) // 4) * 4
    return win_h, pitch, 4 * win_h * pitch


def k5_route(h: int, w: int, out_h: int, out_w: int,
             rows: Jinc2Rows | None = None) -> tuple[str, str]:
    """The route K5 takes at this geometry: (the weights,
    :func:`weight_route` of the frame's geometry; the taps, "staged" in
    shared memory where the tile's window fits the budget, else "direct",
    read through L1)."""
    taps = ("staged" if k5_window(h, w, out_h, out_w, rows)[2] <= _SMEM_LIMIT
            else "direct")
    fh, foh, _ = _row_geometry(h, out_h, rows)
    return weight_route(fh, w, foh, out_w), taps


@rk.kernel_span("jinc2_resize_fused")
def jinc2_resize_fused(x: torch.Tensor, out_h: int, out_w: int,
                       epilogue: Jinc2Epilogue | None = None,
                       rows: Jinc2Rows | None = None) -> torch.Tensor:
    """float32 (..., H, W) -> (..., out_h, out_w): the 2D Jinc2 with
    anti-ringing and the optional epilogue, leading dims flattened into
    planes; ``rows``: the band of a larger frame's rows these are
    (:class:`Jinc2Rows`).

    Kernel K5 (``csrc/jinc2_resize.cu``), replacing
    ``jinc2_pallas.jinc2_resize_fused``.  A block makes a K5_TILE_ROWS x
    K5_TILE_COLS output tile of one plane, 4 adjacent outputs of a row a
    thread.  Its routes (:func:`k5_route`): the weights from the geometry's
    table, the one K6 builds and caches (:func:`_weight_table`), or for a
    geometry with no short period computed for each output; the taps from
    the tile's source window staged in shared memory, or, where that window
    passes the budget, read through L1.  Every route gives the same bits."""
    if x.dtype != torch.float32:
        raise TypeError(f"K5 takes float32 planes, got {x.dtype}")
    if x.dim() < 2 or min(x.shape[-2:]) == 0 or min(out_h, out_w) <= 0:
        raise ValueError(f"K5 cannot resize {tuple(x.shape)} to "
                         f"({out_h}, {out_w})")
    if epilogue is not None:
        epilogue.validate()
    if not rk._kernel_device(x):
        return jinc2_resize_fused_plain(x, out_h, out_w, epilogue, rows)
    h, w = x.shape[-2], x.shape[-1]
    planes = x.numel() // (h * w)
    if planes == 0 or planes > 65535 or out_h > K5_TILE_ROWS * 65535:
        raise ValueError(f"K5 cannot take {planes} planes of {out_h} rows")
    out = torch.empty(x.shape[:-2] + (out_h, out_w), dtype=torch.float32,
                      device=x.device)
    by, dy = _row_tables(h, out_h, rows, x.device)
    bx, dx = _axis_on(w, out_w, x.device)
    fh, foh, row0 = _row_geometry(h, out_h, rows)
    weights, taps = k5_route(h, w, out_h, out_w, rows)
    if weights == "table":
        rcls, ccls, table = _weight_table(fh, foh, w, out_w, x.device)
        wargs = (rcls[row0:row0 + out_h].data_ptr(), ccls.data_ptr(),
                 table.data_ptr(), table.shape[1])
    else:
        wargs = (None, None, None, 0)
    win_h, pitch, _ = k5_window(h, w, out_h, out_w, rows)
    rk._launch("jinc2_resize_fused", "vrt_jinc2_resize", x.device,
               x.data_ptr(), planes, h, w, out_h, out_w, by.data_ptr(),
               dy.data_ptr(), bx.data_ptr(), dx.data_ptr(), *wargs,
               win_h if taps == "staged" else 0, pitch,
               0 if epilogue is None else epilogue.dither_bits, row0,
               out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6: raw Y/U/V -> chroma upsample + colour matrix + Jinc2 + epilogue + pack
# ---------------------------------------------------------------------------


def _k6_win_h(h: int, out_h: int, rows: Jinc2Rows | None) -> int:
    return (_window(h, out_h) if rows is None
            else _window_of(_band_base(h, out_h, rows), TILE))


def k6_smem_bytes(h: int, w: int, out_h: int, out_w: int,
                  out_transpose: bool, rows: Jinc2Rows | None = None) -> int:
    """Shared memory of a K6 block: the float32 RGB source window of the
    widest tile along each axis (:func:`_window`; for a band of rows, its
    own tiles'), and with the transposed store its 3 x TILE x (TILE + 1)
    staging tile."""
    return 4 * (3 * _k6_win_h(h, out_h, rows) * _window(w, out_w)
                + (3 * TILE * (TILE + 1) if out_transpose else 0))


def jinc2_convert_fused_plain(y, u, v, comp_y: rk.BandedMatrix | None,
                              comp_x: rk.BandedMatrix | None,
                              cmat: np.ndarray, out_h: int, out_w: int,
                              y_scale: float, c_scale: float,
                              epilogue: Jinc2Epilogue | None = None,
                              pack_format: str | None = None,
                              out_transpose: bool = False,
                              rows: Jinc2Rows | None = None) -> torch.Tensor:
    """Plain K6: normalise, upsample the chroma by dense float32 products
    (W then H), the colour matrix, the direct Jinc2 on the RGB planes, the
    epilogue, the pack, the transpose."""
    rk._no_tf32()

    def chroma(p):
        x = p.to(torch.float32)
        if comp_x is not None:
            x = x @ comp_x.dense_on(x.device)
        if comp_y is not None:
            x = comp_y.dense_on(x.device).T @ x
        return x * float(np.float32(c_scale))

    yf = y.to(torch.float32) * float(np.float32(y_scale))
    uf, vf = chroma(u), chroma(v)
    m = np.asarray(cmat, np.float32)
    rgb = torch.stack(
        [float(m[i, 0]) * yf + float(m[i, 1]) * uf + float(m[i, 2]) * vf
         + float(m[i, 3]) for i in range(3)], dim=-3)
    out = jinc2_resize_fused_plain(rgb, out_h, out_w, epilogue, rows)
    if pack_format is not None:
        out = rk.pack_surface(out, pack_format)
    return out.transpose(-2, -1).contiguous() if out_transpose else out


@rk.kernel_span("jinc2_convert_fused")
def jinc2_convert_fused(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        comp_y: rk.BandedMatrix | None,
                        comp_x: rk.BandedMatrix | None, cmat: np.ndarray,
                        out_h: int, out_w: int, y_scale: float,
                        c_scale: float,
                        epilogue: Jinc2Epilogue | None = None,
                        pack_format: str | None = None,
                        out_transpose: bool = False,
                        rows: Jinc2Rows | None = None) -> torch.Tensor:
    """Raw luma (..., H, W) and chroma (..., Hc, Wc) planes (uint8, uint16 or
    float32, one dtype) -> the Jinc2-upscaled RGB: chroma upsample by
    ``comp_y`` (Hc, H) and ``comp_x`` (Wc, W) (None: that axis is not
    subsampled), ``y_scale``/``c_scale`` normalisation, the (3, 4) colour
    matrix ``cmat`` (rows m0 m1 m2 c), the 2D Jinc2 with anti-ringing on the
    RGB taps, the epilogue.  Returns (..., 3, out_h, out_w) float32, or with
    ``pack_format`` ("rgba8"/"rgb10a2") (..., out_h, out_w) int32 dwords;
    ``out_transpose`` swaps the last two dims of either, bit for bit.
    ``rows``: the planes are a block of a larger frame's rows and the
    output a band of its output rows (:class:`Jinc2Rows`; ``comp_y`` maps
    the block's chroma rows to its luma rows).

    Kernel K6 (``csrc/jinc2_convert.cu``), replacing
    ``jinc2_pallas.jinc2_convert_fused``.  One block per (frame, 32x32
    output tile) builds the tile's RGB source window in shared memory, then
    each thread resolves 4 adjacent outputs of one row, each with one set
    of 16 weights for three channels, and stores them as one 16-byte
    vector (through a shared-memory tile when transposed); no intermediate
    reaches device memory.  The weights come from the geometry's table
    (:func:`jinc2_weight_table` of its :func:`axis_classes`, built on the
    card at the geometry's first call and cached), or, where
    :func:`weight_route` says "per-output", are computed for each output
    with accurate sqrtf/sinf/division; both routes give the same bits.
    Each launch adds one to ``resize.k6_route_launches`` under its weight
    route, with " transposed" for ``out_transpose`` and " band" for
    ``rows``."""
    if epilogue is not None:
        epilogue.validate()
    if pack_format not in rk.PACK_CODES:
        raise NotImplementedError(f"K6: pack format {pack_format!r}")
    if y.dtype not in _K6_DTYPES or u.dtype != y.dtype or v.dtype != y.dtype:
        raise TypeError(f"K6 takes uint8, uint16 or float32 planes of one "
                        f"dtype, got {y.dtype}, {u.dtype}, {v.dtype}")
    if y.dim() < 2 or u.shape != v.shape or u.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"K6: planes {tuple(y.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)} differ in batch")
    (h, w), (ch, cw) = y.shape[-2:], u.shape[-2:]
    for name, mat, c_in, l_out in (("comp_y", comp_y, ch, h),
                                   ("comp_x", comp_x, cw, w)):
        maps = (c_in, c_in) if mat is None else (mat.in_size, mat.out_size)
        if maps != (c_in, l_out):
            raise ValueError(f"K6: {name} maps {maps[0]} -> {maps[1]} but "
                             f"the planes need {c_in} -> {l_out}")
    if min(h, w, out_h, out_w) <= 0:
        raise ValueError(f"K6 cannot resize ({h}, {w}) to ({out_h}, {out_w})")
    if np.shape(cmat) != (3, 4):
        raise ValueError(f"cmat must be (3, 4), got {np.shape(cmat)}")
    if not rk._kernel_device(y, u, v):
        return jinc2_convert_fused_plain(y, u, v, comp_y, comp_x, cmat,
                                         out_h, out_w, y_scale, c_scale,
                                         epilogue, pack_format, out_transpose,
                                         rows)
    batch = y.numel() // (h * w)
    win_h, win_w = _k6_win_h(h, out_h, rows), _window(w, out_w)
    smem = k6_smem_bytes(h, w, out_h, out_w, out_transpose, rows)
    if batch == 0 or batch > 65535 or smem > _SMEM_LIMIT:
        raise ValueError(f"K6 cannot take batch {batch} with a {win_h}x"
                         f"{win_w} source window ({smem} bytes of shared "
                         "memory)")
    lead = y.shape[:-2]
    oh_, ow_ = (out_w, out_h) if out_transpose else (out_h, out_w)
    if pack_format is None:
        out = torch.empty(lead + (3, oh_, ow_), dtype=torch.float32,
                          device=y.device)
    else:
        out = torch.empty(lead + (oh_, ow_), dtype=torch.int32,
                          device=y.device)
    by, dy = _row_tables(h, out_h, rows, y.device)
    bx, dx = _axis_on(w, out_w, y.device)
    fh, foh, row0 = _row_geometry(h, out_h, rows)
    route = weight_route(fh, w, foh, out_w)
    if route == "table":
        rcls, ccls, table = _weight_table(fh, foh, w, out_w, y.device)
        weights = (rcls[row0:row0 + out_h].data_ptr(), ccls.data_ptr(),
                   table.data_ptr(), table.shape[1])
    else:
        weights = (None, None, None, 0)

    def taps(mat):   # (starts, taps, T) pointers; NULL and T = 0: no matrix
        if mat is None:
            return None, None, 0
        s, t = mat.taps_on(y.device)
        return s.data_ptr(), t.data_ptr(), mat.n_taps

    host_cmat = np.ascontiguousarray(np.asarray(cmat, np.float32).reshape(-1))
    rk._launch("jinc2_convert_fused", "vrt_jinc2_convert", y.device,
               y.data_ptr(), u.data_ptr(), v.data_ptr(), _K6_DTYPES[y.dtype],
               batch, h, w, ch, cw, out_h, out_w, by.data_ptr(),
               dy.data_ptr(), bx.data_ptr(), dx.data_ptr(), *taps(comp_x),
               *taps(comp_y), float(y_scale), float(c_scale),
               host_cmat.ctypes.data,
               0 if epilogue is None else epilogue.dither_bits, row0,
               rk.PACK_CODES[pack_format], int(out_transpose), win_h, win_w,
               *weights, out.data_ptr())
    key = route + (" transposed" if out_transpose else "") \
        + (" band" if rows is not None else "")
    rk.k6_route_launches[key] = rk.k6_route_launches.get(key, 0) + 1
    return out
