// K4: the whole fused pipeline in one kernel, for Hopper (sm_90a): per plane
// the W map, then the H map, then the shared tail (colour matrix,
// correction, local tone map, quantization), planar float32 out.
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: mega3_tail (the
// per-plane plan _MegaPlane, the tile body _mega_plane_tile).  The raw
// planes are read and the finished pixels written; nothing in between
// reaches device memory, in particular not the W-passed "mid16" planes the
// two-stage route (K1 then K2) writes and reads back.  The TPU kernel's
// split-bf16 three-pass products, lane-shifted copies and 128-wide windows
// were artefacts of the MXU and the lane tiling and are gone.
//
// Design (mega3_tail.cuh).  A block makes a tile of tile_rows output rows x
// 128 columns of one frame, 32 x 8 threads:
//   * the input.  For each plane the block copies the window of input rows
//     its tile's H taps reach (kernels/resize.BandedMatrix.row_windows) over
//     the column span its 128 outputs' W taps reach (row_windows(128) of
//     the W map) into shared memory at once, 16-byte cp.async copies where
//     the rows are 16-byte aligned, element copies where not, one commit
//     group a plane, so the luma's W pass starts while the chroma's copies
//     land and a block waits for device memory once.  Each raw byte comes
//     from device memory once a tile; only the halo rows and columns at
//     tile borders are read again (at the headline's 16-row tiles the luma
//     window is 36 rows for 32, the span 260 columns for 256).
//   * the W pass, K1's: each thread owns 2 adjacent output columns, holds
//     their window-relative starts and (up to 8) taps in registers for all
//     the window's rows, 4 rows side by side, and writes the W-passed float
//     rows into the tile's window in shared memory; lanes 16-31 run their
//     second column first, so a warp's reads of one tap fall in distinct
//     banks.  A plane with no W map is its own columns times its scale; a
//     plane with neither map (c7's luma) is not staged at all but read with
//     vector loads where its outputs need it.
//   * the H pass and the tail, K2's: each thread sums the H taps of 4
//     consecutive columns from the window (the tile's taps and starts in
//     shared memory), then runs the tail of its route (route.cuh): the
//     headline (HeadlineFloat), c7 (C7Float) and the colour matrix alone
//     (MatrixFloat) on the raw P010 planes are compiled each with its own
//     path in its own translation unit, the 4 pixels side by side with
//     CheckedDiv; every other flag set takes the runtime route
//     (RuntimeExtended with the L2 trims or the guided curve).  The 4
//     pixels go out as three 16-byte planar stores where the row is
//     aligned, scalar stores at ragged edges.
//   * occupancy.  The launch bounds hold a thread to 80 registers, so
//     three blocks share an SM where their shared memory allows;
//     kernels/resize.k4_route picks the most tile rows that let them.
//   * the long-window route (mega3_tail_long.cu).  A map whose windows do
//     not fit shared memory even at 8-row tiles (a thumbnail of a 4K
//     frame: 2160 rows to 90 reach 888 input rows at 32-row tiles) streams
//     the planes' rows through a ring of three chunks of raw rows (the
//     copies of two in flight while the block W-passes one) into one chunk
//     of W-passed rows, and each thread adds the chunk's rows to the H sums
//     of its 2 rows x 4 columns in registers: rows arrive in order, so each
//     sum runs the staged route's FMAs in its order, bit-equal; the
//     runtime tail.  kernels/resize.k4_route picks the route from the
//     sizes before the launch.
// Every output is bit-equal to the kernel this replaces (one block of 32 x
// 32 outputs, the W pass straight from device memory, the runtime tail a
// pixel at a time): the same FMAs in the same order, the same tail
// operations (route.cuh: the compiled routes give the runtime route's
// bits).  What held that kernel back: every pixel ran the runtime tail
// (~3500-6100 SASS a pixel against ~585 on K2's compiled headline route),
// each thread re-read its W taps from device memory for every window row
// and its raw codes one column at a time, 32-row tiles recomputed 1.16x of
// the W pass and 32-column strips re-read 1.17x of the columns, and each
// output was a 4-byte store.
//
// Bound.  Device memory: the raw planes read once (~0.40 GB per 16 headline
// frames) and the float32 output written once (~0.40 GB): 0.238 ms at 3.35
// TB/s (c7: 0.594).  The tail's instruction issue bounds it higher: the
// compiled headline route's tail is 589.5 SASS a pixel (kernel_report.py),
// 0.585 ms for 16 headline frames at 1980 MHz; c7's 1147, 4.55 ms.
// Measured on one NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 19, batch 16): 1.638 ms at the headline (the kernel this replaces: 1.939),
// 0.978 ms with the colour matrix alone, so the input, W and H passes and
// the stores, at 24% of the byte bound, hold it back as much as the tail;
// 4.340 ms at c7 (was 5.090), at its tail's issue bound; 7.12 ms on the
// long-window route at the 160 x 90 Lanczos thumbnail, whose W pass has
// 144 taps at 24:1 and is recomputed 1.31x over 16-row tiles.  The
// two-stage route (K1 then K2) in the same runs: 1.581 ms unpacked at the
// headline, 4.823 at c7, 3.43 at the thumbnail (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mega3_tail.cuh"

// the routes compiled in mega3_tail_headline.cu, mega3_tail_c7.cu and
// mega3_tail_matrix.cu
extern template VRT_K4_LAUNCH(HeadlineFloat, uint16_t, uint16_t);
extern template VRT_K4_LAUNCH(C7Float, uint16_t, uint16_t);
extern template VRT_K4_LAUNCH(MatrixFloat, uint16_t, uint16_t);
// the long-window kernel (mega3_tail_long.cu) and the extended runtime
// route, staged (mega3_tail_ext.cu) and long-window (mega3_tail_ext_long.cu)
extern template VRT_K4_LAUNCH_ANY(RuntimeRoute, true);
extern template VRT_K4_LAUNCH_ANY(RuntimeExtended, false);
extern template VRT_K4_LAUNCH_ANY(RuntimeExtended, true);

using namespace vrt;
using namespace vrt::k4;

namespace {

const auto kSpecs = std::make_tuple(
    Spec<HeadlineFloat, uint16_t, uint16_t>{"headline planar uint16"},
    Spec<C7Float, uint16_t, uint16_t>{"c7 planar uint16"},
    Spec<MatrixFloat, uint16_t, uint16_t>{"matrix planar uint16"});

}  // namespace

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  Per plane class (y,
// c): the W map's (starts, taps, T) with each 128-column strip's first input
// column (``span_lo_*``, device) and the widest span ``span_*``
// (kernels/resize.BandedMatrix.row_windows(128) of the W map), T = 0 for no
// map; the H map's (starts, taps, T) with each tile's first input row
// (``lo_*``, device, one int per tile of ``tile_rows`` output rows) and the
// widest window ``win_*``, T = 0 for no map (the plane is then h_out rows
// tall).  A plane with neither map is read times ``y_scale``/``c_scale``; a
// plane without a W map is w_out columns wide.  ``chunk_rows``: raw rows a
// chunk of the long-window route's ring (the staged route copies whole
// windows and reads none).  ``host_mats`` is HOST memory: the colour matrix (12
// floats), the gamut matrix (9), the 5 tone-map scalars, the SDR BT.2020
// fix's gamma, the L2 trims and the guided curve (tail.cuh's make_tail).
// ``long_window``: the long-window kernel (tile_rows must be 16), else the
// staged one.  Returns cudaErrorInvalidValue for a layout over
// kSmemBudget.  ``redo_groups``: a device int64 to which the c7 route
// (route.cuh's CheckedPow policy) adds the groups it runs again exactly, or
// NULL.  ``out`` is (batch, 3, h_out, w_out) float32.
extern "C" int vrt_mega3_tail(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int hy, int wy, int hc, int wc, int h_out, int w_out,
    int tile_rows, int chunk_rows, const void* sx_y, const void* tx_y,
    int ntx_y, const void* span_lo_y, int span_y, const void* sx_c,
    const void* tx_c, int ntx_c, const void* span_lo_c, int span_c,
    const void* sy_y, const void* ty_y, int nty_y, const void* lo_y,
    int win_y, const void* sy_c, const void* ty_c, int nty_c,
    const void* lo_c, int win_c, float y_scale, float c_scale,
    const void* host_mats, int apply_matrix, int correction, int tonemap,
    float luminance_scale, int dither_bits, int long_window,
    void* redo_groups, void* out, void* stream) {
  vrt::TailParams P = vrt::make_tail_params(
      host_mats, apply_matrix, correction, tonemap, luminance_scale, y_scale,
      c_scale, dither_bits, vrt::kPackNone);
  P.set_redo(redo_groups);
  auto maps = [](int h, int w, const void* sx, const void* tx, int ntx,
                 const void* span_lo, int span, const void* sy,
                 const void* ty, int nty, const void* lo, int win) {
    return PlaneMaps{h, w, static_cast<const int*>(sx),
                     static_cast<const float*>(tx), ntx,
                     static_cast<const int*>(span_lo), span,
                     static_cast<const int*>(sy),
                     static_cast<const float*>(ty), nty,
                     static_cast<const int*>(lo), win};
  };
  const Geometry G{h_out, w_out, tile_rows, chunk_rows,
                   maps(hy, wy, sx_y, tx_y, ntx_y, span_lo_y, span_y, sy_y,
                        ty_y, nty_y, lo_y, win_y),
                   maps(hc, wc, sx_c, tx_c, ntx_c, span_lo_c, span_c, sy_c,
                        ty_c, nty_c, lo_c, win_c)};
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Flags f = flags_of(y_dtype, c_dtype, apply_matrix, correction,
                           tonemap, P.tail.trims, dither_bits, kPackNone);
  if (long_window) {
    return (f.extended() ? launch_runtime<RuntimeExtended, true>
                         : launch_runtime<RuntimeRoute, true>)(
        y_dtype, c_dtype, y, u, v, G, P, batch, o, st);
  }
  if (f.extended()) {
    return launch_runtime<RuntimeExtended, false>(y_dtype, c_dtype, y, u, v,
                                                  G, P, batch, o, st);
  }
  int err = 0;
  if (with_spec(kSpecs, f, [&](const auto& s) {
        using S = std::decay_t<decltype(s)>;
        err = launch<typename S::R, typename S::TY, typename S::TC, false>(
            y, u, v, G, P, batch, o, st);
      })) {
    return err;
  }
  return launch_runtime<RuntimeRoute, false>(y_dtype, c_dtype, y, u, v, G, P,
                                             batch, o, st);
}

// The name of the route K4 takes for these flags: its compiled route,
// "runtime" for the staged instantiation that reads them (the extended one
// for a launch with the trims or the guided curve), or "long-window
// runtime" for the long-window kernel.
extern "C" const char* vrt_mega3_tail_route(int y_dtype, int c_dtype,
                                            int apply_matrix, int correction,
                                            int tonemap, int trims,
                                            int dither_bits,
                                            int long_window) {
  if (long_window) return "long-window runtime";
  const char* name = "runtime";
  with_spec(kSpecs,
            flags_of(y_dtype, c_dtype, apply_matrix, correction, tonemap,
                     trims, dither_bits, kPackNone),
            [&](const auto& s) { name = s.name; });
  return name;
}
