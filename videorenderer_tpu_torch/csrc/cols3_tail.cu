// K9: W-axis banded resize of (Y, U, V) plus the whole per-pixel tail, for
// Hopper (sm_90a) — K2 (rows3_tail.cu) with the resize axis swapped, for
// pipelines that resize H first (motion-adaptive deinterlacing, Dolby
// Vision).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: cols3_tail.  Each
// output pixel (b, row, col):
//   1. each plane's W pass: sum_t p[b, row, starts[col] + t] * taps[t, col]
//      in fp32 FMAs, t = 0 .. T-1 in order from 0, columns past the row's
//      end skipped, over a per-output-column tap table (kernels/resize.py:
//      plan_taps); or, for a plane with no W matrix, a direct read times its
//      scale;
//   2. the colour matrix (or none), the correction and the local tone map
//      (tail.cuh, shared with K2 and K4);
//   3. quantization from the GLOBAL row and column, and the store: planar
//      float RGB or one R10G10B10A2 / RGBA8 dword (epilogue.cuh).
//
// Design (cols3_tail.cuh).  A block makes tile_rows rows
// (kernels/deint.K9_TILE_ROWS) x 128 output columns of one frame, 32 x 8
// threads, at most 64 registers a thread so that 4 blocks share an SM:
//   * the W pass.  Each warp makes the tile's rows warp, warp + 8, ... on
//     its own: it copies a row's span of input columns its 128 outputs'
//     taps reach (kernels/resize.BandedMatrix.row_windows along the
//     columns, from a start rounded down to 16 bytes, as K1 does) of each
//     plane into shared memory with 16-byte cp.async copies (element
//     copies where the rows are not 16-byte aligned), the next row's while
//     it runs the current one, and waits for its own copies only.  Each
//     input byte comes from device memory once; only the halo columns at
//     span borders are read again.  The block stages the tile's starts and
//     tap weights once.  Each thread makes 4 consecutive output columns,
//     each summing its taps from shared memory in the same order with the
//     same guard; a thread starts its 4 columns at a lane-dependent one, so
//     a warp's reads of a tap at 2:1 spread over 16 banks, and the starts
//     and weights are staged in that order, so a thread reads its 4 weights
//     of a tap as one 16-byte vector.  Up to 8 taps are unrolled, and a
//     thread whose taps all lie inside the row runs them without the
//     end-of-row guard.  A plane with no W matrix is read with 4-wide vector
//     loads straight from device memory.
//   * the tail.  The route is a template parameter (route.cuh): c5's (HLG
//     -> SDR, RGBA8) and c8's (R, G, B planes, PQ -> SDR, R10G10B10A2) are
//     compiled each with its own path only, in cols3_tail_c5.cu and
//     cols3_tail_c8.cu, which build in parallel with this file; any other
//     combination takes the runtime instantiation, which reads the flags
//     and runs a thread's pixels one at a time.  A compiled route runs the
//     thread's 4 pixels' tails side by side with one CheckedDiv check for
//     all their divisions, as K2 does.
//   * the store: 4 packed dwords as one 16-byte store, or three 16-byte
//     stores of planar float, where the row is 16-byte aligned; a scalar
//     edge path takes widths that are not a multiple of 4 and unaligned
//     pointers.  A placed output (Dolby Vision in a rect) goes into its
//     surface at the rect's origin, as K2's does.
//   * the long-window route (cols3_tail_long.cu): a map whose spans do not
//     fit shared memory (4K to 320 columns needs 324 KB) takes a kernel
//     that stages nothing and reads every tap through the read-only cache,
//     in the staged route's order with its guard, then the runtime route's
//     tail, bit-equal to the staged route.
// Every output is bit-equal to the one-pixel-a-thread kernel this replaces:
// the same operations in the same order.  Shared memory: the spans, taps and
// starts must fit kSmemBudget; the wrapper (kernels/deint.cols3_tail) takes
// the long-window route for a map whose spans do not.
//
// Bound.  At c5 (both fields of 16 frames, K7's float32 output) each output
// pixel reads 6 luma taps and 2 x 4 chroma taps of float32 planes that
// device memory delivers about once (1.06 GB a batch) and writes one dword
// (265 MB): 0.396 ms on one H100.  The tail is K2's, the accurate
// transcendentals of the HLG -> SDR chain, each operation rounded on its
// own: 448 SASS instructions a pixel on the C5 route (kernel_report.py), an
// issue bound of 0.89 ms for those pixels, so the tail's issue, not the
// bytes, sets the kernel's floor (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cols3_tail.cuh"

// the routes compiled in cols3_tail_c5.cu and cols3_tail_c8.cu
extern template VRT_K9_LAUNCH(C5, float, float);
extern template VRT_K9_LAUNCH(C8, float, float);
// the long-window kernel (cols3_tail_long.cu) and the extended runtime
// route (cols3_tail_ext.cu)
extern template VRT_K9_LAUNCH_ANY(launch_long, RuntimeRoute);
extern template VRT_K9_LAUNCH_ANY(launch_runtime, RuntimeExtended);
extern template VRT_K9_LAUNCH_ANY(launch_long, RuntimeExtended);

using namespace vrt;
using namespace vrt::k9;

namespace {

const auto kSpecs = std::make_tuple(Spec<C5, float, float>{"c5 float32"},
                                    Spec<C8, float, float>{"c8 float32"});

}  // namespace

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  Per plane class (y,
// c): the W map's starts, taps and n_taps, and each tile's first input
// column (``lo_*``, device, one int per tile of 128 output columns) and the
// widest span ``win_*`` (kernels/resize.BandedMatrix.row_windows); NULL and
// n_taps 0 for a plane with no W matrix, read directly (its width is w_out)
// times its scale.  ``host_mats`` is HOST memory: 12 floats of the colour
// matrix, row-major 3 x (m0 m1 m2 c), 9 of the gamut matrix, the 5 scalars
// of the local tone map of selection ``tonemap`` (0: none), the SDR
// BT.2020 fix's source gamma, then the L2 trims and the guided curve
// (tail.cuh's make_tail).  The output frames go into surfaces of
// surface_h x surface_w at (off_y, off_x) (the whole surface: h x w_out at
// (0, 0)); the bars are the caller's.  ``long_window``: the long-window
// kernel (no shared memory, the runtime route), else the staged one, which
// returns cudaErrorInvalidValue for a layout over kSmemBudget.  A launch
// with the L2 trims or the guided curve takes the extended runtime route.
extern "C" int vrt_cols3_tail(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int h, int wy, int wc, int w_out, int tile_rows,
    const void* starts_y,
    const void* taps_y, int n_taps_y, const void* lo_y, int win_y,
    const void* starts_c, const void* taps_c, int n_taps_c, const void* lo_c,
    int win_c, float y_scale, float c_scale, const void* host_mats,
    int apply_matrix, int correction, int tonemap, float luminance_scale,
    int dither_bits, int pack, int surface_h, int surface_w, int off_y,
    int off_x, int long_window, void* out, void* stream) {
  const vrt::TailParams P = vrt::make_tail_params(
      host_mats, apply_matrix, correction, tonemap, luminance_scale, y_scale,
      c_scale, dither_bits, pack);
  const Geometry G{
      h, w_out, tile_rows,
      WMap{wy, static_cast<const int*>(starts_y),
           static_cast<const float*>(taps_y), n_taps_y,
           static_cast<const int*>(lo_y), win_y},
      WMap{wc, static_cast<const int*>(starts_c),
           static_cast<const float*>(taps_c), n_taps_c,
           static_cast<const int*>(lo_c), win_c},
      vrt::Place{surface_h, surface_w, off_y, off_x}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Flags f = flags_of(y_dtype, c_dtype, apply_matrix, correction,
                           tonemap, P.tail.trims, dither_bits, pack);
  if (long_window) {
    return (f.extended() ? launch_long<RuntimeExtended>
                         : launch_long<RuntimeRoute>)(
        y_dtype, c_dtype, y, u, v, G, P, batch, out, st);
  }
  if (f.extended()) {
    return launch_runtime<RuntimeExtended>(y_dtype, c_dtype, y, u, v, G, P,
                                           batch, out, st);
  }
  int err = 0;
  if (with_spec(kSpecs, f, [&](const auto& s) {
        using S = std::decay_t<decltype(s)>;
        err = launch<typename S::R, typename S::TY, typename S::TC>(
            y, u, v, G, P, batch, out, st);
      })) {
    return err;
  }
  return launch_runtime<RuntimeRoute>(y_dtype, c_dtype, y, u, v, G, P, batch,
                                      out, st);
}

// The name of the route K9 takes for these flags: its compiled route,
// "runtime" for the staged instantiation that reads them (the extended one
// for a launch with the trims or the guided curve), or "long-window
// runtime" for the long-window kernel.
extern "C" const char* vrt_cols3_tail_route(int y_dtype, int c_dtype,
                                            int apply_matrix, int correction,
                                            int tonemap, int trims,
                                            int dither_bits, int pack,
                                            int long_window) {
  if (long_window) return "long-window runtime";
  const char* name = "runtime";
  with_spec(kSpecs,
            flags_of(y_dtype, c_dtype, apply_matrix, correction, tonemap,
                     trims, dither_bits, pack),
            [&](const auto& s) { name = s.name; });
  return name;
}
