// K8: H maps of (Y, U, V) into a mid resolution, the Dolby Vision convert
// there, and a shared H map out, for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: rows3_mid with the
// DoVi mid_fn of videorenderer_tpu/pipeline._make_dovi_fused_fn (the static
// _epi_a and the runtime _epi_a_rt, which reads the curves from a scalar
// vector laid out by ops/dovi.flatten_curve_scalars).  Per mid pixel:
//   1. each plane's H pass into the mid rows: sum_t p[starts[m] + t] *
//      taps[t, m] in fp32 FMAs over a per-mid-row tap table
//      (kernels/resize.py: plan_taps), t = 0 .. T-1 in order from 0, taps
//      past the plane skipped; or a direct read times its scale;
//   2. the reshape of ops/dovi (clip to [0, 1], the piece = the count of
//      pivots at or below the signal, its polynomial or MMR value, clip),
//      the 3x3+c RPU matrix, then the LMS step: PQ EOTF, the combined
//      LMS->RGB matrix, PQ OETF, or with an identity product max(x, 0);
//   3. the out map's H taps over the mid rows, t in order from 0, mid rows
//      past h_mid skipped: one float32 plane per channel.
// Every operation rounds on its own, in the order of the torch plain
// version (kernels/deint.rows3_mid_plain, ops/dovi.MidStage.plain).
//
// Design (rows3_mid.cuh).  A block of 256 threads makes 64 columns of
// kTilesPerBlock consecutive tiles of tile_rows output rows (32 on c8's
// light route, 31 on the LMS route, 16 on the runtime route, fewer where
// the window does not fit shared memory; kernels/deint.k8_tile_rows) of
// one frame, walking its tiles in order:
//   * staging.  The rows of each plane with an in map that the tile's mid
//     window reaches (kernels/deint.k8_in_windows: c8's chroma, 34 rows
//     for 66 mid rows) are copied into shared memory with 16-byte cp.async
//     copies, with the window's in taps and starts; the next tile's are
//     copied while the current tile's out taps run, so those loads overlap
//     the out pass and the stores.  A plane read directly (c8's luma) is
//     read straight from device memory: on c8's route one 8-byte vector
//     load of 4 columns a thread, the next mid row's ahead of the current
//     one's convert.
//   * the mid pass.  Each mid row of the window (66 for 32 output rows at
//     c8's Catmull-Rom 2:1) is computed once and kept in shared memory as
//     three float32 planes, so the full-resolution RGB never reaches
//     device memory: on c8's and the LMS route 4 adjacent columns a
//     thread, written as 16-byte vectors (a warp's row of the planes is
//     256 bytes); on the runtime route the window's pixels dealt out one a
//     thread.
//   * the out pass.  Each thread runs the out taps of 4 columns from the
//     window as 16-byte reads, and stores the three channels as 16-byte
//     vectors; a scalar edge path takes widths that are not a multiple of
//     4 and unaligned pointers.
//   * the convert.  The route is a template parameter (dovi_mid.cuh:
//     MidRoute): c8's (identity curves, an LMS product that folds away)
//     runs a thread's 4 pixels side by side and reads the curve scalars
//     from the launch's __grid_constant__ parameter at fixed offsets, so a
//     block copies nothing; the non-identity LMS route (a stream whose LMS
//     matrices are not mutual inverses: Dolby Vision profile 5, c8's
//     variant) converts a thread's 4 pixels as one group (dovi_mid.cuh:
//     dovi_mid_group), each stage across the group before the next: the
//     curves' scalars in fixed slots of the launch's parameter (to_slots),
//     read as operands, their dispatch compiled (the piece search and the
//     pieces unrolled, the MMR body unrolled for each order), the pows
//     and divisions of the group's LMS steps with one range check
//     (tail.cuh's CheckedPow; a group out of its range runs its LMS steps
//     again exactly and is counted in ``redo_groups``); the
//     runtime route (every other combination of plane dtypes, LMS flag and
//     curve structure) copies the curve scalars and structure into shared
//     memory once a block.  c8's and the LMS route are compiled in
//     rows3_mid_c8.cu and rows3_mid_lms.cu, in parallel with this file.
//   * the long-window route (rows3_mid_long.cu).  A map whose window does
//     not fit shared memory even at one output row a tile (2160 mid rows to
//     16 output rows: 275-824 KB) takes a kernel that keeps no window: each
//     thread computes, for each out tap, that mid row's pixel from inputs
//     read through the read-only cache, in the staged route's order, on
//     the runtime route, bit-equal to the staged route.
// c8's route holds 80 registers a thread and its 70 KB of shared memory 3
// blocks an SM, and so do the LMS route's 80 registers and its 31-row
// tiles' 68 KB (a 64-row window at c8's 2:1: 4 groups a thread); the
// runtime route, whose convert is long dependent chains of accurate pows
// and divisions, 40 registers and its 16-row tiles' ~37 KB 6 blocks.  Every
// output is bit-equal to the one-column-a-thread kernel this replaces:
// the same operations in the same order.
//
// Runtime values: the colour matrix, the combined LMS matrix and the curve
// scalars (at most 12 + 9 + 549 floats) and the curve structure (pieces,
// kinds, MMR orders) travel in one struct passed by value with the launch,
// so a new scene's curves need no rebuild, no copy to the device and no
// host synchronisation.
//
// Bound.  At c8 (4K P010 Dolby Vision -> 1080p, 16 frames) device memory
// delivers the luma (uint16) and the two K1-upsampled chroma planes
// (float32) about once and takes the three float32 output planes: 0.475 ms
// on one H100.  The identity route's convert is a few dozen operations a
// pixel, under that.  The LMS route's is bound by its issue, most of it
// the LMS step's twelve pows a pixel (log2 in software): libdevice's
// log2f and exp2f took ~38 SASS instructions a pow and ~2.8 of K8's
// 4.7 ms at c8's variant, 16 frames, on one H100; CheckedPow takes ~28,
// and K8 4.14 ms at the p5 cell's call (PERF.md, section 6).
// The TPU kernel's split-bf16 products and full-height column stripes in
// VMEM do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows3_mid.cuh"

// the routes compiled in rows3_mid_c8.cu and rows3_mid_lms.cu
extern template VRT_K8_LAUNCH(C8Mid, uint16_t, float);
extern template VRT_K8_LAUNCH(LmsMid, uint16_t, float);

using namespace vrt::k8;
using vrt::dovi::params_of;
using vrt::dovi::route_of;

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  Per plane class (y,
// c): its rows, the in map's starts, taps and n_taps, and each tile's first
// staged input row (``lo_*``, device, one int per tile) and the rows a
// tile stages (``win_*``) (kernels/deint.k8_in_windows); NULL and n_taps 0
// for a plane without an in map, read directly (its height is h_mid)
// times its scale.  The out map's starts, taps and n_taps (0: none, then
// h_out is h_mid), ``tile_lo`` (device, one int per tile of ``tile_rows``
// output rows; NULL without an out map) and ``win`` give each tile's
// window of mid rows (kernels/resize.BandedMatrix.row_windows).
// ``host_vals`` is HOST memory: n_vals floats, the colour matrix row-major
// 3 x (m0 m1 m2 c), the combined LMS matrix row-major 3 x 3, then the curve
// scalars; ``host_structure`` (HOST) holds per channel its piece count,
// then 8 kinds and 8 MMR orders.  ``out`` is (3, batch, h_out, w).
// ``long_window``: the long-window kernel (no shared memory, the runtime
// route; one tile of ``tile_rows`` output rows a block, ``tile_lo`` and the
// in maps' windows unused).  ``redo_groups``: a device int64 to which the
// LMS route (dovi_mid.cuh's CheckedPow) adds the groups it runs again
// exactly, or NULL; the other routes ignore it.  Returns
// cudaErrorInvalidValue for a structure or a layout it does not take.
extern "C" int vrt_rows3_mid(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int hy, int hc, int w, int h_mid, int h_out, int tile_rows,
    const void* starts_y, const void* taps_y, int n_taps_y, const void* lo_y,
    int win_y, const void* starts_c, const void* taps_c, int n_taps_c,
    const void* lo_c, int win_c, const void* starts_o, const void* taps_o,
    int n_taps_o, const void* tile_lo, int win, float y_scale, float c_scale,
    const void* host_vals, int n_vals, const void* host_structure,
    int lms_identity, int long_window, void* redo_groups, void* out,
    void* stream) {
  MidParams P;
  if (!params_of(host_vals, n_vals, host_structure, lms_identity, y_scale,
                 c_scale, &P) ||
      tile_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry G{w, h_mid, h_out, tile_rows,
                   (h_out + tile_rows - 1) / tile_rows,
                   InMap{hy, static_cast<const int*>(starts_y),
                         static_cast<const float*>(taps_y), n_taps_y,
                         static_cast<const int*>(lo_y), win_y},
                   InMap{hc, static_cast<const int*>(starts_c),
                         static_cast<const float*>(taps_c), n_taps_c,
                         static_cast<const int*>(lo_c), win_c},
                   static_cast<const int*>(starts_o),
                   static_cast<const float*>(taps_o), n_taps_o,
                   static_cast<const int*>(tile_lo), win};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (long_window) {
    return launch_long(y_dtype, c_dtype, y, u, v, G, P, batch, out, st);
  }
  switch (route_of(y_dtype, c_dtype, P)) {
    case 1:
      return launch<C8Mid, uint16_t, float>(y, u, v, G, P, batch, out,
                                            nullptr, st);
    case 2:
      vrt::dovi::to_slots(&P);
      return launch<LmsMid, uint16_t, float>(y, u, v, G, P, batch, out,
                                             redo_groups, st);
    default: break;
  }
  int err = 0;
  bool known = false;
  vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    known = true;
    err = launch<RuntimeMid, TY, TC>(y, u, v, G, P, batch, out, nullptr,
                                     st);
  });
  return known ? err : static_cast<int>(cudaErrorInvalidValue);
}

// The name of the route K8 takes for these plane dtypes, curve structure
// and LMS flag ("c8 uint16/float32", "lms uint16/float32", or "runtime"),
// or "invalid" for a structure the kernel does not take.
extern "C" const char* vrt_rows3_mid_route(int y_dtype, int c_dtype,
                                           const void* host_vals, int n_vals,
                                           const void* host_structure,
                                           int lms_identity) {
  MidParams P;
  if (!params_of(host_vals, n_vals, host_structure, lms_identity, 1.f, 1.f,
                 &P)) {
    return "invalid";
  }
  return vrt::dovi::kRouteNames[route_of(y_dtype, c_dtype, P)];
}
