// K2's Dolby Vision route: H-axis banded resize of (Y, U, V) into the
// source rows and the Dolby Vision convert there, for Hopper (sm_90a).
// Stage A of the two-stage Dolby Vision form (VRT_TPU_DOVI_MID=0).
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: rows3_tail with the
// epilogue _epi_a (static curves) or _epi_a_rt (a scene's curves from the
// scalar vector of ops/dovi.flatten_curve_scalars) of
// videorenderer_tpu/pipeline._make_dovi_fused_fn.  Each output pixel
// (b, r, w):
//   1. each plane's H pass: K2's sums (rows3_tail.cu), t = 0 .. T-1 in
//      order from 0, rows past the input skipped; or a direct read times
//      its scale (c8's luma, a 4:4:4 source's chroma);
//   2. the convert of dovi_mid.cuh, shared with K8: the reshape (clip to
//      [0, 1], the piece = the count of pivots at or below the signal, its
//      polynomial or MMR value, clip), the 3x3+c RPU matrix, the LMS step
//      (PQ EOTF, the combined LMS->RGB matrix, PQ OETF, or with an
//      identity product max(x, 0));
//   3. the store: three float32 planes, (3, batch, h, w), so that stage
//      B's K1 reads each channel without a copy.
// Every operation rounds on its own, in the order of the torch plain
// version (kernels/resize.rows3_tail_dovi_plain: K2's plain H contraction,
// then ops/dovi.MidStage.plain).
//
// Design (rows3_tail_dovi.cuh).  K2's tile: a block of 32 x 8 threads makes
// 32 output rows x 128 columns of one frame; it copies the window of input
// rows its tile's taps reach (kernels/resize.BandedMatrix.row_windows) and
// the tile's starts and taps into shared memory with 16-byte cp.async
// copies, and each thread sums the taps of 4 consecutive columns (K2's
// h_values), then converts its 4 pixels and stores each channel as one
// 16-byte vector; a scalar edge path takes widths that are not a multiple
// of 4.  The convert's route is a template parameter (dovi_mid.cuh's
// MidRoute, picked on the host by route_of as for K8): c8's light route
// (uint16 luma, float32 chroma, identity curves, an LMS product that folds
// away) converts the 4 pixels side by side and reads the curve scalars at
// fixed offsets of the launch's __grid_constant__ parameter; the LMS route
// (a non-identity LMS step, c8's variant) and the runtime route (every
// other combination: a 4:4:4 source's uint16 chroma, an 8-bit source,
// curves of several pieces with an LMS product that folds away) copy the
// curve scalars and structure into shared memory once a block and
// convert one pixel at a time.  c8's and the LMS route are compiled here,
// the runtime route in rows3_tail_dovi_rt.cu, in parallel.
// No long-window route: stage A's maps are the chroma upsample and the
// blend map, a few taps an output row, whose windows fit shared memory
// many times over; the wrapper refuses a map whose windows do not
// (kernels/resize.k2_dovi_smem_bytes).
//
// Bound.  At c8 (4K P010 Dolby Vision, 16 frames) the route reads the
// uint16 luma and K1's two float32 chroma planes (2160 x 1920 -> 3840
// wide, 1080 rows) once and writes three float32 planes of 2160 x 3840:
// ~149 MB a frame, 0.713 ms per 16 frames over 3.35 TB/s; the identity
// convert is a few dozen operations a pixel, under that, and the LMS
// route's six accurate pows a pixel near the line between the two bounds
// (PERF.md section 6 has the times).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows3_tail_dovi.cuh"

using namespace vrt::k2;

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  Per plane class (y,
// c): the H map's starts, taps and n_taps, and each tile's first window row
// (``lo_*``, device) and the widest window ``win_*``, as vrt_rows3_tail
// takes them; NULL and n_taps 0 for a plane read directly (its height is
// h_out) times its scale.  ``host_vals`` is HOST memory: n_vals floats,
// the colour matrix row-major 3 x (m0 m1 m2 c), the combined LMS matrix
// row-major 3 x 3, then the curve scalars; ``host_structure`` (HOST) holds
// per channel its piece count, then 8 kinds and 8 MMR orders
// (ops/dovi.MidStage).  ``out`` is (3, batch, h_out, w) float32.  Returns
// cudaErrorInvalidValue for a structure or a layout it does not take.
extern "C" int vrt_rows3_tail_dovi(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int hy, int hc, int w, int h_out, int tile_rows,
    const void* starts_y, const void* taps_y, int n_taps_y, const void* lo_y,
    int win_y, const void* starts_c, const void* taps_c, int n_taps_c,
    const void* lo_c, int win_c, float y_scale, float c_scale,
    const void* host_vals, int n_vals, const void* host_structure,
    int lms_identity, void* out, void* stream) {
  vrt::dovi::MidParams P;
  if (!vrt::dovi::params_of(host_vals, n_vals, host_structure, lms_identity,
                            y_scale, c_scale, &P) ||
      tile_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry G{
      w, h_out, tile_rows,
      HMap{hy, static_cast<const int*>(starts_y),
           static_cast<const float*>(taps_y), n_taps_y,
           static_cast<const int*>(lo_y), win_y},
      HMap{hc, static_cast<const int*>(starts_c),
           static_cast<const float*>(taps_c), n_taps_c,
           static_cast<const int*>(lo_c), win_c},
      vrt::Place{h_out, w, 0, 0}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vrt::dovi::route_of(y_dtype, c_dtype, P)) {
    case 1:
      return launch_dovi<vrt::dovi::C8Mid, uint16_t, float>(y, u, v, G, P,
                                                             batch, out, st);
    case 2:
      return launch_dovi<vrt::dovi::LmsMid, uint16_t, float>(y, u, v, G, P,
                                                              batch, out, st);
    default:
      return launch_dovi_runtime(y_dtype, c_dtype, y, u, v, G, P, batch, out,
                                 st);
  }
}
