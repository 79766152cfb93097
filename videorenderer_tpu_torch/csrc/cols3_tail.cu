// K9: W-axis banded resize of (Y, U, V) plus the whole per-pixel tail, for
// Hopper (sm_90a) — K2 (rows3_tail.cu) with the resize axis swapped, for
// pipelines that resize H first (motion-adaptive deinterlacing).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: cols3_tail.  One
// thread per output pixel (b, row, col):
//   1. each plane's W pass: sum_t p[b, row, starts[col] + t] * taps[t, col]
//      in fp32 FMAs over a per-output-column tap table (kernels/resize.py:
//      plan_taps), or, for a plane with no W matrix, a direct read times its
//      scale;
//   2. the colour matrix (or none) and the correction (tail.cuh, shared with
//      K2);
//   3. quantization from the GLOBAL row and column, and the store: planar
//      float RGB or one R10G10B10A2 / RGBA8 dword (tail.cuh, epilogue.cuh).
// The plane dtypes (uint8, uint16, int16, float32) are template parameters.
//
// Bound.  At c5 (both fields of 16 frames, the float32 output of K7) each
// output pixel reads 6 luma taps and 2 x ~8 chroma taps of float32 (device
// memory delivers the three planes about once: 1.06 GB per batch) and
// writes one dword (265 MB).  Consecutive threads take consecutive output
// columns; their taps overlap, so a warp's loads hit a few contiguous
// sectors that L1 serves again to the next taps, and the tap weights are
// read coalesced.  The tail is K2's: the accurate transcendentals of the
// HLG -> SDR chain, each operation rounded on its own.  The TPU kernel's
// split-bf16 products and 128-lane tiles do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "tail.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float w_pass(const T* __restrict__ row, int w_in,
                                        int col,
                                        const int* __restrict__ starts,
                                        const float* __restrict__ taps,
                                        int n_taps, int w_out, float scale) {
  if (n_taps == 0) return vrt::mul(static_cast<float>(row[col]), scale);
  const int s = starts[col];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    const int i = s + t;
    if (i < w_in) {
      acc = fmaf(static_cast<float>(row[i]), taps[t * w_out + col], acc);
    }
  }
  return acc;
}

// grid: x = batch * h rows, y = column blocks of kThreads output columns
template <typename TY, typename TC>
__global__ void cols3_tail_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, int h, int wy, int wc, int w_out,
    const int* __restrict__ sy, const float* __restrict__ ty, int nty,
    const int* __restrict__ sc, const float* __restrict__ tc, int ntc,
    vrt::TailParams P, void* __restrict__ out) {
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= w_out) return;
  const long long r = blockIdx.x;           // b * h + row
  const long long b = r / h;
  const int row = static_cast<int>(r - b * h);
  const float yv = w_pass(y + r * wy, wy, col, sy, ty, nty, w_out, P.y_scale);
  const float uv = w_pass(u + r * wc, wc, col, sc, tc, ntc, w_out, P.c_scale);
  const float vv = w_pass(v + r * wc, wc, col, sc, tc, ntc, w_out, P.c_scale);
  float c[3];
  vrt::color_tail(P.tail, yv, uv, vv, c);
  vrt::store_pixel(c, P.quant, P.pack, out, b, h, w_out, row, col);
}

}  // namespace

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  n_taps_* == 0: that
// plane has no W matrix and is read directly (its width is w_out) times its
// scale.  ``host_mats`` is HOST memory: 12 floats of the colour matrix,
// row-major 3 x (m0 m1 m2 c), 9 of the gamut matrix, then the 5 scalars of
// the local tone map of selection ``tonemap`` (0: none).
extern "C" int vrt_cols3_tail(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int h, int wy, int wc, int w_out, const void* starts_y,
    const void* taps_y, int n_taps_y, const void* starts_c,
    const void* taps_c, int n_taps_c, float y_scale, float c_scale,
    const void* host_mats, int apply_matrix, int correction, int tonemap,
    float luminance_scale, int dither_bits, int pack, void* out,
    void* stream) {
  const vrt::TailParams P = vrt::make_tail_params(
      host_mats, apply_matrix, correction, tonemap, luminance_scale, y_scale,
      c_scale, dither_bits, pack);
  const dim3 grid(batch * h, (w_out + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    cols3_tail_kernel<TY, TC><<<grid, kThreads, 0, st>>>(
        static_cast<const TY*>(y), static_cast<const TC*>(u),
        static_cast<const TC*>(v), h, wy, wc, w_out,
        static_cast<const int*>(starts_y), static_cast<const float*>(taps_y),
        n_taps_y, static_cast<const int*>(starts_c),
        static_cast<const float*>(taps_c), n_taps_c, P, out);
  });
}
