// K5: the one-pass 2D Jinc2 resample with anti-ringing of float32 planes,
// for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/jinc2_pallas.py: jinc2_resize_fused
// (body _make_kernel).  The Pallas kernel ran the weights as a low-rank SVD
// expansion (five banded bf16 matrix products per tile, a 1e-4 singular-value
// cutoff) because Mosaic has no gather; here one thread per output pixel
// (plane, row, col) gathers its 16 source taps directly, computes their 16
// weights (jinc2.cuh), normalises, applies anti-ringing, then the optional
// epilogue: ordered dither from the GLOBAL row and column, or rounding.
//
// Bound: arithmetic.  Each output reads 16 taps that mostly hit the L1
// cache (neighbouring threads share them) and writes 4 bytes, but computes
// 16 accurate sqrtf, 32 sinf and 16 divisions.  Per-phase weight tables
// (the weights repeat with the phase periods of the two axes: 2x2 phases at
// 2x, 32x9 for the rotation geometry) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "jinc2.cuh"

namespace {

constexpr int kBx = 32, kBy = 8;

__global__ void jinc2_resize_kernel(const float* __restrict__ x, int h, int w,
                                    int oh, int ow,
                                    const int* __restrict__ by,
                                    const float* __restrict__ d2y,
                                    const int* __restrict__ bx,
                                    const float* __restrict__ d2x,
                                    vrt::Quant quant, float* __restrict__ out) {
  const int col = blockIdx.x * kBx + threadIdx.x;
  const int row = blockIdx.y * kBy + threadIdx.y;
  if (col >= ow || row >= oh) return;
  const long long p = blockIdx.z;
  const float* xp = x + p * h * w;

  float dy[4], dx[4];
  int rows[4], cols[4];
  const int r0 = by[row] - 1, c0 = bx[col] - 1;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    dy[o] = d2y[o * oh + row];
    dx[o] = d2x[o * ow + col];
    rows[o] = min(max(r0 + o, 0), h - 1);
    cols[o] = min(max(c0 + o, 0), w - 1);
  }
  float wt[16], t[16];
  const float wsum = vrt::jinc2_weights(dy, dx, wt);
#pragma unroll
  for (int jo = 0; jo < 4; ++jo) {
    const float* xr = xp + static_cast<long long>(rows[jo]) * w;
#pragma unroll
    for (int io = 0; io < 4; ++io) t[jo * 4 + io] = __ldg(xr + cols[io]);
  }
  const float res = vrt::jinc2_resolve(t, wt, wsum);
  out[(p * oh + row) * ow + col] = vrt::quantize(res, quant, row, col);
}

}  // namespace

// x: (planes, h, w) float32; out: (planes, oh, ow) float32.  by/bx (oh,)
// and (ow,) int32, d2y/d2x (4, oh) and (4, ow) float32: the per-axis tables
// of ops/scale.jinc2_axis_tables.  dither_bits: +b ordered dither, -b
// rounding, 0 none.
extern "C" int vrt_jinc2_resize(const void* x, int planes, int h, int w,
                                int oh, int ow, const void* by,
                                const void* d2y, const void* bx,
                                const void* d2x, int dither_bits, void* out,
                                void* stream) {
  const dim3 block(kBx, kBy);
  const dim3 grid((ow + kBx - 1) / kBx, (oh + kBy - 1) / kBy, planes);
  jinc2_resize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), h, w, oh, ow, static_cast<const int*>(by),
      static_cast<const float*>(d2y), static_cast<const int*>(bx),
      static_cast<const float*>(d2x), vrt::make_quant(dither_bits),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
