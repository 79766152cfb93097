// K2's Dolby Vision route (csrc/rows3_tail_dovi.cu has its design): the
// kernel and its launch.  c8's and the LMS route are compiled in
// rows3_tail_dovi.cu with the entry point, the runtime route at every pair
// of plane dtypes in rows3_tail_dovi_rt.cu, in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dovi_mid.cuh"
#include "rows3_tail.cuh"

namespace vrt {
namespace k2 {

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of a block's shared memory: K2's Layout (the windows of y,
// u and v, each map's taps and starts), then the curve scalars and the
// curve structure (filled by the routes that read them at run time), each
// 16-byte aligned.  kernels/resize.k2_dovi_smem_bytes mirrors ``bytes``.
struct DoviLayout {
  Layout base;
  size_t vals, curves, bytes;
};

template <typename TY, typename TC>
__host__ __device__ inline DoviLayout dovi_layout(const Geometry& G,
                                                  int n_vals) {
  DoviLayout D;
  D.base = layout<TY, TC>(G);
  size_t o = up16(D.base.bytes);
  D.vals = o;
  o += up16(static_cast<size_t>(n_vals) * sizeof(float));
  D.curves = o;
  o += up16(3 * sizeof(dovi::Curve));
  D.bytes = o;
  return D;
}

// Resident blocks an SM the launch bounds ask for: 3 on c8's light route
// (at most 80 registers), 4 on the others (64), whose convert runs one
// pixel at a time.
template <typename R>
struct DoviBlocks {
  static constexpr int value = R::kSideBySide ? 3 : 4;
};

// Stage A of the two-stage Dolby Vision form: K2's H taps of (Y, U, V) into
// the source rows, then the convert of dovi_mid.cuh on each pixel; planar
// float32 PQ R, G, B out, (3, batch, h_out, w).
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads, DoviBlocks<R>::value)
    rows3_tail_dovi_kernel(const TY* __restrict__ y, const TC* __restrict__ u,
                           const TC* __restrict__ v, const Geometry G,
                           const __grid_constant__ dovi::MidParams P,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DoviLayout D = dovi_layout<TY, TC>(G, P.n_vals);
  const Layout& L = D.base;
  TY* wy = reinterpret_cast<TY*>(smem + L.y);
  TC* wu = reinterpret_cast<TC*>(smem + L.u);
  TC* wv = reinterpret_cast<TC*>(smem + L.v);
  float* ty = reinterpret_cast<float*>(smem + L.ty);
  int* sy = reinterpret_cast<int*>(smem + L.sy);
  float* tc = reinterpret_cast<float*>(smem + L.tc);
  int* sc = reinterpret_cast<int*>(smem + L.sc);
  float* vals = reinterpret_cast<float*>(smem + D.vals);
  dovi::Curve* curves = reinterpret_cast<dovi::Curve*>(smem + D.curves);

  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  if constexpr (R::kRuntimeCurves) {
    for (int i = tid; i < P.n_vals; i += kThreads) vals[i] = P.vals[i];
    const int* src = reinterpret_cast<const int*>(P.curve);
    int* dst = reinterpret_cast<int*>(curves);
    for (int i = tid; i < static_cast<int>(3 * sizeof(dovi::Curve) / 4);
         i += kThreads) {
      dst[i] = src[i];
    }
  }

  const int col0 = blockIdx.x * kTileCols;
  const int tile = blockIdx.y;
  const int r0 = tile * G.tile_rows;
  const int rows = min(G.tile_rows, G.h_out - r0);
  const long long b = blockIdx.z, batch = gridDim.z;
  const TY* yb = y + b * G.y.h_in * G.w;
  const TC* ub = u + b * G.c.h_in * G.w;
  const TC* vb = v + b * G.c.h_in * G.w;
  int lo_y = 0, lo_c = 0;
  if (G.y.n_taps) {
    lo_y = G.y.lo[tile];
    stage_window(wy, yb, G.w, col0, lo_y, min(G.y.win, G.y.h_in - lo_y),
                 vrt::rows_aligned16(y, G.w));
    stage_taps(G.y, G.h_out, r0, G.tile_rows, ty, sy);
  }
  if (G.c.n_taps) {
    lo_c = G.c.lo[tile];
    const int n = min(G.c.win, G.c.h_in - lo_c);
    stage_window(wu, ub, G.w, col0, lo_c, n, vrt::rows_aligned16(u, G.w));
    stage_window(wv, vb, G.w, col0, lo_c, n, vrt::rows_aligned16(v, G.w));
    stage_taps(G.c, G.h_out, r0, G.tile_rows, tc, sc);
  }
  vrt::cp_async_wait_all();
  __syncthreads();

  const int col = col0 + threadIdx.x * kVec;
  if (col >= G.w) return;
  const bool w_vec = G.w % kVec == 0;
  const bool y_vec = w_vec && (reinterpret_cast<uintptr_t>(y) %
                               sizeof(Vec<TY>)) == 0;
  const bool c_vec = w_vec && (reinterpret_cast<uintptr_t>(u) %
                               sizeof(Vec<TC>)) == 0 &&
                     (reinterpret_cast<uintptr_t>(v) % sizeof(Vec<TC>)) == 0;
  const bool out_vec = w_vec && col + kVec <= G.w &&
                       (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const long long plane = batch * G.h_out * static_cast<long long>(G.w);

  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int r = r0 + m;
    float yv[kVec], uv[kVec], vv[kVec];
    h_values(yb, wy, G.y, ty, sy, lo_y, G.w, G.tile_rows, m, r, col, y_vec,
             P.y_scale, yv);
    h_values(ub, wu, G.c, tc, sc, lo_c, G.w, G.tile_rows, m, r, col, c_vec,
             P.c_scale, uv);
    h_values(vb, wv, G.c, tc, sc, lo_c, G.w, G.tile_rows, m, r, col, c_vec,
             P.c_scale, vv);
    float c[3][kVec];
    if constexpr (R::kSideBySide) {
      // c8's light route: the 4 pixels side by side
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float o[3];
        dovi::dovi_mid<R>(P, vals, curves, yv[j], uv[j], vv[j], o);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c[ch][j] = o[ch];
      }
    } else {
      // the long dependent chains: one pixel at a time, its results put
      // in place by selects (no local memory)
#pragma unroll 1
      for (int j = 0; j < kVec; ++j) {
        float o[3];
        dovi::dovi_mid<R>(P, vals, curves, vrt::pick(yv, j), vrt::pick(uv, j),
                          vrt::pick(vv, j), o);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (k == j) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) c[ch][k] = o[ch];
          }
        }
      }
    }
    float* o = out + (b * G.h_out + r) * static_cast<long long>(G.w) + col;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch, o += plane) {
      if (out_vec) {
        Vec<float> ov;
#pragma unroll
        for (int k = 0; k < kVec; ++k) ov.v[k] = c[ch][k];
        *reinterpret_cast<Vec<float>*>(o) = ov;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (col + k < G.w) o[k] = c[ch][k];
        }
      }
    }
  }
}

template <typename R, typename TY, typename TC>
int launch_dovi(const void* y, const void* u, const void* v,
                const Geometry& G, const dovi::MidParams& P, int batch,
                void* out, cudaStream_t st) {
  const size_t smem = dovi_layout<TY, TC>(G, P.n_vals).bytes;
  if (smem > kSmemBudget || G.tile_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows3_tail_dovi_kernel<R, TY, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.w + kTileCols - 1) / kTileCols,
                  (G.h_out + G.tile_rows - 1) / G.tile_rows, batch);
  rows3_tail_dovi_kernel<R, TY, TC>
      <<<grid, dim3(kColThreads, kRowThreads), smem, st>>>(
          static_cast<const TY*>(y), static_cast<const TC*>(u),
          static_cast<const TC*>(v), G, P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The runtime route's launch at the plane dtypes' pair (compiled in
// rows3_tail_dovi_rt.cu); an unknown code launches nothing and returns
// cudaErrorInvalidValue.
int launch_dovi_runtime(int y_dtype, int c_dtype, const void* y,
                        const void* u, const void* v, const Geometry& G,
                        const dovi::MidParams& P, int batch, void* out,
                        cudaStream_t st);

}  // namespace k2
}  // namespace vrt
