// K2's kernels (csrc/rows3_tail.cu has their design) and their launches.
// The routes the port's paths run (route.cuh) are compiled each in its own
// translation unit: rows3_tail.cu (the entry points, the runtime route, the
// light routes), rows3_tail_headline.cu, rows3_tail_c7.cu,
// rows3_tail_hlg.cu, rows3_tail_long.cu (the long-window kernel) and
// rows3_tail_ext.cu (the extended runtime route, staged and long-window)
// build in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "route.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace vrt {
namespace k2 {

constexpr int kVec = vrt::kGroup;                // columns a thread makes
constexpr int kColThreads = 32;                  // threadIdx.x
constexpr int kRowThreads = 8;                   // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 128 columns a block
constexpr size_t kSmemBudget = 232448;           // 227 KB

using vrt::Vec;

// One plane class's H map (the luma, or both chroma planes).
struct HMap {
  int h_in;                              // input rows
  const int* starts;                     // (h_out,); NULL: read directly
  const float* taps;                     // (n_taps, h_out)
  int n_taps;                            // 0: no H map
  const int* lo;                         // first input row of each tile
  int win;                               // rows of the widest window
};

struct Geometry {
  int w, h_out, tile_rows;
  HMap y, c;
  vrt::Place S;                          // the output surface
};

// Byte offsets of a block's shared memory: the windows of y, u and v
// (win rows x kTileCols columns each, none for a plane read directly), then
// each map's taps (n_taps x tile_rows floats) and starts (tile_rows ints).
// kernels/resize.k2_smem_bytes mirrors ``bytes``.
struct Layout {
  size_t y, u, v, ty, sy, tc, sc, bytes;
};

template <typename TY, typename TC>
__host__ __device__ inline Layout layout(const Geometry& G) {
  Layout L;
  size_t o = 0;
  L.y = o;
  if (G.y.n_taps) o += static_cast<size_t>(G.y.win) * kTileCols * sizeof(TY);
  L.u = o;
  if (G.c.n_taps) o += static_cast<size_t>(G.c.win) * kTileCols * sizeof(TC);
  L.v = o;
  if (G.c.n_taps) o += static_cast<size_t>(G.c.win) * kTileCols * sizeof(TC);
  L.ty = o;
  o += static_cast<size_t>(G.y.n_taps) * G.tile_rows * sizeof(float);
  L.sy = o;
  if (G.y.n_taps) o += static_cast<size_t>(G.tile_rows) * sizeof(int);
  L.tc = o;
  o += static_cast<size_t>(G.c.n_taps) * G.tile_rows * sizeof(float);
  L.sc = o;
  if (G.c.n_taps) o += static_cast<size_t>(G.tile_rows) * sizeof(int);
  L.bytes = o;
  return L;
}

// Rows lo .. lo + n - 1, columns col0 .. col0 + kTileCols - 1 of one frame's
// plane (w columns) into ``win`` (kTileCols a row); columns past w are zero.
template <typename T>
__device__ __forceinline__ void stage_window(T* win,
                                             const T* __restrict__ plane,
                                             int w, int col0, int lo, int n,
                                             bool aligned) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  if (aligned) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kChunks = kTileCols / kChunk;
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int k = i - r * kChunks;
      const int col = col0 + k * kChunk;
      T* d = win + r * kTileCols + k * kChunk;
      if (col < w) {
        vrt::cp_async16(d, plane + static_cast<long long>(lo + r) * w + col);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = tid; i < n * kTileCols; i += kThreads) {
      const int r = i / kTileCols;
      const int col = col0 + (i - r * kTileCols);
      win[i] = col < w ? plane[static_cast<long long>(lo + r) * w + col]
                       : T(0);
    }
  }
}

// The tile's starts and taps of one map (rows past h_out zero).
__device__ __forceinline__ void stage_taps(const HMap& M, int h_out, int r0,
                                           int tile_rows, float* taps,
                                           int* starts) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  for (int i = tid; i < tile_rows; i += kThreads) {
    starts[i] = r0 + i < h_out ? M.starts[r0 + i] : 0;
  }
  for (int i = tid; i < M.n_taps * tile_rows; i += kThreads) {
    const int t = i / tile_rows;
    const int r = r0 + (i - t * tile_rows);
    taps[i] = r < h_out ? M.taps[static_cast<long long>(t) * h_out + r] : 0.f;
  }
}

// One plane's values at output row r (tile row m), columns col .. col + 3:
// the H taps from the staged window, or the direct read times ``scale``.
template <typename T>
__device__ __forceinline__ void h_values(const T* __restrict__ plane,
                                         const T* win, const HMap& M,
                                         const float* taps, const int* starts,
                                         int lo, int w, int tile_rows, int m,
                                         int r, int col, bool direct_vec,
                                         float scale, float out[kVec]) {
  if (M.n_taps == 0) {
    const T* p = plane + static_cast<long long>(r) * w + col;
    if (direct_vec && col + kVec <= w) {
      const Vec<T> x = *reinterpret_cast<const Vec<T>*>(p);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = vrt::mul(vrt::to_float(x.v[k]), scale);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = col + k < w ? vrt::mul(vrt::to_float(p[k]), scale) : 0.f;
      }
    }
    return;
  }
  const int s = starts[m];
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = 0.f;
  const T* base = win + threadIdx.x * kVec;
  for (int t = 0; t < M.n_taps; ++t) {
    const int i = s + t;
    if (i < M.h_in) {
      const float wt = taps[t * tile_rows + m];
      const Vec<T> x =
          *reinterpret_cast<const Vec<T>*>(base + (i - lo) * kTileCols);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = fmaf(vrt::to_float(x.v[k]), wt, out[k]);
      }
    }
  }
}

template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads) rows3_tail_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TY, TC>(G);
  TY* wy = reinterpret_cast<TY*>(smem + L.y);
  TC* wu = reinterpret_cast<TC*>(smem + L.u);
  TC* wv = reinterpret_cast<TC*>(smem + L.v);
  float* ty = reinterpret_cast<float*>(smem + L.ty);
  int* sy = reinterpret_cast<int*>(smem + L.sy);
  float* tc = reinterpret_cast<float*>(smem + L.tc);
  int* sc = reinterpret_cast<int*>(smem + L.sc);

  const int col0 = blockIdx.x * kTileCols;
  const int tile = blockIdx.y;
  const int r0 = tile * G.tile_rows;
  const int rows = min(G.tile_rows, G.h_out - r0);
  const long long b = blockIdx.z;
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
  const bool out_vec = vrt::place_vec(out, G.S, G.w);

  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int r = r0 + m;
    float yv[kVec], uv[kVec], vv[kVec];
    h_values(yb, wy, G.y, ty, sy, lo_y, G.w, G.tile_rows, m, r, col, y_vec,
             P.y_scale, yv);
    h_values(ub, wu, G.c, tc, sc, lo_c, G.w, G.tile_rows, m, r, col, c_vec,
             P.c_scale, uv);
    h_values(vb, wv, G.c, tc, sc, lo_c, G.w, G.tile_rows, m, r, col, c_vec,
             P.c_scale, vv);
    float c[kVec][3];
    vrt::tail_group<R>(P, yv, uv, vv, c);
    vrt::store_group<R>(c, P, out, b, G.S, G.w, r, col, out_vec);
  }
}

// The long-window route's values of one plane at output row r, columns
// col .. col + 3: h_values's taps in the same order with the same r < h_in
// guard, each tap's row read straight from device memory through the
// read-only cache (4-wide vector loads where ``vec``), the starts and
// weights too (one address a warp: a broadcast).
template <typename T>
__device__ __forceinline__ void h_values_long(const T* __restrict__ plane,
                                              const HMap& M, int w, int h_out,
                                              int r, int col, bool vec,
                                              float scale, float out[kVec]) {
  if (M.n_taps == 0) {
    h_values(plane, static_cast<const T*>(nullptr), M, nullptr, nullptr, 0, w,
             0, 0, r, col, vec, scale, out);
    return;
  }
  const int s = __ldg(M.starts + r);
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = 0.f;
  for (int t = 0; t < M.n_taps; ++t) {
    const int i = s + t;
    if (i < M.h_in) {
      const float wt = __ldg(M.taps + static_cast<long long>(t) * h_out + r);
      const T* p = plane + static_cast<long long>(i) * w + col;
      Vec<T> x;
      if (vec && col + kVec <= w) {
        x = vrt::ldg_as<Vec<T>>(p);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          x.v[k] = col + k < w ? __ldg(p + k) : T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = fmaf(vrt::to_float(x.v[k]), wt, out[k]);
      }
    }
  }
}

// K2's long-window route: the staged kernel without the staging, for maps
// whose windows do not fit shared memory (a strong downscale, whose
// consecutive output rows' windows barely overlap, so staging would buy
// little).  Each thread makes 4 columns of the tile's rows as the staged
// kernel does, reading every tap through the read-only cache, then the same
// tail and store: the outputs are the staged route's bit for bit.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads) rows3_tail_long_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    void* __restrict__ out) {
  const int col = blockIdx.x * kTileCols + threadIdx.x * kVec;
  if (col >= G.w) return;
  const int r0 = blockIdx.y * G.tile_rows;
  const int rows = min(G.tile_rows, G.h_out - r0);
  const long long b = blockIdx.z;
  const TY* yb = y + b * G.y.h_in * G.w;
  const TC* ub = u + b * G.c.h_in * G.w;
  const TC* vb = v + b * G.c.h_in * G.w;
  const bool w_vec = G.w % kVec == 0;
  const bool y_vec = w_vec && (reinterpret_cast<uintptr_t>(y) %
                               sizeof(Vec<TY>)) == 0;
  const bool c_vec = w_vec && (reinterpret_cast<uintptr_t>(u) %
                               sizeof(Vec<TC>)) == 0 &&
                     (reinterpret_cast<uintptr_t>(v) % sizeof(Vec<TC>)) == 0;
  const bool out_vec = vrt::place_vec(out, G.S, G.w);
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int r = r0 + m;
    float yv[kVec], uv[kVec], vv[kVec];
    h_values_long(yb, G.y, G.w, G.h_out, r, col, y_vec, P.y_scale, yv);
    h_values_long(ub, G.c, G.w, G.h_out, r, col, c_vec, P.c_scale, uv);
    h_values_long(vb, G.c, G.w, G.h_out, r, col, c_vec, P.c_scale, vv);
    float c[kVec][3];
    vrt::tail_group<R>(P, yv, uv, vv, c);
    vrt::store_group<R>(c, P, out, b, G.S, G.w, r, col, out_vec);
  }
}

template <typename R, typename TY, typename TC>
int launch(const void* y, const void* u, const void* v, const Geometry& G,
           const vrt::TailParams& P, int batch, void* out,
           cudaStream_t st) {
  const size_t smem = layout<TY, TC>(G).bytes;
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows3_tail_kernel<R, TY, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.w + kTileCols - 1) / kTileCols,
                  (G.h_out + G.tile_rows - 1) / G.tile_rows, batch);
  rows3_tail_kernel<R, TY, TC><<<grid, dim3(kColThreads, kRowThreads), smem,
                                 st>>>(
      static_cast<const TY*>(y), static_cast<const TC*>(u),
      static_cast<const TC*>(v), G, P, out);
  return static_cast<int>(cudaGetLastError());
}

// The staged kernel's launch on the runtime route R (RuntimeRoute or
// RuntimeExtended) at the plane dtypes' pair; an unknown code launches
// nothing and returns cudaErrorInvalidValue.
template <typename R>
int launch_runtime(int y_dtype, int c_dtype, const void* y, const void* u,
                   const void* v, const Geometry& G, const vrt::TailParams& P,
                   int batch, void* out, cudaStream_t st) {
  int err = 0;
  bool known = false;
  vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    known = true;
    err = launch<R, TY, TC>(y, u, v, G, P, batch, out, st);
  });
  return known ? err : static_cast<int>(cudaErrorInvalidValue);
}

// The long-window kernel's launch (no shared memory) on the runtime route R
// at the plane dtypes' pair: RuntimeRoute compiled in rows3_tail_long.cu,
// RuntimeExtended in rows3_tail_ext.cu.
template <typename R>
int launch_long(int y_dtype, int c_dtype, const void* y, const void* u,
                const void* v, const Geometry& G, const vrt::TailParams& P,
                int batch, void* out, cudaStream_t st) {
  if (G.tile_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((G.w + kTileCols - 1) / kTileCols,
                  (G.h_out + G.tile_rows - 1) / G.tile_rows, batch);
  return vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    rows3_tail_long_kernel<R, TY, TC>
        <<<grid, dim3(kColThreads, kRowThreads), 0, st>>>(
            static_cast<const TY*>(y), static_cast<const TC*>(u),
            static_cast<const TC*>(v), G, P, out);
  });
}

}  // namespace k2
}  // namespace vrt

// The signature of one route's launch, for its explicit instantiation in
// the translation unit that compiles it and its extern declaration in the
// others.
#define VRT_K2_LAUNCH(R, TY, TC)                                          \
  int vrt::k2::launch<vrt::R, TY, TC>(                                 \
      const void*, const void*, const void*, const vrt::k2::Geometry&,     \
      const vrt::TailParams&, int, void*, cudaStream_t)
// The same for a runtime route's launch at every pair of plane dtypes
// (launch_runtime, launch_long).
#define VRT_K2_LAUNCH_ANY(FN, R)                                          \
  int vrt::k2::FN<vrt::R>(int, int, const void*, const void*, const void*, \
                          const vrt::k2::Geometry&, const vrt::TailParams&, \
                          int, void*, cudaStream_t)
