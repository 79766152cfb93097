// K2's kernel (csrc/rows3_tail.cu has its design), its launch, and the
// routes the port's paths run, compiled each in its own translation unit:
// rows3_tail.cu (the entry points, the runtime route, the light routes),
// rows3_tail_headline.cu, rows3_tail_c7.cu and rows3_tail_hlg.cu build in
// parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace vrt {
namespace k2 {

constexpr int kVec = 4;                          // columns a thread makes
constexpr int kColThreads = 32;                  // threadIdx.x
constexpr int kRowThreads = 8;                   // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 128 columns a block
constexpr size_t kSmemBudget = 232448;           // 227 KB

template <typename T>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

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

// A tail route fixed at compile time: colour matrix (0/1), correction,
// tone-map selection, quantization mode and pack; vrt::kRuntime in a field
// reads that flag from the launch's parameters.
constexpr int kRt = vrt::kRuntime;

template <int M, int C, int TM, int Q, int PK>
struct Route {
  static constexpr int kMat = M, kCorr = C, kTm = TM, kQuant = Q, kPack = PK;
  static constexpr bool kReadsFlags = M == kRt;
};

using RuntimeRoute = Route<kRt, kRt, kRt, kRt, kRt>;

// a[k] through selects, so an array indexed by a loop that is not unrolled
// stays in registers
__device__ __forceinline__ float pick(const float a[kVec], int k) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < kVec; ++j) v = k == j ? a[j] : v;
  return v;
}

// The tail of the thread's pixels one at a time, dividing with __fdiv_rn:
// the runtime route, and a compiled route's rare second pass.
template <typename R>
__device__ __forceinline__ void tail_exact(const vrt::TailParams& P,
                                           const float yv[kVec],
                                           const float uv[kVec],
                                           const float vv[kVec],
                                           float c[kVec][3]) {
#pragma unroll 1
  for (int k = 0; k < kVec; ++k) {
    float ck[3];
    vrt::color_tail<R::kMat, R::kCorr, R::kTm>(P.tail, pick(yv, k),
                                               pick(uv, k), pick(vv, k), ck);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j == k) {
        c[j][0] = ck[0];
        c[j][1] = ck[1];
        c[j][2] = ck[2];
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
  const bool out_vec = w_vec && (reinterpret_cast<uintptr_t>(out) %
                                 sizeof(Vec<float>)) == 0;
  const int pack = R::kPack != kRt ? R::kPack : P.pack;

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
    if constexpr (R::kReadsFlags) {
      tail_exact<R>(P, yv, uv, vv, c);
    } else {
      // the 4 pixels' tails side by side, with one check for all their
      // divisions; a group with an operand out of CheckedDiv's range runs
      // its tail again, exactly
      vrt::CheckedDiv div;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        vrt::color_tail<R::kMat, R::kCorr, R::kTm>(P.tail, yv[k], uv[k],
                                                   vv[k], c[k], div);
      }
      if (!div.ok) tail_exact<R>(P, yv, uv, vv, c);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      vrt::quantize3<R::kQuant>(c[k], P.quant, r, col + k);
    }
    const long long px = (b * G.h_out + r) * G.w + col;
    if (pack != vrt::kPackNone) {
      uint32_t wd[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) wd[k] = vrt::pack_word<R::kPack>(c[k], pack);
      uint32_t* o = static_cast<uint32_t*>(out) + px;
      if (out_vec && col + kVec <= G.w) {
        Vec<uint32_t> ov;
#pragma unroll
        for (int k = 0; k < kVec; ++k) ov.v[k] = wd[k];
        *reinterpret_cast<Vec<uint32_t>*>(o) = ov;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (col + k < G.w) o[k] = wd[k];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float* o = static_cast<float*>(out) +
                   ((b * 3 + i) * G.h_out + r) * G.w + col;
        if (out_vec && col + kVec <= G.w) {
          Vec<float> ov;
#pragma unroll
          for (int k = 0; k < kVec; ++k) ov.v[k] = c[k][i];
          *reinterpret_cast<Vec<float>*>(o) = ov;
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (col + k < G.w) o[k] = c[k][i];
          }
        }
      }
    }
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

// The routes the port's paths give K2 (pipeline._make_tail_epilogue,
// cmat_epilogue, torch_headline_micro's stages).
// the headline: PQ -> SDR, 10-bit ordered dither, R10G10B10A2
using Headline = Route<1, kCorrPqToSdr, kTmNone, kQuantDither, kPackRgb10a2>;
// the same, planar float (the stage split's tailNoPack)
using HeadlineFloat = Route<1, kCorrPqToSdr, kTmNone, kQuantDither, kPackNone>;
// c1: no correction, 8-bit ordered dither, RGBA8
using C1 = Route<1, kCorrNone, kTmNone, kQuantDither, kPackRgba8>;
// c5 single rate: HLG -> SDR, 8-bit ordered dither, RGBA8
using C5 = Route<1, kCorrHlgToSdr, kTmNone, kQuantDither, kPackRgba8>;
// c7: the BT.2390 local tone map, 10-bit dither, R10G10B10A2; and planar
using C7 = Route<1, kCorrNone, kTmBt2390, kQuantDither, kPackRgb10a2>;
using C7Float = Route<1, kCorrNone, kTmBt2390, kQuantDither, kPackNone>;
// HLG passthrough: HLG -> PQ, 10-bit dither, R10G10B10A2
using HlgToPq = Route<1, kCorrHlgToPq, kTmNone, kQuantDither, kPackRgb10a2>;
// the colour matrix only: planar float (the staged convert, c3 rotation
// 270) and R10G10B10A2 (the stage split's tailID)
using MatrixFloat = Route<1, kCorrNone, kTmNone, kQuantNone, kPackNone>;
using MatrixRgb10 = Route<1, kCorrNone, kTmNone, kQuantNone, kPackRgb10a2>;
// no matrix: the H taps and the store (the stage split's tailH)
using PlanesRgb10 = Route<0, kCorrNone, kTmNone, kQuantNone, kPackRgb10a2>;

}  // namespace k2
}  // namespace vrt

// The signature of one route's launch, for its explicit instantiation in
// the translation unit that compiles it and its extern declaration in the
// others.
#define VRT_K2_LAUNCH(R, TY, TC)                                          \
  int vrt::k2::launch<vrt::k2::R, TY, TC>(                                 \
      const void*, const void*, const void*, const vrt::k2::Geometry&,     \
      const vrt::TailParams&, int, void*, cudaStream_t)
