// K9's kernels (csrc/cols3_tail.cu has their design) and their launches.
// The routes the port's paths run (route.cuh: C5, C8) are compiled each in
// its own translation unit, cols3_tail_c5.cu and cols3_tail_c8.cu, in
// parallel with cols3_tail.cu (the entry points and the runtime route) and
// cols3_tail_long.cu (the long-window kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "route.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace vrt {
namespace k9 {

constexpr int kVec = vrt::kGroup;                // columns a thread makes
constexpr int kColThreads = 32;                  // threadIdx.x
constexpr int kRowThreads = 8;                   // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 128 output columns a block
constexpr int kMaxTileRows = 1024;               // rows a block, at most
constexpr int kRegTaps = 8;                      // taps unrolled
constexpr int kMinBlocks = 4;                    // resident blocks an SM
constexpr size_t kSmemBudget = 232448;           // 227 KB

using vrt::Vec;

// One plane class's W map (the luma, or both chroma planes).
struct WMap {
  int w_in;                              // input columns
  const int* starts;                     // (w_out,); NULL: read directly
  const float* taps;                     // (n_taps, w_out)
  int n_taps;                            // 0: no W map
  const int* lo;                         // first input column of each tile
  int win;                               // columns of the widest span
};

struct Geometry {
  int h, w_out, tile_rows;
  WMap y, c;
  vrt::Place S;                          // the output surface
};

// Input elements staged a row: the span of ``win`` columns from a start
// rounded down to 16 bytes (K1's pitch_of).
template <typename T>
__host__ __device__ inline int pitch_of(int win) {
  constexpr int kChunk = 16 / sizeof(T);
  return (win + 2 * kChunk - 2) / kChunk * kChunk;
}

// Byte offsets of a block's shared memory: the spans of y, u and v, two
// rows of pitch_of(win) elements for each warp (none for a plane read
// directly), then each map's taps (n_taps x kTileCols floats) and starts
// (kTileCols ints).  kernels/deint.k9_smem_bytes mirrors ``bytes``.
struct Layout {
  size_t y, u, v, ty, sy, tc, sc, bytes;
};

template <typename TY, typename TC>
__host__ __device__ inline Layout layout(const Geometry& G) {
  Layout L;
  size_t o = 0;
  L.y = o;
  if (G.y.n_taps) {
    o += 2 * static_cast<size_t>(kRowThreads) * pitch_of<TY>(G.y.win) *
         sizeof(TY);
  }
  L.u = o;
  if (G.c.n_taps) {
    o += 2 * static_cast<size_t>(kRowThreads) * pitch_of<TC>(G.c.win) *
         sizeof(TC);
  }
  L.v = o;
  if (G.c.n_taps) {
    o += 2 * static_cast<size_t>(kRowThreads) * pitch_of<TC>(G.c.win) *
         sizeof(TC);
  }
  L.ty = o;
  o += static_cast<size_t>(G.y.n_taps) * kTileCols * sizeof(float);
  L.sy = o;
  if (G.y.n_taps) o += kTileCols * sizeof(int);
  L.tc = o;
  o += static_cast<size_t>(G.c.n_taps) * kTileCols * sizeof(float);
  L.sc = o;
  if (G.c.n_taps) o += kTileCols * sizeof(int);
  L.bytes = o;
  return L;
}

// ``count`` elements from ``src`` into ``dst``, by the 32 lanes of a warp:
// 16-byte cp.async copies where ``aligned`` (both addresses 16-byte
// aligned, count whole chunks), element copies where not.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ src,
                                          int count, bool aligned) {
  if (aligned) {
    constexpr int kChunk = 16 / sizeof(T);
    for (int k = threadIdx.x; k < count / kChunk; k += kColThreads) {
      vrt::cp_async16(dst + k * kChunk, src + k * kChunk);
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kColThreads) dst[k] = src[k];
  }
}

// The slot of tile column c in its thread's group of 4: a thread walks its
// columns starting at column (threadIdx.x / 8) % 4 (w_values), and the
// tile's starts and taps sit in that order, so one 16-byte read gives the
// 4 values the thread uses at one step.
__device__ __forceinline__ int walk_slot(int c) {
  const int rot = ((c / kVec) >> 3) & (kVec - 1);
  return (c & ~(kVec - 1)) + (((c & (kVec - 1)) - rot) & (kVec - 1));
}

// The tile's starts and taps of one map in walk order; a column past w_out
// gets the start w_in, so all its taps are skipped, and zero taps.
__device__ __forceinline__ void stage_taps(const WMap& M, int w_out,
                                           int col0, float* taps,
                                           int* starts) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  for (int i = tid; i < kTileCols; i += kThreads) {
    starts[walk_slot(i)] = col0 + i < w_out ? M.starts[col0 + i] : M.w_in;
  }
  for (int i = tid; i < M.n_taps * kTileCols; i += kThreads) {
    const int t = i / kTileCols;
    const int c = i - t * kTileCols;
    const int j = col0 + c;
    taps[t * kTileCols + walk_slot(c)] =
        j < w_out ? M.taps[static_cast<long long>(t) * w_out + j] : 0.f;
  }
}

// The taps of a thread's 4 columns at step j of its walk (span-relative
// starts s[j]), t = 0 .. T-1 in order from 0; with kGuard, a tap past the
// row's end (span-relative index lim) is skipped.
template <bool kGuard, typename T>
__device__ __forceinline__ void w_taps(const T* rs, const float* taps,
                                       const int s[kVec], int lim, int n_taps,
                                       int cl, float acc[kVec]) {
  auto step = [&](int t) {
    const Vec<float> wv =
        *reinterpret_cast<const Vec<float>*>(taps + t * kTileCols + cl);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (!kGuard || s[j] + t < lim) {
        acc[j] = fmaf(vrt::to_float(rs[s[j] + t]), wv.v[j], acc[j]);
      }
    }
  };
  if (n_taps <= kRegTaps) {
#pragma unroll
    for (int t = 0; t < kRegTaps; ++t) {
      if (t < n_taps) step(t);
    }
  } else {
    for (int t = 0; t < n_taps; ++t) step(t);
  }
}

// One plane's values at row ``row`` (tile row m), output columns
// col .. col + 3 (tile columns cl .. cl + 3): the W taps from the staged
// span, or the direct read times ``scale``.  Each column sums its taps
// t = 0 .. T-1 in order from 0, taps past the row's end skipped.  A thread
// walks its 4 columns starting at column (threadIdx.x / 8) % 4, so that
// at 2:1 the warp's reads of one tap fall in 16 distinct banks, not 4.
template <typename T>
__device__ __forceinline__ void w_values(const T* __restrict__ plane,
                                         const T* span, const WMap& M,
                                         const float* taps, const int* starts,
                                         int lo_al, int pitch, int m, int row,
                                         int w_out, int col, int cl,
                                         bool direct_vec, float scale,
                                         float out[kVec]) {
  if (M.n_taps == 0) {
    const T* p = plane + static_cast<long long>(row) * w_out + col;
    if (direct_vec && col + kVec <= w_out) {
      const Vec<T> x = *reinterpret_cast<const Vec<T>*>(p);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = vrt::mul(vrt::to_float(x.v[k]), scale);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = col + k < w_out ? vrt::mul(vrt::to_float(p[k]), scale) : 0.f;
      }
    }
    return;
  }
  const int rot = (threadIdx.x >> 3) & (kVec - 1);
  const T* rs = span + m * pitch;
  const int lim = M.w_in - lo_al;   // span-relative first column past the row
  const Vec<int> sv = *reinterpret_cast<const Vec<int>*>(starts + cl);
  int s[kVec], s_max = 0;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] = sv.v[j] - lo_al;
    s_max = max(s_max, s[j]);
    acc[j] = 0.f;
  }
  if (s_max + M.n_taps <= lim) {
    w_taps<false>(rs, taps, s, lim, M.n_taps, cl, acc);
  } else {
    w_taps<true>(rs, taps, s, lim, M.n_taps, cl, acc);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = vrt::pick(acc, (k - rot) & (kVec - 1));
}

// One plane's staged spans: where they sit, and where their rows start in
// the plane.
template <typename T>
struct Span {
  T* buf;                     // 2 rows x pitch for each warp
  const T* plane;             // this frame's plane
  int lo_al, pitch, count;    // first staged column, row pitch, columns
  bool aligned;
};

template <typename T>
__device__ __forceinline__ Span<T> span_of(unsigned char* smem, size_t off,
                                           const T* base, const T* plane,
                                           const WMap& M, int tile) {
  constexpr int kChunk = 16 / sizeof(T);
  Span<T> S{reinterpret_cast<T*>(smem + off), plane, 0, pitch_of<T>(M.win),
            0, vrt::rows_aligned16(base, M.w_in)};
  if (M.n_taps) {
    S.lo_al = M.lo[tile] - M.lo[tile] % kChunk;
    S.count = min(S.pitch, M.w_in - S.lo_al);
  }
  return S;
}

// The warp's buffer ``slot`` (0 or 1) of a plane's span.
template <typename T>
__device__ __forceinline__ T* warp_row(const Span<T>& S, int slot) {
  return S.buf + (threadIdx.y * 2 + slot) * S.pitch;
}

// Row ``row`` of a plane's span into the warp's buffer ``slot``.
template <typename T>
__device__ __forceinline__ void stage_plane_row(const Span<T>& S,
                                                const WMap& M, int row,
                                                int slot) {
  if (M.n_taps == 0) return;
  stage_row(warp_row(S, slot),
            S.plane + static_cast<long long>(row) * M.w_in + S.lo_al,
            S.count, S.aligned);
}

// At most 64 registers a thread, so that 4 blocks (32 warps) share an SM:
// the tail's dependent chains need the warps, and c8's route otherwise
// takes 98 registers and 2 blocks.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cols3_tail_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TY, TC>(G);
  float* ty = reinterpret_cast<float*>(smem + L.ty);
  int* sy = reinterpret_cast<int*>(smem + L.sy);
  float* tc = reinterpret_cast<float*>(smem + L.tc);
  int* sc = reinterpret_cast<int*>(smem + L.sc);

  const int tile = blockIdx.x;
  const int col0 = tile * kTileCols;
  const int r0 = blockIdx.y * G.tile_rows;
  const int rows = min(G.tile_rows, G.h - r0);
  const long long b = blockIdx.z;
  const TY* yb = y + b * G.h * G.y.w_in;
  const TC* ub = u + b * G.h * G.c.w_in;
  const TC* vb = v + b * G.h * G.c.w_in;
  const Span<TY> Sy = span_of(smem, L.y, y, yb, G.y, tile);
  const Span<TC> Su = span_of(smem, L.u, u, ub, G.c, tile);
  const Span<TC> Sv = span_of(smem, L.v, v, vb, G.c, tile);
  if (G.y.n_taps) stage_taps(G.y, G.w_out, col0, ty, sy);
  if (G.c.n_taps) stage_taps(G.c, G.w_out, col0, tc, sc);
  __syncthreads();

  const int cl = threadIdx.x * kVec;
  const int col = col0 + cl;
  const bool active = col < G.w_out;
  const bool w_vec = G.w_out % kVec == 0;
  const bool y_vec = w_vec && (reinterpret_cast<uintptr_t>(y) %
                               sizeof(Vec<TY>)) == 0;
  const bool c_vec = w_vec && (reinterpret_cast<uintptr_t>(u) %
                               sizeof(Vec<TC>)) == 0 &&
                     (reinterpret_cast<uintptr_t>(v) % sizeof(Vec<TC>)) == 0;
  const bool out_vec = vrt::place_vec(out, G.S, G.w_out);

  // Each warp makes rows warp, warp + 8, ... of the tile on its own: it
  // copies its next row's spans in while it runs the current one, and
  // waits only for its own copies, so the warps of a block and of the SM
  // drift apart and one warp's copies overlap the others' tails.
  const int warp = threadIdx.y;
  const int n = rows > warp ? (rows - warp + kRowThreads - 1) / kRowThreads
                            : 0;
  auto stage = [&](int i) {
    const int row = r0 + warp + i * kRowThreads;
    stage_plane_row(Sy, G.y, row, i & 1);
    stage_plane_row(Su, G.c, row, i & 1);
    stage_plane_row(Sv, G.c, row, i & 1);
  };
  if (n > 0) stage(0);
  vrt::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) stage(i + 1);
    vrt::cp_async_commit();
    vrt::cp_async_wait<1>();
    __syncwarp();
    if (active) {
      const int row = r0 + warp + i * kRowThreads;
      float yv[kVec], uv[kVec], vv[kVec];
      w_values(yb, warp_row(Sy, i & 1), G.y, ty, sy, Sy.lo_al, 0, 0, row,
               G.w_out, col, cl, y_vec, P.y_scale, yv);
      w_values(ub, warp_row(Su, i & 1), G.c, tc, sc, Su.lo_al, 0, 0, row,
               G.w_out, col, cl, c_vec, P.c_scale, uv);
      w_values(vb, warp_row(Sv, i & 1), G.c, tc, sc, Sv.lo_al, 0, 0, row,
               G.w_out, col, cl, c_vec, P.c_scale, vv);
      float c[kVec][3];
      vrt::tail_group<R>(P, yv, uv, vv, c);
      vrt::store_group<R>(c, P, out, b, G.S, G.w_out, row, col, out_vec);
    }
    __syncwarp();   // the buffer of row i is free for row i + 2
  }
}

// The long-window route's values of one plane at row ``row``, output
// columns col .. col + 3: each column's taps t = 0 .. T-1 in order from 0
// with taps past the row's end skipped, as w_values sums them, the inputs,
// starts and weights read straight from device memory through the
// read-only cache.
template <typename T>
__device__ __forceinline__ void w_values_long(const T* __restrict__ plane,
                                              const WMap& M, int row,
                                              int w_out, int col,
                                              bool direct_vec, float scale,
                                              float out[kVec]) {
  if (M.n_taps == 0) {
    w_values(plane, static_cast<const T*>(nullptr), M, nullptr, nullptr, 0,
             0, 0, row, w_out, col, 0, direct_vec, scale, out);
    return;
  }
  const T* rs = plane + static_cast<long long>(row) * M.w_in;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int j = col + k;
    float acc = 0.f;
    if (j < w_out) {
      const int s = __ldg(M.starts + j);
      for (int t = 0; t < M.n_taps; ++t) {
        if (s + t < M.w_in) {
          acc = fmaf(vrt::to_float(__ldg(rs + s + t)),
                     __ldg(M.taps + static_cast<long long>(t) * w_out + j),
                     acc);
        }
      }
    }
    out[k] = acc;
  }
}

// K9's long-window route: the kernel without the staged spans, for maps
// whose spans do not fit shared memory (a strong downscale).  Each warp
// makes rows warp, warp + 8, ... of the tile, each thread 4 output columns,
// every tap read through the read-only cache; the same tail and store as
// the staged kernel, so the outputs are its bit for bit.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads) cols3_tail_long_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    void* __restrict__ out) {
  const int col = blockIdx.x * kTileCols + threadIdx.x * kVec;
  if (col >= G.w_out) return;
  const int r0 = blockIdx.y * G.tile_rows;
  const int rows = min(G.tile_rows, G.h - r0);
  const long long b = blockIdx.z;
  const TY* yb = y + b * G.h * G.y.w_in;
  const TC* ub = u + b * G.h * G.c.w_in;
  const TC* vb = v + b * G.h * G.c.w_in;
  const bool w_vec = G.w_out % kVec == 0;
  const bool y_vec = w_vec && (reinterpret_cast<uintptr_t>(y) %
                               sizeof(Vec<TY>)) == 0;
  const bool c_vec = w_vec && (reinterpret_cast<uintptr_t>(u) %
                               sizeof(Vec<TC>)) == 0 &&
                     (reinterpret_cast<uintptr_t>(v) % sizeof(Vec<TC>)) == 0;
  const bool out_vec = vrt::place_vec(out, G.S, G.w_out);
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int row = r0 + m;
    float yv[kVec], uv[kVec], vv[kVec];
    w_values_long(yb, G.y, row, G.w_out, col, y_vec, P.y_scale, yv);
    w_values_long(ub, G.c, row, G.w_out, col, c_vec, P.c_scale, uv);
    w_values_long(vb, G.c, row, G.w_out, col, c_vec, P.c_scale, vv);
    float c[kVec][3];
    vrt::tail_group<R>(P, yv, uv, vv, c);
    vrt::store_group<R>(c, P, out, b, G.S, G.w_out, row, col, out_vec);
  }
}

template <typename R, typename TY, typename TC>
int launch(const void* y, const void* u, const void* v, const Geometry& G,
           const vrt::TailParams& P, int batch, void* out,
           cudaStream_t st) {
  const size_t smem = layout<TY, TC>(G).bytes;
  if (smem > kSmemBudget || G.tile_rows < 1 ||
      G.tile_rows > kMaxTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cols3_tail_kernel<R, TY, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.w_out + kTileCols - 1) / kTileCols,
                  (G.h + G.tile_rows - 1) / G.tile_rows, batch);
  cols3_tail_kernel<R, TY, TC><<<grid, dim3(kColThreads, kRowThreads), smem,
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
// at the plane dtypes' pair: RuntimeRoute compiled in cols3_tail_long.cu,
// RuntimeExtended in cols3_tail_ext.cu.
template <typename R>
int launch_long(int y_dtype, int c_dtype, const void* y, const void* u,
                const void* v, const Geometry& G, const vrt::TailParams& P,
                int batch, void* out, cudaStream_t st) {
  if (G.tile_rows < 1 || G.tile_rows > kMaxTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((G.w_out + kTileCols - 1) / kTileCols,
                  (G.h + G.tile_rows - 1) / G.tile_rows, batch);
  return vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    cols3_tail_long_kernel<R, TY, TC>
        <<<grid, dim3(kColThreads, kRowThreads), 0, st>>>(
            static_cast<const TY*>(y), static_cast<const TC*>(u),
            static_cast<const TC*>(v), G, P, out);
  });
}

}  // namespace k9
}  // namespace vrt

// The signature of one route's launch, for its explicit instantiation in
// the translation unit that compiles it and its extern declaration in the
// others.
#define VRT_K9_LAUNCH(R, TY, TC)                                          \
  int vrt::k9::launch<vrt::R, TY, TC>(                                     \
      const void*, const void*, const void*, const vrt::k9::Geometry&,     \
      const vrt::TailParams&, int, void*, cudaStream_t)
// The same for a runtime route's launch at every pair of plane dtypes
// (launch_runtime, launch_long).
#define VRT_K9_LAUNCH_ANY(FN, R)                                          \
  int vrt::k9::FN<vrt::R>(int, int, const void*, const void*, const void*, \
                          const vrt::k9::Geometry&, const vrt::TailParams&, \
                          int, void*, cudaStream_t)
