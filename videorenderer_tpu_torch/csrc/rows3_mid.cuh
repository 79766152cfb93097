// K8's kernels (csrc/rows3_mid.cu has their design) and their launches.
// The routes the port's paths run (C8Mid, LmsMid) are compiled each in its
// own translation unit, rows3_mid_c8.cu and rows3_mid_lms.cu, in parallel
// with rows3_mid.cu (the entry points and the runtime route) and
// rows3_mid_long.cu (the long-window kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dovi_mid.cuh"
#include "epilogue.cuh"
#include "route.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace vrt {
namespace k8 {

// the convert (dovi_mid.cuh): MidParams, Curve, the routes, dovi_mid
using namespace ::vrt::dovi;

constexpr int kVec = vrt::kGroup;               // columns a thread makes
constexpr int kColThreads = 16;                 // threads across a tile row
constexpr int kRowThreads = 16;
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;   // 64 columns a block
constexpr int kTilesPerBlock = 4;   // consecutive row tiles a block walks
constexpr int kRegTaps = 8;         // in taps unrolled
constexpr size_t kSmemBudget = 232448;   // 227 KB

using vrt::Vec;

// One plane class's in map (the luma, or both chroma planes).
struct InMap {
  int h_in;                // rows of the plane
  const int* starts;       // (h_mid,); NULL: read directly
  const float* taps;       // (n_taps, h_mid)
  int n_taps;              // 0: no in map
  const int* lo;           // first input row each tile stages
  int win;                 // input rows a tile stages, at most
};

struct Geometry {
  int w, h_mid, h_out, tile_rows, n_tiles;
  InMap y, c;
  const int* so; const float* to; int nto;   // the out map; nto 0: none
  const int* tile_lo;      // first mid row of each tile's window
  int win;                 // mid rows of the widest window
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of a block's shared memory, each 16-byte aligned: the mid
// window (3 channels x win rows x kTileCols float32), the staged input rows
// of y, u and v (a plane read directly has none), the in taps and starts
// of each in map over the window's mid rows, the out taps and starts of
// the tile's rows, then the curve scalars and structure (filled by the
// runtime route; the LMS route reads them from the launch's parameter and
// leaves them unused).  kernels/deint.k8_smem_bytes mirrors ``bytes``.
struct Layout {
  size_t window, y, u, v, ty, sy, tc, sc, to, so, vals, curves, bytes;
};

template <typename TY, typename TC>
__host__ __device__ inline Layout layout(const Geometry& G, int n_vals) {
  Layout L;
  size_t o = 0;
  const size_t win = G.win, cols = kTileCols;
  L.window = o;
  o += up16(3 * win * cols * sizeof(float));
  L.y = o;
  if (G.y.n_taps) o += up16(G.y.win * cols * sizeof(TY));
  L.u = o;
  if (G.c.n_taps) o += up16(G.c.win * cols * sizeof(TC));
  L.v = o;
  if (G.c.n_taps) o += up16(G.c.win * cols * sizeof(TC));
  L.ty = o;
  o += up16(G.y.n_taps * win * sizeof(float));
  L.sy = o;
  if (G.y.n_taps) o += up16(win * sizeof(int));
  L.tc = o;
  o += up16(G.c.n_taps * win * sizeof(float));
  L.sc = o;
  if (G.c.n_taps) o += up16(win * sizeof(int));
  L.to = o;
  o += up16(static_cast<size_t>(G.nto) * G.tile_rows * sizeof(float));
  L.so = o;
  if (G.nto) o += up16(G.tile_rows * sizeof(int));
  L.vals = o;
  o += up16(n_vals * sizeof(float));
  L.curves = o;
  o += up16(3 * sizeof(Curve));
  L.bytes = o;
  return L;
}

using vrt::add;
using vrt::mul;

// Rows [lo, lo + rows) of a plane (clipped to its h_in rows), columns
// [col0, col0 + kTileCols) (clipped to w), into ``dst`` at a pitch of
// kTileCols: 16-byte cp.async copies where the rows are 16-byte aligned
// and the tile lies inside them, element copies where not.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ plane,
                                           int w, int h_in, int lo, int rows,
                                           int col0, bool aligned) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = kTileCols / kChunk;
  const int n_rows = min(rows, h_in - lo);
  const int n_cols = min(kTileCols, w - col0);
  const T* src = plane + static_cast<long long>(lo) * w + col0;
  if (aligned && n_cols == kTileCols) {
    for (int i = threadIdx.x; i < n_rows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, k = i - r * kPerRow;
      vrt::cp_async16(dst + r * kTileCols + k * kChunk,
                      src + static_cast<long long>(r) * w + k * kChunk);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * kTileCols; i += kThreads) {
      const int r = i / kTileCols, c = i - r * kTileCols;
      if (c < n_cols) dst[i] = src[static_cast<long long>(r) * w + c];
    }
  }
}

// A thread's 4 raw values of row ``row`` of a plane read directly; zeros
// past the row's end.  ``vec``: one vector load (the 4 columns lie inside
// the row and the rows are aligned to the vector).
template <typename T>
__device__ __forceinline__ Vec<T> load4(const T* __restrict__ plane, int w,
                                        int row, int col, bool vec) {
  const T* p = plane + static_cast<long long>(row) * w + col;
  Vec<T> x;
  if (vec) {
    x = *reinterpret_cast<const Vec<T>*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) x.v[k] = col + k < w ? p[k] : T(0);
  }
  return x;
}

// One plane's values at mid row m of the window, columns cl .. cl + 3 of
// the tile: its in taps over the staged rows (``rows``; starts relative to
// them in ``starts``, taps t at taps[t * win + m]), t = 0 .. T-1 in order
// from 0 with taps at or past the plane's last row (relative ``lim``)
// skipped; FMAs from 0 as the one-column-a-thread kernel did.
template <typename T>
__device__ __forceinline__ void in_values(const T* rows, const int* starts,
                                          const float* taps, int win, int m,
                                          int n_taps, int lim, int cl,
                                          float acc[kVec]) {
  const int s = starts[m];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  auto step = [&](int t) {
    if (s + t < lim) {
      const Vec<T> x =
          *reinterpret_cast<const Vec<T>*>(rows + (s + t) * kTileCols + cl);
      const float wt = taps[t * win + m];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        acc[k] = fmaf(vrt::to_float(x.v[k]), wt, acc[k]);
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

// One column's value of the same (the routes that convert one pixel at a
// time): column c of the tile.
template <typename T>
__device__ __forceinline__ float in_value(const T* rows, const int* starts,
                                          const float* taps, int win, int m,
                                          int n_taps, int lim, int c) {
  const int s = starts[m];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    if (s + t < lim) {
      acc = fmaf(vrt::to_float(rows[(s + t) * kTileCols + c]),
                 taps[t * win + m], acc);
    }
  }
  return acc;
}

// The tile's parameters: its first output row, its window of mid rows, and
// the first staged row of each in map.
struct Tile {
  int r0, rows, lo, n_win, y_lo, c_lo;
};

__device__ __forceinline__ Tile tile_of(const Geometry& G, int tile) {
  Tile t;
  t.r0 = tile * G.tile_rows;
  t.rows = min(G.tile_rows, G.h_out - t.r0);
  t.lo = G.nto ? G.tile_lo[tile] : t.r0;
  t.n_win = min(G.win, G.h_mid - t.lo);
  t.y_lo = G.y.n_taps ? G.y.lo[tile] : 0;
  t.c_lo = G.c.n_taps ? G.c.lo[tile] : 0;
  return t;
}

// An in map's starts (relative to the tile's staged rows) and taps over
// the tile's window, into shared memory.
__device__ __forceinline__ void stage_in_taps(const InMap& M, const Geometry& G,
                                              const Tile& T, int in_lo,
                                              float* taps, int* starts) {
  for (int m = threadIdx.x; m < T.n_win; m += kThreads) {
    starts[m] = M.starts[T.lo + m] - in_lo;
  }
  for (int i = threadIdx.x; i < M.n_taps * T.n_win; i += kThreads) {
    const int t = i / T.n_win, m = i - t * T.n_win;
    taps[t * G.win + m] = M.taps[static_cast<long long>(t) * G.h_mid + T.lo + m];
  }
}

// At most 80 registers a thread on the light route and the LMS route (3
// blocks of 256 an SM), 40 on the runtime route (6).  ``redo``: the device
// counter of the groups the LMS route runs again exactly (dovi_mid_group;
// null: none counted), the last parameter, so that no other parameter's
// offset moves and the other routes, which do not read it, keep their
// code.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads, R::kMinBlocks) rows3_mid_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G,
    const __grid_constant__ MidParams P, float* __restrict__ out,
    unsigned long long* redo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TY, TC>(G, P.n_vals);
  float* window = reinterpret_cast<float*>(smem + L.window);
  TY* ys = reinterpret_cast<TY*>(smem + L.y);
  TC* us = reinterpret_cast<TC*>(smem + L.u);
  TC* vs = reinterpret_cast<TC*>(smem + L.v);
  float* ty_s = reinterpret_cast<float*>(smem + L.ty);
  int* sy_s = reinterpret_cast<int*>(smem + L.sy);
  float* tc_s = reinterpret_cast<float*>(smem + L.tc);
  int* sc_s = reinterpret_cast<int*>(smem + L.sc);
  float* to_s = reinterpret_cast<float*>(smem + L.to);
  int* so_s = reinterpret_cast<int*>(smem + L.so);
  float* vals = reinterpret_cast<float*>(smem + L.vals);
  Curve* curves = reinterpret_cast<Curve*>(smem + L.curves);

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, tyd = tid / kColThreads;
  const int col0 = blockIdx.x * kTileCols;
  const int cl = tx * kVec, col = col0 + cl;
  const long long b = blockIdx.z, batch = gridDim.z;
  const int tile0 = blockIdx.y * kTilesPerBlock;
  const int n_tiles = min(kTilesPerBlock, G.n_tiles - tile0);
  const TY* yb = y + b * G.y.h_in * static_cast<long long>(G.w);
  const TC* ub = u + b * G.c.h_in * static_cast<long long>(G.w);
  const TC* vb = v + b * G.c.h_in * static_cast<long long>(G.w);
  const bool y_al = vrt::rows_aligned16(y, G.w);
  const bool c_al = vrt::rows_aligned16(u, G.w) && vrt::rows_aligned16(v, G.w);
  const bool in_row = col + kVec <= G.w;
  const bool y_vec = in_row && G.w % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(y) % sizeof(Vec<TY>) == 0;
  const bool c_vec = in_row && G.w % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(u) % sizeof(Vec<TC>) == 0 &&
                     reinterpret_cast<uintptr_t>(v) % sizeof(Vec<TC>) == 0;
  const bool out_vec = in_row && G.w % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;

  if constexpr (R::kRuntimeCurves && !R::kGroupMid) {
    for (int i = tid; i < P.n_vals; i += kThreads) vals[i] = P.vals[i];
    const int* src = reinterpret_cast<const int*>(P.curve);
    int* dst = reinterpret_cast<int*>(curves);
    for (int i = tid; i < static_cast<int>(3 * sizeof(Curve) / 4);
         i += kThreads) {
      dst[i] = src[i];
    }
  }

  // The tile's staged input rows (16-byte cp.async copies, one group) and
  // its in taps.
  auto stage = [&](const Tile& T) {
    if (G.y.n_taps) {
      stage_rows(ys, yb, G.w, G.y.h_in, T.y_lo, G.y.win, col0, y_al);
      stage_in_taps(G.y, G, T, T.y_lo, ty_s, sy_s);
    }
    if (G.c.n_taps) {
      stage_rows(us, ub, G.w, G.c.h_in, T.c_lo, G.c.win, col0, c_al);
      stage_rows(vs, vb, G.w, G.c.h_in, T.c_lo, G.c.win, col0, c_al);
      stage_in_taps(G.c, G, T, T.c_lo, tc_s, sc_s);
    }
    vrt::cp_async_commit();
  };

  Tile T = tile_of(G, tile0);
  stage(T);
  for (int k = 0; k < n_tiles; ++k) {
    // a luma plane read directly: the thread's first row's values, loaded
    // before the wait (the side-by-side routes)
    const int m0 = tyd;
    Vec<TY> y_next{};
    if ((R::kSideBySide || R::kGroupMid) && !G.y.n_taps && m0 < T.n_win) {
      y_next = load4(yb, G.w, T.lo + m0, col, y_vec);
    }
    vrt::cp_async_wait<0>();
    __syncthreads();   // (A) this tile's inputs are staged; the last out pass is done

    if (G.nto) {
      for (int i = tid; i < T.rows; i += kThreads) so_s[i] = G.so[T.r0 + i] - T.lo;
      for (int i = tid; i < G.nto * T.rows; i += kThreads) {
        const int t = i / T.rows, r = i - t * T.rows;
        to_s[t * G.tile_rows + r] =
            G.to[static_cast<long long>(t) * G.h_out + T.r0 + r];
      }
    }

    // the mid pass: each mid pixel of the window once
    const int plane = G.win * kTileCols;
    if constexpr (R::kSideBySide || R::kGroupMid) {
      // 4 adjacent columns a thread, a mid row each 16 rows
      for (int m = m0; m < T.n_win; m += kRowThreads) {
        const int row = T.lo + m;
        float yv[kVec], uv[kVec], vv[kVec];
        if (G.y.n_taps) {
          in_values(ys, sy_s, ty_s, G.win, m, G.y.n_taps, G.y.h_in - T.y_lo,
                    cl, yv);
        } else {
          const Vec<TY> x = y_next;
          if (m + kRowThreads < T.n_win) {
            y_next = load4(yb, G.w, row + kRowThreads, col, y_vec);
          }
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            yv[j] = mul(vrt::to_float(x.v[j]), P.y_scale);
          }
        }
        if (G.c.n_taps) {
          const int lim = G.c.h_in - T.c_lo;
          in_values(us, sc_s, tc_s, G.win, m, G.c.n_taps, lim, cl, uv);
          in_values(vs, sc_s, tc_s, G.win, m, G.c.n_taps, lim, cl, vv);
        } else {
          const Vec<TC> xu = load4(ub, G.w, row, col, c_vec);
          const Vec<TC> xv = load4(vb, G.w, row, col, c_vec);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            uv[j] = mul(vrt::to_float(xu.v[j]), P.c_scale);
            vv[j] = mul(vrt::to_float(xv.v[j]), P.c_scale);
          }
        }
        float c[kVec][3];
        if constexpr (R::kGroupMid) {
          dovi_mid_group(P, yv, uv, vv, c, redo);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            dovi_mid<R>(P, vals, curves, yv[j], uv[j], vv[j], c[j]);
          }
        }
        float* wrow = window + m * kTileCols + cl;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          Vec<float> o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) o.v[j] = c[j][ch];
          *reinterpret_cast<Vec<float>*>(wrow + ch * plane) = o;
        }
      }
    } else {
      // the window's pixels dealt out one at a time, a warp on 32 adjacent
      // columns of a row
      const int y_lim = G.y.h_in - T.y_lo, c_lim = G.c.h_in - T.c_lo;
      for (int p = tid; p < T.n_win * kTileCols; p += kThreads) {
        const int m = p / kTileCols, cp = p - m * kTileCols, cc = col0 + cp;
        const long long at = static_cast<long long>(T.lo + m) * G.w + cc;
        const bool in = cc < G.w;
        const float yv =
            G.y.n_taps ? in_value(ys, sy_s, ty_s, G.win, m, G.y.n_taps, y_lim, cp)
            : in       ? mul(vrt::to_float(yb[at]), P.y_scale)
                       : 0.f;
        float uv, vv;
        if (G.c.n_taps) {
          uv = in_value(us, sc_s, tc_s, G.win, m, G.c.n_taps, c_lim, cp);
          vv = in_value(vs, sc_s, tc_s, G.win, m, G.c.n_taps, c_lim, cp);
        } else {
          uv = in ? mul(vrt::to_float(ub[at]), P.c_scale) : 0.f;
          vv = in ? mul(vrt::to_float(vb[at]), P.c_scale) : 0.f;
        }
        float c[3];
        dovi_mid<R>(P, vals, curves, yv, uv, vv, c);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          window[ch * plane + m * kTileCols + cp] = c[ch];
        }
      }
    }
    __syncthreads();   // (B) the window is complete; the staged inputs are free

    // copy the next tile's inputs while this one's out taps run
    const Tile cur = T;
    if (k + 1 < n_tiles) {
      T = tile_of(G, tile0 + k + 1);
      stage(T);
    }

    // the out pass: each output row's taps over the window, t = 0 .. T-1
    // in order from 0, mid rows past h_mid skipped; three 16-byte stores
    for (int i = tyd; i < cur.rows; i += kRowThreads) {
      const int r = cur.r0 + i;
      float acc[3][kVec];
      if (G.nto == 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const Vec<float> x = *reinterpret_cast<const Vec<float>*>(
              window + ch * plane + i * kTileCols + cl);
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[ch][j] = x.v[j];
        }
      } else {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[ch][j] = 0.f;
        }
        const int s = so_s[i], lim = G.h_mid - cur.lo;
        for (int t = 0; t < G.nto; ++t) {
          if (s + t < lim) {
            const float wt = to_s[t * G.tile_rows + i];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const Vec<float> x = *reinterpret_cast<const Vec<float>*>(
                  window + ch * plane + (s + t) * kTileCols + cl);
#pragma unroll
              for (int j = 0; j < kVec; ++j) {
                acc[ch][j] = fmaf(x.v[j], wt, acc[ch][j]);
              }
            }
          }
        }
      }
      if (col >= G.w) continue;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float* o = out + ((ch * batch + b) * G.h_out + r) *
                             static_cast<long long>(G.w) + col;
        if (out_vec) {
          Vec<float> ov;
#pragma unroll
          for (int j = 0; j < kVec; ++j) ov.v[j] = acc[ch][j];
          *reinterpret_cast<Vec<float>*>(o) = ov;
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (col + j < G.w) o[j] = acc[ch][j];
          }
        }
      }
    }
  }
}

// The long-window route's value of one plane at mid row m, column cc: its
// in taps t = 0 .. T-1 in order from 0, taps at or past the plane's last
// row skipped, each input read straight from device memory through the
// read-only cache (in_value's sum); or the direct read times ``scale``.
template <typename T>
__device__ __forceinline__ float in_value_long(const T* __restrict__ plane,
                                               const InMap& M, int h_mid,
                                               int w, int m, int cc,
                                               float scale) {
  if (M.n_taps == 0) {
    return mul(vrt::to_float(__ldg(plane + static_cast<long long>(m) * w +
                                   cc)),
               scale);
  }
  const int s = __ldg(M.starts + m);
  float acc = 0.f;
  for (int t = 0; t < M.n_taps; ++t) {
    if (s + t < M.h_in) {
      acc = fmaf(
          vrt::to_float(__ldg(plane + static_cast<long long>(s + t) * w + cc)),
          __ldg(M.taps + static_cast<long long>(t) * h_mid + m), acc);
    }
  }
  return acc;
}

// K8's long-window route: no mid window in shared memory, for maps whose
// window does not fit even at one row a tile (a strong downscale: 2160 mid
// rows to 16 output rows reach 540 mid rows an output row).  Each thread
// makes 4 columns of its output rows: for each out tap it computes that mid
// row's pixel (the in taps read through the read-only cache, then
// dovi_mid), and sums the taps in the staged route's order with its guard,
// so the outputs are the staged route's bit for bit.  A mid pixel is
// computed once for each output row whose taps reach it, about 2 x the
// filter's radius times, which at such a ratio is less work than the mid
// rows between them that the staged route would compute and not use.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads) rows3_mid_long_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G,
    const __grid_constant__ MidParams P, float* __restrict__ out) {
  const int tx = threadIdx.x % kColThreads, tyd = threadIdx.x / kColThreads;
  const int col = blockIdx.x * kTileCols + tx * kVec;
  if (col >= G.w) return;
  const long long b = blockIdx.z, batch = gridDim.z;
  const int r0 = blockIdx.y * G.tile_rows;
  const int rows = min(G.tile_rows, G.h_out - r0);
  const TY* yb = y + b * G.y.h_in * static_cast<long long>(G.w);
  const TC* ub = u + b * G.c.h_in * static_cast<long long>(G.w);
  const TC* vb = v + b * G.c.h_in * static_cast<long long>(G.w);
  const bool out_vec = col + kVec <= G.w && G.w % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto mid = [&](int m, int cc, float c[3]) {
    const float yv = in_value_long(yb, G.y, G.h_mid, G.w, m, cc, P.y_scale);
    const float uv = in_value_long(ub, G.c, G.h_mid, G.w, m, cc, P.c_scale);
    const float vv = in_value_long(vb, G.c, G.h_mid, G.w, m, cc, P.c_scale);
    dovi_mid<R>(P, P.vals, P.curve, yv, uv, vv, c);
  };
  for (int i = tyd; i < rows; i += kRowThreads) {
    const int r = r0 + i;
    float acc[3][kVec];
#pragma unroll 1
    for (int j = 0; j < kVec; ++j) {
      const int cc = col + j;
      float a[3] = {0.f, 0.f, 0.f};
      if (cc < G.w) {
        if (G.nto == 0) {
          mid(r, cc, a);
        } else {
          const int s = __ldg(G.so + r);
          for (int t = 0; t < G.nto; ++t) {
            if (s + t < G.h_mid) {
              const float wt =
                  __ldg(G.to + static_cast<long long>(t) * G.h_out + r);
              float c[3];
              mid(s + t, cc, c);
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) a[ch] = fmaf(c[ch], wt, a[ch]);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) {
        if (jj == j) {
          acc[0][jj] = a[0];
          acc[1][jj] = a[1];
          acc[2][jj] = a[2];
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float* o = out + ((ch * batch + b) * G.h_out + r) *
                           static_cast<long long>(G.w) + col;
      if (out_vec) {
        Vec<float> ov;
#pragma unroll
        for (int j = 0; j < kVec; ++j) ov.v[j] = acc[ch][j];
        *reinterpret_cast<Vec<float>*>(o) = ov;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (col + j < G.w) o[j] = acc[ch][j];
        }
      }
    }
  }
}

// The long-window kernel's launch (no shared memory): compiled for the
// runtime route at every pair of plane dtypes, in rows3_mid_long.cu.
int launch_long(int y_dtype, int c_dtype, const void* y, const void* u,
                const void* v, const Geometry& G, const MidParams& P,
                int batch, void* out, cudaStream_t st);

template <typename R, typename TY, typename TC>
int launch(const void* y, const void* u, const void* v, const Geometry& G,
           const MidParams& P, int batch, void* out, void* redo,
           cudaStream_t st) {
  const size_t smem = layout<TY, TC>(G, P.n_vals).bytes;
  if (smem > kSmemBudget || G.tile_rows < 1 || G.n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows3_mid_kernel<R, TY, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.w + kTileCols - 1) / kTileCols,
                  (G.n_tiles + kTilesPerBlock - 1) / kTilesPerBlock, batch);
  rows3_mid_kernel<R, TY, TC><<<grid, kThreads, smem, st>>>(
      static_cast<const TY*>(y), static_cast<const TC*>(u),
      static_cast<const TC*>(v), G, P, static_cast<float*>(out),
      static_cast<unsigned long long*>(redo));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k8
}  // namespace vrt

// The signature of one route's launch, for its explicit instantiation in
// the translation unit that compiles it and its extern declaration in the
// others.
#define VRT_K8_LAUNCH(R, TY, TC)                                          \
  int vrt::k8::launch<vrt::k8::R, TY, TC>(                                 \
      const void*, const void*, const void*, const vrt::k8::Geometry&,     \
      const vrt::k8::MidParams&, int, void*, void*, cudaStream_t)
