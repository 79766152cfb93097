// K4's kernels (csrc/mega3_tail.cu has their design) and their launches.
// The routes are compiled each in its own translation unit:
// mega3_tail.cu (the entry points and the staged runtime route),
// mega3_tail_headline.cu, mega3_tail_c7.cu, mega3_tail_matrix.cu (the
// compiled routes of the headline's, c7's and the colour matrix's tails),
// mega3_tail_long.cu (the long-window kernel on the runtime route),
// mega3_tail_ext.cu and mega3_tail_ext_long.cu (the extended runtime
// route, staged and long-window) build in parallel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "route.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace vrt {
namespace k4 {

constexpr int kVec = vrt::kGroup;                // columns a thread makes
constexpr int kColThreads = 32;                  // threadIdx.x
constexpr int kRowThreads = 8;                   // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 128 output columns a block
constexpr int kPairs = kTileCols / 2;            // W pass: 2 columns a thread
constexpr int kPairRows = kThreads / kPairs;     // W pass: rows at once
constexpr int kRegTaps = 8;                      // W taps held in registers
constexpr int kRowBlock = 4;                     // W pass: rows a thread sums
                                                 // side by side
constexpr int kRingSlots = 3;                    // chunks of the ring: the
                                                 // copies of two in flight
constexpr int kLongRows = 2;                     // long-window: rows a thread
constexpr int kLongTileRows = kLongRows * kRowThreads;
constexpr size_t kSmemBudget = 232448;           // 227 KB

using vrt::Vec;

// One plane class's maps (the luma, or both chroma planes).  A plane with
// neither map is read straight from device memory (``direct``).
struct PlaneMaps {
  int h_in, w_in;
  const int* sx; const float* tx; int ntx;   // W map, 0 taps: none
  const int* span_lo; int span;              // first input column of each
                                             // strip, the widest span
  const int* sy; const float* ty; int nty;   // H map, 0 taps: none
  const int* lo; int win;                    // first input row of each
                                             // tile, the widest window
  __host__ __device__ bool direct() const { return ntx == 0 && nty == 0; }
};

struct Geometry {
  int h_out, w_out, tile_rows, chunk_rows;
  PlaneMaps y, c;
};

// Input elements staged a row: a W map's widest span from a start rounded
// down to 16 bytes (K1's pitch_of), or the strip's own kTileCols columns.
// kernels/resize.k4_smem_bytes mirrors it.
template <typename T>
__host__ __device__ inline int pitch_of(const PlaneMaps& M) {
  constexpr int kChunk = 16 / sizeof(T);
  if (M.ntx == 0) return kTileCols;
  return (M.span + 2 * kChunk - 2) / kChunk * kChunk;
}

// Byte offsets of a block's shared memory.  The staged route: the raw
// windows of y, u and v (win rows, or tile_rows for a plane without an H
// map, x the plane's pitch; none for a direct plane), their W-passed
// windows (the same rows x kTileCols floats), then each H map's taps
// (n_taps x tile_rows floats) and starts (tile_rows ints).  The long-window
// route: the ring of kRingSlots chunks of chunk_rows raw input rows (each as
// wide as the widest pitch of a staged plane), then one chunk of W-passed
// rows.  kernels/resize.k4_smem_bytes mirrors ``bytes``.
struct Layout {
  size_t slot, ry, ru, rv, y, u, v, ty, sy, tc, sc, bytes;
};

// The input rows a staged tile's window holds of a plane.
__host__ __device__ inline int window_rows(const PlaneMaps& M, int tile_rows) {
  return M.direct() ? 0 : M.nty ? M.win : tile_rows;
}

template <typename TY, typename TC>
__host__ __device__ inline Layout layout(const Geometry& G, bool long_window) {
  Layout L{};
  const size_t py = G.y.direct() ? 0 : pitch_of<TY>(G.y) * sizeof(TY);
  const size_t pc = G.c.direct() ? 0 : pitch_of<TC>(G.c) * sizeof(TC);
  const size_t frow = kTileCols * sizeof(float);
  size_t o = 0;
  if (long_window) {
    L.slot = (py > pc ? py : pc) * G.chunk_rows;
    o = kRingSlots * L.slot;
    L.y = o;
    L.bytes = o + frow * G.chunk_rows;
    return L;
  }
  const size_t ny = window_rows(G.y, G.tile_rows);
  const size_t nc = window_rows(G.c, G.tile_rows);
  L.ry = o;
  o += ny * py;
  L.ru = o;
  o += nc * pc;
  L.rv = o;
  o += nc * pc;
  L.y = o;
  o += ny * frow;
  L.u = o;
  o += nc * frow;
  L.v = o;
  o += nc * frow;
  L.ty = o;
  o += static_cast<size_t>(G.y.nty) * G.tile_rows * sizeof(float);
  L.sy = o;
  if (G.y.nty) o += static_cast<size_t>(G.tile_rows) * sizeof(int);
  L.tc = o;
  o += static_cast<size_t>(G.c.nty) * G.tile_rows * sizeof(float);
  L.sc = o;
  if (G.c.nty) o += static_cast<size_t>(G.tile_rows) * sizeof(int);
  L.bytes = o;
  return L;
}

// Rows row0 .. row0 + n - 1 of one frame's plane (w columns), columns
// lo_al .. lo_al + pitch - 1 (those inside the row), into ``buf`` (pitch
// elements a row): 16-byte cp.async copies where ``aligned`` (the rows and
// lo_al are whole 16-byte chunks), element copies where not.  Elements
// past the row are left as they are: the W pass never reads them.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ plane,
                                           int w, int row0, int n, int lo_al,
                                           int pitch, bool aligned) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  const int count = min(pitch, w - lo_al);
  const T* src = plane + static_cast<long long>(row0) * w + lo_al;
  if (aligned) {
    constexpr int kChunk = 16 / sizeof(T);
    const int chunks = count / kChunk;
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int r = i / chunks;
      const int k = i - r * chunks;
      vrt::cp_async16(buf + r * pitch + k * kChunk,
                      src + static_cast<long long>(r) * w + k * kChunk);
    }
  } else {
    for (int i = tid; i < n * count; i += kThreads) {
      const int r = i / count;
      const int k = i - r * count;
      buf[r * pitch + k] = src[static_cast<long long>(r) * w + k];
    }
  }
}

// The W pass of a thread's 2 output columns, K1's: their window-relative
// starts and (up to kRegTaps) taps in registers for every row the block
// stages, the FMAs t = 0 .. T-1 in order with the i < w_in guard, up to
// kRowBlock rows side by side; maps with more taps read the weights
// through L1 in the same order, one read for those rows.  A plane
// without a W map is its own column times ``scale``.  Lanes 16-31 run
// their second column first, so at 2:1 a warp's reads of one tap fall in
// distinct shared-memory banks.
template <typename T>
struct WCols {
  const float* tx;
  int ntx, w_out, j, first, lim;
  int s[2];
  bool ok[2];
  float wt[2][kRegTaps];
  float scale;

  __device__ __forceinline__ WCols(const PlaneMaps& M, int w_out_, int col0,
                                   int lo_al, float scale_)
      : tx(M.tx), ntx(M.ntx), w_out(w_out_), scale(scale_) {
    const int pair = (threadIdx.y * kColThreads + threadIdx.x) % kPairs;
    j = col0 + 2 * pair;
    first = (pair >> 4) & 1;
    lim = M.w_in - lo_al;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int jq = j + (q ^ first);
      ok[q] = jq < w_out;
      s[q] = !ok[q] ? 0 : ntx ? M.sx[jq] - lo_al : jq - lo_al;
#pragma unroll
      for (int t = 0; t < kRegTaps; ++t) {
        wt[q][t] = ok[q] && t < ntx && ntx <= kRegTaps
                       ? tx[t * w_out + jq] : 0.f;
      }
    }
  }

  // The W-passed values of rows 0 .. nk - 1 (nk <= kRowBlock) of ``raw``
  // (``step`` elements apart) at the thread's 2 columns: for each value its
  // FMAs in tap order; the rows' sums run side by side, so one tap weight
  // read through L1 serves them all.
  __device__ __forceinline__ void values(const T* raw, int step, int nk,
                                         float res[kRowBlock][2]) const {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < kRowBlock; ++k) res[k][q] = 0.f;
      if (!ok[q]) continue;
      if (ntx == 0) {
#pragma unroll
        for (int k = 0; k < kRowBlock; ++k) {
          if (k < nk) {
            res[k][q] = vrt::mul(vrt::to_float(raw[k * step + s[q]]), scale);
          }
        }
      } else if (ntx <= kRegTaps) {
#pragma unroll
        for (int t = 0; t < kRegTaps; ++t) {
          const int i = s[q] + t;
          if (t < ntx && i < lim) {
#pragma unroll
            for (int k = 0; k < kRowBlock; ++k) {
              if (k < nk) {
                res[k][q] = fmaf(vrt::to_float(raw[k * step + i]), wt[q][t],
                                 res[k][q]);
              }
            }
          }
        }
      } else {
        const int jq = j + (q ^ first);
#pragma unroll 4
        for (int t = 0; t < ntx; ++t) {
          const int i = s[q] + t;
          if (i < lim) {
            const float w = tx[t * w_out + jq];
#pragma unroll
            for (int k = 0; k < kRowBlock; ++k) {
              if (k < nk) {
                res[k][q] = fmaf(vrt::to_float(raw[k * step + i]), w,
                                 res[k][q]);
              }
            }
          }
        }
      }
    }
  }

  // rows 0 .. n - 1 of ``raw`` (pitch elements a row) into ``dst``
  // (kTileCols floats a row), one 8-byte store a thread and row
  __device__ __forceinline__ void apply(const T* raw, int pitch, int n,
                                        float* dst) const {
    const int tid = threadIdx.y * kColThreads + threadIdx.x;
    const int pair = tid % kPairs;
    for (int r = tid / kPairs; r < n; r += kPairRows * kRowBlock) {
      const int nk = min(kRowBlock, (n - r + kPairRows - 1) / kPairRows);
      float res[kRowBlock][2];
      values(raw + r * pitch, kPairRows * pitch, nk, res);
#pragma unroll
      for (int k = 0; k < kRowBlock; ++k) {
        if (k < nk) {
          *reinterpret_cast<float2*>(dst + (r + k * kPairRows) * kTileCols +
                                     2 * pair) =
              first ? make_float2(res[k][1], res[k][0])
                    : make_float2(res[k][0], res[k][1]);
        }
      }
    }
  }
};

// One staged plane of a block: its frame's codes, the input rows its tile
// reads (lo .. lo + n - 1; none for a direct plane), its staged columns
// (from lo_al, pitch a row), whether they copy in 16-byte pieces, and its
// chunks of ``cr`` rows.
template <typename T>
struct PlaneRows {
  const T* plane;
  int lo, n, lo_al, pitch, chunks;
  bool aligned;

  __device__ __forceinline__ PlaneRows(const T* plane_, const PlaneMaps& M,
                                       int strip, int lo_, int n_, int cr)
      : plane(plane_), lo(lo_), n(M.direct() ? 0 : n_) {
    constexpr int kChunk = 16 / sizeof(T);
    const int lo_col = M.ntx ? M.span_lo[strip] : strip * kTileCols;
    lo_al = lo_col - lo_col % kChunk;
    pitch = pitch_of<T>(M);
    chunks = n > 0 ? (n + cr - 1) / cr : 0;
    aligned = vrt::rows_aligned16(plane, M.w_in);
  }

  // chunk k (chunk_rows ``cr`` rows) into ``buf``
  __device__ __forceinline__ void stage(void* buf, int w, int k,
                                        int cr) const {
    stage_rows(static_cast<T*>(buf), plane, w, lo + k * cr,
               min(cr, n - k * cr), lo_al, pitch, aligned);
  }
};

// The long-window route's input: streams the staged planes' input rows,
// y's then u's then v's, through the ring in chunks of G.chunk_rows rows,
// the copies of the next kRingSlots - 1 chunks in flight while the block
// W-passes one, into ``fc``; then calls after(p, first row, rows) (plane
// p: 0 y, 1 u, 2 v) once the whole block has written the chunk.
template <typename TY, typename TC, typename After>
__device__ __forceinline__ void stream_planes(
    const PlaneRows<TY>& Y, const PlaneRows<TC>& U, const PlaneRows<TC>& V,
    const Geometry& G, int col0, const vrt::TailParams& P,
    unsigned char* ring, size_t slot, float* fc, After&& after) {
  const int cr = G.chunk_rows;
  const int cy = Y.chunks, cc = U.chunks, total = cy + 2 * cc;
  const WCols<TY> wy(G.y, G.w_out, col0, Y.lo_al, P.y_scale);
  const WCols<TC> wc(G.c, G.w_out, col0, U.lo_al, P.c_scale);
  // job k: plane p, its chunk kp
  auto job = [&](int k, int* kp) {
    if (k < cy) {
      *kp = k;
      return 0;
    }
    *kp = k - cy < cc ? k - cy : k - cy - cc;
    return k - cy < cc ? 1 : 2;
  };
  auto issue = [&](int k) {
    if (k < total) {
      int kp;
      const int p = job(k, &kp);
      void* buf = ring + (k % kRingSlots) * slot;
      if (p == 0) {
        Y.stage(buf, G.y.w_in, kp, cr);
      } else {
        (p == 1 ? U : V).stage(buf, G.c.w_in, kp, cr);
      }
    }
    vrt::cp_async_commit();
  };
  for (int k = 0; k < kRingSlots - 1; ++k) issue(k);
  for (int k = 0; k < total; ++k) {
    issue(k + kRingSlots - 1);
    vrt::cp_async_wait<kRingSlots - 1>();
    __syncthreads();
    int kp;
    const int p = job(k, &kp);
    const void* buf = ring + (k % kRingSlots) * slot;
    const int rows = min(cr, (p == 0 ? Y.n : U.n) - kp * cr);
    if (p == 0) {
      wy.apply(static_cast<const TY*>(buf), Y.pitch, rows, fc);
    } else {
      wc.apply(static_cast<const TC*>(buf), U.pitch, rows, fc);
    }
    __syncthreads();
    after(p, (p == 0 ? Y.lo : U.lo) + kp * cr, rows);
  }
}

// The input rows a tile reads of a plane: its H map's window, or its own
// rows (no H map: the plane is h_out rows tall).
__device__ __forceinline__ void window_of(const PlaneMaps& M, int h_out,
                                          int tile, int r0, int rows,
                                          int* lo, int* n) {
  if (M.nty) {
    *lo = M.lo[tile];
    *n = min(M.win, M.h_in - *lo);
  } else {
    *lo = r0;
    *n = rows;
  }
}

// The tile's starts and taps of one H map (rows past h_out zero).
__device__ __forceinline__ void stage_taps(const PlaneMaps& M, int h_out,
                                           int r0, int tile_rows, float* taps,
                                           int* starts) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  for (int i = tid; i < tile_rows; i += kThreads) {
    starts[i] = r0 + i < h_out ? M.sy[r0 + i] : 0;
  }
  for (int i = tid; i < M.nty * tile_rows; i += kThreads) {
    const int t = i / tile_rows;
    const int r = r0 + (i - t * tile_rows);
    taps[i] = r < h_out ? M.ty[static_cast<long long>(t) * h_out + r] : 0.f;
  }
}

// A direct plane's values at output row r, columns col .. col + 3: its
// codes times ``scale``, 4-wide vector loads where ``vec``.
template <typename T>
__device__ __forceinline__ void direct_values(const T* __restrict__ plane,
                                              int w, int r, int col, bool vec,
                                              float scale, float out[kVec]) {
  const T* p = plane + static_cast<long long>(r) * w + col;
  if (vec && col + kVec <= w) {
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
}

// One staged plane's values at output row r (tile row m), the thread's 4
// columns: the H taps over the W-passed window from shared memory, in
// order, with the i < h_in guard; or, with no H map, the window's row m.
__device__ __forceinline__ void h_values(const float* win, const PlaneMaps& M,
                                         const float* taps, const int* starts,
                                         int lo, int tile_rows, int m,
                                         float out[kVec]) {
  const float* base = win + threadIdx.x * kVec;
  if (M.nty == 0) {
    const float4 x = *reinterpret_cast<const float4*>(base + m * kTileCols);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    return;
  }
  const int s = starts[m];
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = 0.f;
  for (int t = 0; t < M.nty; ++t) {
    const int i = s + t;
    if (i < M.h_in) {
      const float wt = taps[t * tile_rows + m];
      const float4 x =
          *reinterpret_cast<const float4*>(base + (i - lo) * kTileCols);
      out[0] = fmaf(x.x, wt, out[0]);
      out[1] = fmaf(x.y, wt, out[1]);
      out[2] = fmaf(x.z, wt, out[2]);
      out[3] = fmaf(x.w, wt, out[3]);
    }
  }
}

// Whether a direct plane's rows take 4-wide vector loads.
template <typename T>
__device__ __forceinline__ bool direct_vec(const T* p, int w) {
  return w % kVec == 0 &&
         (reinterpret_cast<uintptr_t>(p) % sizeof(Vec<T>)) == 0;
}

// The staged route.  grid: x = strips of kTileCols output columns, y =
// tiles of G.tile_rows output rows, z = frames; block (32, 8), at most 80
// registers a thread so that three blocks share an SM.  Each staged
// plane's whole raw window is copied into shared memory at once, a commit
// group a plane, and W-passed into its float window there as soon as its
// copies have landed; then each thread runs the H taps of 4 consecutive
// columns of its rows, the tail of route R and one 16-byte store a
// channel.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads, 3) mega3_tail_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TY, TC>(G, false);
  float* wy = reinterpret_cast<float*>(smem + L.y);
  float* wu = reinterpret_cast<float*>(smem + L.u);
  float* wv = reinterpret_cast<float*>(smem + L.v);
  float* ty = reinterpret_cast<float*>(smem + L.ty);
  int* sy = reinterpret_cast<int*>(smem + L.sy);
  float* tc = reinterpret_cast<float*>(smem + L.tc);
  int* sc = reinterpret_cast<int*>(smem + L.sc);
  TY* ry = reinterpret_cast<TY*>(smem + L.ry);
  TC* ru = reinterpret_cast<TC*>(smem + L.ru);
  TC* rv = reinterpret_cast<TC*>(smem + L.rv);

  const int strip = blockIdx.x;
  const int col0 = strip * kTileCols;
  const int tile = blockIdx.y;
  const int r0 = tile * G.tile_rows;
  const int rows = min(G.tile_rows, G.h_out - r0);
  const long long b = blockIdx.z;
  const TY* yb = y + b * G.y.h_in * G.y.w_in;
  const TC* ub = u + b * G.c.h_in * G.c.w_in;
  const TC* vb = v + b * G.c.h_in * G.c.w_in;
  int lo_y, lo_c, n_y, n_c;
  window_of(G.y, G.h_out, tile, r0, rows, &lo_y, &n_y);
  window_of(G.c, G.h_out, tile, r0, rows, &lo_c, &n_c);
  const PlaneRows<TY> Y(yb, G.y, strip, lo_y, n_y, n_y);
  const PlaneRows<TC> U(ub, G.c, strip, lo_c, n_c, n_c);
  const PlaneRows<TC> V(vb, G.c, strip, lo_c, n_c, n_c);
  if (Y.n) Y.stage(ry, G.y.w_in, 0, Y.n);
  vrt::cp_async_commit();
  if (U.n) U.stage(ru, G.c.w_in, 0, U.n);
  vrt::cp_async_commit();
  if (V.n) V.stage(rv, G.c.w_in, 0, V.n);
  vrt::cp_async_commit();
  if (G.y.nty) stage_taps(G.y, G.h_out, r0, G.tile_rows, ty, sy);
  if (G.c.nty) stage_taps(G.c, G.h_out, r0, G.tile_rows, tc, sc);
  const WCols<TY> wcy(G.y, G.w_out, col0, Y.lo_al, P.y_scale);
  const WCols<TC> wcc(G.c, G.w_out, col0, U.lo_al, P.c_scale);
  vrt::cp_async_wait<2>();
  __syncthreads();
  if (Y.n) wcy.apply(ry, Y.pitch, Y.n, wy);
  vrt::cp_async_wait<1>();
  __syncthreads();
  if (U.n) wcc.apply(ru, U.pitch, U.n, wu);
  vrt::cp_async_wait<0>();
  __syncthreads();
  if (V.n) wcc.apply(rv, V.pitch, V.n, wv);
  __syncthreads();

  const int col = col0 + threadIdx.x * kVec;
  if (col >= G.w_out) return;
  const bool y_vec = direct_vec(y, G.w_out);
  const bool c_vec = direct_vec(u, G.w_out) && direct_vec(v, G.w_out);
  const vrt::Place S{G.h_out, G.w_out, 0, 0};
  const bool out_vec = vrt::place_vec(out, S, G.w_out);
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int r = r0 + m;
    float yv[kVec], uv[kVec], vv[kVec];
    if (G.y.direct()) {
      direct_values(yb, G.w_out, r, col, y_vec, P.y_scale, yv);
    } else {
      h_values(wy, G.y, ty, sy, lo_y, G.tile_rows, m, yv);
    }
    if (G.c.direct()) {
      direct_values(ub, G.w_out, r, col, c_vec, P.c_scale, uv);
      direct_values(vb, G.w_out, r, col, c_vec, P.c_scale, vv);
    } else {
      h_values(wu, G.c, tc, sc, lo_c, G.tile_rows, m, uv);
      h_values(wv, G.c, tc, sc, lo_c, G.tile_rows, m, vv);
    }
    float c[kVec][3];
    vrt::tail_group<R>(P, yv, uv, vv, c);
    vrt::store_group<R>(c, P, out, b, S, G.w_out, r, col, out_vec);
  }
}

// The long-window route's H taps of one plane over a chunk of W-passed rows
// c0 .. c0 + n - 1 in ``fc``: each of the thread's kLongRows output rows
// adds the taps whose input rows lie in the chunk, in tap order, to its
// sums (rows arrive in order, so every sum runs the staged route's FMAs in
// its order); with no H map the row is its own input row.
__device__ __forceinline__ void h_accumulate(const float* fc,
                                             const PlaneMaps& M, int h_out,
                                             int r0, int c0, int n,
                                             float acc[kLongRows][kVec]) {
  const float* base = fc + threadIdx.x * kVec;
#pragma unroll
  for (int j = 0; j < kLongRows; ++j) {
    const int r = r0 + threadIdx.y + j * kRowThreads;
    if (r >= h_out) continue;
    if (M.nty == 0) {
      if (r >= c0 && r < c0 + n) {
        const float4 x =
            *reinterpret_cast<const float4*>(base + (r - c0) * kTileCols);
        acc[j][0] = x.x; acc[j][1] = x.y; acc[j][2] = x.z; acc[j][3] = x.w;
      }
      continue;
    }
    const int s = __ldg(M.sy + r);
    const int t1 = min(M.nty, c0 + n - s);
    for (int t = max(0, c0 - s); t < t1; ++t) {
      const float wt = __ldg(M.ty + static_cast<long long>(t) * h_out + r);
      const float4 x = *reinterpret_cast<const float4*>(
          base + (s + t - c0) * kTileCols);
      acc[j][0] = fmaf(x.x, wt, acc[j][0]);
      acc[j][1] = fmaf(x.y, wt, acc[j][1]);
      acc[j][2] = fmaf(x.z, wt, acc[j][2]);
      acc[j][3] = fmaf(x.w, wt, acc[j][3]);
    }
  }
}

// The long-window route, for maps whose W-passed windows do not fit shared
// memory (a strong downscale: a thumbnail of a 4K frame).  A block makes
// kLongTileRows output rows x kTileCols columns; the staged planes' windows
// stream through the ring (stream_planes), one chunk of W-passed rows at a
// time, and each thread adds the chunk's rows to the H sums of its
// kLongRows rows x 4 columns in registers; then the tail and the store.
// The outputs are the staged route's bit for bit.
template <typename R, typename TY, typename TC>
__global__ void __launch_bounds__(kThreads, 2) mega3_tail_long_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TY, TC>(G, true);
  float* fc = reinterpret_cast<float*>(smem + L.y);
  const int col0 = blockIdx.x * kTileCols;
  const int tile = blockIdx.y;
  const int r0 = tile * kLongTileRows;
  const int rows = min(kLongTileRows, G.h_out - r0);
  const long long b = blockIdx.z;
  const TY* yb = y + b * G.y.h_in * G.y.w_in;
  const TC* ub = u + b * G.c.h_in * G.c.w_in;
  const TC* vb = v + b * G.c.h_in * G.c.w_in;
  float ya[kLongRows][kVec] = {}, ua[kLongRows][kVec] = {},
        va[kLongRows][kVec] = {};
  int lo_y, lo_c, n_y, n_c;
  window_of(G.y, G.h_out, tile, r0, rows, &lo_y, &n_y);
  window_of(G.c, G.h_out, tile, r0, rows, &lo_c, &n_c);
  stream_planes(PlaneRows<TY>(yb, G.y, blockIdx.x, lo_y, n_y, G.chunk_rows),
                PlaneRows<TC>(ub, G.c, blockIdx.x, lo_c, n_c, G.chunk_rows),
                PlaneRows<TC>(vb, G.c, blockIdx.x, lo_c, n_c, G.chunk_rows),
                G,
                col0, P, smem, L.slot, fc, [&](int p, int c0, int nr) {
                  if (p == 0) {
                    h_accumulate(fc, G.y, G.h_out, r0, c0, nr, ya);
                  } else if (p == 1) {
                    h_accumulate(fc, G.c, G.h_out, r0, c0, nr, ua);
                  } else {
                    h_accumulate(fc, G.c, G.h_out, r0, c0, nr, va);
                  }
                });
  const int col = col0 + threadIdx.x * kVec;
  if (col >= G.w_out) return;
  const bool y_vec = direct_vec(y, G.w_out);
  const bool c_vec = direct_vec(u, G.w_out) && direct_vec(v, G.w_out);
  const vrt::Place S{G.h_out, G.w_out, 0, 0};
  const bool out_vec = vrt::place_vec(out, S, G.w_out);
#pragma unroll
  for (int j = 0; j < kLongRows; ++j) {
    const int r = r0 + threadIdx.y + j * kRowThreads;
    if (r >= G.h_out) break;
    float yv[kVec], uv[kVec], vv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      yv[k] = ya[j][k];
      uv[k] = ua[j][k];
      vv[k] = va[j][k];
    }
    if (G.y.direct()) direct_values(yb, G.w_out, r, col, y_vec, P.y_scale, yv);
    if (G.c.direct()) {
      direct_values(ub, G.w_out, r, col, c_vec, P.c_scale, uv);
      direct_values(vb, G.w_out, r, col, c_vec, P.c_scale, vv);
    }
    float c[kVec][3];
    vrt::tail_group<R>(P, yv, uv, vv, c);
    vrt::store_group<R>(c, P, out, b, S, G.w_out, r, col, out_vec);
  }
}

// The staged or the long-window kernel, instantiating only the one named.
template <typename R, typename TY, typename TC, bool kLong>
constexpr auto kernel_of() {
  if constexpr (kLong) {
    return mega3_tail_long_kernel<R, TY, TC>;
  } else {
    return mega3_tail_kernel<R, TY, TC>;
  }
}

// One launch of the staged (kLong false) or long-window kernel on route R
// at the plane types; cudaErrorInvalidValue for a layout over kSmemBudget
// or a long-window launch whose tile is not kLongTileRows rows.
template <typename R, typename TY, typename TC, bool kLong>
int launch(const void* y, const void* u, const void* v, const Geometry& G,
           const vrt::TailParams& P, int batch, float* out, cudaStream_t st) {
  const size_t smem = layout<TY, TC>(G, kLong).bytes;
  if (smem > kSmemBudget || G.tile_rows < 1 ||
      (kLong && (G.tile_rows != kLongTileRows || G.chunk_rows < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = kernel_of<R, TY, TC, kLong>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.w_out + kTileCols - 1) / kTileCols,
                  (G.h_out + G.tile_rows - 1) / G.tile_rows, batch);
  kernel<<<grid, dim3(kColThreads, kRowThreads), smem, st>>>(
      static_cast<const TY*>(y), static_cast<const TC*>(u),
      static_cast<const TC*>(v), G, P, out);
  return static_cast<int>(cudaGetLastError());
}

// The launch on the runtime route R (RuntimeRoute or RuntimeExtended) at
// the plane dtypes' pair; an unknown code launches nothing and returns
// cudaErrorInvalidValue.
template <typename R, bool kLong>
int launch_runtime(int y_dtype, int c_dtype, const void* y, const void* u,
                   const void* v, const Geometry& G, const vrt::TailParams& P,
                   int batch, float* out, cudaStream_t st) {
  int err = 0;
  bool known = false;
  vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    known = true;
    err = launch<R, TY, TC, kLong>(y, u, v, G, P, batch, out, st);
  });
  return known ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace k4
}  // namespace vrt

// The signature of one compiled route's staged launch, for its explicit
// instantiation in the translation unit that compiles it and its extern
// declaration in the others.
#define VRT_K4_LAUNCH(R, TY, TC)                                          \
  int vrt::k4::launch<vrt::R, TY, TC, false>(                          \
      const void*, const void*, const void*, const vrt::k4::Geometry&,     \
      const vrt::TailParams&, int, float*, cudaStream_t)
// The same for a runtime route's launch, staged or long-window, at every
// pair of plane dtypes.
#define VRT_K4_LAUNCH_ANY(R, LONG)                                        \
  int vrt::k4::launch_runtime<vrt::R, LONG>(                              \
      int, int, const void*, const void*, const void*,                    \
      const vrt::k4::Geometry&, const vrt::TailParams&, int, float*,      \
      cudaStream_t)
