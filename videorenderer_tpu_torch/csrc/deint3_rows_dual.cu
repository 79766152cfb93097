// K7: motion-adaptive deinterlace of both fields fused into the banded
// H-axis resize of (Y, U, V), for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: deint3_rows_dual
// (the select is deint_pallas._deint_fields).  From the raw (prev, cur,
// next) planes, each output (b, m, col) of a plane and field is
// sum_t field[starts[m] + t] * taps[t, m] over a per-output-row tap table
// (kernels/resize.py: plan_taps, the normalisation folded into the taps), in
// fp32 FMAs, t = 0 .. T-1 in order from 0, stopping at the first row past
// the plane.  The deinterlaced value of input row r of a field is
//   cur[r] on a row of the kept field;
//   cur + (bob - cur) * ramp on a row of the other field, bob the mean of
//   its vertical neighbours, clamped at the plane's edges (the last row of
//   the top field's reconstruction averages row H - 2 twice; row 0 of the
//   bottom field's averages row 1 twice), and ramp the motion ramp
//   clip((|next - prev| - thr) / thr, 0, 1) of that row.
// The select rounds every operation on its own (__fsub_rn, __fdiv_rn,
// __fmul_rn, __fadd_rn) in the order of the torch plain version, so the
// deinterlaced values equal it bit for bit and only the tap sums differ in
// order.  Output: float32 (B, 2, h_out, W) per plane, field-major.
//
// Design.  A block makes tile_rows output rows (kernels/deint.K7_TILE_ROWS,
// 32) x kTileCols (64) columns of one plane of one frame, 16 x 16 threads;
// one launch covers the column tiles of Y, then U, then V, and neighbouring
// blocks take one tile of consecutive frames, so the frame a block reads as
// next, its neighbours read as cur and prev while it is still in L2:
//   * the window.  The block copies the input rows its tile's taps reach
//     (kernels/resize.BandedMatrix.row_windows: each tile's first row lo and
//     the widest window win) of prev and next, and of cur widened by the
//     clamped neighbour row above and below, over its 64 columns into
//     shared memory with 16-byte cp.async copies (element copies where the
//     rows are not 16-byte aligned), and the tile's starts and tap weights
//     beside them.
//   * the fields, once per input pixel.  A first pass computes the motion
//     ramp and both fields' deinterlaced values of every pixel of the window
//     into shared memory (float32), 4 columns a thread.  The one-thread-per-
//     output kernel this replaces computed them once per tap, ~6 times over
//     for the 2:1 luma and ~8 for the chroma.
//   * the taps.  Each thread makes 4 consecutive columns of its output rows
//     for both fields: one 16-byte shared-memory read of each field a tap,
//     and one 16-byte store of each field's 4 outputs where the row is
//     16-byte aligned (a scalar edge path takes other widths and pointers).
//   * the long-window route.  A map whose window does not fit shared memory
//     (4K to 270 rows needs 239 KB) takes deint3_long_kernel, which stages
//     nothing: each thread computes the ramp and both fields of each tap
//     row from prev, cur and next read through the read-only cache, in the
//     staged kernel's order.
// Every output is bit-equal to the one-pixel-a-thread kernel this replaces:
// the same operations in the same order, and no FMA for a row past the
// plane (a zero-weight tap on a zero row could turn -0 into +0).
// Shared memory: the fields, the raw window, taps and starts must fit
// kSmemBudget; the wrapper (kernels/deint.deint3_rows_dual) takes the
// long-window route for a map whose window does not.
//
// Shared memory at c5's uint16 luma: 62 KB a block, 3 blocks an SM.
//
// Bound: device memory.  At c5 (16 frames of 4K P010 to 1080 rows) the raw
// frames are read about once from device memory (0.45 GB a batch with the
// halo rows) and the two fields written once (1.06 GB): 0.451 ms on one
// H100.  The field values of the window and the 5-6 taps an output add
// their instructions beside those bytes (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "route.cuh"
#include "stage.cuh"
#include "tail.cuh"

namespace {

constexpr int kVec = vrt::kGroup;                // columns a thread makes
constexpr int kColThreads = 16;                  // threadIdx.x
constexpr int kRowThreads = 16;                  // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 64 columns a block
constexpr int kMaxTileRows = 1024;               // output rows a block, at most
constexpr size_t kSmemBudget = 232448;           // 227 KB

using vrt::Vec;

template <typename T>
struct Plane {
  const T* p;
  const T* c;
  const T* n;
  float* out;
  const int* starts;       // (h_out,)
  const float* taps;       // (n_taps, h_out)
  int n_taps;
  const int* lo;           // first input row of each tile's window
  int win;                 // rows of the widest window
  int h, w;
};

// Byte offsets of a block's shared memory for one plane class: both fields'
// values (win rows x kTileCols floats each), the taps (n_taps x tile_rows
// floats) and starts (tile_rows ints), then the raw windows: cur (win + 2
// rows: the clamped neighbours above and below), prev and next (win rows).
// kernels/deint.k7_smem_bytes mirrors ``bytes``.
struct Layout {
  size_t f0, f1, taps, starts, cur, prev, next, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int win, int n_taps, int tile_rows) {
  Layout L;
  const size_t field = static_cast<size_t>(win) * kTileCols * sizeof(float);
  const size_t raw = static_cast<size_t>(kTileCols) * sizeof(T);
  size_t o = 0;
  L.f0 = o;
  o += field;
  L.f1 = o;
  o += field;
  L.taps = o;
  o += static_cast<size_t>(n_taps) * tile_rows * sizeof(float);
  L.starts = o;
  o += static_cast<size_t>(tile_rows) * sizeof(int);
  o = (o + 15) / 16 * 16;   // the raw windows start on 16 bytes
  L.cur = o;
  o += (win + 2) * raw;
  L.prev = o;
  o += win * raw;
  L.next = o;
  o += win * raw;
  L.bytes = o;
  return L;
}

// Rows first .. first + n - 1 of one frame's plane (h rows, w columns),
// each clamped to [0, h - 1], columns col0 .. col0 + kTileCols - 1 into
// ``win`` (kTileCols a row); columns past w are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(T* win, const T* __restrict__ plane,
                                           int h, int w, int col0, int first,
                                           int n, bool aligned) {
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  if (aligned) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kChunks = kTileCols / kChunk;
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int k = i - r * kChunks;
      const int row = min(max(first + r, 0), h - 1);
      const int col = col0 + k * kChunk;
      T* d = win + r * kTileCols + k * kChunk;
      if (col < w) {
        vrt::cp_async16(d, plane + static_cast<long long>(row) * w + col);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = tid; i < n * kTileCols; i += kThreads) {
      const int r = i / kTileCols;
      const int row = min(max(first + r, 0), h - 1);
      const int col = col0 + (i - r * kTileCols);
      win[i] = col < w ? plane[static_cast<long long>(row) * w + col] : T(0);
    }
  }
}

// The deinterlaced value of row r for one field (deint_pallas._deint_fields)
__device__ __forceinline__ float field_value(int r, int h, float up, float cur,
                                             float dn, float ramp,
                                             bool use_top) {
  if ((r & 1) != (use_top ? 1 : 0)) return cur;
  if (use_top) {
    if (r == h - 1) dn = up;      // bottom clamp: row H - 2 twice
  } else if (r == 0) {
    up = dn;                      // top clamp: row 1 twice
  }
  const float bob = vrt::mul(vrt::add(up, dn), 0.5f);
  return vrt::add(cur, vrt::mul(vrt::sub(bob, cur), ramp));
}

// grid: x = (column tile, frame) with the frame fastest, the column tiles
// of Y, then U, then V; y = tiles of tile_rows output rows.  Neighbouring
// blocks take one tile of consecutive frames, so a frame's window, read as
// next, cur and prev by three of them, comes from device memory about once
// and from L2 the other times.
template <typename T>
__global__ void __launch_bounds__(kThreads) deint3_kernel(
    Plane<T> py, Plane<T> pu, Plane<T> pv, int batch, int h_out,
    int tile_rows, int y_blocks, int c_blocks, float thr,
    int top_field_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x / batch;
  const long long b = blockIdx.x - static_cast<long long>(bx) * batch;
  const int k = bx < y_blocks ? 0 : (bx < y_blocks + c_blocks ? 1 : 2);
  const Plane<T> P = k == 0 ? py : (k == 1 ? pu : pv);
  const int col0 = (k == 0 ? bx : bx - y_blocks - (k - 1) * c_blocks)
                   * kTileCols;
  const int tile = blockIdx.y;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, h_out - r0);
  const int h = P.h, w = P.w;
  const Layout L = layout<T>(P.win, P.n_taps, tile_rows);
  float* f0 = reinterpret_cast<float*>(smem + L.f0);
  float* f1 = reinterpret_cast<float*>(smem + L.f1);
  float* taps = reinterpret_cast<float*>(smem + L.taps);
  int* starts = reinterpret_cast<int*>(smem + L.starts);
  T* cw = reinterpret_cast<T*>(smem + L.cur);
  T* pw = reinterpret_cast<T*>(smem + L.prev);
  T* nw = reinterpret_cast<T*>(smem + L.next);

  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  const int lo = P.lo[tile];
  const int n = min(P.win, h - lo);          // window rows
  const long long base = b * h * static_cast<long long>(w);
  const bool aligned = vrt::rows_aligned16(P.p, w) &&
                       vrt::rows_aligned16(P.c, w) &&
                       vrt::rows_aligned16(P.n, w);
  stage_rows(cw, P.c + base, h, w, col0, lo - 1, n + 2, aligned);
  stage_rows(pw, P.p + base, h, w, col0, lo, n, aligned);
  stage_rows(nw, P.n + base, h, w, col0, lo, n, aligned);
  for (int i = tid; i < tile_rows; i += kThreads) {
    starts[i] = r0 + i < h_out ? P.starts[r0 + i] : 0;
  }
  for (int i = tid; i < P.n_taps * tile_rows; i += kThreads) {
    const int t = i / tile_rows;
    const int r = r0 + (i - t * tile_rows);
    taps[i] = r < h_out ? P.taps[static_cast<long long>(t) * h_out + r] : 0.f;
  }
  vrt::cp_async_wait_all();
  __syncthreads();

  // both fields' values of every window pixel: row j of the window is input
  // row lo + j; cur's rows j, j + 1, j + 2 are its neighbour above, itself
  // and its neighbour below, clamped
  const bool top0 = top_field_first != 0;   // field 0 keeps the top field
  constexpr int kQuads = kTileCols / kVec;
  for (int i = tid; i < n * kQuads; i += kThreads) {
    const int j = i / kQuads;
    const int q = (i - j * kQuads) * kVec;
    const int r = lo + j;
    const Vec<T> up = *reinterpret_cast<const Vec<T>*>(cw + j * kTileCols + q);
    const Vec<T> cu =
        *reinterpret_cast<const Vec<T>*>(cw + (j + 1) * kTileCols + q);
    const Vec<T> dn =
        *reinterpret_cast<const Vec<T>*>(cw + (j + 2) * kTileCols + q);
    const Vec<T> pr = *reinterpret_cast<const Vec<T>*>(pw + j * kTileCols + q);
    const Vec<T> nx = *reinterpret_cast<const Vec<T>*>(nw + j * kTileCols + q);
    Vec<float> a, c;
#pragma unroll
    for (int kk = 0; kk < kVec; ++kk) {
      const float ramp = vrt::clip01(vrt::dvd(
          vrt::sub(fabsf(vrt::sub(vrt::to_float(nx.v[kk]),
                                  vrt::to_float(pr.v[kk]))), thr), thr));
      const float u_ = vrt::to_float(up.v[kk]);
      const float c_ = vrt::to_float(cu.v[kk]);
      const float d_ = vrt::to_float(dn.v[kk]);
      a.v[kk] = field_value(r, h, u_, c_, d_, ramp, top0);
      c.v[kk] = field_value(r, h, u_, c_, d_, ramp, !top0);
    }
    *reinterpret_cast<Vec<float>*>(f0 + j * kTileCols + q) = a;
    *reinterpret_cast<Vec<float>*>(f1 + j * kTileCols + q) = c;
  }
  __syncthreads();

  const int cl = threadIdx.x * kVec;
  const int col = col0 + cl;
  if (col >= w) return;
  const bool out_vec = w % kVec == 0 &&
                       (reinterpret_cast<uintptr_t>(P.out) %
                        sizeof(Vec<float>)) == 0;
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int s = starts[m];
    float a0[kVec], a1[kVec];
#pragma unroll
    for (int kk = 0; kk < kVec; ++kk) a0[kk] = a1[kk] = 0.f;
    for (int t = 0; t < P.n_taps; ++t) {
      const int r = s + t;
      if (r >= h) break;
      const float wt = taps[t * tile_rows + m];
      const Vec<float> x0 =
          *reinterpret_cast<const Vec<float>*>(f0 + (r - lo) * kTileCols + cl);
      const Vec<float> x1 =
          *reinterpret_cast<const Vec<float>*>(f1 + (r - lo) * kTileCols + cl);
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        a0[kk] = fmaf(x0.v[kk], wt, a0[kk]);
        a1[kk] = fmaf(x1.v[kk], wt, a1[kk]);
      }
    }
    float* o0 = P.out + ((b * 2) * h_out + r0 + m) * w + col;
    float* o1 = o0 + static_cast<long long>(h_out) * w;
    if (out_vec && col + kVec <= w) {
      Vec<float> v0, v1;
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        v0.v[kk] = a0[kk];
        v1.v[kk] = a1[kk];
      }
      *reinterpret_cast<Vec<float>*>(o0) = v0;
      *reinterpret_cast<Vec<float>*>(o1) = v1;
    } else {
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        if (col + kk < w) {
          o0[kk] = a0[kk];
          o1[kk] = a1[kk];
        }
      }
    }
  }
}

// The long-window route: deint3_kernel without the window, for maps whose
// window does not fit shared memory (a strong downscale).  Each thread
// makes 4 columns of its output rows for both fields, computing each tap
// row's motion ramp and field values from prev, cur (and cur's clamped
// neighbour rows) and next read straight from device memory through the
// read-only cache, with the same operations in the same order as the
// staged kernel's window pass and taps, so its outputs are the staged
// route's bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads) deint3_long_kernel(
    Plane<T> py, Plane<T> pu, Plane<T> pv, int batch, int h_out,
    int tile_rows, int y_blocks, int c_blocks, float thr,
    int top_field_first) {
  const int bx = blockIdx.x / batch;
  const long long b = blockIdx.x - static_cast<long long>(bx) * batch;
  const int k = bx < y_blocks ? 0 : (bx < y_blocks + c_blocks ? 1 : 2);
  const Plane<T> P = k == 0 ? py : (k == 1 ? pu : pv);
  const int col0 = (k == 0 ? bx : bx - y_blocks - (k - 1) * c_blocks)
                   * kTileCols;
  const int r0 = blockIdx.y * tile_rows;
  const int rows = min(tile_rows, h_out - r0);
  const int h = P.h, w = P.w;
  const int col = col0 + threadIdx.x * kVec;
  if (col >= w) return;
  const long long base = b * h * static_cast<long long>(w);
  const T* pp = P.p + base;
  const T* pc = P.c + base;
  const T* pn = P.n + base;
  const bool vec = w % kVec == 0 && col + kVec <= w &&
                   (reinterpret_cast<uintptr_t>(P.p) % sizeof(Vec<T>)) == 0 &&
                   (reinterpret_cast<uintptr_t>(P.c) % sizeof(Vec<T>)) == 0 &&
                   (reinterpret_cast<uintptr_t>(P.n) % sizeof(Vec<T>)) == 0;
  const bool out_vec = w % kVec == 0 &&
                       (reinterpret_cast<uintptr_t>(P.out) %
                        sizeof(Vec<float>)) == 0;
  auto load = [&](const T* plane, int row) {
    const T* q = plane + static_cast<long long>(row) * w + col;
    if (vec) return vrt::ldg_as<Vec<T>>(q);
    Vec<T> x;
#pragma unroll
    for (int kk = 0; kk < kVec; ++kk) {
      x.v[kk] = col + kk < w ? __ldg(q + kk) : T(0);
    }
    return x;
  };
  const bool top0 = top_field_first != 0;   // field 0 keeps the top field
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int ro = r0 + m;
    const int s = __ldg(P.starts + ro);
    float a0[kVec], a1[kVec];
#pragma unroll
    for (int kk = 0; kk < kVec; ++kk) a0[kk] = a1[kk] = 0.f;
    for (int t = 0; t < P.n_taps; ++t) {
      const int r = s + t;
      if (r >= h) break;
      const float wt =
          __ldg(P.taps + static_cast<long long>(t) * h_out + ro);
      const Vec<T> up = load(pc, max(r - 1, 0));
      const Vec<T> cu = load(pc, r);
      const Vec<T> dn = load(pc, min(r + 1, h - 1));
      const Vec<T> pr = load(pp, r);
      const Vec<T> nx = load(pn, r);
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        const float ramp = vrt::clip01(vrt::dvd(
            vrt::sub(fabsf(vrt::sub(vrt::to_float(nx.v[kk]),
                                    vrt::to_float(pr.v[kk]))), thr), thr));
        const float u_ = vrt::to_float(up.v[kk]);
        const float c_ = vrt::to_float(cu.v[kk]);
        const float d_ = vrt::to_float(dn.v[kk]);
        a0[kk] = fmaf(field_value(r, h, u_, c_, d_, ramp, top0), wt, a0[kk]);
        a1[kk] = fmaf(field_value(r, h, u_, c_, d_, ramp, !top0), wt,
                      a1[kk]);
      }
    }
    float* o0 = P.out + ((b * 2) * h_out + ro) * w + col;
    float* o1 = o0 + static_cast<long long>(h_out) * w;
    if (out_vec && col + kVec <= w) {
      Vec<float> v0, v1;
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        v0.v[kk] = a0[kk];
        v1.v[kk] = a1[kk];
      }
      *reinterpret_cast<Vec<float>*>(o0) = v0;
      *reinterpret_cast<Vec<float>*>(o1) = v1;
    } else {
#pragma unroll
      for (int kk = 0; kk < kVec; ++kk) {
        if (col + kk < w) {
          o0[kk] = a0[kk];
          o1[kk] = a1[kk];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* const* planes, int batch, int hy, int wy, int hc,
           int wc, int h_out, int tile_rows, const int* sy, const float* ty, int nty,
           const int* lo_y, int win_y, const int* sc, const float* tc,
           int ntc, const int* lo_c, int win_c, float thr,
           int top_field_first, bool long_window, float* oy, float* ou,
           float* ov, cudaStream_t stream) {
  auto mk = [&](int i, float* out, const int* s, const float* t, int n,
                const int* lo, int win, int h, int w) {
    return Plane<T>{static_cast<const T*>(planes[3 * i]),
                    static_cast<const T*>(planes[3 * i + 1]),
                    static_cast<const T*>(planes[3 * i + 2]), out, s, t, n,
                    lo, win, h, w};
  };
  const int y_blocks = (wy + kTileCols - 1) / kTileCols;
  const int c_blocks = (wc + kTileCols - 1) / kTileCols;
  const dim3 grid((y_blocks + 2 * c_blocks) * batch,
                  (h_out + tile_rows - 1) / tile_rows);
  if (tile_rows < 1 || tile_rows > kMaxTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (long_window) {
    deint3_long_kernel<T><<<grid, dim3(kColThreads, kRowThreads), 0,
                            stream>>>(
        mk(0, oy, sy, ty, nty, lo_y, win_y, hy, wy),
        mk(1, ou, sc, tc, ntc, lo_c, win_c, hc, wc),
        mk(2, ov, sc, tc, ntc, lo_c, win_c, hc, wc), batch, h_out, tile_rows,
        y_blocks, c_blocks, thr, top_field_first);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem_y = layout<T>(win_y, nty, tile_rows).bytes;
  const size_t smem_c = layout<T>(win_c, ntc, tile_rows).bytes;
  const size_t smem = smem_y > smem_c ? smem_y : smem_c;
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        deint3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  deint3_kernel<T><<<grid, dim3(kColThreads, kRowThreads), smem, stream>>>(
      mk(0, oy, sy, ty, nty, lo_y, win_y, hy, wy),
      mk(1, ou, sc, tc, ntc, lo_c, win_c, hc, wc),
      mk(2, ov, sc, tc, ntc, lo_c, win_c, hc, wc), batch, h_out, tile_rows,
      y_blocks, c_blocks, thr, top_field_first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``planes``: HOST array of 9 device pointers, (prev, cur, next) of Y, then
// of U, then of V, all of one dtype: 0 uint8, 1 uint16, 2 int16, 3 float32.
// Per plane class (y, c): the H map's starts, taps and n_taps, and each
// tile's first window row (``lo_*``, device, one int per tile of
// ``tile_rows`` output rows) and the widest window ``win_*``
// (kernels/resize.BandedMatrix.row_windows).  Outputs float32 (batch, 2,
// h_out, w) per plane.  ``long_window``: the long-window kernel (no shared
// memory), else the staged one, which returns cudaErrorInvalidValue for a
// layout over kSmemBudget.
extern "C" int vrt_deint3_rows_dual(
    const void* planes, int dtype, int batch, int hy, int wy, int hc, int wc,
    int h_out, int tile_rows, const void* starts_y, const void* taps_y, int n_taps_y,
    const void* lo_y, int win_y, const void* starts_c, const void* taps_c,
    int n_taps_c, const void* lo_c, int win_c, float thr,
    int top_field_first, int long_window, void* out_y, void* out_u,
    void* out_v, void* stream) {
  const void* const* ps = static_cast<const void* const*>(planes);
  const int* sy = static_cast<const int*>(starts_y);
  const float* ty = static_cast<const float*>(taps_y);
  const int* ly = static_cast<const int*>(lo_y);
  const int* sc = static_cast<const int*>(starts_c);
  const float* tc = static_cast<const float*>(taps_c);
  const int* lc = static_cast<const int*>(lo_c);
  float* oy = static_cast<float*>(out_y);
  float* ou = static_cast<float*>(out_u);
  float* ov = static_cast<float*>(out_v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(ps, batch, hy, wy, hc, wc, h_out, tile_rows, sy, ty, n_taps_y, ly,
                     win_y, sc, tc, n_taps_c, lc, win_c, thr,
                     top_field_first, long_window != 0, oy, ou, ov, st);
  };
  switch (dtype) {
    case 0: return run(uint8_t{});
    case 1: return run(uint16_t{});
    case 2: return run(int16_t{});
    case 3: return run(float{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
