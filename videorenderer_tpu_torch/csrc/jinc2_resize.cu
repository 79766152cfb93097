// K5: the one-pass 2D Jinc2 resample with anti-ringing of float32 planes,
// for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/jinc2_pallas.py: jinc2_resize_fused
// (body _make_kernel).  The Pallas kernel ran the weights as a low-rank SVD
// expansion (five banded bf16 matrix products per tile, a 1e-4 singular-value
// cutoff) because Mosaic has no gather; here each output gathers its 16
// source taps directly, weights them (jinc2.cuh), normalises, applies
// anti-ringing, then the optional epilogue: ordered dither from the GLOBAL
// row and column, or rounding.  A launch may make a band of a larger
// frame's rows (a row shard, parallel/spatial): the wrapper passes that
// band's rows of the tap tables and row0, the band's first row in the
// frame, so the dither keeps the frame's pattern.
//
// Design.  A block of 256 threads makes one 32-row x 128-column output
// tile of one plane; a thread makes 4 adjacent outputs of a row, in 4 rows
// 8 apart.
//   * weights.  An output's 16 weights depend only on its row's and its
//     column's d2 4-vectors, which repeat with the axes' phase periods (2 x
//     2 distinct pairs at 2x).  On the table route (kWeights == kTable) an
//     output reads its entry of the geometry's table, the one K6 reads
//     (kernels/jinc2._weight_table: 16 weights and their sum from
//     jinc2_weights on the same d2 bits), as five 16-byte loads; a geometry
//     whose table would pass the wrapper's cap (no short period on either
//     axis) takes the per-output route of the same kernel (kPerOutput),
//     which computes the 16 weights with accurate sqrtf, sinf and divisions.
//     Both routes give the same bits.
//   * taps.  On the staged route (kTaps == kStaged) the block copies the
//     source window its tile's taps reach (rows by[r0] - 1 .. by[r1 - 1] +
//     2, columns likewise from bx, each clamped to the plane as the plain
//     version clamps) into shared memory once: 16-byte cp.async where the
//     rows are 16-byte aligned and the 4 columns lie inside the plane,
//     element copies elsewhere.  Every tap read then comes from shared
//     memory.  A window that does not fit the budget (a strong downscale)
//     takes the direct route (kDirect) of the same kernel, whose taps are
//     read through L1.
//   * banks.  A warp makes one output row: lane tx reads the taps of
//     columns 4 tx .. 4 tx + 3.  At 2x those start 2 source columns apart,
//     so lanes tx and tx + 16 would hit one bank; lanes 16-31 make their 4
//     outputs in the order 2, 3, 0, 1 instead, which lands them on the
//     other half of the banks (tests/test_torch_k5_k3_tiles.py).
//   * store.  The 4 outputs go out as one 16-byte store where the row is
//     aligned, else as scalar stores.
// Every output is bit-equal to the one-output-a-thread kernel this
// replaces: the same weights, the same jinc2_resolve (products and sums in
// tap order, __fdiv_rn, anti-ringing) and the same quantize at the global
// (row, col).
//
// Bound.  Device memory sees each plane once and the output once (at
// c3r270's 48 planes of 1080p -> 4K, 1.99 GB: 0.59 ms on one H100).
// Without the weights an output still costs its 16 shared-memory tap
// reads, 16 products, 15 sums, a division, the anti-ringing and the
// quantization: the issue of those instructions, near the byte time, bounds
// the table route.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "jinc2.cuh"
#include "stage.cuh"

namespace {

constexpr int kVec = 4;                          // adjacent outputs a thread
constexpr int kColThreads = 32;                  // threadIdx.x
constexpr int kRowThreads = 8;                   // threadIdx.y
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTileCols = kVec * kColThreads;    // 128 output columns
constexpr int kTileRows = 32;                    // output rows
constexpr size_t kSmemBudget = 232448;           // 227 KB

enum { kPerOutput = 0, kTable = 1 };             // weights
enum { kDirect = 0, kStaged = 1 };               // taps

struct Geometry {
  int h, w, oh, ow;
  const int* by; const float* d2y;   // (oh,), (4, oh)
  const int* bx; const float* d2x;   // (ow,), (4, ow)
  const int* row_cls;                // (oh,) each row's class; table route
  const int* col_cls;                // (ow,) each column's class
  const float* table;                // (n_row_cls, n_col_cls, kJ2Entry)
  int n_col_cls;
  int win_h, pitch;                  // staged window: rows, floats a row
  int row0;                          // the frame row of output row 0
};

template <int kWeights, int kTaps>
__global__ void __launch_bounds__(kThreads) jinc2_resize_kernel(
    const float* __restrict__ x, const Geometry G, vrt::Quant quant,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float win[];
  const int r0 = blockIdx.y * kTileRows, c0 = blockIdx.x * kTileCols;
  const long long p = blockIdx.z;
  const float* xp = x + p * G.h * G.w;
  // the window's first row and its first column, rounded down to 4
  const int wy0 = __ldg(G.by + r0) - 1;
  const int wx0 = __ldg(G.bx + c0) - 1;
  const int sx0 = wx0 - (wx0 & 3);
  if constexpr (kTaps == kStaged) {
    const int r1 = min(r0 + kTileRows, G.oh), c1 = min(c0 + kTileCols, G.ow);
    const int nwh = __ldg(G.by + r1 - 1) + 3 - wy0;
    const int chunks = (__ldg(G.bx + c1 - 1) + 3 - sx0 + 3) / 4;
    const bool vec = vrt::rows_aligned16(x, G.w);
    const int tid = threadIdx.y * kColThreads + threadIdx.x;
    for (int i = tid; i < nwh * chunks; i += kThreads) {
      const int r = i / chunks, q = i - r * chunks;
      const float* src =
          xp + static_cast<long long>(min(max(wy0 + r, 0), G.h - 1)) * G.w;
      const int c = sx0 + 4 * q;
      float* d = win + r * G.pitch + 4 * q;
      if (vec && c >= 0 && c + 4 <= G.w) {
        vrt::cp_async16(d, src + c);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = __ldg(src + min(max(c + e, 0), G.w - 1));
      }
    }
    vrt::cp_async_wait_all();
    __syncthreads();
  }

  const int tx = threadIdx.x;
  const int col0 = c0 + kVec * tx;
  if (col0 >= G.ow) return;
  const int sw = tx & 16 ? 2 : 0;   // lanes 16-31: outputs 2, 3, 0, 1
  // output k of this thread is column col0 + (k ^ sw): its first tap
  // column (window-relative on the staged route) and its class
  int cols[kVec], wc[kVec], cc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    cols[k] = col0 + (k ^ sw);
    const int col = min(cols[k], G.ow - 1);
    wc[k] = __ldg(G.bx + col) - 1 - (kTaps == kStaged ? sx0 : 0);
    cc[k] = kWeights == kTable ? __ldg(G.col_cls + col) : 0;
  }
  const bool vec = G.ow % kVec == 0 && col0 + kVec <= G.ow &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  // one row a pass, not unrolled, so that kernel_report.py's static count
  // of the kernel is one pass's
#pragma unroll 1
  for (int i = 0; i < kTileRows / kRowThreads; ++i) {
    const int row = r0 + threadIdx.y + kRowThreads * i;
    if (row >= G.oh) break;
    const int wr = __ldg(G.by + row) - 1 - (kTaps == kStaged ? wy0 : 0);
    int rc = 0;
    float dy[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kWeights == kTable) {
      rc = __ldg(G.row_cls + row);
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o) dy[o] = __ldg(G.d2y + o * G.oh + row);
    }
    // output k of the thread's 4; the per-output route makes them one at
    // a time (its weights' sinf code, unrolled 4 times, spills registers)
    auto output = [&](int k) {
      float wt[16], t[16];
      float wsum;
      if constexpr (kWeights == kTable) {
        wsum = vrt::jinc2_table_weights(G.table, G.n_col_cls, rc, cc[k], wt);
      } else {
        const int col = min(cols[k], G.ow - 1);
        float dx[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) dx[o] = __ldg(G.d2x + o * G.ow + col);
        wsum = vrt::jinc2_weights(dy, dx, wt);
      }
      if constexpr (kTaps == kStaged) {
        const float* tp = win + wr * G.pitch + wc[k];
#pragma unroll
        for (int jo = 0; jo < 4; ++jo) {
#pragma unroll
          for (int io = 0; io < 4; ++io) t[jo * 4 + io] = tp[jo * G.pitch + io];
        }
      } else {
#pragma unroll
        for (int jo = 0; jo < 4; ++jo) {
          const float* xr =
              xp + static_cast<long long>(min(max(wr + jo, 0), G.h - 1)) * G.w;
#pragma unroll
          for (int io = 0; io < 4; ++io) {
            t[jo * 4 + io] = __ldg(xr + min(max(wc[k] + io, 0), G.w - 1));
          }
        }
      }
      return vrt::quantize(vrt::jinc2_resolve(t, wt, wsum), quant,
                           row + G.row0, cols[k]);
    };
    float res[kVec];
    if constexpr (kWeights == kTable) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) res[k] = output(k);
    } else {
#pragma unroll 1
      for (int k = 0; k < kVec; ++k) res[k] = output(k);
    }
    // output j of the row is res[j ^ sw]
    float* o = out + (p * G.oh + row) * G.ow + col0;
    float4 v;
    v.x = sw ? res[2] : res[0];
    v.y = sw ? res[3] : res[1];
    v.z = sw ? res[0] : res[2];
    v.w = sw ? res[1] : res[3];
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float f[kVec] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (col0 + j < G.ow) o[j] = f[j];
      }
    }
  }
}

template <int kWeights, int kTaps>
int launch(const float* x, int planes, const Geometry& G, vrt::Quant quant,
           float* out, cudaStream_t stream) {
  const size_t smem =
      kTaps == kStaged ? static_cast<size_t>(G.win_h) * G.pitch * sizeof(float)
                       : 0;
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = jinc2_resize_kernel<kWeights, kTaps>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.ow + kTileCols - 1) / kTileCols,
                  (G.oh + kTileRows - 1) / kTileRows, planes);
  kernel<<<grid, dim3(kColThreads, kRowThreads), smem, stream>>>(x, G, quant,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (planes, h, w) float32; out: (planes, oh, ow) float32.  by/bx (oh,)
// and (ow,) int32, d2y/d2x (4, oh) and (4, ow) float32: the per-axis tables
// of ops/scale.jinc2_axis_tables.  row_cls (oh,), col_cls (ow,) and table
// (n_row_cls x n_col_cls entries of 20 floats, 16-byte aligned, from
// vrt_jinc2_weight_table): the table route; table NULL: the per-output
// route.  win_h > 0: the staged route, every tile's window within win_h
// rows of ``pitch`` floats (a multiple of 4, kernels/jinc2.k5_window);
// win_h 0: the direct route.  dither_bits: +b ordered dither, -b rounding,
// 0 none; row0: the frame row the dither pattern gives output row 0.
extern "C" int vrt_jinc2_resize(const void* x, int planes, int h, int w,
                                int oh, int ow, const void* by,
                                const void* d2y, const void* bx,
                                const void* d2x, const void* row_cls,
                                const void* col_cls, const void* table,
                                int n_col_cls, int win_h, int pitch,
                                int dither_bits, int row0, void* out,
                                void* stream) {
  const Geometry G{h, w, oh, ow,
                   static_cast<const int*>(by), static_cast<const float*>(d2y),
                   static_cast<const int*>(bx), static_cast<const float*>(d2x),
                   static_cast<const int*>(row_cls),
                   static_cast<const int*>(col_cls),
                   static_cast<const float*>(table), n_col_cls, win_h, pitch,
                   row0};
  if ((table != nullptr &&
       (row_cls == nullptr || col_cls == nullptr || n_col_cls < 1 ||
        (reinterpret_cast<uintptr_t>(table) % 16) != 0)) ||
      (win_h > 0 && (pitch < 4 || pitch % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const vrt::Quant q = vrt::make_quant(dither_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    return win_h > 0 ? launch<kTable, kStaged>(xs, planes, G, q, o, st)
                     : launch<kTable, kDirect>(xs, planes, G, q, o, st);
  }
  return win_h > 0 ? launch<kPerOutput, kStaged>(xs, planes, G, q, o, st)
                   : launch<kPerOutput, kDirect>(xs, planes, G, q, o, st);
}
