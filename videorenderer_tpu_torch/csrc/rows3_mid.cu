// K8: H maps of (Y, U, V) into a mid resolution, the Dolby Vision convert
// there, and a shared H map out, for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: rows3_mid with the
// DoVi mid_fn of videorenderer_tpu/pipeline._make_dovi_fused_fn (the static
// _epi_a and the runtime _epi_a_rt, which reads the curves from a scalar
// vector laid out by ops/dovi.flatten_curve_scalars).  Per mid pixel:
//   1. each plane's H pass into the mid rows: sum_t p[starts[m] + t] *
//      taps[t, m] in fp32 FMAs over a per-mid-row tap table
//      (kernels/resize.py: plan_taps), or a direct read times its scale;
//   2. the reshape of ops/dovi (clip to [0, 1], the piece = the count of
//      pivots at or below the signal, its polynomial or MMR value, clip),
//      the 3x3+c RPU matrix, then the LMS step: PQ EOTF, the combined
//      LMS->RGB matrix, PQ OETF, or with an identity product max(x, 0);
//   3. the out map's H taps over the mid rows, one float32 plane per
//      channel.
// Every operation rounds on its own, in the order of the torch plain
// version (kernels/deint.rows3_mid_plain, ops/dovi.MidStage.plain).
//
// Runtime values: the colour matrix, the combined LMS matrix and the curve
// scalars (at most 12 + 9 + 549 floats) and the curve structure (pieces,
// kinds, MMR orders) travel in one struct passed by value with the launch,
// so a new scene's curves need no rebuild, no copy to the device and no
// host synchronisation.  Each block copies the struct into shared memory.
//
// Bound.  At c8 (4K P010 Dolby Vision -> 1080p, 16 frames) a block owns
// 32 columns x 32 output rows; it computes the ~66 mid rows those outputs
// reach (the 2:1 Catmull-Rom band) into shared memory, three channels, then
// runs the out taps from there, so the full-resolution RGB never reaches
// device memory.  Device memory delivers the luma (uint16) and the two
// K1-upsampled chroma planes (float32) about once and takes the three
// float32 output planes: ~50 MB in and ~50 MB out a frame.  The mid stage
// is a few dozen operations a pixel (several hundred with a non-identity
// LMS step: six accurate pows), so with that step the kernel may come near
// the line between the two bounds.
// The TPU kernel's split-bf16 products and full-height column stripes in
// VMEM do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "tail.cuh"

namespace {

constexpr int kCols = 32;       // columns of a block (threadIdx.x)
constexpr int kRowThreads = 8;  // threadIdx.y
constexpr int kTileRows = 32;   // output rows of a block (kernels/deint.py)
constexpr int kMaxPieces = 8;
constexpr int kHead = 12 + 9;   // the colour matrix, then the LMS matrix
constexpr int kMaxVals = kHead + 3 * (7 + kMaxPieces * 22);

struct Curve {
  int pieces;
  int piv;                 // offset of the pieces - 1 pivots in vals
  int kind[kMaxPieces];    // 0 polynomial, 1 MMR
  int order[kMaxPieces];   // MMR order
  int off[kMaxPieces];     // offset of the piece's coefficients in vals
};

struct MidParams {
  float vals[kMaxVals];    // [cmat 3 x (m0 m1 m2 c)][lms 3 x 3][curves]
  Curve curve[3];
  int lms_identity;
  float y_scale, c_scale;
};

struct Geometry {
  int hy, hc, w, h_mid, h_out;
  const int* sy; const float* ty; int nty;
  const int* sc; const float* tc; int ntc;
  const int* so; const float* to; int nto;
  const int* tile_lo;      // first mid row of each tile's window
  int win;                 // rows of the window
};

using vrt::add;
using vrt::mul;

// One plane's value at mid row ``row``: the in map's taps, or a direct read
// times the scale.
template <typename T>
__device__ __forceinline__ float in_pass(const T* __restrict__ plane, int h_in,
                                         int w, int col, int row,
                                         const int* __restrict__ starts,
                                         const float* __restrict__ taps,
                                         int n_taps, int h_mid, float scale) {
  if (n_taps == 0) {
    return mul(static_cast<float>(plane[static_cast<long long>(row) * w + col]),
               scale);
  }
  const int s = starts[row];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    const int i = s + t;
    if (i < h_in) {
      acc = fmaf(static_cast<float>(plane[static_cast<long long>(i) * w + col]),
                 taps[t * h_mid + row], acc);
    }
  }
  return acc;
}

// reshape_mmr (Source/Shaders.cpp:733-763): c + sum over orders j of the
// 3 linear and 4 cross terms, each raised to the power j + 1.
__device__ __forceinline__ float mmr(const float* w, int order,
                                     const float sig[3]) {
  const float lin[3] = {sig[0], sig[1], sig[2]};
  const float s01 = mul(sig[0], sig[1]);
  const float cross[4] = {s01, mul(sig[0], sig[2]), mul(sig[1], sig[2]),
                          mul(s01, sig[2])};
  float lj[3] = {lin[0], lin[1], lin[2]};
  float cj[4] = {cross[0], cross[1], cross[2], cross[3]};
  float acc = w[0];
  const float* wp = w + 1;
  for (int j = 0; j < order; ++j, wp += 7) {
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) lj[k] = mul(lj[k], lin[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) cj[k] = mul(cj[k], cross[k]);
    }
    float tl = mul(wp[0], lj[0]);
    tl = add(tl, mul(wp[1], lj[1]));
    tl = add(tl, mul(wp[2], lj[2]));
    float tc = mul(wp[3], cj[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) tc = add(tc, mul(wp[3 + k], cj[k]));
    acc = add(add(acc, tl), tc);
  }
  return acc;
}

// ShaderDoviReshape (Source/Shaders.cpp:554-589) of one channel.
__device__ __forceinline__ float reshape(const MidParams& P, const Curve& C,
                                         float s, const float sig[3]) {
  int idx = 0;
  for (int k = 0; k < C.pieces - 1; ++k) idx += s >= P.vals[C.piv + k];
  const float* w = P.vals + C.off[idx];
  const float val = C.kind[idx] == 0
                        ? add(mul(add(mul(w[2], s), w[1]), s), w[0])
                        : mmr(w, C.order[idx], sig);
  return vrt::clip01(val);
}

// The DoVi convert of one pixel: reshape, RPU matrix, LMS step.
__device__ __forceinline__ void dovi_mid(const MidParams& P, float yv,
                                         float uv, float vv, float c[3]) {
  const float sig[3] = {vrt::clip01(yv), vrt::clip01(uv), vrt::clip01(vv)};
  float ycc[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) ycc[ch] = reshape(P, P.curve[ch], sig[ch], sig);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = P.vals + 4 * i;
    c[i] = add(vrt::dot3(m[0], m[1], m[2], ycc[0], ycc[1], ycc[2]), m[3]);
  }
  if (P.lms_identity) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = fmaxf(c[i], 0.f);
    return;
  }
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = vrt::pq_to_linear(fmaxf(c[i], 0.f), 1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = P.vals + 12 + 3 * i;
    c[i] = vrt::linear_to_pq(
        fmaxf(vrt::dot3(m[0], m[1], m[2], x[0], x[1], x[2]), 0.f));
  }
}

// grid: x = column strips of kCols, y = tiles of kTileRows output rows,
// z = frames; block (kCols, kRowThreads)
template <typename TY, typename TC>
__global__ void __launch_bounds__(kCols * kRowThreads) rows3_mid_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G,
    const __grid_constant__ MidParams P, float* __restrict__ out) {
  extern __shared__ float window[];        // [3][G.win][kCols]
  __shared__ MidParams sp;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  {
    const int* src = reinterpret_cast<const int*>(&P);
    int* dst = reinterpret_cast<int*>(&sp);
    for (int i = tid; i < static_cast<int>(sizeof(MidParams) / 4);
         i += kCols * kRowThreads) {
      dst[i] = src[i];
    }
  }
  __syncthreads();

  const int col = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * kTileRows;
  const long long b = blockIdx.z;
  const int lo = G.nto ? G.tile_lo[blockIdx.y] : r0;
  const int n_win = min(G.win, G.h_mid - lo);
  const TY* yb = y + b * G.hy * static_cast<long long>(G.w);
  const TC* ub = u + b * G.hc * static_cast<long long>(G.w);
  const TC* vb = v + b * G.hc * static_cast<long long>(G.w);

  for (int m = threadIdx.y; m < n_win; m += kRowThreads) {
    float c[3] = {0.f, 0.f, 0.f};
    if (col < G.w) {
      const int row = lo + m;
      const float yv = in_pass(yb, G.hy, G.w, col, row, G.sy, G.ty, G.nty,
                               G.h_mid, sp.y_scale);
      const float uv = in_pass(ub, G.hc, G.w, col, row, G.sc, G.tc, G.ntc,
                               G.h_mid, sp.c_scale);
      const float vv = in_pass(vb, G.hc, G.w, col, row, G.sc, G.tc, G.ntc,
                               G.h_mid, sp.c_scale);
      dovi_mid(sp, yv, uv, vv, c);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      window[(ch * G.win + m) * kCols + threadIdx.x] = c[ch];
    }
  }
  __syncthreads();
  if (col >= G.w) return;

  const long long batch = gridDim.z;
  const int r_end = min(r0 + kTileRows, G.h_out);
  for (int r = r0 + threadIdx.y; r < r_end; r += kRowThreads) {
    float acc[3] = {0.f, 0.f, 0.f};
    if (G.nto == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        acc[ch] = window[(ch * G.win + r - lo) * kCols + threadIdx.x];
      }
    } else {
      const int s = G.so[r];
      for (int t = 0; t < G.nto; ++t) {
        const int i = s + t;
        if (i < G.h_mid) {
          const float wt = G.to[t * G.h_out + r];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            acc[ch] = fmaf(window[(ch * G.win + i - lo) * kCols + threadIdx.x],
                           wt, acc[ch]);
          }
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      out[((ch * batch + b) * G.h_out + r) * static_cast<long long>(G.w) + col] =
          acc[ch];
    }
  }
}

}  // namespace

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  n_taps_* == 0: no
// map; a plane without an in map is read directly (its height is h_mid)
// times its scale, and without an out map h_out is h_mid.  ``tile_lo``
// (device, one int per tile of 32 output rows) and ``win`` give each tile's
// window of mid rows (kernels/resize.BandedMatrix.row_windows).
// ``host_vals`` is HOST memory: n_vals floats, the colour matrix row-major
// 3 x (m0 m1 m2 c), the combined LMS matrix row-major 3 x 3, then the curve
// scalars; ``host_structure`` (HOST) holds per channel its piece count,
// then 8 kinds and 8 MMR orders.  ``out`` is (3, batch, h_out, w).
extern "C" int vrt_rows3_mid(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int hy, int hc, int w, int h_mid, int h_out,
    const void* starts_y, const void* taps_y, int n_taps_y,
    const void* starts_c, const void* taps_c, int n_taps_c,
    const void* starts_o, const void* taps_o, int n_taps_o,
    const void* tile_lo, int win, float y_scale, float c_scale,
    const void* host_vals, int n_vals, const void* host_structure,
    int lms_identity, void* out, void* stream) {
  if (n_vals > kMaxVals || n_vals < kHead) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MidParams P = {};
  const float* hv = static_cast<const float*>(host_vals);
  for (int i = 0; i < n_vals; ++i) P.vals[i] = hv[i];
  const int* hs = static_cast<const int*>(host_structure);
  int o = kHead;
  for (int ch = 0; ch < 3; ++ch) {
    Curve& C = P.curve[ch];
    const int* d = hs + ch * (1 + 2 * kMaxPieces);
    C.pieces = d[0];
    if (C.pieces < 1 || C.pieces > kMaxPieces) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    C.piv = o;
    o += C.pieces - 1;
    for (int p = 0; p < C.pieces; ++p) {
      C.kind[p] = d[1 + p];
      C.order[p] = d[1 + kMaxPieces + p];
      if (C.kind[p] != 0 && (C.order[p] < 1 || C.order[p] > 3)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      C.off[p] = o;
      o += C.kind[p] == 0 ? 3 : 1 + 7 * C.order[p];
    }
  }
  if (o != n_vals) return static_cast<int>(cudaErrorInvalidValue);
  P.lms_identity = lms_identity;
  P.y_scale = y_scale;
  P.c_scale = c_scale;

  const Geometry G{hy, hc, w, h_mid, h_out,
                   static_cast<const int*>(starts_y),
                   static_cast<const float*>(taps_y), n_taps_y,
                   static_cast<const int*>(starts_c),
                   static_cast<const float*>(taps_c), n_taps_c,
                   static_cast<const int*>(starts_o),
                   static_cast<const float*>(taps_o), n_taps_o,
                   static_cast<const int*>(tile_lo), win};
  const dim3 grid((w + kCols - 1) / kCols, (h_out + kTileRows - 1) / kTileRows,
                  batch);
  const dim3 block(kCols, kRowThreads);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(win) * kCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int attr_err = 0;
  const int err = vrt::dispatch_planes(y_dtype, c_dtype,
                                       [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    if (smem > 48 * 1024) {
      attr_err = static_cast<int>(cudaFuncSetAttribute(
          rows3_mid_kernel<TY, TC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (attr_err != 0) return;
    }
    rows3_mid_kernel<TY, TC><<<grid, block, smem, st>>>(
        static_cast<const TY*>(y), static_cast<const TC*>(u),
        static_cast<const TC*>(v), G, P, static_cast<float*>(out));
  });
  return attr_err != 0 ? attr_err : err;
}
