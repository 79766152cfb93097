// K4: the whole fused pipeline in one kernel, for Hopper (sm_90a): per plane
// the W map, then the H map, then the shared tail (colour matrix,
// correction, local tone map, quantization), planar float32 out.
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: mega3_tail (the
// per-plane plan _MegaPlane, the tile body _mega_plane_tile).  The raw
// planes are read and the finished pixels written; nothing in between
// reaches device memory, in particular not the W-passed "mid16" planes the
// two-stage route (K1 then K2) writes and reads back.
//
// One block per (frame, 32 output columns, 32 output rows), 32 x 8 threads:
//   1. for each plane, the W pass of the input rows its 32 output rows'
//      H taps reach (the tile's window, kernels/resize.BandedMatrix
//      .row_windows), over the block's 32 columns: fp32 FMAs over K1's
//      per-column tap table, or, for a plane with no W map, a direct read
//      times its scale; into shared memory, one float per (row, column);
//   2. each thread runs its outputs' H taps from shared memory (a plane
//      with no H map reads its own row of the window), then color_tail and
//      the quantization of tail.cuh / epilogue.cuh, and stores planar
//      float32 (..., 3, h_out, w_out).
// The normalisation of the raw planes is folded into the first map that
// touches each plane, or is the direct read's scale (kernels/resize.
// mega_maps).  The TPU kernel's split-bf16 three-pass products, lane-shifted
// copies and 128-wide windows were artefacts of the MXU and the lane tiling
// and are gone.
//
// Bound.  Device memory: the raw planes read once (~0.40 GB per 16 headline
// frames) and the float32 output written once (~0.40 GB).  Where row windows
// overlap (a 2:1 Lanczos3 luma tile of 32 rows reaches ~76 input rows) the W
// pass is recomputed, about 1.2x the W FMAs at the headline, and neighbouring
// blocks read the overlap again (from L2).  The tail is K2's, with its
// accurate transcendentals.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "tail.cuh"

namespace {

constexpr int kCols = 32;       // columns of a block (threadIdx.x)
constexpr int kRowThreads = 8;  // threadIdx.y
constexpr int kTileRows = 32;   // output rows of a block (kernels/resize.py)

// One plane class's maps (luma, or both chroma planes).
struct PlaneMaps {
  int h_in, w_in;
  const int* sx; const float* tx; int ntx;   // W map, 0 taps: none
  const int* sy; const float* ty; int nty;   // H map, 0 taps: none
  const int* lo;                             // first input row of each tile
  int win;                                   // rows of the widest window
};

struct Geometry {
  int h_out, w_out;
  PlaneMaps y, c;
};

// The W pass of one input row at output column ``col``.
template <typename T>
__device__ __forceinline__ float w_pass(const T* __restrict__ row,
                                        const PlaneMaps& M, int w_out, int col,
                                        float scale) {
  if (M.ntx == 0) return vrt::mul(static_cast<float>(row[col]), scale);
  const int s = M.sx[col];
  float acc = 0.f;
  for (int t = 0; t < M.ntx; ++t) {
    const int i = s + t;
    if (i < M.w_in) {
      acc = fmaf(static_cast<float>(row[i]), M.tx[t * w_out + col], acc);
    }
  }
  return acc;
}

// The W-passed rows lo .. lo + n - 1 of one plane into ``win`` (row-major,
// kCols floats a row); columns past the output are zero.
template <typename T>
__device__ __forceinline__ void fill_window(const T* __restrict__ plane,
                                            const PlaneMaps& M, int w_out,
                                            int col, int lo, int n,
                                            float scale, float* win) {
  for (int m = threadIdx.y; m < n; m += kRowThreads) {
    float val = 0.f;
    if (col < w_out) {
      val = w_pass(plane + static_cast<long long>(lo + m) * M.w_in, M, w_out,
                   col, scale);
    }
    win[m * kCols + threadIdx.x] = val;
  }
}

// The H pass of output row ``r`` from the window starting at input row lo.
__device__ __forceinline__ float h_pass(const float* win, const PlaneMaps& M,
                                        int h_out, int lo, int r) {
  if (M.nty == 0) return win[(r - lo) * kCols + threadIdx.x];
  const int s = M.sy[r];
  float acc = 0.f;
  for (int t = 0; t < M.nty; ++t) {
    const int i = s + t;
    if (i < M.h_in) {
      acc = fmaf(win[(i - lo) * kCols + threadIdx.x], M.ty[t * h_out + r],
                 acc);
    }
  }
  return acc;
}

// grid: x = column strips of kCols, y = tiles of kTileRows output rows,
// z = frames; block (kCols, kRowThreads).  kExt: the tail carries the L2
// trims and the guided curve (tail.cuh), for the launches that need them.
template <typename TY, typename TC, bool kExt>
__global__ void __launch_bounds__(kCols * kRowThreads) mega3_tail_kernel(
    const TY* __restrict__ y, const TC* __restrict__ u,
    const TC* __restrict__ v, const Geometry G, const vrt::TailParams P,
    float* __restrict__ out) {
  extern __shared__ float smem[];   // [G.y.win][kCols], then 2 x [G.c.win][kCols]
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int tile = blockIdx.y;
  const int r0 = tile * kTileRows;
  const long long b = blockIdx.z;
  const int lo_y = G.y.nty ? G.y.lo[tile] : r0;
  const int lo_c = G.c.nty ? G.c.lo[tile] : r0;
  float* wy = smem;
  float* wu = wy + G.y.win * kCols;
  float* wv = wu + G.c.win * kCols;
  const long long plane_y = static_cast<long long>(G.y.h_in) * G.y.w_in;
  const long long plane_c = static_cast<long long>(G.c.h_in) * G.c.w_in;
  fill_window(y + b * plane_y, G.y, G.w_out, col, lo_y,
              min(G.y.win, G.y.h_in - lo_y), P.y_scale, wy);
  fill_window(u + b * plane_c, G.c, G.w_out, col, lo_c,
              min(G.c.win, G.c.h_in - lo_c), P.c_scale, wu);
  fill_window(v + b * plane_c, G.c, G.w_out, col, lo_c,
              min(G.c.win, G.c.h_in - lo_c), P.c_scale, wv);
  __syncthreads();
  if (col >= G.w_out) return;

  const int r_end = min(r0 + kTileRows, G.h_out);
  for (int r = r0 + threadIdx.y; r < r_end; r += kRowThreads) {
    const float yv = h_pass(wy, G.y, G.h_out, lo_y, r);
    const float uv = h_pass(wu, G.c, G.h_out, lo_c, r);
    const float vv = h_pass(wv, G.c, G.h_out, lo_c, r);
    float c[3];
    vrt::color_tail<vrt::kRuntime, vrt::kRuntime, vrt::kRuntime, kExt>(
        P.tail, yv, uv, vv, c);
    vrt::store_pixel(c, P.quant, vrt::kPackNone, out, b, G.h_out, G.w_out, r,
                     col);
  }
}

}  // namespace

// Dtype codes: 0 uint8, 1 uint16, 2 int16, 3 float32.  Per plane class (y,
// c): the W map's (starts, taps, T) and the H map's (starts, taps, T), T = 0
// for no map; ``lo_*`` (device, one int per tile of 32 output rows) and
// ``win_*`` give each tile's window of input rows
// (kernels/resize.BandedMatrix.row_windows), or NULL and 32 for a plane
// without an H map (its height is h_out).  A plane without a W map (its
// width is w_out) is read times ``y_scale``/``c_scale``.  ``host_mats`` is
// HOST memory: the colour matrix (12 floats), the gamut matrix (9), the 5
// tone-map scalars, the SDR BT.2020 fix's gamma, the L2 trims and the
// guided curve (tail.cuh's make_tail).  ``out`` is (batch, 3, h_out,
// w_out) float32.
extern "C" int vrt_mega3_tail(
    const void* y, int y_dtype, const void* u, const void* v, int c_dtype,
    int batch, int hy, int wy, int hc, int wc, int h_out, int w_out,
    const void* sx_y, const void* tx_y, int ntx_y, const void* sx_c,
    const void* tx_c, int ntx_c, const void* sy_y, const void* ty_y,
    int nty_y, const void* lo_y, int win_y, const void* sy_c,
    const void* ty_c, int nty_c, const void* lo_c, int win_c, float y_scale,
    float c_scale, const void* host_mats, int apply_matrix, int correction,
    int tonemap, float luminance_scale, int dither_bits, void* out,
    void* stream) {
  const vrt::TailParams P = vrt::make_tail_params(
      host_mats, apply_matrix, correction, tonemap, luminance_scale, y_scale,
      c_scale, dither_bits, vrt::kPackNone);
  const Geometry G{
      h_out, w_out,
      PlaneMaps{hy, wy, static_cast<const int*>(sx_y),
                static_cast<const float*>(tx_y), ntx_y,
                static_cast<const int*>(sy_y), static_cast<const float*>(ty_y),
                nty_y, static_cast<const int*>(lo_y), win_y},
      PlaneMaps{hc, wc, static_cast<const int*>(sx_c),
                static_cast<const float*>(tx_c), ntx_c,
                static_cast<const int*>(sy_c), static_cast<const float*>(ty_c),
                nty_c, static_cast<const int*>(lo_c), win_c}};
  const dim3 grid((w_out + kCols - 1) / kCols,
                  (h_out + kTileRows - 1) / kTileRows, batch);
  const dim3 block(kCols, kRowThreads);
  const size_t smem =
      sizeof(float) * kCols * (static_cast<size_t>(win_y) + 2 * win_c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int attr_err = 0;
  auto run = [&](auto kernel, auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    if (smem > 48 * 1024) {
      attr_err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (attr_err != 0) return;
    }
    kernel<<<grid, block, smem, st>>>(
        static_cast<const TY*>(y), static_cast<const TC*>(u),
        static_cast<const TC*>(v), G, P, static_cast<float*>(out));
  };
  const bool ext = P.tail.trims != vrt::kTrimsNone ||
                   tonemap == vrt::kTmGuided;
  const int err = vrt::dispatch_planes(y_dtype, c_dtype,
                                       [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    if (ext) {
      run(mega3_tail_kernel<TY, TC, true>, y_tag, c_tag);
    } else {
      run(mega3_tail_kernel<TY, TC, false>, y_tag, c_tag);
    }
  });
  return attr_err != 0 ? attr_err : err;
}
