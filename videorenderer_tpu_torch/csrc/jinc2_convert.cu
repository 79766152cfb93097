// K6: raw Y/U/V planes to the finished Jinc2-upscaled surface in one kernel,
// for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/jinc2_pallas.py: jinc2_convert_fused
// (body _make_kernel3, packing _pack_plane).  The Pallas kernel folded the
// chroma upsample into low-rank SVD weight matrices for the TPU's matrix
// unit; here one thread block covers one (frame, 32x32 output tile):
//   1. it loads the tile's source window (the taps of its outputs, luma
//      coordinates clamped to the plane) from the raw planes: Y directly,
//      U and V upsampled to the luma grid through the per-position tap
//      tables of the chroma upsample matrices (kernels/resize.plan_taps of
//      ops/chroma.chroma_upsample_matrices, which carry the reference's
//      clamping in chroma space);
//   2. it normalises, applies the 3x4 colour matrix and keeps the window's
//      RGB in shared memory as float32;
//   3. each thread resolves 4 outputs with the direct 4x4-tap Jinc2 of
//      jinc2.cuh: one set of 16 weights for the three channels,
//      anti-ringing on the RGB taps (as _make_kernel3:636-644);
//   4. dither from the GLOBAL pre-rotation row and column, or rounding;
//   5. store: planar float RGB or one RGBA8 / R10G10B10A2 dword, at
//      (row, col), or with out_transpose at (col, row), through a
//      shared-memory tile so the transposed store stays coalesced.
// The compute never depends on out_transpose, so the transposed surface is
// bit-identical to the transpose of the plain one.
//
// Bound: arithmetic, as K5: 16 accurate sqrtf, 32 sinf and 16 divisions
// per output pixel; device memory sees the raw planes about once and the
// surface once (~530 MB per 16 frames of 1080p -> 4K RGBA8).  When an axis's
// Jinc2 role is "up" its input is at most twice its output, so a tile's
// source window is at most 2 * 32 + 3 per axis: the window fits shared
// memory and the wrapper sizes it from the tap tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "jinc2.cuh"

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kRowsPerPass = 8;  // block is kTile x kRowsPerPass threads
constexpr int kPitch = kTile + 1;  // staging pitch (no bank conflicts)

struct Geometry {
  int h, w, ch, cw, oh, ow;
  const int* by; const float* d2y;   // Jinc2 rows: (oh,), (4, oh)
  const int* bx; const float* d2x;   // Jinc2 cols: (ow,), (4, ow)
  const int* ux_s; const float* ux_t; int n_ux;  // chroma W taps over w
  const int* uy_s; const float* uy_t; int n_uy;  // chroma H taps over h
  int win_h, win_w;                  // shared-memory window capacity
};

struct Params {
  float m[12];  // row-major 3 x (m0 m1 m2 c)
  float y_scale, c_scale;
  vrt::Quant quant;
  int pack, transpose;
};

// One chroma plane at luma (pr, pc): sum over the H taps of the sums over
// the W taps (taps past the matrix are zero and skipped), times c_scale.
template <typename T>
__device__ __forceinline__ float chroma_at(const T* __restrict__ p,
                                           const Geometry& G, float c_scale,
                                           int pr, int pc) {
  auto row_val = [&](int cr) {
    const T* rp = p + static_cast<long long>(cr) * G.cw;
    if (G.n_ux == 0) return static_cast<float>(rp[pc]);
    const int s = G.ux_s[pc];
    float acc = 0.f;
    for (int b = 0; b < G.n_ux; ++b) {
      if (s + b < G.cw) {
        acc = fmaf(G.ux_t[b * G.w + pc], static_cast<float>(rp[s + b]), acc);
      }
    }
    return acc;
  };
  float v;
  if (G.n_uy == 0) {
    v = row_val(pr);
  } else {
    const int s = G.uy_s[pr];
    v = 0.f;
    for (int a = 0; a < G.n_uy; ++a) {
      if (s + a < G.ch) v = fmaf(G.uy_t[a * G.h + pr], row_val(s + a), v);
    }
  }
  return __fmul_rn(v, c_scale);
}

// ((m0*y + m1*u) + m2*v) + c, the order of the plain version
__device__ __forceinline__ float cmat_row(float m0, float m1, float m2,
                                          float c, float y, float u, float v) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m0, y), __fmul_rn(m1, u)), __fmul_rn(m2, v)),
      c);
}

template <typename T>
__global__ void jinc2_convert_kernel(const T* __restrict__ y,
                                     const T* __restrict__ u,
                                     const T* __restrict__ v, Geometry G,
                                     Params P, void* __restrict__ out) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int r1 = min(r0 + kTile, G.oh), c1 = min(c0 + kTile, G.ow);
  const long long b = blockIdx.z;

  // 1-2. the RGB window of this tile's taps
  const int wy0 = G.by[r0] - 1, wx0 = G.bx[c0] - 1;
  const int nwh = G.by[r1 - 1] + 3 - wy0, nww = G.bx[c1 - 1] + 3 - wx0;
  const int plane = G.win_h * G.win_w;
  const T* yb = y + b * G.h * G.w;
  const T* ub = u + b * G.ch * G.cw;
  const T* vb = v + b * G.ch * G.cw;
  for (int e = tid; e < nwh * nww; e += kTile * kRowsPerPass) {
    const int wr = e / nww, wc = e - (e / nww) * nww;
    const int pr = min(max(wy0 + wr, 0), G.h - 1);
    const int pc = min(max(wx0 + wc, 0), G.w - 1);
    const float yv = __fmul_rn(
        static_cast<float>(yb[static_cast<long long>(pr) * G.w + pc]),
        P.y_scale);
    const float uv = chroma_at(ub, G, P.c_scale, pr, pc);
    const float vv = chroma_at(vb, G, P.c_scale, pr, pc);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      smem[i * plane + wr * G.win_w + wc] = cmat_row(
          P.m[4 * i], P.m[4 * i + 1], P.m[4 * i + 2], P.m[4 * i + 3], yv, uv, vv);
    }
  }
  __syncthreads();

  // 3-4. four outputs per thread: rows r0 + ty + 8k, column c0 + tx
  const int col = c0 + tx;
  float res[4][3];
#pragma unroll
  for (int k = 0; k < kTile / kRowsPerPass; ++k) {
    const int row = r0 + ty + kRowsPerPass * k;
    if (row >= G.oh || col >= G.ow) continue;
    float dy[4], dx[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      dy[o] = G.d2y[o * G.oh + row];
      dx[o] = G.d2x[o * G.ow + col];
    }
    float wt[16];
    const float wsum = vrt::jinc2_weights(dy, dx, wt);
    const int wr = G.by[row] - 1 - wy0, wc = G.bx[col] - 1 - wx0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* win = smem + i * plane + wr * G.win_w + wc;
      float t[16];
#pragma unroll
      for (int jo = 0; jo < 4; ++jo) {
#pragma unroll
        for (int io = 0; io < 4; ++io) t[jo * 4 + io] = win[jo * G.win_w + io];
      }
      res[k][i] = vrt::quantize(vrt::jinc2_resolve(t, wt, wsum), P.quant, row,
                                col);
    }
  }

  // 5. store
  if (!P.transpose) {
#pragma unroll
    for (int k = 0; k < kTile / kRowsPerPass; ++k) {
      const int row = r0 + ty + kRowsPerPass * k;
      if (row >= G.oh || col >= G.ow) continue;
      if (P.pack != vrt::kPackNone) {
        static_cast<uint32_t*>(out)[(b * G.oh + row) * G.ow + col] =
            vrt::pack_word(res[k], P.pack);
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          static_cast<float*>(out)[((b * 3 + i) * G.oh + row) * G.ow + col] =
              res[k][i];
        }
      }
    }
    return;
  }
  // transposed: stage the tile, then write row c of the output (a column of
  // the tile) with consecutive threads on consecutive pre-rotation rows
  float* stage = smem + 3 * plane;
  const int n_ch = P.pack != vrt::kPackNone ? 1 : 3;
#pragma unroll
  for (int k = 0; k < kTile / kRowsPerPass; ++k) {
    const int lr = ty + kRowsPerPass * k;
    if (r0 + lr >= G.oh || col >= G.ow) continue;
    if (n_ch == 1) {
      reinterpret_cast<uint32_t*>(stage)[lr * kPitch + tx] =
          vrt::pack_word(res[k], P.pack);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        stage[(i * kTile + lr) * kPitch + tx] = res[k][i];
      }
    }
  }
  __syncthreads();
  const int orow = r0 + tx;  // pre-rotation row = output column
#pragma unroll
  for (int k = 0; k < kTile / kRowsPerPass; ++k) {
    const int lc = ty + kRowsPerPass * k;
    if (orow >= G.oh || c0 + lc >= G.ow) continue;
    if (n_ch == 1) {
      static_cast<uint32_t*>(out)[(b * G.ow + c0 + lc) * G.oh + orow] =
          reinterpret_cast<const uint32_t*>(stage)[tx * kPitch + lc];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        static_cast<float*>(out)[((b * 3 + i) * G.ow + c0 + lc) * G.oh + orow] =
            stage[(i * kTile + tx) * kPitch + lc];
      }
    }
  }
}

template <typename T>
int launch(const void* y, const void* u, const void* v, int batch,
           const Geometry& G, const Params& P, void* out,
           cudaStream_t stream) {
  const size_t stage = P.transpose ? 3 * kTile * kPitch : 0;
  const size_t bytes =
      (3 * static_cast<size_t>(G.win_h) * G.win_w + stage) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jinc2_convert_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kTile, kRowsPerPass);
  const dim3 grid((G.ow + kTile - 1) / kTile, (G.oh + kTile - 1) / kTile, batch);
  jinc2_convert_kernel<T><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(u),
      static_cast<const T*>(v), G, P, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (batch, h, w), u/v (batch, ch, cw), all of one dtype: 0 uint8,
// 1 uint16, 3 float32 (kernels/resize.py: DTYPE_CODES).  by/d2y, bx/d2x:
// ops/scale.jinc2_axis_tables of (h, oh) and (w, ow).  ux_* (n_ux, w) and
// uy_* (n_uy, h): plan_taps of the chroma upsample matrices; n = 0 means
// that axis is not subsampled.  host_cmat is HOST memory, 12 floats
// row-major 3 x (m0 m1 m2 c).  pack: 0 planar float (batch, 3, oh, ow),
// 1 R10G10B10A2, 2 RGBA8 (batch, oh, ow) int32; transpose stores
// (batch, [3,] ow, oh).  win_h x win_w bounds every tile's source window.
extern "C" int vrt_jinc2_convert(
    const void* y, const void* u, const void* v, int dtype, int batch, int h,
    int w, int ch, int cw, int oh, int ow, const void* by, const void* d2y,
    const void* bx, const void* d2x, const void* ux_starts,
    const void* ux_taps, int n_ux, const void* uy_starts, const void* uy_taps,
    int n_uy, float y_scale, float c_scale, const void* host_cmat,
    int dither_bits, int pack, int transpose, int win_h, int win_w,
    void* out, void* stream) {
  Geometry G{h, w, ch, cw, oh, ow,
             static_cast<const int*>(by), static_cast<const float*>(d2y),
             static_cast<const int*>(bx), static_cast<const float*>(d2x),
             static_cast<const int*>(ux_starts),
             static_cast<const float*>(ux_taps), n_ux,
             static_cast<const int*>(uy_starts),
             static_cast<const float*>(uy_taps), n_uy, win_h, win_w};
  Params P;
  const float* hm = static_cast<const float*>(host_cmat);
  for (int i = 0; i < 12; ++i) P.m[i] = hm[i];
  P.y_scale = y_scale;
  P.c_scale = c_scale;
  P.quant = vrt::make_quant(dither_bits);
  P.pack = pack;
  P.transpose = transpose;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<uint8_t>(y, u, v, batch, G, P, out, st);
    case 1: return launch<uint16_t>(y, u, v, batch, G, P, out, st);
    case 3: return launch<float>(y, u, v, batch, G, P, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
