// K6: raw Y/U/V planes to the finished Jinc2-upscaled surface in one kernel,
// for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/jinc2_pallas.py: jinc2_convert_fused
// (body _make_kernel3, packing _pack_plane).  The Pallas kernel folded the
// chroma upsample into low-rank SVD weight matrices for the TPU's matrix
// unit; here one block of 256 threads covers one (frame, 32x32 output
// tile):
//   1. it loads the tile's source window (the taps of its outputs, luma
//      coordinates clamped to the plane) from the raw planes: Y directly,
//      U and V upsampled to the luma grid through the per-position tap
//      tables of the chroma upsample matrices (kernels/resize.plan_taps of
//      ops/chroma.chroma_upsample_matrices, which carry the reference's
//      clamping in chroma space);
//   2. it normalises, applies the 3x4 colour matrix and keeps the window's
//      RGB in shared memory as float32;
//   3. each thread resolves 4 adjacent outputs of one row with the direct
//      4x4-tap Jinc2 of jinc2.cuh: one set of 16 weights for the three
//      channels, anti-ringing on the RGB taps (as _make_kernel3:636-644);
//   4. dither from the GLOBAL pre-rotation row and column, or rounding (a
//      launch that makes a band of a larger frame's rows, a row shard of
//      parallel/spatial, gets that band's rows of the tap tables and
//      row0, the band's first row in the frame);
//   5. store: planar float RGB or one RGBA8 / R10G10B10A2 dword, 4 outputs
//      as one 16-byte store, at (row, col), or with out_transpose at
//      (col, row), through a shared-memory tile so that the transposed
//      store stays coalesced and vectorised too.
// The compute never depends on out_transpose, so the transposed surface is
// bit-identical to the transpose of the plain one.
//
// Weights.  An output's 16 weights depend only on its row's d2 4-vector and
// its column's (ops/scale.jinc2_axis_tables), and those repeat with the
// axes' phase periods: 2 x 2 distinct pairs at c3 (1080p -> 4K), 32 x 9 at
// c3rot.  The wrapper (kernels/jinc2.py) numbers each row's and column's
// distinct vector (its class) and builds, once per geometry and device, a
// table of 16 weights and their sum for every (row class, column class)
// pair with jinc2_weight_table_kernel, which calls the same jinc2_weights
// as the per-output route on the same bits, so the table route gives the
// per-output route's outputs bit for bit.  The table route (kWeights ==
// kTable) reads an output's entry as five 16-byte loads through the
// read-only path; a geometry whose table would pass the wrapper's cap (no
// short period on either axis) takes the per-output route of the same
// kernel (kPerOutput), which computes 16 accurate sqrtf, 32 sinf and 16
// divisions an output.
//
// Bound.  Device memory sees the raw planes about once and the surface
// once (~530 MB per 16 frames of 1080p -> 4K RGBA8: 0.17 ms on one H100).
// Without the weights an output still costs its 48 tap reads from shared
// memory and three resolves (16 products, 15 sums, a division and the
// anti-ringing each), so the issue of those instructions, not the bytes,
// bounds the table route.  When an axis's Jinc2 role is "up" its input is
// at most twice its output, so a tile's source window is at most
// 2 * 32 + 3 per axis: the window fits shared memory and the wrapper sizes
// it from the tap tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "jinc2.cuh"

namespace {

constexpr int kTile = 32;                     // output tile edge
constexpr int kVec = 4;                       // adjacent outputs a thread
constexpr int kColThreads = kTile / kVec;     // threads across a tile row
constexpr int kThreads = kColThreads * kTile; // 256: one row of 4 a thread
constexpr int kPitch = kTile + 1;             // staging pitch (no conflicts)

enum { kPerOutput = 0, kTable = 1 };

struct Geometry {
  int h, w, ch, cw, oh, ow;
  const int* by; const float* d2y;   // Jinc2 rows: (oh,), (4, oh)
  const int* bx; const float* d2x;   // Jinc2 cols: (ow,), (4, ow)
  const int* ux_s; const float* ux_t; int n_ux;  // chroma W taps over w
  const int* uy_s; const float* uy_t; int n_uy;  // chroma H taps over h
  int win_h, win_w;                  // shared-memory window capacity
  const int* row_cls;                // (oh,) each row's class; table route
  const int* col_cls;                // (ow,) each column's class
  const float* table;                // (n_row_cls, n_col_cls, kJ2Entry)
  int n_col_cls;
};

struct Params {
  float m[12];  // row-major 3 x (m0 m1 m2 c)
  float y_scale, c_scale;
  vrt::Quant quant;
  int row0;  // the frame row of output row 0 (the dither's)
  int pack, transpose;
};

template <typename T>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
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

// The 16 weights of output (row, col) and their sum: the table entry of
// its (row class, column class), or computed from its d2 vectors.
template <int kWeights>
__device__ __forceinline__ float weights_of(const Geometry& G, int rc,
                                            const float dy[4], int col,
                                            float wt[16]) {
  if constexpr (kWeights == kTable) {
    return vrt::jinc2_table_weights(G.table, G.n_col_cls, rc,
                                    __ldg(G.col_cls + col), wt);
  } else {
    float dx[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) dx[o] = __ldg(G.d2x + o * G.ow + col);
    return vrt::jinc2_weights(dy, dx, wt);
  }
}

template <typename T, int kWeights>
__global__ void __launch_bounds__(kThreads) jinc2_convert_kernel(
    const T* __restrict__ y, const T* __restrict__ u, const T* __restrict__ v,
    const Geometry G, const Params P, void* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
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
  for (int e = tid; e < nwh * nww; e += kThreads) {
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

  // 3-4. four adjacent outputs of one row a thread: row r0 + lr, columns
  // c0 + 4 * tx .. + 3
  const int tx = tid % kColThreads, lr = tid / kColThreads;
  const int row = r0 + lr, col0 = c0 + kVec * tx;
  const bool live = row < G.oh;
  float res[kVec][3];
  if (live) {
    int rc = 0;
    float dy[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kWeights == kTable) {
      rc = __ldg(G.row_cls + row);
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o) dy[o] = __ldg(G.d2y + o * G.oh + row);
    }
    const int wr = G.by[row] - 1 - wy0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int col = col0 + k;
      if (col >= G.ow) continue;
      float wt[16];
      const float wsum = weights_of<kWeights>(G, rc, dy, col, wt);
      const int wc = G.bx[col] - 1 - wx0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* win = smem + i * plane + wr * G.win_w + wc;
        float t[16];
#pragma unroll
        for (int jo = 0; jo < 4; ++jo) {
#pragma unroll
          for (int io = 0; io < 4; ++io) t[jo * 4 + io] = win[jo * G.win_w + io];
        }
        res[k][i] = vrt::quantize(vrt::jinc2_resolve(t, wt, wsum), P.quant,
                                  row + P.row0, col);
      }
    }
  }

  // 5. store
  const bool packed = P.pack != vrt::kPackNone;
  if (!P.transpose) {
    if (!live) return;
    const bool vec = (G.ow % kVec) == 0 && col0 + kVec <= G.ow &&
                     (reinterpret_cast<uintptr_t>(out) % 16) == 0;
    if (packed) {
      uint32_t* o = static_cast<uint32_t*>(out) + (b * G.oh + row) * G.ow + col0;
      Vec<uint32_t> wv;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        wv.v[k] = col0 + k < G.ow ? vrt::pack_word(res[k], P.pack) : 0u;
      }
      if (vec) {
        *reinterpret_cast<Vec<uint32_t>*>(o) = wv;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (col0 + k < G.ow) o[k] = wv.v[k];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float* o = static_cast<float*>(out) + ((b * 3 + i) * G.oh + row) * G.ow +
                   col0;
        if (vec) {
          Vec<float> fv;
#pragma unroll
          for (int k = 0; k < kVec; ++k) fv.v[k] = res[k][i];
          *reinterpret_cast<Vec<float>*>(o) = fv;
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (col0 + k < G.ow) o[k] = res[k][i];
          }
        }
      }
    }
    return;
  }
  // transposed: stage the tile, then write row c0 + lc of the output (a
  // column of the tile), each thread 4 consecutive pre-rotation rows
  float* stage = smem + 3 * plane;
  const int n_ch = packed ? 1 : 3;
  if (live) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (col0 + k >= G.ow) continue;
      const int lc = kVec * tx + k;
      if (packed) {
        reinterpret_cast<uint32_t*>(stage)[lr * kPitch + lc] =
            vrt::pack_word(res[k], P.pack);
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) stage[(i * kTile + lr) * kPitch + lc] = res[k][i];
      }
    }
  }
  __syncthreads();
  const int lc = tid / kColThreads, orow0 = r0 + kVec * (tid % kColThreads);
  if (c0 + lc >= G.ow || orow0 >= G.oh) return;
  const bool vec = (G.oh % kVec) == 0 && orow0 + kVec <= G.oh &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  for (int i = 0; i < n_ch; ++i) {
    const float* s = stage + (i * kTile + orow0 - r0) * kPitch + lc;
    const long long at = ((b * n_ch + i) * G.ow + c0 + lc) * G.oh + orow0;
    Vec<uint32_t> wv;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      wv.v[k] = __float_as_uint(s[k * kPitch]);
    }
    uint32_t* o = static_cast<uint32_t*>(out) + at;
    if (vec) {
      *reinterpret_cast<Vec<uint32_t>*>(o) = wv;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (orow0 + k < G.oh) o[k] = wv.v[k];
      }
    }
  }
}

template <typename T, int kWeights>
int launch(const void* y, const void* u, const void* v, int batch,
           const Geometry& G, const Params& P, void* out,
           cudaStream_t stream) {
  const size_t stage = P.transpose ? 3 * kTile * kPitch : 0;
  const size_t bytes =
      (3 * static_cast<size_t>(G.win_h) * G.win_w + stage) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jinc2_convert_kernel<T, kWeights>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((G.ow + kTile - 1) / kTile, (G.oh + kTile - 1) / kTile, batch);
  jinc2_convert_kernel<T, kWeights><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(u),
      static_cast<const T*>(v), G, P, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_route(const void* y, const void* u, const void* v, int batch,
                 const Geometry& G, const Params& P, void* out,
                 cudaStream_t stream) {
  return G.table != nullptr
             ? launch<T, kTable>(y, u, v, batch, G, P, out, stream)
             : launch<T, kPerOutput>(y, u, v, batch, G, P, out, stream);
}

// One thread per (row class, column class) entry: jinc2_weights of the
// classes' d2 vectors, the function the per-output routes of K6 and K5
// (jinc2_resize.cu, which reads the same tables) call.
__global__ void jinc2_weight_table_kernel(const float* __restrict__ d2y,
                                          int n_row_cls,
                                          const float* __restrict__ d2x,
                                          int n_col_cls,
                                          float* __restrict__ table) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_row_cls * n_col_cls) return;
  const int r = e / n_col_cls, c = e - r * n_col_cls;
  float dy[4], dx[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    dy[o] = d2y[o * n_row_cls + r];
    dx[o] = d2x[o * n_col_cls + c];
  }
  float wt[16];
  const float wsum = vrt::jinc2_weights(dy, dx, wt);
  float* t = table + static_cast<long long>(e) * vrt::kJ2Entry;
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = wt[k];
  t[16] = wsum;
  t[17] = t[18] = t[19] = 0.f;
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
// row_cls (oh,), col_cls (ow,) and table (n_row_cls x n_col_cls entries of
// 20 floats, from vrt_jinc2_weight_table): the table route; table NULL:
// the per-output route, which computes each output's weights.
extern "C" int vrt_jinc2_convert(
    const void* y, const void* u, const void* v, int dtype, int batch, int h,
    int w, int ch, int cw, int oh, int ow, const void* by, const void* d2y,
    const void* bx, const void* d2x, const void* ux_starts,
    const void* ux_taps, int n_ux, const void* uy_starts, const void* uy_taps,
    int n_uy, float y_scale, float c_scale, const void* host_cmat,
    int dither_bits, int row0, int pack, int transpose, int win_h, int win_w,
    const void* row_cls, const void* col_cls, const void* table,
    int n_col_cls, void* out, void* stream) {
  Geometry G{h, w, ch, cw, oh, ow,
             static_cast<const int*>(by), static_cast<const float*>(d2y),
             static_cast<const int*>(bx), static_cast<const float*>(d2x),
             static_cast<const int*>(ux_starts),
             static_cast<const float*>(ux_taps), n_ux,
             static_cast<const int*>(uy_starts),
             static_cast<const float*>(uy_taps), n_uy, win_h, win_w,
             static_cast<const int*>(row_cls),
             static_cast<const int*>(col_cls),
             static_cast<const float*>(table), n_col_cls};
  if (table != nullptr && (row_cls == nullptr || col_cls == nullptr ||
                           n_col_cls < 1 ||
                           (reinterpret_cast<uintptr_t>(table) % 16) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P;
  const float* hm = static_cast<const float*>(host_cmat);
  for (int i = 0; i < 12; ++i) P.m[i] = hm[i];
  P.y_scale = y_scale;
  P.c_scale = c_scale;
  P.quant = vrt::make_quant(dither_bits);
  P.row0 = row0;
  P.pack = pack;
  P.transpose = transpose;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_route<uint8_t>(y, u, v, batch, G, P, out, st);
    case 1: return launch_route<uint16_t>(y, u, v, batch, G, P, out, st);
    case 3: return launch_route<float>(y, u, v, batch, G, P, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The weight table of one geometry: d2y (4, n_row_cls) and d2x
// (4, n_col_cls) float32 hold each class's d2 vector (kernels/jinc2.
// axis_classes); table (n_row_cls * n_col_cls * 20 floats, 16-byte
// aligned) receives, for entry (r, c) at (r * n_col_cls + c) * 20, the 16
// weights row-major (jo * 4 + io), their sum, then 3 zeros.
extern "C" int vrt_jinc2_weight_table(const void* d2y, int n_row_cls,
                                      const void* d2x, int n_col_cls,
                                      void* table, void* stream) {
  const long long n = static_cast<long long>(n_row_cls) * n_col_cls;
  if (n_row_cls < 1 || n_col_cls < 1 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBlock = 128;
  jinc2_weight_table_kernel<<<static_cast<int>((n + kBlock - 1) / kBlock),
                              kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2y), n_row_cls,
      static_cast<const float*>(d2x), n_col_cls, static_cast<float*>(table));
  return static_cast<int>(cudaGetLastError());
}
