// K3: banded resize along the H axis (the second-to-last), for Hopper
// (sm_90a).
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: banded_resize_rows
// (and its packed form banded_resize_rows_packed, body _kernel_rows).
// out[b, r, c] = sum_t x[b, starts[r] + t, c] * taps[t, r] over a per-output-
// row tap table (kernels/resize.py: plan_taps), any normalisation folded into
// the taps as K1 does, t = 0 .. T-1 in order in fp32 FMAs, rows past the
// input skipped.  Input uint8, uint16, int16 or float32; output float32.
//
// Design: K2's H pass (rows3_tail.cuh) for one plane.  A block of 256
// threads makes tile_rows output rows x 128 columns of one frame:
//   * input.  It copies the window of input rows its tile's taps reach
//     (kernels/resize.BandedMatrix.row_windows) over its 128 columns into
//     shared memory, with 16-byte cp.async where the rows are 16-byte
//     aligned and element copies where they are not.  Each input byte then
//     comes from device memory once, and only the window's halo rows (T - 2
//     of them at 2:1) twice, where the one-output-a-thread kernel this
//     replaces read every input row about three times through L2.
//   * taps.  The tile's starts and taps come into shared memory once.
//   * output.  Each thread runs the taps of 4 consecutive columns, one
//     vector load from shared memory a tap, for every 8th row of the tile,
//     and stores the 4 sums as one 16-byte store where the row is aligned.
// Every output is bit-equal to the kernel this replaces: acc = 0, then
// acc = fmaf(x, tap, acc) over the taps in order, the conversion to float
// exact (stage.cuh's to_float).
//
// Bound: device memory.  At the letterboxed path's shapes (a 2.39:1 scope
// film, 1608 -> 804 rows, Lanczos3 at 2:1) each output reads 2 input floats
// and writes one, with 6 FMAs: far below the compute roof.  The wrapper
// picks tile_rows (kernels/resize.k3_tile_rows): 32 where the window fits
// the shared-memory budget, fewer for a map with many taps; a map whose
// window does not fit at one row (2160 rows to 16 with Lanczos: 408 KB)
// takes the long-window kernel, which stages nothing and reads every tap
// through the read-only cache, bit-equal to the staged one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

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

struct Map {
  int h_in, h_out, w, n_taps, tile_rows;
  const int* starts;   // (h_out,)
  const float* taps;   // (n_taps, h_out)
  const int* lo;       // first input row of each tile's window
  int win;             // rows of the widest window
};

// Shared memory of a block: the window (win rows x kTileCols), then the
// tile's taps (n_taps x tile_rows floats) and starts (tile_rows ints).
// kernels/resize.k3_smem_bytes mirrors it.
template <typename T>
__host__ __device__ inline size_t window_bytes(const Map& M) {
  return static_cast<size_t>(M.win) * kTileCols * sizeof(T);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(const Map& M) {
  return window_bytes<T>(M) +
         static_cast<size_t>(M.n_taps + 1) * M.tile_rows * sizeof(float);
}

// grid: x = row tiles x frames (tile-major within a frame), y = column tiles
template <typename T>
__global__ void __launch_bounds__(kThreads) banded_resize_rows_kernel(
    const T* __restrict__ x, const Map M, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  float* taps = reinterpret_cast<float*>(smem + window_bytes<T>(M));
  int* starts = reinterpret_cast<int*>(taps + M.n_taps * M.tile_rows);
  const int n_tiles = (M.h_out + M.tile_rows - 1) / M.tile_rows;
  const long long b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - static_cast<int>(b) * n_tiles;
  const int r0 = tile * M.tile_rows;
  const int rows = min(M.tile_rows, M.h_out - r0);
  const int col0 = blockIdx.y * kTileCols;
  const int lo = M.lo[tile];
  const int n = min(M.win, M.h_in - lo);
  const T* plane = x + b * M.h_in * static_cast<long long>(M.w);
  const int tid = threadIdx.y * kColThreads + threadIdx.x;

  // the window: rows lo .. lo + n - 1, columns col0 .. + kTileCols - 1
  // (zero past w)
  if (vrt::rows_aligned16(x, M.w)) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kChunks = kTileCols / kChunk;
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int k = i - r * kChunks;
      const int col = col0 + k * kChunk;
      T* d = win + r * kTileCols + k * kChunk;
      if (col < M.w) {
        vrt::cp_async16(d, plane + static_cast<long long>(lo + r) * M.w + col);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = tid; i < n * kTileCols; i += kThreads) {
      const int r = i / kTileCols;
      const int col = col0 + (i - r * kTileCols);
      win[i] = col < M.w ? plane[static_cast<long long>(lo + r) * M.w + col]
                         : T(0);
    }
  }
  // the tile's starts and taps (rows past h_out zero)
  for (int i = tid; i < M.tile_rows; i += kThreads) {
    starts[i] = r0 + i < M.h_out ? M.starts[r0 + i] : 0;
  }
  for (int i = tid; i < M.n_taps * M.tile_rows; i += kThreads) {
    const int t = i / M.tile_rows;
    const int r = r0 + (i - t * M.tile_rows);
    taps[i] = r < M.h_out ? M.taps[static_cast<long long>(t) * M.h_out + r]
                          : 0.f;
  }
  vrt::cp_async_wait_all();
  __syncthreads();

  const int col = col0 + threadIdx.x * kVec;
  if (col >= M.w) return;
  const bool vec = M.w % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % sizeof(Vec<float>)) == 0;
  const T* base = win + threadIdx.x * kVec;
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int s = starts[m];
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < M.n_taps; ++t) {
      const int i = s + t;
      if (i < M.h_in) {
        const float wt = taps[t * M.tile_rows + m];
        const Vec<T> v =
            *reinterpret_cast<const Vec<T>*>(base + (i - lo) * kTileCols);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          acc[k] = fmaf(vrt::to_float(v.v[k]), wt, acc[k]);
        }
      }
    }
    float* o = out + (b * M.h_out + r0 + m) * static_cast<long long>(M.w) + col;
    if (vec) {
      Vec<float> f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) f.v[k] = acc[k];
      *reinterpret_cast<Vec<float>*>(o) = f;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (col + k < M.w) o[k] = acc[k];
      }
    }
  }
}

// The long-window route: the kernel above without the window, for maps
// whose window does not fit shared memory even at one output row a tile (a
// strong downscale).  Each thread makes 4 columns of its output rows,
// reading each tap's row straight from device memory through the read-only
// cache (one vector load where aligned), its start and weights likewise
// (one address a warp), the FMAs in the same order with the same guard, so
// its outputs are the staged route's bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads) banded_resize_rows_long_kernel(
    const T* __restrict__ x, const Map M, float* __restrict__ out) {
  const int n_tiles = (M.h_out + M.tile_rows - 1) / M.tile_rows;
  const long long b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - static_cast<int>(b) * n_tiles;
  const int r0 = tile * M.tile_rows;
  const int rows = min(M.tile_rows, M.h_out - r0);
  const int col = blockIdx.y * kTileCols + threadIdx.x * kVec;
  if (col >= M.w) return;
  const T* plane = x + b * M.h_in * static_cast<long long>(M.w);
  const bool in_vec = M.w % kVec == 0 && col + kVec <= M.w &&
                      (reinterpret_cast<uintptr_t>(x) % sizeof(Vec<T>)) == 0;
  const bool vec = M.w % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % sizeof(Vec<float>)) == 0;
  for (int m = threadIdx.y; m < rows; m += kRowThreads) {
    const int r = r0 + m;
    const int s = __ldg(M.starts + r);
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < M.n_taps; ++t) {
      const int i = s + t;
      if (i < M.h_in) {
        const float wt =
            __ldg(M.taps + static_cast<long long>(t) * M.h_out + r);
        const T* p = plane + static_cast<long long>(i) * M.w + col;
        Vec<T> v;
        if (in_vec) {
          v = vrt::ldg_as<Vec<T>>(p);
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            v.v[k] = col + k < M.w ? __ldg(p + k) : T(0);
          }
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          acc[k] = fmaf(vrt::to_float(v.v[k]), wt, acc[k]);
        }
      }
    }
    float* o = out + (b * M.h_out + r) * static_cast<long long>(M.w) + col;
    if (vec) {
      Vec<float> f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) f.v[k] = acc[k];
      *reinterpret_cast<Vec<float>*>(o) = f;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (col + k < M.w) o[k] = acc[k];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const Map& M, int batch, float* out,
           bool long_window, cudaStream_t stream) {
  const long long n_tiles = (M.h_out + M.tile_rows - 1) / M.tile_rows;
  const dim3 grid(static_cast<unsigned>(n_tiles * batch),
                  (M.w + kTileCols - 1) / kTileCols);
  if (long_window) {
    banded_resize_rows_long_kernel<T>
        <<<grid, dim3(kColThreads, kRowThreads), 0, stream>>>(
            static_cast<const T*>(x), M, out);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes<T>(M);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = banded_resize_rows_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, dim3(kColThreads, kRowThreads), smem, stream>>>(
      static_cast<const T*>(x), M, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 uint8, 1 uint16, 2 int16, 3 float32 (kernels/resize.py:
// DTYPE_CODES).  x is (batch, h_in, w), out (batch, h_out, w), both
// contiguous.  tile_lo (device, one int per tile of tile_rows output rows)
// and win are the tiles' first input row and the widest window
// (kernels/resize.BandedMatrix.row_windows(tile_rows)).  ``long_window``:
// the long-window kernel (no shared memory), else the staged one, which
// returns cudaErrorInvalidValue for a block over kSmemBudget.
extern "C" int vrt_banded_resize_rows(const void* x, int x_dtype,
                                      const void* starts, const void* taps,
                                      const void* tile_lo, int win,
                                      void* out, int batch, int h_in,
                                      int h_out, int w, int n_taps,
                                      int tile_rows, int long_window,
                                      void* stream) {
  if (tile_rows < 1 || (win < 1 && !long_window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Map M{h_in, h_out, w, n_taps, tile_rows,
              static_cast<const int*>(starts), static_cast<const float*>(taps),
              static_cast<const int*>(tile_lo), win};
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch<uint8_t>(x, M, batch, o, long_window != 0, st);
    case 1: return launch<uint16_t>(x, M, batch, o, long_window != 0, st);
    case 2: return launch<int16_t>(x, M, batch, o, long_window != 0, st);
    case 3: return launch<float>(x, M, batch, o, long_window != 0, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
