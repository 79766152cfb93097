// K1: banded resize along the last axis, for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: banded_resize_last_axis
// (body _make_kernel_cols).  out[r, j] = sum_t x[r, starts[j] + t] * taps[t, j]
// over a per-output-column tap table (kernels/resize.py: plan_taps), with the
// UNORM normalisation folded into the taps, t = 0 .. T-1 in order in fp32
// FMAs, columns past the input skipped.  Output is float32, or int16 "mid16"
// codes round(value * 16384) (round half to even, as jnp.round).
//
// Design.  A block takes rows_per_block rows x 256 output columns, 128
// threads:
//   * input.  The block copies each of its rows' input span (the columns
//     its outputs' taps reach, kernels/resize.BandedMatrix.row_windows along
//     the columns) into shared memory, with 16-byte cp.async copies where
//     the rows are 16-byte aligned and element copies where they are not.
//     Each input byte comes from device memory once; only the halo columns
//     at span borders are read again.
//   * taps.  Each thread owns 2 consecutive output columns for all the
//     block's rows: it loads their starts and (up to 8) tap weights once
//     into registers and uses them rows_per_block times.  Maps with more
//     taps read the weights through L1 in the same order.  Lanes 16-31 run
//     their second column first, so at 2:1 a warp's reads of one tap fall in
//     32 distinct shared-memory banks.
//   * output.  The two outputs go out as one 4-byte (mid16) or 8-byte
//     (float32) store where the row is aligned, else as two scalar stores.
// Every output is bit-equal to the one-pixel-a-thread kernel this replaces:
// the same FMAs in the same order and the same rounding.
//
// Bound: device memory.  At the headline shape (4K uint16 luma to 1920
// columns) each output reads 2 input bytes x 2 and writes 2 bytes, and does
// 6 FMAs: far below the card's compute roof.  Measured on one NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py, batch 16): the headline's three planes
// in 0.394 ms, 50% of their 0.198 ms byte bound; the luma alone in 0.214 ms,
// beside the 0.200 ms of the W-pass floor kernel (probe_wpass.cu) that reads
// the same bytes.  Shared memory: rows_per_block x the span must fit
// kSmemBudget; the wrapper refuses a map that does not before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOut = 2;                  // consecutive output columns a thread
constexpr int kSpan = kThreads * kOut;   // output columns a block
constexpr int kRegTaps = 8;              // taps held in registers
constexpr size_t kSmemBudget = 232448;   // 227 KB

// Input elements staged a row: the span of ``win`` columns from a start
// rounded down to 16 bytes.  kernels/resize.k1_smem_bytes mirrors it.
template <typename Tin>
__host__ __device__ inline int pitch_of(int win) {
  constexpr int kChunk = 16 / sizeof(Tin);
  return (win + 2 * kChunk - 2) / kChunk * kChunk;
}

template <typename Tin, bool kMid16>
__device__ __forceinline__ void store2(void* out, long long idx, bool vec,
                                       bool has2, float a, float b) {
  if (kMid16) {
    const int16_t qa = static_cast<int16_t>(__float2int_rn(a * 16384.0f));
    const int16_t qb = static_cast<int16_t>(__float2int_rn(b * 16384.0f));
    int16_t* o = static_cast<int16_t*>(out) + idx;
    if (vec && has2) {
      *reinterpret_cast<uint32_t*>(o) =
          static_cast<uint32_t>(static_cast<uint16_t>(qa)) |
          (static_cast<uint32_t>(static_cast<uint16_t>(qb)) << 16);
    } else {
      o[0] = qa;
      if (has2) o[1] = qb;
    }
  } else {
    float* o = static_cast<float*>(out) + idx;
    if (vec && has2) {
      *reinterpret_cast<float2*>(o) = make_float2(a, b);
    } else {
      o[0] = a;
      if (has2) o[1] = b;
    }
  }
}

// grid: x = groups of rows_per_block rows, y = spans of kSpan output columns
template <typename Tin, bool kMid16, bool kRegs>
__global__ void __launch_bounds__(kThreads) banded_resize_kernel(
    const Tin* __restrict__ x, const int* __restrict__ starts,
    const float* __restrict__ taps, const int* __restrict__ span_lo,
    void* __restrict__ out, long long rows, int w_in, int w_out, int n_taps,
    int win, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* sm = reinterpret_cast<Tin*>(smem);
  constexpr int kChunk = 16 / sizeof(Tin);
  const int pitch = pitch_of<Tin>(win);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), rows - r0));
  const int span = blockIdx.y;
  const int lo = span_lo[span];
  const int lo_al = lo - lo % kChunk;
  const int count = min(pitch, w_in - lo_al);   // elements staged a row
  const Tin* src = x + r0 * w_in + lo_al;
  if (vrt::rows_aligned16(x, w_in)) {
    const int chunks = count / kChunk;   // w_in and lo_al are whole chunks
    for (int i = threadIdx.x; i < n_rows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int k = i - r * chunks;
      vrt::cp_async16(sm + r * pitch + k * kChunk,
                      src + static_cast<long long>(r) * w_in + k * kChunk);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * count; i += kThreads) {
      const int r = i / count;
      const int k = i - r * count;
      sm[r * pitch + k] = src[static_cast<long long>(r) * w_in + k];
    }
  }
  vrt::cp_async_wait_all();
  __syncthreads();

  const int j = span * kSpan + threadIdx.x * kOut;
  if (j >= w_out) return;
  const int first = (threadIdx.x >> 4) & 1;   // the column run first
  int jq[kOut], s[kOut];
  bool ok[kOut];
  float wt[kOut][kRegTaps];
#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    jq[q] = j + (q ^ first);
    ok[q] = jq[q] < w_out;
    s[q] = ok[q] ? starts[jq[q]] - lo_al : 0;   // window-relative
#pragma unroll
    for (int t = 0; t < kRegTaps; ++t) {
      wt[q][t] = kRegs && ok[q] && t < n_taps ? taps[t * w_out + jq[q]] : 0.f;
    }
  }
  const int lim = w_in - lo_al;   // window-relative first column past the row
  const bool has2 = j + 1 < w_out;
  const bool vec = w_out % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) %
                    (kOut * (kMid16 ? sizeof(int16_t) : sizeof(float)))) == 0;
  for (int rr = 0; rr < n_rows; ++rr) {
    const Tin* row = sm + rr * pitch;
    float res[kOut];
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      float acc = 0.f;
      if (ok[q]) {
        if (kRegs) {
#pragma unroll
          for (int t = 0; t < kRegTaps; ++t) {
            const int i = s[q] + t;
            if (t < n_taps && i < lim) {
              acc = fmaf(vrt::to_float(row[i]), wt[q][t], acc);
            }
          }
        } else {
          for (int t = 0; t < n_taps; ++t) {
            const int i = s[q] + t;
            if (i < lim) {
              acc = fmaf(vrt::to_float(row[i]), taps[t * w_out + jq[q]], acc);
            }
          }
        }
      }
      res[q] = acc;
    }
    store2<Tin, kMid16>(out, (r0 + rr) * w_out + j, vec, has2,
                        first ? res[1] : res[0], first ? res[0] : res[1]);
  }
}

template <typename Tin, bool kMid16, bool kRegs>
int launch(const void* x, const int* starts, const float* taps,
           const int* span_lo, void* out, long long rows, int w_in,
           int w_out, int n_taps, int win, int rows_per_block,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows_per_block) *
                      pitch_of<Tin>(win) * sizeof(Tin);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = banded_resize_kernel<Tin, kMid16, kRegs>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block,
                  (w_out + kSpan - 1) / kSpan);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), starts, taps, span_lo, out, rows, w_in,
      w_out, n_taps, win, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_dtype(const void* x, const int* starts, const float* taps,
                 const int* span_lo, void* out, int mid16, long long rows,
                 int w_in, int w_out, int n_taps, int win,
                 int rows_per_block, cudaStream_t st) {
  const bool regs = n_taps <= kRegTaps;
  if (mid16) {
    return regs ? launch<Tin, true, true>(x, starts, taps, span_lo, out,
                                          rows, w_in, w_out, n_taps, win,
                                          rows_per_block, st)
                : launch<Tin, true, false>(x, starts, taps, span_lo, out,
                                           rows, w_in, w_out, n_taps, win,
                                           rows_per_block, st);
  }
  return regs ? launch<Tin, false, true>(x, starts, taps, span_lo, out, rows,
                                         w_in, w_out, n_taps, win,
                                         rows_per_block, st)
              : launch<Tin, false, false>(x, starts, taps, span_lo, out,
                                          rows, w_in, w_out, n_taps, win,
                                          rows_per_block, st);
}

}  // namespace

// x_dtype: 0 uint8, 1 uint16, 2 int16, 3 float32 (kernels/resize.py:
// DTYPE_CODES).  ``span_lo`` (device, one int per span of 256 output
// columns) and ``win`` are the spans' first input column and the widest
// span (kernels/resize.BandedMatrix.row_windows(256)).  Returns
// cudaErrorInvalidValue for rows_per_block rows of ``win`` columns over
// kSmemBudget.
extern "C" int vrt_banded_resize(const void* x, int x_dtype,
                                 const void* starts, const void* taps,
                                 const void* span_lo, int win, void* out,
                                 int mid16, long long rows, int w_in,
                                 int w_out, int n_taps, int rows_per_block,
                                 void* stream) {
  const int* s = static_cast<const int*>(starts);
  const float* t = static_cast<const float*>(taps);
  const int* lo = static_cast<const int*>(span_lo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch_dtype<uint8_t>(x, s, t, lo, out, mid16, rows, w_in, w_out, n_taps, win, rows_per_block, st);
    case 1: return launch_dtype<uint16_t>(x, s, t, lo, out, mid16, rows, w_in, w_out, n_taps, win, rows_per_block, st);
    case 2: return launch_dtype<int16_t>(x, s, t, lo, out, mid16, rows, w_in, w_out, n_taps, win, rows_per_block, st);
    case 3: return launch_dtype<float>(x, s, t, lo, out, mid16, rows, w_in, w_out, n_taps, win, rows_per_block, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
