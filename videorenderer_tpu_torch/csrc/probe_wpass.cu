// K10: the W-pass probe of the headline stage split, for Hopper (sm_90a).
//
// Replaces bench_headline_micro.py: _probe_wpass (pallas_call :113), whose
// two Pallas bodies take a W pass apart on the 4K uint16 luma:
//  * vrt_wpass_bf16, body k1 ("yW1"): out[r, j] = sum_t bf16(x[r, s_j + t])
//    * taps[t, j], summed in float32.  x is the raw uint16 code as float;
//    the taps are bf16 already, rounded after the normalisation was folded
//    in (kernels/probe.py).  A bf16 x bf16 product is exact in float32, so
//    the result differs from the Pallas kernel only in the order of the sum.
//    The Pallas kernel's 128-aligned band windows and one MXU dot per output
//    tile become K1's per-column tap table (kernels/resize.py: plan_taps)
//    and K1's design: a block takes rows_per_block rows x 256 output
//    columns, 128 threads, and copies each row's input span (the columns
//    its outputs' taps reach, BandedMatrix.row_windows(256)) into shared
//    memory with 16-byte cp.async copies (element copies where the rows are
//    not 16-byte aligned), so each input byte comes from device memory once
//    and only the halo columns at span borders are read again.  Each thread
//    owns 2 adjacent outputs and holds their starts and (up to 8) bf16 taps,
//    widened to float, in registers for all the block's rows; lanes 16-31
//    run their second column first, so a warp's reads of one tap fall in
//    distinct banks; the 2 outputs go out as one 8-byte store.  The codes
//    are rounded to bf16 where each tap reads them, as before (in integer
//    operations at the full rate, bf16_of, where the conversions ran at a
//    quarter of it), and the sum runs t = 0 .. T-1 in fp32 FMAs:
//    bit-equal to the one-output-a-thread
//    kernel this replaces, which re-read its taps from device memory for
//    every row and stored 4 bytes at a time (0.436 ms at the headline,
//    36% of its bound; PERF.md section 6).  No tensor cores: an output has
//    6 nonzero taps in a band ~262 wide, so a dense wgmma tile would do
//    ~40x the FLOPs of a pass bound by bytes (~3 FLOP a byte).
//  * vrt_wpass_floor, body ksplit ("yWsplit"): each block stages the whole
//    width of its rows in shared memory as bf16, then writes the first w_out
//    columns back as float32.  The Pallas kernel moves every input byte into
//    VMEM, so its time is the floor of a W pass's read + convert + write;
//    reading only the columns it writes would time another floor.
//
// Bound: device memory, both.  At the headline (16 frames of 2160 x 3840
// uint16 luma to 1920 columns) each reads 265.4 MB and writes 265.4 MB:
// 0.158 ms at 3.35 TB/s.  The band product's 6 FMAs an output (Lanczos3 at
// 2:1) are far below the compute roof.  Measured on one NVIDIA H100 80GB
// HBM3 at 700.00 W (torch_headline_micro.py --probe-wpass, batch 16):
// wpass_bf16 0.302-0.309 ms (the kernel this replaces: 0.436), 51-52% of
// the bound, the rate of K1's own W pass (yW, 0.213-0.225 ms for 398 MB);
// wpass_floor 0.195 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 128;       // wpass_bf16: threads of a block
constexpr int kOut = 2;             // wpass_bf16: adjacent outputs a thread
constexpr int kSpan = kThreads * kOut;   // wpass_bf16: output columns a block
constexpr int kRegTaps = 8;         // wpass_bf16: taps held in registers
constexpr int kChunk = 8;           // uint16 codes in 16 bytes
constexpr size_t kSmemBudget = 232448;   // 227 KB
constexpr int kFloorThreads = 256;  // wpass_floor
constexpr int kTileElems = 16384;   // wpass_floor: 32 KB of bf16 a block

__device__ __forceinline__ __nv_bfloat16 to_bf16(uint16_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}

// float(bf16(v)) of a code, as __bfloat162float(to_bf16(v)) gives it, in
// full-rate integer and float operations instead of two conversions at a
// quarter of the rate: the exact float of the code (stage.cuh's to_float),
// then its low 16 bits rounded off to nearest even (the code is finite).
__device__ __forceinline__ float bf16_of(uint16_t v) {
  const unsigned b = __float_as_uint(vrt::to_float(v));
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

// Input elements staged a row: the span of ``win`` columns from a start
// rounded down to 16 bytes (K1's pitch_of; kernels/resize.k1_smem_bytes).
__host__ __device__ inline int pitch_of(int win) {
  return (win + 2 * kChunk - 2) / kChunk * kChunk;
}

// grid: x = groups of rows_per_block rows, y = spans of kSpan output columns
template <bool kRegs>
__global__ void __launch_bounds__(kThreads) wpass_bf16_kernel(
    const uint16_t* __restrict__ x, const int* __restrict__ starts,
    const __nv_bfloat16* __restrict__ taps, const int* __restrict__ span_lo,
    float* __restrict__ out, int rows, int w_in, int w_out, int n_taps,
    int win, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem);
  const int pitch = pitch_of(win);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), rows - r0));
  const int span = blockIdx.y;
  const int lo = span_lo[span];
  const int lo_al = lo - lo % kChunk;
  const int count = min(pitch, w_in - lo_al);   // elements staged a row
  const uint16_t* src = x + r0 * w_in + lo_al;
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
      wt[q][t] = kRegs && ok[q] && t < n_taps
                     ? __bfloat162float(taps[t * w_out + jq[q]]) : 0.f;
    }
  }
  const int lim = w_in - lo_al;   // window-relative first column past the row
  const bool has2 = j + 1 < w_out;
  const bool vec = w_out % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % sizeof(float2)) == 0;
  for (int rr = 0; rr < n_rows; ++rr) {
    const uint16_t* row = sm + rr * pitch;
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
              acc = fmaf(bf16_of(row[i]), wt[q][t], acc);
            }
          }
        } else {
          for (int t = 0; t < n_taps; ++t) {
            const int i = s[q] + t;
            if (i < lim) {
              acc = fmaf(bf16_of(row[i]),
                         __bfloat162float(taps[t * w_out + jq[q]]), acc);
            }
          }
        }
      }
      res[q] = acc;
    }
    float* o = out + (r0 + rr) * w_out + j;
    const float a = first ? res[1] : res[0], b = first ? res[0] : res[1];
    if (vec && has2) {
      *reinterpret_cast<float2*>(o) = make_float2(a, b);
    } else {
      o[0] = a;
      if (has2) o[1] = b;
    }
  }
}

__global__ void wpass_floor_kernel(const uint16_t* __restrict__ x,
                                   float* __restrict__ out, int rows,
                                   int w_in, int w_out, int rows_per_block) {
  __shared__ __nv_bfloat16 tile[kTileElems];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n_rows = min(rows_per_block, static_cast<int>(rows - r0));
  const uint16_t* src = x + r0 * w_in;
  const int n_in = n_rows * w_in;
  for (int i = threadIdx.x; i < n_in; i += kFloorThreads) {
    tile[i] = to_bf16(src[i]);
  }
  __syncthreads();
  float* dst = out + r0 * w_out;
  const int n_out = n_rows * w_out;
  for (int i = threadIdx.x; i < n_out; i += kFloorThreads) {
    const int rr = i / w_out;
    dst[i] = __bfloat162float(tile[rr * w_in + (i - rr * w_out)]);
  }
}

}  // namespace

// x: (rows, w_in) uint16, starts (w_out,) int32, taps (n_taps, w_out) bf16,
// out (rows, w_out) float32, all contiguous; ``span_lo`` (device, one int
// per span of 256 output columns) and ``win`` are the spans' first input
// column and the widest span (kernels/resize.BandedMatrix.row_windows(256)),
// ``rows_per_block`` the rows a block stages (kernels/resize.k1_rows).
// Returns cudaErrorInvalidValue for rows_per_block rows of ``win`` columns
// over kSmemBudget.
extern "C" int vrt_wpass_bf16(const void* x, const void* starts,
                              const void* taps, const void* span_lo, int win,
                              void* out, int rows, int w_in, int w_out,
                              int n_taps, int rows_per_block, void* stream) {
  const size_t smem = static_cast<size_t>(rows_per_block) * pitch_of(win) *
                      sizeof(uint16_t);
  if (smem > kSmemBudget || rows_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = n_taps <= kRegTaps ? wpass_bf16_kernel<true>
                                   : wpass_bf16_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block,
                  (w_out + kSpan - 1) / kSpan);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const int*>(starts),
      static_cast<const __nv_bfloat16*>(taps),
      static_cast<const int*>(span_lo), static_cast<float*>(out), rows, w_in,
      w_out, n_taps, win, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, w_in) uint16, out (rows, w_out) float32, w_out <= w_in <=
// kTileElems, both contiguous.
extern "C" int vrt_wpass_floor(const void* x, void* out, int rows, int w_in,
                               int w_out, void* stream) {
  if (w_in > kTileElems || w_out > w_in || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_block = kTileElems / w_in;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  wpass_floor_kernel<<<blocks, kFloorThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(out), rows, w_in,
      w_out, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
