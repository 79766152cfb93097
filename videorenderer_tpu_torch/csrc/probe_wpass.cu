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
//    tile become K1's per-column tap table (kernels/resize.py: plan_taps):
//    one thread per output pixel runs T fp32 FMAs over its contiguous taps.
//  * vrt_wpass_floor, body ksplit ("yWsplit"): each block stages the whole
//    width of its rows in shared memory as bf16, then writes the first w_out
//    columns back as float32.  The Pallas kernel moves every input byte into
//    VMEM, so its time is the floor of a W pass's read + convert + write;
//    reading only the columns it writes would time another floor.
//
// Bound: device memory, both.  At the headline (16 frames of 2160 x 3840
// uint16 luma to 1920 columns) each reads 265.4 MB and writes 265.4 MB:
// 0.158 ms at 3.35 TB/s.  The band product's 6 FMAs an output (Lanczos3 at
// 2:1) are far below the compute roof.  Loads are coalesced along W: a warp's outputs
// read one contiguous input span (k1), or a block's rows are one contiguous
// span of the input and of the output (ksplit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // wpass_bf16: outputs of a block
constexpr int kFloorThreads = 256;  // wpass_floor
constexpr int kTileElems = 16384;   // wpass_floor: 32 KB of bf16 a block

__device__ __forceinline__ __nv_bfloat16 to_bf16(uint16_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}

__global__ void wpass_bf16_kernel(const uint16_t* __restrict__ x,
                                  const int* __restrict__ starts,
                                  const __nv_bfloat16* __restrict__ taps,
                                  float* __restrict__ out, int w_in, int w_out,
                                  int n_taps) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= w_out) return;
  const long long r = blockIdx.x;
  const uint16_t* row = x + r * w_in;
  const int s = starts[j];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    const int i = s + t;
    if (i < w_in) {
      acc = fmaf(__bfloat162float(to_bf16(row[i])),
                 __bfloat162float(taps[t * w_out + j]), acc);
    }
  }
  out[r * w_out + j] = acc;
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
// out (rows, w_out) float32, all contiguous.
extern "C" int vrt_wpass_bf16(const void* x, const void* starts,
                              const void* taps, void* out, int rows, int w_in,
                              int w_out, int n_taps, void* stream) {
  const dim3 grid(rows, (w_out + kThreads - 1) / kThreads);
  wpass_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const int*>(starts),
      static_cast<const __nv_bfloat16*>(taps), static_cast<float*>(out), w_in,
      w_out, n_taps);
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
