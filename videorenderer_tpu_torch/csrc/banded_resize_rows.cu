// K3: banded resize along the H axis (the second-to-last), for Hopper
// (sm_90a).
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: banded_resize_rows
// (and its packed form banded_resize_rows_packed, body _kernel_rows).
// out[b, r, c] = sum_t x[b, starts[r] + t, c] * taps[t, r] over a per-output-
// row tap table (kernels/resize.py: plan_taps), any normalisation folded into
// the taps as K1 does.  Input uint8, uint16, int16 or float32; output float32.
//
// Bound: device memory.  At the letterboxed path's shapes (a 2.39:1 scope
// film, 1608 -> 804 rows, Lanczos3 at 2:1) each output reads 6 input rows
// and does 6 FMAs, far below the compute roof.  One thread per output (row,
// column): a block's threads take consecutive columns of one output row, so
// every tap row is one coalesced span of the input, and the tap weight of
// that row is one broadcast load.  The input rows a block reads overlap with
// the next output row's (the band steps by 2 rows), which the L2 serves.  The
// TPU kernel's full-height column stripes in VMEM and its split-bf16 products
// do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Tin>
__global__ void banded_resize_rows_kernel(const Tin* __restrict__ x,
                                          const int* __restrict__ starts,
                                          const float* __restrict__ taps,
                                          float* __restrict__ out, int h_in,
                                          int h_out, int w, int n_taps) {
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= w) return;
  const long long r = blockIdx.x;          // b * h_out + row
  const long long b = r / h_out;
  const int row = static_cast<int>(r - b * h_out);
  const Tin* plane = x + b * h_in * static_cast<long long>(w);
  const int s = starts[row];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    const int i = s + t;
    if (i < h_in) {
      acc = fmaf(static_cast<float>(plane[static_cast<long long>(i) * w + col]),
                 taps[t * h_out + row], acc);
    }
  }
  out[r * w + col] = acc;
}

template <typename Tin>
void launch(const void* x, const int* starts, const float* taps, float* out,
            int batch, int h_in, int h_out, int w, int n_taps,
            cudaStream_t stream) {
  const dim3 grid(batch * h_out, (w + kThreads - 1) / kThreads);
  banded_resize_rows_kernel<Tin><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), starts, taps, out, h_in, h_out, w, n_taps);
}

}  // namespace

// x_dtype: 0 uint8, 1 uint16, 2 int16, 3 float32 (kernels/resize.py:
// DTYPE_CODES).  x is (batch, h_in, w), out (batch, h_out, w), both
// contiguous.
extern "C" int vrt_banded_resize_rows(const void* x, int x_dtype,
                                      const void* starts, const void* taps,
                                      void* out, int batch, int h_in,
                                      int h_out, int w, int n_taps,
                                      void* stream) {
  const int* s = static_cast<const int*>(starts);
  const float* t = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: launch<uint8_t>(x, s, t, o, batch, h_in, h_out, w, n_taps, st); break;
    case 1: launch<uint16_t>(x, s, t, o, batch, h_in, h_out, w, n_taps, st); break;
    case 2: launch<int16_t>(x, s, t, o, batch, h_in, h_out, w, n_taps, st); break;
    case 3: launch<float>(x, s, t, o, batch, h_in, h_out, w, n_taps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
