// K1: banded resize along the last axis, for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/resize_pallas.py: banded_resize_last_axis
// (body _make_kernel_cols).  out[r, j] = sum_t x[r, starts[j] + t] * taps[t, j]
// over a per-output-column tap table (kernels/resize.py: plan_taps), with the
// UNORM normalisation folded into the taps.  Output is float32, or int16
// "mid16" codes round(value * 16384) (round half to even, as jnp.round).
//
// Bound: device memory.  At the headline shape (4K uint16 luma to 1920
// columns) each output reads about 2 input bytes x 2 and writes 2 bytes, and
// does 6 FMAs: far below the card's compute roof.  The design keeps every
// byte read once from device memory: one thread per output pixel loops over
// its T taps in fp32 FMAs; a warp's 32 outputs read one contiguous input span
// (neighbouring threads, neighbouring starts), which the L1 cache serves to
// the overlapping taps.  The Pallas form's split-bf16 products and 128-aligned
// windows existed for the TPU's matrix unit and lane tiling and are gone.
// Measured on an H100: 0.72 ms for the three planes of 16 frames, 28% of
// peak bandwidth; vector loads and several rows a thread are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Tin, bool kMid16>
__global__ void banded_resize_kernel(const Tin* __restrict__ x,
                                     const int* __restrict__ starts,
                                     const float* __restrict__ taps,
                                     void* __restrict__ out, int w_in,
                                     int w_out, int n_taps) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= w_out) return;
  const long long r = blockIdx.x;
  const Tin* row = x + r * w_in;
  const int s = starts[j];
  float acc = 0.f;
  for (int t = 0; t < n_taps; ++t) {
    const int i = s + t;
    if (i < w_in) {
      acc = fmaf(static_cast<float>(row[i]), taps[t * w_out + j], acc);
    }
  }
  if (kMid16) {
    static_cast<int16_t*>(out)[r * w_out + j] =
        static_cast<int16_t>(__float2int_rn(acc * 16384.0f));
  } else {
    static_cast<float*>(out)[r * w_out + j] = acc;
  }
}

template <typename Tin>
void launch(const void* x, const int* starts, const float* taps, void* out,
            int mid16, int rows, int w_in, int w_out, int n_taps,
            cudaStream_t stream) {
  const dim3 grid(rows, (w_out + kThreads - 1) / kThreads);
  const Tin* xp = static_cast<const Tin*>(x);
  if (mid16) {
    banded_resize_kernel<Tin, true><<<grid, kThreads, 0, stream>>>(
        xp, starts, taps, out, w_in, w_out, n_taps);
  } else {
    banded_resize_kernel<Tin, false><<<grid, kThreads, 0, stream>>>(
        xp, starts, taps, out, w_in, w_out, n_taps);
  }
}

}  // namespace

// x_dtype: 0 uint8, 1 uint16, 2 int16, 3 float32 (kernels/resize.py: DTYPE_CODES).
extern "C" int vrt_banded_resize(const void* x, int x_dtype, const void* starts,
                                 const void* taps, void* out, int mid16,
                                 int rows, int w_in, int w_out, int n_taps,
                                 void* stream) {
  const int* s = static_cast<const int*>(starts);
  const float* t = static_cast<const float*>(taps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: launch<uint8_t>(x, s, t, out, mid16, rows, w_in, w_out, n_taps, st); break;
    case 1: launch<uint16_t>(x, s, t, out, mid16, rows, w_in, w_out, n_taps, st); break;
    case 2: launch<int16_t>(x, s, t, out, mid16, rows, w_in, w_out, n_taps, st); break;
    case 3: launch<float>(x, s, t, out, mid16, rows, w_in, w_out, n_taps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
