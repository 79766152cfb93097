// The checked pow of the c7 routes (tail.cuh's CheckedPow) beside the pow
// it stands for (pow_pos, libdevice's log2f and exp2f), one value a thread,
// so that a card test can hold the two bit-equal over every input where the
// range test passes, and count the inputs where it does not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) checked_pow_kernel(
    const float* __restrict__ x, long long n, float e,
    float* __restrict__ checked, float* __restrict__ exact,
    uint8_t* __restrict__ ok, float* __restrict__ v) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  vrt::CheckedPow d;
  checked[i] = d.pow(xi, e);
  ok[i] = d.ok;
  exact[i] = vrt::pow_pos(xi, e);
  // the value CheckedPow's range test reads
  const float l = vrt::log2_normal(xi);
  v[i] = e > 1.f ? vrt::mul(e, l) : l;
}

}  // namespace

// For each of the n floats of ``x`` (device): CheckedPow's x ** e into
// ``checked``, whether its range test held into ``ok`` (uint8), pow_pos's
// x ** e into ``exact``, and the value the test compared with 126 into
// ``v``.
extern "C" int vrt_checked_pow(const void* x, long long n, float e,
                               void* checked, void* exact, void* ok, void* v,
                               void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  checked_pow_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, e, static_cast<float*>(checked),
      static_cast<float*>(exact), static_cast<uint8_t*>(ok),
      static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}
