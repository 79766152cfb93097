// Staging helpers shared by the tiled kernels (K1 banded_resize.cu, K2
// rows3_tail.cu, K7 deint3_rows_dual.cu, K9 cols3_tail.cuh): 16-byte
// asynchronous copies from device memory into shared memory, in groups a
// thread can wait for one at a time, loads through the read-only cache for
// the long-window routes that stage nothing, and exact conversions of the
// plane codes to float.
//
// to_float gives the same value as static_cast<float> for every uint8,
// uint16 and int16 code, with one integer and one float operation at the
// full rate instead of a conversion instruction at a quarter of it: the
// code goes into the low mantissa bits of 2^23, and 2^23 (plus the int16
// offset) is subtracted, which is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace vrt {

// cp.async of 16 bytes, cached in L2 only; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// closes the group of the cp.async copies this thread issued since the last
// commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most ``kPending`` of this thread's committed groups are
// still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// waits for every cp.async this thread has issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// sizeof(V) bytes (4, 8 or 16, aligned to that) at ``p`` through the
// read-only cache, as a V
template <typename V>
__device__ __forceinline__ V ldg_as(const void* p) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8 || sizeof(V) == 16,
                "ldg_as loads 4, 8 or 16 bytes");
  V v;
  if constexpr (sizeof(V) == 4) {
    const unsigned a = __ldg(static_cast<const unsigned*>(p));
    memcpy(&v, &a, sizeof(V));
  } else if constexpr (sizeof(V) == 8) {
    const uint2 a = __ldg(static_cast<const uint2*>(p));
    memcpy(&v, &a, sizeof(V));
  } else {
    const uint4 a = __ldg(static_cast<const uint4*>(p));
    memcpy(&v, &a, sizeof(V));
  }
  return v;
}

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(uint16_t x) {
  return __fsub_rn(__int_as_float(0x4B000000 | static_cast<int>(x)),
                   8388608.f);
}

__device__ __forceinline__ float to_float(uint8_t x) {
  return __fsub_rn(__int_as_float(0x4B000000 | static_cast<int>(x)),
                   8388608.f);
}

__device__ __forceinline__ float to_float(int16_t x) {
  return __fsub_rn(
      __int_as_float(0x4B000000 + (static_cast<int>(x) + 32768)),
      8421376.f);
}

// True when ``p`` is 16-byte aligned and so is every row of ``w`` elements
// after it: a row segment that starts on a 16-byte column then copies in
// 16-byte pieces.
template <typename T>
__device__ __forceinline__ bool rows_aligned16(const T* p, long long w) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         ((w * static_cast<long long>(sizeof(T))) & 15) == 0;
}

}  // namespace vrt
