// Per-pixel output steps shared by the kernels that end a pipeline (K2
// rows3_tail, K5 jinc2_resize, K6 jinc2_convert): the 32x32 ordered dither
// or rounding to the output depth, and the packed surface dword.
//
// Every operation rounds on its own (no FMA contraction), in the order the
// torch plain versions evaluate it (ops/dither.py, kernels/resize.pack_surface).
//
// The quantization mode and the pack are template parameters: a value fixed
// at compile time keeps only its own path; kRuntime (the default) reads the
// launch's flags.  Both forms compute the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vrt {

enum { kPackNone = 0, kPackRgb10a2 = 1, kPackRgba8 = 2 };
// quantization modes: none, ordered dither, round half to even
enum { kQuantNone = 0, kQuantDither = 1, kQuantRound = 2 };
// a template parameter that reads its value from the launch's flags
constexpr int kRuntime = -1;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// Bayer 32x32 value at global (row, col): digit b of the base-4 index is
// 2*bit_b(i^j) + bit_b(i) with weight 4**(4-b) (ops/dither.bayer_field).
__device__ __forceinline__ float bayer(int row, int col) {
  const int i = row & 31, j = col & 31, x = i ^ j;
  int v = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    v += ((((x >> b) & 1) * 2) + ((i >> b) & 1)) << (2 * (4 - b));
  }
  return (static_cast<float>(v) + 0.5f) / 1024.f;
}

// Quantization of the final pass (ps_final_pass.hlsl): dither_bits +b is
// floor(clip(c) * q + bayer) / q, -b is round-half-even(clip(c) * q) / q,
// 0 leaves c as it is.  q = 2**b - 1; inv_q its float reciprocal; the
// division is a multiply by it, clamped to 1 (ops/dither._requantize).
struct Quant {
  int dither_bits;
  float q, inv_q;
};

// The quantization mode of ``dither_bits``.
__host__ __device__ inline int quant_mode(int dither_bits) {
  return dither_bits > 0 ? kQuantDither
                         : dither_bits < 0 ? kQuantRound : kQuantNone;
}

inline Quant make_quant(int dither_bits) {
  const int b = dither_bits < 0 ? -dither_bits : dither_bits;
  const int levels = (1 << b) - 1;
  return Quant{dither_bits, static_cast<float>(levels),
               levels > 0 ? static_cast<float>(1.0 / levels) : 0.f};
}

template <int kQuant = kRuntime>
__device__ __forceinline__ float quantize(float c, const Quant& Q, int row,
                                          int col) {
  const int mode = kQuant != kRuntime ? kQuant : quant_mode(Q.dither_bits);
  if (mode == kQuantNone) return c;
  const float xq = __fmul_rn(clip01(c), Q.q);
  const float codes = mode == kQuantDither
                          ? floorf(__fadd_rn(xq, bayer(row, col)))
                          : rintf(xq);
  return fminf(__fmul_rn(codes, Q.inv_q), 1.f);
}

// One R10G10B10A2 or RGBA8 dword: (clip(c) * scale + 0.5) truncated per
// channel, alpha opaque (resize_pallas.py:450).
template <int kPack = kRuntime>
__device__ __forceinline__ uint32_t pack_word(const float c[3], int pack) {
  const bool ten = (kPack != kRuntime ? kPack : pack) == kPackRgb10a2;
  const float scale = ten ? 1023.f : 255.f;
  const int shift = ten ? 10 : 8;
  uint32_t word = ten ? 0xC0000000u : 0xFF000000u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t qv = static_cast<uint32_t>(
        static_cast<int>(__fadd_rn(__fmul_rn(clip01(c[i]), scale), 0.5f)));
    word |= qv << (shift * i);
  }
  return word;
}

}  // namespace vrt
