// The per-pixel math of the direct 4x4-tap Jinc2 resample with
// anti-ringing, shared by K5 (jinc2_resize.cu) and K6 (jinc2_convert.cu).
//
// Output (row, col) takes the source taps base_y[row] - 1 + jo and
// base_x[col] - 1 + io (jo, io in 0..3; clamped to the plane by the
// caller) with weights g(d2y[jo][row] + d2x[io][col]),
// g(s) = sin(sqrt(s) * wa) * sin(sqrt(s) * wb) / s and g(0) = wa * wb,
// normalised by their sum (ops/scale.jinc2_axis_tables plans base and d2).
// Anti-ringing then moves the result 0.8 of the way toward its clamp to
// the min/max of the centre 2x2 taps.  sqrtf, sinf and the division are
// the accurate ones (no fast-math), and every sum rounds on its own in the
// order of the plain version (kernels/jinc2._jinc2_plain): the two then
// differ only by the last bits of sinf.
//
// The weights repeat with the axes' phase periods, so both kernels can read
// them from a geometry's table instead (kernels/jinc2._weight_table): an
// entry of kJ2Entry floats for each (row class, column class) pair, built
// by jinc2_convert.cu's table kernel with jinc2_weights on the classes' d2
// bits, so an entry holds exactly the weights jinc2_weights computes for
// the outputs of that pair.

#pragma once

#include <cuda_runtime.h>

namespace vrt {

// ops/scale: _JINC2_WINDOW_SINC * pi, _JINC2_SINC * pi, their product,
// rounded once from double as the plain version's scalars are
constexpr double kJ2WaD = 0.416 * 3.14159265358979323846;
constexpr double kJ2WbD = 0.985 * 3.14159265358979323846;
constexpr float kJ2Wa = static_cast<float>(kJ2WaD);
constexpr float kJ2Wb = static_cast<float>(kJ2WbD);
constexpr float kJ2Wab = static_cast<float>(kJ2WaD * kJ2WbD);
constexpr float kJ2Ar = 0.8f;  // _JINC2_AR_STRENGTH
// floats of a weight-table entry: the 16 weights, their sum, 3 zeros
constexpr int kJ2Entry = 20;

__device__ __forceinline__ float jinc2_weight(float d2) {
  if (d2 == 0.f) return kJ2Wab;
  const float d = sqrtf(d2);
  return __fdiv_rn(
      __fmul_rn(sinf(__fmul_rn(d, kJ2Wa)), sinf(__fmul_rn(d, kJ2Wb))), d2);
}

// The 16 weights of one output, row-major w[jo * 4 + io]; returns their sum.
__device__ __forceinline__ float jinc2_weights(const float dy[4],
                                               const float dx[4],
                                               float w[16]) {
  float wsum = 0.f;
#pragma unroll
  for (int jo = 0; jo < 4; ++jo) {
#pragma unroll
    for (int io = 0; io < 4; ++io) {
      const float wt = jinc2_weight(__fadd_rn(dy[jo], dx[io]));
      w[jo * 4 + io] = wt;
      wsum = jo + io == 0 ? wt : __fadd_rn(wsum, wt);
    }
  }
  return wsum;
}

// The 16 weights and the sum of entry (rc, cc) of a table of n_col_cls
// columns: five 16-byte loads through the read-only path.
__device__ __forceinline__ float jinc2_table_weights(
    const float* __restrict__ table, int n_col_cls, int rc, int cc,
    float w[16]) {
  const float4* e = reinterpret_cast<const float4*>(table) +
                    (static_cast<long long>(rc) * n_col_cls + cc) *
                        (kJ2Entry / 4);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = __ldg(e + q);
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
  return __ldg(e + 4).x;
}

// Weighted sum of 16 taps t[jo * 4 + io], divided by wsum, then the
// anti-ringing lerp toward the centre 2x2 taps' range.
__device__ __forceinline__ float jinc2_resolve(const float t[16],
                                               const float w[16],
                                               float wsum) {
  float acc = __fmul_rn(t[0], w[0]);
#pragma unroll
  for (int k = 1; k < 16; ++k) acc = __fadd_rn(acc, __fmul_rn(t[k], w[k]));
  const float out = __fdiv_rn(acc, wsum);
  const float mn = fminf(fminf(t[5], t[6]), fminf(t[9], t[10]));
  const float mx = fmaxf(fmaxf(t[5], t[6]), fmaxf(t[9], t[10]));
  const float clamped = fminf(fmaxf(out, mn), mx);
  return __fadd_rn(out, __fmul_rn(__fsub_rn(clamped, out), kJ2Ar));
}

}  // namespace vrt
