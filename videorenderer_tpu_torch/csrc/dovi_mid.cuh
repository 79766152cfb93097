// The Dolby Vision convert of one pixel, shared by K8 (rows3_mid.cuh: at
// the mid resolution, between its in and out maps) and K2's Dolby Vision
// route (rows3_tail_dovi.cu: at the source resolution, stage A of the
// two-stage form): the reshape of ops/dovi (each channel's piece, its
// polynomial or MMR value, clipped), the 3x3+c RPU matrix, then the LMS
// step (PQ EOTF, the combined LMS->RGB matrix, PQ OETF, or with an identity
// product max(x, 0)).  Every operation rounds on its own, in the order of
// the torch plain version (ops/dovi.MidStage.plain).
//
// Runtime values: the colour matrix, the combined LMS matrix and the curve
// scalars (at most 12 + 9 + 549 floats) and the curve structure (pieces,
// kinds, MMR orders) travel in one MidParams passed by value with the
// launch, so a new scene's curves need no rebuild.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "route.cuh"
#include "tail.cuh"

namespace vrt {
namespace dovi {

constexpr int kMaxPieces = 8;
constexpr int kHead = 12 + 9;       // the colour matrix, then the LMS matrix
constexpr int kMaxVals = kHead + 3 * (7 + kMaxPieces * 22);

struct Curve {
  int pieces;
  int piv;                 // offset of the pieces - 1 pivots in vals
  int kind[kMaxPieces];    // 0 polynomial, 1 MMR
  int order[kMaxPieces];   // MMR order
  int off[kMaxPieces];     // offset of the piece's coefficients in vals
};

struct MidParams {
  float vals[kMaxVals];    // [cmat 3 x (m0 m1 m2 c)][lms 3 x 3][curves]
  Curve curve[3];
  int lms_identity, n_vals;
  float y_scale, c_scale;
};

// A convert route fixed at compile time: the LMS step (kLmsIdentity:
// max(x, 0); kLmsFull: the PQ round trip through the LMS matrix; kRt: the
// launch's flag) and the curves (kPoly1: one polynomial piece a channel,
// read from the launch's parameter at fixed offsets; kRt: the launch's
// structure, copied with the scalars into shared memory once a block).
// c8's light route converts a thread's 4 adjacent columns side by side;
// the others, whose convert is long dependent chains of accurate pows and
// divisions, one pixel at a time (K8 deals its window's pixels out one a
// thread, so that every thread converts within one pixel of the same
// count: 17 of a 66-row window's 4224, where rows of 4 would give some
// threads 20).
enum { kLmsIdentity = 0, kLmsFull = 1 };
enum { kPoly1 = 1 };

template <int L, int C>
struct MidRoute {
  static constexpr int kLms = L, kCurves = C;
  static constexpr bool kRuntimeCurves = C == kRt;
  // a light route runs a thread's 4 pixels side by side; the others deal
  // out the window's pixels one at a time
  static constexpr bool kSideBySide = L == kLmsIdentity && C == kPoly1;
  // K8's resident blocks an SM: 3 for the light route (c8's 32-row tiles,
  // 70 KB), more for the others, whose long dependent chains need warps
  // (kernels/deint.K8_HEAVY_TILE_ROWS halves their tiles to fit)
  static constexpr int kMinBlocks = kSideBySide ? 3 : 6;
};

// c8: identity curves and an LMS product that folds away
using C8Mid = MidRoute<kLmsIdentity, kPoly1>;
// a stream whose LMS matrices are not mutual inverses (c8's variant)
using LmsMid = MidRoute<kLmsFull, kRt>;
using RuntimeMid = MidRoute<kRt, kRt>;

using vrt::add;
using vrt::mul;

// reshape_mmr (Source/Shaders.cpp:733-763): c + sum over orders j of the
// 3 linear and 4 cross terms, each raised to the power j + 1.
__device__ __forceinline__ float mmr(const float* w, int order,
                                     const float sig[3]) {
  const float lin[3] = {sig[0], sig[1], sig[2]};
  const float s01 = mul(sig[0], sig[1]);
  const float cross[4] = {s01, mul(sig[0], sig[2]), mul(sig[1], sig[2]),
                          mul(s01, sig[2])};
  float lj[3] = {lin[0], lin[1], lin[2]};
  float cj[4] = {cross[0], cross[1], cross[2], cross[3]};
  float acc = w[0];
  const float* wp = w + 1;
  for (int j = 0; j < order; ++j, wp += 7) {
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) lj[k] = mul(lj[k], lin[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) cj[k] = mul(cj[k], cross[k]);
    }
    float tl = mul(wp[0], lj[0]);
    tl = add(tl, mul(wp[1], lj[1]));
    tl = add(tl, mul(wp[2], lj[2]));
    float tc = mul(wp[3], cj[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) tc = add(tc, mul(wp[3 + k], cj[k]));
    acc = add(add(acc, tl), tc);
  }
  return acc;
}

// ShaderDoviReshape (Source/Shaders.cpp:554-589) of channel ``ch``: the
// piece is the count of pivots at or below the signal.  ``vals`` and
// ``curves`` are the shared-memory copies (runtime curves).
template <typename R>
__device__ __forceinline__ float reshape(const MidParams& P, const float* vals,
                                         const Curve* curves, int ch, float s,
                                         const float sig[3]) {
  if constexpr (R::kCurves == kPoly1) {
    // one piece a channel: no pivots, coefficients at kHead + 3 * ch
    const float* w = P.vals + kHead + 3 * ch;
    return vrt::clip01(add(mul(add(mul(w[2], s), w[1]), s), w[0]));
  } else {
    const Curve& C = curves[ch];
    int idx = 0;
    for (int k = 0; k < C.pieces - 1; ++k) idx += s >= vals[C.piv + k];
    const float* w = vals + C.off[idx];
    const float val = C.kind[idx] == 0
                          ? add(mul(add(mul(w[2], s), w[1]), s), w[0])
                          : mmr(w, C.order[idx], sig);
    return vrt::clip01(val);
  }
}

// The DoVi convert of one pixel: reshape, RPU matrix, LMS step.  The
// matrices are read from the launch's parameter at fixed offsets.
template <typename R>
__device__ __forceinline__ void dovi_mid(const MidParams& P, const float* vals,
                                         const Curve* curves, float yv,
                                         float uv, float vv, float c[3]) {
  const float sig[3] = {vrt::clip01(yv), vrt::clip01(uv), vrt::clip01(vv)};
  float ycc[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    ycc[ch] = reshape<R>(P, vals, curves, ch, sig[ch], sig);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = P.vals + 4 * i;
    c[i] = add(vrt::dot3(m[0], m[1], m[2], ycc[0], ycc[1], ycc[2]), m[3]);
  }
  const bool identity =
      R::kLms == kRt ? P.lms_identity != 0 : R::kLms == kLmsIdentity;
  if (identity) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = fmaxf(c[i], 0.f);
    return;
  }
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = vrt::pq_to_linear(fmaxf(c[i], 0.f), 1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = P.vals + 12 + 3 * i;
    c[i] = vrt::linear_to_pq(
        fmaxf(vrt::dot3(m[0], m[1], m[2], x[0], x[1], x[2]), 0.f));
  }
}


// Host side.

// The compiled route a launch of K8 or K2's Dolby Vision route takes: 1
// c8's (uint16 luma, float32 chroma, identity curves and LMS fold), 2 the
// LMS route (uint16 luma, float32 chroma, a non-identity LMS step), 0
// runtime.
inline int route_of(int y_dtype, int c_dtype, const MidParams& P) {
  if (y_dtype != vrt::dtype_code<uint16_t>() ||
      c_dtype != vrt::dtype_code<float>()) {
    return 0;
  }
  if (P.lms_identity) {
    for (int ch = 0; ch < 3; ++ch) {
      if (P.curve[ch].pieces != 1 || P.curve[ch].kind[0] != 0) return 0;
    }
    return 1;
  }
  return 2;
}

inline const char* const kRouteNames[] = {"runtime", "c8 uint16/float32",
                                          "lms uint16/float32"};

// The launch's parameters from its host arrays; false for a structure the
// kernel does not take.
inline bool params_of(const void* host_vals, int n_vals,
                      const void* host_structure, int lms_identity,
                      float y_scale, float c_scale, MidParams* P) {
  if (n_vals > kMaxVals || n_vals < kHead) return false;
  *P = MidParams{};
  const float* hv = static_cast<const float*>(host_vals);
  for (int i = 0; i < n_vals; ++i) P->vals[i] = hv[i];
  const int* hs = static_cast<const int*>(host_structure);
  int o = kHead;
  for (int ch = 0; ch < 3; ++ch) {
    Curve& C = P->curve[ch];
    const int* d = hs + ch * (1 + 2 * kMaxPieces);
    C.pieces = d[0];
    if (C.pieces < 1 || C.pieces > kMaxPieces) return false;
    C.piv = o;
    o += C.pieces - 1;
    for (int p = 0; p < C.pieces; ++p) {
      C.kind[p] = d[1 + p];
      C.order[p] = d[1 + kMaxPieces + p];
      if (C.kind[p] != 0 && (C.order[p] < 1 || C.order[p] > 3)) return false;
      C.off[p] = o;
      o += C.kind[p] == 0 ? 3 : 1 + 7 * C.order[p];
    }
  }
  if (o != n_vals) return false;
  P->lms_identity = lms_identity;
  P->n_vals = n_vals;
  P->y_scale = y_scale;
  P->c_scale = c_scale;
  return true;
}

}  // namespace dovi
}  // namespace vrt
