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
// K8's LMS route reads the curves from fixed slots of the launch's vals
// (to_slots): after the matrices, each channel's kMaxPieces - 1 pivots,
// then kSlot floats for each channel's kMaxPieces pieces (a polynomial's
// 3 coefficients, or an MMR piece's constant and 7 weights an order), so
// that every offset is known at compile time and every scalar is an
// operand read from the constant bank.
constexpr int kSlot = 1 + 7 * 3;
constexpr int kSlotPivots = kHead;
constexpr int kSlotWeights = kSlotPivots + 3 * (kMaxPieces - 1);
static_assert(kSlotWeights + 3 * kMaxPieces * kSlot == kMaxVals,
              "the slots fill vals");

__host__ __device__ constexpr int slot_of(int ch, int piece) {
  return kSlotWeights + (ch * kMaxPieces + piece) * kSlot;
}

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
// structure, copied with the scalars into shared memory once a block; K8's
// LMS route reads them from the launch's parameter, in slots).  c8's light
// route converts a thread's 4 adjacent columns side by side with dovi_mid;
// K8's LMS route converts them as one group with dovi_mid_group; the
// runtime route, whose convert is long dependent chains of accurate pows
// and divisions, one pixel at a time (K8 deals its window's pixels out one
// a thread, so that every thread converts within one pixel of the same
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
  // K8's LMS route converts a thread's 4 adjacent pixels as one group
  // (dovi_mid_group); K2's Dolby Vision route keeps dovi_mid
  static constexpr bool kGroupMid = L == kLmsFull && C == kRt;
  // K8's resident blocks an SM: 3 (80 registers) for the light route
  // (c8's 32-row tiles, 70 KB) and the LMS route (its group's chains;
  // kernels/deint.K8_LMS_TILE_ROWS: 31-row tiles, 68 KB, whose 64-row
  // window at c8's 2:1 is 4 rows of groups a thread), 6 for the runtime
  // route, whose long dependent chains need warps
  // (kernels/deint.K8_HEAVY_TILE_ROWS halves its tiles to fit)
  static constexpr int kMinBlocks = kSideBySide || kGroupMid ? 3 : 6;
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


// K8's LMS route (LmsMid) converts a thread's kGroup adjacent pixels as one
// group (dovi_mid_group), each stage across the group before the next:
//   * the curves stay data, the launch's structure and scalars, so a new
//     scene or stream rebuilds nothing; but the host lays the scalars out
//     in fixed slots (to_slots), so that the reshape reads each pivot and
//     coefficient as an operand from the constant bank, and the dispatch
//     is compiled: the piece search unrolled over kMaxPieces, each pivot
//     read once for the group; the pieces unrolled, each piece's value
//     taken at the group's pixels side by side and kept by a select, its
//     kind and MMR order one switch to a body unrolled for its order
//     (mmr_fixed);
//   * the RPU matrix of the group; then the LMS steps (the 3 PQ EOTFs, the
//     LMS matrix, the 3 PQ OETFs of a pixel) kLmsLanes pixels at a time
//     under tail.cuh's CheckedPow: their 12 pows a pixel without
//     libdevice's arms for non-normal values, their 6 divisions as
//     CheckedDiv, all with one range flag for the group; a group out of
//     its range runs its LMS steps again, one pixel at a time, with
//     ExactDiv (__fdiv_rn and pow_pos), and adds one to the launch's redo
//     counter.
// Every operation and its order are dovi_mid's, so the bits are too.  The
// LMS steps take one pixel a pass and not more side by side: on one H100
// at the p5 cell's call, with CheckedPow, K8 took 4.14 ms with one, 4.38
// with two and 4.97 with four, whose 80 registers spill (PERF.md,
// section 6).
constexpr int kLmsLanes = 1;

// mmr with its order fixed at compile time: the same products and sums in
// the same order, unrolled.
template <int N>
__device__ __forceinline__ float mmr_fixed(const float* w,
                                           const float sig[3]) {
  const float lin[3] = {sig[0], sig[1], sig[2]};
  const float s01 = mul(sig[0], sig[1]);
  const float cross[4] = {s01, mul(sig[0], sig[2]), mul(sig[1], sig[2]),
                          mul(s01, sig[2])};
  float lj[3] = {lin[0], lin[1], lin[2]};
  float cj[4] = {cross[0], cross[1], cross[2], cross[3]};
  float acc = w[0];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float* wp = w + 1 + 7 * j;
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

// Channel ``ch``'s reshape of N pixels, from the slots (to_slots): each
// pixel's piece is the count of pivots at or below its signal (the search
// unrolled over kMaxPieces - 1 pivots, each an operand for the N pixels);
// then, piece by piece (unrolled over kMaxPieces, the launch's piece count
// a bound every thread shares), the pixels of that piece take its value,
// its kind and MMR order dispatched by one switch, its coefficients
// operands.  A thread runs the body of each piece one of its pixels lies
// on.
template <int N>
__device__ __forceinline__ void reshape_group(const MidParams& P, int ch,
                                              const float (&sig)[N][3],
                                              float (&ycc)[3][N]) {
  const Curve& C = P.curve[ch];
  const float* pivot = P.vals + kSlotPivots + (kMaxPieces - 1) * ch;
  int idx[N];
  float val[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    idx[j] = 0;
    val[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kMaxPieces - 1; ++k) {
    if (k >= C.pieces - 1) break;
#pragma unroll
    for (int j = 0; j < N; ++j) idx[j] += sig[j][ch] >= pivot[k];
  }
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p) {
    if (p >= C.pieces) break;
    const float* w = P.vals + slot_of(ch, p);
    // the piece's value at each of the N pixels, kept by those on it (a
    // select: N chains side by side, no branch a pixel)
    float v[N];
    const int code = C.kind[p] == 0 ? 0 : C.order[p];
    if (code == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float s = sig[j][ch];
        v[j] = add(mul(add(mul(w[2], s), w[1]), s), w[0]);
      }
    } else {
      // an MMR piece of a curve of more than two pieces: a thread none of
      // whose pixels lies on it skips it (up to two, every pixel takes
      // both, with no branch)
      bool here = C.pieces <= 2;
#pragma unroll
      for (int j = 0; j < N; ++j) here |= idx[j] == p;
      if (!here) continue;
      switch (code) {
        case 1:
#pragma unroll
          for (int j = 0; j < N; ++j) v[j] = mmr_fixed<1>(w, sig[j]);
          break;
        case 2:
#pragma unroll
          for (int j = 0; j < N; ++j) v[j] = mmr_fixed<2>(w, sig[j]);
          break;
        default:
#pragma unroll
          for (int j = 0; j < N; ++j) v[j] = mmr_fixed<3>(w, sig[j]);
          break;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) val[j] = idx[j] == p ? v[j] : val[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) ycc[ch][j] = vrt::clip01(val[j]);
}

// The LMS step of N pixels (rgb and c channel-major): the 3 x N PQ EOTFs,
// the LMS matrix, the 3 x N PQ OETFs, dividing with ``d``.
template <int N, class D>
__device__ __forceinline__ void lms_step(const MidParams& P,
                                         const float (&rgb)[3][N],
                                         float (&c)[3][N], D& d) {
  float x[3][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i][j] = vrt::pq_to_linear(fmaxf(rgb[i][j], 0.f), 1.f, d);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* m = P.vals + 12 + 3 * i;
      c[i][j] = vrt::linear_to_pq(
          fmaxf(vrt::dot3(m[0], m[1], m[2], x[0][j], x[1][j], x[2][j]), 0.f),
          d);
    }
  }
}

// The LMS steps of a thread's kGroup pixels, L at a time (a loop that is
// not unrolled, its pixels picked and put in place by selects), dividing
// with ``d``.
template <int L, class D>
__device__ __forceinline__ void lms_lanes(const MidParams& P,
                                          const float (&rgb)[3][kGroup],
                                          float (&o)[3][kGroup], D& d) {
#pragma unroll 1
  for (int h = 0; h < kGroup; h += L) {
    float in[3][L], out[3][L];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int l = 0; l < L; ++l) in[i][l] = vrt::pick(rgb[i], h + l);
    }
    lms_step(P, in, out, d);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (j == h + l) {
#pragma unroll
          for (int i = 0; i < 3; ++i) o[i][j] = out[i][l];
        }
      }
    }
  }
}

// The LMS route's convert of a thread's kGroup pixels (c pixel-major, as
// dovi_mid's): the reshapes and the RPU matrix of the kGroup pixels side
// by side, then their LMS steps kLmsLanes pixels a pass, the pows and
// divisions of all of them with one CheckedPow flag; a group out of its
// range runs its LMS steps again, one pixel at a time, with __fdiv_rn and
// pow_pos, and is counted in ``redo`` (route.cuh's count_redo; none
// counted where it is null).
__device__ __forceinline__ void dovi_mid_group(const MidParams& P,
                                               const float (&yv)[kGroup],
                                               const float (&uv)[kGroup],
                                               const float (&vv)[kGroup],
                                               float (&c)[kGroup][3],
                                               unsigned long long* redo) {
  float sig[kGroup][3];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    sig[j][0] = vrt::clip01(yv[j]);
    sig[j][1] = vrt::clip01(uv[j]);
    sig[j][2] = vrt::clip01(vv[j]);
  }
  float ycc[3][kGroup];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) reshape_group(P, ch, sig, ycc);
  float rgb[3][kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* m = P.vals + 4 * i;
      rgb[i][j] = add(
          vrt::dot3(m[0], m[1], m[2], ycc[0][j], ycc[1][j], ycc[2][j]), m[3]);
    }
  }
  float o[3][kGroup];
  vrt::CheckedPow div;
  lms_lanes<kLmsLanes>(P, rgb, o, div);
  if (!div.ok) {
    vrt::count_redo(redo);
    vrt::ExactDiv exact;
    lms_lanes<1>(P, rgb, o, exact);
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c[j][i] = o[i][j];
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

// The launch's curves rewritten into K8's LMS route's slots (kSlotPivots,
// slot_of): the same scalars, each at an offset fixed by its channel and
// piece; the matrices, the structure and n_vals are left as they are.
inline void to_slots(MidParams* P) {
  float v[kMaxVals] = {};
  for (int i = 0; i < kHead; ++i) v[i] = P->vals[i];
  for (int ch = 0; ch < 3; ++ch) {
    const Curve& C = P->curve[ch];
    for (int k = 0; k < C.pieces - 1; ++k) {
      v[kSlotPivots + (kMaxPieces - 1) * ch + k] = P->vals[C.piv + k];
    }
    for (int p = 0; p < C.pieces; ++p) {
      const int n = C.kind[p] == 0 ? 3 : 1 + 7 * C.order[p];
      for (int i = 0; i < n; ++i) {
        v[slot_of(ch, p) + i] = P->vals[C.off[p] + i];
      }
    }
  }
  for (int i = 0; i < kMaxVals; ++i) P->vals[i] = v[i];
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
