// The tail routes of the kernels that end the pipeline in a 4-pixel group
// (K2 rows3_tail.cuh, K9 cols3_tail.cuh): a route fixed at compile time,
// the named routes the port's paths run, the group's tail with one
// CheckedDiv check, its quantization and store, and the host side that
// picks a compiled route from a launch's flags.
//
// A route (colour matrix, correction, tone map, quantization, pack) is a
// set of template parameters of tail.cuh's and epilogue.cuh's functions: a
// compiled route keeps only its own path, its branches and its registers,
// and runs its thread's 4 pixels' tails side by side under one arithmetic
// policy with one range flag for the group (Policy below): CheckedDiv, its
// pows libdevice's pow_pos, on every compiled route but c7's; CheckedPow,
// which also takes the pows without libdevice's arms for non-normal values,
// on C7 and C7Float (K2's three c7 routes, K4's c7 route).  The rare group
// with a value out of the policy's range runs its tail again, one pixel at
// a time, with __fdiv_rn and pow_pos (tail_exact); on CheckedPow's routes
// it adds one to the launch's redo counter (TailParams::redo()).
// RuntimeRoute reads the flags from the launch's parameters and runs every
// pixel through tail_exact.  All of them run the same operations in the same
// order, so they give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>
#include <type_traits>

#include "epilogue.cuh"
#include "tail.cuh"

namespace vrt {

constexpr int kGroup = 4;   // consecutive output columns a thread makes
constexpr int kRt = kRuntime;

template <typename T>
struct alignas(sizeof(T) * kGroup) Vec {
  T v[kGroup];
};

// A tail route fixed at compile time: colour matrix (0/1), correction,
// tone-map selection, quantization mode and pack; kRt in a field reads that
// flag from the launch's parameters.  X: the route carries the L2 trims and
// the guided curve (tail.cuh's kExt).
template <int M, int C, int TM, int Q, int PK, bool X = false>
struct Route {
  static constexpr int kMat = M, kCorr = C, kTm = TM, kQuant = Q, kPack = PK;
  static constexpr bool kReadsFlags = M == kRt, kExt = X;
};

// The runtime routes read every flag; the extended one carries the L2 trims
// and the guided curve as well, and takes the launches that need them.
using RuntimeRoute = Route<kRt, kRt, kRt, kRt, kRt>;
using RuntimeExtended = Route<kRt, kRt, kRt, kRt, kRt, true>;

// The routes the port's paths run (pipeline._make_tail_epilogue,
// cmat_epilogue, torch_headline_micro's stages).
// the headline: PQ -> SDR, 10-bit ordered dither, R10G10B10A2
using Headline = Route<1, kCorrPqToSdr, kTmNone, kQuantDither, kPackRgb10a2>;
// the same, planar float (the stage split's tailNoPack)
using HeadlineFloat = Route<1, kCorrPqToSdr, kTmNone, kQuantDither, kPackNone>;
// c1: no correction, 8-bit ordered dither, RGBA8
using C1 = Route<1, kCorrNone, kTmNone, kQuantDither, kPackRgba8>;
// c5 (K2 at single rate, K9 at double rate): HLG -> SDR, 8-bit ordered
// dither, RGBA8
using C5 = Route<1, kCorrHlgToSdr, kTmNone, kQuantDither, kPackRgba8>;
// c7: the BT.2390 local tone map, 10-bit dither, R10G10B10A2; and planar
using C7 = Route<1, kCorrNone, kTmBt2390, kQuantDither, kPackRgb10a2>;
using C7Float = Route<1, kCorrNone, kTmBt2390, kQuantDither, kPackNone>;
// c8 (K9): the planes are R, G, B already; PQ -> SDR, 10-bit ordered
// dither, R10G10B10A2
using C8 = Route<0, kCorrPqToSdr, kTmNone, kQuantDither, kPackRgb10a2>;
// HLG passthrough: HLG -> PQ, 10-bit dither, R10G10B10A2
using HlgToPq = Route<1, kCorrHlgToPq, kTmNone, kQuantDither, kPackRgb10a2>;
// the colour matrix only: planar float (the staged convert, c3 rotation
// 270) and R10G10B10A2 (the stage split's tailID)
using MatrixFloat = Route<1, kCorrNone, kTmNone, kQuantNone, kPackNone>;
using MatrixRgb10 = Route<1, kCorrNone, kTmNone, kQuantNone, kPackRgb10a2>;
// no matrix: the taps and the store (the stage split's tailH)
using PlanesRgb10 = Route<0, kCorrNone, kTmNone, kQuantNone, kPackRgb10a2>;

// The arithmetic policy of a compiled route's first pass (tail.cuh):
// CheckedDiv, or CheckedPow on the routes named below.  A route takes
// CheckedPow by one line here; the others keep their code, and their
// registers.
template <typename R>
struct Policy {
  using type = CheckedDiv;
};
template <>
struct Policy<C7> {
  using type = CheckedPow;
};
template <>
struct Policy<C7Float> {
  using type = CheckedPow;
};

// a[k] through selects, so an array indexed by a loop that is not unrolled
// stays in registers
__device__ __forceinline__ float pick(const float a[kGroup], int k) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < kGroup; ++j) v = k == j ? a[j] : v;
  return v;
}

// The tail of the thread's pixels one at a time, dividing with __fdiv_rn:
// the runtime route, and a compiled route's rare second pass.
template <typename R>
__device__ __forceinline__ void tail_exact(const TailParams& P,
                                           const float yv[kGroup],
                                           const float uv[kGroup],
                                           const float vv[kGroup],
                                           float c[kGroup][3]) {
#pragma unroll 1
  for (int k = 0; k < kGroup; ++k) {
    float ck[3];
    color_tail<R::kMat, R::kCorr, R::kTm, R::kExt>(
        P.tail, pick(yv, k), pick(uv, k), pick(vv, k), ck);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j == k) {
        c[j][0] = ck[0];
        c[j][1] = ck[1];
        c[j][2] = ck[2];
      }
    }
  }
}

// Adds the number of a warp's threads whose groups run again exactly
// (tail_exact; K8's LMS steps in dovi_mid.cuh) to the launch's counter, one
// atomic by the first of them (kernels/resize gives K2's, K4's and K8's
// launches a counter; none where the address is 0).
__device__ __forceinline__ void count_redo(unsigned long long* redo) {
  const unsigned active = __activemask();
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  if (redo != nullptr && lane == __ffs(active) - 1) {
    atomicAdd(redo, static_cast<unsigned long long>(__popc(active)));
  }
}

// The tail of a thread's 4 pixels: a compiled route runs them side by side
// under its Policy with one check for all their divisions (and CheckedPow's
// pows), and a group with a value out of the policy's range runs its tail
// again, exactly; the runtime route runs tail_exact.
template <typename R>
__device__ __forceinline__ void tail_group(const TailParams& P,
                                           const float yv[kGroup],
                                           const float uv[kGroup],
                                           const float vv[kGroup],
                                           float c[kGroup][3]) {
  if constexpr (R::kReadsFlags) {
    tail_exact<R>(P, yv, uv, vv, c);
  } else {
    using D = typename Policy<R>::type;
    D div;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      color_tail<R::kMat, R::kCorr, R::kTm, R::kExt>(P.tail, yv[k], uv[k],
                                                     vv[k], c[k], div);
    }
    if (!div.ok) {
      if constexpr (std::is_same_v<D, CheckedPow>) count_redo(P.redo());
      tail_exact<R>(P, yv, uv, vv, c);
    }
  }
}

// Where a kernel's output frames go: surfaces of h x w pixels with the
// video's row 0 and column 0 at (oy, ox), the bars around it written by the
// caller (kernels/resize.rows3_tail's ``place``); an unplaced output is its
// own surface, at (0, 0).
struct Place {
  int h, w, oy, ox;
};

// The quantization of 4 pixels at the video's row ``row`` of frame ``b``
// (w columns), columns col .. col + 3, from the video's row and column, and
// their store into surface ``S``: one R10G10B10A2 / RGBA8 dword each at
// (b * S.h + S.oy + row) * S.w + S.ox + col, as one 16-byte store where
// ``vec`` (the caller's: that address 16-byte aligned) and the 4 columns lie
// inside the row, or planar float RGB at ((b * 3 + i) * S.h + S.oy + row) *
// S.w + S.ox + col, likewise.  Columns past w are not stored.
template <typename R>
__device__ __forceinline__ void store_group(float c[kGroup][3],
                                            const TailParams& P,
                                            void* __restrict__ out,
                                            long long b, const Place& S,
                                            int w, int row, int col,
                                            bool vec) {
  const int pack = R::kPack != kRt ? R::kPack : P.pack;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    quantize3<R::kQuant>(c[k], P.quant, row, col + k);
  }
  const long long px = (b * S.h + S.oy + row) * S.w + S.ox + col;
  if (pack != kPackNone) {
    uint32_t wd[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) wd[k] = pack_word<R::kPack>(c[k], pack);
    uint32_t* o = static_cast<uint32_t*>(out) + px;
    if (vec && col + kGroup <= w) {
      Vec<uint32_t> ov;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) ov.v[k] = wd[k];
      *reinterpret_cast<Vec<uint32_t>*>(o) = ov;
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (col + k < w) o[k] = wd[k];
      }
    }
  } else {
    const long long plane = static_cast<long long>(S.h) * S.w;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float* o = static_cast<float*>(out) + px + (b * 2 + i) * plane;
      if (vec && col + kGroup <= w) {
        Vec<float> ov;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) ov.v[k] = c[k][i];
        *reinterpret_cast<Vec<float>*>(o) = ov;
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (col + k < w) o[k] = c[k][i];
        }
      }
    }
  }
}

// Whether a thread's 16-byte stores into surface ``S`` of ``out`` are
// aligned: the video's width, the surface's and the column offset are
// multiples of 4 and ``out`` is 16-byte aligned (an unaligned offset takes
// the scalar stores of the same route).
__device__ __forceinline__ bool place_vec(const void* out, const Place& S,
                                          int w) {
  return w % kGroup == 0 && S.w % kGroup == 0 && S.ox % kGroup == 0 &&
         (reinterpret_cast<uintptr_t>(out) % sizeof(Vec<float>)) == 0;
}

// ---------------------------------------------------------------------------
// host: which compiled route a launch takes
// ---------------------------------------------------------------------------

// A compiled route at one pair of plane dtypes, with the name the route
// queries report.
template <typename R_, typename TY_, typename TC_>
struct Spec {
  using R = R_;
  using TY = TY_;
  using TC = TC_;
  const char* name;
};

// 0 uint8, 1 uint16, 2 int16, 3 float32 (kernels/resize.DTYPE_CODES)
template <typename T>
constexpr int dtype_code() {
  return sizeof(T) == 1 ? 0 : sizeof(T) == 4 ? 3 : T(-1) > T(0) ? 1 : 2;
}

// The launch's flags, as the routes name them; ``trims``: the launch runs
// the L2 trims (tail.cuh's kTrims*), which no compiled route carries.
struct Flags {
  int y_dtype, c_dtype, mat, corr, tm, trims, quant, pack;
  // the launch needs the extended runtime route: the trims or the guided
  // curve
  bool extended() const { return trims || tm == kTmGuided; }
};

inline Flags flags_of(int y_dtype, int c_dtype, int apply_matrix,
                      int correction, int tonemap, int trims,
                      int dither_bits, int pack) {
  return Flags{y_dtype, c_dtype, apply_matrix ? 1 : 0, correction, tonemap,
               trims ? 1 : 0, quant_mode(dither_bits), pack};
}

// Whether the compiled route of spec ``S`` computes a launch with flags
// ``f``: the same flags, and no trims (a launch with the trims or the
// guided curve, selection 7, matches none and takes the runtime route).
template <typename S>
bool matches(const S&, const Flags& f) {
  using R = typename S::R;
  return !f.trims && dtype_code<typename S::TY>() == f.y_dtype &&
         dtype_code<typename S::TC>() == f.c_dtype && R::kMat == f.mat &&
         R::kCorr == f.corr && R::kTm == f.tm && R::kQuant == f.quant &&
         R::kPack == f.pack;
}

// Calls fn(spec) for the first spec of the tuple ``specs`` that matches
// ``f``; returns whether one did.
template <typename Specs, typename Fn>
bool with_spec(const Specs& specs, const Flags& f, Fn&& fn) {
  bool done = false;
  std::apply([&](const auto&... s) {
    ((done = done || (matches(s, f) ? (fn(s), true) : false)), ...);
  }, specs);
  return done;
}

}  // namespace vrt
