// K7: motion-adaptive deinterlace of both fields fused into the banded
// H-axis resize of (Y, U, V), for Hopper (sm_90a).
//
// Replaces videorenderer_tpu/kernels/deint_pallas.py: deint3_rows_dual
// (the select is deint_pallas._deint_fields).  From the raw (prev, cur,
// next) planes, one thread per output column and output row (b, m, col) of
// one plane walks the row's T taps of a per-output-row tap table
// (kernels/resize.py: plan_taps, the normalisation folded into the taps).
// At each tap row r it loads prev[r], next[r] and cur[r + 1] (cur[r - 1] and
// cur[r] it carries from the previous tap), computes the motion ramp
// clip((|next - prev| - thr) / thr, 0, 1) once, and the deinterlaced value
// of both temporal fields:
//   a row of the kept field is cur[r];
//   a row of the other field is cur + (bob - cur) * ramp, bob the mean of
//   its vertical neighbours, clamped at the plane's edges (the last row of
//   the top field's reconstruction averages row H - 2 twice; row 0 of the
//   bottom field's averages row 1 twice);
// and accumulates each into its field's sum with an fp32 FMA.  The select
// rounds every operation on its own (__fsub_rn, __fdiv_rn, __fmul_rn,
// __fadd_rn) in the order of the torch plain version, so the deinterlaced
// values equal it bit for bit and only the tap sums differ in order.
// Output: float32 (B, 2, h_out, W) per plane, field-major.
//
// Bound: device memory.  At c5 (16 frames of 4K P010 to 1080 rows) each
// output pair reads ~6 taps of three uint16 planes, which neighbouring
// output rows share through L2, and writes 8 bytes: the three input windows
// are read about once (~1.2 GB per batch) and the two fields written once
// (1.06 GB).  Consecutive threads take consecutive columns, so every load
// and store is coalesced, and the tap weights of one output row are uniform
// across the block.  The TPU kernel's VMEM column stripes and split-bf16
// products do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Plane {
  const T* p;
  const T* c;
  const T* n;
  float* out;
  const int* starts;
  const float* taps;
  int h, w, n_taps;
};

// The deinterlaced value of row r for one field (deint_pallas._deint_fields)
__device__ __forceinline__ float field_value(int r, int h, float up, float cur,
                                             float dn, float ramp,
                                             bool use_top) {
  if ((r & 1) != (use_top ? 1 : 0)) return cur;
  if (use_top) {
    if (r == h - 1) dn = up;      // bottom clamp: row H - 2 twice
  } else if (r == 0) {
    up = dn;                      // top clamp: row 1 twice
  }
  const float bob = vrt::mul(vrt::add(up, dn), 0.5f);
  return vrt::add(cur, vrt::mul(vrt::sub(bob, cur), ramp));
}

// grid: x = batch * h_out output rows, y = the column blocks of Y, then U,
// then V
template <typename T>
__global__ void deint3_kernel(Plane<T> py, Plane<T> pu, Plane<T> pv,
                              int h_out, int y_blocks, int c_blocks,
                              float thr, int top_field_first) {
  const int bx = blockIdx.y;
  const int k = bx < y_blocks ? 0 : (bx < y_blocks + c_blocks ? 1 : 2);
  const Plane<T> P = k == 0 ? py : (k == 1 ? pu : pv);
  const int col = (k == 0 ? bx : bx - y_blocks - (k - 1) * c_blocks)
                  * kThreads + threadIdx.x;
  if (col >= P.w) return;
  const long long ro = blockIdx.x;          // b * h_out + m
  const long long b = ro / h_out;
  const int m = static_cast<int>(ro - b * h_out);
  const int h = P.h;
  const long long w = P.w;
  const long long base = b * h * w + col;
  const T* pp = P.p + base;
  const T* cp = P.c + base;
  const T* np = P.n + base;

  const bool top0 = top_field_first != 0;   // field 0 keeps the top field
  const int s = P.starts[m];
  float up = static_cast<float>(cp[(s > 0 ? s - 1 : 0) * w]);
  float cur = static_cast<float>(cp[s * w]);
  float acc0 = 0.f, acc1 = 0.f;
  for (int t = 0; t < P.n_taps; ++t) {
    const int r = s + t;
    if (r >= h) break;
    const float dn = static_cast<float>(cp[(r + 1 < h ? r + 1 : h - 1) * w]);
    const float pr = static_cast<float>(pp[r * w]);
    const float nx = static_cast<float>(np[r * w]);
    const float ramp = vrt::clip01(
        vrt::dvd(vrt::sub(fabsf(vrt::sub(nx, pr)), thr), thr));
    const float wt = P.taps[t * h_out + m];
    acc0 = fmaf(field_value(r, h, up, cur, dn, ramp, top0), wt, acc0);
    acc1 = fmaf(field_value(r, h, up, cur, dn, ramp, !top0), wt, acc1);
    up = cur;
    cur = dn;
  }
  float* o = P.out + ((b * 2) * h_out + m) * w + col;
  o[0] = acc0;
  o[static_cast<long long>(h_out) * w] = acc1;
}

template <typename T>
void launch(const void* const* planes, int batch, int hy, int wy, int hc,
            int wc, int h_out, const int* sy, const float* ty, int nty,
            const int* sc, const float* tc, int ntc, float thr,
            int top_field_first, float* oy, float* ou, float* ov,
            cudaStream_t stream) {
  auto mk = [&](int i, float* out, const int* s, const float* t, int h, int w,
                int n) {
    return Plane<T>{static_cast<const T*>(planes[3 * i]),
                    static_cast<const T*>(planes[3 * i + 1]),
                    static_cast<const T*>(planes[3 * i + 2]), out, s, t, h, w,
                    n};
  };
  const int y_blocks = (wy + kThreads - 1) / kThreads;
  const int c_blocks = (wc + kThreads - 1) / kThreads;
  const dim3 grid(batch * h_out, y_blocks + 2 * c_blocks);
  deint3_kernel<T><<<grid, kThreads, 0, stream>>>(
      mk(0, oy, sy, ty, hy, wy, nty), mk(1, ou, sc, tc, hc, wc, ntc),
      mk(2, ov, sc, tc, hc, wc, ntc), h_out, y_blocks, c_blocks, thr,
      top_field_first);
}

}  // namespace

// ``planes``: HOST array of 9 device pointers, (prev, cur, next) of Y, then
// of U, then of V, all of one dtype: 0 uint8, 1 uint16, 2 int16, 3 float32.
// Outputs float32 (batch, 2, h_out, w) per plane.
extern "C" int vrt_deint3_rows_dual(
    const void* planes, int dtype, int batch, int hy, int wy, int hc, int wc,
    int h_out, const void* starts_y, const void* taps_y, int n_taps_y,
    const void* starts_c, const void* taps_c, int n_taps_c, float thr,
    int top_field_first, void* out_y, void* out_u, void* out_v,
    void* stream) {
  const void* const* ps = static_cast<const void* const*>(planes);
  const int* sy = static_cast<const int*>(starts_y);
  const float* ty = static_cast<const float*>(taps_y);
  const int* sc = static_cast<const int*>(starts_c);
  const float* tc = static_cast<const float*>(taps_c);
  float* oy = static_cast<float*>(out_y);
  float* ou = static_cast<float*>(out_u);
  float* ov = static_cast<float*>(out_v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<uint8_t>(ps, batch, hy, wy, hc, wc, h_out, sy, ty, n_taps_y, sc, tc, n_taps_c, thr, top_field_first, oy, ou, ov, st); break;
    case 1: launch<uint16_t>(ps, batch, hy, wy, hc, wc, h_out, sy, ty, n_taps_y, sc, tc, n_taps_c, thr, top_field_first, oy, ou, ov, st); break;
    case 2: launch<int16_t>(ps, batch, hy, wy, hc, wc, h_out, sy, ty, n_taps_y, sc, tc, n_taps_c, thr, top_field_first, oy, ou, ov, st); break;
    case 3: launch<float>(ps, batch, hy, wy, hc, wc, h_out, sy, ty, n_taps_y, sc, tc, n_taps_c, thr, top_field_first, oy, ou, ov, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
