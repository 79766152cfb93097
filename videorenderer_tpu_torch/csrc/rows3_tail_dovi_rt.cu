// K2's Dolby Vision route (csrc/rows3_tail_dovi.cu): the runtime route (the
// LMS flag and the curve structure read from the launch) at every pair of
// plane dtypes, in a translation unit of its own, so that the build
// compiles it in parallel with the others.

#include "rows3_tail_dovi.cuh"

namespace vrt {
namespace k2 {

int launch_dovi_runtime(int y_dtype, int c_dtype, const void* y,
                        const void* u, const void* v, const Geometry& G,
                        const dovi::MidParams& P, int batch, void* out,
                        cudaStream_t st) {
  int err = 0;
  bool known = false;
  vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    known = true;
    err = launch_dovi<dovi::RuntimeMid, TY, TC>(y, u, v, G, P, batch, out,
                                                st);
  });
  return known ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace k2
}  // namespace vrt
