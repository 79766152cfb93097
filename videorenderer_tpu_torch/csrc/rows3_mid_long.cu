// K8 (csrc/rows3_mid.cu): the long-window kernel, which keeps no mid window
// in shared memory and reads its inputs through the read-only cache, on the
// runtime route at every pair of plane dtypes, in a translation unit of its
// own, so that the build compiles it in parallel with the others.

#include "rows3_mid.cuh"

namespace vrt {
namespace k8 {

int launch_long(int y_dtype, int c_dtype, const void* y, const void* u,
                const void* v, const Geometry& G, const MidParams& P,
                int batch, void* out, cudaStream_t st) {
  if (G.tile_rows < 1 || G.n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((G.w + kTileCols - 1) / kTileCols, G.n_tiles, batch);
  return vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    rows3_mid_long_kernel<RuntimeMid, TY, TC><<<grid, kThreads, 0, st>>>(
        static_cast<const TY*>(y), static_cast<const TC*>(u),
        static_cast<const TC*>(v), G, P, static_cast<float*>(out));
  });
}

}  // namespace k8
}  // namespace vrt
