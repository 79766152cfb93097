// K9 (csrc/cols3_tail.cu): the long-window kernel, which reads its taps
// through the read-only cache and stages nothing, on the runtime route at
// every pair of plane dtypes, in a translation unit of its own, so that the
// build compiles it in parallel with the others.

#include "cols3_tail.cuh"

namespace vrt {
namespace k9 {

int launch_long(int y_dtype, int c_dtype, const void* y, const void* u,
                const void* v, const Geometry& G, const vrt::TailParams& P,
                int batch, void* out, cudaStream_t st) {
  if (G.tile_rows < 1 || G.tile_rows > kMaxTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((G.w_out + kTileCols - 1) / kTileCols,
                  (G.h + G.tile_rows - 1) / G.tile_rows, batch);
  return vrt::dispatch_planes(y_dtype, c_dtype, [&](auto y_tag, auto c_tag) {
    using TY = decltype(y_tag);
    using TC = decltype(c_tag);
    cols3_tail_long_kernel<vrt::RuntimeRoute, TY, TC>
        <<<grid, dim3(kColThreads, kRowThreads), 0, st>>>(
            static_cast<const TY*>(y), static_cast<const TC*>(u),
            static_cast<const TC*>(v), G, P, out);
  });
}

}  // namespace k9
}  // namespace vrt
