// K9 (csrc/cols3_tail.cu): the long-window kernel, which reads its taps
// through the read-only cache and stages nothing, on the runtime route at
// every pair of plane dtypes, in a translation unit of its own, so that the
// build compiles it in parallel with the others.

#include "cols3_tail.cuh"

template VRT_K9_LAUNCH_ANY(launch_long, RuntimeRoute);
