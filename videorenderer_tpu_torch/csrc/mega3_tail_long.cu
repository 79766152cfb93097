// K4 (csrc/mega3_tail.cu): the long-window kernel on the runtime route at
// every pair of plane dtypes, in a translation unit of its own, so that the
// build compiles it in parallel with the others.

#include "mega3_tail.cuh"

template VRT_K4_LAUNCH_ANY(RuntimeRoute, true);
