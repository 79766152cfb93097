// K2 (csrc/rows3_tail.cu): the extended runtime route (route.cuh's
// RuntimeExtended: the tail with the Dolby Vision L2 trims and the HDR10+
// guided curve), staged and long-window, at every pair of plane dtypes, in
// a translation unit of its own, so that the build compiles it in parallel
// with the others and the plain runtime route keeps its registers.

#include "rows3_tail.cuh"

template VRT_K2_LAUNCH_ANY(launch_runtime, RuntimeExtended);
template VRT_K2_LAUNCH_ANY(launch_long, RuntimeExtended);
