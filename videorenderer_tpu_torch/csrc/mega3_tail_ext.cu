// K4 (csrc/mega3_tail.cu): the extended runtime route (route.cuh's
// RuntimeExtended: the tail with the Dolby Vision L2 trims and the HDR10+
// guided curve) of the staged kernel at every pair of plane dtypes, in a
// translation unit of its own, so that the build compiles it in parallel
// with the others and the plain runtime route keeps its registers.

#include "mega3_tail.cuh"

template VRT_K4_LAUNCH_ANY(RuntimeExtended, false);
