// K4 (csrc/mega3_tail.cu): c7's route (the BT.2390 local tone map, 10-bit
// dither, planar float) on the raw P010 planes, in a translation unit of its
// own, so that the build compiles it in parallel with the others.

#include "mega3_tail.cuh"

template VRT_K4_LAUNCH(C7Float, uint16_t, uint16_t);
