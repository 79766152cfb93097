// K2 (csrc/rows3_tail.cu): c7's routes (the BT.2390 local tone map, 10-bit
// dither; packed and planar), in a translation unit of their own, so that the
// build compiles them in parallel with the others.

#include "rows3_tail.cuh"

template VRT_K2_LAUNCH(C7, uint16_t, int16_t);
template VRT_K2_LAUNCH(C7, uint16_t, float);
template VRT_K2_LAUNCH(C7Float, uint16_t, float);
