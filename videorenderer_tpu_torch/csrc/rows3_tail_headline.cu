// K2 (csrc/rows3_tail.cu): the headline's routes (PQ -> SDR, 10-bit dither;
// packed and planar), in a translation unit of their own, so that the build
// compiles them in parallel with the others.

#include "rows3_tail.cuh"

template VRT_K2_LAUNCH(Headline, int16_t, int16_t);
template VRT_K2_LAUNCH(Headline, float, float);
template VRT_K2_LAUNCH(HeadlineFloat, float, float);
