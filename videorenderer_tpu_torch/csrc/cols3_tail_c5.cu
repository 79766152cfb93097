// K9 (csrc/cols3_tail.cu): c5's route (HLG -> SDR, 8-bit ordered dither,
// RGBA8) on K7's float32 fields, in a translation unit of its own, so that
// the build compiles it in parallel with the others.

#include "cols3_tail.cuh"

template VRT_K9_LAUNCH(C5, float, float);
