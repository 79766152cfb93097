// K9 (csrc/cols3_tail.cu): c8's route (the planes are R, G, B already;
// PQ -> SDR, 10-bit ordered dither, R10G10B10A2) on K8's float32 planes, in
// a translation unit of its own, so that the build compiles it in parallel
// with the others.

#include "cols3_tail.cuh"

template VRT_K9_LAUNCH(C8, float, float);
