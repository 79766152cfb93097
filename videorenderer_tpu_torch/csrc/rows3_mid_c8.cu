// K8 (csrc/rows3_mid.cu): c8's route (identity curves, an LMS product that
// folds away) on uint16 luma and K1's float32 chroma, in a translation unit
// of its own, so that the build compiles it in parallel with the others.

#include "rows3_mid.cuh"

template VRT_K8_LAUNCH(C8Mid, uint16_t, float);
