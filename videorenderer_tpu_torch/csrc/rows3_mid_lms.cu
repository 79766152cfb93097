// K8 (csrc/rows3_mid.cu): the route of a stream whose LMS matrices are not
// mutual inverses (the PQ round trip through the LMS matrix, curves of any
// structure) on uint16 luma and K1's float32 chroma, in a translation unit
// of its own, so that the build compiles it in parallel with the others.

#include "rows3_mid.cuh"

template VRT_K8_LAUNCH(LmsMid, uint16_t, float);
