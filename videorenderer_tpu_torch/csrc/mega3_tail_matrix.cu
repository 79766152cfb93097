// K4 (csrc/mega3_tail.cu): the colour matrix only (planar float, no
// quantization) on the raw P010 planes, in a translation unit of its own, so
// that the build compiles it in parallel with the others.

#include "mega3_tail.cuh"

template VRT_K4_LAUNCH(MatrixFloat, uint16_t, uint16_t);
