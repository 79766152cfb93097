// K2 (csrc/rows3_tail.cu): the HLG routes (c5 single rate's HLG -> SDR, HLG
// -> PQ) and c1's, in a translation unit of their own, so that the build
// compiles them in parallel with the others.

#include "rows3_tail.cuh"

template VRT_K2_LAUNCH(C5, int16_t, int16_t);
template VRT_K2_LAUNCH(HlgToPq, uint16_t, int16_t);
template VRT_K2_LAUNCH(C1, uint8_t, int16_t);
