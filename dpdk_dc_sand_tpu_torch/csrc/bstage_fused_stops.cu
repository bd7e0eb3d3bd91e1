// K2's stage stops (phase 6 of chip_smoke.py times them), built in an nvcc
// process of their own: this file takes K2's ring body from
// csrc/bstage_fused.cu (whose head describes the stops) and instantiates
// only its stop variants, so the library's build time stays that of its
// slowest source.

#define K2_STAGE_STOPS
#include "bstage_fused.cu"
