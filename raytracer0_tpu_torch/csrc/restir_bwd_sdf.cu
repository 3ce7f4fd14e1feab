// restir_bwd_sdf.cu — K7's whole-SDF copy (restir_bwd.cu), built as a
// library of its own so that nvcc compiles it beside the library of K7's
// ROUND_BOX copy.  Its exports are restir_bwd.cu's; its launcher runs the
// whole-SDF copy.

#define RT0_K7_WHOLE_SDF 1
#include "restir_bwd.cu"
