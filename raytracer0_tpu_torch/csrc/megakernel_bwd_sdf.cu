// megakernel_bwd_sdf.cu — K2's whole-SDF copy (megakernel_bwd.cu), built
// as a library of its own so that nvcc compiles it beside the library of
// K2's Cornell and wide copies.  Its exports are megakernel_bwd.cu's; its
// launcher runs the whole-SDF copy alone (use_tex bit 2) and refuses the
// other scenes.

#define RT0_K2_WHOLE_SDF 1
#include "megakernel_bwd.cu"
