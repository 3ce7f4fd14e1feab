// megakernel_bwd_medium.cu — K2's medium copy (megakernel_bwd.cu): the
// adjoint of K1's medium copy (hero-wavelength spectral transport and the
// homogeneous medium over K1's whole class), built as a library of its own
// so that nvcc compiles it beside the libraries of K2's other copies and
// they keep their code.  Its exports are megakernel_bwd.cu's; its launcher
// takes K1's medium arguments after `threads` and runs the medium copy
// alone.

#define RT0_K2_MEDIUM 1
#include "megakernel_bwd.cu"
