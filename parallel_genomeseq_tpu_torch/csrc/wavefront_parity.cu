// K26, the reference-parity forms of csrc/wavefront.cu's sw_warp_kernel
// (saturating uint8 values and the skewed tie-break; see that file's
// header), built as a translation unit of their own so that nvcc compiles
// their instantiations beside K1-K9's rather than after them.
#define PGS_WAVEFRONT_PARITY 1
#include "wavefront.cu"
