// The image-group kernels of conv3x3_any_mma.cu (a tile of G whole images,
// where the images are smaller than a row tile): a library of its own, so that
// the two halves compile in parallel, which kernels/conv3x3.py takes where
// conv_tiling names groups. The same C entries as conv3x3_any_mma.cu.
//
// Replaces, at those shapes, the Pallas TPU kernels that file names
// (sarssl_tpu/kernels/conv3x3.py::_pallas_conv3x3 and conv_s2d.py::_conv_s2d).
#define CONV_ANY_MMA_GROUPS 1
#include "conv3x3_any_mma.cu"
