// The f32 attention kernels of attention_f32_mma.cu in their instances that
// take partial sums over L (mma_acc_rows' PSUM): a library of its own, so that
// the two halves compile in parallel, which kernels/attention.py takes past
// L = 1024 (F32_PSUM_MIN_L). The same C entries as attention_f32_mma.cu.
//
// Replaces, past that length, the Pallas TPU kernels that file names
// (sarssl_tpu/kernels/attention.py::_call_fwd and _fa_bwd).
#define ATTN_F32_PSUM 1
#include "attention_f32_mma.cu"
