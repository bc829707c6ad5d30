"""Hand-written Hopper kernels with their plain PyTorch versions.

  attention.py : fused rel-pos attention, CUDA C++: ``csrc/attention_mma.cu``
                 (tensor cores; bfloat16, head dim 32/64/128, any L),
                 ``csrc/attention_f32_mma.cu`` (tensor cores as 3xTF32;
                 float32, head dim 32/64/128, any L) and ``csrc/attention.cu``
                 (f32 FMAs; head dim 16)
  dropout.py   : counter-hash inverted dropout, Triton (one seed, or under
                 torch.func.vmap one seed a lane)
  conv3x3.py   : SAME 3x3 conv, NHWC x HWIO, CUDA C++: ``csrc/conv3x3_mma.cu``
                 (tensor cores, ``wgmma``; bfloat16 at (C, Cout) in {64, 128}^2)
                 and ``csrc/conv3x3.cu`` (f32 FMAs; float32 at the same pairs)
  conv_s2d.py  : the same conv over the W-space-to-depth view: bfloat16 at
                 C = 64 on the tensor-core kernel, which multiplies only the
                 blocks of the expanded weight that exist (it walks the view's
                 64-channel chunks); anything else on the dense kernels at
                 twice the channels
  csrc/mma_common.cuh : cp.async / ldmatrix / mma primitives the tensor-core
                 sources include

Each wrapper launches its kernel on CUDA tensors (or raises) and uses the
plain version only for CPU tensors. ``launches`` counts kernel launches.
"""
from ._build import launches, reset_launches
from .attention import attention_plain, fused_attention
from .conv3x3 import conv3x3, conv3x3_plain
from .conv_s2d import conv3x3_s2d, conv3x3_s2d_plain, expand_weights_s2d2
from .dropout import dropout_plain, hash_dropout, hash_keep_mask

__all__ = ["launches", "reset_launches", "attention_plain", "fused_attention",
           "conv3x3", "conv3x3_plain", "conv3x3_s2d", "conv3x3_s2d_plain",
           "expand_weights_s2d2", "dropout_plain", "hash_dropout", "hash_keep_mask"]
