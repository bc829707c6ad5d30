"""Hand-written Hopper kernels with their plain PyTorch versions.

  attention.py : fused rel-pos attention, CUDA C++: ``csrc/attention_mma.cu``
                 (tensor cores; bfloat16) and ``csrc/attention_f32_mma.cu``
                 (tensor cores as 3xTF32; float32), head dim 16/32/64/128
                 (the bf16 forward also 256) and a wide instance at every
                 multiple of 64 from 256 on, any L, any B and H; every other
                 head dim on zero-padded inputs; ``csrc/attention.cu`` (f32
                 FMAs) only launched directly, as the yardstick
  dropout.py   : counter-hash inverted dropout, Triton (one seed, or under
                 torch.func.vmap one seed a lane), up to 2^32 - 1 elements
  conv3x3.py   : SAME 3x3 conv, NHWC x HWIO, CUDA C++: ``csrc/conv3x3_mma.cu``
                 (tensor cores, ``wgmma``; bfloat16 at (C, Cout) in {64, 128}^2),
                 ``csrc/conv3x3_any_mma.cu`` (tensor cores; bfloat16 at every
                 other (C, Cout), and at any pair where the images are smaller
                 than a row tile in tiles of several whole images,
                 ``csrc/conv3x3_any_mma_groups.cu``) and ``csrc/conv3x3.cu``
                 (f32 FMAs; float32, with the channel counts at run time
                 outside {64, 128}^2); any N
  conv_s2d.py  : the same conv over the W-space-to-depth view, which is the
                 conv of x itself: conv3x3's kernels on x's C channels, so no
                 zero block of the expanded weight is multiplied
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
