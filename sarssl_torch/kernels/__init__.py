"""Hand-written Hopper kernels with their plain PyTorch versions.

  attention.py : fused rel-pos attention, CUDA C++ (``csrc/attention.cu``)
  dropout.py   : counter-hash inverted dropout, Triton

Each wrapper launches its kernel on CUDA tensors (or raises) and uses the
plain version only for CPU tensors. ``launches`` counts kernel launches.
"""
from ._build import launches, reset_launches
from .attention import attention_plain, fused_attention
from .dropout import dropout_plain, hash_dropout, hash_keep_mask

__all__ = ["launches", "reset_launches", "attention_plain", "fused_attention",
           "dropout_plain", "hash_dropout", "hash_keep_mask"]
