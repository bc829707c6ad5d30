"""Shared layers that reproduce flax.linen's semantics in PyTorch.

Parameters are float32; each layer computes in its ``dtype`` (bf16 compute
over f32 parameters, as the JAX package runs). Initialisers follow flax's
defaults (lecun-normal kernels, zero biases) unless a caller asks for
xavier-uniform, and draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.dropout import hash_dropout


def draw_seed(generator: torch.Generator) -> int:
    """One uint32 dropout seed from a CPU generator (no device sync)."""
    return int(torch.randint(0, 2 ** 32, (), dtype=torch.int64, generator=generator))


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    # flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; the kernel is
    stored as torch's ``(out, in)`` weight."""

    def __init__(self, din: int, dout: int, bias: bool = True, dtype=torch.float32,
                 xavier: bool = False, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dout, din))
        if xavier:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        else:
            lecun_normal_(self.weight, din, generator)
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 (torch's default is 1e-5), statistics
    in f32, output in dtype."""

    eps = 1e-6

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over channel dim 1.

    Training normalises with the biased batch variance and updates
    ``running = 0.9 * running + 0.1 * batch`` with the *biased* variance, as
    flax does (torch's BatchNorm keeps an unbiased running variance).
    Statistics are f32; the output is in ``dtype``.
    """

    momentum = 0.9  # flax's sense: the weight of the old running value
    eps = 1e-5

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, train: bool = False):
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            var, mean = torch.var_mean(x.detach().float(), dim=dims, correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.dtype)


class Dropout(nn.Module):
    """Inverted dropout with the counter-hash mask (``kernels/dropout.py``):
    the Triton kernel on CUDA tensors, the plain version on CPU tensors. One
    seed per call, drawn from the caller's generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, generator=None):
        if not train or self.rate == 0.0:
            return x
        return hash_dropout(x.contiguous(), draw_seed(generator), self.rate)
