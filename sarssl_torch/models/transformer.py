"""Pre-LN Transformer encoder (port of ``sarssl_tpu/models/transformer.py``).

Sinusoidal absolute positions with sqrt(d_model) input scaling, pre-norm
residual attention and feed-forward layers, a closing LayerNorm. The
attention is flax's ``nn.MultiHeadDotProductAttention`` as flax 0.12 computes
it, in the compute dtype throughout: the query divided by sqrt(head_dim)
(not by sqrt(d_model) as the conformer's), the softmax in the compute dtype,
and attention-weight dropout broadcast over batch and heads, one ``(L, L)``
mask a call, here the counter-hash mask of ``kernels/dropout.py``. The JAX
package computes this outside any Pallas kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.dropout import hash_dropout
from .common import Dense, Dropout, LayerNorm, draw_seed, lecun_normal_
from .conformer import sinusoid_position_encoding


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` as MHA uses it, in flax's layout: the query,
    key and value projections ``(d, h, hd)`` with bias ``(h, hd)``
    (``heads_out=True``), the output projection ``(h, hd, d)`` with bias
    ``(d,)``. lecun-normal over the flattened fan-in, zero bias."""

    def __init__(self, d_model: int, num_heads: int, heads_out: bool, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype, self.heads_out = dtype, heads_out
        hd = d_model // num_heads
        flat = torch.empty(d_model, d_model)
        lecun_normal_(flat, d_model, generator)
        self.weight = nn.Parameter(flat.reshape((d_model, num_heads, hd) if heads_out
                                                else (num_heads, hd, d_model)))
        self.bias = nn.Parameter(torch.zeros((num_heads, hd) if heads_out else (d_model,)))

    def forward(self, x):
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.heads_out:  # (..., d) -> (..., h, hd)
            y = F.linear(x.to(self.dtype), w.flatten(1).t(), b.flatten())
            return y.unflatten(-1, w.shape[1:])
        return F.linear(x.to(self.dtype).flatten(-2), w.flatten(0, 1).t(), b)


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention of flax's ``MultiHeadDotProductAttention`` (flax name
    ``MultiHeadDotProductAttention_0``; ``query``, ``key``, ``value``,
    ``out``)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads, self.rate, self.dtype = num_heads, dropout, dtype
        proj = lambda heads_out: DenseGeneral(d_model, num_heads, heads_out, dtype, generator)
        self.query, self.key, self.value = proj(True), proj(True), proj(True)
        self.out = proj(False)

    def forward(self, x, train: bool = False, generator=None):
        dt = self.dtype
        q, k, v = self.query(x), self.key(x), self.value(x)  # (b, l, h, hd)
        depth = q.shape[-1]
        q = q / torch.tensor(math.sqrt(depth), dtype=dt)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if train and self.rate > 0.0:
            nseq = x.shape[1]
            keep = hash_dropout(torch.ones((nseq, nseq), dtype=dt, device=x.device),
                                draw_seed(generator), self.rate)
            w = w * keep
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class EncoderLayer(nn.Module):
    """LN -> MHA -> dropout -> residual; LN -> Dense(d_ff) -> ReLU -> dropout
    -> Dense(d) -> dropout -> residual. flax names: ``LayerNorm_0`` -> ``ln``,
    ``MultiHeadDotProductAttention_0`` -> ``mha``, ``LayerNorm_1`` -> ``ln1``,
    ``Dense_0`` -> ``dense0``, ``Dense_1`` -> ``dense1``."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, dropout: float = 0.1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.ln = LayerNorm(d_model, dtype)
        self.mha = MultiHeadDotProductAttention(d_model, num_heads, dropout, dtype, generator)
        self.ln1 = LayerNorm(d_model, dtype)
        self.dense0 = Dense(d_model, d_ff, dtype=dtype, generator=generator)
        self.dense1 = Dense(d_ff, d_model, dtype=dtype, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x, train: bool = False, generator=None):
        x = x + self.drop(self.mha(self.ln(x), train, generator), train, generator)
        y = self.drop(F.relu(self.dense0(self.ln1(x))), train, generator)
        return x + self.drop(self.dense1(y), train, generator)


class TransformerEncoder(nn.Module):
    """``x * sqrt(d) + PE`` -> dropout -> N layers (each optionally followed
    by adding its sequence mean, ``add_same_one``) -> LayerNorm. flax names:
    ``layer<i>`` -> ``layers.<i>``, the closing ``LayerNorm_0`` -> ``ln``."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int = 4, d_ff: int = 0,
                 dropout: float = 0.1, add_same_one: bool = False, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.d_model, self.dtype, self.add_same_one = d_model, dtype, add_same_one
        d_ff = d_ff or 4 * d_model
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, d_ff, num_heads, dropout, dtype, generator)
            for _ in range(num_layers))
        self.ln = LayerNorm(d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, train: bool = False, generator=None):
        pe = sinusoid_position_encoding(x.shape[1], self.d_model, self.dtype, x.device)
        x = self.drop(x.to(self.dtype) * math.sqrt(self.d_model) + pe, train, generator)
        for layer in self.layers:
            x = layer(x, train, generator)
            if self.add_same_one:
                x = x + x.mean(dim=1, keepdim=True)
        return self.ln(x)
