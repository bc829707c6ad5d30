"""Conformer encoder (port of ``sarssl_tpu/models/conformer.py``).

Macaron half-step feed-forwards, Transformer-XL relative multi-head
self-attention with learned u/v biases, a GLU + depthwise-conv module with
BatchNorm, and a closing LayerNorm per block. Activations are
``(batch, seq, dim)``. ``remat`` recomputes each block's activations in the
backward (``common.remat``); ``add_same_one`` adds each block's mean over the
sequence back to its output.

Tensor-parallel (``parallel/steps.py`` sets ``tp``): a rank of ``M`` holds
``num_heads / M`` heads of the attention (its column shards of ``query``,
``key``, ``value``, ``pos``, its rows of ``u_bias`` / ``v_bias``, and a
row shard of ``out``) and ``4d / M`` units of each feed-forward (a column
shard of ``dense0``, a row shard of ``dense1``); the mask of each dropout
over a shard is that shard's slice of the unsharded mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.attention import fused_attention
from ..parallel import tp
from .common import (BatchNorm, Dense, Dropout, LayerNorm, data_seed, draw_seed, lecun_normal_,
                     remat)


def sinusoid_position_encoding(length: int, d_model: int, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """PE(pos, 2i) = sin(pos/10000^(2i/d)), PE(pos, 2i+1) = cos(...), pos 0..L-1."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    ang = pos * div[None, :]
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


def _relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
    """Transformer-XL left shift: pad a zero column, fold, drop the first row."""
    b, h, l1, l2 = pos_score.shape
    padded = F.pad(pos_score, (1, 0)).reshape(b, h, l2 + 1, l1)
    return padded[:, :, 1:].reshape(b, h, l1, l2)


class RelPosSelfAttention(nn.Module):
    """Relative multi-head self-attention (conformer.py:52-121).

    ``fused=True`` runs ``kernels.attention.fused_attention``: the CUDA
    kernels on the card, its plain version on the CPU. ``fused=False`` runs
    the unfused path of conformer.py:110-119 (f32 scores, softmax, dropout
    module, PV)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 fused: bool = False, dtype=torch.float32, generator=None):
        super().__init__()
        self.d_model, self.num_heads, self.rate = d_model, num_heads, dropout
        self.fused, self.dtype = fused, dtype
        dense = lambda bias=True: Dense(d_model, d_model, bias, dtype, xavier=True,
                                        generator=generator)
        self.query, self.key, self.value = dense(), dense(), dense()
        self.pos = dense(bias=False)
        self.out = dense()
        dh = d_model // num_heads
        self.u_bias = nn.Parameter(nn.init.xavier_uniform_(torch.empty(num_heads, dh),
                                                           generator=generator))
        self.v_bias = nn.Parameter(nn.init.xavier_uniform_(torch.empty(num_heads, dh),
                                                           generator=generator))
        self.drop = Dropout(dropout)
        self.tp = None  # tensor-parallel: (model group, rank in it, its size)

    def tensor_parallel(self, group, index: int, size: int):
        """Run rank ``index`` of ``size``'s heads (``parallel/steps.py``);
        returns the replicated leaves it uses only in part."""
        if self.num_heads % size:
            raise ValueError(f"{self.num_heads} heads do not split over {size} model ranks")
        self.tp = (group, index, size)
        return ["u_bias", "v_bias"]

    def forward(self, x, train: bool = False, generator=None):
        nb, nseq, _ = x.shape
        nh, dt = self.num_heads, self.dtype
        dh = self.d_model // nh
        h0 = 0
        if self.tp is not None:
            group, index, size = self.tp
            nh = self.num_heads // size
            h0 = index * nh
            x = tp.copy_to(x, group)
        q = self.query(x).reshape(nb, nseq, nh, dh)
        k = self.key(x).reshape(nb, nseq, nh, dh)
        v = self.value(x).reshape(nb, nseq, nh, dh)
        pe = sinusoid_position_encoding(nseq, self.d_model, dt, x.device)
        p = self.pos(pe).reshape(nseq, nh, dh)
        u_bias, v_bias = self.u_bias[h0:h0 + nh], self.v_bias[h0:h0 + nh]
        # the reference scales by sqrt(d_model), not sqrt(d_head)
        scale = 1.0 / math.sqrt(self.d_model)
        qv = q + v_bias.to(dt)
        drop_active = train and self.rate > 0.0
        if self.fused:
            # (q+v) P^T at compute dtype, then the relative shift (pure data
            # movement, so casting first is bitwise the same)
            pos = _relative_shift(torch.einsum("bihd,jhd->bhij", qv, p)).contiguous()
            qu = (q + u_bias.to(dt)).transpose(1, 2).contiguous()
            seed = (data_seed(draw_seed(generator), self.drop.data_shard,
                              nb * self.num_heads * nseq * nseq) if drop_active else 0)
            ctx = fused_attention(qu, k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), pos, seed, scale,
                                  self.rate if drop_active else 0.0, self.num_heads, h0)
            ctx = ctx.transpose(1, 2)
        else:
            pos = _relative_shift(torch.einsum("bihd,jhd->bhij", qv.float(), p.float()))
            content = torch.einsum("bihd,bjhd->bhij", (q + u_bias.to(dt)).float(), k.float())
            attn = torch.softmax((content + pos) * scale, dim=-1).to(dt)
            ll = nseq * nseq
            attn = self.drop(attn, train, generator,
                             None if self.tp is None else (nh * ll, self.num_heads * ll, h0 * ll))
            ctx = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
        return self.out(ctx.to(dt).reshape(nb, nseq, nh * dh))


class FeedForwardModule(nn.Module):
    """LN -> Dense(4d) -> swish -> dropout -> Dense(d) -> dropout."""

    def __init__(self, dim: int, expansion: int = 4, dropout: float = 0.1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.ln = LayerNorm(dim, dtype)
        self.dense0 = Dense(dim, dim * expansion, dtype=dtype, xavier=True,
                            generator=generator)
        self.dense1 = Dense(dim * expansion, dim, dtype=dtype, xavier=True,
                            generator=generator)
        self.drop = Dropout(dropout)
        # tensor-parallel: the model group, and the hidden units' index map
        self.tp_group, self.hidden_map = None, None

    def tensor_parallel(self, group, index: int, size: int):
        """Run rank ``index`` of ``size``'s hidden units (``parallel/steps.py``)."""
        hidden = self.dense0.weight.shape[0]
        self.tp_group, self.hidden_map = group, (hidden // size, hidden, index * hidden // size)
        return []

    def forward(self, x, train: bool = False, generator=None):
        y = self.ln(x)
        if self.tp_group is not None:
            y = tp.copy_to(y, self.tp_group)
        y = F.silu(self.dense0(y))
        y = self.dense1(self.drop(y, train, generator, self.hidden_map))
        return self.drop(y, train, generator)


class ConvModule(nn.Module):
    """LN -> pointwise(2d) -> GLU -> depthwise(k) -> BN -> swish -> pointwise
    -> dropout. GLU is ``a * sigmoid(b)`` with ``a`` the first half."""

    def __init__(self, dim: int, kernel_size: int = 31, dropout: float = 0.1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.ln = LayerNorm(dim, dtype)
        self.dense0 = Dense(dim, 2 * dim, dtype=dtype, generator=generator)
        # depthwise 'SAME' conv, weight (ch, 1, k); flax's fan_in is k
        self.dwconv = nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2,
                                groups=dim, bias=False)
        lecun_normal_(self.dwconv.weight.data, kernel_size, generator)
        self.bn = BatchNorm(dim, dtype)
        self.dense1 = Dense(dim, dim, dtype=dtype, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x, train: bool = False, generator=None):
        a, b = self.dense0(self.ln(x)).chunk(2, dim=-1)
        y = (a * torch.sigmoid(b)).transpose(1, 2)  # (nb, dim, seq)
        c = self.dwconv
        y = F.conv1d(y, c.weight.to(self.dtype), padding=c.padding, groups=c.groups)
        y = F.silu(self.bn(y, train)).transpose(1, 2)
        return self.drop(self.dense1(y), train, generator)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, ff_expansion: int = 4,
                 conv_kernel_size: int = 31, dropout: float = 0.1,
                 fused_attention: bool = False, dtype=torch.float32, generator=None):
        super().__init__()
        self.ff1 = FeedForwardModule(dim, ff_expansion, dropout, dtype, generator)
        self.mhsa_ln = LayerNorm(dim, dtype)
        self.mhsa = RelPosSelfAttention(dim, num_heads, dropout, fused_attention, dtype,
                                        generator)
        self.drop = Dropout(dropout)
        self.conv = ConvModule(dim, conv_kernel_size, dropout, dtype, generator)
        self.ff2 = FeedForwardModule(dim, ff_expansion, dropout, dtype, generator)
        self.final_ln = LayerNorm(dim, dtype)

    def forward(self, x, train: bool = False, generator=None):
        x = x + 0.5 * self.ff1(x, train, generator)
        attn = self.mhsa(self.mhsa_ln(x), train, generator)
        x = x + self.drop(attn, train, generator)
        x = x + self.conv(x, train, generator)
        x = x + 0.5 * self.ff2(x, train, generator)
        return self.final_ln(x)


class ConformerEncoder(nn.Module):
    """N conformer blocks; ``add_same_one`` adds the sequence mean after each
    (Conformer.py:190-193); ``remat`` recomputes each block in the backward."""

    def __init__(self, dim: int, num_layers: int, num_heads: int = 4,
                 ff_expansion: int = 4, conv_kernel_size: int = 31, dropout: float = 0.1,
                 fused_attention: bool = False, dtype=torch.float32, generator=None,
                 add_same_one: bool = False, remat: bool = False):
        super().__init__()
        self.add_same_one, self.remat = add_same_one, remat
        self.blocks = nn.ModuleList(
            ConformerBlock(dim, num_heads, ff_expansion, conv_kernel_size, dropout,
                           fused_attention, dtype, generator)
            for _ in range(num_layers))

    def forward(self, x, train: bool = False, generator=None):
        for block in self.blocks:
            if self.remat:
                x = remat(block, lambda y, gen, b=block: b(y, train, gen), x, generator)
            else:
                x = block(x, train, generator)
            if self.add_same_one:
                x = x + x.mean(dim=1, keepdim=True)
        return x
