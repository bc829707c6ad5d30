"""CRNN ablation encoders (port of ``sarssl_tpu/models/crnn.py``).

Frequency-strided residual conv blocks collapse the frequency axis, a
(bi)GRU models time and a Dense head projects each frame to the embedding.
Inputs and outputs keep the JAX modules' layouts (a TF map ``(nb, nf, nt,
nch)`` in, ``(nb, nt', out_dim)`` out); inside, the conv blocks run on the
NCHW view ``(nb, c, nf, nt)``. Convolutions, BatchNorm and the GRU are
cuDNN's on the card (``F.conv*``, ``torch.gru``), as the JAX modules run
``nn.Conv`` / ``nn.RNN(nn.GRUCell)`` outside any Pallas kernel.

flax's ``nn.GRUCell`` has no hidden bias on the reset and update gates, so
each cell keeps flax's six gate parameters (``ir``, ``iz``, ``in`` with a
bias; ``hr``, ``hz`` without; ``hn`` with) and hands ``torch.gru`` the
stacked weights with zeros in the hidden biases of r and z: the gradients
reach only the parameters flax has.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm, Conv, Dense


class CnnBlock(nn.Module):
    """conv3x3(stride (f_stride, 1)) -> BN -> ReLU -> conv3x3 -> BN
    [+ residual, through a strided 1x1 conv + BN where the shape changes]
    -> ReLU, over NCHW. flax names: ``conv1``, ``bn1``, ``conv2``, ``bn2``,
    ``down_conv``, ``down_bn``."""

    def __init__(self, cin: int, planes: int, f_stride: int = 1, use_res: bool = True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        stride = (f_stride, 1)
        self.use_res = use_res
        self.conv1 = Conv(cin, planes, (3, 3), stride, dtype=dtype, generator=generator)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, (3, 3), dtype=dtype, generator=generator)
        self.bn2 = BatchNorm(planes, dtype)
        self.down = use_res and (cin != planes or f_stride != 1)
        if self.down:
            self.down_conv = Conv(cin, planes, (1, 1), stride, dtype=dtype, generator=generator)
            self.down_bn = BatchNorm(planes, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.use_res:
            y = y + (self.down_bn(self.down_conv(x), train) if self.down else x)
        return F.relu(y)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``'s parameters (``in`` is a Python keyword, so the
    port names it ``in_``): input kernels lecun-normal, recurrent kernels
    orthogonal, biases zero."""

    def __init__(self, din: int, hidden: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.hidden = hidden
        self.ir, self.iz, self.in_ = (Dense(din, hidden, dtype=dtype, generator=generator)
                                      for _ in range(3))
        self.hr, self.hz = (Dense(hidden, hidden, bias=False, dtype=dtype, generator=generator)
                            for _ in range(2))
        self.hn = Dense(hidden, hidden, dtype=dtype, generator=generator)
        for d in (self.hr, self.hz, self.hn):
            nn.init.orthogonal_(d.weight.data, generator=generator)

    def gru_weights(self):
        """``torch.gru``'s ``[w_ih, w_hh, b_ih, b_hh]`` in its (r, z, n) order."""
        zeros = torch.zeros(2 * self.hidden, dtype=self.hn.bias.dtype, device=self.hn.bias.device)
        return [torch.cat([self.ir.weight, self.iz.weight, self.in_.weight]),
                torch.cat([self.hr.weight, self.hz.weight, self.hn.weight]),
                torch.cat([self.ir.bias, self.iz.bias, self.in_.bias]),
                torch.cat([zeros, self.hn.bias])]


class BiGRU(nn.Module):
    """``(nb, nt, din)`` -> ``(nb, nt, ndir * hidden)`` from a zero carry, the
    backward direction's outputs aligned with the input's frames (flax's
    ``reverse=True, keep_order=True``). flax names: ``GRUCell_0`` ->
    ``fwd``, ``GRUCell_1`` -> ``bwd``."""

    def __init__(self, din: int, hidden: int, bidirectional: bool = True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype, self.bidirectional = dtype, bidirectional
        self.fwd = GRUCell(din, hidden, dtype, generator)
        if bidirectional:
            self.bwd = GRUCell(din, hidden, dtype, generator)

    def forward(self, x):
        cells = (self.fwd, self.bwd) if self.bidirectional else (self.fwd,)
        weights = [w.to(self.dtype) for c in cells for w in c.gru_weights()]
        h0 = x.new_zeros(len(cells), x.shape[0], self.fwd.hidden, dtype=self.dtype)
        out, _ = torch.gru(x.to(self.dtype).contiguous(), h0, weights, True, 1, 0.0,
                           torch.is_grad_enabled(), self.bidirectional, True)
        return out


def _strided(n: int, strides: Sequence[int]) -> int:
    for s in strides:  # 'SAME' with a stride: ceil(n / s) rows
        n = -(-n // s)
    return n


def _frames_to_features(y):
    """NCHW ``(nb, c, nf', nt)`` -> ``(nb, nt, nf' * c)``, frequency-major
    then channel, as the JAX modules flatten NHWC."""
    nb, c, nf, nt = y.shape
    return y.permute(0, 3, 2, 1).reshape(nb, nt, nf * c)


class CRNN(nn.Module):
    """The reference's ``crnn``: strided residual CNN over (nf, nt), the
    frequency axis flattened into the features, a (bi)GRU over time, a Dense
    to ``out_dim``. ``(nb, nf, nt, nch)`` -> ``(nb, nt, out_dim)``. flax
    names: ``pre``, ``block<i>a``, ``block<i>b``, ``rnn``, ``fc``."""

    def __init__(self, nch: int, nf: int = 256, planes: Sequence[int] = (64, 64, 128, 256, 512),
                 f_stride: Sequence[int] = (1, 1, 4, 4, 4), res_flag: bool = True,
                 out_dim: int = 256, bidirectional: bool = True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.nblocks = len(f_stride)
        self.pre = CnnBlock(nch, planes[0], f_stride[0], res_flag, **kw)
        for i in range(1, self.nblocks):
            setattr(self, f"block{i}a", CnnBlock(planes[i - 1], planes[i], f_stride[i],
                                                 res_flag, **kw))
            setattr(self, f"block{i}b", CnnBlock(planes[i], planes[i], 1, res_flag, **kw))
        din = _strided(nf, f_stride) * planes[-1]
        ndir = 2 if bidirectional else 1
        self.rnn = BiGRU(din, din // ndir, bidirectional, **kw)
        self.fc = Dense(ndir * (din // ndir), out_dim, **kw)

    def forward(self, x, train: bool = False):
        y = self.pre(x.permute(0, 3, 1, 2), train)
        for i in range(1, self.nblocks):
            y = getattr(self, f"block{i}a")(y, train)
            y = getattr(self, f"block{i}b")(y, train)
        return self.fc(self.rnn(_frames_to_features(y)))


class CRNNSim(nn.Module):
    """The reference's ``crnn_sim``: ``nlayers`` residual blocks of
    ``conv_chs`` channels (frequency stride 1, then 2), a Dense to
    ``rnn_hid``, a (bi)GRU, a Dense to ``out_dim``. flax names: ``block<i>``
    -> ``blocks.<i>``, ``proj``, ``rnn``, ``fc``."""

    def __init__(self, nch: int, nf: int = 256, conv_chs: int = 64, nlayers: int = 3,
                 rnn_hid: int = 256, out_dim: int = 256, bidirectional: bool = True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        strides = [2 if i else 1 for i in range(nlayers)]
        self.blocks = nn.ModuleList(CnnBlock(conv_chs if i else nch, conv_chs, s, True, **kw)
                                    for i, s in enumerate(strides))
        self.proj = Dense(_strided(nf, strides) * conv_chs, rnn_hid, **kw)
        ndir = 2 if bidirectional else 1
        self.rnn = BiGRU(rnn_hid, rnn_hid // ndir, bidirectional, **kw)
        self.fc = Dense(ndir * (rnn_hid // ndir), out_dim, **kw)

    def forward(self, x, train: bool = False):
        y = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            y = block(y, train)
        return self.fc(self.rnn(self.proj(_frames_to_features(y))))


class TCRNN(nn.Module):
    """The reference's ``tcrnn``: 1-D time-conv residual blocks over the
    flattened ``nf * nch`` features, a (bi)GRU, a Dense to ``out_dim``. flax
    names: ``conv<i>a``, ``bn<i>a``, ``conv<i>b``, ``bn<i>b``, ``down<i>``
    (where the width changes), ``rnn``, ``fc``."""

    def __init__(self, nch: int, nf: int = 256, planes: Sequence[int] = (256, 256, 128),
                 out_dim: int = 256, bidirectional: bool = True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.planes = tuple(planes)
        width = nf * nch
        for i, p in enumerate(planes):
            setattr(self, f"conv{i}a", Conv(width, p, (3,), **kw))
            setattr(self, f"bn{i}a", BatchNorm(p, dtype))
            setattr(self, f"conv{i}b", Conv(p, p, (3,), **kw))
            setattr(self, f"bn{i}b", BatchNorm(p, dtype))
            if width != p:
                setattr(self, f"down{i}", Dense(width, p, bias=False, **kw))
            width = p
        ndir = 2 if bidirectional else 1
        self.rnn = BiGRU(width, width // ndir, bidirectional, **kw)
        self.fc = Dense(ndir * (width // ndir), out_dim, **kw)

    def forward(self, x, train: bool = False):
        nb, nf, nt, nch = x.shape
        y = x.transpose(1, 2).reshape(nb, nt, nf * nch)  # (nb, nt, nf * nch)
        for i in range(len(self.planes)):
            z = F.relu(getattr(self, f"bn{i}a")(getattr(self, f"conv{i}a")(y.transpose(1, 2)),
                                                train))
            z = getattr(self, f"bn{i}b")(getattr(self, f"conv{i}b")(z), train).transpose(1, 2)
            if hasattr(self, f"down{i}"):
                y = getattr(self, f"down{i}")(y)
            y = F.relu(z + y)
        return self.fc(self.rnn(y))


class CausCnnBlock(nn.Module):
    """Time-causal conv block: each 3x3 conv pads frequency (1, 1) and time
    (2, 0), so frame t sees frames <= t only; BN + ReLU after each conv
    [+ identity residual]. flax names: ``conv1``, ``bn1``, ``conv2``,
    ``bn2``."""

    PADDING = ((1, 1), (2, 0))

    def __init__(self, cin: int, planes: int, use_res: bool = False, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.use_res = use_res
        self.conv1 = Conv(cin, planes, (3, 3), padding=self.PADDING, dtype=dtype,
                          generator=generator)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, (3, 3), padding=self.PADDING, dtype=dtype,
                          generator=generator)
        self.bn2 = BatchNorm(planes, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.use_res:
            y = y + x
        return F.relu(y)


class CauCRNN(nn.Module):
    """The reference's ``CauCRNN``, the DP-RTF / DOA ablation encoder: causal
    conv blocks each followed by a (frequency, time) max-pool, a
    unidirectional GRU over the channel-major flattened features, a Dense and
    ``tanh * max_num_sources``. ``(nb, nf, nt, nch)`` -> ``(nb, nt', out_dim)``.
    flax names: ``block<i>`` -> ``blocks.<i>``, ``rnn``, ``fc``."""

    def __init__(self, nch: int = 4, nf: int = 256, conv_chs: int = 64, rnn_hid: int = 256,
                 out_dim: int = 512, max_num_sources: int = 2,
                 pools: Sequence[Tuple[int, int]] = ((4, 1), (2, 1), (2, 2), (2, 2), (2, 3)),
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.pools, self.max_num_sources = tuple(map(tuple, pools)), max_num_sources
        self.blocks = nn.ModuleList(CausCnnBlock(conv_chs if i else nch, conv_chs, **kw)
                                    for i in range(len(pools)))
        for pf, _ in self.pools:
            nf //= pf
        self.rnn = BiGRU(conv_chs * nf, rnn_hid, bidirectional=False, **kw)
        self.fc = Dense(rnn_hid, out_dim, **kw)

    def forward(self, x, train: bool = False):
        y = x.permute(0, 3, 1, 2)
        for block, pool in zip(self.blocks, self.pools):
            y = F.max_pool2d(block(y, train), pool, pool)
        nb, c, nf, nt = y.shape
        y = y.permute(0, 3, 1, 2).reshape(nb, nt, c * nf)  # channel-major, as JAX
        return torch.tanh(self.fc(self.rnn(y))) * self.max_num_sources
