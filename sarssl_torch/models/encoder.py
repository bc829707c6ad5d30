"""Per-patch embedding encoder (port of ``sarssl_tpu/models/encoder.py``).

``CNNFrontEnd`` (encoder.py:23-51) and the ``cnn``/``conformer`` arm of
``EmbedEncoder`` (:110-144). The convolutions are cuDNN calls
(``F.conv2d``), as the JAX package runs them outside any Pallas kernel.
Public tensors keep the JAX package's NHWC layout; inside, the NCHW view of
an NHWC tensor is channels-last, which cuDNN takes as it is. The ``fc`` and
``cnn_f_first`` front ends, the CLS token, the transformer and the CRNN
variants are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.patches import patch_recover
from .common import BatchNorm, lecun_normal_
from .conformer import ConformerEncoder


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` without bias: 'SAME' padding for odd kernels, or
    'VALID' with a stride; lecun-normal init; computes in ``dtype``."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, dtype=torch.float32,
                 generator=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.dtype = dtype
        kh, kw = self.kernel_size
        lecun_normal_(self.weight.data, kh * kw * cin, generator)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride,
                        self.padding)


class CNNFrontEnd(nn.Module):
    """1x1 -> 3x3 -> 3x3 -> 1x1 (BN + ReLU each) -> patch-strided projection.

    Input ``(nb, nf, nt, nch)``, output ``(nb, nf/pf, nt/pt, dembed)``."""

    def __init__(self, nch: int, dembed: int, patch_shape, conv_chs: int = 64,
                 dtype=torch.float32, generator=None):
        super().__init__()
        conv = lambda cin, cout, k: Conv2d(cin, cout, k, padding=k // 2, dtype=dtype,
                                           generator=generator)
        self.conv0, self.bn0 = conv(nch, conv_chs, 1), BatchNorm(conv_chs, dtype)
        self.conv1, self.bn1 = conv(conv_chs, conv_chs, 3), BatchNorm(conv_chs, dtype)
        self.conv2, self.bn2 = conv(conv_chs, conv_chs, 3), BatchNorm(conv_chs, dtype)
        self.conv3, self.bn3 = conv(conv_chs, nch, 1), BatchNorm(nch, dtype)
        self.proj = Conv2d(nch, dembed, tuple(patch_shape), stride=tuple(patch_shape),
                           dtype=dtype, generator=generator)

    def forward(self, x, train: bool = False):
        y = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1),
                         (self.conv2, self.bn2), (self.conv3, self.bn3)):
            y = F.relu(bn(conv(y), train))
        return self.proj(y).permute(0, 2, 3, 1)


class EmbedEncoder(nn.Module):
    """CNN front end over the patch-recovered TF map, then a conformer over
    the patch sequence. ``embed (nb, npatch, dpatch*nreim*nmic)`` ->
    ``(nb, npatch, dembed)``."""

    def __init__(self, sig_shape, patch_shape, dembed: int, model=("cnn", "conformer"),
                 mode: str = "spat", num_layers: int = 0, dropout: float = 0.1,
                 fused_attention: bool = False, dtype=torch.float32, generator=None):
        super().__init__()
        if tuple(model) != ("cnn", "conformer"):
            raise NotImplementedError(f"EmbedEncoder model {tuple(model)} is not ported yet")
        self.sig_shape, self.patch_shape, self.dembed = tuple(sig_shape), tuple(patch_shape), dembed
        nf, nt, nreim, nmic = sig_shape
        nlayers = num_layers or (1 if mode == "spec" else 3)
        self.front = CNNFrontEnd(nreim * nmic, dembed, patch_shape, dtype=dtype,
                                 generator=generator)
        # flax name: "global"
        self.seq = ConformerEncoder(dembed, nlayers, num_heads=4, ff_expansion=4,
                                    dropout=dropout, fused_attention=fused_attention,
                                    dtype=dtype, generator=generator)

    def forward(self, embed, train: bool = False, generator=None):
        nf, nt, nreim, nmic = self.sig_shape
        pf, pt = self.patch_shape
        nb, npatch, _ = embed.shape
        v = embed.reshape(nb, npatch, pf * pt, nreim * nmic)
        tf = patch_recover(v, (nf, nt), self.patch_shape)  # (nb, nf, nt, nch)
        x = self.front(tf, train).reshape(nb, npatch, self.dembed)
        return self.seq(x, train, generator)
