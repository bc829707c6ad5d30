"""Embedding decoder, ``('', 'fc')`` arm (port of
``sarssl_tpu/models/decoder.py:47-51``): a 2-layer MLP with 3x expansion
from each patch embedding back to ``dpatch * nreim * nmic`` values. The
sequence stages and the CNN head are not ported yet."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense


class EmbedDecoder(nn.Module):
    def __init__(self, sig_shape, patch_shape, dembed: int, model=("", "fc"),
                 dtype=torch.float32, generator=None):
        super().__init__()
        if tuple(model) != ("", "fc"):
            raise NotImplementedError(f"EmbedDecoder model {tuple(model)} is not ported yet")
        nf, nt, nreim, nmic = sig_shape
        dout = patch_shape[0] * patch_shape[1] * nreim * nmic
        self.proj0 = Dense(dembed, dout * 3, dtype=dtype, generator=generator)
        self.proj1 = Dense(dout * 3, dout, dtype=dtype, generator=generator)

    def forward(self, embed, train: bool = False):
        return self.proj1(F.relu(self.proj0(embed)))
