"""Embedding decoder (port of ``sarssl_tpu/models/decoder.py``): an optional
sequence stage over the patch embeddings (``conformer`` or ``transformer``,
one layer, four heads, unfused attention as in the JAX package; flax's
``seq``, here ``stage``), then a head back to ``dpatch * nreim * nmic``
values a patch:

  * ``fc``: a 2-layer MLP with 3x expansion (``proj0``, ``proj1``; under
    tensor parallelism, ``tp_group``, a column shard of ``proj0`` and a row
    shard of ``proj1``);
  * ``cnn`` (decoder.py:50-82): each embedding spread over its patch of the
    TF canvas (``dembed / dpatch`` channels; the transposed ``(nt, nf)``
    canvas for f-first patches, as the encoder's), the front end's conv stack
    down to ``nreim * nmic`` channels, and a patch-strided projection to the
    values (``conv0``..``conv3``, ``bn0``..``bn3``, ``proj``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.patches import patch_recover
from ..parallel import tp
from .common import Dense
from .conformer import ConformerEncoder
from .encoder import add_conv_stack, run_conv_stack
from .transformer import TransformerEncoder

STAGES = ("", "conformer", "transformer")
HEADS = ("fc", "cnn")


class EmbedDecoder(nn.Module):
    def __init__(self, sig_shape, patch_shape, dembed: int, model=("", "fc"),
                 dropout: float = 0.1, dtype=torch.float32, generator=None):
        super().__init__()
        stage, head = model
        if stage not in STAGES:
            raise ValueError(f"Unsupported decoder stage: {stage}")
        if head not in HEADS:
            raise ValueError(f"Unsupported decoder head: {head}")
        self.sig_shape, self.patch_shape, self.dembed = tuple(sig_shape), tuple(patch_shape), dembed
        self.head = head
        self.tp_group = None
        nf, nt, nreim, nmic = sig_shape
        pf, pt = patch_shape
        dout = pf * pt * nreim * nmic
        if stage == "conformer":
            self.stage = ConformerEncoder(dembed, 1, num_heads=4, ff_expansion=4, dropout=dropout,
                                        dtype=dtype, generator=generator)
        elif stage == "transformer":
            self.stage = TransformerEncoder(dembed, 1, num_heads=4, dropout=dropout, dtype=dtype,
                                          generator=generator)
        if head == "fc":
            self.proj0 = Dense(dembed, dout * 3, dtype=dtype, generator=generator)
            self.proj1 = Dense(dout * 3, dout, dtype=dtype, generator=generator)
        else:
            if dembed % (pf * pt):
                raise ValueError(f"the cnn head needs dembed ({dembed}) divisible by the "
                                 f"patch size ({pf * pt})")
            self.f_first = pt != 1
            add_conv_stack(self, dembed // (pf * pt), nreim * nmic, dout,
                           (pt, pf) if self.f_first else (pf, pt), dtype=dtype,
                           generator=generator)

    def tensor_parallel(self, group, index: int, size: int):
        """Run the fc head's shards of ``proj0`` / ``proj1`` (``parallel/steps.py``)."""
        self.tp_group = group
        return []

    def forward(self, embed, train: bool = False, generator=None):
        if hasattr(self, "stage"):
            embed = self.stage(embed, train, generator)
        if self.head == "fc":
            if self.tp_group is not None:
                embed = tp.copy_to(embed, self.tp_group)
            return self.proj1(F.relu(self.proj0(embed)))
        nf, nt, _, _ = self.sig_shape
        dpatch = self.patch_shape[0] * self.patch_shape[1]
        nb, npatch, _ = embed.shape
        x = embed.reshape(nb, npatch, dpatch, self.dembed // dpatch)
        tf = patch_recover(x, (nf, nt), self.patch_shape, f_first=self.f_first)
        if self.f_first:
            tf = tf.transpose(1, 2)
        return run_conv_stack(self, tf, train).reshape(nb, npatch, -1)
