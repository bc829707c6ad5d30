"""Per-patch embedding encoder (port of ``sarssl_tpu/models/encoder.py``).

``CNNFrontEnd`` (encoder.py:23-51) and ``EmbedEncoder`` (:110-150): a local
front end (``fc``: one Dense over each patch; ``cnn``: the CNN over the
patch-recovered TF map; ``cnn_f_first``: the same over the transposed
``(nt, nf)`` canvas with a ``(pt, pf)`` projection), an optional CLS token
appended last, and a global sequence model (``conformer``, ``transformer``
or none). The convolutions are cuDNN calls (``F.conv2d``), as the JAX
package runs them outside any Pallas kernel. Public tensors keep the JAX
package's NHWC layout; inside, the NCHW view of an NHWC tensor is
channels-last, which cuDNN takes as it is. A single-model ``("crnn",)``,
``("crnn-sim",)`` or ``("tcrnn",)`` encoder (encoder.py:87-108) runs a
``models/crnn.py`` module, named ``crnn``, over the patch-recovered TF map:
its frame-wise outputs are the embeddings.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.patches import patch_recover
from .common import BatchNorm, Conv, Dense, remat
from .conformer import ConformerEncoder
from .crnn import CRNN, CRNNSim, TCRNN
from .transformer import TransformerEncoder

LOCAL_MODELS = ("fc", "cnn", "cnn_f_first")
GLOBAL_MODELS = ("conformer", "transformer", "")
CRNN_MODELS = ("crnn", "crnn-sim", "tcrnn")


def add_conv_stack(module: nn.Module, cin: int, cout: int, dembed: int, patch_shape,
                   conv_chs: int = 64, dtype=torch.float32, generator=None) -> None:
    """Give ``module`` flax's conv stack names: ``conv0``..``conv3`` (1x1, 3x3,
    3x3, 1x1: cin -> conv_chs -> conv_chs -> conv_chs -> cout), ``bn0``..``bn3``
    and the patch-strided projection ``proj`` to ``dembed``."""
    conv = lambda ci, co, k: Conv(ci, co, (k, k), dtype=dtype, generator=generator)
    module.conv0, module.bn0 = conv(cin, conv_chs, 1), BatchNorm(conv_chs, dtype)
    module.conv1, module.bn1 = conv(conv_chs, conv_chs, 3), BatchNorm(conv_chs, dtype)
    module.conv2, module.bn2 = conv(conv_chs, conv_chs, 3), BatchNorm(conv_chs, dtype)
    module.conv3, module.bn3 = conv(conv_chs, cout, 1), BatchNorm(cout, dtype)
    module.proj = Conv(cout, dembed, patch_shape, stride=tuple(patch_shape), padding="VALID",
                       dtype=dtype, generator=generator)


def run_conv_stack(module: nn.Module, x, train: bool = False):
    """The stack of :func:`add_conv_stack` (BN + ReLU after each conv) over an
    NHWC tensor; NHWC out."""
    y = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
    for i in range(4):
        y = F.relu(getattr(module, f"bn{i}")(getattr(module, f"conv{i}")(y), train))
    return module.proj(y).permute(0, 2, 3, 1)


class CNNFrontEnd(nn.Module):
    """1x1 -> 3x3 -> 3x3 -> 1x1 (BN + ReLU each) -> patch-strided projection.

    Input ``(nb, nf, nt, nch)``, output ``(nb, nf/pf, nt/pt, dembed)``."""

    def __init__(self, nch: int, dembed: int, patch_shape, conv_chs: int = 64,
                 dtype=torch.float32, generator=None):
        super().__init__()
        add_conv_stack(self, nch, nch, dembed, patch_shape, conv_chs, dtype, generator)

    def forward(self, x, train: bool = False):
        return run_conv_stack(self, x, train)


def _crnn(local: str, mode: str, nf: int, nch: int, dembed: int, dtype, generator):
    """The single-model CRNN variant ``local`` (encoder.py:87-108)."""
    kw = dict(out_dim=dembed, dtype=dtype, generator=generator)
    if local == "crnn" and mode == "spec":
        return CRNN(nch, nf, planes=(32, 32, 64), f_stride=(1, 4, 4), **kw)
    if local == "crnn":
        return CRNN(nch, nf, planes=(16, 16, 32, 64, 128), f_stride=(1, 1, 4, 4, 4), **kw)
    if local == "crnn-sim":
        return CRNNSim(nch, nf, conv_chs=64, rnn_hid=dembed, **kw)
    return TCRNN(nch, nf, **kw)


class EmbedEncoder(nn.Module):
    """Local front end over the patches, then a global sequence model.
    ``embed (nb, npatch, dpatch*nreim*nmic)`` -> ``(nb, npatch[+1], dembed)``
    (one more token, last, with ``use_cls`` and a global model).

    ``model`` is ``(local, global)`` from {'fc', 'cnn', 'cnn_f_first'} x
    {'conformer', 'transformer', ''}, or one of ``("crnn",)``,
    ``("crnn-sim",)``, ``("tcrnn",)`` (``(nb, nt, dembed)`` out, the CRNN's
    size picked by ``mode``); ``mode`` picks the layer count (spec 1, spat 3)
    unless ``num_layers`` is given; ``remat_local`` recomputes the CNN front
    end in the backward. flax names: ``patch_proj`` (fc), ``front`` (cnn),
    ``crnn``, ``cls_token``, ``global`` -> ``seq``."""

    def __init__(self, sig_shape, patch_shape, dembed: int, model=("cnn", "conformer"),
                 mode: str = "spat", num_layers: int = 0, dropout: float = 0.1,
                 fused_attention: bool = False, dtype=torch.float32, generator=None,
                 use_cls: bool = False, remat_local: bool = False):
        super().__init__()
        model = tuple(model)
        self.local, self.global_ = model[0], (model[1] if len(model) > 1 else "")
        self.sig_shape, self.patch_shape, self.dembed = tuple(sig_shape), tuple(patch_shape), dembed
        nf, nt, nreim, nmic = sig_shape
        self.is_crnn = len(model) == 1 and self.local in CRNN_MODELS
        if self.is_crnn:
            self.crnn = _crnn(self.local, mode, nf, nreim * nmic, dembed, dtype, generator)
            return
        if self.local not in LOCAL_MODELS:
            raise ValueError(f"Unsupported local model: {self.local}")
        if self.global_ not in GLOBAL_MODELS:
            raise ValueError(f"Unsupported global model: {self.global_}")
        self.remat_local = remat_local
        pf, pt = patch_shape
        nlayers = num_layers or (1 if mode == "spec" else 3)
        if self.local == "fc":
            self.patch_proj = Dense(pf * pt * nreim * nmic, dembed, dtype=dtype,
                                    generator=generator)
        else:
            proj = (pt, pf) if self.local == "cnn_f_first" else (pf, pt)
            self.front = CNNFrontEnd(nreim * nmic, dembed, proj, dtype=dtype,
                                     generator=generator)
        self.use_cls = use_cls and self.global_ != ""
        if self.use_cls:
            self.cls_token = nn.Parameter(nn.init.trunc_normal_(
                torch.empty(1, 1, dembed), 0.0, 0.02, -0.04, 0.04, generator=generator))
        if self.global_ == "conformer":
            self.seq = ConformerEncoder(dembed, nlayers, num_heads=4, ff_expansion=4,
                                        dropout=dropout, fused_attention=fused_attention,
                                        dtype=dtype, generator=generator)
        elif self.global_ == "transformer":
            self.seq = TransformerEncoder(dembed, nlayers, num_heads=4, dropout=dropout,
                                          dtype=dtype, generator=generator)

    def _front(self, embed, train: bool):
        nf, nt, nreim, nmic = self.sig_shape
        pf, pt = self.patch_shape
        nb, npatch, _ = embed.shape
        f_first = self.local == "cnn_f_first"
        v = embed.reshape(nb, npatch, pf * pt, nreim * nmic)
        tf = patch_recover(v, (nf, nt), self.patch_shape, f_first=f_first)  # (nb, nf, nt, nch)
        if f_first:  # the transposed (nt, nf) canvas (encoder.py:118-123)
            tf = tf.transpose(1, 2)
        if self.remat_local:
            y = remat(self.front, lambda t, _: self.front(t, train), tf)
        else:
            y = self.front(tf, train)
        return y.reshape(nb, npatch, self.dembed)

    def forward(self, embed, train: bool = False, generator=None):
        if self.is_crnn:  # frame-wise outputs are the embeddings
            nb, npatch, _ = embed.shape
            v = embed.reshape(nb, npatch, self.patch_shape[0] * self.patch_shape[1], -1)
            tf = patch_recover(v, self.sig_shape[:2], self.patch_shape,
                               f_first=self.patch_shape[1] != 1)
            return self.crnn(tf, train)  # (nb, nt, dembed)
        if self.local == "fc":
            x = self.patch_proj(embed)
        else:
            x = self._front(embed, train)
        if self.use_cls:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, self.dembed)
            x = torch.cat([x, cls], dim=1)
        if self.global_:
            x = self.seq(x, train, generator)
        return x
