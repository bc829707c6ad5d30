"""SAR-SSL model (port of ``sarssl_tpu/models/sarssl.py``).

Dual encoder (spec + spat, each a local front end and a global sequence
model, ``local_model`` x ``global_model``; f-first patches, ``patch_shape``
with ``pt != 1``, turn the ``cnn`` front end into ``cnn_f_first``).

With ``pretrain=True``, cross-channel masked spectrogram reconstruction. For
``in_ver="separate"``:

  spec-encoder input = masked frames of the kept channel
                       + unmasked frames of the masked channel;
  spat-encoder input = both channels on unmasked frames only;
  the decoder predicts every patch of every channel; the loss reads the
  masked channel on masked frames, over ``sum(mask) * dpatch * 2``.

``in_ver="same"`` gives both encoders the input with the masked channel's
masked frames zeroed; ``"single_ch_each_patch"`` does too, but each patch
carries one channel: the encoders run on the mics' patch sequences joined
end to end (``(nf * nmic, nt)`` canvas, one channel, ``dembed / nmic``), and
each mic's embeddings are joined again along features. ``use_cls`` appends a
CLS token to each encoder's sequence; the decoder does not see it, and the
downstream embedding is the token (``downstream_token="cls"``) or the mean
of the patches (``"all"``).

With ``pretrain=False``, the downstream regression head: both encoders on
the unmasked input, the chosen embedding mean-pooled over patches, then
LayerNorm -> [Dense + ReLU when dlabel > 1] -> Dense.

``SARSSLMultiCH`` is the multi-pair downstream model: one such trunk shared
by every mic pair, its spat embeddings joined across pairs into one head.

With ``frozen_encoder_pretext`` (the decoder retrained over frozen encoders,
reference ``model.py:622-631``) the spec encoder sees only the masked frames
of the kept channel.

``MCConformer`` is the supervised encoder-decoder without masking
(sarssl.py:266-304).

With a batch sharded over data ranks (``data_group``, set by
``parallel/steps.py``) the pretext loss is the global batch's: its
numerator and denominator are summed over the group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mask import PatchMask
from ..ops.patches import patch_recover, patch_split
from ..parallel import tp
from ..utils.device import resolve_device
from .common import Dense, LayerNorm
from .decoder import EmbedDecoder
from .encoder import EmbedEncoder


@dataclass(frozen=True)
class SARSSLConfig:
    """Copy of ``sarssl_tpu.models.SARSSLConfig`` (sarssl.py:36-89)."""

    sig_shape: Tuple[int, int, int, int] = (256, 256, 2, 2)  # (nf, nt, nreim, nmic)
    patch_shape: Tuple[int, int] = (256, 1)
    nmasked_patch: int = 128
    spec_dembed: int = 512
    spat_dembed: int = 256
    spec_layers: int = 1
    spat_layers: int = 3
    num_heads: int = 4
    local_model: str = "cnn"
    global_model: str = "conformer"
    dec_model: Tuple[str, str] = ("", "fc")
    dropout: float = 0.1
    pretrain: bool = True
    downstream_head: str = "mlp"
    downstream_embed: str = "spec_spat"
    downstream_dlabel: int = 1
    frozen_encoder_pretext: bool = False
    in_ver: str = "separate"
    remat_cnn: bool = False
    fused_attention: bool = False
    use_cls: bool = False
    downstream_token: str = "all"
    dtype: str = "float32"

    @property
    def npatch(self) -> int:
        nf, nt, _, _ = self.sig_shape
        return (nf // self.patch_shape[0]) * (nt // self.patch_shape[1])

    @property
    def dpatch(self) -> int:
        return self.patch_shape[0] * self.patch_shape[1]

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def effective_nmasked(self) -> int:
        # the reference forces nmasked = npatch // 2
        return self.npatch // 2

    def tiny(self, **overrides) -> "SARSSLConfig":
        """Small config for tests."""
        base = dict(
            sig_shape=(32, 16, 2, 2), patch_shape=(32, 1), nmasked_patch=8,
            spec_dembed=32, spat_dembed=16, spec_layers=1, spat_layers=1,
            num_heads=2,
        )
        base.update(overrides)
        return SARSSLConfig(**{**self.__dict__, **base})


DOWNSTREAM_EMBEDS = ("spec_spat", "spec", "spat", "noinfo")
IN_VERS = ("separate", "same", "single_ch_each_patch")
DOWNSTREAM_TOKENS = ("all", "cls")


def _check_ported(c: SARSSLConfig) -> None:
    if not c.pretrain and c.downstream_embed not in DOWNSTREAM_EMBEDS:
        raise ValueError(f"downstream_embed {c.downstream_embed!r} not in {DOWNSTREAM_EMBEDS}")
    if c.in_ver not in IN_VERS:
        raise ValueError(f"in_ver {c.in_ver!r} not in {IN_VERS}")
    if c.downstream_token not in DOWNSTREAM_TOKENS:
        raise ValueError(f"downstream_token {c.downstream_token!r} not in {DOWNSTREAM_TOKENS}")
    # the JAX package builds no head for another name, so its downstream
    # forward has nothing to call
    if not c.pretrain and c.downstream_head != "mlp":
        raise NotImplementedError(f"downstream_head={c.downstream_head!r}: only 'mlp' "
                                  f"exists in either package")


def _local_model(c: SARSSLConfig) -> str:
    """f-first patches run the CNN front end on the transposed canvas."""
    f_first = c.patch_shape[1] != 1
    return "cnn_f_first" if f_first and c.local_model == "cnn" else c.local_model


def _join_mics(e, npatch: int, nmic: int):
    """``(nb, nmic * npatch[+1], d)`` -> ``(nb, npatch, nmic * d)``: each mic's
    patch embeddings side by side (a CLS token, last, drops out)."""
    return torch.cat([e[:, m * npatch:(m + 1) * npatch] for m in range(nmic)], dim=2)


class SARSSL(nn.Module):
    """Pretext (``cfg.pretrain``) or downstream SAR-SSL network. Built from
    ``torch.Generator().manual_seed(seed)`` on the CPU, then moved to
    ``device`` (default ``"cuda"``). ``head=False`` leaves out the downstream
    head: the encoders alone, as flax creates them for a module whose only
    caller is ``embed`` (``SARSSLMultiCH``'s trunk)."""

    def __init__(self, cfg: SARSSLConfig, device="cuda", seed: int = 0, head: bool = True):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = c = cfg
        self.data_group = None
        gen = torch.Generator().manual_seed(seed)
        dtype = c.compute_dtype
        if c.in_ver == "single_ch_each_patch":
            nf, nt, nreim, nmic = c.sig_shape
            enc_sig_shape, dembed_div = (nf * nmic, nt, nreim, 1), nmic
        else:
            enc_sig_shape, dembed_div = c.sig_shape, 1
        enc = lambda dembed, mode, layers: EmbedEncoder(
            enc_sig_shape, c.patch_shape, dembed // dembed_div,
            (_local_model(c), c.global_model), mode, layers, c.dropout, c.fused_attention,
            dtype, gen, use_cls=c.use_cls, remat_local=c.remat_cnn)
        self.spec_encoder = enc(c.spec_dembed, "spec", c.spec_layers)
        self.spat_encoder = enc(c.spat_dembed, "spat", c.spat_layers)
        if c.pretrain:
            self.decoder = EmbedDecoder(c.sig_shape, c.patch_shape,
                                        c.spec_dembed + c.spat_dembed, c.dec_model, c.dropout,
                                        dtype, gen)
        elif head:  # flax's names: head_norm, head_hidden, head_proj
            dembed = {"spec_spat": c.spec_dembed + c.spat_dembed, "spec": c.spec_dembed,
                      "spat": c.spat_dembed, "noinfo": c.spec_dembed}[c.downstream_embed]
            self.head_norm = LayerNorm(dembed, dtype)
            if c.downstream_dlabel != 1:
                self.head_hidden = Dense(dembed, dembed, dtype=dtype, generator=gen)
            self.head_proj = Dense(dembed, c.downstream_dlabel, dtype=dtype, generator=gen)
        self.to(dev)

    def _split(self, x):
        # (nb, nmic, nf, nt, nreim) -> patches (nb, npatch, dpatch, nreim, nmic)
        return patch_split(x.permute(0, 2, 3, 4, 1), self.cfg.patch_shape,
                           f_first=self.cfg.patch_shape[1] != 1)

    def _encode_per_mic(self, vec, train, generator):
        """``single_ch_each_patch``: both encoders over the mics' patch
        sequences joined end to end, each mic's embeddings joined again."""
        nb, npatch, nmic = vec.shape[0], vec.shape[1], vec.shape[-1]
        flat = torch.cat([vec[..., m] for m in range(nmic)], dim=1).reshape(nb, npatch * nmic, -1)
        return (_join_mics(self.spec_encoder(flat, train, generator), npatch, nmic),
                _join_mics(self.spat_encoder(flat, train, generator), npatch, nmic))

    def forward(self, x, mask: Optional[PatchMask] = None, train: bool = False,
                generator=None):
        """``pretext(x, mask, ...)`` when ``cfg.pretrain``, else
        ``downstream(x, ...)``."""
        if self.cfg.pretrain:
            if mask is None:
                raise ValueError("the pretext forward needs a PatchMask")
            return self.pretext(x, mask, train, generator)
        return self.downstream(x, train, generator)

    def pretext(self, x, mask: PatchMask, train: bool = False, generator=None):
        """Masked cross-channel reconstruction. Returns ``(loss, diff, aux)``.

        ``generator``: CPU ``torch.Generator`` for the dropout seeds (train)."""
        c = self.cfg
        nb, nmic = x.shape[0], x.shape[1]
        vec = self._split(x)  # (nb, npatch, dpatch, nreim, nmic)
        npatch, dpatch = vec.shape[1], vec.shape[2]
        dtype = c.compute_dtype

        masked = mask.patch.to(dtype)[:, :, None, None, None]
        masked_ch = F.one_hot(mask.ch, nmic).to(dtype)[:, None, None, None, :]
        kept_ch = 1.0 - masked_ch
        vecc = vec.to(dtype)
        if c.in_ver == "single_ch_each_patch":
            both = vecc * (1.0 - masked * masked_ch)
            embed_spec, embed_spat = self._encode_per_mic(both, train, generator)
        else:
            if c.in_ver == "same":
                spec_in = spat_in = vecc * (1.0 - masked * masked_ch)
            else:
                spec_in = vecc * masked * kept_ch
                if not c.frozen_encoder_pretext:
                    spec_in = spec_in + vecc * (1.0 - masked) * masked_ch
                spat_in = vecc * (1.0 - masked)
            embed_spec = self.spec_encoder(spec_in.reshape(nb, npatch, -1), train, generator)
            embed_spat = self.spat_encoder(spat_in.reshape(nb, npatch, -1), train, generator)
        # the CLS token, last, is not decoded
        embed = torch.cat([embed_spec[:, :npatch], embed_spat[:, :npatch]], dim=2)
        pred = self.decoder(embed, train, generator).reshape(nb, npatch, dpatch, 2, nmic)

        pred_m = (pred.float() * masked_ch).sum(-1)
        with torch.no_grad():
            tar_m = (vec * masked_ch).sum(-1)
            tar_k = (vec * kept_ch).sum(-1)
        w = mask.patch.float()[:, :, None, None]
        denom = mask.patch.sum() * dpatch * 2
        num = (((pred_m - tar_m) ** 2) * w).sum()
        num_diff = (((tar_m - tar_k) ** 2) * w).sum()
        if self.data_group is not None:  # the global batch's sums
            num = tp.reduce_from(num, self.data_group)
            num_diff = tp.summed(num_diff, self.data_group)
            denom = tp.summed(denom, self.data_group)
        loss = num / denom
        diff = num_diff / denom
        return loss, diff, {"pred": pred, "tar": vec, "mask": mask}

    def embed(self, x, train: bool = False, generator=None):
        """Unmasked dual-encoder embeddings, mean-pooled over patches:
        ``(nb, dembed_ds)``. Both encoders always run, so in train mode both
        update their BatchNorm stats whatever the embedding."""
        c = self.cfg
        nb = x.shape[0]
        vec = self._split(x).to(c.compute_dtype)
        if c.in_ver == "single_ch_each_patch":
            embed_spec, embed_spat = self._encode_per_mic(vec, train, generator)
        else:
            flat = vec.reshape(nb, vec.shape[1], -1)
            embed_spec = self.spec_encoder(flat, train, generator)
            embed_spat = self.spat_encoder(flat, train, generator)
        if c.downstream_embed == "spec_spat":
            embed = torch.cat([embed_spec, embed_spat], dim=2)
        elif c.downstream_embed == "spec":
            embed = embed_spec
        elif c.downstream_embed == "spat":
            embed = embed_spat
        else:  # noinfo: zeros, no gradient to the encoders
            embed = torch.zeros_like(embed_spec.detach())
        if c.use_cls:
            if c.downstream_token == "cls":
                return embed[:, -1]
            embed = embed[:, :-1]  # 'all': the mean of the patch tokens
        return embed.mean(dim=1)

    def downstream(self, x, train: bool = False, generator=None):
        """Regression head. Returns ``(pred (nb, dlabel) f32, embed (nb,
        dembed_ds))``."""
        pooled = self.embed(x, train, generator)
        y = self.head_norm(pooled)
        if self.cfg.downstream_dlabel != 1:
            y = F.relu(self.head_hidden(y))
        return self.head_proj(y).float(), pooled


class MCConformer(nn.Module):
    """Supervised encoder-decoder without masking (sarssl.py:266-304): the
    encoders that ``spec_dembed`` / ``spat_dembed`` > 0 ask for (mode's layer
    count, unfused attention, no CLS token, no remat) over the patches, their
    embeddings joined, the decoder, and the prediction recovered onto the TF
    map: ``(nb, nmic, nf, nt, nreim)`` in, ``(nb, nf, nt, nreim, nmic)`` out.
    Built like :class:`SARSSL` from a seed on the CPU, then moved to
    ``device``."""

    def __init__(self, cfg: SARSSLConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        gen = torch.Generator().manual_seed(seed)
        dtype = c.compute_dtype
        enc = lambda dembed, mode: EmbedEncoder(
            c.sig_shape, c.patch_shape, dembed, (_local_model(c), c.global_model), mode,
            0, c.dropout, False, dtype, gen)
        if c.spec_dembed > 0:
            self.spec_encoder = enc(c.spec_dembed, "spec")
        if c.spat_dembed > 0:
            self.spat_encoder = enc(c.spat_dembed, "spat")
        self.decoder = EmbedDecoder(c.sig_shape, c.patch_shape, c.spec_dembed + c.spat_dembed,
                                    c.dec_model, c.dropout, dtype, gen)
        self.to(dev)

    def forward(self, x, train: bool = False, generator=None):
        c = self.cfg
        nb, nmic = x.shape[0], x.shape[1]
        f_first = c.patch_shape[1] != 1
        vec = patch_split(x.permute(0, 2, 3, 4, 1), c.patch_shape, f_first=f_first)
        npatch, dpatch = vec.shape[1], vec.shape[2]
        flat = vec.reshape(nb, npatch, -1).to(c.compute_dtype)
        embeds = [enc(flat, train, generator) for enc in
                  (getattr(self, "spec_encoder", None), getattr(self, "spat_encoder", None))
                  if enc is not None]
        pred = self.decoder(torch.cat(embeds, dim=2), train, generator)
        pred = pred.reshape(nb, npatch, dpatch, 2, nmic)
        return patch_recover(pred, (c.sig_shape[0], c.sig_shape[1]), c.patch_shape,
                             f_first=f_first)


class SARSSLMultiCH(nn.Module):
    """Multi-pair downstream model: one ``SARSSL`` trunk (``model_sch``,
    ``pretrain=False``, ``downstream_embed="spat"``, no head) embeds every
    mic pair, the pairs' pooled spat embeddings are joined per example, and a
    joint head LayerNorm -> Dense(npair * d) -> ReLU -> Dense(dlabel) reads
    them; dlabel is ``nmic_pair`` for TDOA (one target a pair), else 1.

    The input is ``(nb * nmic_pair, 2, nf, nt, nreim)``, pairs of an example
    consecutive (``mic_pair_rebatch``). Module names follow flax's tree
    (``model_sch``, ``LayerNorm_0`` -> ``ln``, ``Dense_0`` -> ``dense0``,
    ``Dense_1`` -> ``dense1``)."""

    def __init__(self, cfg: SARSSLConfig, nmic_pair: int, task: str = "TDOA", device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.nmic_pair = nmic_pair
        trunk_cfg = SARSSLConfig(**{**cfg.__dict__, "pretrain": False,
                                    "downstream_embed": "spat"})
        self.model_sch = SARSSL(trunk_cfg, device="cpu", seed=seed, head=False)
        gen = torch.Generator().manual_seed(seed + 1)
        dtype = cfg.compute_dtype
        djoint = nmic_pair * cfg.spat_dembed
        self.ln = LayerNorm(djoint, dtype)
        self.dense0 = Dense(djoint, djoint, dtype=dtype, generator=gen)
        self.dense1 = Dense(djoint, nmic_pair if task == "TDOA" else 1, dtype=dtype,
                            generator=gen)
        self.to(dev)

    def downstream(self, x, train: bool = False, generator=None):
        """Returns ``(pred (nb, dlabel) f32, joint embedding (nb, npair * d))``."""
        pooled = self.model_sch.embed(x, train, generator)  # (nb * npair, d)
        joint = pooled.reshape(-1, self.nmic_pair * pooled.shape[-1])
        y = F.relu(self.dense0(self.ln(joint)))
        return self.dense1(y).float(), joint
