"""Pretext train and eval steps (port of ``sarssl_tpu/train/steps.py:22-90``).

One step: STFT features -> 'T' mask (the only mode ported yet) -> forward
in train mode -> masked MSE -> backward -> Adam update; the BatchNorm running
stats update during the forward. PyTorch runs eagerly, so a step is a plain function over a
``TrainState``.

Randomness comes from an explicit CPU ``torch.Generator``: the mask (unless
one is given, e.g. replayed from the JAX package) and one uint32 dropout
seed per dropout site. Drawing on the host keeps the step free of device
syncs.
"""
from __future__ import annotations

import torch

from ..ops.features import FeatureConfig, stft_features
from ..ops.mask import gen_patch_mask
from ..utils.device import resolve_device
from .state import TrainState


def _check_model_device(model, dev):
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model is on {p.device}, the step on {dev}")


def _features(wave_batch, feat_cfg, dev):
    wave = torch.as_tensor(wave_batch).to(dev, torch.float32, non_blocking=True)
    return stft_features(wave, feat_cfg)  # (nb', 2, nf, nt, 2)


def make_pretrain_step(model, feat_cfg: FeatureConfig = FeatureConfig(), device="cuda"):
    """Returns ``step(state, wave_batch, lr, generator, mask=None) -> metrics``.

    ``wave_batch``: ``(nb, nsample, nch)`` float waveforms (tensor or numpy).
    ``metrics``: ``{"loss", "diff"}`` as 0-d tensors on the device."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    cfg = model.cfg
    nmasked = cfg.effective_nmasked()

    def step(state: TrainState, wave_batch, lr: float, generator: torch.Generator,
             mask=None):
        feats = _features(wave_batch, feat_cfg, dev)
        if mask is None:
            mask = gen_patch_mask(generator, feats.shape[0], cfg.npatch, nmasked, nmic=2,
                                  device=dev)
        state.model.train()
        loss, diff, _ = state.model.pretext(feats, mask, True, generator)
        loss.backward()
        state.apply_gradients(lr)
        return {"loss": loss.detach(), "diff": diff.detach()}

    return step


def make_pretrain_eval_step(model, feat_cfg: FeatureConfig = FeatureConfig(),
                            device="cuda"):
    """Returns ``step(state, wave_batch, generator, mask=None) -> metrics``
    (eval mode: running BatchNorm stats, no dropout, no update)."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    cfg = model.cfg
    nmasked = cfg.effective_nmasked()

    @torch.no_grad()
    def step(state: TrainState, wave_batch, generator: torch.Generator, mask=None):
        feats = _features(wave_batch, feat_cfg, dev)
        if mask is None:
            mask = gen_patch_mask(generator, feats.shape[0], cfg.npatch, nmasked, nmic=2,
                                  device=dev)
        state.model.eval()
        loss, diff, _ = state.model.pretext(feats, mask, False)
        return {"loss": loss, "diff": diff}

    return step
