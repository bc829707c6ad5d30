"""Train and eval steps (port of ``sarssl_tpu/train/steps.py``).

Pretext step: STFT features -> mask (``mask_mode``, 'T' by default) ->
forward in train mode -> masked MSE -> backward -> Adam update of the
parameters not frozen (the frozen-encoder pretext stage). Downstream step:
STFT features -> head prediction -> MSE against the task's target ->
backward -> Adam update of the parameters not frozen (lineareval). The
BatchNorm running stats update during the forward. PyTorch runs eagerly, so
a step is a plain function over a ``TrainState``.

Freezing, as the JAX steps do it: a frozen parameter takes no gradient (here
``requires_grad`` is off during the step, so autograd skips whatever only it
needs, the backward of a wholly frozen encoder included; Adam reads the
missing gradient as 0, and so does a clipping norm), the update runs over all
parameters, and the frozen values are then put back: moments restored from a
checkpoint, or AdamW's weight decay, would otherwise move them. The BatchNorm
stats of a frozen encoder still move, as the JAX steps replace all of
``batch_stats``.

Randomness comes from an explicit CPU ``torch.Generator``: the mask (unless
one is given, e.g. replayed from the JAX package) and one uint32 dropout
seed per dropout site. Drawing on the host keeps the step free of device
syncs.

The sharded steps of ``parallel/steps.py`` are these steps, given this
rank's ``rows`` of the global batch (the mask is drawn for the global batch
and sliced), a ``grad_sync`` (its ``attach()`` before the forward, its call
between backward and update) and the global batch's ``mean``; the defaults
are the step over its own batch.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..ops.features import FeatureConfig, stft_features
from ..ops.mask import T_MODE, PatchMask, gen_patch_mask
from ..utils.device import resolve_device
from .state import TrainState


def _check_model_device(model, dev):
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model is on {p.device}, the step on {dev}")


def _features(wave_batch, feat_cfg, dev):
    wave = torch.as_tensor(wave_batch).to(dev, torch.float32, non_blocking=True)
    return stft_features(wave, feat_cfg)  # (nb', 2, nf, nt, 2)


def _frozen_params(model, trainable_mask: Optional[Dict[str, bool]]) -> List[torch.nn.Parameter]:
    if trainable_mask is None:
        return []
    params = dict(model.named_parameters())
    if set(trainable_mask) != set(params):
        raise ValueError("trainable_mask must name every parameter of the model")
    return [params[n] for n, trainable in trainable_mask.items() if not trainable]


@contextlib.contextmanager
def _without_grad(frozen: List[torch.nn.Parameter]):
    for p in frozen:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in frozen:
            p.requires_grad_(True)


@torch.no_grad()
def _update(state: TrainState, lr: float, frozen: List[torch.nn.Parameter]) -> None:
    kept = torch._foreach_mul(frozen, 1.0) if frozen else []  # exact copies
    for p in frozen:  # masked, as the JAX step masks them: 0 in a clipping norm
        p.grad = None
    state.apply_gradients(lr)
    if frozen:
        torch._foreach_copy_(frozen, kept)


def _mean(x: torch.Tensor, dim: Optional[int] = None, grad: bool = False) -> torch.Tensor:
    """The mean over the step's own rows (``dim`` 0) or over every element;
    ``grad`` says whether the loss's gradient flows through it."""
    return x.mean() if dim is None else x.mean(dim=dim)


def _step_mask(mask, generator, nb, cfg, mask_mode, rows, dev):
    """The step's mask: ``mask`` or one drawn for the global batch, then
    this rank's ``rows`` of it (the whole of it without a mesh)."""
    count = 1 if rows is None else rows.count
    if mask is None:
        mask = gen_patch_mask(generator, nb * count, cfg.npatch, cfg.effective_nmasked(),
                              nmic=2, mode=mask_mode, device=dev)
    if rows is None:
        return mask
    return PatchMask(*(rows.local(t) for t in mask)).to(dev)


def make_pretrain_step(model, feat_cfg: FeatureConfig = FeatureConfig(), device="cuda",
                       trainable_mask: Optional[Dict[str, bool]] = None,
                       mask_mode: str = T_MODE, rows=None, grad_sync=None):
    """Returns ``step(state, wave_batch, lr, generator, mask=None) -> metrics``.

    ``wave_batch``: ``(nb, nsample, nch)`` float waveforms (tensor or numpy).
    ``metrics``: ``{"loss", "diff"}`` as 0-d tensors on the device.
    ``trainable_mask`` maps parameter names to False for frozen ones (the
    encoders in the frozen-encoder pretext stage); see the module's note.
    ``mask_mode`` is ``gen_patch_mask``'s; as in the JAX step no grid shape is
    passed, so a step that draws a 'TF' mask raises (hand one in as ``mask``).
    ``rows``, ``grad_sync``: a mesh's (the module's note)."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    cfg = model.cfg
    frozen = _frozen_params(model, trainable_mask)

    def step(state: TrainState, wave_batch, lr: float, generator: torch.Generator,
             mask=None):
        feats = _features(wave_batch, feat_cfg, dev)
        mask = _step_mask(mask, generator, feats.shape[0], cfg, mask_mode, rows, dev)
        state.model.train()
        with _without_grad(frozen):
            if grad_sync is not None:
                grad_sync.attach()
            loss, diff, _ = state.model.pretext(feats, mask, True, generator)
            loss.backward()
        if grad_sync is not None:
            grad_sync()
        _update(state, lr, frozen)
        return {"loss": loss.detach(), "diff": diff.detach()}

    return step


def make_pretrain_eval_step(model, feat_cfg: FeatureConfig = FeatureConfig(),
                            device="cuda", mask_mode: str = T_MODE, rows=None):
    """Returns ``step(state, wave_batch, generator, mask=None) -> metrics``
    (eval mode: running BatchNorm stats, no dropout, no update)."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    cfg = model.cfg

    @torch.no_grad()
    def step(state: TrainState, wave_batch, generator: torch.Generator, mask=None):
        feats = _features(wave_batch, feat_cfg, dev)
        mask = _step_mask(mask, generator, feats.shape[0], cfg, mask_mode, rows, dev)
        state.model.eval()
        loss, diff, _ = state.model.pretext(feats, mask, False)
        return {"loss": loss, "diff": diff}

    return step


def _target_transform(task: str, gt: torch.Tensor, dlabel: int = 1) -> torch.Tensor:
    """Targets as the reference learner reads them: TDOA in samples (x fs),
    SUR/VOL in log10, every other task as it is; ``[:, :dlabel]``."""
    gt = gt.reshape(gt.shape[0], -1)[:, :dlabel]
    if task == "TDOA":
        return gt * 16000.0
    if task in ("SUR", "VOL"):
        return torch.log10(gt)
    return gt


def _targets(gt_batch, task, dlabel, dev):
    return _target_transform(task, torch.as_tensor(gt_batch).to(dev, torch.float32), dlabel)


def make_downstream_step(model, feat_cfg: FeatureConfig = FeatureConfig(), task: str = "TDOA",
                         trainable_mask: Optional[Dict[str, bool]] = None, dlabel: int = 1,
                         device="cuda", grad_sync=None, mean=_mean):
    """Returns ``step(state, wave_batch, gt_batch, lr, generator) -> metrics``.

    MSE of the head's prediction against the transformed target (no
    gradient to the target); the BatchNorm running stats update in the
    forward. ``metrics``: ``{"loss", "mae"}`` as 0-d tensors on the device.

    ``trainable_mask`` (e.g. from ``trainable_mask_from_loaded``) maps
    parameter names to False for frozen ones (lineareval); see the module's
    note. ``grad_sync``, ``mean``: a mesh's (the module's note)."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    frozen = _frozen_params(model, trainable_mask)

    def step(state: TrainState, wave_batch, gt_batch, lr: float, generator: torch.Generator):
        feats = _features(wave_batch, feat_cfg, dev)
        tar = _targets(gt_batch, task, dlabel, dev)
        state.model.train()
        with _without_grad(frozen):
            if grad_sync is not None:
                grad_sync.attach()
            pred, _ = state.model.downstream(feats, True, generator)
            loss = mean((pred - tar) ** 2, grad=True)
            loss.backward()
        if grad_sync is not None:
            grad_sync()
        _update(state, lr, frozen)
        pred = pred.detach()
        return {"loss": loss.detach(), "mae": mean((pred - tar).abs())}

    return step


def make_downstream_eval_step(model, feat_cfg: FeatureConfig = FeatureConfig(),
                              task: str = "TDOA", dlabel: int = 1, device="cuda", mean=_mean):
    """Returns ``step(state, wave_batch, gt_batch) -> metrics`` (eval mode:
    running BatchNorm stats, no dropout, no update): ``loss``, ``mae``,
    ``pred``, ``embed``, and the per-dimension ``mae_dims`` when
    ``dlabel > 1``."""
    dev = resolve_device(device)
    _check_model_device(model, dev)

    @torch.no_grad()
    def step(state: TrainState, wave_batch, gt_batch):
        feats = _features(wave_batch, feat_cfg, dev)
        tar = _targets(gt_batch, task, dlabel, dev)
        state.model.eval()
        pred, embed = state.model.downstream(feats, False)
        err = pred - tar
        out = {"loss": mean(err ** 2), "mae": mean(err.abs()), "pred": pred, "embed": embed}
        if dlabel > 1:
            out["mae_dims"] = mean(err.abs(), dim=0)
        return out

    return step
