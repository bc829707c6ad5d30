"""Pretext-task evaluation (port of ``sarssl_tpu/train/pretext_eval.py``):
spectrogram reconstruction -> waveform metrics.

The reference's ``STFTLearner.pretrain_evaluate`` (``learner.py:574-618``):
view the predicted and target patch grids as complex STFTs, prepend the
dropped DC bin, ISTFT, peak-normalise, and compute the masked and unmasked
MSEs and, optionally, PESQ. The MSEs and the ISTFT run on the tensors'
device (``ops/stft.py::istft``); the waveforms then go to the host for PESQ
(``utils/pesq.py``) and the dumps.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.patches import patch_recover
from ..ops.stft import istft
from ..utils import pesq as _pesq


def reconstruct_waveforms(pred_tf: torch.Tensor, win_len: int = 512,
                          win_shift_ratio: float = 0.5, nfft: int = 512) -> torch.Tensor:
    """``(nb, nf, nt, nreim, nch)`` TF grid (DC dropped) -> ``(nb, nsample,
    nch)`` on the grid's device, divided by the batch's peak magnitude."""
    x = pred_tf.float()
    cplx = torch.complex(x[..., 0, :], x[..., 1, :])       # (nb, nf, nt, nch)
    full = torch.cat([torch.zeros_like(cplx[:, :1]), cplx], dim=1)
    sig = istft(full, win_len, win_shift_ratio, nfft)
    return sig / sig.abs().max().clamp_min(1e-9)


def pretext_metrics(aux: Dict, sig_shape, patch_shape, fs: int = 16000,
                    compute_pesq: bool = False) -> Dict:
    """Metrics from a pretext forward's ``aux`` dict ``{pred, tar, mask}``.

    Returns ``mse``, ``mse_mask``, ``mse_mask_ch`` (floats), ``pesq`` (nb,
    nch) or NaN, ``pesq_mask_ch`` (nb,), ``sig_pred`` and ``sig_tar`` (nb,
    nsample, nch), and the per-item dumps ``mask_dense`` (nb, nf, nt, nch; 1 =
    kept), ``pred_tf`` and ``tar_tf`` (nb, nf, nt, 2, nch), all numpy."""
    nf, nt = sig_shape[0], sig_shape[1]
    f_first = patch_shape[1] != 1
    pred = patch_recover(aux["pred"].float(), (nf, nt), patch_shape, f_first)
    tar = patch_recover(aux["tar"].float(), (nf, nt), patch_shape, f_first)
    mask = aux["mask"]
    nb, npatch = mask.patch.shape
    nmic = tar.shape[-1]

    # dense mask over the TF grid: 1 = kept, 0 = masked (the reference's)
    mp = mask.patch.float()                                # 1 = masked
    ch = F.one_hot(mask.ch.long(), nmic).float()           # 1 = masked channel
    dpatch = patch_shape[0] * patch_shape[1]
    dense_patches = 1.0 - mp[:, :, None, None] * ch[:, None, None, :]
    mask_dense = patch_recover(dense_patches.expand(nb, npatch, dpatch, nmic),
                               (nf, nt), patch_shape, f_first)  # (nb, nf, nt, nmic)

    diff = (pred - tar) ** 2                               # (nb, nf, nt, 2, nmic)
    # over the full (nb, nf, nt, nreim, nch) grid, as the reference tiles it
    # (learner.py:594): the denominator counts re AND im cells
    md = mask_dense[:, :, :, None, :].expand_as(diff)
    diff_mask = diff * (1 - md)
    mse = diff.mean()
    mse_mask = diff_mask.sum() / (1 - md).sum().clamp_min(1)
    mse_mask_ch = diff_mask.sum(-1).mean()                 # learner.py:599-600
    vals = torch.stack([mse, mse_mask, mse_mask_ch]).tolist()
    out = dict(zip(("mse", "mse_mask", "mse_mask_ch"), vals))

    sig_pred = reconstruct_waveforms(pred).cpu().numpy()
    sig_tar = reconstruct_waveforms(tar).cpu().numpy()
    out["sig_pred"], out["sig_tar"] = sig_pred, sig_tar

    pesq = np.full((nb, nmic), np.nan)
    if compute_pesq:
        for b in range(nb):
            for m in range(nmic):
                try:
                    pesq[b, m] = _pesq.pesq_wb(sig_tar[b, :, m], sig_pred[b, :, m], fs)
                except Exception:
                    pesq[b, m] = np.nan
    out["pesq"] = pesq
    # PESQ of each item's masked channel: the one with FEWER kept cells
    # (learner.py:609-616)
    mask_dense = mask_dense.cpu().numpy()
    mask_ch = np.argmin(mask_dense.sum(axis=(1, 2)), axis=1)
    out["pesq_mask_ch"] = pesq[np.arange(nb), mask_ch]
    out["mask_dense"] = mask_dense
    out["pred_tf"], out["tar_tf"] = pred.cpu().numpy(), tar.cpu().numpy()
    return out
