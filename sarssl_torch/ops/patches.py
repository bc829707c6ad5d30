"""Patch split / recover as reshapes (port of ``sarssl_tpu/ops/patches.py``).

  * input  ``(nb, nf, nt, nreim, nmic)`` or ``(nb, nf, nt, nch)``
  * output ``(nb, npatch, dpatch, nreim, nmic)`` / ``(nb, npatch, dpatch, nch)``
  * ``npatch`` runs row-major over ``(nf/pf, nt/pt)`` (``(nt/pt, nf/pf)`` when
    ``f_first``); ``dpatch`` row-major over ``(pf, pt)`` (or ``(pt, pf)``).
"""
from __future__ import annotations

import torch


def _split4(data, pf, pt, swap):
    nb, nf, nt, nch = data.shape
    if swap:
        data = data.transpose(1, 2)  # (nb, nt, nf, nch)
        nf, nt = nt, nf
        pf, pt = pt, pf
    x = data.permute(0, 3, 1, 2)  # (nb, nch, nf, nt)
    x = x.reshape(nb, nch, nf // pf, pf, nt // pt, pt)
    x = x.permute(0, 2, 4, 3, 5, 1)  # (nb, nfb, ntb, pf, pt, nch)
    return x.reshape(nb, (nf // pf) * (nt // pt), pf * pt, nch)


def patch_split(data: torch.Tensor, patch_shape, f_first: bool = False) -> torch.Tensor:
    pf, pt = patch_shape
    if data.ndim == 4:
        return _split4(data, pf, pt, f_first)
    nb, nf, nt, nreim, nmic = data.shape
    out = _split4(data.reshape(nb, nf, nt, nreim * nmic), pf, pt, f_first)
    return out.reshape(nb, out.shape[1], out.shape[2], nreim, nmic)


def _recover4(vec, output_shape, pf, pt, swap):
    nb, npatch, dpatch, nch = vec.shape
    nf, nt = output_shape
    if swap:
        nf, nt = nt, nf
        pf, pt = pt, pf
    x = vec.reshape(nb, nf // pf, nt // pt, pf, pt, nch)
    x = x.permute(0, 5, 1, 3, 2, 4)  # (nb, nch, nfb, pf, ntb, pt)
    x = x.reshape(nb, nch, nf, nt).permute(0, 2, 3, 1)  # (nb, nf, nt, nch)
    if swap:
        x = x.transpose(1, 2)
    return x


def patch_recover(vec: torch.Tensor, output_shape, patch_shape,
                  f_first: bool = False) -> torch.Tensor:
    """Inverse of :func:`patch_split`; ``output_shape`` is ``(nf, nt)``."""
    pf, pt = patch_shape
    if vec.ndim == 4:
        return _recover4(vec, output_shape, pf, pt, f_first)
    nb, npatch, dpatch, nreim, nmic = vec.shape
    out = _recover4(vec.reshape(nb, npatch, dpatch, nreim * nmic),
                    output_shape, pf, pt, f_first)
    return out.reshape(nb, out.shape[1], out.shape[2], nreim, nmic)
