"""Diagnostic plots: TF-domain reconstruction maps and t-SNE embeddings
(port of ``sarssl_tpu/utils/vis.py``).

Equivalents of the reference's vis_time_fre_data / vis_TSNE
(``common/utils.py:293-364``) and the embedding visualisation mode
(``run_downstream.py:482-503``). matplotlib and scikit-learn are optional and
imported at the call: without either, a plot function returns ``None``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def plot_tf_reconstruction(pred_tf: np.ndarray, tar_tf: np.ndarray,
                           mask_tf: Optional[np.ndarray], save_path: str,
                           ch: int = 0) -> Optional[str]:
    """Save |pred| / |tar| / mask magnitude maps for one example.

    pred_tf/tar_tf: (nf, nt, 2, nmic); mask_tf: (nf, nt, nmic) or None.
    """
    plt = _plt()
    if plt is None:
        return None
    mag = lambda x: np.sqrt(x[:, :, 0, ch] ** 2 + x[:, :, 1, ch] ** 2)
    ncol = 3 if mask_tf is not None else 2
    fig, axes = plt.subplots(1, ncol, figsize=(4 * ncol, 4))
    for ax, (title, img) in zip(
            axes, [("target", np.log10(mag(tar_tf) + 1e-6)),
                   ("prediction", np.log10(mag(pred_tf) + 1e-6))]
            + ([("mask", mask_tf[:, :, ch])] if mask_tf is not None else [])):
        im = ax.imshow(img, origin="lower", aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_tsne_embeddings(embeds: np.ndarray, labels: np.ndarray,
                         save_path: str, perplexity: float = 30.0
                         ) -> Optional[str]:
    """2-D t-SNE of downstream embeddings colored by label value."""
    plt = _plt()
    if plt is None:
        return None
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        return None
    xy = TSNE(n_components=2, perplexity=min(perplexity, len(embeds) - 1),
              init="pca", random_state=0).fit_transform(embeds)
    fig, ax = plt.subplots(figsize=(5, 4))
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=labels, s=8, cmap="viridis")
    fig.colorbar(sc, ax=ax)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path
