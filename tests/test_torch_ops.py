"""The port's feature path, patches, pairs and masks against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu import ops as jops  # noqa: E402
from sarssl_torch import ops as tops  # noqa: E402
from sarssl_torch.ops.features import _features_generic  # noqa: E402
from tiny import NSAMPLE  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _waves(nb, nsample, nch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((nb, nsample, nch)).astype(np.float32)


def _feat_pair(**kw):
    return jops.FeatureConfig(**kw), tops.FeatureConfig(**kw)


@pytest.mark.parametrize("kw,nsample", [
    (dict(win_len=128, nfft=128), NSAMPLE),    # tiny profile (FEAT)
    (dict(), 512 * 8 + 256),                   # flagship nfft 512, 2 short waves
])
def test_stft_features_fast_path(kw, nsample):
    jcfg, tcfg = _feat_pair(**kw)
    wave = _waves(2, nsample)
    ref = np.asarray(jops.stft_features(jnp.asarray(wave), jcfg))
    out = tops.stft_features(torch.from_numpy(wave), tcfg).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("nsample", [NSAMPLE, 512 * 8 + 256])
def test_stft_features_generic_path_drops_dc_with_full_mean(nsample):
    """The generic path (separate re/im products, DC drop afterwards) equals
    the JAX fast path: the normaliser includes the DC bin either way."""
    kw = dict(win_len=128, nfft=128) if nsample == NSAMPLE else {}
    jcfg, tcfg = _feat_pair(**kw)
    wave = _waves(2, nsample, seed=1)
    ref = np.asarray(jops.stft_features(jnp.asarray(wave), jcfg))
    out = _features_generic(torch.from_numpy(wave), tcfg).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_stft_features_half_band_and_four_mics():
    jcfg, tcfg = _feat_pair(win_len=128, nfft=128, fre_used_ratio=0.5, ch_mode="MM")
    wave = _waves(2, NSAMPLE, nch=4, seed=2)
    ref = np.asarray(jops.stft_features(jnp.asarray(wave), jcfg))
    out = tops.stft_features(torch.from_numpy(wave), tcfg).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_frame_signal_gather_path():
    x = _waves(1, 1000, nch=3)[0].T.copy()  # nsample not a multiple of hop
    ref = np.asarray(jops.frame_signal(jnp.asarray(x), 128, 48))
    out = tops.frame_signal(torch.from_numpy(x), 128, 48).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("f_first", [False, True])
@pytest.mark.parametrize("ndim", [4, 5])
def test_patch_split_recover_exact(f_first, ndim):
    shape = (2, 8, 6, 2, 2) if ndim == 5 else (2, 8, 6, 3)
    data = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    patch = (4, 2)
    ref = np.asarray(jops.patch_split(jnp.asarray(data), patch, f_first=f_first))
    out = tops.patch_split(torch.from_numpy(data), patch, f_first=f_first)
    np.testing.assert_array_equal(out.numpy(), ref)
    back = tops.patch_recover(out, (8, 6), patch, f_first=f_first).numpy()
    np.testing.assert_array_equal(back, data)
    ref_back = np.asarray(jops.patch_recover(jnp.asarray(ref), (8, 6), patch,
                                             f_first=f_first))
    np.testing.assert_array_equal(back, ref_back)


@pytest.mark.parametrize("mode,nch", [("M", 2), ("M", 4), ("MM", 4), ("1", 3)])
def test_mic_pair_rebatch_exact(mode, nch):
    data = np.random.default_rng(4).standard_normal((3, nch, 5, 2)).astype(np.float32)
    ref = np.asarray(jops.mic_pair_rebatch(jnp.asarray(data), mode))
    out = tops.mic_pair_rebatch(torch.from_numpy(data), mode).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.shape[0] == 3 * tops.num_pairs(nch, mode)


def test_gen_patch_mask_t_mode():
    gen = torch.Generator().manual_seed(0)
    nb, npatch, nmasked = 64, 16, 8
    m = tops.gen_patch_mask(gen, nb, npatch, nmasked, nmic=2)
    assert m.patch.shape == (nb, npatch) and m.patch.dtype == torch.bool
    assert (m.patch.sum(1) == nmasked).all()
    assert m.idx.shape == (nb, nmasked)
    assert (m.idx[:, 1:] > m.idx[:, :-1]).all()  # sorted, distinct
    assert torch.equal(torch.gather(m.patch, 1, m.idx), torch.ones_like(m.idx, dtype=torch.bool))
    assert set(m.ch.tolist()) == {0, 1}
    again = tops.gen_patch_mask(torch.Generator().manual_seed(0), nb, npatch, nmasked)
    assert all(torch.equal(a, b) for a, b in zip(m, again))

