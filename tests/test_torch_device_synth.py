"""The port's on-card synthesizer (``sarssl_torch.data.device_synth``), run on
the CPU, against the JAX package's ``device_synth`` on JAX's draws.

The JAX package draws from keys and the port from a ``torch.Generator``, so
their samples differ by design. These tests rebuild JAX's draws from its keys,
in its split structure (``_sample_scene``'s 8 subkeys, the tail's 2, the
source's 3, ``fold_in(key, 99)`` for the SNR and the white noise), hand them to
the port's deterministic part, and hold the result against JAX's.

Tolerances, in f32 on the CPU: the image positions and amplitudes within 1e-6
of their largest magnitude (pow and meshgrid order); the CTF within 1e-4 of its
largest magnitude (each image's phase reaches ~200 rad at the top bins, where
one f32 ulp of the argument is ~1.5e-5 rad, and the two libraries' cos / sin
round differently there; the one-hot sums run in another order) and
``synth_pair``'s waves within 1e-4 of the peak; the labels within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_torch.data import device_synth as T  # noqa: E402
from sarssl_torch.data.annotations import t60_from_rir  # noqa: E402
from sarssl_torch.data.ism import simulate_rir_single  # noqa: E402
from sarssl_tpu.data import device_synth as J  # noqa: E402

NSAMPLE = 8000  # 0.5 s
CFG_T, CFG_J = T.DeviceSynthConfig(nsample=NSAMPLE), J.DeviceSynthConfig(nsample=NSAMPLE)


def jax_draws(key, cfg):
    """JAX's random inputs of one pair, from its key, as ``synth_pair`` draws them."""
    ks = jax.random.split(key, 8)
    u = jax.random.uniform
    d = {"room": u(ks[0], (3,), minval=jnp.asarray(cfg.room_lo), maxval=jnp.asarray(cfg.room_hi)),
         "t60": u(ks[1], (), minval=cfg.t60_range[0], maxval=cfg.t60_range[1]),
         "center_u": u(ks[2], (3,), minval=0.35, maxval=0.65),
         "mic_dist": u(ks[3], (), minval=cfg.mic_dist_range[0], maxval=cfg.mic_dist_range[1]),
         "theta": u(ks[4], (), minval=0.0, maxval=2 * jnp.pi),
         "src_u": u(ks[5], (3,), minval=0.2, maxval=0.8)}
    k1, k2 = jax.random.split(ks[6])
    d["tail_re"] = jax.random.normal(k1, (2, cfg.n_rir_frames, cfg.nf))
    d["tail_im"] = jax.random.normal(k2, (2, cfg.n_rir_frames, cfg.nf))
    kt, kf, ke = jax.random.split(ks[7], 3)
    d["spec_re"] = jax.random.normal(kt, (cfg.nf, cfg.nt))
    d["spec_im"] = jax.random.normal(kf, (cfg.nf, cfg.nt))
    d["env_u"] = u(ke, ())
    kn = jax.random.fold_in(key, 99)
    d["snr"] = u(jax.random.fold_in(kn, 1), (), minval=cfg.snr_range[0], maxval=cfg.snr_range[1])
    d["white"] = jax.random.normal(kn, (cfg.nsample, 2))
    return d


@pytest.fixture(scope="module")
def batch():
    """Three pairs: their JAX keys and draws, stacked for the port."""
    keys = [jax.random.key(s) for s in (0, 1, 2)]
    ds = [jax_draws(k, CFG_J) for k in keys]
    draws = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in ds])) for k in ds[0]}
    return keys, draws


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_draws_cover_every_random_input():
    d = T.draw_inputs(torch.Generator().manual_seed(0), 3, CFG_T)
    want = jax_draws(jax.random.key(0), CFG_J)
    assert set(d) == set(want)
    for k, v in d.items():
        assert tuple(v.shape) == (3, *np.shape(want[k])) and v.dtype == torch.float32, k


def test_scene_and_images_equal_jax(batch):
    keys, draws = batch
    room, t60, beta, mics, src = T._sample_scene(draws, CFG_T)
    pos, amp = T._images(room, src, beta, CFG_T)
    assert pos.shape == (3, CFG_T.n_images, 3)
    for i, key in enumerate(keys):
        jroom, jt60, jbeta, jmics, jsrc, _, _ = J._sample_scene(key, CFG_J)
        for got, want in ((room, jroom), (t60, jt60), (beta, jbeta), (mics, jmics), (src, jsrc)):
            assert _rel(got[i], want) <= 1e-6
        jpos, jamp = J._images(jroom, jsrc, jbeta, CFG_J)
        assert _rel(pos[i], jpos) <= 1e-6 and _rel(amp[i], jamp) <= 1e-6
        cx, ax = T._axis_images(room[i:i + 1, 2], src[i:i + 1, 2], beta[i:i + 1, 4],
                                beta[i:i + 1, 5], 4)
        jcx, jax_ = J._axis_images(jroom[2], jsrc[2], jbeta[4], jbeta[5], 4)
        assert _rel(cx[0], jcx) <= 1e-6 and _rel(ax[0], jax_) <= 1e-6


def test_ctf_frames_equal_jax(batch):
    keys, draws = batch
    room, t60, beta, mics, src = T._sample_scene(draws, CFG_T)
    H = T.ctf_frames(draws["tail_re"], draws["tail_im"], room, t60, beta, mics, src, CFG_T)
    assert H.shape == (3, 2, CFG_T.n_rir_frames, CFG_T.nf) and H.dtype == torch.complex64
    for i, key in enumerate(keys):
        jroom, jt60, jbeta, jmics, jsrc, knoise, _ = J._sample_scene(key, CFG_J)
        jH = J.ctf_frames(knoise, jroom, jt60, jbeta, jmics, jsrc, CFG_J)
        assert _rel(H[i].numpy(), jH) <= 1e-4


@pytest.mark.parametrize("nsample", [NSAMPLE, 2304], ids=["0.5s", "smoke_length"])
def test_synth_pair_equals_jax_on_jax_draws(batch, nsample):
    cfg_t, cfg_j = T.DeviceSynthConfig(nsample=nsample), J.DeviceSynthConfig(nsample=nsample)
    keys = batch[0]
    ds = [jax_draws(k, cfg_j) for k in keys]
    draws = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in ds])) for k in ds[0]}
    wave, labels = T.synth_pair(draws, cfg_t)
    assert wave.shape == (3, nsample, 2) and wave.dtype == torch.float32
    for i, key in enumerate(keys):
        jw, jl = J.synth_pair(key, cfg_j)
        assert _rel(wave[i].numpy(), jw) <= 1e-4
        for k in ("TDOA", "T60", "SNR"):
            assert abs(float(labels[k][i]) - float(jl[k])) <= 1e-6 * max(1.0, abs(float(jl[k])))


def test_batch_shapes_labels_and_determinism():
    cfg = T.DeviceSynthConfig(nsample=NSAMPLE)
    wave, labels = T.synth_batch_device(torch.Generator().manual_seed(5), 4, cfg, device="cpu")
    assert wave.shape == (4, NSAMPLE, 2) and wave.dtype == torch.float32
    assert torch.isfinite(wave).all()
    np.testing.assert_allclose(wave.abs().amax((1, 2)).numpy(), 0.9, atol=1e-3)
    assert ((labels["T60"] >= 0.2) & (labels["T60"] <= 1.0)).all()
    assert ((labels["SNR"] >= 15) & (labels["SNR"] <= 30)).all()
    assert (labels["TDOA"].abs() <= 0.20 / 343.0 + 1e-9).all()
    again, labels2 = T.synth_batch_device(torch.Generator().manual_seed(5), 4, cfg, device="cpu")
    assert torch.equal(wave, again) and all(torch.equal(labels[k], labels2[k]) for k in labels)
    other, _ = T.synth_batch_device(torch.Generator().manual_seed(6), 4, cfg, device="cpu")
    assert not torch.equal(wave, other)


def test_tdoa_is_observable_by_cross_correlation():
    """The pair's cross-correlation peaks at the labelled TDOA (low T60, high
    SNR, wide pairs: the direct path dominates)."""
    cfg = T.DeviceSynthConfig(nsample=16640, t60_range=(0.2, 0.3), snr_range=(40.0, 40.0),
                              mic_dist_range=(0.15, 0.20))
    wave, labels = T.synth_batch_device(torch.Generator().manual_seed(0), 8, cfg, device="cpu")
    hits, total = 0, 0
    for w, tdoa in zip(wave.numpy(), labels["TDOA"].numpy()):
        want = float(tdoa) * cfg.fs
        if abs(want) < 2.0:  # near broadside an integer-lag peak is ambiguous
            continue
        total += 1
        x0, x1 = w[:, 0] - w[:, 0].mean(), w[:, 1] - w[:, 1].mean()
        corr = np.correlate(x1, x0, "full")
        lag = np.argmax(np.abs(corr)) - (len(x0) - 1)
        hits += abs(lag - want) <= 2.5
    assert total >= 2 and hits >= total - 1, (hits, total)


def _rir_from_ctf(H, cfg):
    """Time-domain RIR from CTF frames: each frame's irfft rolled by a hop
    (its residuals lie within +-hop/2) and overlap-placed at j*hop."""
    nmic, J_, _ = H.shape
    frames = np.roll(np.fft.irfft(H, n=cfg.nfft, axis=-1), cfg.hop, axis=-1)
    rir = np.zeros((nmic, (J_ + 2) * cfg.hop + cfg.nfft))
    for j in range(J_):
        rir[:, j * cfg.hop:j * cfg.hop + cfg.nfft] += frames[:, j]
    return rir[:, cfg.hop:]


def test_edc_t60_matches_spec_and_ism():
    """A RIR rebuilt from the CTF frames decays at the specified T60 under the
    reference's EDC estimator, as the host ISM's RIR of the same scene does."""
    t60 = 0.6
    room, src = np.array([6.0, 5.0, 3.0]), np.array([2.0, 3.1, 1.6])
    mics = np.array([[3.9, 2.45, 1.5], [3.9, 2.55, 1.5]])
    V, S = np.prod(room), 2 * (30.0 + 18.0 + 15.0)
    beta = np.sqrt(1.0 - np.clip(0.161 * V / (S * t60), 0.02, 0.95)) * np.ones(6)
    cfg = T.DeviceSynthConfig()
    g = torch.Generator().manual_seed(0)
    f32 = lambda a: torch.tensor(np.asarray(a)[None], dtype=torch.float32)  # noqa: E731
    shape = (1, 2, cfg.n_rir_frames, cfg.nf)
    H = T.ctf_frames(torch.randn(shape, generator=g), torch.randn(shape, generator=g),
                     f32(room), f32(t60), f32(beta), f32(mics), f32(src), cfg)[0].numpy()
    t60_dev, corr = t60_from_rir(_rir_from_ctf(H, cfg)[0], cfg.fs)
    t60_ism, _ = t60_from_rir(np.array(simulate_rir_single(room, beta, src, mics, cfg.fs, t60)[0],
                                       np.float64), cfg.fs)
    assert abs(corr) > 0.9
    assert abs(t60_dev - t60) < 0.15 * t60 + 0.03, t60_dev
    assert abs(t60_dev - t60_ism) < 0.2 * t60 + 0.03, (t60_dev, t60_ism)


def test_synthesis_needs_its_generator_on_its_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        T.synth_batch_device(torch.Generator(), 2, CFG_T)  # device="cuda" by default
    with pytest.raises(ValueError, match="generator"):
        T.synth_batch_device(torch.Generator(), 2, CFG_T, device="meta")

