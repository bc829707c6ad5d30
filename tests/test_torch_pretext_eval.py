"""The port's pretext evaluation against the JAX package: ``ops/stft.py``
(``stft`` in both implementations, ``overlap_add``, ``istft``),
``train/pretext_eval.py``, ``utils/pesq.py``, ``data/wavio.py``,
``utils/vis.py``, ``run_pretrain --test`` and ``run_downstream --ds-test-mode
vis_embed``. Every input is made from a numpy seed.

Tolerances (f32 on both sides): spectra and waveforms within 1e-5 of the
largest magnitude (the ISTFT where two or more frames overlap: see its
test); the STFT -> ISTFT round trip within 1e-5 of the largest sample there;
the MSEs within 1e-5 relative; PESQ, host numpy on the reconstructed
waveforms, within 1e-4 absolute (within 1e-12 on the same input);
``write_wav``'s bytes identical; the t-SNE inputs within 1e-4 relative
(embeddings of the same weights) and the labels equal.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.io import loadmat, wavfile  # noqa: E402

import sarssl_torch.ops as tops_pkg  # noqa: E402
import sarssl_tpu.ops as jops_pkg  # noqa: E402
from sarssl_torch.cli.run_downstream import main as ds_main  # noqa: E402
from sarssl_torch.cli.run_pretrain import main  # noqa: E402
from sarssl_torch.data import wavio  # noqa: E402
from sarssl_torch.ops import PatchMask  # noqa: E402
from sarssl_torch.ops.stft import istft, overlap_add, stft  # noqa: E402
from sarssl_torch.train import pretext_eval  # noqa: E402
from sarssl_torch.utils import pesq, vis  # noqa: E402
from sarssl_tpu.cli.run_downstream import main as j_ds_main  # noqa: E402
from sarssl_tpu.cli.run_pretrain import main as j_main  # noqa: E402
from sarssl_tpu.data import wavio as jwavio  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig  # noqa: E402
from sarssl_tpu.ops.mask import PatchMask as JPatchMask  # noqa: E402
from sarssl_tpu.ops.stft import istft as j_istft  # noqa: E402
from sarssl_tpu.ops.stft import overlap_add as j_overlap_add  # noqa: E402
from sarssl_tpu.ops.stft import stft as j_stft  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import pretext_eval as jpretext_eval  # noqa: E402
from sarssl_tpu.utils import pesq as jpesq  # noqa: E402
from sarssl_tpu.utils import vis as jvis  # noqa: E402

TOL = 1e-5
NF, NT = 256, 8  # the smoke model: 2304 samples -> 8 frames of 256 bins
DUMPS = ["ins_0.mat", "ins_1.mat", "ins_2.mat", "ins_3.mat", "metrics.json", "pred0.wav",
         "recon_tf.png", "tar0.wav"]


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _rng(seed):
    return np.random.default_rng(seed)


def _waves(nb, nsample, seed=0):
    return _rng(seed).standard_normal((nb, nsample, 2)).astype(np.float32)


def _spec(nb, nf, nt, nch, seed=1):
    r = _rng(seed)
    return (r.standard_normal((nb, nf, nt, nch))
            + 1j * r.standard_normal((nb, nf, nt, nch))).astype(np.complex64)


# ------------------------------------------------------------------ stft


STFT_CFGS = [(512, 0.5, 512, 512 * 8 + 256), (128, 0.25, 128, 1000), (96, 0.5, 128, 960)]


@pytest.mark.parametrize("impl", ["matmul", "fft"])
@pytest.mark.parametrize("win_len,ratio,nfft,nsample", STFT_CFGS,
                         ids=["flagship", "quarter_hop", "win_below_nfft"])
def test_stft_matches_jax(impl, win_len, ratio, nfft, nsample):
    wave = _waves(2, nsample)
    ref = np.asarray(j_stft(jnp.asarray(wave), win_len, ratio, nfft, impl=impl))
    out = stft(torch.from_numpy(wave), win_len, ratio, nfft, impl=impl)
    assert out.dtype == torch.complex64
    _close(out.numpy(), ref)


@pytest.mark.parametrize("win_len,hop", [(64, 32), (64, 16), (60, 25)],
                         ids=["two_halves", "quarter_hop", "generic"])
def test_overlap_add_matches_jax(win_len, hop):
    frames = _rng(2).standard_normal((2, 3, 7, win_len)).astype(np.float32)
    ref = np.asarray(j_overlap_add(jnp.asarray(frames), hop))
    out = overlap_add(torch.from_numpy(frames), hop).numpy()
    assert out.shape == ((2, 3, 6 * hop + win_len))
    _close(out, ref)


@pytest.mark.parametrize("win_len,ratio,nfft", [(512, 0.5, 512), (128, 0.25, 128)],
                         ids=["two_halves", "quarter_hop"])
def test_istft_matches_jax_and_its_numpy_mirror(win_len, ratio, nfft):
    """On an STFT of a signal and on a random spectrum, where two or more
    frames overlap. At the ends one frame's window vanishes and the envelope
    division amplifies each side's f32 irfft rounding by 1/win (up to 2.6e4
    at the second sample); JAX's ``istft`` also takes its window in f32,
    where ``1 - cos`` loses up to 1e-3 of itself there."""
    hop = int(win_len * ratio)
    wave = _waves(2, 8 * hop + win_len, seed=12)
    overlap = slice(win_len - hop, -(win_len - hop))
    for spec in (np.asarray(j_stft(jnp.asarray(wave), win_len, ratio, nfft)),
                 _spec(2, nfft // 2 + 1, 9, 2)):
        out = istft(torch.from_numpy(spec.copy()), win_len, ratio, nfft).numpy()
        for ref in (np.asarray(j_istft(jnp.asarray(spec), win_len, ratio, nfft)),
                    jpretext_eval._istft_np(spec, win_len, ratio, nfft)):
            assert out.shape == ref.shape
            _close(out[:, overlap], ref[:, overlap])


@pytest.mark.parametrize("impl", ["matmul", "fft"])
def test_stft_istft_round_trip_is_exact_in_the_interior(impl):
    wave = _waves(2, 512 * 8 + 256)
    back = istft(stft(torch.from_numpy(wave), impl=impl)).numpy()
    assert back.shape == wave.shape  # 17 frames of hop 256 cover every sample
    _close(back[:, 256:-256], wave[:, 256:-256])  # every sample two frames cover


# ------------------------------------------------------- pretext metrics


def test_reconstruct_waveforms_matches_jax():
    grid = _rng(3).standard_normal((2, NF, 12, 2, 2)).astype(np.float32)
    out = pretext_eval.reconstruct_waveforms(torch.from_numpy(grid)).numpy()
    ref = jpretext_eval.reconstruct_waveforms(grid)
    assert out.shape == (2, 11 * 256 + 512, 2)
    _close(out, ref)
    assert np.abs(out).max() == pytest.approx(1.0)


def _aux(patch_shape, nt=16, nb=2, seed=4):
    """The same pretext aux in both packages: random prediction and target
    patches (the target a noisy copy of the prediction) and a 'T'-style mask."""
    r = _rng(seed)
    npatch = (NF // patch_shape[0]) * (nt // patch_shape[1])
    dpatch = patch_shape[0] * patch_shape[1]
    tar = r.standard_normal((nb, npatch, dpatch, 2, 2)).astype(np.float32)
    pred = (tar + 0.3 * r.standard_normal(tar.shape)).astype(np.float32)
    idx = np.sort(np.stack([r.permutation(npatch)[:npatch // 2] for _ in range(nb)]), axis=1)
    patch = np.zeros((nb, npatch), bool)
    np.put_along_axis(patch, idx, True, axis=1)
    ch = np.array([0, 1][:nb])
    jaux = {"pred": jnp.asarray(pred), "tar": jnp.asarray(tar),
            "mask": JPatchMask(jnp.asarray(patch), jnp.asarray(ch, jnp.int32),
                               jnp.asarray(idx, jnp.int32))}
    taux = {"pred": torch.from_numpy(pred), "tar": torch.from_numpy(tar),
            "mask": PatchMask(torch.from_numpy(patch), torch.from_numpy(ch).long(),
                              torch.from_numpy(idx).long())}
    return jaux, taux, (NF, nt, 2, 2)


@pytest.mark.parametrize("patch_shape", [(NF, 1), (16, 4)], ids=["full_height", "f_first"])
def test_pretext_metrics_match_jax_key_for_key(patch_shape):
    jaux, taux, sig_shape = _aux(patch_shape)
    ref = jpretext_eval.pretext_metrics(jaux, sig_shape, patch_shape, compute_pesq=True)
    out = pretext_eval.pretext_metrics(taux, sig_shape, patch_shape, compute_pesq=True)
    assert set(out) == set(ref) == {"mse", "mse_mask", "mse_mask_ch", "pesq", "pesq_mask_ch",
                                    "sig_pred", "sig_tar", "mask_dense", "pred_tf", "tar_tf"}
    for k in ("mse", "mse_mask", "mse_mask_ch"):
        assert isinstance(out[k], float)
        np.testing.assert_allclose(out[k], ref[k], rtol=TOL, err_msg=k)
    for k in ("sig_pred", "sig_tar"):
        _close(out[k], ref[k])
    for k in ("pred_tf", "tar_tf"):
        _close(out[k], ref[k])
    np.testing.assert_array_equal(out["mask_dense"], ref["mask_dense"])
    for k in ("pesq", "pesq_mask_ch"):
        assert np.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=k)


def test_pretext_metrics_without_pesq_gives_nan():
    jaux, taux, sig_shape = _aux((NF, 1))
    out = pretext_eval.pretext_metrics(taux, sig_shape, (NF, 1))
    ref = jpretext_eval.pretext_metrics(jaux, sig_shape, (NF, 1))
    assert out["pesq"].shape == ref["pesq"].shape == (2, 2)
    assert np.isnan(out["pesq"]).all() and np.isnan(out["pesq_mask_ch"]).all()


# ------------------------------------------------------------------ pesq


def _speech_like(n, seed=5):
    """Harmonic bursts with a syllable-rate envelope, 16 kHz."""
    t = np.arange(n) / 16000.0
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000.0) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t), 0, None) ** 2
    return (x * env + 1e-3 * _rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 30.0])
def test_pesq_matches_jax(snr_db):
    ref = _speech_like(32000)
    noise = _rng(6).standard_normal(ref.shape).astype(np.float32)
    deg = ref + noise * np.sqrt(np.mean(ref ** 2) / np.mean(noise ** 2) / 10 ** (snr_db / 10))
    got = pesq.pesq_wb(ref, deg, 16000)
    assert 1.0 <= got <= 4.644
    assert got == pytest.approx(jpesq.pesq_wb(ref, deg, 16000), abs=1e-12)


def test_pesq_of_identity_is_the_ceiling_and_falls_with_noise():
    ref = _speech_like(32000)
    # no disturbance: the raw score 4.5 through the P.862.2 mapping
    ceiling = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * 4.5 + 3.8224))
    assert pesq.pesq_wb(ref, ref) == jpesq.pesq_wb(ref, ref) == pytest.approx(ceiling, abs=1e-12)
    noisy = ref + 0.3 * _rng(7).standard_normal(ref.shape).astype(np.float32)
    assert pesq.pesq_wb(ref, noisy) < 4.0


# ----------------------------------------------------------------- wavio


def test_write_wav_bytes_equal_jax(tmp_path):
    data = _rng(8).uniform(-1, 1, (1000, 2)).astype(np.float64)
    wavio.write_wav(str(tmp_path / "port.wav"), data, 16000)
    jwavio.write_wav(str(tmp_path / "jax.wav"), data, 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_wav_readers_equal_jax(dtype, tmp_path):
    path = str(tmp_path / "x.wav")
    data = _rng(9).uniform(-0.9, 0.9, (1000, 3)).astype(np.float32)
    if dtype == "int16":
        wavfile.write(path, 8000, (data * 32767).astype(np.int16))
    else:
        wavio.write_wav(path, data, 8000)
    info, jinfo = wavio.audio_info(path), jwavio.audio_info(path)
    assert (info.frames, info.fs, info.channels, info.sampwidth, info.audio_format,
            info.data_offset) == (jinfo.frames, jinfo.fs, jinfo.channels, jinfo.sampwidth,
                                  jinfo.audio_format, jinfo.data_offset)
    assert (info.frames, info.fs, info.channels) == (1000, 8000, 3)
    for got, want in ((wavio.read_wav(path), jwavio.read_wav(path)),
                      (wavio.read_audio(path), jwavio.read_audio(path)),
                      (wavio.read_audio(path, 100, 250), jwavio.read_audio(path, 100, 250))):
        assert got[1] == want[1] == 8000
        np.testing.assert_array_equal(got[0], want[0])
    assert wavio.read_audio(path, 100, 250)[0].shape == (150, 3)
    if dtype == "float32":
        np.testing.assert_array_equal(wavio.read_wav(path)[0], data)


# ------------------------------------------------------------------- vis


def test_plots_write_pngs(tmp_path):
    grid = _rng(10).standard_normal((2, 32, 16, 2, 2)).astype(np.float32)
    png = str(tmp_path / "tf" / "recon.png")
    assert vis.plot_tf_reconstruction(grid[0], grid[1], np.ones((32, 16, 2)), png) == png
    emb, lab = _rng(11).standard_normal((20, 6)), np.arange(20.0)
    tsne = str(tmp_path / "tsne.png")
    assert vis.plot_tsne_embeddings(emb, lab, tsne) == tsne
    for f in (png, tsne):
        with open(f, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_return_none_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(vis, "_plt", lambda: None)
    monkeypatch.setattr(jvis, "_plt", lambda: None)
    grid = np.zeros((32, 16, 2, 2), np.float32)
    for mod in (vis, jvis):
        assert mod.plot_tf_reconstruction(grid, grid, None, str(tmp_path / "a.png")) is None
        assert mod.plot_tsne_embeddings(np.zeros((5, 3)), np.zeros(5),
                                        str(tmp_path / "b.png")) is None
    assert not os.listdir(tmp_path)


# ------------------------------------------------------- run_pretrain --test


def _jax_state(pretrain=True):
    """A JAX state of the smoke model (pretext, or the downstream one)."""
    jcfg = JSARSSLConfig(dtype="float32", pretrain=pretrain).tiny(
        sig_shape=(NF, NT, 2, 2), patch_shape=(NF, 1), spec_dembed=32, spat_dembed=16,
        pretrain=pretrain)
    from sarssl_tpu.ops import gen_patch_mask
    mask = (gen_patch_mask(jax.random.key(0), 4, jcfg.npatch, jcfg.effective_nmasked())
            if pretrain else None)
    return j_create_state(JSARSSL(jcfg), jax.random.key(7), jnp.zeros((4, 2, NF, NT, 2)), mask)


@pytest.fixture(scope="module")
def test_runs(tmp_path_factory):
    """``--smoke --test`` through both CLIs on one JAX-written ``best_model``,
    each package's ``gen_patch_mask`` replaced by the same two masks."""
    root = tmp_path_factory.mktemp("pretext_test")
    state = _jax_state()
    exps = {k: root / k for k in ("jax", "port")}
    for d in exps.values():
        jckpt.save_checkpoint(str(d / "checkpoints"), state, 3, -1.0, is_best=True)
    gen = torch.Generator().manual_seed(5)
    masks = [tops_pkg.gen_patch_mask(gen, 4, NT, NT // 2) for _ in range(2)]
    calls = {"jax": 0, "port": 0}
    k0 = np.asarray(jax.random.key_data(jax.random.key(0)))
    j_orig = jops_pkg.gen_patch_mask

    def j_fake(key, nb, npatch, nmasked, *a, **k):
        if np.array_equal(np.asarray(jax.random.key_data(key)), k0):  # the init's shape probe
            return j_orig(key, nb, npatch, nmasked, *a, **k)
        m = masks[calls["jax"]]
        calls["jax"] += 1
        return JPatchMask(jnp.asarray(m.patch.numpy()), jnp.asarray(m.ch.numpy(), jnp.int32),
                          jnp.asarray(m.idx.numpy(), jnp.int32))

    def t_fake(generator, nb, npatch, nmasked, nmic=2, device=None, **k):
        assert isinstance(generator, torch.Generator) and (nb, npatch, nmasked) == (4, NT, NT // 2)
        m = masks[calls["port"]]
        calls["port"] += 1
        return m if device is None else m.to(device)

    printed = {}
    import contextlib
    import io
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops_pkg, "gen_patch_mask", j_fake)
        mp.setattr(tops_pkg, "gen_patch_mask", t_fake)
        for name, fn, extra in (("jax", j_main, []), ("port", main, ["--cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert fn(["--smoke", "--test", "--exp-dir", str(exps[name])] + extra) == 0
            printed[name] = buf.getvalue()
    assert calls == {"jax": 2, "port": 2}
    return exps, printed


def test_pretext_test_metrics_match_jax(test_runs):
    exps, printed = test_runs
    got, want = (json.load(open(exps[p] / "test_dumps" / "metrics.json"))
                 for p in ("port", "jax"))
    assert set(got) == set(want) == {"mse", "mse_mask", "pesq", "pesq_mask_ch"}
    for k in ("mse", "mse_mask"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    for k in ("pesq", "pesq_mask_ch"):
        assert 1.0 <= got[k] <= 4.644
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    for name in ("port", "jax"):
        assert "loaded best checkpoint (epoch 3)" in printed[name]
        assert "pretext test: mse " in printed[name]


def test_pretext_test_dumps_match_jax(test_runs):
    exps, _ = test_runs
    dumps = {p: exps[p] / "test_dumps" for p in exps}
    assert sorted(os.listdir(dumps["port"])) == sorted(os.listdir(dumps["jax"])) == DUMPS
    for f in ("pred0.wav", "tar0.wav"):
        (fs, got), (jfs, want) = (wavfile.read(dumps[p] / f) for p in ("port", "jax"))
        assert fs == jfs == 16000 and got.dtype == want.dtype == np.float32
        _close(got, want)
    for i in range(4):
        got, want = (loadmat(str(dumps[p] / f"ins_{i}.mat")) for p in ("port", "jax"))
        for k in ("mask", "pred", "tar"):
            _close(got[k], want[k])
        np.testing.assert_allclose(got["pesq"], want["pesq"], rtol=0, atol=1e-4)


def test_pretext_test_writes_config_test_beside_the_run(test_runs):
    exps, _ = test_runs
    for p in exps:
        assert (exps[p] / "config_test.json").exists() and not (exps[p] / "config.json").exists()
    got, want = (json.load(open(exps[p] / "config_test.json")) for p in ("port", "jax"))
    assert set(got) == set(want) and got["test"] and got["exp_dir"] == str(exps["port"])


# ----------------------------------------- run_downstream --ds-test-mode vis_embed


def test_vis_embed_gives_plot_tsne_the_jax_inputs(tmp_path):
    """Both CLIs' t-SNE inputs from one JAX-written downstream checkpoint."""
    ck = tmp_path / "ck"
    jckpt.save_checkpoint(str(ck), _jax_state(pretrain=False), 0, -1.0, is_best=True)
    seen = {}

    def catch(name):
        def fake(embeds, labels, save_path, perplexity=30.0):
            seen[name] = (np.asarray(embeds), np.asarray(labels), save_path)
            return save_path
        return fake

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvis, "plot_tsne_embeddings", catch("jax"))
        mp.setattr(vis, "plot_tsne_embeddings", catch("port"))
        for name, fn, extra in (("jax", j_ds_main, []), ("port", ds_main, ["--cpu"])):
            assert fn(["--smoke", "--ds-test", "--ds-test-mode", "vis_embed", "--ckpt", str(ck),
                       "--exp-dir", str(tmp_path / name)] + extra) == 0
    (emb, lab, path), (jemb, jlab, jpath) = seen["port"], seen["jax"]
    assert emb.shape == jemb.shape == (8, 48) and np.isfinite(emb).all()  # 8 test rows, 32 + 16
    np.testing.assert_allclose(emb, jemb, rtol=1e-4, atol=1e-4 * np.abs(jemb).max())
    np.testing.assert_array_equal(lab, jlab)
    assert path == str(tmp_path / "port" / "tsne.png")
    assert jpath == str(tmp_path / "jax" / "tsne.png")
