"""The pre-training CLI's model options in the port against the JAX package:
mel and ``fft`` features (``ops/features.py``), the ``frozen_encoder_pretext``
forward, ``make_pretrain_step(..., trainable_mask=...)``, and
``run_pretrain --mel-bins`` / ``--pretrain-frozen-encoder``. Every input is
made from a numpy seed; weights go from flax's init through
``from_jax_params``.

Tolerances (f32 on both sides): features and filterbanks within 1e-5 of the
largest magnitude; forwards and BatchNorm stats rtol 1e-4 / atol 1e-5 (the
sums run in another order); frozen parameters bit-identical. The trained
parameters after one Adam step: Adam's first update is lr * g / (|g| + eps),
about lr * sign(g), so an element whose exact gradient is ~0 moves by up to
lr either way on each side; every element within 2 * lr, and all but 0.1%
of them within 1e-5.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_torch.cli.run_pretrain import main  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask, stft_features  # noqa: E402
from sarssl_torch.ops.features import mel_filterbank  # noqa: E402
from sarssl_torch.train import checkpoint as ckpt  # noqa: E402
from sarssl_torch.train import create_train_state, make_pretrain_step  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params, to_jax_params  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig  # noqa: E402
from sarssl_tpu.ops import FeatureConfig as JFeatureConfig  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.ops import stft_features as j_stft_features  # noqa: E402
from sarssl_tpu.ops.features import mel_filterbank as j_mel_filterbank  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_pretrain_step as j_pretrain_step  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
NB = 4
NF, NT = 256, 8  # the smoke model: 2304 samples -> 8 frames of 256 bins


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _waves(nb, nsample, seed=0):
    return np.random.default_rng(seed).standard_normal((nb, nsample, 2)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in mask))


def _port_model(jcfg, variables):
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    params, buffers = from_jax_params(_np_tree(variables))
    model.load_state_dict({**params, **buffers}, strict=True)
    return model


# -------------------------------------------------------------- features


@pytest.mark.parametrize("n_mels,n_freqs", [(30, 257), (8, 65)])
def test_mel_filterbank_matches_jax(n_mels, n_freqs):
    fb = mel_filterbank(n_mels, n_freqs, 16000)
    ref = np.asarray(j_mel_filterbank(n_mels, n_freqs, 16000))
    assert fb.shape == (n_mels, n_freqs) and fb.dtype == torch.float32
    _close(fb.numpy(), ref)


FEATURE_OPTIONS = [
    dict(mel_bins=30), dict(win_len=128, nfft=128, mel_bins=8),
    dict(stft_impl="fft"), dict(win_len=128, nfft=128, stft_impl="fft"),
    dict(stft_impl="fft", mel_bins=30), dict(stft_impl="fft", fre_used_ratio=0.5),
    dict(ch_mode="MM", stft_impl="fft", mel_bins=30),
]


@pytest.mark.parametrize("kw", FEATURE_OPTIONS,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items()) for kw in FEATURE_OPTIONS])
def test_stft_features_options_match_jax(kw):
    nfft = kw.get("nfft", 512)
    nch = 3 if kw.get("ch_mode") == "MM" else 2
    wave = np.random.default_rng(1).standard_normal((2, nfft * 8, nch)).astype(np.float32)
    ref = np.asarray(j_stft_features(jnp.asarray(wave), JFeatureConfig(**kw)))
    out = stft_features(torch.from_numpy(wave), FeatureConfig(**kw))
    assert out.shape == ref.shape and out.shape[2] == FeatureConfig(**kw).nf_used
    _close(out.numpy(), ref)


# ----------------------------------------------------------------- models


def _tiny_jax(**kw):
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, **kw})
    nf, nt, nreim, nmic = jcfg.sig_shape
    jm = JSARSSL(jcfg)
    mask = gen_patch_mask(jax.random.key(0), NB, jcfg.npatch, jcfg.effective_nmasked())
    variables = jm.init(jax.random.key(1), jnp.zeros((NB, nmic, nf, nt, nreim)), mask, False)
    return jcfg, jm, variables, mask


@pytest.mark.parametrize("sig_shape", [(64, 8, 2, 2), (30, 8, 2, 2)], ids=["linear", "mel30"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_frozen_encoder_pretext_matches_jax(sig_shape, train):
    """The spec encoder sees only the masked frames of the kept channel; on
    the 64-bin tiny input and on 30 mel bands."""
    jcfg, jm, variables, mask = _tiny_jax(frozen_encoder_pretext=True, sig_shape=sig_shape,
                                          patch_shape=(sig_shape[0], 1))
    x = np.random.default_rng(2).standard_normal((NB, 2, sig_shape[0], 8, 2)).astype(np.float32)
    tm = _port_model(jcfg, variables)
    if train:
        (loss, diff, aux), mut = jm.apply(variables, jnp.asarray(x), mask, True,
                                          mutable=["batch_stats"])
    else:
        loss, diff, aux = jm.apply(variables, jnp.asarray(x), mask, False)
    tl, td, taux = tm.pretext(torch.from_numpy(x), _torch_mask(mask), train)
    np.testing.assert_allclose(tl.item(), float(loss), **TOL)
    np.testing.assert_allclose(td.item(), float(diff), **TOL)
    np.testing.assert_allclose(taux["pred"].detach().numpy(), np.asarray(aux["pred"]), **TOL)
    if train:
        _, ref = from_jax_params({"params": {}, "batch_stats": _np_tree(mut["batch_stats"])})
        got = dict(tm.named_buffers())
        for name, r in ref.items():
            np.testing.assert_allclose(got[name].numpy(), r.numpy(), err_msg=name, **TOL)
    # the option changes the input: without it the spec encoder also sees the
    # unmasked frames of the masked channel
    plain = _port_model(type(jcfg)(**{**jcfg.__dict__, "frozen_encoder_pretext": False}),
                        variables)
    assert not torch.allclose(plain.pretext(torch.from_numpy(x), _torch_mask(mask), False)[0],
                              tm.pretext(torch.from_numpy(x), _torch_mask(mask), False)[0])


# ------------------------------------------------------------------ steps


def _decoder_only(params):
    return jax.tree_util.tree_map_with_path(lambda path, _: path[0].key == "decoder", params)


@pytest.fixture(scope="module")
def masked_step():
    """One frozen-encoder pretrain step in both packages from the same flax
    init, dropout 0, the mask replayed into the port."""
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "frozen_encoder_pretext": True})
    nf, nt, nreim, nmic = jcfg.sig_shape
    from sarssl_torch.data.synthetic import synth_batch
    wave, _ = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    jm = JSARSSL(jcfg)
    mask0 = gen_patch_mask(jax.random.key(0), NB, jcfg.npatch, jcfg.effective_nmasked())
    jstate = j_create_state(jm, jax.random.key(1), jnp.zeros((NB, nmic, nf, nt, nreim)), mask0)
    variables0 = _np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
    tmask_tree = _decoder_only(jstate.params)
    jstep = j_pretrain_step(jm, FEAT, donate=False, trainable_mask=tmask_tree)
    key = jax.random.key(2)
    jstate1, jm1 = jstep(jstate, jnp.asarray(wave), LR, key)
    rng_mask, _ = jax.random.split(key)
    mask = gen_patch_mask(rng_mask, NB, jcfg.npatch, jcfg.effective_nmasked(), nmic=2, mode="T")

    model = _port_model(jcfg, variables0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    model.spec_encoder.register_forward_hook(lambda m, i, o: seen.append(o.requires_grad))
    trainable = {n: n.startswith("decoder.") for n in before}
    state = create_train_state(model, lr=LR)
    step = make_pretrain_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                              device="cpu", trainable_mask=trainable)
    tm1 = step(state, wave, LR, torch.Generator().manual_seed(0), mask=_torch_mask(mask))
    return dict(jstate=jstate1, jm=jm1, state=state, tm=tm1, before=before,
                trainable=trainable, seen=seen, jfrozen=_np_tree(jstate.params))


def test_masked_step_loss_matches_jax(masked_step):
    for k in ("loss", "diff"):
        np.testing.assert_allclose(masked_step["tm"][k].item(), float(masked_step["jm"][k]),
                                   rtol=1e-4)


def test_masked_step_keeps_frozen_leaves_bit_identical(masked_step):
    model, before = masked_step["state"].model, masked_step["before"]
    jparams, _ = from_jax_params(_np_tree({"params": masked_step["jstate"].params}))
    for n, p in model.named_parameters():
        if not masked_step["trainable"][n]:
            assert torch.equal(p.detach(), before[n]), n
            assert torch.equal(jparams[n], before[n]), n  # JAX's too
    # no gradient reached a frozen encoder: autograd never ran its backward
    assert masked_step["seen"] == [False]


def test_masked_step_trains_the_decoder_as_jax(masked_step):
    model = masked_step["state"].model
    ref, _ = from_jax_params(_np_tree({"params": masked_step["jstate"].params}))
    n_far = n_all = 0
    for n, p in model.named_parameters():
        if masked_step["trainable"][n]:
            assert not torch.equal(p.detach(), masked_step["before"][n]), n
            diff = np.abs(p.detach().numpy() - ref[n].numpy())
            assert diff.max() <= 2 * LR, (n, diff.max())
            n_far += int((diff > 1e-5).sum())
            n_all += diff.size
    assert n_all and n_far <= 1e-3 * n_all, (n_far, n_all)


def test_masked_step_moves_batch_stats_as_jax(masked_step):
    _, ref = from_jax_params({"params": {}, "batch_stats":
                              _np_tree(masked_step["jstate"].batch_stats)})
    got = dict(masked_step["state"].model.named_buffers())
    assert ref and set(ref) == set(got)
    for n, r in ref.items():
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), err_msg=n, **TOL)


def test_masked_step_leaves_frozen_moments_at_zero(masked_step):
    opt = masked_step["state"].optimizer
    for n, mu, nu in zip(opt.names, opt.mu, opt.nu):
        frozen = not masked_step["trainable"][n]
        assert (not mu.any() and not nu.any()) == frozen, n


def test_masked_step_puts_frozen_values_back_under_restored_moments():
    """Moments restored non-zero would move a frozen parameter: the step
    puts its value back, bit for bit, while the decoder moves."""
    cfg = SARSSLConfig(**{**CFG.__dict__, "frozen_encoder_pretext": True})
    model = SARSSL(cfg, device="cpu", seed=1)
    state = create_train_state(model, lr=LR)
    rng = np.random.default_rng(1)
    for i, p in enumerate(state.optimizer.params):
        state.optimizer.mu[i].copy_(torch.tensor(rng.standard_normal(p.shape) * 1e-3))
        state.optimizer.nu[i].copy_(torch.tensor(rng.random(p.shape) * 1e-6))
    state.optimizer.count = 5
    trainable = {n: n.startswith("decoder.") for n, _ in model.named_parameters()}
    step = make_pretrain_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                              device="cpu", trainable_mask=trainable)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    from sarssl_torch.data.synthetic import synth_batch
    wave, _ = synth_batch(np.random.default_rng(3), NB, NSAMPLE)
    for _ in range(2):
        step(state, wave, LR, torch.Generator().manual_seed(0))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) != trainable[n], n
    with pytest.raises(ValueError, match="every parameter"):
        make_pretrain_step(model, device="cpu", trainable_mask={"decoder.proj0.weight": True})


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def jax_init_dir(tmp_path_factory):
    """A JAX pretext state of the smoke model, saved by the JAX package as
    ``best_model`` (f32)."""
    jcfg = JSARSSLConfig(dtype="float32").tiny(sig_shape=(NF, NT, 2, 2), patch_shape=(NF, 1),
                                               spec_dembed=32, spat_dembed=16)
    mask = gen_patch_mask(jax.random.key(0), 2, jcfg.npatch, jcfg.effective_nmasked())
    state = j_create_state(JSARSSL(jcfg), jax.random.key(7), jnp.zeros((2, 2, NF, NT, 2)), mask)
    d = tmp_path_factory.mktemp("jax_init")
    jckpt.save_checkpoint(str(d), state, 5, -1.0, is_best=True)
    return str(d), len(jax.tree.leaves(state.params))


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(tree[k])


def test_frozen_encoder_cli_keeps_the_loaded_encoders(jax_init_dir, tmp_path, capsys):
    src, n = jax_init_dir
    argv = ["--smoke", "--cpu", "--epochs", "1", "--pretrain-frozen-encoder", "--init-ckpt", src,
            "--exp-dir", str(tmp_path)]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert f"partial_load: {n}/{n} keys loaded" in out and "SMOKE PASS" in out
    init = jckpt.load_checkpoint(jckpt.best_path(src))
    saved = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path / "checkpoints")))
    adam = saved["opt_state"]["inner_state"]["0"]["0"]
    moments = {k: dict(_leaves(adam[k])) for k in ("mu", "nu")}
    got, want = dict(_leaves(saved["params"])), dict(_leaves(init["params"]))
    assert set(got) == set(want) and len(got) == n
    n_frozen = 0
    for name, value in got.items():
        if name.startswith("decoder"):
            assert not np.array_equal(value, want[name]), name
            assert moments["mu"][name].any() and moments["nu"][name].any(), name
        else:
            np.testing.assert_array_equal(value, want[name], err_msg=name)
            assert not moments["mu"][name].any() and not moments["nu"][name].any(), name
            n_frozen += 1
    assert 0 < n_frozen < n
    # the encoders' BatchNorm running stats still move (JAX replaces all of them)
    fresh = dict(_leaves(to_jax_params(SARSSL(SARSSLConfig(dtype="float32").tiny(
        sig_shape=(NF, NT, 2, 2), patch_shape=(NF, 1), spec_dembed=32, spat_dembed=16),
        device="cpu"))["batch_stats"]))
    stats = dict(_leaves(saved["batch_stats"]))
    assert stats and all(not np.array_equal(v, fresh[k]) for k, v in stats.items())


def test_frozen_encoder_cli_without_init_ckpt_trains_every_parameter(tmp_path, capsys):
    argv = ["--smoke", "--cpu", "--epochs", "1", "--pretrain-frozen-encoder",
            "--exp-dir", str(tmp_path)]
    assert main(argv) == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    saved = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path / "checkpoints")))
    adam = saved["opt_state"]["inner_state"]["0"]["0"]
    assert all(v.any() for _, v in _leaves(adam["mu"]))  # nothing frozen


def test_mel_bins_smoke_passes(tmp_path, capsys):
    assert main(["--smoke", "--cpu", "--mel-bins", "8", "--exp-dir", str(tmp_path)]) == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["mel_bins"] == 8
    saved = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path / "checkpoints")))
    # the decoder predicts a (8, 1) patch x re/im x 2 mics per frame
    assert np.asarray(saved["params"]["decoder"]["proj1"]["kernel"]).shape[-1] == 8 * 2 * 2
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "best_model.msgpack", "latest_model.msgpack", "model0.msgpack", "model1.msgpack"]
