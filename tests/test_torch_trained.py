"""The first check of the port on trained weights: the committed epoch-27
flagship checkpoint (``exp/pretrain_r5_ctf_s101/best_model_f16.msgpack``,
params and BatchNorm stats in f16) loaded into both packages at the flagship
widths (spec 512 x 1 layer, spat 256 x 3 layers, 4 heads), at nt = 64 frames
and batch 2 (no parameter's shape depends on nt), the configuration of the
repo's ``PARITY.json``.

The JAX side reads the file with flax and casts it up to f32 as
``scripts/export_ckpt_f16.py`` says a reader must; the port reads it with its
own codec (``train/checkpoint.py``), which casts up on restore. Both run in
f32, eval mode, on the same waves and one replayed mask. The bar is
``PARITY.json``'s 1e-3 (absolute) on the pretext loss and ``diff``, and on
the downstream ``pred`` and ``embed`` after ``partial_load`` of the trunk.
In bf16, the port's prediction error against its own f32 is held to JAX's
(see the last test).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig  # noqa: E402
from sarssl_tpu.ops import FeatureConfig as JFeatureConfig  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask, stft_features as j_stft_features  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask, stft_features  # noqa: E402
from sarssl_torch.train import (create_train_state, make_downstream_eval_step,  # noqa: E402
                                make_pretrain_eval_step, partial_load)
from sarssl_torch.train import checkpoint as ckpt  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "exp", "pretrain_r5_ctf_s101", "best_model_f16.msgpack")
NB, NT = 2, 64
NSAMPLE = (NT - 1) * 256 + 512  # 16640 samples, 1.04 s
TOL = 1e-3  # PARITY.json


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    wave, tdoa = synth_batch(np.random.default_rng(11), NB, NSAMPLE)
    payload = jckpt.load_checkpoint(TRAINED)
    assert payload["meta"]["epoch"] == 27
    variables = {"params": _f32(payload["params"]), "batch_stats": _f32(payload["batch_stats"])}
    feats = j_stft_features(jnp.asarray(wave), JFeatureConfig())
    assert feats.shape == (NB, 2, 256, NT, 2)
    return wave, tdoa, variables, feats


def test_trained_pretext_loss_and_diff_match_jax(setup):
    wave, _, variables, feats = setup
    jcfg = JSARSSLConfig(sig_shape=(256, NT, 2, 2), patch_shape=(256, 1), dtype="float32")
    mask = gen_patch_mask(jax.random.key(4), NB, jcfg.npatch, jcfg.effective_nmasked())
    jloss, jdiff, _ = jax.jit(lambda v, x, m: JSARSSL(jcfg).apply(v, x, m, False))(
        variables, feats, mask)

    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu", seed=5)
    state = ckpt.restore_state(create_train_state(model), ckpt.load_checkpoint(TRAINED),
                               restore_opt=False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tmask = PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                        else torch.tensor(np.asarray(t)).long() for t in mask))
    out = make_pretrain_eval_step(model, FeatureConfig(), device="cpu")(
        state, wave, torch.Generator(), mask=tmask)
    assert abs(out["loss"].item() - float(jloss)) <= TOL, (out["loss"].item(), float(jloss))
    assert abs(out["diff"].item() - float(jdiff)) <= TOL, (out["diff"].item(), float(jdiff))
    assert float(jloss) < float(jdiff)  # trained: it predicts better than copying a channel


def test_trained_downstream_pred_and_embed_match_jax(setup):
    wave, tdoa, variables, feats = setup
    jcfg = JSARSSLConfig(sig_shape=(256, NT, 2, 2), patch_shape=(256, 1), dtype="float32",
                         pretrain=False, downstream_embed="spec_spat")
    jm = JSARSSL(jcfg)
    init = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(3)}, feats, None, False))
    params, loaded = jckpt.partial_load(init["params"], variables["params"])
    assert loaded and not any(k.startswith("head_") for k in loaded)
    jpred, jembed = jax.jit(lambda v, x: jm.apply(v, x, None, False))(
        {"params": params, "batch_stats": init["batch_stats"]}, feats)

    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    p0, b0 = from_jax_params(init)  # the same head and fresh BatchNorm stats
    model.load_state_dict({**p0, **b0}, strict=True)
    trunk, _ = from_jax_params({"params": ckpt.load_checkpoint(TRAINED)["params"]})
    assert sorted(partial_load(model, trunk)) == sorted(
        n for n, _ in model.named_parameters() if not n.startswith("head_"))
    out = make_downstream_eval_step(model, FeatureConfig(), "TDOA", device="cpu")(
        create_train_state(model), wave, tdoa / 16000.0)
    assert float(np.abs(out["pred"].numpy() - np.asarray(jpred)).max()) <= TOL
    assert float(np.abs(out["embed"].numpy() - np.asarray(jembed)).max()) <= TOL


def test_trained_bf16_prediction_error_is_jax_bf16_error(setup):
    """bf16 on trained weights (ROADMAP §3 b at the flagship's depth): the
    port's bf16 prediction moves from its f32 one by as much as JAX's bf16
    moves from JAX's f32, within 1.5x, both as max and as mean |error|
    relative to max / mean |f32| (about 0.1 and 0.06 on these weights: bf16
    keeps 8 bits and the roundings add over the model's depth).
    ``chip_smoke.py`` holds the card's bf16 to the CPU's by the same factor."""
    wave, _, variables, feats = setup
    tx = torch.from_numpy(wave).float()
    preds = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = JSARSSLConfig(sig_shape=(256, NT, 2, 2), patch_shape=(256, 1), dtype=dtype)
        mask = gen_patch_mask(jax.random.key(4), NB, jcfg.npatch, jcfg.effective_nmasked())
        _, _, aux = jax.jit(lambda v, x, m: JSARSSL(jcfg).apply(v, x, m, False))(
            variables, feats, mask)
        preds["jax", dtype] = np.asarray(aux["pred"], np.float32)
        model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
        ckpt.restore_state(create_train_state(model), ckpt.load_checkpoint(TRAINED),
                           restore_opt=False)
        tmask = PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                            else torch.tensor(np.asarray(t)).long() for t in mask))
        model.eval()
        with torch.no_grad():
            _, _, taux = model.pretext(stft_features(tx, FeatureConfig()), tmask, False)
        preds["port", dtype] = taux["pred"].float().numpy()

    def errs(side):
        ref, err = preds[side, "float32"], np.abs(preds[side, "bfloat16"] - preds[side, "float32"])
        return float(err.max() / np.abs(ref).max()), float(err.mean() / np.abs(ref).mean())

    port, jax_ = errs("port"), errs("jax")
    assert all(0 < j <= 0.2 for j in jax_), jax_  # bf16 did round, and modestly
    for p, j in zip(port, jax_):
        assert p <= 1.5 * j, (port, jax_)
