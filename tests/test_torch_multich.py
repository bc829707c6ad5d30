"""The port's multi-pair downstream path against ``sarssl_tpu``: the pair
targets (``pairwise_tdoa``) and view (``pair_unbatch``), the nch-mic
synthetic batches, ``SARSSLMultiCH`` (forward in both ``ch_mode``s, its
weights both ways, a train and an eval step through the unchanged downstream
steps) and the pretrained trunk going into ``model_sch``. Tiny config
(``tests/tiny.py``), f32, dropout 0.

Tolerances (f32 on both sides): outputs, losses, MAEs and BatchNorm stats
rtol 1e-4 / atol 1e-5 (sums run in another order), as in
``test_torch_downstream.py``. Pair targets, pair views, synthetic batches and
converted weights: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.data.synthetic import synth_batch_multich as j_synth_multich  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLMultiCH as JSARSSLMultiCH  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.ops import pairs as jpairs  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_downstream_eval_step as j_eval_step  # noqa: E402
from sarssl_tpu.train import make_downstream_step as j_step  # noqa: E402
from sarssl_tpu.train.checkpoint import partial_load as j_partial_load  # noqa: E402
from sarssl_torch.data import synth_batch_multich  # noqa: E402
from sarssl_torch.models import SARSSLConfig, SARSSLMultiCH  # noqa: E402
from sarssl_torch.ops import FeatureConfig, num_pairs, pair_unbatch, pairwise_tdoa  # noqa: E402
from sarssl_torch.train import (create_train_state, make_downstream_eval_step,  # noqa: E402
                                make_downstream_step, partial_load)
from sarssl_torch.utils.weights import _key, from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE, feat  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
NB, NMIC, LR = 2, 4, 1e-3
JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": False})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_name(jax_key: str) -> str:
    """A JAX ``partial_load`` key ('a/b/kernel') as the port's parameter name."""
    *path, leaf = jax_key.split("/")
    return _key(path, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))


@pytest.mark.parametrize("ch_mode", ["M", "MM"])
@pytest.mark.parametrize("nch", [2, 3, 4, 6])
def test_pairwise_tdoa_equals_jax(nch, ch_mode):
    t = np.random.default_rng(nch).uniform(-6e-4, 6e-4, (5, nch - 1)).astype(np.float32)
    ref = np.asarray(jpairs.pairwise_tdoa(jnp.asarray(t), nch, ch_mode))
    out = pairwise_tdoa(torch.from_numpy(t), nch, ch_mode).numpy()
    assert out.shape == ref.shape == (5, num_pairs(nch, ch_mode) if nch > 2 else 1)
    np.testing.assert_array_equal(out, ref)


def test_pair_targets_follow_the_rebatch_pair_order():
    """Pair k of an example holds mics (i, j): its target is t_j - t_i."""
    t = torch.tensor([[1.0, 2.0, 4.0]])  # mics 1..3 against mic 0
    assert pairwise_tdoa(t, 4, "MM").tolist() == [[1.0, 2.0, 4.0, 1.0, 3.0, 2.0]]
    assert pairwise_tdoa(t, 4, "M").tolist() == [[1.0, 2.0, 4.0]]


def test_pair_unbatch_equals_jax():
    x = np.arange(6 * 3 * 2, dtype=np.float32).reshape(6, 3, 2)
    ref = np.asarray(jpairs.pair_unbatch(jnp.asarray(x), 2))
    out = pair_unbatch(torch.from_numpy(x), 2).numpy()
    assert out.shape == (2, 3, 3, 2)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("nch", [3, 4])
def test_synth_batch_multich_is_bit_identical(nch):
    jw, jt = j_synth_multich(np.random.default_rng(9), 3, NSAMPLE, nch=nch)
    tw, tt = synth_batch_multich(np.random.default_rng(9), 3, NSAMPLE, nch=nch)
    assert tw.dtype == jw.dtype == np.float32 and tw.shape == (3, NSAMPLE, nch)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tt, jt)


def _pair(ch_mode, seed=0):
    """The JAX multi-pair module with its variables, and the port's holding
    them."""
    npair = num_pairs(NMIC, ch_mode)
    nf, nt, nreim, _ = JCFG.sig_shape
    jm = JSARSSLMultiCH(JCFG, nmic_pair=npair)
    variables = jm.init({"params": jax.random.key(seed)},
                        jnp.zeros((NB * npair, 2, nf, nt, nreim)), None, False)
    model = SARSSLMultiCH(SARSSLConfig(**JCFG.__dict__), npair, device="cpu")
    params, buffers = from_jax_params(_np_tree(variables))
    model.load_state_dict({**params, **buffers}, strict=True)
    return jm, variables, model


@pytest.mark.parametrize("ch_mode", ["M", "MM"])
def test_multich_downstream_matches_jax(ch_mode):
    jm, variables, model = _pair(ch_mode)
    npair = num_pairs(NMIC, ch_mode)
    nf, nt, nreim, _ = JCFG.sig_shape
    x = np.random.default_rng(1).standard_normal((NB * npair, 2, nf, nt, nreim)
                                                 ).astype(np.float32)
    for train in (False, True):  # eval first: train mode updates the stats
        if train:
            (pred, joint), mut = jm.apply(variables, jnp.asarray(x), None, True,
                                          mutable=["batch_stats"])
        else:
            pred, joint = jm.apply(variables, jnp.asarray(x), None, False)
        tpred, tjoint = model.downstream(torch.from_numpy(x), train)
        assert tpred.dtype == torch.float32 and tpred.shape == (NB, npair)
        assert tjoint.shape == (NB, npair * JCFG.spat_dembed)
        np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(pred), **TOL)
        np.testing.assert_allclose(tjoint.detach().numpy(), np.asarray(joint), **TOL)
    _, stats = from_jax_params({"params": {}, "batch_stats": _np_tree(mut["batch_stats"])})
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("task", ["TDOA", "T60"])
def test_multich_weights_both_ways(task):
    """flax's tree, leaf for leaf: the trunk's encoders (no head: flax never
    creates one for a module only ``embed`` reads) and the joint head."""
    jm = JSARSSLMultiCH(JCFG, nmic_pair=3, task=task)
    nf, nt, nreim, _ = JCFG.sig_shape
    variables = _np_tree(jm.init({"params": jax.random.key(3)},
                                 jnp.zeros((NB * 3, 2, nf, nt, nreim)), None, False))
    model = SARSSLMultiCH(SARSSLConfig(**JCFG.__dict__), 3, task=task, device="cpu")
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert names == {"model_sch", "ln", "dense0", "dense1"}
    assert set(variables["params"]) == {"model_sch", "LayerNorm_0", "Dense_0", "Dense_1"}
    assert set(variables["params"]["model_sch"]) == {"spec_encoder", "spat_encoder"}
    assert model.dense1.weight.shape[0] == (3 if task == "TDOA" else 1)
    params, buffers = from_jax_params(variables)
    model.load_state_dict({**params, **buffers}, strict=True)  # every leaf mapped
    assert len(model.state_dict()) == len(jax.tree.leaves(variables))
    back = to_jax_params(model)
    for part in ("params", "batch_stats"):
        got, want = flatten_dict(back[part]), flatten_dict(variables[part])
        assert set(got) == set(want), part
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


@pytest.mark.parametrize("ch_mode", ["M", "MM"])
def test_multich_steps_match_jax(ch_mode):
    """Two train steps and an eval step with per-pair MAEs, through the
    downstream steps both packages already had."""
    npair = num_pairs(NMIC, ch_mode)
    jm, variables, model = _pair(ch_mode, seed=4)
    nf, nt, nreim, _ = JCFG.sig_shape
    jstate = j_create_state(jm, jax.random.key(4), jnp.zeros((NB * npair, 2, nf, nt, nreim)),
                            None)
    assert jax.tree.all(jax.tree.map(np.array_equal, _np_tree(jstate.params),
                                     _np_tree(variables["params"])))
    wave, tdoa = synth_batch_multich(np.random.default_rng(5), NB, NSAMPLE, nch=NMIC)
    gt = pairwise_tdoa(torch.from_numpy(tdoa / 16000.0), NMIC, ch_mode).numpy()
    jfeat, tfeat = feat(ch_mode=ch_mode), FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft,
                                                        ch_mode=ch_mode)
    jstep = j_step(jm, jfeat, "TDOA", donate=False, dlabel=npair)
    state = create_train_state(model)
    step = make_downstream_step(model, tfeat, "TDOA", dlabel=npair, device="cpu")
    key = jax.random.key(6)
    for _ in range(2):
        key, sub = jax.random.split(key)
        jstate, jm_ = jstep(jstate, jnp.asarray(wave), jnp.asarray(gt), LR, sub)
        tm = step(state, wave, gt, LR, torch.Generator().manual_seed(0))
        for k in ("loss", "mae"):
            np.testing.assert_allclose(tm[k].item(), float(jm_[k]), rtol=1e-4, err_msg=k)
    ref = j_eval_step(jm, jfeat, "TDOA", npair)(jstate, jnp.asarray(wave), jnp.asarray(gt))
    out = make_downstream_eval_step(model, tfeat, "TDOA", npair, device="cpu")(state, wave, gt)
    assert set(out) == set(ref) and out["mae_dims"].shape == (npair,)
    for k in ("loss", "mae", "pred", "mae_dims"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


def test_pretrained_trunk_goes_into_model_sch(monkeypatch):
    """A pretext tree loaded as JAX's ``{"model_sch": pre_sd}``: the port
    loads the same keys under ``model_sch.``."""
    from sarssl_torch.cli.run_downstream import pretrained_params
    from sarssl_torch.train import checkpoint as ckpt

    jcfg = type(JCFG)(**{**JCFG.__dict__, "pretrain": True})
    nf, nt, nreim, nmic = jcfg.sig_shape
    mask = gen_patch_mask(jax.random.key(0), NB, jcfg.npatch, jcfg.effective_nmasked())
    pre = JSARSSL(jcfg).init({"params": jax.random.key(5)}, jnp.zeros((NB, nmic, nf, nt, nreim)),
                             mask, False)
    pre_sd = serialization.to_state_dict(jax.device_get(pre["params"]))
    _, variables, model = _pair("MM")
    _, jloaded = j_partial_load(variables["params"], {"model_sch": pre_sd})
    monkeypatch.setattr(ckpt, "load_checkpoint", lambda path: {"params": _np_tree(pre_sd)})
    loaded = partial_load(model, pretrained_params("best_model.msgpack", multipair=True))
    assert sorted(loaded) == sorted(map(_torch_name, jloaded))
    assert sorted(loaded) == sorted(n for n, _ in model.named_parameters()
                                    if n.startswith("model_sch."))
