"""The port's downstream learner, config and baseline against ``sarssl_tpu``:
``DownstreamConfig`` / ``real_ds_setting`` / ``exp_dirs``, scripted val-MAE
sequences through both ``DownstreamLearner``s (lr drop, best epochs, stop,
checkpoint writes, the epochs ensembled), ``ensemble`` over files the JAX
learner wrote, 3 epochs of finetune and lineareval on the tiny config, the
predict-the-mean baseline, and the f16 cast on ``partial_load``.

Tolerances: the schedule, best epochs, file names and epoch lists are equal.
The ensemble of JAX-written files: parameters and BatchNorm stats equal to
JAX's average to f32 rounding (rtol 1e-7: both sum in f64 and round once to
f32; the sum is exact for 5 terms, so they are equal in practice). Training
parity (f32, dropout 0, 3 epochs of 2 steps from the same weights): each
epoch's losses and MAEs, and the ensemble's test MAE, within rtol 1e-3. The
parameters drift apart by up to lr a step where a gradient element is ~0
(``test_torch_downstream.py``), and the later epochs read through them: the
largest difference in a CPU run of this test was 8e-5 (finetune, epoch 2's val
loss), lineareval's 2e-6. The baseline: equal to 1e-12 (f64 on both sides).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization, struct  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu import config as jconfig  # noqa: E402
from sarssl_tpu.data import SyntheticPairs as JSyntheticPairs  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import learner as jlearner  # noqa: E402
from sarssl_tpu.train import make_downstream_eval_step as j_eval_step  # noqa: E402
from sarssl_tpu.train import make_downstream_step as j_step  # noqa: E402
from sarssl_tpu.train.checkpoint import partial_load as j_partial_load  # noqa: E402
from sarssl_tpu.train.checkpoint import trainable_mask_from_loaded as j_mask  # noqa: E402
from sarssl_torch import config as tconfig  # noqa: E402
from sarssl_torch.data import SyntheticPairs  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.models.common import Dense  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.train import (create_train_state, make_downstream_eval_step,  # noqa: E402
                                make_downstream_step, partial_load,
                                trainable_mask_from_loaded)
from sarssl_torch.train import checkpoint as tckpt  # noqa: E402
from sarssl_torch.train import learner as tlearner  # noqa: E402
from sarssl_torch.utils import MetricLogger  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

NB, LR = 4, 1e-3
TASKS = ["TDOA", "DRR", "T60", "C50", "C80", "ABS", "SNR", "DOA", "SUR", "VOL"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- config

@pytest.mark.parametrize("task", TASKS)
def test_downstream_config_equals_jax(task):
    for nsimroom in (2, 4, 8, 16, 32, 256):
        j = jconfig.DownstreamConfig(task=task, nsimroom=nsimroom)
        t = tconfig.DownstreamConfig(task=task, nsimroom=nsimroom)
        assert (list(t.lr_set), list(t.bs_set), t.ntrial, t.train_num, t.T) == \
            (list(j.lr_set), list(j.bs_set), j.ntrial, j.train_num, j.T)
    assert tconfig.DownstreamConfig(task=task).T == (1.04 if task == "TDOA" else 4.112)


@pytest.mark.parametrize("ratio", [(1, 0), (1, 1), (0, 1)])
@pytest.mark.parametrize("mode", ["finetune", "lineareval", "scratchlow"])
@pytest.mark.parametrize("task", ["TDOA", "T60", "DRR"])
def test_real_ds_setting_equals_jax(task, mode, ratio):
    try:
        want = jconfig.real_ds_setting(task, mode, ratio)
    except ValueError as e:
        assert task != "TDOA" and mode == "lineareval"  # no real-world count for it
        with pytest.raises(ValueError, match="no real-world training count") as got:
            tconfig.real_ds_setting(task, mode, ratio)
        assert str(got.value) == str(e)
        return
    assert tconfig.real_ds_setting(task, mode, ratio) == want


def test_exp_dirs_equal_jax(tmp_path):
    assert tconfig.exp_dirs(str(tmp_path), "01020304") == jconfig.exp_dirs(str(tmp_path),
                                                                           "01020304")
    assert set(tconfig.exp_dirs()) == set(jconfig.exp_dirs())


def test_mae_without_training_equals_jax():
    rng = np.random.default_rng(0)
    tr, te = rng.normal(2.0, 3.0, 37), rng.normal(1.0, 2.0, (5, 4))
    want, got = jlearner.mae_without_training(tr, te), tlearner.mae_without_training(tr, te)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


# ----------------------------------------------------- scripted val sequences

@struct.dataclass
class _JState:
    params: dict
    batch_stats: dict
    opt_state: dict


# val MAE sequences: improving, a plateau that drops the lr then stops,
# ties (a tie is a new best), a late recovery after the drop, and a NaN
SCRIPTS = {
    "improving": [5.0, 4.0, 3.5, 3.0, 2.9, 2.8, 2.7, 2.6, 2.5, 2.4],
    "plateau": [5.0, 4.0, 4.5, 4.8, 5.0, 5.2, 5.5, 5.9, 6.0, 6.5, 7.0, 7.1],
    "ties": [3.0, 3.0, 3.0, 3.1, 3.0, 3.0, 3.2, 3.3, 3.4, 3.5, 3.6, 3.7],
    "recovery": [5.0, 4.0, 4.2, 4.4, 4.6, 3.0, 2.0, 2.5, 2.9, 3.2, 3.6, 4.0, 4.5, 5.0],
    "nan": [5.0, 4.0, float("nan"), 3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0],
}


def _run_script(learner, script, step_arg):
    """Train and end each epoch on the script until the learner halts;
    returns (lr per epoch, files after each epoch, halt epoch)."""
    lrs, files, halt = [], [], None
    for epoch, mae in enumerate(script):
        lrs.append(learner.train_epoch([(None, None)], step_arg)["lr"])
        stop = learner.end_epoch(mae)
        files.append(sorted(os.listdir(learner.ckpt_dir)))
        if stop:
            halt = epoch
            break
    return lrs, files, halt


@pytest.mark.parametrize("name", SCRIPTS)
@pytest.mark.parametrize("patience", [2, 3])
def test_scripted_val_maes_give_the_jax_schedule(name, patience, tmp_path, monkeypatch):
    """Stub steps: each train step adds 1 to every weight, so an epoch's file
    holds its epoch number, and the ensemble's average says which epochs it
    read."""
    script = SCRIPTS[name]
    one = {"loss": 1.0, "mae": 1.0}
    jstate = _JState(params={"w": np.zeros(3, np.float32)},
                     batch_stats={"bn": {"mean": np.zeros(2, np.float32)}}, opt_state={})
    jl = jlearner.DownstreamLearner(
        state=jstate, lr_init=LR, ckpt_dir=str(tmp_path / "j"), patience=patience,
        train_step=lambda s, w, g, lr, rng: (s.replace(params={"w": s.params["w"] + 1}), one),
        eval_step=None)
    model = Dense(3, 1)
    model.register_buffer("running_mean", torch.zeros(2))

    def tstep(state, wave, gt, lr, gen):
        with torch.no_grad():
            for t in (*model.parameters(), model.running_mean):
                t.add_(1.0)
        return {k: torch.tensor(v) for k, v in one.items()}

    tl = tlearner.DownstreamLearner(
        state=create_train_state(model), lr_init=LR, ckpt_dir=str(tmp_path / "t"),
        patience=patience, train_step=tstep, eval_step=None)
    jrun = _run_script(jl, script, jax.random.key(0))
    trun = _run_script(tl, script, torch.Generator())
    assert trun == jrun
    assert (tl.epoch, tl.lr, tl.lr_drops, tl.best_epochs, tl.val_raw) == \
        (jl.epoch, jl.lr, jl.lr_drops, jl.best_epochs, jl.val_raw)
    if name == "plateau":
        assert jrun[2] is not None and LR / 10 in jrun[0]  # dropped the lr, then halted
    best = jckpt.load_checkpoint(jckpt.best_path(str(tmp_path / "j")))["meta"]
    assert tckpt.load_checkpoint(tckpt.best_path(str(tmp_path / "t")))["meta"] == best

    read = {"j": [], "t": []}
    for side, mod in (("j", jckpt), ("t", tckpt)):
        monkeypatch.setattr(mod, "load_checkpoint", lambda p, side=side, f=mod.load_checkpoint:
                            read[side].append(os.path.basename(p)) or f(p))
    javg, tavg = jl.ensemble(k=5), tl.ensemble(k=5)
    assert read["t"] == read["j"] and read["j"]  # the same consecutive epochs
    epochs = [int(f[5:-8]) for f in read["j"]]
    np.testing.assert_array_equal(tavg["bias"].numpy(), np.mean(epochs) + 1)
    np.testing.assert_array_equal(tavg["bias"].numpy()[0], javg["w"][0])
    np.testing.assert_array_equal(model.running_mean.numpy(), np.mean(epochs) + 1)
    assert os.path.exists(tckpt.ensemble_path(str(tmp_path / "t")))


def test_ensemble_without_epoch_files_returns_the_current_params(tmp_path):
    model = Dense(3, 1)
    tl = tlearner.DownstreamLearner(state=create_train_state(model), lr_init=LR,
                                    ckpt_dir=str(tmp_path), train_step=None, eval_step=None)
    out = tl.ensemble()
    assert set(out) == {"weight", "bias"} and torch.equal(out["weight"], model.weight)
    assert not os.path.exists(tckpt.ensemble_path(str(tmp_path)))


# ------------------------------------------------ ensemble over JAX's files

JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": False})


def _x0():
    nf, nt, nreim, nmic = CFG.sig_shape
    return jnp.zeros((NB, nmic, nf, nt, nreim))


def test_ensemble_over_jax_written_files(tmp_path):
    """The JAX learner writes 6 epochs of a real downstream tree (each epoch
    moves every parameter and stat by seeded noise); the port's ensemble over
    those files gives JAX's average of parameters and BatchNorm stats, on the
    model and in ``ensemble_model``."""
    jstate = j_create_state(JSARSSL(JCFG), jax.random.key(0), _x0(), None)
    rng = np.random.default_rng(1)

    def jstep(state, wave, gt, lr, key):
        jitter = lambda x: x + rng.standard_normal(x.shape).astype(np.float32)  # noqa: E731
        return state.replace(params=jax.tree.map(jitter, _np_tree(state.params)),
                             batch_stats=jax.tree.map(jitter, _np_tree(state.batch_stats))), \
            {"loss": 0.0, "mae": 0.0}

    jl = jlearner.DownstreamLearner(state=jstate, train_step=jstep, eval_step=None, lr_init=LR,
                                    ckpt_dir=str(tmp_path / "j"), patience=10)
    for mae in [5.0, 4.0, 3.0, 2.0, 2.5, 1.0]:
        jl.train_epoch([(None, None)], jax.random.key(0))
        jl.end_epoch(mae)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu")
    tl = tlearner.DownstreamLearner(state=create_train_state(model), train_step=None,
                                    eval_step=None, lr_init=LR, ckpt_dir=str(tmp_path / "t"))
    tl.epoch, tl.best_epochs, tl.stopper.best = jl.epoch, list(jl.best_epochs), jl.stopper.best
    javg = jl.ensemble(k=5)
    tavg = tl.ensemble(k=5)
    want = {"params": _np_tree(javg), "batch_stats": _np_tree(jl.state.batch_stats)}
    ref_p, ref_b = from_jax_params(want)
    assert set(tavg) == set(ref_p)
    for name, r in ref_p.items():
        np.testing.assert_allclose(tavg[name].numpy(), r.numpy(), rtol=1e-7, err_msg=name)
    got = to_jax_params(model)  # installed on the model
    for part in ("params", "batch_stats"):
        g, w = flatten_dict(got[part]), flatten_dict(want[part])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-7, err_msg=str(k))
    jfile = jckpt.load_checkpoint(jckpt.ensemble_path(str(tmp_path / "j")))
    tfile = tckpt.load_checkpoint(tckpt.ensemble_path(str(tmp_path / "t")))
    assert tfile["meta"] == jfile["meta"] and "opt_state" not in tfile
    for part in ("params", "batch_stats"):
        g, w = flatten_dict(tfile[part]), flatten_dict(jfile[part])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-7, err_msg=str(k))


# ------------------------------------------------------------ training parity

EPOCHS, BATCHES = 3, 2


@pytest.mark.parametrize("mode", ["finetune", "lineareval"])
def test_three_epochs_match_the_jax_learner(mode, tmp_path):
    """Both learners from JAX's init weights with a pretext trunk loaded,
    the same batches (dropout 0), 3 epochs, then the ensemble and the test."""
    jcfg_pre = type(JCFG)(**{**JCFG.__dict__, "pretrain": True})
    mask = gen_patch_mask(jax.random.key(0), NB, jcfg_pre.npatch, jcfg_pre.effective_nmasked())
    pre = JSARSSL(jcfg_pre).init({"params": jax.random.key(5)}, _x0(), mask, False)
    pre_sd = serialization.to_state_dict(jax.device_get(pre["params"]))
    jm = JSARSSL(JCFG)
    jstate = j_create_state(jm, jax.random.key(1), _x0(), None)
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu")
    params, buffers = from_jax_params(_np_tree({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}))
    model.load_state_dict({**params, **buffers}, strict=True)
    jparams, jloaded = j_partial_load(jstate.params, pre_sd)
    jstate = jstate.replace(params=jparams, opt_state=jstate.tx.init(jparams))
    loaded = partial_load(model, from_jax_params({"params": _np_tree(pre_sd)})[0])
    assert len(loaded) == len(jloaded)
    lin = mode == "lineareval"
    tfeat = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)
    jl = jlearner.DownstreamLearner(
        state=jstate, lr_init=LR, ckpt_dir=str(tmp_path / "j"), patience=10,
        train_step=j_step(jm, FEAT, "TDOA", donate=False,
                          trainable_mask=j_mask(jparams, jloaded) if lin else None),
        eval_step=j_eval_step(jm, FEAT, "TDOA"))
    tl = tlearner.DownstreamLearner(
        state=create_train_state(model), lr_init=LR, ckpt_dir=str(tmp_path / "t"), patience=10,
        train_step=make_downstream_step(
            model, tfeat, "TDOA", trainable_mask_from_loaded(model, loaded) if lin else None,
            device="cpu"),
        eval_step=make_downstream_eval_step(model, tfeat, "TDOA", device="cpu"),
        logger=MetricLogger(str(tmp_path / "logs"), use_tensorboard=False))

    def batches(cls, seed, n=BATCHES):
        return [(w, g["TDOA"]) for w, g in cls(nsample=NSAMPLE, seed=seed).batches(
            NB, n, with_labels=True)]

    def jbatches(seed, n=BATCHES):
        return [(jnp.asarray(w), jnp.asarray(g)) for w, g in batches(JSyntheticPairs, seed, n)]

    for epoch in range(EPOCHS):
        jm_ = jl.train_epoch(jbatches(100 + epoch), jax.random.key(epoch))
        tm = tl.train_epoch(batches(SyntheticPairs, 100 + epoch), torch.Generator())
        jv, tv = jl.eval_epoch(jbatches(1, 1)), tl.eval_epoch(batches(SyntheticPairs, 1, 1))
        for k in ("loss", "mae"):
            np.testing.assert_allclose(tm[k], jm_[k], rtol=1e-3, err_msg=f"train {k} {epoch}")
            np.testing.assert_allclose(tv[k], jv[k], rtol=1e-3, err_msg=f"val {k} {epoch}")
        assert tm["lr"] == jm_["lr"]
        assert tl.end_epoch(tv["mae"]) == jl.end_epoch(jv["mae"])
    assert tl.best_epochs == jl.best_epochs
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    javg = jl.ensemble(k=5)  # installs the averaged stats on jl.state
    jl.state = jl.state.replace(params=javg)
    tl.ensemble(k=5)
    jt, tt = jl.eval_epoch(jbatches(2, 1), "test"), tl.eval_epoch(batches(SyntheticPairs, 2, 1),
                                                                  "test")
    np.testing.assert_allclose(tt["mae"], jt["mae"], rtol=1e-3)
    if lin:  # the frozen encoders average to themselves, bit for bit
        src = from_jax_params({"params": _np_tree(pre_sd)})[0]
        for name, p in model.named_parameters():
            if name in loaded:
                assert torch.equal(p.detach(), src[name]), name
    tl.logger.close()


# ---------------------------------------------------------------- f16 leaves

def test_partial_load_casts_f16_to_f32_where_jax_keeps_f16():
    """The committed trained checkpoint stores f16 leaves. JAX's
    ``partial_load`` keeps the source leaf's dtype, so its downstream run
    trains f16 encoder leaves; the port copies into the f32 parameter."""
    w16 = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float16)
    jparams, jloaded = j_partial_load({"d": {"kernel": np.zeros((3, 2), np.float32)}},
                                      {"d": {"kernel": w16}})
    assert jloaded == ["d/kernel"] and np.asarray(jparams["d"]["kernel"]).dtype == np.float16
    model = torch.nn.Module()
    model.d = Dense(3, 2)
    src = from_jax_params({"params": {"d": {"kernel": w16}}})[0]
    assert src["d.weight"].dtype == torch.float32  # the reader casts already
    for source in (src, {"d.weight": torch.from_numpy(w16.T.copy())}):
        assert partial_load(model, source) == ["d.weight"]
        assert model.d.weight.dtype == torch.float32
        np.testing.assert_array_equal(model.d.weight.detach().numpy(), w16.T.astype(np.float32))
