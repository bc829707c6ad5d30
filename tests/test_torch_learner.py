"""The port's optimizer, schedules and pretext learner against the JAX
package's.

Tolerances (f32 on both sides):
* Optimizer on given gradients, after 3 updates: parameters and moments
  within rtol 1e-5 plus 1e-6 of the leaf's largest magnitude. The two sides
  round the same f32 formulas in another order (the global norm, fused
  multiply-adds): a few ulps of the leaf's scale each update, and a moment
  that sums gradients of both signs to near 0 keeps those ulps.
* Schedules: equal, float for float.
* Frozen parameters: bit-identical on both sides, in the optimizer alone (the
  state then beside optax's as above) and in the downstream step.
* Learner: losses rtol 1e-4, lrs equal, the same best epochs and files.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.data import SyntheticPairs as JSyntheticPairs  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import learner as jlearner  # noqa: E402
from sarssl_tpu.train import make_pretrain_eval_step as j_eval_step  # noqa: E402
from sarssl_tpu.train import make_pretrain_step as j_pretrain_step  # noqa: E402
from sarssl_tpu.train import schedules as jsched  # noqa: E402
from sarssl_tpu.train.state import make_adam  # noqa: E402
from sarssl_tpu.utils import MetricLogger as JMetricLogger  # noqa: E402
from sarssl_tpu.utils.metrics import count_params as j_count_params  # noqa: E402
from sarssl_torch.data import SyntheticPairs  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask  # noqa: E402
from sarssl_torch.train import (create_train_state, make_downstream_step,  # noqa: E402
                                make_pretrain_eval_step, make_pretrain_step)
from sarssl_torch.train import learner as tlearner  # noqa: E402
from sarssl_torch.train import schedules as tsched  # noqa: E402
from sarssl_torch.utils import MetricLogger, count_params  # noqa: E402
from sarssl_torch.utils.weights import flax_tree, from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

NB = 4
LR = 1e-3
JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
TFEAT = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in mask))


def _pair(tx):
    """A JAX train state with ``tx`` and the port's model holding its weights."""
    nf, nt, nreim, nmic = JCFG.sig_shape
    jm = JSARSSL(JCFG)
    mask0 = gen_patch_mask(jax.random.key(0), NB, JCFG.npatch, JCFG.effective_nmasked())
    jstate = j_create_state(jm, jax.random.key(1), jnp.zeros((NB, nmic, nf, nt, nreim)),
                            mask0, tx=tx)
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu")
    params, buffers = from_jax_params(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    model.load_state_dict({**params, **buffers}, strict=True)
    return jm, jstate, model


def _close_trees(got, want, rtol=1e-5, scale=1e-6):
    """Leaf by leaf within ``rtol`` plus ``scale`` of the leaf's largest
    magnitude (0, 0: equal)."""
    got = flatten_dict(serialization.to_state_dict(jax.device_get(got)), keep_empty_nodes=True)
    want = flatten_dict(serialization.to_state_dict(jax.device_get(want)), keep_empty_nodes=True)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            atol = scale * float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=str(k))


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("missing", [False, True], ids=["adam", "adam_missing_grads"])
def test_optimizer_matches_optax_on_given_gradients(missing):
    """3 updates at varying rates; with ``missing``, the decoder's gradients
    are left out on the port's side (read as 0) and zero on optax's."""
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=2)
    state = create_train_state(model, lr=LR)
    tx = make_adam(LR)
    params = to_jax_params(model)["params"]
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    named = dict(model.named_parameters())
    for i in range(3):
        grads = {n: torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
                 * (not (missing and n.startswith("decoder."))) for n, p in named.items()}
        lr = LR * (1 - 0.2 * i)
        opt_state = opt_state._replace(
            hyperparams={**opt_state.hyperparams, "learning_rate": jnp.asarray(lr)})
        updates, opt_state = tx.update(flax_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in named.items():
            p.grad = None if missing and n.startswith("decoder.") else grads[n].clone()
        state.apply_gradients(lr)
    _close_trees(to_jax_params(model)["params"], params)
    _close_trees(state.optimizer.state_dict(), opt_state)
    assert state.optimizer.count == 3 and state.step == 3
    state.reset_optimizer()  # tx.init(params): zero moments, count 0, the initial rate
    fresh = serialization.to_state_dict(jax.device_get(tx.init(params)))
    _close_trees(state.optimizer.state_dict(), fresh, rtol=0, scale=0)


def test_frozen_leaves_in_the_optimizer_match_optax():
    """2 free updates (moments non-zero), then 2 with the spec encoder
    frozen, as the downstream steps freeze: JAX zeroes its gradients and
    restores its values after the update; the port gives it no gradient and
    restores its values after the update. Without the restore, the non-zero
    moments would move the frozen values."""
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=2)
    state = create_train_state(model, lr=LR)
    tx = make_adam(LR)
    params = to_jax_params(model)["params"]
    opt_state = tx.init(params)
    named = dict(model.named_parameters())
    frozen = [p for n, p in named.items() if n.startswith("spec_encoder.")]
    rng = np.random.default_rng(1)
    for i in range(4):
        grads = {n: torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
                 for n, p in named.items()}
        if i >= 2:
            jgrads = flax_tree({n: g * (not n.startswith("spec_encoder.")) for n, g in
                                grads.items()})
            if i == 2:
                before = {n: p.detach().clone() for n, p in named.items()}
        else:
            jgrads = flax_tree(grads)
        updates, new_opt = tx.update(jgrads, opt_state, params)
        new = optax.apply_updates(params, updates)
        if i >= 2:
            new = {**new, "spec_encoder": params["spec_encoder"]}
        params, opt_state = new, new_opt
        for n, p in named.items():
            p.grad = None if (i >= 2 and n.startswith("spec_encoder.")) else grads[n].clone()
        kept = [p.detach().clone() for p in frozen]
        state.apply_gradients(LR)
        if i >= 2:
            assert not all(torch.equal(p, k) for p, k in zip(frozen, kept))
            with torch.no_grad():
                for p, k in zip(frozen, kept):
                    p.copy_(k)
    for n, p in named.items():
        assert torch.equal(p, before[n]) == n.startswith("spec_encoder."), n
    _close_trees(to_jax_params(model)["params"], params)
    _close_trees(state.optimizer.state_dict(), opt_state)


# ------------------------------------------------------------ frozen leaves

def test_frozen_parameters_stay_put_in_the_downstream_step():
    """Moments restored non-zero would move a frozen parameter: the step
    puts its value back, bit for bit."""
    cfg = SARSSLConfig(**{**JCFG.__dict__, "pretrain": False})
    model = SARSSL(cfg, device="cpu", seed=1)
    state = create_train_state(model, lr=LR)
    rng = np.random.default_rng(1)
    for n, p in model.named_parameters():  # restored moments, non-zero
        i = state.optimizer.names.index(n)
        state.optimizer.mu[i].copy_(torch.tensor(rng.standard_normal(p.shape) * 1e-3))
        state.optimizer.nu[i].copy_(torch.tensor(rng.random(p.shape) * 1e-6))
    state.optimizer.count = 5
    trainable = {n: n.startswith("head_") for n, _ in model.named_parameters()}
    step = make_downstream_step(model, TFEAT, "TDOA", trainable, device="cpu")
    wave, gt = next(SyntheticPairs(nsample=NSAMPLE, seed=2).batches(NB, 1, with_labels=True))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):
        step(state, wave, gt["TDOA"], LR, torch.Generator().manual_seed(0))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) != trainable[n], n


# ----------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["cosine_schedule", "linear_schedule"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedules_equal_jax(name, warmup):
    for total, base in ((30, 1e-3), (40, 5e-4), (1, 1e-2)):
        j, t = getattr(jsched, name)(total, base, warmup), getattr(tsched, name)(total, base,
                                                                                 warmup)
        assert [t(e) for e in range(41)] == [j(e) for e in range(41)]


def test_exp_decay_equals_jax():
    j, t = jsched.exp_decay(1e-3, 10, 0.5), tsched.exp_decay(1e-3, 10, 0.5)
    assert [t(e) for e in range(41)] == [j(e) for e in range(41)]


# -------------------------------------------------- smoothing, early stopping

SCORES = [-3.0, -2.5, -2.5, -2.7, -2.6, -2.55, -2.4, -2.9, -3.1, -3.0, -2.2]


def test_smooth_data_equals_jax():
    assert tlearner.smooth_data(SCORES) == jlearner.smooth_data(SCORES)
    assert tlearner.smooth_data(SCORES, 0.3) == jlearner.smooth_data(SCORES, 0.3)
    assert tlearner.smooth_data([]) == jlearner.smooth_data([]) == []


@pytest.mark.parametrize("patience", [1, 2, 3])
def test_early_stopping_equals_jax(patience):
    j, t = jlearner.EarlyStopping(patience), tlearner.EarlyStopping(patience)
    trace = []
    for s in SCORES:
        trace.append((t.update(s), t.best, t.counter, t.stopped, j.update(s), j.best, j.counter,
                      j.stopped))
        if j.stopped:
            j.reset_counter()
            t.reset_counter()
    for row in trace:
        assert row[:4] == row[4:], trace


def test_count_params_equals_jax():
    _, jstate, model = _pair(make_adam(LR))
    groups = ["spec_encoder", "spat_encoder", "decoder"]
    assert count_params(model, groups) == j_count_params(jstate.params, groups)


# ------------------------------------------------------------------- learner

EPOCHS, BATCHES = 3, 2


def _masks(key, n, train):
    """The masks the JAX learner's steps draw from ``key`` (learner.py splits
    a subkey per step; the train step splits it again for the mask)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        mkey = jax.random.split(sub)[0] if train else sub
        out.append(_torch_mask(gen_patch_mask(mkey, NB, JCFG.npatch, JCFG.effective_nmasked(),
                                              nmic=2)))
    return out


def test_pretrain_learner_epochs_match_jax(tmp_path):
    jm, jstate, model = _pair(make_adam(LR))
    state = create_train_state(model, lr=LR)
    step, ev = make_pretrain_step(model, TFEAT, device="cpu"), make_pretrain_eval_step(
        model, TFEAT, device="cpu")
    queue = []
    tl = tlearner.PretrainLearner(
        state=state, train_step=lambda s, w, lr, g: step(s, w, lr, g, mask=queue.pop(0)),
        eval_step=lambda s, w, g: ev(s, w, g, mask=queue.pop(0)),
        lr_schedule=tsched.cosine_schedule(EPOCHS, LR), ckpt_dir=str(tmp_path / "t" / "ckpt"),
        patience=2, logger=MetricLogger(str(tmp_path / "t" / "logs")))
    jl = jlearner.PretrainLearner(
        state=jstate, train_step=j_pretrain_step(jm, FEAT, donate=False),
        eval_step=j_eval_step(jm, FEAT), lr_schedule=jsched.cosine_schedule(EPOCHS, LR),
        ckpt_dir=str(tmp_path / "j" / "ckpt"), patience=2,
        logger=JMetricLogger(str(tmp_path / "j" / "logs")))
    root = jax.random.key(100)
    best = {"t": [], "j": []}
    for epoch in range(EPOCHS):
        tkey, vkey = jax.random.fold_in(root, epoch), jax.random.fold_in(root, 10_000 + epoch)
        jwaves = list(JSyntheticPairs(nsample=NSAMPLE, seed=100 + epoch).batches(NB, BATCHES))
        twaves = list(SyntheticPairs(nsample=NSAMPLE, seed=100 + epoch).batches(NB, BATCHES))
        for a, b in zip(jwaves, twaves):
            np.testing.assert_array_equal(a, b)  # the two generators draw the same waves
        jm_ = jl.train_epoch(jwaves, tkey)
        queue[:] = _masks(tkey, BATCHES, True)
        tm = tl.train_epoch(twaves, torch.Generator())
        jv = jl.eval_epoch(jwaves[:1], vkey)
        queue[:] = _masks(vkey, 1, False)
        tv = tl.eval_epoch(twaves[:1], torch.Generator())
        assert not queue
        assert tm["lr"] == jm_["lr"]
        for k in ("loss", "diff"):
            np.testing.assert_allclose(tm[k], jm_[k], rtol=1e-4)
            np.testing.assert_allclose(tv[k], jv[k], rtol=1e-4)
        best["j"].append(jl.end_epoch(jv["loss"]))
        best["t"].append(tl.end_epoch(tv["loss"]))
    assert best["t"] == best["j"]
    assert tl.epoch == jl.epoch == EPOCHS and tl.should_stop == jl.should_stop
    np.testing.assert_allclose(tl.history["val_loss"], jl.history["val_loss"], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "t" / "ckpt")) == sorted(os.listdir(tmp_path / "j" /
                                                                            "ckpt"))
    tl.logger.close()
    jl.logger.close()
    recs = {}
    for side in ("t", "j"):
        with open(tmp_path / side / "logs" / "metrics.jsonl") as f:
            recs[side] = [json.loads(line) for line in f]
    assert [(r["split"], r["step"], sorted(r)) for r in recs["t"]] == \
        [(r["split"], r["step"], sorted(r)) for r in recs["j"]]
