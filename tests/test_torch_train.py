"""The port's pretext train and eval steps against ``sarssl_tpu.train``.

Three Adam steps at lr 1e-3 with dropout 0 from the same flax init; each
step's mask is recomputed outside the JAX step (``rng_mask, _ =
jax.random.split(rng)``, steps.py:35-37) and replayed into the port.

Tolerances (f32 on both sides): losses rtol 1e-4; BatchNorm stats rtol 1e-4 /
atol 1e-5. Parameters: Adam divides each gradient element by its own running
magnitude, so an element whose exact gradient is ~0 (the key-projection bias,
to which softmax is invariant, or decoder weights few masked channels reach)
takes a step of up to lr in a direction set by rounding noise, on each side
independently. So every element is held to 3 * lr (three steps) and all but
0.1% of all elements to 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_pretrain_eval_step as j_eval_step  # noqa: E402
from sarssl_tpu.train import make_pretrain_step as j_pretrain_step  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask  # noqa: E402
from sarssl_torch.train import (create_train_state, make_pretrain_eval_step,  # noqa: E402
                                make_pretrain_step)
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

LR = 1e-3
NB = 4


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)).long() if t.dtype != bool
                       else torch.tensor(np.asarray(t)) for t in mask))


@pytest.fixture(scope="module")
def trained():
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
    nf, nt, nreim, nmic = jcfg.sig_shape
    nmasked = jcfg.effective_nmasked()
    # synth_batch is the port's copy of the JAX package's; both see this wave
    wave, _ = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    jm = JSARSSL(jcfg)
    x0 = jnp.zeros((NB, nmic, nf, nt, nreim))
    mask0 = gen_patch_mask(jax.random.key(0), NB, jcfg.npatch, nmasked)
    jstate = j_create_state(jm, jax.random.key(1), x0, mask0)
    variables0 = {"params": jstate.params, "batch_stats": jstate.batch_stats}

    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    params, buffers = from_jax_params(jax.tree.map(np.asarray, variables0))
    model.load_state_dict({**params, **buffers}, strict=True)
    state = create_train_state(model)
    feat = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)
    step = make_pretrain_step(model, feat, device="cpu")

    jstep = j_pretrain_step(jm, FEAT, donate=False)
    key = jax.random.key(2)
    jlosses, tlosses = [], []
    for _ in range(3):
        key, sub = jax.random.split(key)
        jstate, m = jstep(jstate, jnp.asarray(wave), LR, sub)
        jlosses.append(float(m["loss"]))
        rng_mask, _ = jax.random.split(sub)
        mask = gen_patch_mask(rng_mask, NB, jcfg.npatch, nmasked, nmic=2, mode="T")
        tm = step(state, wave, LR, torch.Generator().manual_seed(0), mask=_torch_mask(mask))
        tlosses.append(tm["loss"].item())
    eval_mask = gen_patch_mask(jax.random.key(9), NB, jcfg.npatch, nmasked)
    jev = j_eval_step(jm, FEAT)(jstate, jnp.asarray(wave), jax.random.key(9))
    tev = make_pretrain_eval_step(model, feat, device="cpu")(
        state, wave, torch.Generator(), mask=_torch_mask(eval_mask))
    return dict(jstate=jstate, state=state, jlosses=jlosses, tlosses=tlosses,
                jev=jev, tev=tev)


def test_losses_match_per_step(trained):
    np.testing.assert_allclose(trained["tlosses"], trained["jlosses"], rtol=1e-4)
    assert trained["state"].step == 3


def test_final_params_match(trained):
    jstate, model = trained["jstate"], trained["state"].model
    ref, _ = from_jax_params(jax.tree.map(np.asarray, {"params": jstate.params}))
    got = dict(model.named_parameters())
    assert set(ref) == set(got)
    n_far = n_all = 0
    for name, r in ref.items():
        diff = np.abs(got[name].detach().numpy() - r.numpy())
        assert diff.max() <= 3 * LR, (name, diff.max())
        n_far += int((diff > 2e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_final_batch_stats_match(trained):
    jstate, model = trained["jstate"], trained["state"].model
    _, ref = from_jax_params({"params": {}, "batch_stats":
                              jax.tree.map(np.asarray, jstate.batch_stats)})
    got = dict(model.named_buffers())
    assert set(ref) == set(got)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_eval_step_matches(trained):
    for k in ("loss", "diff"):
        np.testing.assert_allclose(trained["tev"][k].item(), float(trained["jev"][k]),
                                   rtol=1e-4)
