"""The mask modes of the port against the JAX package: ``T_1s``,
``T_cluster``, ``T_cluster_inverse``, ``T_cluster2`` and ``TF``.

Each clustered mode is a draw of run starts and a construction from them
(``sarssl_torch/ops/mask.py``). The construction is fed the starts that
``jax.random.randint`` draws inside the JAX package's ``gen_patch_mask`` and
must give its mask bit for bit; the port's own draws are held by their
counts and order. Then one pretrain step per mode against the JAX step with
``mask_mode``, on the mask JAX drew, replayed.

The step's weights are the port model's, handed to JAX through
``to_jax_params`` (its tree first held against the structure and shapes of
JAX's ``init`` by ``jax.eval_shape``, which runs nothing). Tolerances as
``tests/test_torch_train.py``: loss rtol 1e-4, running stats rtol 1e-4 /
atol 1e-5, parameters after one Adam step every element within lr and all
but 0.1% within 2e-5 (Adam moves an element whose exact gradient is ~0 by up
to lr in a direction rounding sets). Masks: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import mask as jmask  # noqa: E402
from sarssl_tpu.train import make_pretrain_step as j_pretrain_step  # noqa: E402
from sarssl_tpu.train.state import TrainState as JTrainState  # noqa: E402
from sarssl_tpu.train.state import make_adam  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask  # noqa: E402
from sarssl_torch.ops import mask as tmask  # noqa: E402
from sarssl_torch.train import create_train_state, make_pretrain_step  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in mask))


def _jax_variables(jm, model, *init_args):
    """The port model's weights as the JAX model's variables."""
    want = jax.eval_shape(lambda: jm.init({"params": jax.random.key(1)}, *init_args))
    got = to_jax_params(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    return got


def _jax_starts(key, mode, nb, npatch, nmasked):
    """The run starts ``sarssl_tpu.ops.mask.gen_patch_mask`` draws from ``key``
    (mask.py:50-61,107-119,121-124)."""
    kp, _ = jax.random.split(key)
    if mode == "T_cluster2":
        nruns = (nmasked + 4) // 5 + 1
        return jax.random.randint(kp, (nb, nruns), 0, max(npatch // 5, 1)) * 5
    n = npatch - nmasked if mode == "T_cluster_inverse" else nmasked
    nruns = (n + 8) // 9 + 1 if mode == "TF" else (n + 4) // 5 + 1
    return jax.random.randint(kp, (nb, nruns), 0, npatch)


@pytest.mark.parametrize("mode", ["T_cluster", "T_cluster_inverse", "T_cluster2", "TF"])
def test_mask_construction_matches_jax_bit_for_bit(mode):
    """From the starts JAX draws, the port builds JAX's mask exactly: runs
    clipped at the last patch, duplicates collapsed, trimmed and filled to
    ``nmasked`` in every row (npatch 37 and 64, nmasked from 1 to npatch-1)."""
    grid = {37: None, 64: (8, 8)}
    for npatch, nmasked, seed in ((64, 32, 0), (64, 5, 1), (64, 60, 2), (37, 18, 3),
                                  (37, 1, 4), (37, 36, 5)):
        if mode == "TF" and grid[npatch] is None:
            continue
        nb = 64
        key = jax.random.key(seed)
        ref = jmask.gen_patch_mask(key, nb, npatch, nmasked, mode=mode, grid_shape=grid[npatch])
        starts = np.asarray(_jax_starts(key, mode, nb, npatch, nmasked))
        assert starts.shape[1] == tmask.cluster_runs(mode, npatch, nmasked)
        patch, idx = tmask.mask_from_starts(mode, torch.tensor(starts).long(), npatch,
                                            nmasked, grid[npatch])
        np.testing.assert_array_equal(patch.numpy(), np.asarray(ref.patch))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref.idx))


def test_t1s_mask_matches_jax():
    ref = jmask.gen_patch_mask(jax.random.key(0), 5, 24, 12, mode="T_1s")
    got = tmask.gen_patch_mask(torch.Generator().manual_seed(0), 5, 24, 12, mode="T_1s")
    np.testing.assert_array_equal(got.patch.numpy(), np.asarray(ref.patch))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


@pytest.mark.parametrize("mode", tmask.MASK_MODES)
def test_gen_patch_mask_counts_and_order(mode):
    nb, npatch, nmasked = 256, 64, 32
    kw = {"grid_shape": (8, 8)} if mode == "TF" else {}
    m = tmask.gen_patch_mask(torch.Generator().manual_seed(0), nb, npatch, nmasked, mode=mode,
                             **kw)
    count = npatch // 4 if mode == "T_1s" else nmasked
    assert m.patch.shape == (nb, npatch) and m.patch.dtype == torch.bool
    assert (m.patch.sum(1) == count).all()
    assert m.idx.shape == (nb, count)
    assert (m.idx[:, 1:] > m.idx[:, :-1]).all()
    assert torch.gather(m.patch, 1, m.idx).all()
    assert set(m.ch.tolist()) == {0, 1}
    again = tmask.gen_patch_mask(torch.Generator().manual_seed(0), nb, npatch, nmasked,
                                 mode=mode, **kw)
    assert all(torch.equal(a, b) for a, b in zip(m, again))
    if mode in ("T_cluster", "T_cluster2", "TF"):
        # clustered: a masked patch's neighbour is masked far more often than
        # under 'T' (about a half there)
        p = m.patch
        both = (p[:, 1:] & p[:, :-1]).sum().item() / p[:, :-1].sum().item()
        assert both > 0.6, both


def test_tf_mode_needs_a_grid_shape_and_the_step_passes_none():
    with pytest.raises(ValueError, match="grid_shape"):
        tmask.gen_patch_mask(torch.Generator(), 2, 16, 8, mode="TF")
    with pytest.raises(ValueError, match="Unrecognized"):
        tmask.gen_patch_mask(torch.Generator(), 2, 16, 8, mode="X")
    cfg = SARSSLConfig(**{**CFG.__dict__, "dropout": 0.0})
    model = SARSSL(cfg, device="cpu")
    feat = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)
    step = make_pretrain_step(model, feat, device="cpu", mask_mode="TF")
    wave, _ = synth_batch(np.random.default_rng(0), 2, NSAMPLE)
    with pytest.raises(ValueError, match="grid_shape"):
        step(create_train_state(model), wave, LR, torch.Generator())


@pytest.mark.parametrize("mode", ["T_1s", "T_cluster", "T_cluster_inverse", "T_cluster2"])
def test_pretrain_step_per_mask_mode_matches_jax(mode):
    """One Adam step of the JAX step with ``mask_mode`` and of the port's,
    whose mask is the one JAX drew inside its step (steps.py:35-37),
    replayed. The parameters: as ``tests/test_torch_train.py``, every element
    within lr, all but 0.1% within 2e-5."""
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
    nf, nt, nreim, nmic = jcfg.sig_shape
    wave, _ = synth_batch(np.random.default_rng(1), 4, NSAMPLE)
    jm = JSARSSL(jcfg)
    mask0 = jmask.gen_patch_mask(jax.random.key(0), 4, jcfg.npatch, jcfg.effective_nmasked())
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    v = _jax_variables(jm, model, jnp.zeros((4, nmic, nf, nt, nreim)), mask0, False)
    tx = make_adam(LR)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    state = create_train_state(model)
    rng = jax.random.key(2)
    jstate, jmet = j_pretrain_step(jm, FEAT, mask_mode=mode, donate=False)(
        jstate, jnp.asarray(wave), LR, rng)
    mask = jmask.gen_patch_mask(jax.random.split(rng)[0], 4, jcfg.npatch,
                                jcfg.effective_nmasked(), nmic=2, mode=mode)
    step = make_pretrain_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                              device="cpu", mask_mode=mode)
    met = step(state, wave, LR, torch.Generator(), mask=_torch_mask(mask))
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-4)
    ref, _ = from_jax_params(jax.tree.map(np.asarray, {"params": jstate.params}))
    got = dict(model.named_parameters())
    n_far = n_all = 0
    for name, r in ref.items():
        diff = np.abs(got[name].detach().numpy() - r.numpy())
        assert diff.max() <= LR, (name, diff.max())
        n_far += int((diff > 2e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    _, stats = from_jax_params({"params": {}, "batch_stats": jax.tree.map(np.asarray,
                                                                         jstate.batch_stats)})
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), err_msg=name, **TOL)
