"""The port's modules against the JAX package's, with weights from
``model.init`` moved through ``from_jax_params`` (f32, dropout off).

Tolerance: rtol 1e-4 / atol 1e-5 for outputs and BatchNorm running stats
(f32 on both sides; the sums run in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models.conformer import ConformerBlock as JBlock  # noqa: E402
from sarssl_tpu.models.conformer import RelPosSelfAttention as JAttn  # noqa: E402
from sarssl_tpu.models.conformer import _relative_shift as j_shift  # noqa: E402
from sarssl_tpu.models.encoder import CNNFrontEnd as JFront  # noqa: E402
from sarssl_tpu.models.encoder import EmbedEncoder as JEncoder  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_torch.models import (SARSSL, CNNFrontEnd, ConformerBlock, EmbedEncoder,  # noqa: E402
                                 RelPosSelfAttention, SARSSLConfig)
from sarssl_torch.models.conformer import _relative_shift  # noqa: E402
from sarssl_torch.ops import PatchMask  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402
from tiny import CFG  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    params, buffers = from_jax_params(_np_tree(variables))
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close_stats(torch_module, jax_stats):
    _, buffers = from_jax_params({"params": {}, "batch_stats": _np_tree(jax_stats)})
    state = torch_module.state_dict()
    assert buffers
    for name, ref in buffers.items():
        np.testing.assert_allclose(state[name].numpy(), ref.numpy(), err_msg=name, **TOL)


def test_relative_shift_matches():
    x = _rand((2, 3, 5, 5), 0)
    np.testing.assert_array_equal(_relative_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_shift(jnp.asarray(x))))


@pytest.mark.parametrize("fused", [False, True])
def test_rel_pos_self_attention(fused):
    x = _rand((2, 8, 32), 1)
    jm = JAttn(d_model=32, num_heads=4, dropout=0.1)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = _load(RelPosSelfAttention(32, 4, 0.1, fused=fused), variables)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_conformer_block(train):
    x = _rand((2, 8, 32), 2)
    jm = JBlock(dim=32, num_heads=4, dropout=0.0)
    variables = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = _load(ConformerBlock(32, 4, dropout=0.0), variables)
    out = tm(torch.from_numpy(x), train).detach().numpy()
    if train:
        ref, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        _close_stats(tm, mut["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x), False)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_cnn_front_end(train):
    x = _rand((2, 8, 6, 4), 3)  # NHWC
    jm = JFront(dembed=16, patch_shape=(8, 1))
    variables = jm.init(jax.random.key(2), jnp.asarray(x))
    tm = _load(CNNFrontEnd(4, 16, (8, 1)), variables)
    out = tm(torch.from_numpy(x), train).detach().numpy()
    if train:
        ref, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        _close_stats(tm, mut["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x), False)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_embed_encoder():
    sig, patch = (8, 6, 2, 2), (8, 1)
    x = _rand((2, 6, 8 * 4), 4)
    jm = JEncoder(sig_shape=sig, patch_shape=patch, dembed=16, mode="spat",
                  num_layers=2, dropout=0.0)
    variables = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = _load(EmbedEncoder(sig, patch, 16, mode="spat", num_layers=2, dropout=0.0),
               variables)
    for train in (False, True):  # eval first: train mode updates the stats
        if train:
            ref, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        else:
            ref = jm.apply(variables, jnp.asarray(x), False)
        out = tm(torch.from_numpy(x), train).detach().numpy()
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    _close_stats(tm, mut["batch_stats"])


def _torch_cfg(jcfg, **kw):
    return SARSSLConfig(**{**jcfg.__dict__, **kw})


def _jax_mask_as_torch(mask):
    return PatchMask(patch=torch.tensor(np.asarray(mask.patch)),
                     ch=torch.tensor(np.asarray(mask.ch)).long(),
                     idx=torch.tensor(np.asarray(mask.idx)).long())


@pytest.mark.parametrize("fused", [False, True])
def test_sarssl_pretext_matches_with_replayed_mask(fused):
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
    nf, nt, nreim, nmic = jcfg.sig_shape
    nb = 4
    x = _rand((nb, nmic, nf, nt, nreim), 5)
    mask = gen_patch_mask(jax.random.key(7), nb, jcfg.npatch, jcfg.effective_nmasked())
    jm = JSARSSL(jcfg)
    variables = jm.init({"params": jax.random.key(6)}, jnp.asarray(x), mask, False)
    tm = _load(SARSSL(_torch_cfg(jcfg, fused_attention=fused), device="cpu"), variables)
    tmask = _jax_mask_as_torch(mask)
    for train in (False, True):
        if train:
            (loss, diff, aux), mut = jm.apply(variables, jnp.asarray(x), mask, True,
                                              mutable=["batch_stats"])
        else:
            loss, diff, aux = jm.apply(variables, jnp.asarray(x), mask, False)
        tl, td, taux = tm.pretext(torch.from_numpy(x), tmask, train)
        np.testing.assert_allclose(tl.item(), float(loss), **TOL)
        np.testing.assert_allclose(float(td), float(diff), **TOL)
        np.testing.assert_allclose(taux["pred"].detach().numpy(), np.asarray(aux["pred"]),
                                   **TOL)
    _close_stats(tm, mut["batch_stats"])


def test_unported_options_raise():
    """Only a downstream head other than 'mlp' raises: the JAX package builds
    none either (every other option: tests/test_torch_model_options.py)."""
    with pytest.raises(NotImplementedError):
        SARSSL(_torch_cfg(CFG, pretrain=False, downstream_head="x"), device="cpu")
