"""The model's options in the port against the JAX package: ``in_ver``, the
CLS token, remat, the ``fc`` / f-first front ends, the transformer, the
decoder stages and CNN head, and ``MCConformer`` (the mask modes:
``tests/test_torch_mask_modes.py``).

Weights: the port's module's own, handed to the JAX module through
``to_jax_params``. That tree is first held against the structure and shapes
of the JAX module's ``init`` (``jax.eval_shape``, which runs nothing) and read
back through ``from_jax_params`` with a strict load, so every new leaf's name
and layout goes both ways, and the outputs then show the values land where
JAX reads them. (Running JAX's ``init`` instead costs seconds a model on the
CPU.) The inputs are the same numpy arrays and the masks the same (replayed)
ones; dropout is 0 wherever JAX is compared (the two sides draw different
random numbers). Remat is held against the port's own plain path, dropout on.

Tolerances. f32: rtol 1e-4 / atol 1e-5 for outputs and BatchNorm running
stats (as ``tests/test_torch_models.py``: f32 on both sides, sums in another
order). bf16 (the transformer): 2.5e-2 of the largest JAX magnitude, the
bound of ``tests/test_torch_bf16.py`` (8 significant bits, about 40
independent roundings at most on this chain: sqrt(40) * 2**-8). Masks and
remat against plain: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import MCConformer as JMCConformer  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models.conformer import ConformerEncoder as JConformer  # noqa: E402
from sarssl_tpu.models.decoder import EmbedDecoder as JDecoder  # noqa: E402
from sarssl_tpu.models.encoder import EmbedEncoder as JEncoder  # noqa: E402
from sarssl_tpu.models.transformer import TransformerEncoder as JTransformer  # noqa: E402
from sarssl_tpu.ops import mask as jmask  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import (SARSSL, ConformerEncoder, EmbedDecoder,  # noqa: E402
                                 EmbedEncoder, MCConformer, SARSSLConfig, TransformerEncoder)
from sarssl_torch.ops import FeatureConfig, PatchMask  # noqa: E402
from sarssl_torch.train import create_train_state, make_pretrain_step  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
TOL_BF16 = 2.5e-2
LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    params, buffers = from_jax_params(_np_tree(variables))
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def _variables(jm, tm, *init_args, rngs=None):
    """``tm``'s weights as the JAX module's variables (see the module's note)."""
    want = jax.eval_shape(lambda: jm.init(rngs or jax.random.key(0), *init_args))
    got = to_jax_params(tm)
    if not got["batch_stats"]:
        del got["batch_stats"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(jax.tree.leaves(jax.tree.map(lambda a, b: a.shape == b.shape, got, want)))
    _load(tm, got)
    return got


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close_stats(module, jax_stats):
    _, buffers = from_jax_params({"params": {}, "batch_stats": _np_tree(jax_stats)})
    state = module.state_dict()
    assert set(buffers) == {n for n, _ in module.named_buffers()}
    for name, ref in buffers.items():
        np.testing.assert_allclose(state[name].numpy(), ref.numpy(), err_msg=name, **TOL)


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in mask))


def _both_modes(jm, variables, tm, args_j, args_t, close, call=None):
    """Eval, then train (which moves the running stats): the outputs of
    ``call`` (default ``tm``) each time, ``tm``'s stats after. ``args_*`` end
    before the ``train`` flag."""
    for train in (False, True):
        if train:
            ref, mut = jax.jit(lambda v, *a: jm.apply(v, *a, True, mutable=["batch_stats"]))(
                variables, *args_j)
        else:
            ref = jax.jit(lambda v, *a: jm.apply(v, *a, False))(variables, *args_j)
        close((call or tm)(*args_t, train), ref)
    if "batch_stats" in variables:
        _close_stats(tm, mut["batch_stats"])


def _close_arrays(got, ref):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32), **TOL)


# --------------------------------------------------------------------------
# sequence models
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add_same_one", [False, True])
def test_transformer_encoder_matches_flax(dtype, add_same_one):
    """flax's ``MultiHeadDotProductAttention`` (query over sqrt(head_dim),
    softmax in the compute dtype) inside the pre-LN encoder, 2 layers."""
    x = _rand((2, 12, 32), 0)
    jdt = jnp.dtype(dtype)
    jm = JTransformer(32, 2, num_heads=4, dropout=0.0, add_same_one=add_same_one, dtype=jdt)
    tm = TransformerEncoder(32, 2, num_heads=4, dropout=0.0, add_same_one=add_same_one,
                            dtype=getattr(torch, dtype))
    variables = _variables(jm, tm, jnp.asarray(x))

    def close(got, ref):
        ref = np.asarray(ref, np.float32)
        assert str(got.dtype) == f"torch.{dtype}" and ref.dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
        else:
            err = np.abs(got.detach().float().numpy() - ref).max() / np.abs(ref).max()
            assert err <= TOL_BF16, err

    _both_modes(jm, variables, tm, (jnp.asarray(x),), (torch.from_numpy(x),), close)


@pytest.mark.parametrize("kw", [dict(add_same_one=True), dict(remat=True)])
def test_conformer_encoder_options_match_jax(kw):
    x = _rand((2, 10, 32), 1)
    jm = JConformer(32, 2, num_heads=4, dropout=0.0, **kw)
    tm = ConformerEncoder(32, 2, num_heads=4, dropout=0.0, **kw)
    variables = _variables(jm, tm, jnp.asarray(x))
    _both_modes(jm, variables, tm, (jnp.asarray(x),), (torch.from_numpy(x),), _close_arrays)


# --------------------------------------------------------------------------
# encoder and decoder
# --------------------------------------------------------------------------
ENCODERS = {
    "fc-conformer": dict(model=("fc", "conformer")),
    "fc-transformer-cls": dict(model=("fc", "transformer"), use_cls=True),
    "cnn-transformer": dict(model=("cnn", "transformer")),
    "cnn-none": dict(model=("cnn", "")),
    "cnn-conformer-cls": dict(model=("cnn", "conformer"), use_cls=True),
    "cnn-remat": dict(model=("cnn", "conformer"), remat_local=True),
    "cnn_f_first": dict(model=("cnn_f_first", "conformer"), patch_shape=(4, 2)),
}


@pytest.mark.parametrize("name", ENCODERS)
def test_embed_encoder_options_match_jax(name):
    kw = dict(ENCODERS[name])
    sig, patch = (8, 6, 2, 2), kw.pop("patch_shape", (8, 1))
    npatch = (sig[0] // patch[0]) * (sig[1] // patch[1])
    x = _rand((2, npatch, patch[0] * patch[1] * 4), 2)
    jm = JEncoder(sig_shape=sig, patch_shape=patch, dembed=16, mode="spat", num_layers=1,
                  dropout=0.0, **kw)
    tm = EmbedEncoder(sig, patch, 16, mode="spat", num_layers=1, dropout=0.0,
                      generator=torch.Generator().manual_seed(2), **kw)
    variables = _variables(jm, tm, jnp.asarray(x))
    _both_modes(jm, variables, tm, (jnp.asarray(x),), (torch.from_numpy(x),), _close_arrays)


DECODERS = {
    "conformer-fc": (("conformer", "fc"), (8, 1)),
    "transformer-fc": (("transformer", "fc"), (8, 1)),
    "cnn": (("", "cnn"), (8, 1)),
    "cnn-f_first": (("", "cnn"), (4, 2)),
}


@pytest.mark.parametrize("name", DECODERS)
def test_embed_decoder_options_match_jax(name):
    model, patch = DECODERS[name]
    sig = (8, 6, 2, 2)
    npatch = (sig[0] // patch[0]) * (sig[1] // patch[1])
    x = _rand((2, npatch, 32), 3)
    jm = JDecoder(sig_shape=sig, patch_shape=patch, dembed=32, model=model, dropout=0.0)
    tm = EmbedDecoder(sig, patch, 32, model, dropout=0.0,
                      generator=torch.Generator().manual_seed(3))
    variables = _variables(jm, tm, jnp.asarray(x))
    _both_modes(jm, variables, tm, (jnp.asarray(x),), (torch.from_numpy(x),), _close_arrays)


# --------------------------------------------------------------------------
# SARSSL and MCConformer
# --------------------------------------------------------------------------
PRETEXT = {
    "in_ver-same": dict(in_ver="same"),
    "in_ver-single_ch_each_patch": dict(in_ver="single_ch_each_patch"),
    "use_cls": dict(use_cls=True),
    "remat_cnn": dict(remat_cnn=True),
    "local-fc": dict(local_model="fc"),
    "f-first-patches": dict(patch_shape=(16, 2)),
    "global-transformer": dict(global_model="transformer"),
    "dec-conformer": dict(dec_model=("conformer", "fc")),
    "dec-transformer": dict(dec_model=("transformer", "fc")),
    "dec-cnn": dict(dec_model=("", "cnn"), spec_dembed=96, spat_dembed=32),
}


def _sarssl_case(kw, pretrain=True, seed=5):
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": pretrain, **kw})
    nf, nt, nreim, nmic = jcfg.sig_shape
    x = _rand((4, nmic, nf, nt, nreim), seed)
    mask = jmask.gen_patch_mask(jax.random.key(7), 4, jcfg.npatch, jcfg.effective_nmasked())
    jm = JSARSSL(jcfg)
    tm = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu", seed=seed)
    variables = _variables(jm, tm, jnp.asarray(x), mask if pretrain else None, False,
                           rngs={"params": jax.random.key(6)})
    return jm, variables, tm, x, mask


@pytest.mark.parametrize("name", PRETEXT)
def test_sarssl_pretext_options_match_jax(name):
    """Loss, ``diff``, prediction and running stats in eval and train, on a
    replayed mask."""
    jm, variables, tm, x, mask = _sarssl_case(PRETEXT[name])
    tmask_ = _torch_mask(mask)

    def close(got, ref):
        (tl, td, taux), (loss, diff, aux) = got, ref
        np.testing.assert_allclose(tl.item(), float(loss), **TOL)
        np.testing.assert_allclose(td.item(), float(diff), **TOL)
        _close_arrays(taux["pred"], aux["pred"])

    _both_modes(jm, variables, tm, (jnp.asarray(x), mask), (torch.from_numpy(x), tmask_),
                close, tm.pretext)


@pytest.mark.parametrize("kw", [dict(use_cls=True, downstream_token="all"),
                                dict(use_cls=True, downstream_token="cls"),
                                dict(in_ver="single_ch_each_patch"),
                                dict(in_ver="single_ch_each_patch", use_cls=True,
                                     downstream_token="cls")],
                         ids=["cls-all", "cls-cls", "single_ch", "single_ch-cls"])
def test_sarssl_downstream_options_match_jax(kw):
    jm, variables, tm, x, _ = _sarssl_case(kw, pretrain=False)

    def close(got, ref):
        for g, r in zip(got, ref):
            _close_arrays(g, r)

    # SARSSL.__call__(x, mask, train): no mask downstream
    _both_modes(jm, variables, tm, (jnp.asarray(x), None), (torch.from_numpy(x),), close,
                tm.downstream)


@pytest.mark.parametrize("kw", [dict(), dict(patch_shape=(16, 2), dec_model=("", "cnn"),
                                             spec_dembed=96, spat_dembed=32),
                                dict(spat_dembed=0, global_model="transformer")],
                         ids=["default", "f_first-cnn", "spec-only-transformer"])
def test_mc_conformer_matches_jax(kw):
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, **kw})
    nf, nt, nreim, nmic = jcfg.sig_shape
    x = _rand((3, nmic, nf, nt, nreim), 8)
    jm = JMCConformer(jcfg)
    tm = MCConformer(SARSSLConfig(**jcfg.__dict__), device="cpu")
    variables = _variables(jm, tm, jnp.asarray(x), False, rngs={"params": jax.random.key(8)})
    assert tm(torch.from_numpy(x)).shape == (3, nf, nt, nreim, nmic)
    _both_modes(jm, variables, tm, (jnp.asarray(x),), (torch.from_numpy(x),), _close_arrays)


# --------------------------------------------------------------------------
# remat against the plain path (no JAX)
# --------------------------------------------------------------------------
def _grads_equal(a, b):
    ga = {n: p.grad for n, p in a.named_parameters()}
    gb = {n: p.grad for n, p in b.named_parameters()}
    assert set(ga) == set(gb)
    for n in ga:
        assert (ga[n] is None) == (gb[n] is None), n
        if ga[n] is not None:
            assert torch.equal(ga[n], gb[n]), n


def test_conformer_remat_equals_plain_with_dropout():
    """Output, input and parameter gradients, running stats and the
    generator's state after the step: all equal to the plain encoder's, with
    dropout 0.1 (the recomputation replays the forward's seeds)."""
    x, g = (torch.from_numpy(_rand((2, 10, 32), s)) for s in (9, 10))
    runs = {}
    for remat in (False, True):
        m = ConformerEncoder(32, 2, num_heads=4, dropout=0.1,
                             generator=torch.Generator().manual_seed(3), remat=remat)
        gen = torch.Generator().manual_seed(4)
        xr = x.clone().requires_grad_()
        y = m(xr, True, gen)
        y.backward(g)
        runs[remat] = (m, y, xr.grad, gen.get_state())
    (pm, py, pdx, pstate), (rm, ry, rdx, rstate) = runs[False], runs[True]
    assert torch.equal(py, ry) and torch.equal(pdx, rdx)
    assert torch.equal(pstate, rstate)
    _grads_equal(pm, rm)
    for (n, a), (_, b) in zip(pm.named_buffers(), rm.named_buffers()):
        assert torch.equal(a, b), n


def test_remat_cnn_step_equals_plain():
    """A pretrain step with ``remat_cnn`` from the same weights, mask and
    generator: loss, parameters after the update, running stats (updated
    once, not again by the recomputation) and generator state equal."""
    cfg = SARSSLConfig(**{**CFG.__dict__, "dropout": 0.1})
    wave, _ = synth_batch(np.random.default_rng(2), 4, NSAMPLE)
    feat = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)
    runs = {}
    for remat in (False, True):
        model = SARSSL(SARSSLConfig(**{**cfg.__dict__, "remat_cnn": remat}), device="cpu",
                       seed=1)
        state = create_train_state(model)
        gen = torch.Generator().manual_seed(5)
        met = make_pretrain_step(model, feat, device="cpu")(state, wave, LR, gen)
        runs[remat] = (model, met["loss"], gen.get_state())
    (pm, pl, ps), (rm, rl, rs) = runs[False], runs[True]
    assert torch.equal(pl, rl) and torch.equal(ps, rs)
    for (n, a), (_, b) in zip(pm.state_dict().items(), rm.state_dict().items()):
        assert torch.equal(a, b), n
