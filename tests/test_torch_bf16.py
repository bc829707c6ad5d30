"""bf16 compute in the port against the JAX package: ``SARSSL.pretext`` and
the downstream head at ``dtype="bfloat16"`` on the tiny config, with a
replayed mask and dropout 0, in eval and train mode.

First every module's output dtype must be the JAX module's (flax's
``capture_intermediates`` against forward hooks): the two sides round to
bf16 at the same points (LayerNorm and BatchNorm compute in f32 and return
bf16, the residual stream and the decoder stay bf16, the loss reads the
prediction in f32).

Tolerances. bf16 keeps 8 significant bits, so each rounding moves a value by
up to 2^-8 of itself, and the two sides round at the same points but sum in
different orders, so their roundings differ independently. The deepest chain
here (CNN front end, conformer block, decoder or head) has about 40 roundings;
independent errors add as sqrt(40) * 2^-8 = 2.5e-2 of the largest magnitude,
the bound on ``pred`` and ``embed``. The loss averages N = 2048 squared
errors whose first-order terms cancel as sqrt(N): 2 * 2.5e-2 / sqrt(2048) =
1.1e-3, held at rtol 2e-3. ``diff`` reads only the f32 features: rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask, stft_features as j_stft_features  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask, stft_features  # noqa: E402
from sarssl_torch.utils.weights import _flax_path, from_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

NB = 4
TOL_OUT = 2.5e-2  # sqrt(40) * 2**-8, relative to max |JAX|
TOL_LOSS = 2e-3
TOL_DIFF = 1e-5


def _case(pretrain):
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "dtype": "bfloat16",
                        "pretrain": pretrain})
    wave, _ = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    x = j_stft_features(jnp.asarray(wave), FEAT)
    jmask = gen_patch_mask(jax.random.key(3), x.shape[0], jcfg.npatch, jcfg.effective_nmasked())
    jm = JSARSSL(jcfg)
    variables = jm.init({"params": jax.random.key(1)}, x, jmask if pretrain else None, False)
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    params, buffers = from_jax_params(jax.tree.map(np.asarray, variables))
    model.load_state_dict({**params, **buffers}, strict=True)
    tx = stft_features(torch.from_numpy(wave), FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft))
    mask = PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in jmask))
    if not pretrain:
        jmask = mask = None
    return jm, variables, x, jmask, model, tx, mask


def _torch_forward(model, tx, mask, train):
    model.train(train)
    with torch.no_grad():
        if mask is not None:
            return model.pretext(tx, mask, train, torch.Generator())
        return model.downstream(tx, train, torch.Generator())


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("pretrain", [True, False], ids=["pretext", "downstream"])
def test_bf16_cast_points_match_jax(pretrain):
    jm, variables, x, jmask, model, tx, mask = _case(pretrain)
    _, inter = jm.apply(variables, x, jmask, True, capture_intermediates=True,
                        mutable=["intermediates", "batch_stats"])
    want = {}
    for path, outs in flatten_dict(inter["intermediates"]).items():
        want["/".join(path[:-1])] = [str(leaf.dtype) for leaf in jax.tree.leaves(outs)]
    got = {}

    def hook(name):
        def record(module, inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            flax_name = "/".join(_flax_path(name + ".leaf")[0])
            got[flax_name] = [str(o.dtype)[6:] for o in outs if torch.is_tensor(o)]
        return record

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(hook(name))
    _torch_forward(model, tx, mask, True)
    shared = sorted(set(got) & set(want))
    assert len(shared) >= 40, shared
    for name in shared:
        assert got[name] == want[name][:len(got[name])], (name, got[name], want[name])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_pretext_matches_jax(train):
    jm, variables, x, jmask, model, tx, mask = _case(True)
    if train:
        (jloss, jdiff, jaux), _ = jm.apply(variables, x, jmask, True, mutable=["batch_stats"])
    else:
        jloss, jdiff, jaux = jm.apply(variables, x, jmask, False)
    loss, diff, aux = _torch_forward(model, tx, mask, train)
    assert aux["pred"].dtype == torch.bfloat16 and jaux["pred"].dtype == jnp.bfloat16
    assert _rel(aux["pred"], jaux["pred"]) <= TOL_OUT
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL_LOSS)
    np.testing.assert_allclose(diff.item(), float(jdiff), rtol=TOL_DIFF)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_downstream_head_matches_jax(train):
    jm, variables, x, _, model, tx, _ = _case(False)
    if train:
        (jpred, jembed), _ = jm.apply(variables, x, None, True, mutable=["batch_stats"])
    else:
        jpred, jembed = jm.apply(variables, x, None, False)
    pred, embed = _torch_forward(model, tx, None, train)
    assert pred.dtype == torch.float32 and embed.dtype == torch.bfloat16
    assert jembed.dtype == jnp.bfloat16
    assert _rel(pred, jpred) <= TOL_OUT
    assert _rel(embed, jembed) <= TOL_OUT
