"""The port's downstream path against ``sarssl_tpu``: the head's forward,
the finetune and lineareval steps, the eval step, the target transform,
``partial_load`` / ``trainable_mask_from_loaded`` and the weight converter
on a downstream tree. Tiny config (``tests/tiny.py``), f32, dropout 0.

Tolerances (f32 on both sides): outputs, losses and BatchNorm stats rtol 1e-4
/ atol 1e-5 (sums run in another order). Parameters after 3 Adam steps as in
``test_torch_train.py``: every element within 3 * lr, all but 0.1% within
2e-5 (Adam divides each gradient element by its own magnitude, so elements
whose gradient is ~0 move by up to lr in a direction set by rounding). The
attention key biases, whose exact gradient is 0, may move that far on each
side in opposite directions, so they are held to 6 * lr.
BatchNorm stats after 3 steps: atol 3e-5, as they are read through those
parameters. Frozen parameters: exact. The targets: exact but for log10 (SUR,
VOL), which the two libraries may round an ulp apart: rtol 2e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_downstream_eval_step as j_eval_step  # noqa: E402
from sarssl_tpu.train import make_downstream_step as j_step  # noqa: E402
from sarssl_tpu.train.checkpoint import partial_load as j_partial_load  # noqa: E402
from sarssl_tpu.train.checkpoint import trainable_mask_from_loaded as j_mask  # noqa: E402
from sarssl_tpu.train.steps import _target_transform as j_target  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.train import (create_train_state, make_downstream_eval_step,  # noqa: E402
                                make_downstream_step, partial_load,
                                trainable_mask_from_loaded)
from sarssl_torch.train.steps import _target_transform  # noqa: E402
from sarssl_torch.utils.weights import _key, from_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
NB = 4
EMBEDS = ["spec_spat", "spec", "spat", "noinfo"]
TASKS = ["TDOA", "SUR", "VOL", "DRR", "T60", "C50", "C80", "ABS", "SNR", "DOA"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    params, buffers = from_jax_params(_np_tree(variables))
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def _jcfg(pretrain=False, embed="spec_spat", dlabel=1):
    return type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": pretrain,
                        "downstream_embed": embed, "downstream_dlabel": dlabel})


def _port(jcfg):
    return SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")


def _x0():
    nf, nt, nreim, nmic = CFG.sig_shape
    return jnp.zeros((NB, nmic, nf, nt, nreim))


def _pretext_variables(seed=5):
    jcfg = _jcfg(pretrain=True)
    mask = gen_patch_mask(jax.random.key(0), NB, jcfg.npatch, jcfg.effective_nmasked())
    return JSARSSL(jcfg).init({"params": jax.random.key(seed)}, _x0(), mask, False)


def _torch_name(jax_key: str) -> str:
    """A JAX ``partial_load`` key ('a/b/kernel') as the port's parameter name."""
    *path, leaf = jax_key.split("/")
    return _key(path, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))


def _close_stats(model, jax_stats, atol=TOL["atol"]):
    _, ref = from_jax_params({"params": {}, "batch_stats": _np_tree(jax_stats)})
    got = dict(model.named_buffers())
    assert set(ref) == set(got)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), err_msg=name,
                                   rtol=TOL["rtol"], atol=atol)


@pytest.mark.parametrize("dlabel", [1, 2])
@pytest.mark.parametrize("embed", EMBEDS)
def test_downstream_forward_matches(embed, dlabel):
    jcfg = _jcfg(embed=embed, dlabel=dlabel)
    nf, nt, nreim, nmic = jcfg.sig_shape
    x = np.random.default_rng(1).standard_normal((NB, nmic, nf, nt, nreim)).astype(np.float32)
    jm = JSARSSL(jcfg)
    variables = jm.init({"params": jax.random.key(2)}, jnp.asarray(x), None, False)
    tm = _load(_port(jcfg), variables)
    for train in (False, True):  # eval first: train mode updates the stats
        if train:
            (pred, emb), mut = jm.apply(variables, jnp.asarray(x), None, True,
                                        mutable=["batch_stats"])
        else:
            pred, emb = jm.apply(variables, jnp.asarray(x), None, False)
        tpred, temb = tm(torch.from_numpy(x), None, train)
        assert tpred.dtype == torch.float32 and tpred.shape == (NB, dlabel)
        np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(pred), **TOL)
        np.testing.assert_allclose(temb.detach().numpy(), np.asarray(emb), **TOL)
    _close_stats(tm, mut["batch_stats"])
    if embed == "noinfo":  # zeros without gradient: nothing reaches the encoders
        tpred.sum().backward()
        assert all(p.grad is None for n, p in tm.named_parameters()
                   if n.startswith(("spec_encoder.", "spat_encoder.")))


@pytest.fixture(scope="module", params=["finetune", "lineareval"])
def stepped(request):
    """3 steps of each side from the same init with a partial_load'ed
    pretext trunk; lineareval freezes what was loaded."""
    lineareval = request.param == "lineareval"
    jcfg = _jcfg()
    wave, tdoa = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    gt = tdoa / 16000.0  # seconds, as the JAX synthetic path feeds it
    pre_vars = _pretext_variables()
    jm = JSARSSL(jcfg)
    jstate = j_create_state(jm, jax.random.key(1), _x0(), None)
    model = _load(_port(jcfg), {"params": jstate.params, "batch_stats": jstate.batch_stats})
    jparams, jloaded = j_partial_load(
        jstate.params, serialization.to_state_dict(jax.device_get(pre_vars["params"])))
    jstate = jstate.replace(params=jparams, opt_state=jstate.tx.init(jparams))
    loaded = partial_load(model, _load(_port(_jcfg(pretrain=True)), pre_vars).state_dict())
    assert sorted(loaded) == sorted(map(_torch_name, jloaded))
    jtm = j_mask(jparams, jloaded) if lineareval else None
    tmask = trainable_mask_from_loaded(model, loaded) if lineareval else None
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    state = create_train_state(model)
    step = make_downstream_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                                "TDOA", tmask, device="cpu")
    jstep = j_step(jm, FEAT, "TDOA", donate=False, trainable_mask=jtm)
    key = jax.random.key(3)
    jm_, tm_ = [], []
    for _ in range(3):
        key, sub = jax.random.split(key)
        jstate, m = jstep(jstate, jnp.asarray(wave), jnp.asarray(gt), LR, sub)
        jm_.append((float(m["loss"]), float(m["mae"])))
        t = step(state, wave, gt, LR, torch.Generator().manual_seed(0))
        tm_.append((t["loss"].item(), t["mae"].item()))
    return dict(jstate=jstate, state=state, jmetrics=jm_, tmetrics=tm_, loaded=loaded,
                start=start, lineareval=lineareval)


def test_downstream_step_losses_match(stepped):
    np.testing.assert_allclose(stepped["tmetrics"], stepped["jmetrics"], rtol=1e-4)
    assert stepped["state"].step == 3


def test_downstream_step_params_match(stepped):
    ref, _ = from_jax_params(_np_tree({"params": stepped["jstate"].params}))
    got = dict(stepped["state"].model.named_parameters())
    assert set(ref) == set(got)
    n_far = n_all = 0
    for name, r in ref.items():
        diff = np.abs(got[name].detach().numpy() - r.numpy())
        # softmax is invariant to the key bias, so its exact gradient is 0 and
        # each side steps by up to lr per step on rounding noise alone, each
        # in its own direction: 2 * 3 * lr apart at most
        bound = 6 * LR if name.endswith("mhsa.key.bias") else 3 * LR
        assert diff.max() <= bound, (name, diff.max())
        n_far += int((diff > 2e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_downstream_step_batch_stats_match(stepped):
    # steps 2 and 3 read their stats through parameters that already differ
    # by up to 2e-5 (see the parameter tolerance), hence atol 3e-5
    _close_stats(stepped["state"].model, stepped["jstate"].batch_stats, atol=3e-5)
    # the encoders' stats moved in both modes (lineareval freezes params only)
    bufs = dict(stepped["state"].model.named_buffers())
    assert not torch.equal(bufs["spec_encoder.front.bn1.running_mean"],
                           torch.zeros_like(bufs["spec_encoder.front.bn1.running_mean"]))


def test_downstream_step_frozen_params_bit_identical(stepped):
    ref, _ = from_jax_params(_np_tree({"params": stepped["jstate"].params}))
    model, start = stepped["state"].model, stepped["start"]
    loaded = set(stepped["loaded"])
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), start[name])
        if stepped["lineareval"] and name in loaded:
            assert not moved, name
            assert torch.equal(p.detach(), ref[name]), name  # JAX's frozen leaf, bit for bit
        elif name.startswith("head_proj"):
            assert moved, name
    if not stepped["lineareval"]:
        assert not torch.equal(model.spec_encoder.front.conv1.weight.detach(),
                               start["spec_encoder.front.conv1.weight"])


@pytest.mark.parametrize("dlabel", [1, 2])
def test_downstream_eval_step_matches(dlabel):
    jcfg = _jcfg(dlabel=dlabel)
    wave, _ = synth_batch(np.random.default_rng(4), NB, NSAMPLE)
    gt = np.random.default_rng(5).uniform(-6e-4, 6e-4, (NB, 3)).astype(np.float32)
    jm = JSARSSL(jcfg)
    jstate = j_create_state(jm, jax.random.key(6), _x0(), None)
    model = _load(_port(jcfg), {"params": jstate.params, "batch_stats": jstate.batch_stats})
    ref = j_eval_step(jm, FEAT, "TDOA", dlabel)(jstate, jnp.asarray(wave), jnp.asarray(gt))
    out = make_downstream_eval_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                                    "TDOA", dlabel, device="cpu")(create_train_state(model),
                                                                  wave, gt)
    assert set(out) == set(ref)
    assert ("mae_dims" in out) == (dlabel > 1)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("dlabel", [1, 2])
@pytest.mark.parametrize("task", TASKS)
def test_target_transform_matches(task, dlabel):
    gt = np.random.default_rng(7).uniform(0.1, 3.0, (NB, 1, 3)).astype(np.float32)
    ref = np.asarray(j_target(task, jnp.asarray(gt), dlabel))
    out = _target_transform(task, torch.from_numpy(gt), dlabel).numpy()
    assert out.shape == ref.shape == (NB, dlabel)
    # exact but for log10, which the two libraries round within an ulp
    np.testing.assert_allclose(out, ref, rtol=2e-7, atol=0)


def test_partial_load_copies_params_only():
    """The same loaded set as JAX's partial_load; BatchNorm running stats,
    which the JAX downstream run never loads, stay the target's own."""
    pre = _load(_port(_jcfg(pretrain=True)), _pretext_variables())
    for name, buf in pre.named_buffers():
        buf.fill_(0.5)
    jcfg = _jcfg()
    variables = JSARSSL(jcfg).init({"params": jax.random.key(8)}, _x0(), None, False)
    model = _load(_port(jcfg), variables)
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    loaded = partial_load(model, pre.state_dict())
    _, jloaded = j_partial_load(
        variables["params"],
        serialization.to_state_dict(jax.device_get(_pretext_variables()["params"])))
    assert sorted(loaded) == sorted(map(_torch_name, jloaded))
    encoders = [n for n, _ in model.named_parameters() if not n.startswith("head_")]
    assert sorted(loaded) == sorted(encoders)
    src = pre.state_dict()
    for name, p in model.named_parameters():
        if name in loaded:
            assert torch.equal(p.detach(), src[name]), name
    for name, b in model.named_buffers():
        assert torch.equal(b, bufs[name]), name


def test_partial_load_strips_prefix_and_skips_other_shapes():
    pre = _load(_port(_jcfg(pretrain=True)), _pretext_variables())
    model = _port(_jcfg())
    src = {f"trunk.{k}": v for k, v in pre.state_dict().items()}
    src["trunk.spec_encoder.front.conv1.weight"] = torch.zeros(3, 3)
    loaded = partial_load(model, src, ex_prefix="trunk.")
    assert "spec_encoder.front.conv1.weight" not in loaded
    assert "spec_encoder.front.conv2.weight" in loaded
    assert partial_load(_port(_jcfg()), src) == []  # no prefix stripped, no name matches


def test_trainable_mask_from_loaded_matches_jax():
    jcfg = _jcfg()
    variables = JSARSSL(jcfg).init({"params": jax.random.key(9)}, _x0(), None, False)
    jparams, jloaded = j_partial_load(
        variables["params"],
        serialization.to_state_dict(jax.device_get(_pretext_variables()["params"])))
    ref = {_torch_name("/".join(k)): bool(v) for k, v in flatten_dict(
        serialization.to_state_dict(j_mask(jparams, jloaded))).items()}
    model = _load(_port(jcfg), variables)
    mask = trainable_mask_from_loaded(model, partial_load(model, _load(
        _port(_jcfg(pretrain=True)), _pretext_variables()).state_dict()))
    assert mask == ref
    assert mask["head_proj.weight"] and not mask["spat_encoder.front.conv1.weight"]


@pytest.mark.parametrize("dlabel", [1, 2])
def test_from_jax_params_maps_a_downstream_tree(dlabel):
    jcfg = _jcfg(dlabel=dlabel)
    variables = _np_tree(JSARSSL(jcfg).init({"params": jax.random.key(10)}, _x0(), None, False))
    params, buffers = from_jax_params(variables)
    assert len(params) + len(buffers) == len(jax.tree.leaves(variables))
    assert not any(n.startswith("decoder.") for n in params)
    model = _port(jcfg)
    model.load_state_dict({**params, **buffers}, strict=True)  # no leaf unmapped
    head = variables["params"]
    np.testing.assert_array_equal(model.head_proj.weight.detach().numpy(),
                                  head["head_proj"]["kernel"].T)
    np.testing.assert_array_equal(model.head_norm.weight.detach().numpy(),
                                  head["head_norm"]["scale"])
    assert hasattr(model, "head_hidden") == (dlabel > 1)


def test_downstream_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    model = _port(_jcfg())
    with pytest.raises(RuntimeError, match="cuda"):
        make_downstream_step(model)
    with pytest.raises(RuntimeError, match="cuda"):
        make_downstream_eval_step(model)
