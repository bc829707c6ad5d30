"""The port's DPIPD templates, utils and ``make_adam`` options against
``sarssl_tpu`` / optax.

* ``ops/dpipd.py``: templates and DOA IPDs, 'M' and 'MM' pairs; complex64 of
  modulus 1, atol 1e-5 (phases up to ~30 rad in f32 on both sides).
* ``utils/metrics.py``: ``forgetting_norm`` (rtol 1e-5 / atol 1e-6, f32, the
  same recurrence), ``estimate_flops`` (a matmul exactly; a tiny ``SARSSL``
  downstream forward against XLA's cost analysis, which also counts
  elementwise work: the port reads 1.10x XLA's there, held within 0.5x-2x),
  ``detect_nonfinite``; ``utils/profiling.py``: ``StepTimer``, ``sync``,
  ``trace``.
* ``make_adam(lr, weight_decay=..., grad_clip=...)``: the update against
  optax's on seeded gradients (clipping active and not) over 3 steps, rtol
  1e-5 / atol 1e-7, and the state in optax's tree; then 3 tiny ``SARSSL``
  downstream steps against the JAX step with weight decay, with clipping and
  with both (lineareval: frozen parameters bit-identical), held as
  ``tests/test_torch_downstream.py`` holds Adam's (every element within 3 lr
  a step, all but 0.1% within 2e-5), but for finetuning with clipping: all
  but 1% within 2e-5 (see the test); the optimizer state written by each
  package and restored by the other, byte for byte.
"""
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import dpipd as jdpipd  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_downstream_step as j_step  # noqa: E402
from sarssl_tpu.train.checkpoint import partial_load as j_partial_load  # noqa: E402
from sarssl_tpu.train.checkpoint import trainable_mask_from_loaded as j_mask  # noqa: E402
from sarssl_tpu.train.state import make_adam as j_make_adam  # noqa: E402
from sarssl_tpu.utils import metrics as jmetrics  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.ops.dpipd import dpipd_for_doa, dpipd_template  # noqa: E402
from sarssl_torch.train import (create_train_state, make_adam,  # noqa: E402
                                make_downstream_step, partial_load, trainable_mask_from_loaded)
from sarssl_torch.train import checkpoint as ckpt  # noqa: E402
from sarssl_torch.utils import detect_nonfinite  # noqa: E402
from sarssl_torch.utils.metrics import estimate_flops, forgetting_norm  # noqa: E402
from sarssl_torch.utils.profiling import StepTimer, sync, trace  # noqa: E402
from sarssl_torch.utils.weights import flax_tree, from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

TOL_DPIPD = 1e-5
TOL_OPT = dict(rtol=1e-5, atol=1e-7)
LR = 1e-3
NB = 4
WD, CLIP = 1e-2, 1.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small ops, restored after the module:
    with one per core they oversubscribe a host whose cores the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return flatten_dict(serialization.to_state_dict(jax.device_get(tree)), keep_empty_nodes=True)


# ------------------------------------------------------------------ DPIPD

@pytest.mark.parametrize("ch_mode,nmic", [("M", 2), ("M", 4), ("MM", 4)])
def test_dpipd_template_matches(ch_mode, nmic):
    mic = _rand((nmic, 3), 0) * 0.1
    want, (jele, jazi) = jdpipd.dpipd_template(mic, (5, 9), nf=17, ch_mode=ch_mode)
    got, (ele, azi) = dpipd_template(mic, (5, 9), nf=17, ch_mode=ch_mode, device="cpu")
    npair = nmic - 1 if ch_mode == "M" else nmic * (nmic - 1) // 2
    assert got.shape == (5, 9, 17, npair) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_DPIPD)
    np.testing.assert_allclose(ele.numpy(), np.asarray(jele), rtol=1e-6)
    np.testing.assert_allclose(azi.numpy(), np.asarray(jazi), rtol=1e-6)


@pytest.mark.parametrize("ch_mode,nmic", [("M", 2), ("MM", 4)])
def test_dpipd_for_doa_matches(ch_mode, nmic):
    mic = _rand((nmic, 3), 1) * 0.1
    rng = np.random.default_rng(2)
    doa = np.stack([rng.uniform(0, np.pi, (2, 3, 2)), rng.uniform(-np.pi, np.pi, (2, 3, 2))],
                   axis=2).astype(np.float32)  # (nb, nt, 2, nsrc)
    want = np.asarray(jdpipd.dpipd_for_doa(jnp.asarray(doa), mic, nf=17, ch_mode=ch_mode))
    got = dpipd_for_doa(torch.tensor(doa), mic, nf=17, ch_mode=ch_mode)
    assert tuple(got.shape) == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_DPIPD)


def test_dpipd_template_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dpipd_template(np.zeros((2, 3)))


# ------------------------------------------------------------------ utils

@pytest.mark.parametrize("num_frame_set", [None, 10])
def test_forgetting_norm_matches(num_frame_set):
    x = np.abs(_rand((3, 2, 5, 40), 3))
    want = np.asarray(jmetrics.forgetting_norm(jnp.asarray(x), num_frame_set))
    got = forgetting_norm(torch.tensor(x), num_frame_set)
    assert tuple(got.shape) == (3, 1, 1, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    m0 = x[..., 0].reshape(3, -1).mean(1)  # alpha_0 = -1: mu_0 = 2 m_0
    np.testing.assert_allclose(got[:, 0, 0, 0].numpy(), 2 * m0, rtol=1e-6)


@pytest.fixture
def stdlib_profile(monkeypatch):
    """FlopCounterMode's first call imports torch._dynamo -> cProfile ->
    profile; tests/test_reference_parity.py puts scripts/ (with its
    profile.py) first on sys.path, so take it off for the call."""
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if os.path.basename(os.path.normpath(p)) != "scripts"])
    if "profile" in sys.modules and not hasattr(sys.modules["profile"], "run"):
        monkeypatch.delitem(sys.modules, "profile")


def test_estimate_flops_matmul_is_exact(stdlib_profile):
    assert estimate_flops(lambda x: x @ x, torch.zeros(64, 64)) == 2 * 64 ** 3 / 1e9


def test_estimate_flops_of_a_model_against_xla(stdlib_profile):
    cfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": False})
    nf, nt, nreim, nmic = cfg.sig_shape
    x = _rand((NB, nmic, nf, nt, nreim), 4)
    model = SARSSL(SARSSLConfig(**cfg.__dict__), device="cpu").eval()
    variables = to_jax_params(model)
    jm = JSARSSL(cfg)
    xla = jmetrics.estimate_flops(lambda v: jm.apply(variables, v, None, False), jnp.asarray(x))
    port = estimate_flops(lambda v: model(v, None, False), torch.tensor(x))
    assert 0.5 <= port / xla <= 2.0, (port, xla)


def test_detect_nonfinite(capsys):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    assert detect_nonfinite(model, "m") is False
    with torch.no_grad():
        model[0].weight[1, 2] = float("nan")
    model[1].running_var[0] = float("inf")
    assert detect_nonfinite(model, "m") is True
    assert capsys.readouterr().out.splitlines() == [
        "nonfinite values in m:0.weight", "nonfinite values in m:1.running_var"]
    tree = {"a": {"kernel": np.array([1.0, np.inf], np.float32)}, "count": np.int32(3),
            "b": torch.ones(2)}
    assert detect_nonfinite(tree, "opt") is True
    assert capsys.readouterr().out.strip() == "nonfinite values in opt:a/kernel"


def test_step_timer_sync_and_trace(tmp_path):
    t = StepTimer(warmup=1)
    for _ in range(4):
        t.start()
        t.stop({"loss": [torch.ones(2) * 2]})
    s = t.summary(items_per_step=10)
    assert len(t.times) == 3 and s["items_per_sec"] > 0 and s["mean_ms"] >= 0
    assert set(s) == {"mean_ms", "p50_ms", "p95_ms", "items_per_sec"}
    sync(torch.nn.Linear(2, 2))
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


# -------------------------------------------------- the optimizer alone

class _Params(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(4, 3)  # flax dense/kernel (4, 3), dense/bias
        self.norm = torch.nn.Parameter(torch.tensor(_rand((5,), 7)))  # norm: a 1-D 'scale'


LRS = (1e-3, 5e-4, 2e-3)  # the rate given at each of the 3 updates


def _grads(named, i):
    """Step i's seeded gradients; their global norm is ~4.5 * (i + 1)."""
    return {n: torch.tensor(_rand(tuple(p.shape), 10 + i)) * (i + 1) for n, p in named.items()}


def _optax_run(named, wd, clip):
    params = flax_tree(named)
    tx = j_make_adam(LR, weight_decay=wd, grad_clip=clip)
    state = tx.init(params)
    for i, lr in enumerate(LRS):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, state = tx.update(flax_tree(_grads(named, i)), state, params)
        params = optax.apply_updates(params, updates)
    return _flat(params), _flat(state)


@pytest.mark.parametrize("wd,clip", [(WD, None), (0.0, 0.05), (0.0, 1e3), (WD, 0.05)],
                         ids=["adamw", "clip-active", "clip-idle", "both"])
def test_adam_options_match_optax(wd, clip):
    module = _Params()
    named = dict(module.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    want, jstate = _optax_run(start, wd, clip)
    opt = make_adam(LR, weight_decay=wd, grad_clip=clip)(module.named_parameters())
    for i, lr in enumerate(LRS):
        for n, g in _grads(named, i).items():
            named[n].grad = g
        opt.update(lr)
    got = _flat(flax_tree(named))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=str(k), **TOL_OPT)
    sd = _flat(opt.state_dict())
    assert set(sd) == set(jstate)
    for k, v in jstate.items():
        if isinstance(v, (np.ndarray, np.generic)):
            assert np.asarray(sd[k]).dtype == v.dtype, k
            np.testing.assert_allclose(sd[k], v, err_msg=str(k), **TOL_OPT)
    if clip:  # an active clip moves the result off unclipped Adam(W)'s, an idle one does not
        unclipped, _ = _optax_run(start, wd, None)
        far = max(np.abs(got[k] - unclipped[k]).max() for k in want)
        assert (far > 1e-5) == (clip < 1.0), far


def test_adam_refuses_another_chain():
    module = _Params()
    plain = make_adam(LR)(module.named_parameters())
    with pytest.raises(ValueError, match="chain"):
        make_adam(LR, weight_decay=WD)(module.named_parameters()).load_state_dict(
            plain.state_dict())
    with pytest.raises(ValueError, match="chain"):
        make_adam(LR, grad_clip=CLIP)(module.named_parameters()).load_state_dict(
            make_adam(LR, weight_decay=WD, grad_clip=CLIP)(
                module.named_parameters()).state_dict())


# ------------------------------------- a tiny SARSSL downstream step, 3 steps

def _jcfg(pretrain=False):
    return type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": pretrain})


def _x0():
    nf, nt, nreim, nmic = CFG.sig_shape
    return jnp.zeros((NB, nmic, nf, nt, nreim))


def _load(module, variables):
    params, buffers = from_jax_params(_np_tree(variables))
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


@pytest.fixture(scope="module", params=["adamw", "clip", "both-lineareval"])
def stepped(request):
    """3 downstream steps of each side from the same init with ``make_adam``'s
    options; the last case freezes the loaded pretext trunk (lineareval)."""
    wd = WD if request.param != "clip" else 0.0
    clip = CLIP if request.param != "adamw" else None
    lineareval = request.param == "both-lineareval"
    jcfg = _jcfg()
    wave, tdoa = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    gt = tdoa / 16000.0
    jm = JSARSSL(jcfg)
    jstate = j_create_state(jm, jax.random.key(1), _x0(), None,
                            tx=j_make_adam(LR, weight_decay=wd, grad_clip=clip))
    model = _load(SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu"),
                  {"params": jstate.params, "batch_stats": jstate.batch_stats})
    jtm = tmask = None
    if lineareval:
        pcfg = _jcfg(pretrain=True)
        mask = gen_patch_mask(jax.random.key(0), NB, pcfg.npatch, pcfg.effective_nmasked())
        pre = JSARSSL(pcfg).init({"params": jax.random.key(5)}, _x0(), mask, False)
        jparams, jloaded = j_partial_load(
            jstate.params, serialization.to_state_dict(jax.device_get(pre["params"])))
        jstate = jstate.replace(params=jparams, opt_state=jstate.tx.init(jparams))
        loaded = partial_load(model, _load(SARSSL(SARSSLConfig(**pcfg.__dict__), device="cpu"),
                                           pre).state_dict())
        jtm, tmask = j_mask(jparams, jloaded), trainable_mask_from_loaded(model, loaded)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, tx=make_adam(LR, weight_decay=wd, grad_clip=clip))
    step = make_downstream_step(model, FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft),
                                "TDOA", tmask, device="cpu")
    jstep = j_step(jm, FEAT, "TDOA", donate=False, trainable_mask=jtm)
    key = jax.random.key(3)
    jl, tl = [], []
    for lr in LRS:
        key, sub = jax.random.split(key)
        jstate, m = jstep(jstate, jnp.asarray(wave), jnp.asarray(gt), lr, sub)
        jl.append(float(m["loss"]))
        tl.append(step(state, wave, gt, lr, torch.Generator().manual_seed(0))["loss"].item())
    return dict(jstate=jstate, state=state, jl=jl, tl=tl, start=start, tmask=tmask,
                clip=clip)


def test_downstream_steps_match_optax(stepped):
    np.testing.assert_allclose(stepped["tl"], stepped["jl"], rtol=1e-4)
    ref, _ = from_jax_params(_np_tree({"params": stepped["jstate"].params}))
    got = dict(stepped["state"].model.named_parameters())
    n_far = n_all = 0
    for name, r in ref.items():  # as tests/test_torch_downstream.py holds Adam's 3 steps
        diff = np.abs(got[name].detach().numpy() - r.numpy())
        bound = 6 * LR if name.endswith("mhsa.key.bias") else 3 * LR
        assert diff.max() <= bound * max(LRS) / LR, (name, diff.max())
        n_far += int((diff > 2e-5).sum())
        n_all += diff.size
    # clipped to norm 1, the trainable conv kernels' gradients fall to ~1e-6
    # and below, near Adam's eps 1e-8, where the step follows the gradient's
    # size rather than its sign: f32 rounding noise in the smallest ones then
    # shows in the step (0.49% of elements past 2e-5 read here, none past 2.3e-4)
    share = 1e-2 if stepped["clip"] and stepped["tmask"] is None else 1e-3
    assert n_far <= share * n_all, (n_far, n_all)
    assert stepped["state"].optimizer.count == 3


def test_downstream_frozen_params_bit_identical(stepped):
    ref, _ = from_jax_params(_np_tree({"params": stepped["jstate"].params}))
    frozen = {n for n, t in (stepped["tmask"] or {}).items() if not t}
    assert bool(frozen) == (stepped["tmask"] is not None)
    for name, p in stepped["state"].model.named_parameters():
        moved = not torch.equal(p.detach(), stepped["start"][name])
        if name in frozen:  # weight decay and the moments left them where they were
            assert not moved, name
            assert torch.equal(p.detach(), ref[name]), name
        elif name.startswith("head_proj") or name.endswith("front.conv1.weight"):
            assert moved, name


def test_optimizer_state_files_both_ways_byte_identical(stepped, tmp_path):
    """JAX's state after its 3 steps, loaded into the port: each package
    writes the same bytes and restores the other's file exactly."""
    jstate, state = stepped["jstate"], stepped["state"]
    payload = {"meta": {}, "params": jstate.params, "batch_stats": jstate.batch_stats,
               "opt_state": serialization.to_state_dict(jax.device_get(jstate.opt_state))}
    ckpt.restore_state(state, jax.tree.map(np.asarray, payload), restore_opt=True)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, epoch=2, max_score=-math.inf)
    ckpt.save_checkpoint(str(tmp_path / "port"), state, epoch=2, max_score=-math.inf)
    with open(jckpt.latest_path(str(tmp_path / "jax")), "rb") as f:
        jblob = f.read()
    with open(ckpt.latest_path(str(tmp_path / "port")), "rb") as f:
        assert f.read() == jblob
    restored = jckpt.restore_state(jstate, jckpt.load_checkpoint(
        ckpt.latest_path(str(tmp_path / "port"))), restore_opt=True)
    for got, want in ((restored.opt_state, jstate.opt_state),
                      (state.optimizer.state_dict(), jstate.opt_state)):
        got, want = _flat(got), _flat(want)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, (np.ndarray, np.generic)):
                np.testing.assert_array_equal(got[k], v, err_msg=str(k))
