"""The port's checkpoint files against the JAX package's.

* The codec (``sarssl_torch.train.msgpack``) against
  ``flax.serialization``: the same bytes for a train state's payload (f32,
  f16, int32 and bool arrays, 0-d arrays, a numpy scalar, ``epoch=-1``,
  ``max_score=-inf``), the same tree on reading, the committed trained
  checkpoint re-encoded to its exact bytes, chunked arrays both ways.
* ``to_jax_params`` inverts ``from_jax_params`` leaf for leaf.
* Files both ways: a port checkpoint restored by JAX's ``restore_state(...,
  restore_opt=True)`` and a JAX checkpoint restored by the port's hold the
  same params, batch_stats and opt_state (exactly: f32 copied). After a JAX
  checkpoint, three more steps on each side (replayed masks, dropout 0) give
  the same losses at ``tests/test_torch_train.py``'s rtol 1e-4.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train import make_pretrain_step as j_pretrain_step  # noqa: E402
from sarssl_tpu.train.state import make_adam  # noqa: E402
from sarssl_torch.data.synthetic import synth_batch  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig, PatchMask  # noqa: E402
from sarssl_torch.train import checkpoint as ckpt  # noqa: E402
from sarssl_torch.train import create_train_state, make_pretrain_step  # noqa: E402
from sarssl_torch.train import msgpack as codec  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params, to_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "exp", "pretrain_r5_ctf_s101", "best_model_f16.msgpack")
NB = 4
LR = 1e-3
JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
TFEAT = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)


def _torch_mask(mask):
    return PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                       else torch.tensor(np.asarray(t)).long() for t in mask))


def _wave():
    wave, _ = synth_batch(np.random.default_rng(0), NB, NSAMPLE)
    return wave


def _jax_state(tx=None):
    nf, nt, nreim, nmic = JCFG.sig_shape
    jm = JSARSSL(JCFG)
    mask0 = gen_patch_mask(jax.random.key(0), NB, JCFG.npatch, JCFG.effective_nmasked())
    state = j_create_state(jm, jax.random.key(1), jnp.zeros((NB, nmic, nf, nt, nreim)), mask0,
                           tx=make_adam(LR) if tx is None else tx)
    return jm, state


def _port_from(jstate):
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu")
    params, buffers = from_jax_params(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    model.load_state_dict({**params, **buffers}, strict=True)
    return create_train_state(model, lr=LR)


def _steps(jm, jstate, state, n, key):
    """``n`` steps on each side (the port's masks replayed from JAX's keys);
    returns the new JAX state and both sides' losses."""
    wave = _wave()
    jstep = j_pretrain_step(jm, FEAT, donate=False)
    step = make_pretrain_step(state.model, TFEAT, device="cpu")
    jl, tl = [], []
    for _ in range(n):
        key, sub = jax.random.split(key)
        jstate, m = jstep(jstate, jnp.asarray(wave), LR, sub)
        jl.append(float(m["loss"]))
        rng_mask, _ = jax.random.split(sub)
        mask = gen_patch_mask(rng_mask, NB, JCFG.npatch, JCFG.effective_nmasked(), nmic=2)
        tl.append(step(state, wave, LR, torch.Generator(), mask=_torch_mask(mask))["loss"].item())
    return jstate, jl, tl


def _flat(tree):
    return flatten_dict(serialization.to_state_dict(jax.device_get(tree)), keep_empty_nodes=True)


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(got[k]).dtype == w.dtype and np.shape(got[k]) == np.shape(w), k
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def _same_decoded(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_decoded(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), (path, got, want)


@pytest.fixture(scope="module")
def payload():
    """A tiny train state's checkpoint payload, widened to every leaf kind."""
    _, jstate = _jax_state()
    params = serialization.to_state_dict(jax.device_get(jstate.params))
    return {
        "meta": {"epoch": -1, "max_score": -math.inf, "stored_dtype": "float16"},
        "params": params,
        "batch_stats": serialization.to_state_dict(jax.device_get(jstate.batch_stats)),
        "opt_state": serialization.to_state_dict(jax.device_get(jstate.opt_state)),
        "extra": {"f16": params["decoder"]["proj0"]["kernel"].astype(np.float16),
                  "i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
                  "mask": np.array([[True, False], [False, True]]),
                  "zero_d": np.zeros((), np.float32), "scalar": np.float32(1.5),
                  "count": np.int32(7)},
    }


def test_codec_writes_flax_bytes(payload):
    assert codec.msgpack_serialize(payload) == serialization.msgpack_serialize(payload)


def test_codec_reads_what_flax_reads(payload):
    blob = serialization.msgpack_serialize(payload)
    _same_decoded(codec.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_codec_reencodes_committed_checkpoint_exactly():
    with open(TRAINED, "rb") as f:
        blob = f.read()
    tree = codec.msgpack_restore(blob)
    _same_decoded(tree, serialization.msgpack_restore(blob))
    assert codec.msgpack_serialize(tree) == blob


def test_codec_chunked_arrays_both_ways(payload, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 4096)
    blob = serialization.msgpack_serialize(payload)
    assert b"__msgpack_chunked_array__" in blob
    assert codec.msgpack_serialize(payload) == blob
    ours = codec.msgpack_restore(blob)
    _same_decoded(ours, serialization.msgpack_restore(blob))
    _same_decoded(serialization.msgpack_restore(codec.msgpack_serialize(ours)), ours)


@pytest.mark.parametrize("pretrain", [True, False], ids=["pretext", "downstream"])
def test_to_jax_params_inverts_from_jax_params(pretrain):
    jcfg = type(CFG)(**{**CFG.__dict__, "pretrain": pretrain})
    nf, nt, nreim, nmic = jcfg.sig_shape
    mask = gen_patch_mask(jax.random.key(0), 2, jcfg.npatch, jcfg.effective_nmasked())
    variables = jax.tree.map(np.asarray, JSARSSL(jcfg).init(
        {"params": jax.random.key(1)}, jnp.zeros((2, nmic, nf, nt, nreim)),
        mask if pretrain else None, False))
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    params, buffers = from_jax_params(variables)
    model.load_state_dict({**params, **buffers}, strict=True)
    _assert_trees_equal(to_jax_params(model), variables)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, jstate = _jax_state()
    state = _port_from(jstate)
    _steps(jm, jstate, state, 2, jax.random.key(5))  # moments non-zero
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, max_score=-math.inf, is_best=True)
    assert sorted(os.listdir(tmp_path)) == ["best_model.msgpack", "latest_model.msgpack",
                                            "model1.msgpack"]
    payload = jckpt.load_checkpoint(jckpt.latest_path(str(tmp_path)))
    assert payload["meta"] == {"epoch": 1, "max_score": -math.inf}
    restored = jckpt.restore_state(jstate, payload, restore_opt=True)
    want = to_jax_params(state.model)
    _assert_trees_equal(restored.params, want["params"])
    _assert_trees_equal(restored.batch_stats, want["batch_stats"])
    _assert_trees_equal(restored.opt_state, state.optimizer.state_dict())
    assert int(restored.opt_state.inner_state[-1][0].count) == 2


def test_jax_checkpoint_restores_in_port_and_training_goes_on(tmp_path):
    jm, jstate = _jax_state()
    fresh = _port_from(jstate)
    jstate, _, _ = _steps(jm, jstate, _port_from(jstate), 2, jax.random.key(5))
    jckpt.save_checkpoint(str(tmp_path), jstate, epoch=4, max_score=-0.25)
    payload = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path)))
    assert payload["meta"] == {"epoch": 4, "max_score": -0.25}
    state = ckpt.restore_state(fresh, payload, restore_opt=True)
    got = to_jax_params(state.model)
    _assert_trees_equal(got["params"], jstate.params)
    _assert_trees_equal(got["batch_stats"], jstate.batch_stats)
    _assert_trees_equal(state.optimizer.state_dict(), jstate.opt_state)
    assert state.optimizer.count == 2
    _, jl, tl = _steps(jm, jstate, state, 3, jax.random.key(6))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_restore_casts_f16_leaves_up_and_checks_the_optimizer_chain(tmp_path):
    _, jstate = _jax_state()
    f16 = jax.tree.map(lambda a: np.asarray(a).astype(np.float16),
                       {"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = _port_from(jstate)
    ckpt.restore_state(state, {"meta": {}, **f16}, restore_opt=False)
    got = to_jax_params(state.model)
    for tree, ref in ((got["params"], f16["params"]), (got["batch_stats"], f16["batch_stats"])):
        for k, v in flatten_dict(ref).items():
            assert flatten_dict(tree)[k].dtype == np.float32
            np.testing.assert_array_equal(flatten_dict(tree)[k], v.astype(np.float32))
    # a JAX state made with make_adam's options (AdamW, clipping) holds
    # another chain, which the port's make_adam(lr) does not read
    _, other = _jax_state(make_adam(LR, weight_decay=1e-2, grad_clip=0.5))
    with pytest.raises(ValueError, match="chain"):
        state.optimizer.load_state_dict(serialization.to_state_dict(jax.device_get(
            other.opt_state)))


def test_save_named_ensemble_and_epoch_removal(tmp_path):
    _, jstate = _jax_state()
    state = _port_from(jstate)
    path = ckpt.save_named(str(tmp_path), state, "ensemble_model", epoch=3, max_score=0.5)
    assert path == ckpt.ensemble_path(str(tmp_path))
    payload = jckpt.load_checkpoint(path)
    assert payload["meta"] == {"epoch": 3, "max_score": 0.5} and "opt_state" not in payload
    rng = np.random.default_rng(0)
    trees = [jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
                          jstate.params) for _ in range(3)]
    want = jckpt.ensemble_params(trees)
    dicts = [from_jax_params({"params": t})[0] for t in trees]
    got = ckpt.ensemble_params(dicts)
    for name, ref in from_jax_params({"params": want})[0].items():
        np.testing.assert_array_equal(got[name].numpy(), ref.numpy(), err_msg=name)
    for e in (0, 1):
        ckpt.save_checkpoint(str(tmp_path), state, e, 0.0)
    ckpt.remove_checkpoint_epochs(str(tmp_path), [0, 5])
    assert not os.path.exists(ckpt.epoch_path(str(tmp_path), 0))
    assert os.path.exists(ckpt.epoch_path(str(tmp_path), 1))
