"""The port's multi-device path (``sarssl_torch/parallel``) on the CPU: gloo
ranks spawned by ``torch.multiprocessing`` (``tests/torch_parallel_ranks.py``),
held against the world-size-1 step and against the JAX package's sharded
steps (``tests/test_parallel.py``, ``tests/test_multislice.py``, case by case).

A ``DxM`` step computes what the world-size-1 step computes: the same loss
(rel 1e-5), the gradients its update reads, and under clipping the clipped
ones (each leaf within rel 1e-5; the key biases, whose exact gradient is 0,
within 1e-6), BatchNorm running stats (1e-6), per-item predictions (1e-5) and
dropout masks (bit for bit: each rank's masks are the slices of the
world-size-1 masks), and parameters within 1e-5 but where Adam's first step
turns rounding into a step: it moves an element by ``lr * g / (|g| + eps)``,
so a gradient that is zero in exact arithmetic (the attention's key biases:
softmax is invariant to them) or below eps takes a step whose size and sign
the summation order sets. Those elements (the key biases, and at most 1e-4
of the rest) are held to ``2 * lr``.
"""
import os

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_ranks as R  # noqa: E402
from sarssl_torch.kernels import attention_plain, dropout_plain  # noqa: E402
from sarssl_torch.models import SARSSL  # noqa: E402
from sarssl_torch.parallel import (batch_sharding, global_batch_from_local,  # noqa: E402
                                   host_batch_iterator, param_pspec, shard_for_process)
from sarssl_torch.parallel.mesh import Rows, param_pspecs  # noqa: E402
from sarssl_torch.train import (create_train_state, make_adam,  # noqa: E402
                                make_downstream_eval_step, make_downstream_step,
                                make_pretrain_eval_step, make_pretrain_step)
from sarssl_torch.train import checkpoint as ckpt  # noqa: E402
from sarssl_torch.utils.weights import to_jax_params  # noqa: E402

MESHES = ["2x1", "1x2", "2x2"]
KINDS = ["pretrain", "downstream"]
# the train steps: the pretext step, the downstream step, and the pretext step
# under make_adam's global-norm clipping
STEPS = KINDS + ["clipped"]


def _world(mesh):
    d, m = map(int, mesh.split("x"))
    return d, m


def _reference():
    """The world-size-1 steps of ``R.steps_rank`` with their masks and
    gradients."""
    wave, gt = R.waves(3)
    out = {}
    model = SARSSL(R.config(True), device="cpu", seed=0)
    state = create_train_state(model)
    log, grads = R.MaskLog(), R.GradLog(state)
    met = make_pretrain_step(model, R.FEAT, device="cpu")(
        state, wave, R.LR, torch.Generator().manual_seed(5))
    out["pretrain_masks"] = log.close()
    out["pretrain_grads"], _ = grads.close()
    out["pretrain"] = {k: float(v) for k, v in met.items()}
    out["pretrain_params"], out["pretrain_buffers"] = R._full_state(model)
    out["pretrain_eval"] = {k: float(v) for k, v in make_pretrain_eval_step(
        model, R.FEAT, device="cpu")(state, wave, torch.Generator().manual_seed(9)).items()}

    model = SARSSL(R.config(True), device="cpu", seed=0)
    state = create_train_state(model, tx=make_adam(R.LR, grad_clip=R.CLIP))
    grads = R.GradLog(state)
    met = make_pretrain_step(model, R.FEAT, device="cpu")(
        state, wave, R.LR, torch.Generator().manual_seed(5))
    out["clipped_grads"], out["clipped_clipped"] = grads.close()
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in out["clipped_grads"].values()))
    assert norm > R.CLIP  # the clip binds
    out["clipped"] = {k: float(v) for k, v in met.items()}
    out["clipped_params"], out["clipped_buffers"] = R._full_state(model)

    model = SARSSL(R.config(False), device="cpu", seed=1)
    state = create_train_state(model)
    log, grads = R.MaskLog(), R.GradLog(state)
    met = make_downstream_step(model, R.FEAT, device="cpu")(
        state, wave, gt, R.LR, torch.Generator().manual_seed(6))
    out["downstream_masks"] = log.close()
    out["downstream_grads"], _ = grads.close()
    out["downstream"] = {k: float(v) for k, v in met.items()}
    out["downstream_params"], out["downstream_buffers"] = R._full_state(model)
    em = make_downstream_eval_step(model, R.FEAT, device="cpu")(state, wave, gt)
    out["downstream_eval"] = {k: float(em[k]) for k in ("loss", "mae")}
    out["pred"] = em["pred"].numpy()
    return out


@pytest.fixture(scope="module")
def runs():
    out = {"1x1": _reference()}
    for mesh in MESHES:
        d, m = _world(mesh)
        out[mesh] = R.spawn(R.steps_rank, d * m, d, m)
    return out


def _close_params(got, ref, what):
    assert set(got) == set(ref), what
    n_far = n_all = 0
    for name, r in ref.items():
        diff = np.abs(got[name] - r)
        assert diff.max() <= 2 * R.LR, (what, name, diff.max())
        if name.endswith("key.bias"):
            continue
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-4 * n_all, (what, n_far, n_all)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", STEPS)
def test_train_step_loss_matches_one_rank(runs, mesh, kind):
    ref = runs["1x1"][kind]
    for r in runs[mesh]:
        for k, v in r[kind].items():
            assert v == pytest.approx(ref[k], rel=1e-5), (mesh, kind, k)


def _close_grads(got, ref, what):
    """Each leaf within rel 1e-5 of the world-size-1 gradient (the norm of
    the difference against the leaf's norm); the key biases, whose exact
    gradient is 0, are held to the absolute size of the others' noise."""
    assert set(got) == set(ref), what
    for name, r in ref.items():
        err = float(np.linalg.norm(got[name].astype(np.float64) - r))
        scale = float(np.linalg.norm(r.astype(np.float64)))
        if name.endswith("key.bias"):
            assert err <= 1e-6, (what, name, err)
        else:
            assert err <= 1e-5 * scale, (what, name, err, scale)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", STEPS)
def test_train_step_grads_match_one_rank(runs, mesh, kind):
    """The gradients the update reads, after the data group's bucket and the
    model group's partial sums: a scale error (a leaf summed twice, a mean
    for a sum) shows here, where Adam's first step would hide it."""
    for r in runs[mesh]:
        _close_grads(r[kind + "_grads"], runs["1x1"][kind + "_grads"], (mesh, kind))


@pytest.mark.parametrize("mesh", MESHES)
def test_clipped_grads_match_one_rank(runs, mesh):
    """make_adam's clipping scales by the whole tree's norm on every rank."""
    for r in runs[mesh]:
        _close_grads(r["clipped_clipped"], runs["1x1"]["clipped_clipped"], mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", STEPS)
def test_train_step_params_match_one_rank(runs, mesh, kind):
    for r in runs[mesh]:
        _close_params(r[kind + "_params"], runs["1x1"][kind + "_params"], (mesh, kind))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", STEPS)
def test_train_step_batch_stats_match_one_rank(runs, mesh, kind):
    ref = runs["1x1"][kind + "_buffers"]
    for r in runs[mesh]:
        for name, v in ref.items():
            np.testing.assert_allclose(r[kind + "_buffers"][name], v, rtol=0, atol=1e-6,
                                       err_msg=f"{mesh} {kind} {name}")


def _place(world_mask, local, index_map, data_index, data_size):
    """The block of ``world_mask`` that a rank's ``local`` mask covers."""
    if index_map is None:
        row_local = row_total = local.size // local.shape[0]
        col = 0
    else:
        row_local, row_total, col = index_map
    rows = local.size // row_local
    w = world_mask.reshape(-1, row_total)
    assert w.shape[0] == rows * data_size
    return w[data_index * rows:(data_index + 1) * rows, col:col + row_local].reshape(local.shape)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_dropout_masks_are_slices_of_one_rank(runs, mesh, kind):
    d, m = _world(mesh)
    ref = runs["1x1"][kind + "_masks"]
    assert len(ref) > 0
    for r in runs[mesh]:
        masks = r[kind + "_masks"]
        assert len(masks) == len(ref), (mesh, kind)
        sharded = 0
        for (local, imap), (world, _) in zip(masks, ref):
            want = _place(world, local, imap, r["data_index"], d)
            assert np.array_equal(local, want), (mesh, kind, imap)
            sharded += imap is not None
        # the model ranks drop the attention probabilities and the
        # feed-forward hidden units through their index maps
        assert (sharded > 0) == (m > 1), (mesh, kind, sharded)


@pytest.mark.parametrize("mesh", MESHES)
def test_eval_steps_match_one_rank(runs, mesh):
    ref = runs["1x1"]
    for r in runs[mesh]:
        for kind in ("pretrain_eval", "downstream_eval"):
            for k, v in r[kind].items():
                assert v == pytest.approx(ref[kind][k], rel=1e-5), (mesh, kind, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_eval_pred_is_the_ranks_rows(runs, mesh):
    d, _ = _world(mesh)
    ref = runs["1x1"]["pred"]
    for r in runs[mesh]:
        rows = Rows(r["data_index"], d, torch.device("cpu"))
        np.testing.assert_allclose(r["pred"], ref[rows.slice(ref.shape[0])], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_shardings_follow_the_rules(runs, mesh):
    _, m = _world(mesh)
    model = SARSSL(R.config(True), device="cpu", seed=0)
    specs = param_pspecs(model)
    for r in runs[mesh]:
        sh = r["shardings"]
        assert set(sh) == set(specs)
        for name, spec in specs.items():
            assert (sh[name] is not None) == (m > 1 and "model" in spec), (mesh, name)


# --- mesh shapes (test_parallel.py::test_mesh_shapes, test_multislice.py) ---

@pytest.fixture(scope="module")
def meshes():
    return R.spawn(R.mesh_rank, 4)


def test_mesh_shapes(meshes):
    assert [r["all_data"] for r in meshes] == [({"data": 4, "model": 1}, i, 0) for i in range(4)]
    assert [r["2x2"] for r in meshes] == [({"data": 2, "model": 2}, i // 2, i % 2)
                                          for i in range(4)]


def test_replica_mesh_step(meshes):
    want = {"replica": 2, "data": 1, "model": 2}
    assert [r["2x1x2"] for r in meshes] == [(want, i // 2, 2, i % 2) for i in range(4)]
    # the batch over ('replica', 'data'): two blocks, one a replica
    assert [r["replica_rows"] for r in meshes] == [(i // 2, 2) for i in range(4)]
    model = SARSSL(R.config(True), device="cpu", seed=0)
    wave, _ = R.waves(3)
    ref = float(make_pretrain_step(model, R.FEAT, device="cpu")(
        create_train_state(model), wave, R.LR, torch.Generator().manual_seed(5))["loss"])
    for r in meshes:
        assert r["replica_loss"] == pytest.approx(ref, rel=1e-5)


def test_mesh_that_does_not_tile_the_world_raises(meshes):
    for r in meshes:
        assert r["untiled"] is not None and "tile" in r["untiled"]


# --- the rule tables against JAX's ------------------------------------------

def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("which", ["tiny_pretext", "tiny_downstream", "flagship_pretext",
                                   "flagship_downstream", "decoder_stage"])
def test_param_pspec_equals_jax(which):
    from sarssl_torch.models import SARSSLConfig
    from sarssl_tpu.parallel.mesh import param_pspec as j_pspec

    cfg = {"tiny_pretext": R.config(True), "tiny_downstream": R.config(False),
           "flagship_pretext": SARSSLConfig(),
           "flagship_downstream": SARSSLConfig(pretrain=False, downstream_dlabel=2),
           "decoder_stage": R.config(True, dec_model=("conformer", "fc"))}[which]
    model = SARSSL(cfg, device="cpu", seed=0)
    tree = to_jax_params(model)["params"]
    n_sharded = 0
    for path, leaf in _leaves(tree):
        want = tuple(j_pspec(path, leaf))
        assert param_pspec(path, leaf) == want, path
        n_sharded += bool(want)
    assert n_sharded > 0
    # the port's names reach the same specs through their flax paths
    specs = param_pspecs(model)
    flat = dict(_leaves(tree))
    from sarssl_torch.utils.weights import flax_path
    for name, p in model.named_parameters():
        path = flax_path(name, p.ndim)
        assert specs[name] == tuple(j_pspec(path, flat[path])), name


# --- against the JAX package's sharded steps on a (2, 2) CPU mesh -----------

@pytest.fixture(scope="module")
def against_jax():
    from sarssl_tpu.models import SARSSL as JSARSSL
    from sarssl_tpu.ops import gen_patch_mask
    from sarssl_tpu.parallel import (make_mesh, make_sharded_downstream_step,
                                     make_sharded_pretrain_step)
    from sarssl_tpu.train import create_train_state as j_create_state
    from tiny import CFG, FEAT

    wave, gt = R.waves(3)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    out = {}
    key = jax.random.key(2)
    rng_mask, _ = jax.random.split(key)
    jcfg = type(CFG)(**{**CFG.__dict__, "dropout": 0.0})
    nmasked = jcfg.effective_nmasked()
    mask = gen_patch_mask(rng_mask, R.NB, jcfg.npatch, nmasked, nmic=2, mode="T")
    for kind, pre, seed in (("pretrain", True, 0), ("downstream", False, 1)):
        jc = type(CFG)(**{**jcfg.__dict__, "pretrain": pre})
        jm = JSARSSL(jc)
        nf, nt, nreim, nmic = jc.sig_shape
        x0 = jnp.zeros((R.NB, nmic, nf, nt, nreim))
        jstate = j_create_state(jm, jax.random.key(1), x0, mask if pre else None)
        tree = to_jax_params(SARSSL(R.config(pre, 0.0), device="cpu", seed=seed))
        jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree["params"]),
                                batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]))
        if pre:
            step, st_sh, b_sh = make_sharded_pretrain_step(jm, FEAT, mesh, jstate, donate=False)
            jstate, m = step(jax.device_put(jstate, st_sh),
                             jax.device_put(jnp.asarray(wave), b_sh), R.LR, key)
        else:
            step, st_sh, b_sh = make_sharded_downstream_step(jm, FEAT, mesh, jstate,
                                                             donate=False)
            jstate, m = step(jax.device_put(jstate, st_sh),
                             jax.device_put(jnp.asarray(wave), b_sh),
                             jax.device_put(jnp.asarray(gt), b_sh), R.LR, key)
        out[kind] = (float(m["loss"]), jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
    ranks = R.spawn(R.jax_steps_rank, 4, wave, gt, tuple(np.asarray(t) for t in mask))
    return out, ranks


@pytest.mark.parametrize("kind", KINDS)
def test_2x2_step_matches_jax_sharded_step(against_jax, kind):
    """Loss rel 1e-4; parameters as tests/test_torch_train.py and
    test_torch_downstream.py hold Adam steps: all but 0.1% of the elements
    within 2e-5, and every element within the two sides' steps of at most lr
    each (2 lr: a gradient that is rounding noise on both sides may take
    opposite signs); BatchNorm stats rtol 1e-4 / atol 1e-5."""
    from sarssl_torch.utils.weights import from_jax_params

    jax_out, ranks = against_jax
    loss, tree = jax_out[kind]
    ref, ref_bufs = from_jax_params(tree)
    for r in ranks:
        assert r[kind] == pytest.approx(loss, rel=1e-4)
        got = r[kind + "_params"]
        assert set(got) == set(ref)
        n_far = n_all = 0
        for name, v in ref.items():
            diff = np.abs(got[name] - v.numpy())
            assert diff.max() <= 2 * R.LR, (kind, name, diff.max())
            n_far += int((diff > 2e-5).sum())
            n_all += diff.size
        assert n_far <= 1e-3 * n_all, (kind, n_far, n_all)
        for name, v in ref_bufs.items():
            np.testing.assert_allclose(r[kind + "_buffers"][name], v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


# --- lineareval, checkpoints, ensembles on a 2x2 state -----------------------

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    model = SARSSL(R.config(False), device="cpu", seed=1)
    state = create_train_state(model)
    gen = torch.Generator().manual_seed(4)
    names = state.optimizer.names
    mu = {n: torch.randn(p.shape, generator=gen) for n, p in zip(names, state.optimizer.params)}
    nu = {n: torch.rand(p.shape, generator=gen) for n, p in zip(names, state.optimizer.params)}
    state.optimizer.mu = [mu[n].clone() for n in names]
    state.optimizer.nu = [nu[n].clone() for n in names]
    state.optimizer.count = 3
    single = ckpt.save_named(str(root / "single"), state, "single", save_opt=True)
    pretrained = dict(SARSSL(R.config(True), device="cpu", seed=5).named_parameters())
    pretrained = {k: v.detach() for k, v in pretrained.items()}
    full = ({k: v.clone() for k, v in model.state_dict().items()}, mu, nu, 3)
    ranks = R.spawn(R.checkpoint_rank, 4, str(root / "sharded"), full, pretrained)
    yield dict(root=root, single=single, ranks=ranks, state=state)


def test_sharded_checkpoint_is_byte_identical(ckpts):
    with open(ckpts["single"], "rb") as f:
        single = f.read()
    with open(os.path.join(ckpts["root"], "sharded", "sharded.msgpack"), "rb") as f:
        assert f.read() == single


def test_resume_restores_each_shard(ckpts):
    state = ckpts["state"]
    full_params = dict(state.model.named_parameters())
    full_mu = dict(zip(state.optimizer.names, state.optimizer.mu))
    for r in ckpts["ranks"]:
        params, mu, count = r["restored"]
        assert count == 3
        mi = r["model_index"]
        for name, got in params.items():
            dim = r["shardings"][name]
            want = full_params[name].detach().numpy()
            if dim is not None:
                n = want.shape[dim] // 2
                want = np.take(want, range(mi * n, (mi + 1) * n), axis=dim)
                wmu = np.take(full_mu[name].numpy(), range(mi * n, (mi + 1) * n), axis=dim)
            else:
                wmu = full_mu[name].numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
            np.testing.assert_array_equal(mu[name], wmu, err_msg=name)


def test_sharded_lineareval_freezes_loaded_params(ckpts):
    for r in ckpts["ranks"]:
        loaded, before, after = r["lineareval"]
        assert loaded and all(k.split(".")[0] in ("spec_encoder", "spat_encoder")
                              for k in loaded)
        for k in loaded:
            np.testing.assert_array_equal(before[k], after[k], err_msg=f"frozen moved: {k}")
        assert np.abs(before["head_proj.weight"] - after["head_proj.weight"]).max() > 0


def test_ensemble_on_sharded_state(ckpts):
    d = os.path.join(ckpts["root"], "sharded", "ens")
    epochs = [ckpt.load_checkpoint(ckpt.epoch_path(d, e))["params"] for e in range(3)]
    want = sum(np.asarray(p["head_proj"]["kernel"], np.float64) for p in epochs) / 3
    for r in ckpts["ranks"]:
        avg, installed = r["ensemble"]
        np.testing.assert_allclose(avg["head_proj.weight"].T, want, rtol=0, atol=1e-6)
        for name in avg:  # the sharded model holds the average
            np.testing.assert_array_equal(installed[name], avg[name], err_msg=name)
    assert os.path.exists(ckpt.ensemble_path(d))


# --- host data ----------------------------------------------------------------

def test_shard_for_process_equals_jax():
    from sarssl_tpu.parallel import shard_for_process as j_shard

    items = list(range(103))
    for pi in range(4):
        assert shard_for_process(items, pi, 4) == j_shard(items, pi, 4)
    assert shard_for_process(items) == items  # no mesh: every item


def test_ranks_rows_are_their_slice_of_the_global_batch():
    x = np.random.default_rng(0).standard_normal((8, 6, 2)).astype(np.float32)
    parts = []
    for i in range(4):
        rows = Rows(i, 4, torch.device("cpu"))
        local = rows.local(x)
        g = global_batch_from_local(local, rows)
        assert isinstance(g, torch.Tensor) and g.shape == (2, 6, 2)
        out = list(host_batch_iterator([{"wave": local + k} for k in range(3)], rows))
        np.testing.assert_array_equal(np.asarray(out[2]["wave"]), local + 2)
        parts.append(g.numpy())
    np.testing.assert_array_equal(np.concatenate(parts), x)


def test_packed_global_batch_is_the_one_rank_batch(tmp_path):
    from sarssl_torch.data import shards as tsh
    from sarssl_torch.data.wavio import write_wav
    from sarssl_torch.parallel import packed_batches

    rng = np.random.default_rng(0)
    for i in range(20):
        write_wav(str(tmp_path / f"{i}.wav"), rng.uniform(-0.9, 0.9, (600, 2)), 16000)
        np.savez(str(tmp_path / f"{i}_info.npz"), TDOA=np.float32(i))
    tsh.pack_wav_tree(str(tmp_path), str(tmp_path / "packed"), items_per_shard=8)
    pds = tsh.PackedDataset(str(tmp_path / "packed"), load_anno=True)
    one = list(pds.iter_batches(4, shuffle=True, seed=3))
    ranks = [list(packed_batches(pds, 4, i, 2, shuffle=True, seed=3)) for i in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(one) == 5
    for b, (r0, r1) in enumerate(zip(*ranks)):
        # the same rows in the same order: the data ranks' blocks of the batch
        assert r0[0].shape == (2, 600, 2)
        np.testing.assert_array_equal(np.concatenate([r0[0], r1[0]]), one[b][0])
        np.testing.assert_array_equal(np.concatenate([r0[1]["TDOA"], r1[1]["TDOA"]]),
                                      one[b][1]["TDOA"])
    # one rank reads the one-rank batches themselves
    for got, want in zip(packed_batches(pds, 4, shuffle=True, seed=3), one):
        np.testing.assert_array_equal(got[0], want[0])
    # the JAX package's strided split holds the same set of rows
    idx = list(pds.batch_indices(4, shuffle=True, seed=3))
    strided = [list(pds.batch_indices(2, shuffle=True, seed=3, shard_i=i, shard_n=2))
               for i in range(2)]
    for b in range(len(idx)):
        assert set(np.concatenate([strided[0][b], strided[1][b]])) == set(idx[b])


# --- the kernels' plain versions with index maps -----------------------------

def test_dropout_plain_index_map_is_a_slice():
    x = torch.randn((3, 5, 16), generator=torch.Generator().manual_seed(0))
    full = dropout_plain(x, 0x9E3779B9, 0.3)
    for c0 in (0, 4, 12):
        part = dropout_plain(x[..., c0:c0 + 4].contiguous(), 0x9E3779B9, 0.3, (4, 16, c0))
        assert torch.equal(part, full[..., c0:c0 + 4])


def test_attention_plain_heads_are_a_slice():
    gen = torch.Generator().manual_seed(1)
    B, H, L, D = 2, 4, 10, 8
    qu, k, v = (torch.randn((B, H, L, D), generator=gen) for _ in range(3))
    bias = torch.randn((B, H, L, L), generator=gen)
    full = attention_plain(qu, k, v, bias, 77, 0.25, 0.1)
    for h0 in (0, 2):
        hs = slice(h0, h0 + 2)
        part = attention_plain(qu[:, hs], k[:, hs], v[:, hs], bias[:, hs], 77, 0.25, 0.1, H, h0)
        assert torch.equal(part, full[:, hs])
    with pytest.raises(ValueError):
        attention_plain(qu[:, :2], k[:, :2], v[:, :2], bias[:, :2], 77, 0.25, 0.1, H, 3)


def test_batch_sharding_rows():
    """A rank's rows fold 'replica' with 'data': rank (r, d, m) of a (2, 2, 2)
    mesh holds block r * 2 + d of 4."""
    from sarssl_torch.parallel import Mesh

    mesh = Mesh(device_mesh=None, shape={"replica": 2, "data": 2, "model": 2},
                device=torch.device("cpu"), data_group=None, model_group=None, data_index=3,
                data_size=4, model_index=1, model_size=2, rank=7)
    rows = batch_sharding(mesh)
    assert rows == Rows(3, 4, torch.device("cpu"))
    assert rows.slice(8) == slice(6, 8)
    with pytest.raises(ValueError):
        rows.slice(7)
