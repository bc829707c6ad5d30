"""The port's vmapped downstream grid (``sarssl_torch/train/grid.py``) on the
CPU: against the JAX package's ``VmappedGridRunner`` (dropout 0, JAX's init
weights), against the port's own sequential ``DownstreamLearner`` (dropout
0.1, the same generators), and the lane-seeded dropout: its plain version
against ``jax.vmap`` of ``fused_dropout``, and the ``vmap`` rule of
``_HashDropout`` with the Triton launches replaced by their plain versions.

Tolerances, each where it is asserted:
- lane-seeded masks and values against JAX: bit for bit;
- one vmapped step against JAX's: per-lane loss and MAE within rel 1e-5; the
  port's identical lanes bit for bit;
- three epochs against JAX's runner: per-cell val MAE within rel 2e-3 (the
  parameters drift apart by up to lr a step where a gradient element is ~0,
  as tests/test_torch_ds_learner.py states, 8e-5 there), the same best
  epochs, lr drops and stops;
- a lane against the sequential learner, dropout 0.1: the step's dropout
  seeds equal, its forward loss and MAE within rel 1e-6; BatchNorm running
  stats after two steps within rel 1e-5 of each stat's largest magnitude;
  after 3 epochs the ensemble within 2e-3 of each leaf's largest magnitude,
  the attention key biases left out (their gradient is 0 analytically,
  softmax being shift-invariant, so Adam moves them by ~lr on rounding
  noise, in either direction);
- the ensemble fold on the sequential learner's own states: bit for bit
  (both sum in f64 in epoch order);
- lineareval's frozen leaves: bit for bit; the resident epoch against the
  streamed one: losses rel 1e-6, parameters atol 2e-6.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

from sarssl_tpu.kernels.dropout import fused_dropout  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train.grid import VmappedGridRunner as JRunner  # noqa: E402
from sarssl_tpu.train.grid import slice_state as j_slice_state  # noqa: E402
import sarssl_torch.kernels.dropout as kd  # noqa: E402
from sarssl_torch.data import SyntheticPairs  # noqa: E402
from sarssl_torch.data.shards import PackedDataset, pack_dataset  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.models import common  # noqa: E402
from sarssl_torch.models.common import LaneSeeds  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.train import (Adam, DownstreamLearner, StackedAdam, VmappedGridRunner,  # noqa
                                create_train_state, make_downstream_eval_step,
                                make_downstream_step, make_vmapped_downstream_steps,
                                slice_state, stack_states, trainable_mask_from_loaded)
from sarssl_torch.train import grid as tgrid  # noqa: E402
from sarssl_torch.utils import epoch_generator  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

NB = 4
TFEAT = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)
JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": False})
DCFG = SARSSLConfig(**{**JCFG.__dict__, "dropout": 0.1})  # the port's, dropout on
KEY_BIAS = ".mhsa.key.bias"


def _seed_of(key) -> int:
    """The uint32 seed ``_hash_mask`` derives from a key (dropout.py:114-115)."""
    kd_ = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd_[0] ^ np.uint32((int(kd_[-1]) * 0x9E3779B9) & 0xFFFFFFFF))


def _batches(seed, n=2, nb=NB):
    return [(w, g["TDOA"].astype(np.float32)) for w, g in SyntheticPairs(
        nsample=NSAMPLE, seed=seed).batches(nb, n, with_labels=True)]


def _lanes(data, nlane):
    return ((np.stack([w] * nlane), np.stack([g] * nlane)) for w, g in data)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small vmapped models, restored after
    the module: with one per core they oversubscribe a host whose cores the
    suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's downstream state on the tiny config (dropout 0) and the port's
    model with its weights."""
    nf, nt, nreim, nmic = JCFG.sig_shape
    jm = JSARSSL(JCFG)
    jstate = j_create_state(jm, jax.random.key(0), jnp.zeros((NB, nmic, nf, nt, nreim)), None)
    params, buffers = from_jax_params(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    return jm, jstate, {**params, **buffers}


def _port_model(sd, cfg=None):
    model = SARSSL(cfg or SARSSLConfig(**JCFG.__dict__), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


# -------------------------------------------------------- lane-seeded dropout

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_lane_seeded_plain_dropout_equals_jax_vmap(rate):
    """``dropout_plain`` vmapped with each lane's seed, fed the seeds JAX
    derives from its per-lane keys, equals ``jax.vmap(fused_dropout)`` bit
    for bit."""
    keys = jax.random.split(jax.random.key(17), 5)
    x = np.random.default_rng(0).standard_normal((5, 6, 33, 7)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, k: fused_dropout(a, k, rate))(jnp.asarray(x), keys))
    seeds = torch.tensor([_seed_of(k) for k in keys], dtype=torch.int64)
    got = vmap(kd.dropout_plain, in_dims=(0, 0, None))(torch.from_numpy(x), seeds, rate)
    np.testing.assert_array_equal(got.numpy(), want)
    # and through the model's entry point on CPU tensors, each lane its own mask
    got2 = vmap(kd.hash_dropout, in_dims=(0, 0, None))(torch.from_numpy(x), seeds, rate)
    np.testing.assert_array_equal(got2.numpy(), want)
    assert not np.array_equal(want[0] != 0, want[1] != 0)


@pytest.fixture
def plain_launches(monkeypatch):
    """The two Triton launches replaced by their plain versions, so the
    autograd Functions and the vmap rule run on CPU tensors; the calls are
    recorded."""
    calls = []

    def lanes(x, seeds, rate):
        calls.append(("lanes", tuple(x.shape)))
        return vmap(kd.dropout_plain, in_dims=(0, 0, None))(x, seeds, rate)

    def one(x, seed, rate):
        calls.append(("one", tuple(x.shape)))
        return kd.dropout_plain(x, seed, rate)

    monkeypatch.setattr(kd, "launch_dropout_lanes", lanes)
    monkeypatch.setattr(kd, "launch_dropout", one)
    return calls


@pytest.mark.parametrize("case", ["seed_lanes_dim1", "int_seed", "unbatched_x"])
def test_hash_dropout_vmap_rule_runs_the_lane_kernel(case, plain_launches):
    """``_HashDropout`` under ``torch.func.vmap``: its vmap rule moves the
    lanes to dim 0 and runs ``_HashDropoutLanes`` (forward and, through an
    ordinary ``.backward()`` outside the vmap, its backward), equal to the
    vmapped plain version; no unbatched launch."""
    rate, n = 0.3, 3
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, n, 7, 4)).astype(
        np.float32))
    seeds = torch.tensor([1, 2 ** 32 - 5, 0x9E3779B9], dtype=torch.int64)
    plain = vmap(kd.dropout_plain, in_dims=(0, 0, None))
    xr = x.clone().requires_grad_()
    if case == "seed_lanes_dim1":  # x batched on dim 1, the seeds on dim 0
        out = vmap(lambda a, s: kd._HashDropout.apply(a * 2.0, s, rate), in_dims=(1, 0))(
            xr, seeds)
        want = plain(x.movedim(1, 0) * 2.0, seeds, rate)
    elif case == "int_seed":  # one int seed for every lane
        out = vmap(lambda a: kd._HashDropout.apply(a * 2.0, 9, rate), in_dims=1)(xr)
        want = plain(x.movedim(1, 0) * 2.0, torch.full((n,), 9), rate)
    else:  # a tensor that is not batched, lane seeds
        out = vmap(lambda s: kd._HashDropout.apply(xr[:, 0] * 2.0, s, rate))(seeds)
        want = plain(x[:, 0].expand(n, 5, 7, 4) * 2.0, seeds, rate)
    assert torch.equal(out, want)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    if case == "unbatched_x":  # the lanes' gradients sum into the one tensor
        want_grad = torch.zeros_like(x)
        want_grad[:, 0] = 2.0 * plain(g, seeds, rate).sum(0)
    else:
        s = seeds if case == "seed_lanes_dim1" else torch.full((n,), 9)
        want_grad = 2.0 * plain(g, s, rate).movedim(0, 1)
    torch.testing.assert_close(xr.grad, want_grad, rtol=1e-6, atol=1e-6)
    assert {c[0] for c in plain_launches} == {"lanes"} and len(plain_launches) == 2


def test_hash_dropout_outside_vmap_keeps_its_int_launch(plain_launches):
    x = torch.randn(4, 6).requires_grad_()
    out = kd._HashDropout.apply(x, 7, 0.2)
    out.sum().backward()
    assert torch.equal(out, kd.dropout_plain(x.detach(), 7, 0.2))
    assert [c[0] for c in plain_launches] == ["one", "one"]
    # a 0-d seed tensor outside vmap is one lane
    plain_launches.clear()
    out = kd._HashDropout.apply(x.detach(), torch.tensor(7), 0.2)
    assert torch.equal(out, kd.dropout_plain(x.detach(), 7, 0.2))
    assert [c[0] for c in plain_launches] == ["lanes"]


def test_lane_seeds_hand_out_the_sites_in_order():
    cur = LaneSeeds(torch.tensor([5, 6, 7]))
    assert [int(common.draw_seed(cur)) for _ in range(3)] == [5, 6, 7] and cur.pos == 3
    with pytest.raises(RuntimeError, match="more than the 3 dropout seeds"):
        common.draw_seed(cur)


def test_stacked_adam_equals_adam_per_lane():
    """Each lane takes ``Adam.update``'s step at its own rate; a lane at lr 0
    does not move."""
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    lrs = [1e-2, 1e-3, 0.0]
    base = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    stacked = [torch.stack([b] * 3).requires_grad_() for b in base]
    opt = StackedAdam(stacked)
    singles = [[torch.nn.Parameter(b.clone()) for b in base] for _ in lrs]
    adams = [Adam([(str(i), p) for i, p in enumerate(ps)]) for ps in singles]
    for _ in range(3):
        grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
                 for _ in lrs]
        for i, p in enumerate(stacked):
            p.grad = torch.stack([g[i] for g in grads])
        opt.update(torch.tensor(lrs))
        for lane, (ps, a) in enumerate(zip(singles, adams)):
            for p, g in zip(ps, grads[lane]):
                p.grad = g
            a.update(lrs[lane])
    for i, p in enumerate(stacked):
        for lane, ps in enumerate(singles):
            torch.testing.assert_close(p.detach()[lane], ps[i].detach(), rtol=1e-6, atol=1e-7)
        assert torch.equal(p.detach()[2], base[i])  # lr 0
    assert opt.count == 3


# ---------------------------------------------------------------- against JAX

def test_vmapped_step_equals_jax_and_lanes_are_independent(jax_init):
    """One vmapped step over lanes [(0,1e-2),(0,1e-2),(0,1e-3)]: per-lane loss
    and MAE equal JAX's runner; identical lanes bit for bit; the 1e-3 lane
    differs."""
    jm, jstate, sd = jax_init
    cells = [(0, 1e-2), (0, 1e-2), (0, 1e-3)]
    data = _batches(7, n=1)
    jr = JRunner(jm, FEAT, [jstate] * 3, cells, patience=100)
    jtm = jr.train_epoch(((jnp.asarray(w), jnp.asarray(g)) for w, g in _lanes(data, 3)),
                         [jax.random.key(5)] * 3)
    model = _port_model(sd)
    st = create_train_state(model)
    tr = VmappedGridRunner(model, TFEAT, [st] * 3, cells, patience=100, device="cpu")
    ttm = tr.train_epoch(_lanes(data, 3), [torch.Generator() for _ in cells])
    np.testing.assert_allclose(ttm["loss"], jtm["loss"], rtol=1e-5)
    np.testing.assert_allclose(ttm["mae"], jtm["mae"], rtol=1e-5)
    p = tr.states.params
    assert all(torch.equal(v[0], v[1]) for v in p.values())
    assert max(float((v[0] - v[2]).detach().abs().max()) for v in p.values()) > 1e-4
    # the bare vmapped step (no dropout site at rate 0: no seed a lane) takes
    # the runner's step
    bare = _port_model(sd)
    train, _ = make_vmapped_downstream_steps(bare, TFEAT, device="cpu")
    stacked = stack_states([create_train_state(bare)] * 3)
    w, g = data[0]
    m = train(stacked, np.stack([w] * 3), np.stack([g] * 3), tr._lrs(),
              torch.zeros((3, 0), dtype=torch.int64))
    np.testing.assert_allclose(m["loss"].numpy(), jtm["loss"], rtol=1e-5)
    assert all(torch.equal(stacked.params[n], v) for n, v in p.items())
    # JAX's identical lanes are identical too, and the state slices back
    jp0, jp1 = (jax.tree.leaves(j_slice_state(jr.states, i).params) for i in (0, 1))
    assert all(np.array_equal(a, b) for a, b in zip(jp0, jp1))


def test_three_epochs_equal_jax_runner(jax_init):
    """Per-cell val-MAE trajectories, best epochs, lr drops and stops of three
    epochs (patience 1) equal JAX's runner's."""
    jm, jstate, sd = jax_init
    cells = [(0, 5e-2), (1, 1e-3)]
    model = _port_model(sd)
    st = create_train_state(model)
    jr = JRunner(jm, FEAT, [jstate] * 2, cells, patience=1, scan_block=2)
    tr = VmappedGridRunner(model, TFEAT, [st] * 2, cells, patience=1, scan_block=2,
                           device="cpu")
    val = _batches(1, n=1)
    jv_all, tv_all = [], []
    for epoch in range(3):
        data = [_batches(100 + 1000 * t + epoch) for t in (0, 1)]
        stacked = [(np.stack([a[0], b[0]]), np.stack([a[1], b[1]])) for a, b in zip(*data)]
        jr.train_epoch(((jnp.asarray(w), jnp.asarray(g)) for w, g in stacked),
                       [jax.random.key(epoch)] * 2)
        tr.train_epoch(iter(stacked), [torch.Generator() for _ in cells])
        jv = jr.eval_epoch((jnp.asarray(w), jnp.asarray(g)) for w, g in val)
        tv = tr.eval_epoch(iter(val))
        np.testing.assert_allclose(tv["mae"], jv["mae"], rtol=2e-3, err_msg=f"epoch {epoch}")
        jv_all.append(jv["mae"])
        tv_all.append(tv["mae"])
        assert tr.end_epoch(tv["mae"]) == jr.end_epoch(jv["mae"])
    for tc, jc in zip(tr.cells, jr.cells):
        assert (tc.best_epochs, tc.lr_drops, tc.done, tc.epochs_run) == \
            (jc.best_epochs, jc.lr_drops, jc.done, jc.epochs_run)
        assert tc.lr == pytest.approx(jc.lr, rel=1e-12)
    # the hot lane's val MAE rose, so it dropped its rate
    assert tr.cells[0].lr_drops == 1


# ------------------------------------------- against the sequential learner

@pytest.fixture(scope="module")
def seq_run(tmp_path_factory):
    """The port's sequential learner, dropout 0.1, 3 epochs of 2 steps at
    lr 1e-3 with the CLI's generators, its step seeds caught; and the grid
    over two lanes (lr 1e-3 and 1e-2) on the same data and generators."""
    tmp = tmp_path_factory.mktemp("seq")
    model = SARSSL(DCFG, device="cpu", seed=3)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    val = _batches(1, n=1)
    drawn, draw = [], common.draw_seed

    def catching(gen):
        s = draw(gen)
        drawn.append(s)
        return s

    learner = DownstreamLearner(
        state=create_train_state(model), lr_init=1e-3, ckpt_dir=str(tmp), patience=100,
        train_step=make_downstream_step(model, TFEAT, device="cpu"),
        eval_step=make_downstream_eval_step(model, TFEAT, device="cpu"))
    seq = {"loss": [], "mae": [], "val": [], "bn": None}
    common.draw_seed = catching
    try:
        for epoch in range(3):
            m = learner.train_epoch(_batches(100 + epoch), epoch_generator(100, "train", 7000 + epoch))
            if epoch == 0:
                seq["bn"] = {k: v.clone() for k, v in model.named_buffers()}
                seq["first_seeds"] = list(drawn)
            v = learner.eval_epoch(val)
            learner.end_epoch(v["mae"])
            for k in ("loss", "mae"):
                seq[k].append(m[k])
            seq["val"].append(v["mae"])
    finally:
        common.draw_seed = draw
    learner.ensemble(k=5)
    seq["ens"] = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(sd0)
    st = create_train_state(model)
    seeds_drawn = []
    runner = VmappedGridRunner(model, TFEAT, [st, st], [(0, 1e-3), (0, 1e-2)], patience=100,
                               scan_block=2, device="cpu")
    sd_draw = runner.train_block.seeds.draw

    def keep(gens, n):
        out = sd_draw(gens, n)
        seeds_drawn.append(out)
        return out

    runner.train_block.seeds.draw = keep
    grid = {"loss": [], "mae": [], "val": [], "bn": None}
    for epoch in range(3):
        m = runner.train_epoch(_lanes(_batches(100 + epoch), 2),
                               [epoch_generator(100, "train", 7000 + epoch) for _ in range(2)])
        if epoch == 0:
            grid["bn"] = {k: v.clone() for k, v in runner.states.buffers.items()}
        v = runner.eval_epoch(iter(val))
        runner.end_epoch(v["mae"])
        for k in ("loss", "mae"):
            grid[k].append(m[k])
        grid["val"].append(v["mae"])
    grid["seeds"] = seeds_drawn
    grid["sites"] = runner.train_block.seeds.sites
    runner.ensembled_states()
    grid["ens"] = {**{k: v[0].detach().clone() for k, v in runner.states.params.items()},
                   **{k: v[0].clone() for k, v in runner.states.buffers.items()}}
    yield seq, grid
    shutil.rmtree(tmp, ignore_errors=True)


def test_lane_draws_the_sequential_seeds_and_forward(seq_run):
    """The grid's first step draws each lane the seeds the sequential step
    drew (so the same masks: the lane-seeded mask is the per-lane one), and
    its first epoch's loss and MAE (the first step's forward, the second's
    after one update) equal the sequential run's."""
    seq, grid = seq_run
    sites = grid["sites"]
    assert sites == 14  # 7 sites a conformer block, one block an encoder
    first = grid["seeds"][0]  # the first step, drawn at the bound
    assert first.shape[:2] == (1, 2)
    assert first[0, 0, :sites].tolist() == seq["first_seeds"][:sites]
    assert torch.equal(first[0, 0, :sites], first[0, 1, :sites])  # one trial, one chain
    second = grid["seeds"][1]
    assert second.shape == (1, 2, sites)
    assert second[0, 0].tolist() == seq["first_seeds"][sites:2 * sites]
    np.testing.assert_allclose(grid["loss"][0][0], seq["loss"][0], rtol=1e-6)
    np.testing.assert_allclose(grid["mae"][0][0], seq["mae"][0], rtol=1e-6)


def test_lane_batchnorm_stats_move_as_the_sequential_ones(seq_run):
    seq, grid = seq_run
    for k, want in seq["bn"].items():
        got = grid["bn"][k][0]
        assert not torch.equal(got, torch.zeros_like(got) if "mean" in k else torch.ones_like(got))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()), msg=k)


def test_lane_trajectory_and_ensemble_match_the_sequential_learner(seq_run):
    seq, grid = seq_run
    np.testing.assert_allclose([v[0] for v in grid["val"]], seq["val"], rtol=1e-3)
    for k, want in seq["ens"].items():
        if k.endswith(KEY_BIAS):
            continue
        got = grid["ens"][k]
        torch.testing.assert_close(got, want, rtol=0, atol=2e-3 * float(want.abs().max()), msg=k)


def test_ensemble_fold_equals_the_sequential_ensemble_on_its_states(tmp_path):
    """The ring fold on the card, fed the sequential learner's own states and
    val MAEs epoch by epoch, equals ``DownstreamLearner.ensemble`` bit for
    bit, parameters and BatchNorm stats."""
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=4)
    runner = VmappedGridRunner(model, TFEAT, [create_train_state(model)], [(0, 1e-3)],
                               patience=2, ensemble_k=3, device="cpu")
    learner = DownstreamLearner(state=create_train_state(model), train_step=None, eval_step=None,
                                lr_init=1e-3, ckpt_dir=str(tmp_path), patience=2)
    rng = np.random.default_rng(5)
    for mae in [5.0, 4.0, 3.0, 3.5, 2.0, 2.5, 2.6]:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                t.add_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
            for n, p in model.named_parameters():
                runner.states.params[n][0].copy_(p)
            for n, b in model.named_buffers():
                runner.states.buffers[n][0].copy_(b)
        assert runner.end_epoch(np.array([mae])) == learner.end_epoch(mae)
    assert runner.cells[0].best_epochs == learner.best_epochs
    learner.ensemble(k=3)
    runner.ensembled_states()
    for n, p in model.named_parameters():
        assert torch.equal(runner.states.params[n][0], p.detach()), n
    for n, b in model.named_buffers():
        assert torch.equal(runner.states.buffers[n][0], b), n


def test_lineareval_lanes_keep_their_frozen_leaves(jax_init):
    jm, jstate, sd = jax_init
    model = _port_model(sd, DCFG)
    names = [n for n, _ in model.named_parameters() if n.startswith("spec_encoder.")]
    mask = trainable_mask_from_loaded(model, names)
    st = create_train_state(model)
    runner = VmappedGridRunner(model, TFEAT, [st, st], [(0, 1e-2), (0, 1e-3)],
                               trainable_mask=mask, patience=100, device="cpu")
    start = {n: p.detach().clone() for n, p in runner.states.params.items()}
    runner.train_epoch(_lanes(_batches(3), 2), [torch.Generator().manual_seed(1)] * 2)
    for n, p in runner.states.params.items():
        if n in names:
            assert torch.equal(p.detach(), start[n]), n
    assert any(not torch.equal(p.detach(), start[n]) for n, p in runner.states.params.items()
               if n.startswith("head_"))


def test_resident_train_epoch_matches_stream(tmp_path):
    """Index gathers from a split staged on the device draw the packed
    stream's batches and give its losses and parameters."""
    n, bs, nsteps = 24, 4, 3

    class _Src:
        def __len__(self):
            return n

        def __getitem__(self, i):
            r = np.random.default_rng(1000 + i)
            return (r.standard_normal((NSAMPLE, 2)).astype(np.float32),
                    {"TDOA": np.float32(r.uniform(-2e-4, 2e-4))})

    d = str(tmp_path / "packed")
    pack_dataset(_Src(), d, items_per_shard=7)
    pds = PackedDataset(d, load_anno=True)
    seeds = {0: 42, 1: 77}
    model = SARSSL(DCFG, device="cpu", seed=6)
    st = create_train_state(model)

    def run(resident):
        runner = VmappedGridRunner(model, TFEAT, [st, st], [(0, 1e-3), (1, 1e-3)],
                                   patience=100, scan_block=2, device="cpu")
        gens = [torch.Generator().manual_seed(9) for _ in range(2)]
        acol = pds.annos()["TDOA"]
        if resident:
            runner.stage_train_waves(pds.all_waves())
            its = [pds.batch_indices(bs, shuffle=True, seed=s) for s in seeds.values()]
            m = runner.train_epoch_resident(
                ((np.stack(per), np.stack([np.asarray(acol[i], np.float32) for i in per]))
                 for _, per in zip(range(nsteps), zip(*its))), gens)
        else:
            its = [pds.iter_batches(bs, shuffle=True, seed=s) for s in seeds.values()]
            m = runner.train_epoch(
                ((np.stack([b[0] for b in per]),
                  np.stack([np.asarray(b[1]["TDOA"], np.float32) for b in per]))
                 for _, per in zip(range(nsteps), zip(*its))), gens)
        return m, runner.states.params

    m1, p1 = run(False)
    m2, p2 = run(True)
    np.testing.assert_allclose(m1["loss"], m2["loss"], rtol=1e-6)
    np.testing.assert_allclose(m1["mae"], m2["mae"], rtol=1e-6)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=2e-6)


# ------------------------------------------------------------- the life cycle

def _runner(cells, **kw):
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=8)
    st = create_train_state(model)
    return VmappedGridRunner(model, TFEAT, [st] * len(cells), cells, device="cpu", **kw)


def _leaf(runner, part="params"):
    return next(iter(getattr(runner.states, part).values())).detach().clone()


def _shift(runner, d):
    with torch.no_grad():
        for p in runner.states.params.values():
            p.add_(d)


def test_device_ring_ensemble_math():
    """The window average equals the uniform mean of the last k epochs ending
    at the best; an epoch that is no best does not fold."""
    runner = _runner([(0, 1e-3)], patience=100, ensemble_k=2)
    p0 = _leaf(runner)[0]
    runner.end_epoch(np.array([1.0]))  # P0, best
    _shift(runner, 1.0)
    runner.end_epoch(np.array([0.5]))  # P0+1, best: mean(P0, P0+1)
    _shift(runner, 9.0)
    runner.end_epoch(np.array([5.0]))  # P0+10, worse: unchanged
    runner.ensembled_states()
    torch.testing.assert_close(_leaf(runner)[0], p0 + 0.5, rtol=0, atol=1e-6)


def test_cell_lifecycle_and_ensemble():
    """Cells stop on their own (lr/10, then done); a finished lane is frozen
    at lr 0; the cells' ensembles differ."""
    runner = _runner([(0, 1e-2), (0, 1e-3)], patience=1, ensemble_k=2)
    val_a = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5]  # keeps improving
    val_b = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]  # worse every epoch
    for epoch in range(6):
        runner.train_epoch(_lanes(_batches(epoch, n=1), 2),
                           [torch.Generator().manual_seed(epoch)] * 2)
        if runner.end_epoch(np.array([val_a[epoch], val_b[epoch]])):
            break
    b = runner.cells[1]
    assert b.done and b.lr_drops == 1 and b.lr == pytest.approx(1e-4)
    assert not runner.cells[0].done
    assert float(runner._lrs()[1]) == 0.0
    before = _leaf(runner)[1]
    runner.train_epoch(_lanes(_batches(7, n=1), 2), [torch.Generator()] * 2)
    assert torch.equal(_leaf(runner)[1], before)
    runner.ensembled_states()
    ens = _leaf(runner)
    assert ens[1].abs().max() > 0 and not torch.equal(ens[0], ens[1])


def test_nan_lane_falls_back_to_live_state():
    runner = _runner([(0, 1e-3), (0, 1e-2)], patience=2, ensemble_k=2)
    runner.end_epoch(np.array([1.0, np.nan]))
    _shift(runner, 1.0)
    done = runner.end_epoch(np.array([0.5, np.nan]))
    mae, epoch = 0.5, 2
    while not done:
        assert epoch < 16, "the grid never stopped on worsening val MAEs"
        _shift(runner, 1.0)
        mae += 0.2
        done = runner.end_epoch(np.array([mae, np.nan]))
        epoch += 1
    live = _leaf(runner)
    runner.ensembled_states()
    got = _leaf(runner)
    assert torch.equal(got[1], live[1]) and not torch.allclose(got[0], live[0])
    assert runner.cells[0].best_epochs and not runner.cells[1].best_epochs


def test_all_nan_chunk_returns_live_states():
    runner = _runner([(0, 1e-2), (0, 1e-1)], patience=2, ensemble_k=2)
    done, epoch = False, 0
    while not done:
        assert epoch < 16, "the all-NaN grid never stopped"
        done = runner.end_epoch(np.array([np.nan, np.nan]))
        epoch += 1
    live = _leaf(runner), _leaf(runner, "buffers")
    runner.ensembled_states()
    assert torch.equal(_leaf(runner), live[0]) and torch.equal(_leaf(runner, "buffers"), live[1])


def test_ensembled_states_without_an_epoch_raises():
    with pytest.raises(RuntimeError, match="end_epoch was never called"):
        _runner([(0, 1e-3)]).ensembled_states()


def test_stack_and_slice_states_round_trip():
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=2)
    st = create_train_state(model)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    stacked = stack_states([st, st])
    assert stacked.ncell == 2 and all(p.requires_grad for p in stacked.params.values())
    with torch.no_grad():
        for p in stacked.params.values():
            p[1].add_(1.0)
    lane = slice_state(stacked, 1)
    assert lane.model is model and lane.optimizer.count == 0
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), sd[k] + 1.0), k
    slice_state(stacked, 0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert tgrid._site_capacity(model) >= 14
