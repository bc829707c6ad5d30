"""Rank programs for ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_cli.py`` (not a test module: no JAX here, so the
spawned ranks import only the port).

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (spawn),
each with ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, a free
localhost port), one intra-op thread, on gloo, and runs ``fn(rank, *args)``
in each; every rank's return value is saved to a file that the parent reads
back. The tiny profile (``tests/tiny.py``) is rebuilt here with the port's
classes.
"""
from __future__ import annotations

import os
import shutil
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from sarssl_torch.data.synthetic import synth_batch
from sarssl_torch.models import SARSSL, SARSSLConfig
from sarssl_torch.ops import FeatureConfig

NSAMPLE = 576
FEAT = FeatureConfig(win_len=128, nfft=128)
CFG = SARSSLConfig().tiny(sig_shape=(64, 8, 2, 2), patch_shape=(64, 1), spec_dembed=32,
                          spat_dembed=16, num_heads=2)
NB = 8
LR = 1e-3
CLIP = 0.1  # below the tiny pretext model's first gradient norm: the clip binds


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out_dir, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args):
    """``[fn(rank, *args) for rank in range(world)]``, each in its own
    process of a ``world``-rank gloo job."""
    out_dir = tempfile.mkdtemp(prefix="sarssl_ranks_")
    try:
        torch.multiprocessing.spawn(_entry, args=(fn, world, free_port(), out_dir, args),
                                    nprocs=world)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def config(pretrain=True, dropout=0.1, **kw):
    return SARSSLConfig(**{**CFG.__dict__, "pretrain": pretrain, "dropout": dropout, **kw})


def waves(seed=0, nb=NB):
    wave, tdoa = synth_batch(np.random.default_rng(seed), nb, NSAMPLE)
    return wave, (tdoa / 16000.0).astype(np.float32)


def numpy_dict(named):
    return {k: v.detach().float().cpu().numpy().copy() for k, v in named.items()}


class MaskLog:
    """Records every dropout mask the model draws (the plain version's keep
    mask of each call's seed and index map), in call order."""

    def __init__(self):
        from sarssl_torch.kernels import dropout as kd
        from sarssl_torch.models import common

        self.masks, self.common, self.orig = [], common, common.hash_dropout

        def logged(x, seed, rate, index_map=None):
            keep = kd.hash_keep_mask(x.numel(), seed, rate, index_map=index_map)
            self.masks.append((keep.reshape(x.shape).numpy(), index_map))
            return self.orig(x, seed, rate, index_map)

        common.hash_dropout = logged

    def close(self):
        self.common.hash_dropout = self.orig
        return self.masks


class GradLog:
    """Records, as whole tensors, the gradients that ``state``'s next update
    reads (after the step's gradient sync, before any clipping; a missing
    one as 0) and, under ``make_adam``'s clipping, the clipped gradients it
    steps with. On a sharded model every model rank gathers them together."""

    def __init__(self, state):
        from sarssl_torch.train import state as state_mod

        self.grads = self.clipped = None
        opt = state.optimizer
        layout = getattr(state.model, "shard_layout", None)

        def whole(tensors):
            named = dict(zip(opt.names, tensors))
            return numpy_dict(named if layout is None else layout.full_dict(named))

        apply = state.apply_gradients

        def logged_apply(lr):
            self.grads = whole([torch.zeros_like(p) if p.grad is None else p.grad
                                for p in opt.params])
            apply(lr)

        state.apply_gradients = logged_apply
        self.state_mod, self.clip = state_mod, state_mod._clip_by_global_norm

        def logged_clip(grads, max_norm, global_norm=None):
            out = self.clip(grads, max_norm, global_norm)
            self.clipped = whole(out)
            return out

        state_mod._clip_by_global_norm = logged_clip

    def close(self):
        self.state_mod._clip_by_global_norm = self.clip
        return self.grads, self.clipped


def _full_state(model):
    layout = getattr(model, "shard_layout", None)
    params = dict(model.named_parameters())
    if layout is not None:
        params = layout.full_dict(params)
    return numpy_dict(params), numpy_dict(dict(model.named_buffers()))


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------
def steps_rank(rank, d, m, dropout=0.1, mask=None, wave_seed=3):
    """The four sharded steps on a (d, m) mesh at the tiny profile: a
    pretext train step (its masks logged), a pretext eval step, a downstream
    train step (its masks logged) and a downstream eval step; returns the
    metrics, the whole parameters and buffers after each train step, the
    rank's rows of ``pred`` and its masks. ``mask``: the global batch's
    pretext mask (else drawn from the step's generator)."""
    from sarssl_torch.parallel import (make_mesh, make_sharded_downstream_eval_step,
                                       make_sharded_downstream_step,
                                       make_sharded_pretrain_eval_step,
                                       make_sharded_pretrain_step)
    from sarssl_torch.train import create_train_state, make_adam

    mesh = make_mesh(d, m, device_type="cpu")
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
    wave, gt = waves(wave_seed)

    model = SARSSL(config(True, dropout), device="cpu", seed=0)
    state = create_train_state(model)
    step, shardings, rows = make_sharded_pretrain_step(model, FEAT, mesh, state)
    ev, _, _ = make_sharded_pretrain_eval_step(model, FEAT, mesh, state)
    out["shardings"] = shardings
    log, grads = MaskLog(), GradLog(state)
    met = step(state, rows.local(wave), LR, torch.Generator().manual_seed(5), mask=mask)
    out["pretrain_masks"] = log.close()
    out["pretrain_grads"], _ = grads.close()
    out["pretrain"] = {k: float(v) for k, v in met.items()}
    out["pretrain_params"], out["pretrain_buffers"] = _full_state(model)
    out["pretrain_eval"] = {k: float(v) for k, v in
                            ev(state, rows.local(wave), torch.Generator().manual_seed(9)).items()}

    # make_adam's global-norm clipping, the norm over every rank's shards
    model = SARSSL(config(True, dropout), device="cpu", seed=0)
    state = create_train_state(model, tx=make_adam(LR, grad_clip=CLIP))
    step, _, rows = make_sharded_pretrain_step(model, FEAT, mesh, state)
    grads = GradLog(state)
    met = step(state, rows.local(wave), LR, torch.Generator().manual_seed(5), mask=mask)
    out["clipped_grads"], out["clipped_clipped"] = grads.close()
    out["clipped"] = {k: float(v) for k, v in met.items()}
    out["clipped_params"], out["clipped_buffers"] = _full_state(model)

    model = SARSSL(config(False, dropout), device="cpu", seed=1)
    state = create_train_state(model)
    step, _, rows = make_sharded_downstream_step(model, FEAT, mesh, state)
    ev, _, _ = make_sharded_downstream_eval_step(model, FEAT, mesh, state)
    log, grads = MaskLog(), GradLog(state)
    met = step(state, rows.local(wave), rows.local(gt), LR, torch.Generator().manual_seed(6))
    out["downstream_masks"] = log.close()
    out["downstream_grads"], _ = grads.close()
    out["downstream"] = {k: float(v) for k, v in met.items()}
    out["downstream_params"], out["downstream_buffers"] = _full_state(model)
    em = ev(state, rows.local(wave), rows.local(gt))
    out["downstream_eval"] = {k: float(em[k]) for k in ("loss", "mae")}
    out["pred"] = em["pred"].numpy()
    return out


def jax_steps_rank(rank, wave, gt, mask):
    """The pretext and downstream train steps on a 2x2 mesh at dropout 0 from
    the seeded weights (pretext seed 0, downstream seed 1), the pretext on the
    global batch's ``mask`` (numpy arrays)."""
    from sarssl_torch.ops import PatchMask
    from sarssl_torch.parallel import (make_mesh, make_sharded_downstream_step,
                                       make_sharded_pretrain_step)
    from sarssl_torch.train import create_train_state

    mesh = make_mesh(2, 2, device_type="cpu")
    out = {}
    for key, pre in (("pretrain", True), ("downstream", False)):
        model = SARSSL(config(pre, 0.0), device="cpu", seed=0 if pre else 1)
        state = create_train_state(model)
        if pre:
            step, _, rows = make_sharded_pretrain_step(model, FEAT, mesh, state)
            met = step(state, rows.local(wave), LR, torch.Generator().manual_seed(0),
                       mask=PatchMask(*(torch.as_tensor(t) if t.dtype == bool
                                           else torch.as_tensor(t).long() for t in mask)))
        else:
            step, _, rows = make_sharded_downstream_step(model, FEAT, mesh, state)
            met = step(state, rows.local(wave), rows.local(gt), LR,
                       torch.Generator().manual_seed(0))
        out[key] = float(met["loss"])
        out[key + "_params"], out[key + "_buffers"] = _full_state(model)
    return out


def mesh_rank(rank):
    """Mesh shapes on 4 ranks: all-data, 2x2, replicas 2x1x2 (with a pretext
    step), and a mesh that does not tile the world."""
    from sarssl_torch.parallel import make_mesh, make_sharded_pretrain_step
    from sarssl_torch.train import create_train_state

    out = {}
    m = make_mesh(device_type="cpu")
    out["all_data"] = (m.shape, m.data_index, m.model_index)
    m = make_mesh(2, 2, device_type="cpu")
    out["2x2"] = (m.shape, m.data_index, m.model_index)
    m = make_mesh(n_replica=2, n_data=1, n_model=2, device_type="cpu")
    out["2x1x2"] = (m.shape, m.data_index, m.data_size, m.model_index)
    model = SARSSL(config(True, 0.1), device="cpu", seed=0)
    state = create_train_state(model)
    step, _, rows = make_sharded_pretrain_step(model, FEAT, m, state)
    wave, _ = waves(3)
    out["replica_rows"] = (rows.index, rows.count)
    out["replica_loss"] = float(step(state, rows.local(wave), LR,
                                     torch.Generator().manual_seed(5))["loss"])
    try:
        make_mesh(3, 1, device_type="cpu")
        out["untiled"] = None
    except ValueError as e:
        out["untiled"] = str(e)
    return out


def checkpoint_rank(rank, ckpt_dir, full_state, pretrained):
    """On a 2x2 mesh: (a) save a sharded state whose parameters and moments
    are ``full_state``'s; (b) restore that file into a fresh sharded state
    (each rank's shards returned); (c) lineareval: the encoders loaded from
    ``pretrained`` frozen, one downstream step; (d) three epochs of a
    DownstreamLearner with improving scores, then the 3-epoch ensemble."""
    from sarssl_torch.parallel import (make_mesh, make_sharded_downstream_eval_step,
                                       make_sharded_downstream_step)
    from sarssl_torch.train import (DownstreamLearner, create_train_state, partial_load,
                                    trainable_mask_from_loaded)
    from sarssl_torch.train import checkpoint as ckpt

    mesh = make_mesh(2, 2, device_type="cpu")
    out = {}
    params, mu, nu, count = full_state
    model = SARSSL(config(False, 0.1), device="cpu", seed=1)
    model.load_state_dict(params, strict=True)
    state = create_train_state(model)
    state.optimizer.mu = [mu[n].clone() for n in state.optimizer.names]
    state.optimizer.nu = [nu[n].clone() for n in state.optimizer.names]
    state.optimizer.count = count
    step, shardings, rows = make_sharded_downstream_step(model, FEAT, mesh, state)
    ckpt.save_named(ckpt_dir, state, "sharded", save_opt=True)

    fresh = SARSSL(config(False, 0.1), device="cpu", seed=7)
    fstate = create_train_state(fresh)
    make_sharded_downstream_step(fresh, FEAT, mesh, fstate)
    ckpt.restore_state(fstate, ckpt.load_checkpoint(os.path.join(ckpt_dir, "sharded.msgpack")))
    out["restored"] = (numpy_dict(dict(fresh.named_parameters())),
                       {n: m.numpy().copy() for n, m in zip(fstate.optimizer.names,
                                                            fstate.optimizer.mu)},
                       fstate.optimizer.count)
    out["shardings"] = shardings
    out["model_index"] = mesh.model_index

    lin = SARSSL(config(False, 0.1), device="cpu", seed=2)
    loaded = partial_load(lin, pretrained)
    lstate = create_train_state(lin)
    tmask = trainable_mask_from_loaded(lin, loaded)
    step, _, rows = make_sharded_downstream_step(lin, FEAT, mesh, lstate, trainable_mask=tmask)
    before, _ = _full_state(lin)
    wave, gt = waves(4)
    step(lstate, rows.local(wave), rows.local(gt), 1e-2, torch.Generator().manual_seed(1))
    after, _ = _full_state(lin)
    out["lineareval"] = (loaded, before, after)

    ens = SARSSL(config(False, 0.1), device="cpu", seed=3)
    estate = create_train_state(ens)
    step, _, rows = make_sharded_downstream_step(ens, FEAT, mesh, estate)
    ev, _, _ = make_sharded_downstream_eval_step(ens, FEAT, mesh, estate)
    learner = DownstreamLearner(state=estate, train_step=step, eval_step=ev, lr_init=1e-3,
                                ckpt_dir=os.path.join(ckpt_dir, "ens"), patience=2)
    for e in range(3):
        learner.train_epoch([(rows.local(wave), rows.local(gt))],
                            torch.Generator().manual_seed(e))
        learner.end_epoch(1.0 - e * 0.1)
    avg = learner.ensemble(k=3)
    out["ensemble"] = (numpy_dict(avg), _full_state(ens)[0])
    return out


def cli_rank(rank, cli, argv):
    """``sarssl_torch.cli.<cli>.main(argv)`` on this rank (``torchrun``'s
    environment set by :func:`spawn`); returns its exit code."""
    import importlib

    return importlib.import_module(f"sarssl_torch.cli.{cli}").main(argv)
