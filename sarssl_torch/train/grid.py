"""Vmapped downstream grid (port of ``sarssl_tpu/train/grid.py``): every
(trial, lr) cell as one lane of one program.

The sequential grid (``cli/run_downstream.py``) trains up to 64 separate
batch-8 cells whose small steps leave the card mostly idle, the host's
dispatch setting the pace. Here the cells become lanes: parameters, Adam
moments, BatchNorm running stats and the learning rate gain a leading lane
axis, and one step runs every lane through ``torch.func.vmap`` over
``torch.func.functional_call`` of the model, so each host dispatch carries
N lanes' work (the convolutions become grouped ones). One ``.backward()`` of
the lanes' summed loss gives each lane its own gradient, and a stacked Adam
(``train/state.py::StackedAdam``) applies it with each lane's rate.

Per-cell smoothed early stopping and the two-stage lr/10 run on the host. A
finished cell's lane is frozen with lr 0. The last-k-best ensemble stays on
the card: a ring of the last k epochs' stacked parameters and BatchNorm
stats, folded (in f64, as ``DownstreamLearner.ensemble`` sums) into a cell's
candidate when its best improves, so no per-epoch checkpoint is written.

Randomness: each lane has its own CPU generator, the sequential learner's
per-epoch one; a step takes a child of it (``utils/seeding.step_generator``)
and the step's dropout seeds are drawn from the child in site order, on the
host, before the step, as a ``(lanes, sites)`` tensor that the model reads
through ``models/common.py::LaneSeeds``. Under vmap each dropout site then
runs the lane-seeded kernel (``kernels/dropout.py``), so a lane draws the
masks of its sequential run. The site count is recorded on the first step
and asserted on every later one.

``make_scanned_downstream_steps`` loops over the k steps of a block on the
card (there is no ``lax.scan`` to port): one pinned host-to-device copy
carries a block's waves, and loss and MAE sums stay on the card until the
epoch's end. With ``lane_slots`` the lr cells of one trial share one data
slot, gathered per lane on the device.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from ..data.prefetch import device_prefetch
from ..models.common import Dropout, LaneSeeds, draw_seed
from ..ops.features import FeatureConfig
from ..utils.device import resolve_device
from ..utils.seeding import step_generator
from .learner import EarlyStopping, smooth_data
from .state import StackedAdam, TrainState
from .steps import _check_model_device, _features, _frozen_params, _targets


@dataclass
class StackedState:
    """N cells' states along a leading lane axis: ``params`` and ``buffers``
    (the BatchNorm running stats) by the model's names, the stacked
    optimizer, the step count; ``model`` is the module ``functional_call``
    runs (its own tensors are not read)."""

    model: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: StackedAdam
    step: int = 0

    @property
    def ncell(self) -> int:
        return next(iter(self.params.values())).shape[0]


@torch.no_grad()
def stack_states(states: Sequence[TrainState]) -> StackedState:
    """Stack N TrainStates of one model (parameters, buffers, Adam moments)
    along a new leading axis; the stacked parameters are leaves that take
    gradients."""
    model = states[0].model
    if states[0].optimizer.weight_decay or states[0].optimizer.grad_clip:
        raise ValueError("the vmapped grid steps make_adam(lr)'s Adam only, without weight "
                         "decay or clipping")
    per = [dict(s.model.named_parameters()) for s in states]
    params = {n: torch.stack([p[n].detach() for p in per]).requires_grad_()
              for n, _ in model.named_parameters()}
    bufs = [dict(s.model.named_buffers()) for s in states]
    buffers = {n: torch.stack([b[n] for b in bufs]) for n, _ in model.named_buffers()}
    opt = StackedAdam(params.values())
    for i, name in enumerate(params):
        j = states[0].optimizer.names.index(name)
        opt.mu[i].copy_(torch.stack([s.optimizer.mu[j] for s in states]))
        opt.nu[i].copy_(torch.stack([s.optimizer.nu[j] for s in states]))
    opt.count = states[0].optimizer.count
    return StackedState(model=model, params=params, buffers=buffers, optimizer=opt,
                        step=states[0].step)


@torch.no_grad()
def slice_state(stacked: StackedState, i: int) -> TrainState:
    """Lane ``i`` as a TrainState: its parameters and buffers copied into
    ``stacked.model`` (the one module every lane shares, overwritten) and its
    Adam moments; ``checkpoint.save_named`` writes it in flax's layout."""
    model = stacked.model
    named = dict(model.named_parameters())
    for n, p in stacked.params.items():
        named[n].copy_(p[i])
    for n, b in model.named_buffers():
        b.copy_(stacked.buffers[n][i])
    opt = stacked.optimizer.lane(list(stacked.params), [named[n] for n in stacked.params], i)
    return TrainState(model=model, optimizer=opt, step=stacked.step)


def _site_capacity(model) -> int:
    # a first step's draws: each dropout module runs at most twice a forward
    # (the feed-forward module's), so this bounds the sites; LaneSeeds raises
    # past it
    return 2 * sum(isinstance(m, Dropout) for m in model.modules())


def _lane_features(waves, feat_cfg, dev):
    """``waves (L, bs, ns, nch)`` -> per-lane features ``(L, bs', 2, nf, nt,
    2)``; each example's features are its own (per-example normalisation)."""
    nl = waves.shape[0]
    f = _features(waves.reshape(-1, *waves.shape[2:]), feat_cfg, dev)
    return f.reshape(nl, -1, *f.shape[1:])


def _lane_targets(gts, task, dlabel, dev):
    nl = gts.shape[0]
    t = _targets(gts.reshape(-1, *gts.shape[2:]), task, dlabel, dev)
    return t.reshape(nl, -1, *t.shape[1:])


def _lane_steps(model, feat_cfg, task, trainable_mask, dlabel, dev):
    """``(lane_step, evalf)``: ``lane_step(stacked, feats (N,...), tar (N,bs,d),
    lrs (N,), seeds (N, nsites)) -> (losses (N,), maes (N,), sites drawn)``
    on per-lane features already on the device; ``evalf`` as
    :func:`make_vmapped_downstream_steps` returns it."""
    _check_model_device(model, dev)
    _frozen_params(model, trainable_mask)  # the mask must name every parameter
    frozen_names = {n for n, trainable in (trainable_mask or {}).items() if not trainable}
    drawn = [0]

    def body(params, buffers, feats, tar, seeds):
        gen = LaneSeeds(seeds)
        pred, _ = functional_call(model, (params, buffers), (feats,),
                                  {"train": True, "generator": gen})
        drawn[0] = gen.pos  # the body runs once for every lane
        loss = ((pred - tar) ** 2).mean()
        return loss, (pred.detach() - tar).abs().mean()

    vbody = vmap(body)

    def lane_step(stacked: StackedState, feats, tar, lrs, seeds):
        model.train()
        params = {n: (p.detach() if n in frozen_names else p) for n, p in stacked.params.items()}
        losses, maes = vbody(params, stacked.buffers, feats, tar, seeds)
        losses.sum().backward()
        with torch.no_grad():
            kept = {n: stacked.params[n].clone() for n in frozen_names}
            stacked.optimizer.update(lrs)
            for p in stacked.params.values():
                p.grad = None
            for n, v in kept.items():
                stacked.params[n].copy_(v)
        stacked.step += 1
        return losses.detach(), maes.detach(), drawn[0]

    def ebody(params, buffers, feats, tar):
        pred, _ = functional_call(model, (params, buffers), (feats,), {"train": False})
        err = pred - tar
        return (err ** 2).mean(), err.abs().mean()

    vebody = vmap(ebody, in_dims=(0, 0, None, None))

    @torch.no_grad()
    def evalf(stacked: StackedState, wave, gt):
        model.eval()
        losses, maes = vebody(stacked.params, stacked.buffers, _features(wave, feat_cfg, dev),
                              _targets(gt, task, dlabel, dev))
        return {"loss": losses, "mae": maes}

    return lane_step, evalf


def make_vmapped_downstream_steps(model, feat_cfg: FeatureConfig = FeatureConfig(),
                                  task: str = "TDOA", trainable_mask=None, dlabel: int = 1,
                                  device="cuda"):
    """``(train, eval)`` steps vmapped over the leading lane axis.

    ``train(stacked, waves (N,bs,ns,nch), gts (N,bs[,d]), lrs (N,), seeds
    (N, nsites)) -> {"loss", "mae"}`` (each ``(N,)`` on the device) updates
    ``stacked`` in place: the ``make_downstream_step`` body per lane, one
    backward over the lanes, the stacked Adam at each lane's rate, frozen
    leaves (``trainable_mask``) put back; ``seeds``: each lane's dropout
    seeds in site order.
    ``eval(stacked, wave (bs,ns,nch), gt (bs[,d])) -> {"loss", "mae"}``: one
    batch, shared by every lane (in-dims ``(0, None, None)``)."""
    dev = resolve_device(device)
    lane_step, evalf = _lane_steps(model, feat_cfg, task, trainable_mask, dlabel, dev)

    def train(stacked: StackedState, waves, gts, lrs, seeds):
        losses, maes, _ = lane_step(stacked, _lane_features(waves, feat_cfg, dev),
                                    _lane_targets(gts, task, dlabel, dev), lrs,
                                    torch.as_tensor(seeds).to(dev))
        return {"loss": losses, "mae": maes}

    return train, evalf


class _Seeds:
    """The host's draw of a block's dropout seeds: per step and lane a child
    of the lane's generator, then the step's sites in order. The site count
    is unknown until a first step ran: that step draws a bound's worth (the
    child is a step's own, so extra draws change nothing) and records it."""

    def __init__(self, capacity: int):
        self.capacity, self.sites = capacity, None

    def draw(self, gens: Sequence[torch.Generator], nsteps: int) -> torch.Tensor:
        n = self.capacity if self.sites is None else self.sites
        out = [[[draw_seed(child) for _ in range(n)]
                for child in (step_generator(g) for g in gens)] for _ in range(nsteps)]
        return torch.tensor(out, dtype=torch.int64).reshape(nsteps, len(gens), n)

    def record(self, drawn: int) -> None:
        if self.sites is None:
            self.sites = drawn
        elif drawn != self.sites:
            raise RuntimeError(f"a grid step drew {drawn} dropout seeds, the first {self.sites}")


def make_scanned_downstream_steps(model, feat_cfg: FeatureConfig = FeatureConfig(),
                                  task: str = "TDOA", trainable_mask=None, dlabel: int = 1,
                                  lane_slots=None, device="cuda"):
    """Block variants of the vmapped steps: each runs the k steps of a block
    on the card, with the block's waves already there (one pinned copy) and
    the loss and MAE sums kept there.

    ``train_block(stacked, gens, waves (k,S,bs,ns,nch), gts (k,S,bs[,d]),
    lrs (N,)) -> (loss_sums (N,), mae_sums (N,))``, f64 on the device;
    ``gens``: one CPU generator a lane (its epoch generator, advanced a draw a
    step as ``DownstreamLearner.train_epoch`` advances it).
    ``eval_block(stacked, waves (k,bs,ns,nch), gts (k,bs[,d])) -> sums``.
    ``train_block_resident(stacked, gens, waves_all (ndata,ns,nch), idx
    (k,S,bs), gts, lrs)``: the rows gathered by index from a split staged on
    the card.

    S is the number of data slots: with ``lane_slots=None`` S == N and slot
    i feeds lane i; otherwise lane j reads slot ``lane_slots[j]``, so the lr
    cells of a trial move their (identical) data once."""
    dev = resolve_device(device)
    lane_step, evalf = _lane_steps(model, feat_cfg, task, trainable_mask, dlabel, dev)
    slots = None if lane_slots is None else torch.as_tensor(lane_slots, dtype=torch.int64,
                                                            device=dev)
    seeds = _Seeds(_site_capacity(model))

    def run_steps(stacked, gens, nsteps, step_data, lrs):
        nlane = stacked.ncell
        loss_sum = torch.zeros(nlane, dtype=torch.float64, device=dev)
        mae_sum = torch.zeros(nlane, dtype=torch.float64, device=dev)
        t = 0
        while t < nsteps:
            # the first step of a run learns the site count; then a block's
            # seeds go over in one copy
            n = 1 if seeds.sites is None else nsteps - t
            block_seeds = seeds.draw(gens, n)
            block_seeds = (block_seeds.pin_memory().to(dev, non_blocking=True)
                           if dev.type == "cuda" else block_seeds)
            for s in range(n):
                w, g = step_data(t + s)
                feats = _lane_features(w, feat_cfg, dev)
                tar = _lane_targets(g, task, dlabel, dev)
                if slots is not None:
                    feats, tar = feats.index_select(0, slots), tar.index_select(0, slots)
                losses, maes, drawn = lane_step(stacked, feats, tar, lrs, block_seeds[s])
                seeds.record(drawn)
                loss_sum += losses
                mae_sum += maes
            t += n
        return loss_sum, mae_sum

    def train_block(stacked, gens, waves, gts, lrs):
        return run_steps(stacked, gens, waves.shape[0], lambda t: (waves[t], gts[t]), lrs)

    def train_block_resident(stacked, gens, waves_all, idx, gts, lrs):
        idx = torch.as_tensor(idx).to(dev)

        def step_data(t):
            w = waves_all.index_select(0, idx[t].reshape(-1))
            return w.reshape(*idx[t].shape, *waves_all.shape[1:]), gts[t]

        return run_steps(stacked, gens, idx.shape[0], step_data, lrs)

    def eval_block(stacked, waves, gts):
        loss_sum = torch.zeros(stacked.ncell, dtype=torch.float64, device=dev)
        mae_sum = torch.zeros(stacked.ncell, dtype=torch.float64, device=dev)
        for t in range(waves.shape[0]):
            m = evalf(stacked, waves[t], gts[t])
            loss_sum += m["loss"]
            mae_sum += m["mae"]
        return loss_sum, mae_sum

    # the site count the steps learned, shared by both train functions
    train_block.seeds = train_block_resident.seeds = seeds
    return train_block, eval_block, train_block_resident


def _blocks(batches: Iterable, k: int):
    """Group a stream of per-step ``(waves, gts)`` into ``(k', ...)``
    step-axis stacks (k' == k except possibly the last block)."""
    buf = []
    for item in batches:
        buf.append(item)
        if len(buf) == k:
            yield (np.stack([w for w, _ in buf]), np.stack([g for _, g in buf]))
            buf = []
    if buf:
        yield (np.stack([w for w, _ in buf]), np.stack([g for _, g in buf]))


def _to_device(blocks: Iterable, dev: torch.device):
    """Blocks as tensors on ``dev``: a pinned copy each on the card, two in
    flight (``data/prefetch.py``)."""
    if dev.type != "cuda":
        return ((torch.as_tensor(w), torch.as_tensor(g)) for w, g in blocks)
    return device_prefetch(blocks, size=2, device=dev)


@dataclass
class _Cell:
    lr: float
    trial: int
    name: str
    patience: int
    lr_drops: int = 0
    done: bool = False
    val_raw: List[float] = field(default_factory=list)
    best_epochs: List[int] = field(default_factory=list)
    epochs_run: int = 0
    stopper: EarlyStopping = None

    def __post_init__(self):
        self.stopper = EarlyStopping(self.patience)


class VmappedGridRunner:
    """Drives the stacked cells through the DownstreamLearner life cycle."""

    def __init__(self, model, feat_cfg: FeatureConfig, init_states: Sequence[TrainState],
                 cells: Sequence[Tuple[int, float]], task: str = "TDOA", dlabel: int = 1,
                 trainable_mask=None, patience: int = 10, smooth_alpha: float = 0.6,
                 ensemble_k: int = 5, scan_block: int = 25, lane_slots=None, device="cuda"):
        self.dev = resolve_device(device)
        self.scan_block = scan_block
        self.lane_slots = lane_slots
        (self.train_block, self.eval_block,
         self.train_block_resident) = make_scanned_downstream_steps(
            model, feat_cfg, task, trainable_mask, dlabel, lane_slots=lane_slots,
            device=self.dev)
        self.resident_waves = None
        self.states = stack_states(list(init_states))
        self.cells = [_Cell(lr=lr, trial=t, name=f"trial{t}_lr{lr:g}", patience=patience)
                      for t, lr in cells]
        self.smooth_alpha = smooth_alpha
        self.k = ensemble_k
        self.epoch = 0
        # the ensemble on the card: a ring of the last k epochs' stacked
        # (params, buffers) and a candidate a lane. A cell's best can only
        # improve at the current epoch, so its window [best-k+1 .. best] is
        # the ring at that moment: fold it into the cell's candidate then.
        self._ring = collections.deque(maxlen=ensemble_k)
        with torch.no_grad():
            self._cand_p = {n: torch.zeros_like(p) for n, p in self.states.params.items()}
            self._cand_b = {n: torch.zeros_like(b) for n, b in self.states.buffers.items()}

    @property
    def ncell(self) -> int:
        return len(self.cells)

    @property
    def all_done(self) -> bool:
        return all(c.done for c in self.cells)

    def _lrs(self) -> torch.Tensor:
        return torch.tensor([0.0 if c.done else c.lr for c in self.cells],
                            dtype=torch.float32).to(self.dev)

    def _epoch(self, blocks, run) -> Dict[str, np.ndarray]:
        """``run(block) -> (loss sums, MAE sums)`` over the blocks; the means
        a step, read from the card once."""
        sums = torch.zeros((2, self.ncell), dtype=torch.float64, device=self.dev)
        n = 0
        for block in blocks:
            sums += torch.stack(run(block))
            n += block[0].shape[0]
        tot = sums.cpu().numpy() / max(n, 1)
        return {"loss": tot[0], "mae": tot[1]}

    def train_epoch(self, stacked_batches: Iterable,
                    epoch_generators: Sequence[torch.Generator]) -> Dict[str, np.ndarray]:
        """``stacked_batches`` yields per-step host ``(waves (S,bs,ns,nch),
        gts (S,bs[,d]))``, S = ncell or the slot count; ``epoch_generators``:
        one CPU generator a cell (the sequential learner's epoch generator),
        advanced once a step."""
        gens, lrs = list(epoch_generators), self._lrs()
        return self._epoch(_to_device(_blocks(stacked_batches, self.scan_block), self.dev),
                           lambda b: self.train_block(self.states, gens, *b, lrs))

    def stage_train_waves(self, waves_all) -> None:
        """Put the whole train split on the card once (a tensor already there
        is kept, so chunks share one staging); ``train_epoch_resident`` then
        takes index batches only."""
        w = torch.as_tensor(waves_all)
        if w.device.type != self.dev.type:
            w = w.to(torch.float32)
            w = w.pin_memory().to(self.dev) if self.dev.type == "cuda" else w
        self.resident_waves = w

    def train_epoch_resident(self, idx_batches: Iterable,
                             epoch_generators: Sequence[torch.Generator]) -> Dict[str, np.ndarray]:
        """``idx_batches`` yields per-step ``(idx (S,bs) int, gts (S,bs[,d]))``;
        the rows gather from the staged split on the card. Same generator
        chain and metrics as ``train_epoch``."""
        if self.resident_waves is None:
            raise RuntimeError("call stage_train_waves first")
        gens, lrs = list(epoch_generators), self._lrs()
        blocks = ((np.asarray(i, np.int64), g) for i, g in _blocks(idx_batches, self.scan_block))
        return self._epoch(_to_device(blocks, self.dev), lambda b: self.train_block_resident(
            self.states, gens, self.resident_waves, *b, lrs))

    def eval_epoch(self, batches: Iterable) -> Dict[str, np.ndarray]:
        """Every lane on the same batches (host ``(wave (bs,ns,nch), gt)``)."""
        return self.eval_epoch_staged(_to_device(_blocks(batches, self.scan_block), self.dev))

    def stage_eval_blocks(self, batches: Iterable) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """A fixed eval stream put on the card once and reused every epoch."""
        return list(_to_device(_blocks(batches, self.scan_block), self.dev))

    def eval_epoch_staged(self, staged) -> Dict[str, np.ndarray]:
        return self._epoch(staged, lambda b: self.eval_block(self.states, *b))

    @torch.no_grad()
    def end_epoch(self, val_maes: np.ndarray) -> bool:
        """Per-cell smoothed early stopping, lr/10 and the ensemble's
        bookkeeping on the card. Returns True when every cell has stopped."""
        self._ring.append(({n: p.detach().clone() for n, p in self.states.params.items()},
                           {n: b.clone() for n, b in self.states.buffers.items()}))
        improved = []
        for i, c in enumerate(self.cells):
            if c.done:
                continue
            c.val_raw.append(float(val_maes[i]))
            smoothed = smooth_data(c.val_raw, self.smooth_alpha)[-1]
            if c.stopper.update(-smoothed):
                c.best_epochs.append(self.epoch)
                improved.append(i)
            c.epochs_run = self.epoch + 1
            if c.stopper.stopped:
                if c.lr_drops == 0:
                    c.lr /= 10.0
                    c.lr_drops = 1
                    c.stopper.reset_counter()
                else:
                    c.done = True
        if improved:
            lanes = torch.tensor(improved, dtype=torch.int64).to(self.dev)
            for part, cand in ((0, self._cand_p), (1, self._cand_b)):
                for name, c in cand.items():
                    # DownstreamLearner.ensemble's average: summed in f64 in
                    # epoch order, divided, cast back
                    win = sum(snap[part][name].index_select(0, lanes).double()
                              for snap in self._ring) / len(self._ring)
                    c.index_copy_(0, lanes, win.to(c.dtype))
        self.epoch += 1
        return self.all_done

    def finalize(self) -> None:
        for c in self.cells:
            c.done = True

    @torch.no_grad()
    def ensembled_states(self) -> StackedState:
        """Install each cell's window-averaged parameters and BatchNorm stats
        (``DownstreamLearner.ensemble``) into the stacked state. A lane that
        never improved (a NaN val MAE from epoch 0) keeps its live state, as
        the sequential learner falls back to its last epoch; a chunk whose
        every lane is NaN still returns its live states."""
        self.finalize()
        if self.epoch == 0:
            raise RuntimeError("end_epoch was never called (epochs=0?)")
        has_best = torch.tensor([bool(c.best_epochs) for c in self.cells]).to(self.dev)
        for live, cand in ((self.states.params, self._cand_p),
                           (self.states.buffers, self._cand_b)):
            for name, t in live.items():
                m = has_best.reshape(-1, *[1] * (t.ndim - 1))
                t.copy_(torch.where(m, cand[name], t))
        return self.states
