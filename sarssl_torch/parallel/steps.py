"""Multi-device train and eval steps (port of ``sarssl_tpu/parallel/steps.py``):
the single-device steps' bodies over a mesh of ``torch.distributed`` ranks.

JAX's sharded step has global-array semantics: under GSPMD it computes what
the single-device step computes on the whole batch. These steps keep that:

  * each rank takes its rows of the global batch (``batch_sharding``); the
    mask and the dropout seeds are drawn for the global batch from the same
    generator on every rank, and each rank keeps its rows' share (its rows of
    the mask; its slice of each dropout mask, ``models/common.py``);
  * the pretext loss, the downstream MSE / MAE and BatchNorm's statistics
    are the global batch's (sums over the data group);
  * tensor parallelism over the model group follows the JAX rule tables
    (``mesh.py``): each rank holds its heads' and feed-forward units' shards
    (``shard_state``);
  * the steps are ``train/steps.py``'s, given this rank's rows, the gradient
    sync and the global batch's mean;
  * with more than one data rank the gradients accumulate into views of one
    flat bucket (as ``DistributedDataParallel`` keeps them), summed over the
    data group after the backward with no copy in or out; the replicated
    leaves a rank uses only in part (its rows of ``u_bias`` / ``v_bias``) are
    summed over the model group; ``make_adam``'s global-norm clipping takes
    the norm of the whole tree (the sharded leaves' squares summed over the
    model group, the replicated ones counted once); Adam updates each rank's
    shard.

So a ``DxM`` step equals the world-size-1 step up to reduction order. Scalar
metrics come back the same on every rank; ``pred`` / ``embed`` hold the
rank's rows. The builders return ``(step, shardings, rows)``: the sharded
axis of each parameter (None: replicated) and this rank's rows.

Frozen parameters (``trainable_mask``) work as in ``train/steps.py`` and
stay out of the bucket.
:class:`DistributedDataParallel` is not used: these steps are functions over
a module and an optimizer that reads ``.grad``, and frozen parameters would
need its search for unused ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..ops.features import FeatureConfig
from ..ops.mask import T_MODE
from ..train.steps import (_mean, make_downstream_eval_step, make_downstream_step,
                           make_pretrain_eval_step, make_pretrain_step)
from . import tp
from .mesh import Mesh, batch_sharding, param_shardings


class Layout:
    """How a model's parameters lie over a mesh: ``dims[name]`` is the axis
    a parameter is sharded along over 'model' (None: replicated);
    ``partial`` names the replicated leaves each model rank uses only in
    part. Converts between whole tensors (files, the world-size-1 state) and
    this rank's shards."""

    def __init__(self, mesh: Mesh, dims: Dict[str, Optional[int]], partial=()):
        self.mesh, self.dims, self.partial = mesh, dims, frozenset(partial)

    @property
    def is_writer(self) -> bool:
        return self.mesh.is_writer

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor ``t`` of parameter ``name``."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        n = t.shape[dim] // self.mesh.model_size
        return t.narrow(dim, self.mesh.model_index * n, n).clone()

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from every rank's shard
        ``t`` (a collective over the model group)."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        return tp.gathered(t, dim, self.mesh.model_group)

    def full_dict(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.full(n, t) for n, t in named.items()}

    def full_shape(self, name: str, shape) -> tuple:
        dim = self.dims.get(name)
        shape = tuple(shape)
        if dim is None:
            return shape
        return shape[:dim] + (shape[dim] * self.mesh.model_size,) + shape[dim + 1:]


def state_shardings(mesh: Mesh, state) -> Dict[str, Optional[int]]:
    """The sharded axis of each parameter (Adam's moments take their
    parameter's); raises on a model axis > 1 when no parameter matches a
    rule, as the JAX package asserts (the model would run replicated)."""
    dims = param_shardings(mesh, state.model)
    if mesh.model_size > 1 and all(d is None for d in dims.values()):
        raise ValueError("model axis > 1 but no parameter matched the tensor-parallel "
                         "sharding rules (parallel/mesh.py): this model would be fully "
                         "replicated; run with model=1 or extend the rule tables")
    return dims


def _install_tp(model, mesh: Mesh, dims) -> List[str]:
    """Run sharded the modules that the rule tables shard: each sharded
    parameter's owner (its nearest enclosing module with a
    ``tensor_parallel`` method) switches to its shard of the heads or units,
    and every ``Dense`` whose weight is sharded along its input axis sums
    its partial products over the model group. Returns the partial leaves
    (what the owners name). A sharded parameter with no owner raises."""
    from ..models.common import Dense

    modules = dict(model.named_modules())
    owners = {name for name, m in modules.items() if hasattr(m, "tensor_parallel")}

    def owner(pname):
        parts = pname.split(".")[:-1]
        for k in range(len(parts), -1, -1):
            if ".".join(parts[:k]) in owners:
                return ".".join(parts[:k])
        return None

    sharded = [n for n, d in dims.items() if d is not None]
    stray = sorted(n for n in sharded if owner(n) is None)
    if stray:
        raise ValueError(f"parameters a rule shards lie in no module that runs them sharded: "
                         f"{stray}")
    partial = []
    for name in sorted({owner(n) for n in sharded}):
        pre = name + "." if name else ""
        partial += [pre + leaf for leaf in modules[name].tensor_parallel(
            mesh.model_group, mesh.model_index, mesh.model_size)]
    for name, m in modules.items():
        if isinstance(m, Dense) and dims.get((name + "." if name else "") + "weight") == 1:
            m.reduce_group = mesh.model_group  # (out, in): a row-parallel shard
    return partial


def _install_dp(model, mesh: Mesh) -> None:
    """The data group for BatchNorm and the pretext loss, and each dropout
    site's block of the global batch."""
    from ..models.common import BatchNorm, Dropout
    from ..models.sarssl import SARSSL

    for m in model.modules():
        if isinstance(m, (BatchNorm, SARSSL)):
            m.data_group = mesh.data_group
        elif isinstance(m, Dropout):
            m.data_shard = (mesh.data_index, mesh.data_size)


@torch.no_grad()
def shard_state(state, mesh: Mesh) -> Layout:
    """Shard a state of whole parameters over ``mesh`` in place: each
    parameter (and Adam's moments) becomes this rank's shard, the modules
    learn their groups, and the model and the optimizer keep the
    :class:`Layout` (``shard_layout`` / ``layout``) that checkpoints read. A
    model already sharded over ``mesh`` keeps its layout (a fresh optimizer
    over it is sharded alike)."""
    model, opt = state.model, state.optimizer
    layout = getattr(model, "shard_layout", None)
    if layout is None:
        dims = state_shardings(mesh, state)
        params = dict(model.named_parameters())
        for name, dim in dims.items():
            if dim is not None and params[name].shape[dim] % mesh.model_size:
                raise ValueError(f"{name} {tuple(params[name].shape)}: axis {dim} does not "
                                 f"split over {mesh.model_size} model ranks")
        partial = _install_tp(model, mesh, dims) if mesh.model_size > 1 else []
        if mesh.data_size > 1:
            _install_dp(model, mesh)
        layout = Layout(mesh, dims, partial)
        for name, p in params.items():
            p.data = layout.local(name, p.data)
        model.shard_layout = layout
    elif layout.mesh is not mesh:
        raise ValueError("the model is sharded over another mesh")
    if getattr(opt, "layout", None) is not layout:
        for i, (name, p) in enumerate(zip(opt.names, opt.params)):
            if opt.mu[i].shape != p.shape:
                opt.mu[i], opt.nu[i] = layout.local(name, opt.mu[i]), layout.local(name, opt.nu[i])
        opt.layout = layout
        if mesh.model_size > 1:
            opt.global_norm = _GlobalNorm(opt.names, layout)
    return layout


class _GlobalNorm:
    """``optax.global_norm`` of the whole gradient tree from a rank's
    shards: the sharded leaves' squares summed over the model group, the
    replicated ones (the same on every model rank) counted once."""

    def __init__(self, names, layout: Layout):
        self.sharded = [layout.dims.get(n) is not None for n in names]
        self.group = layout.mesh.model_group

    def __call__(self, grads: List[torch.Tensor]) -> torch.Tensor:
        def squares(gs):
            if not gs:
                return torch.zeros((), dtype=torch.float32, device=grads[0].device)
            return torch.stack(torch._foreach_norm(gs)).square().sum()

        sh = [g for g, s in zip(grads, self.sharded) if s]
        rep = [g for g, s in zip(grads, self.sharded) if not s]
        return torch.sqrt(tp.summed(squares(sh), self.group) + squares(rep))


class _GradSync:
    """The gradients summed over the data group, and the partial leaves'
    over the model group. ``attach()`` (before the forward) zeroes one flat
    bucket and makes each trainable parameter's gradient a view of it, so
    the backward accumulates into the bucket; the call (after the backward)
    all-reduces it in place. With one data rank there is no bucket."""

    def __init__(self, model, layout: Layout):
        mesh = layout.mesh
        named = list(model.named_parameters())
        self.params = [p for _, p in named] if mesh.data_size > 1 else []
        self.partial = ([p for n, p in named if n in layout.partial]
                        if mesh.model_size > 1 else [])
        self.mesh = mesh
        self.flat, self.views = None, None

    @torch.no_grad()
    def attach(self) -> None:
        if self.views is None:  # a step's frozen parameters are off here, and stay so
            self.params = [p for p in self.params if p.requires_grad]
            if self.params:
                self.flat = torch.empty(sum(p.numel() for p in self.params),
                                        dtype=self.params[0].dtype, device=self.params[0].device)
            self.views = ([] if self.flat is None else
                          [c.view_as(p) for c, p in zip(
                              self.flat.split([p.numel() for p in self.params]), self.params)])
        if self.flat is not None:
            self.flat.zero_()
        for p, v in zip(self.params, self.views):
            p.grad = v

    @torch.no_grad()
    def __call__(self) -> None:
        if self.flat is not None:
            dist.all_reduce(self.flat, group=self.mesh.data_group)
        for p in self.partial:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=self.mesh.model_group)


def _prepare(model, mesh: Mesh, state_template, sync: bool = False):
    """Shard the state; returns the layout, this rank's rows, the gradient
    sync (None where there is nothing to sum) and the global batch's mean."""
    layout = shard_state(state_template, mesh)
    p = next(model.parameters())
    if p.device != mesh.device:
        raise ValueError(f"model is on {p.device}, the mesh's rank on {mesh.device}")
    grad_sync = None
    if sync and (mesh.data_size > 1 or layout.partial):
        grad_sync = _GradSync(model, layout)
    return layout, batch_sharding(mesh), grad_sync, _global_mean(mesh)


def _global_mean(mesh: Mesh):
    """The mean over the global batch (the rows of every data rank), as
    ``train/steps.py::_mean`` takes it over one rank's."""
    if mesh.data_size == 1:
        return _mean

    def mean(x: torch.Tensor, dim: Optional[int] = None, grad: bool = False) -> torch.Tensor:
        total = x.sum() if dim is None else x.sum(dim=dim)
        n = x.numel() if dim is None else x.shape[dim]
        total = (tp.reduce_from if grad else tp.summed)(total, mesh.data_group)
        return total / (n * mesh.data_size)

    return mean


def make_sharded_pretrain_step(model, feat_cfg: FeatureConfig, mesh: Mesh, state_template,
                               mask_mode: str = T_MODE, trainable_mask=None):
    """Returns ``(step, shardings, rows)``; ``step(state, wave_rows, lr,
    generator, mask=None) -> {"loss", "diff"}`` (global). ``wave_rows``: this
    rank's rows of the global batch; ``mask``: the global batch's."""
    layout, rows, sync, _ = _prepare(model, mesh, state_template, sync=True)
    step = make_pretrain_step(model, feat_cfg, mesh.device, trainable_mask, mask_mode,
                              rows=rows, grad_sync=sync)
    return step, layout.dims, rows


def make_sharded_pretrain_eval_step(model, feat_cfg: FeatureConfig, mesh: Mesh,
                                    state_template, mask_mode: str = T_MODE):
    """Returns ``(step, shardings, rows)``; ``step(state, wave_rows,
    generator, mask=None) -> {"loss", "diff"}`` (global; eval mode)."""
    layout, rows, _, _ = _prepare(model, mesh, state_template)
    step = make_pretrain_eval_step(model, feat_cfg, mesh.device, mask_mode, rows=rows)
    return step, layout.dims, rows


def make_sharded_downstream_step(model, feat_cfg: FeatureConfig, mesh: Mesh, state_template,
                                 task: str = "TDOA", trainable_mask=None, dlabel: int = 1):
    """Returns ``(step, shardings, rows)``; ``step(state, wave_rows, gt_rows,
    lr, generator) -> {"loss", "mae"}``: the global batch's MSE and MAE."""
    layout, rows, sync, mean = _prepare(model, mesh, state_template, sync=True)
    step = make_downstream_step(model, feat_cfg, task, trainable_mask, dlabel, mesh.device,
                                grad_sync=sync, mean=mean)
    return step, layout.dims, rows


def make_sharded_downstream_eval_step(model, feat_cfg: FeatureConfig, mesh: Mesh,
                                      state_template, task: str = "TDOA", dlabel: int = 1):
    """Returns ``(step, shardings, rows)``; ``step(state, wave_rows,
    gt_rows)`` -> ``loss``, ``mae`` (and ``mae_dims`` when ``dlabel > 1``) of
    the global batch, ``pred`` and ``embed`` of this rank's rows."""
    layout, rows, _, mean = _prepare(model, mesh, state_template)
    step = make_downstream_eval_step(model, feat_cfg, task, dlabel, mesh.device, mean=mean)
    return step, layout.dims, rows
