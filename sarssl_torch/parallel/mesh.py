"""Device meshes and the tensor-parallel rules (port of
``sarssl_tpu/parallel/mesh.py``) over ``torch.distributed``.

One process a device: ``cuda:LOCAL_RANK`` with NCCL on the card, the CPU
with gloo when the caller asks for it. The mesh is ``('data', 'model')``, or
``('replica', 'data', 'model')`` with replicas, built by
``torch.distributed.device_mesh.init_device_mesh``; rank ``r`` sits at
``r = (replica * D + data) * M + model``:

  * ``data`` (folded with ``replica``): the batch's rows, each data rank a
    contiguous block of the global batch (:func:`batch_sharding`); gradients
    and BatchNorm's statistics are summed over the data group;
  * ``model``: Megatron-style tensor parallelism over attention heads and
    feed-forward units, by the JAX package's rule tables, copied here as
    they are and applied to each parameter's flax path
    (``utils/weights.py``'s names).

:func:`init_distributed` joins the process group: from ``torchrun``'s
environment when it is there, else as a group of one in this process.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"  # folded with 'data' for the batch and the gradients


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device_type: str = "cuda") -> bool:
    """Join the default process group: NCCL for ``device_type`` 'cuda'
    (this process's card is ``cuda:LOCAL_RANK``), gloo for 'cpu'. Under
    ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment) from its
    rendezvous; else a group of one rank on a free localhost port. Returns
    True when this call made the group (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on 'cuda' needs a GPU; run with the CPU (--cpu) "
                               "to use gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                rank=0, world_size=1)
    return True


@dataclass
class Mesh:
    """This rank's place in the mesh, its groups and its device."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    shape: Dict[str, int]  # axis name -> size, as jax's Mesh.shape
    device: torch.device
    data_group: object  # the ranks of this model index (replicas and data)
    model_group: object  # the ranks of this data index
    data_index: int
    data_size: int
    model_index: int
    model_size: int
    rank: int

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes files and logs."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_replica: int = 1,
              device_type: str = "cuda") -> Mesh:
    """('data','model') mesh, or ('replica','data','model') when
    ``n_replica > 1``, over every rank of the process group (joined here by
    :func:`init_distributed` if it is not yet). ``n_replica * n_data *
    n_model`` must equal the world size: a mesh that does not tile it raises,
    as the JAX package's assert does for its devices."""
    init_distributed(device_type)
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // (n_model * n_replica)
    if n_data < 1 or n_model < 1 or n_replica < 1:
        raise ValueError(f"mesh {n_replica}x{n_data}x{n_model}: every axis needs a rank")
    used = n_replica * n_data * n_model
    if used != n:
        raise ValueError(f"mesh {n_replica}x{n_data}x{n_model} uses {used} ranks of a world "
                         f"of {n}: it must tile the world")
    from torch.distributed.device_mesh import init_device_mesh

    shape = ((n_replica, n_data, n_model) if n_replica > 1 else (n_data, n_model))
    axes = ((REPLICA_AXIS, DATA_AXIS, MODEL_AXIS) if n_replica > 1
            else (DATA_AXIS, MODEL_AXIS))
    dmesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    rank = dist.get_rank()
    dsize = n_replica * n_data
    # the data group folds replica and data, as P(('replica', 'data')) does;
    # every rank takes part in making every group
    data_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(dsize)])
        if rank % n_model == m:
            data_group = g
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    return Mesh(device_mesh=dmesh, shape=dict(zip(axes, shape)), device=device,
                data_group=data_group, model_group=dmesh.get_group(MODEL_AXIS),
                data_index=rank // n_model, data_size=dsize, model_index=rank % n_model,
                model_size=n_model, rank=rank)


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``'DxM'`` -> ``(D, M)``, as the CLIs' ``--mesh`` reads it."""
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (data x model ranks), e.g. 2x1, not {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec}: both sizes must be at least 1")
    return d, m


@dataclass(frozen=True)
class Rows:
    """This rank's rows of a global batch: block ``index`` of ``count``
    equal blocks (the port's ``batch_sharding``: the leading axis over
    'data', and 'replica' with it), on ``device``."""

    index: int
    count: int
    device: torch.device

    def slice(self, n_global: int) -> slice:
        if n_global % self.count:
            raise ValueError(f"a global batch of {n_global} rows does not split into "
                             f"{self.count} data ranks")
        n = n_global // self.count
        return slice(self.index * n, (self.index + 1) * n)

    def local(self, x):
        """This rank's block of a global batch (any leading-axis array)."""
        return x[self.slice(x.shape[0])]


def batch_sharding(mesh: Mesh) -> Rows:
    """Leading (batch) axis over 'data' (and 'replica' when present)."""
    return Rows(mesh.data_index, mesh.data_size, mesh.device)


# --- tensor-parallel rules: sarssl_tpu/parallel/mesh.py, as they are -------

_COL_PARALLEL_KERNELS = (  # shard output features over 'model'
    ("mhsa", "query", "kernel"), ("mhsa", "key", "kernel"),
    ("mhsa", "value", "kernel"), ("mhsa", "pos", "kernel"),
    ("ff1", "Dense_0", "kernel"), ("ff2", "Dense_0", "kernel"),
    ("proj0", "kernel"),
)
_ROW_PARALLEL_KERNELS = (  # shard input features over 'model'
    ("mhsa", "out", "kernel"),
    ("ff1", "Dense_1", "kernel"), ("ff2", "Dense_1", "kernel"),
    ("proj1", "kernel"),
)
_COL_PARALLEL_BIASES = (
    ("ff1", "Dense_0", "bias"), ("ff2", "Dense_0", "bias"),
    ("mhsa", "query", "bias"), ("mhsa", "key", "bias"),
    ("mhsa", "value", "bias"), ("proj0", "bias"),
)


def _endswith(path: Tuple[str, ...], suffix: Tuple[str, ...]) -> bool:
    return len(path) >= len(suffix) and tuple(path[-len(suffix):]) == suffix


def param_pspec(path: Tuple[str, ...], leaf) -> Tuple:
    """PartitionSpec (as a tuple) of one flax parameter leaf under
    ('data','model'): ``(None, 'model')``, ``('model', None)``,
    ``('model',)`` or ``()`` (replicated)."""
    ndim = np.ndim(leaf)
    for suf in _COL_PARALLEL_KERNELS:
        if _endswith(path, suf) and ndim == 2:
            return (None, MODEL_AXIS)
    for suf in _ROW_PARALLEL_KERNELS:
        if _endswith(path, suf) and ndim == 2:
            return (MODEL_AXIS, None)
    for suf in _COL_PARALLEL_BIASES:
        if _endswith(path, suf) and ndim == 1:
            return (MODEL_AXIS,)
    return ()  # replicate


def param_pspecs(model: torch.nn.Module) -> Dict[str, Tuple]:
    """The PartitionSpec of each of the model's parameters, by its flax path
    and flax layout (``utils/weights.flax_path``)."""
    from ..utils.weights import flax_path

    return {name: param_pspec(flax_path(name, p.ndim), p) for name, p in
            model.named_parameters()}


def torch_dim(spec: Tuple, ndim: int) -> Optional[int]:
    """The axis of the port's tensor that a flax spec shards over 'model':
    a 2-D kernel is stored transposed (``(out, in)``), so flax's axis ``a``
    is the port's ``1 - a``; None for a replicated leaf."""
    if MODEL_AXIS not in spec:
        return None
    axis = spec.index(MODEL_AXIS)
    return 1 - axis if ndim == 2 else axis


def param_shardings(mesh: Mesh, model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """The axis each parameter is sharded along over 'model' (None:
    replicated); every spec is replicated on a mesh of one model rank."""
    if mesh.model_size == 1:
        return {name: None for name, _ in model.named_parameters()}
    params = dict(model.named_parameters())
    return {name: torch_dim(spec, params[name].ndim)
            for name, spec in param_pspecs(model).items()}
