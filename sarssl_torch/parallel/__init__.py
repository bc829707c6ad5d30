"""Multi-device training over ``torch.distributed`` (port of
``sarssl_tpu/parallel/``): the mesh and the tensor-parallel rules
(``mesh.py``), the collectives as autograd functions (``tp.py``), the
sharded steps (``steps.py``) and each rank's share of the data
(``hostdata.py``). ``steps`` and ``hostdata`` load on first use: the model
modules import ``tp`` from here, and the steps import the models."""
from .mesh import (Mesh, Rows, batch_sharding, init_distributed, make_mesh, param_pspec,
                   param_shardings, parse_mesh)

_LAZY = {
    "Layout": "steps", "shard_state": "steps", "state_shardings": "steps",
    "make_sharded_pretrain_step": "steps", "make_sharded_downstream_step": "steps",
    "make_sharded_pretrain_eval_step": "steps", "make_sharded_downstream_eval_step": "steps",
    "shard_for_process": "hostdata", "global_batch_from_local": "hostdata",
    "host_batch_iterator": "hostdata", "packed_batches": "hostdata",
}

__all__ = ["Mesh", "Rows", "make_mesh", "init_distributed", "parse_mesh",
           "batch_sharding", "param_pspec", "param_shardings", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
