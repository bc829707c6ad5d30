"""Checkpoints (port of ``sarssl_tpu/train/checkpoint.py``): the
``latest_model`` / ``model{epoch}`` / ``best_model`` / ``ensemble_model``
files, and moving a pretrained trunk into a downstream model.

Files are flax msgpack of ``{"meta": {"epoch", "max_score", ...}, "params",
"batch_stats", "opt_state"}`` with flax's names and layouts
(``utils/weights.py``) and optax's optimizer state (``Adam.state_dict``),
written by the port's own codec (``train/msgpack.py``): each package reads
the other's files. Leaves stored in f16 (``scripts/export_ckpt_f16.py``) are
cast up to f32 on restore.

Like the JAX downstream run, which loads ``params`` only, ``partial_load``
copies parameters and never buffers: the downstream model keeps its own
freshly initialised BatchNorm running stats.

A model sharded over a mesh (``parallel/steps.py``, its ``shard_layout``)
saves whole arrays, gathered from every model rank, so the file is the
world-size-1 file of the same state; rank 0 alone writes it, and every rank
waits for the write. Reading takes whole arrays and slices each rank's
shard.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..utils.weights import from_jax_params, to_jax_params
from .msgpack import msgpack_restore, msgpack_serialize

SUFFIX = ".msgpack"


def latest_path(d: str) -> str:
    return os.path.join(d, "latest_model" + SUFFIX)


def best_path(d: str) -> str:
    return os.path.join(d, "best_model" + SUFFIX)


def epoch_path(d: str, epoch: int) -> str:
    return os.path.join(d, f"model{epoch}" + SUFFIX)


def ensemble_path(d: str) -> str:
    return os.path.join(d, "ensemble_model" + SUFFIX)


def _blob(state, meta: Dict[str, Any], save_opt: bool) -> Optional[bytes]:
    """The file's bytes, on the process that writes it (over a mesh every
    rank takes part in gathering the whole arrays; rank 0 serialises)."""
    payload = {"meta": meta, **to_jax_params(state.model)}
    if save_opt:
        payload["opt_state"] = state.optimizer.state_dict()
    return msgpack_serialize(payload) if is_writer(state) else None


def _write(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _layout(state_or_model):
    model = getattr(state_or_model, "model", state_or_model)
    return getattr(model, "shard_layout", None)


def is_writer(state_or_model) -> bool:
    """Whether this process writes files: always, but over a mesh rank 0."""
    layout = _layout(state_or_model)
    return layout is None or layout.is_writer


def _written(state) -> None:
    """Over a mesh, every rank waits here for rank 0's writes."""
    if _layout(state) is not None:
        torch.distributed.barrier()


def save_checkpoint(ckpt_dir: str, state, epoch: int, max_score: float,
                    is_best: bool = False, keep_epoch: bool = True,
                    save_opt: bool = True, extra: Optional[Dict[str, Any]] = None):
    """Write latest (+ epoch, + best) checkpoint files atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = _blob(state, {"epoch": int(epoch), "max_score": float(max_score), **(extra or {})},
                 save_opt)
    if is_writer(state):
        _write(latest_path(ckpt_dir), blob)
        if keep_epoch:
            _write(epoch_path(ckpt_dir, epoch), blob)
        if is_best:
            _write(best_path(ckpt_dir), blob)
    _written(state)


def save_named(ckpt_dir: str, state, name: str, epoch: int = -1,
               max_score: float = 0.0, save_opt: bool = False) -> str:
    """Write a single named checkpoint file (e.g. 'ensemble_model')."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name + SUFFIX)
    blob = _blob(state, {"epoch": int(epoch), "max_score": float(max_score)}, save_opt)
    if is_writer(state):
        _write(path, blob)
    _written(state)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


@torch.no_grad()
def load_full_state_dict(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state_dict, strict=True)`` from whole tensors:
    a sharded model takes each parameter's shard."""
    layout = _layout(model)
    if layout is not None:
        state_dict = {k: layout.local(k, v) for k, v in state_dict.items()}
    model.load_state_dict(state_dict, strict=True)


@torch.no_grad()
def restore_state(state, payload: Dict[str, Any], restore_opt: bool = True):
    """Restore a TrainState in place from a checkpoint payload (every leaf
    present, shapes equal) and return it."""
    params, buffers = from_jax_params({"params": payload["params"],
                                       "batch_stats": payload["batch_stats"]})
    load_full_state_dict(state.model, {**params, **buffers})
    if restore_opt and "opt_state" in payload:
        state.optimizer.load_state_dict(payload["opt_state"])
    return state


@torch.no_grad()
def partial_load(model: torch.nn.Module, source_state_dict: Dict[str, torch.Tensor],
                 ex_prefix: str = "") -> List[str]:
    """Copy ``source_state_dict[name]`` into each parameter of ``model`` of
    the same name and shape; return the names loaded.

    ``ex_prefix`` is stripped from the source names that start with it.
    Source entries that name no parameter (buffers such as BatchNorm running
    stats, or a decoder the model lacks) are skipped. The source is whole: a
    sharded model takes each parameter's shard."""
    src = {(k[len(ex_prefix):] if ex_prefix and k.startswith(ex_prefix) else k): v
           for k, v in source_state_dict.items()}
    layout = _layout(model)
    loaded = []
    for name, p in model.named_parameters():
        v = src.get(name)
        shape = p.shape if layout is None else layout.full_shape(name, p.shape)
        if v is not None and tuple(v.shape) == tuple(shape):
            p.copy_(v if layout is None else layout.local(name, v))
            loaded.append(name)
    return loaded


def trainable_mask_from_loaded(model: torch.nn.Module,
                               loaded: Sequence[str]) -> Dict[str, bool]:
    """``{name: trainable}`` over ``model``'s parameters: False for the
    loaded ones (lineareval freezing), True for the rest."""
    done = set(loaded)
    return {name: name not in done for name, _ in model.named_parameters()}


def ensemble_params(param_list: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Uniform parameter average over ``{name: tensor}`` dicts, summed in
    f64 and cast back to each tensor's dtype."""
    n = len(param_list)
    return {k: (sum(p[k].double() for p in param_list) / n).to(v.dtype)
            for k, v in param_list[0].items()}


def remove_checkpoint_epochs(ckpt_dir: str, epochs: Sequence[int]) -> None:
    for e in epochs:
        p = epoch_path(ckpt_dir, e)
        if os.path.exists(p):
            os.remove(p)
