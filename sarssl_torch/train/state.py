"""Train state (port of ``sarssl_tpu/train/state.py``): the model (parameters
and BatchNorm running stats), an Adam optimizer and a step count.

``Adam`` is what ``make_adam(lr, b1, b2, weight_decay, grad_clip)`` builds in
the JAX package: ``optax.adam`` (eps 1e-8), or ``optax.adamw`` with
``weight_decay``, after ``optax.clip_by_global_norm(grad_clip)`` where one
is given, with the learning rate given at every update, as the JAX state
injects it at run time. It updates all parameters with multi-tensor
(``torch._foreach_*``) ops, a few launches per step on the card, and reads
nothing back to the host.

``Adam.state_dict()`` is optax's state in flax's names, as
``flax.serialization.to_state_dict(make_adam(...).init(params))`` lays it
out, so each package restores the other's optimizer state from a checkpoint.
Over a mesh (``parallel/steps.py``) the moments are the rank's shards: the
state's moments are gathered whole, a loaded state's sliced, through the
optimizer's ``layout``, and the clipping norm is the whole tree's
(``global_norm``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.weights import flax_tree, from_jax_params


class Adam:
    """``optax.adam``: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``,
    ``p -= lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)``. A missing
    gradient reads as 0.

    ``grad_clip``: first scale the gradients by ``grad_clip / g_norm`` where
    their global norm ``g_norm`` (f32, over every parameter's gradient, a
    missing one 0) reaches ``grad_clip`` (``optax.clip_by_global_norm``).
    ``weight_decay``: add ``weight_decay * p`` to Adam's step before the rate
    scales it (``optax.adamw``), for every parameter. 0 / None turn either
    off, as in the JAX ``make_adam``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.init_lr = self.lr = float(lr)
        self.b1, self.b2 = b1, b2
        self.weight_decay = float(weight_decay or 0.0)
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.layout = None  # a sharded model's parallel.steps.Layout
        self.global_norm = None  # the norm of the whole tree from a rank's shards
        self.reset()

    def reset(self) -> None:
        """Fresh moments, count 0 and the initial rate: ``tx.init(params)``."""
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.lr = self.init_lr

    @torch.no_grad()
    def update(self, lr: float) -> None:
        """One update from the gradients in ``.grad`` (a missing one is 0)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.grad_clip:
            grads = _clip_by_global_norm(grads, self.grad_clip, self.global_norm)
        self.count += 1
        self.lr = float(lr)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, _bias_correction(self.b1, self.count))
        torch._foreach_div_(step, denom)
        if self.weight_decay:
            torch._foreach_add_(step, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, step, alpha=-lr)

    # ------------------------------------------------------- optax layout

    def state_dict(self) -> Dict:
        """The optimizer state as optax's, in flax's names: numpy arrays,
        the moments with flax's parameter names and layouts."""
        count = np.asarray(self.count, np.int32)
        whole = (lambda d: d) if self.layout is None else self.layout.full_dict
        adam = {"count": count, "mu": flax_tree(whole(dict(zip(self.names, self.mu)))),
                "nu": flax_tree(whole(dict(zip(self.names, self.nu))))}
        return {"count": count, "hyperparams": {"learning_rate": np.asarray(self.lr, np.float32)},
                "hyperparams_states": {}, "inner_state": self._inner(adam)}

    def _inner(self, adam) -> Dict:
        """``inject_hyperparams(chain([clip_by_global_norm,] adam | adamw))``'s
        inner state around the ``scale_by_adam`` state ``adam``: adam is
        chain(scale_by_adam, scale_by_learning_rate), adamw chain(scale_by_adam,
        add_decayed_weights, scale_by_learning_rate); the others keep none."""
        chain = {"0": adam, "1": {}, "2": {}} if self.weight_decay else {"0": adam, "1": {}}
        return {"0": {}, "1": chain} if self.grad_clip else {"0": chain}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Restore from ``state_dict()``'s layout (a JAX checkpoint's
        ``opt_state`` included); the chain must be this optimizer's."""
        inner = sd["inner_state"]
        if _chain_shape(inner) != _chain_shape(self._inner({"mu": None})):
            raise ValueError(
                f"optimizer state holds another chain than make_adam(lr, weight_decay="
                f"{self.weight_decay}, grad_clip={self.grad_clip})'s (inner_state "
                f"{_chain_shape(inner)})")
        adam = inner["1"]["0"] if self.grad_clip else inner["0"]["0"]
        for moments, tree in ((self.mu, adam["mu"]), (self.nu, adam["nu"])):
            loaded, _ = from_jax_params({"params": tree})
            if set(loaded) != set(self.names):
                raise ValueError("optimizer moments name other parameters than the model's")
            for name, m in zip(self.names, moments):
                want = m.shape if self.layout is None else self.layout.full_shape(name, m.shape)
                if tuple(loaded[name].shape) != tuple(want):
                    raise ValueError(f"moment of {name}: shape {tuple(loaded[name].shape)}, "
                                     f"parameter {tuple(want)}")
                m.copy_(loaded[name] if self.layout is None
                        else self.layout.local(name, loaded[name]))
        self.count = int(adam["count"])
        self.lr = float(sd["hyperparams"]["learning_rate"])


class StackedAdam:
    """:class:`Adam`'s optax formulas over stacked ``(N, ...)`` parameters,
    one lane a grid cell (``train/grid.py``), with one learning rate a lane:
    ``p -= lr[l] * mu_hat / (sqrt(nu_hat) + eps)``. The lanes step in
    lockstep, so they share one count and its f32 bias corrections. A lane at
    lr 0 does not move (its moments do), which is how the grid freezes a
    finished cell. A missing gradient reads as 0."""

    b1, b2, eps = Adam.b1, Adam.b2, Adam.eps

    def __init__(self, params: Iterable[torch.Tensor]):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, lrs: torch.Tensor) -> None:
        """One update from the gradients in ``.grad``; ``lrs``: ``(N,)`` f32
        on the parameters' device."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, _bias_correction(self.b1, self.count))
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, [lrs.view(-1, *[1] * (p.ndim - 1)) for p in self.params])
        torch._foreach_sub_(self.params, step)

    def lane(self, names: Iterable[str], params: Iterable[torch.nn.Parameter],
             i: int) -> Adam:
        """Lane ``i``'s optimizer state as an :class:`Adam` over ``params``
        (named ``names``, in this optimizer's order)."""
        opt = Adam(zip(names, params))
        with torch.no_grad():
            for dst, src in ((opt.mu, self.mu), (opt.nu, self.nu)):
                torch._foreach_copy_(dst, [m[i] for m in src])
        opt.count = self.count
        return opt


def _chain_shape(tree):
    """The nesting of an optax chain's state, its Adam state as ``"adam"``."""
    if "mu" in tree:
        return "adam"
    return {k: _chain_shape(v) for k, v in tree.items()}


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         global_norm=None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: ``g / g_norm * max_norm`` where
    ``g_norm >= max_norm``, else ``g`` (decided on the device).
    ``global_norm(grads)``, where given, takes ``g_norm`` over a sharded
    tree's every rank."""
    g_norm = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
              if global_norm is None else global_norm(grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in f32, as optax computes it: in f64, 1 - 0.999
    would differ from optax's by 1.3e-5 of itself."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Adam
    step: int = 0

    def apply_gradients(self, lr: float) -> None:
        """One optimizer update at rate ``lr``; clears the gradients."""
        self.optimizer.update(lr)
        for p in self.optimizer.params:
            p.grad = None
        self.step += 1

    def reset_optimizer(self) -> None:
        """Fresh optimizer moments (the reference builds a new Adam every
        epoch under ``--parity``)."""
        self.optimizer.reset()


def make_adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0,
              grad_clip: Optional[float] = None) -> Callable[..., Adam]:
    """The JAX package's ``make_adam``: Adam(W) with the rate given at each
    update, after global-norm clipping where ``grad_clip`` is given. Returns
    ``tx(named_params) -> Adam``, which ``create_train_state`` takes."""
    return functools.partial(Adam, lr=lr, b1=b1, b2=b2, weight_decay=weight_decay,
                             grad_clip=grad_clip)


def create_train_state(model: torch.nn.Module, lr: float = 1e-3,
                       tx: Optional[Callable[..., Adam]] = None) -> TrainState:
    """The state ``create_train_state`` gives the JAX model: the optimizer
    ``tx`` (from :func:`make_adam`), ``make_adam(lr)`` by default."""
    tx = make_adam(lr) if tx is None else tx
    return TrainState(model=model, optimizer=tx(model.named_parameters()))
