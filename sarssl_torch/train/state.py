"""Train state (port of ``sarssl_tpu/train/state.py``): the model (parameters
and BatchNorm running stats), an Adam optimizer and a step count.

``Adam`` is ``make_adam(lr)``, the only optimizer the JAX package builds:
``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8) with the learning rate given at
every update, as the JAX state injects it at run time. It updates all
parameters with multi-tensor (``torch._foreach_*``) ops, a few launches per
step on the card, and reads nothing back to the host.

``Adam.state_dict()`` is optax's state in flax's names, as
``flax.serialization.to_state_dict(make_adam(lr).init(params))`` lays it
out, so each package restores the other's optimizer state from a checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..utils.weights import flax_tree, from_jax_params


class Adam:
    """``optax.adam``: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``,
    ``p -= lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)``. A missing
    gradient reads as 0."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], lr: float = 1e-3):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.init_lr = self.lr = float(lr)
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
        torch._foreach_add_(self.params, step, alpha=-lr)

    # ------------------------------------------------------- optax layout

    def state_dict(self) -> Dict:
        """The optimizer state as optax's, in flax's names: numpy arrays,
        the moments with flax's parameter names and layouts."""
        count = np.asarray(self.count, np.int32)
        adam = {"count": count, "mu": flax_tree(dict(zip(self.names, self.mu))),
                "nu": flax_tree(dict(zip(self.names, self.nu)))}
        # inject_hyperparams(chain(adam)), adam = chain(scale_by_adam, scale_by_learning_rate)
        return {"count": count, "hyperparams": {"learning_rate": np.asarray(self.lr, np.float32)},
                "hyperparams_states": {}, "inner_state": {"0": {"0": adam, "1": {}}}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Restore from ``state_dict()``'s layout (a JAX checkpoint's
        ``opt_state`` included); the chain must be ``make_adam(lr)``'s."""
        inner = sd["inner_state"]
        if list(inner) != ["0"] or sorted(inner["0"]) != ["0", "1"]:
            raise ValueError("optimizer state holds another chain than make_adam(lr)'s "
                             f"(inner_state {({k: sorted(v) for k, v in inner.items()})})")
        adam = inner["0"]["0"]
        for moments, tree in ((self.mu, adam["mu"]), (self.nu, adam["nu"])):
            loaded, _ = from_jax_params({"params": tree})
            if set(loaded) != set(self.names):
                raise ValueError("optimizer moments name other parameters than the model's")
            for name, m in zip(self.names, moments):
                if tuple(loaded[name].shape) != tuple(m.shape):
                    raise ValueError(f"moment of {name}: shape {tuple(loaded[name].shape)}, "
                                     f"parameter {tuple(m.shape)}")
                m.copy_(loaded[name])
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


def create_train_state(model: torch.nn.Module, lr: float = 1e-3) -> TrainState:
    """The state ``create_train_state`` gives the JAX model: ``make_adam(lr)``."""
    return TrainState(model=model, optimizer=Adam(model.named_parameters(), lr))
