"""Train state (port of ``sarssl_tpu/train/state.py``): the model (parameters
and BatchNorm running stats), an Adam optimizer and a step count.

``Adam`` follows ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8) term for term,
with the learning rate given at every update, as the JAX state injects it at
run time. It updates all parameters with multi-tensor (``torch._foreach_*``)
ops, a few launches per step on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


class Adam:
    """``optax.adam``: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``,
    ``p -= lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, lr: float) -> None:
        """One update from the gradients in ``.grad`` (a missing one is 0)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, 1 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, 1 - self.b1 ** self.count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(self.params, step, alpha=-lr)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Adam
    step: int = 0

    def apply_gradients(self, lr: float) -> None:
        """One Adam update at rate ``lr``; clears the gradients."""
        self.optimizer.update(lr)
        for p in self.optimizer.params:
            p.grad = None
        self.step += 1


def create_train_state(model: torch.nn.Module) -> TrainState:
    return TrainState(model=model, optimizer=Adam(model.parameters()))
