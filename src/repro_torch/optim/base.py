"""Minimal optimizer core, the port of ``repro.optim.base``: an Optimizer
is (init(params) -> state, update(grads, state, params, step) ->
(updates, state)).

Params, grads and updates are lists of tensors in one order. A grad of
``None`` (a parameter the loss does not reach, which ``torch.autograd``
reports as ``None``) stands for the zero grad ``jax.grad`` gives: the
parameter still counts in the global norm (with zero) and still
decays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable                  # (grads, state, params, step) -> ...


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u.astype(p.dtype)`` in place: the update is rounded to the
    param's dtype before the add, as the JAX package does (for bf16
    params a float32 ``add_`` would round once and give other bits)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params


def global_norm(tree) -> torch.Tensor:
    """float32 root of the sum of squares over every leaf (``None`` adds
    nothing, as a zero leaf does)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree
                          if x is not None))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every grad by ``min(1, max_norm / max(norm, 1e-9))`` in
    float32, then cast back to its dtype. Returns (grads, norm)."""
    norm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return [None if g is None else (g.float() * scale).to(g.dtype)
            for g in grads], norm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params, step)

    return Optimizer(opt.init, update)
