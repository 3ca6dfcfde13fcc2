"""Adafactor (Shazeer & Stern, 2018) with factored second moments, the
port of ``repro.optim.adafactor``, term by term: ``beta2 = 1 - t**(-decay)``,
row and column means of ``g**2 + eps`` for a leaf whose last two dims
are both at least ``min_dim_factored`` (its state ``{"vr", "vc"}``, else
``{"v"}``), the RMS update clip, and the decay inside the lr term,
``u = -lr * (u + wd * p)``.

Params, grads and updates are lists of tensors in one order, as in the
port's AdamW; the state is ``{"v": [per-leaf dict, ...]}`` aligned with
them. The step's scalars (``t**(-decay)``, the lr) are taken on the host
in float32, the power in float64 rounded once, which gives XLA's float32
result at ``decay=0.8``; divisors are device tensors (CUDA divides by a
host scalar through its reciprocal, which rounds twice).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.optim.base import Optimizer


def _beta2(step: int, decay: float) -> float:
    t = np.float32(step) + np.float32(1.0)
    p = np.float32(np.float64(t) ** np.float64(np.float32(-decay)))
    return float(np.float32(1.0) - p)


def adafactor(lr: float | Callable, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0, min_dim_factored: int = 128
              ) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def state_for(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"v": [state_for(p) for p in params]}

    @torch.no_grad()
    def update(grads, state, params, step):
        beta2 = _beta2(step, decay)
        one_minus = float(np.float32(1.0) - np.float32(beta2))
        lr_t = float(np.float32(lr_fn(step)))
        clip = torch.tensor(clip_threshold, device=params[0].device)
        updates, new_v = [], []
        for g, s, p in zip(grads, state["v"], params):
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device) \
                if g is None else g.float()
            g2 = g.square() + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + one_minus * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + one_minus * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., None]
                u = g * torch.rsqrt(r * vc[..., None, :] + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + one_minus * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            rms = torch.sqrt(u.square().mean() + 1e-30)
            u = u / torch.clamp(rms / clip, min=1.0)
            updates.append(-lr_t * (u + weight_decay * p.float()))
            new_v.append(ns)
        return updates, {"v": new_v}

    return Optimizer(init, update)
