"""AdamW with float32 moments (params may be bf16), the port of
``repro.optim.adamw``, term by term. It differs from
``torch.optim.AdamW``: b2 defaults to 0.95, the moments are float32 for
any param dtype, and the decay sits inside the lr term,
``u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. Every parameter is
updated, a ``None`` grad taken as zero (it still decays)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.base import Optimizer


def _bias_correction(b: float, t: np.float32) -> float:
    """``1 - b ** t`` in float32, as the JAX package computes it with a
    float32 ``t``. The power is taken in float64 and rounded once, which
    gives XLA's float32 result (``tests/test_torch_optim.py`` holds it
    over the first 5,000 steps for b = 0.9 and 0.95) where torch's and
    numpy's float32 ``pow`` differ from it in the last bit at some
    steps; taken on the host, it is the same on every device."""
    p = np.float32(np.float64(np.float32(b)) ** np.float64(t))
    return float(np.float32(1.0) - p)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": [zeros(p) for p in params],
                "v": [zeros(p) for p in params]}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = np.float32(step) + np.float32(1.0)
        # divisors as device tensors: CUDA divides by a host scalar
        # through its reciprocal, which rounds twice
        bc1, bc2 = torch.tensor(
            [_bias_correction(b1, t), _bias_correction(b2, t)],
            device=params[0].device)
        updates, ms, vs = [], [], []
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            g = torch.zeros_like(m) if g is None else g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g.square()
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.float())
            updates.append(u)
            ms.append(m)
            vs.append(v)
        return updates, {"m": ms, "v": vs}

    return Optimizer(init, update)
