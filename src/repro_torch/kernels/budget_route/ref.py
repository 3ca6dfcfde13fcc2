"""Plain PyTorch version of the budget_route kernel: stable
select-and-compact.

Selection rule (shared with the CUDA kernel and scheduler.plan_batch):
rows with score > tau are always kept (at most capacity-1 exist when tau
is the capacity-th largest score); ties at tau fill the remaining slots
in row order. A strictly better row is therefore never displaced by a
tie. Scores and tau are compared with subnormals flushed to zero, as
XLA's compare does. Unused output rows are zero and unused ``idx`` slots
-1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.order import flush_subnormal


def budget_route_ref(scores, tokens, tau, *, capacity: int):
    """scores (N,) f32, tokens (N, D), tau scalar -> (routed (capacity,
    D), idx (capacity,) int32, count () int32)."""
    n, d = tokens.shape
    s, t = flush_subnormal(scores), flush_subnormal(tau)
    gt = s > t
    eq = s == t
    eq_i = eq.int()
    tie_cap = capacity - gt.sum()
    tie_rank = torch.cumsum(eq_i, 0) - eq_i
    mask = gt | (eq & (tie_rank < tie_cap))
    m_i = mask.int()
    pos = torch.cumsum(m_i, 0) - m_i
    keep = mask & (pos < capacity)
    rows = torch.nonzero(keep).flatten()
    out = torch.zeros((capacity, d), dtype=tokens.dtype,
                      device=tokens.device)
    idx = torch.full((capacity,), -1, dtype=torch.int32,
                     device=tokens.device)
    out[pos[rows]] = tokens[rows]
    idx[pos[rows]] = rows.int()
    count = torch.clamp(mask.sum(), max=capacity).int()
    return out, idx, count
