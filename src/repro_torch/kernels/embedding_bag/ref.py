"""Plain PyTorch version of the embedding_bag kernel, on any device:
``jnp.take`` + weighted sum, as ``repro/kernels/embedding_bag/ref.py``
computes it.

Ids follow ``jnp.take``: ``-R <= id < 0`` counts from the end, and an
id ``>= R`` or ``< -R`` gives a NaN row (so its bag is NaN). Products
and sums are taken in float32; ``mean`` divides by ``max(sum(w),
1e-9)``; the result is cast to the table's dtype.

``embedding_bag_backward_ref`` is the plain version of the backward
kernel: the table gradient of bags of one (``jnp.take``'s transpose,
XLA's scatter-add), accumulated in the table's dtype in ascending
position order.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import embed_lookup


def embedding_bag_ref(table, ids, weights, *, combiner: str = "sum"):
    """table (R, D); ids (B, L) int; weights (B, L) -> (B, D) in the
    table's dtype."""
    w = weights.float()
    out = (embed_lookup(table, ids).float() * w[..., None]).sum(1)
    if combiner == "mean":
        out = out / w.sum(1).clamp_min(1e-9)[:, None]
    return out.to(table.dtype)


def sorted_rows(ids, rows: int):
    """The backward's plumbing, shared by the kernel's wrapper: ids (N,)
    -> (keys, perm), the ids wrapped into [0, R) as ``jnp.take`` wraps
    them (an id outside [-R, R) becomes R, which sorts last and adds
    nothing) and stably sorted, with the position each key came from.
    Within a row's run the positions ascend."""
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + rows, flat)
    flat = torch.where((flat < 0) | (flat >= rows),
                       torch.full_like(flat, rows), flat)
    return torch.sort(flat, stable=True)


def embedding_bag_backward_ref(grad, ids, rows: int):
    """grad (N, D); ids (N,) int -> the dense (R, D) table gradient in
    grad's dtype: row r is ``((0 + g[p0]) + g[p1]) + ...`` over the
    positions p0 < p1 < ... whose id is r (wrapped), each add rounded to
    the dtype, as XLA's scatter-add does on the CPU. Ids outside [-R, R)
    add nothing. Done level by level: the k-th occurrence of every row
    in one vectorised add, for k up to the largest count."""
    out = torch.zeros((rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    keys, perm = sorted_rows(ids, rows)
    valid = keys < rows
    keys, perm = keys[valid], perm[valid]
    if keys.numel() == 0:
        return out
    idx = torch.arange(keys.numel(), device=keys.device)
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    level = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    by_level = torch.sort(level, stable=True)
    counts = torch.bincount(by_level.values).tolist()
    lo = 0
    for c in counts:
        sel = by_level.indices[lo:lo + c]
        lo += c
        r = keys[sel]
        out[r] = out[r] + grad[perm[sel]]
    return out
