"""Plain PyTorch version of the embedding_bag kernel, on any device:
``jnp.take`` + weighted sum, as ``repro/kernels/embedding_bag/ref.py``
computes it.

Ids follow ``jnp.take``: ``-R <= id < 0`` counts from the end, and an
id ``>= R`` or ``< -R`` gives a NaN row (so its bag is NaN). Products
and sums are taken in float32; ``mean`` divides by ``max(sum(w),
1e-9)``; the result is cast to the table's dtype.
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
