"""Shared neural layers of the port (the subset of ``repro.models.layers``
the CLS-III encoder uses): layer norm computed in float32, tanh-GELU,
and the embedding lookup."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Normalise over the last axis in float32, return in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s semantics instead of an indexing
    error: negative ids count from the end, and ids outside [-V, V) give
    a NaN row. Checked on the device, so no host synchronisation."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    oob = (ids < 0) | (ids >= v)
    rows = table[ids.clamp(0, v - 1)]
    return torch.where(oob[..., None],
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device), rows)
