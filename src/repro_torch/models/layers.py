"""Shared neural layers of the port (the subset of ``repro.models.layers``
the CLS-III encoder and the dense LM use): layer and RMS norms computed
in float32, rotary embeddings, tanh-GELU, SwiGLU, the logit soft cap and
the embedding lookup; plus the dtype-name map and the numpy-to-tensor
copy that carry the JAX package's params across."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ...) -> the torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def from_numpy(a) -> torch.Tensor:
    """A writable tensor copy of a numpy leaf, bfloat16 (``ml_dtypes``,
    which numpy has no native type for) included, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalise the last axis in float32 and scale by ``1 + scale``
    (the LM's scales start at zero), return in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Normalise over the last axis in float32, return in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def rope_frequencies(d_head: int, theta: float,
                     device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to
    (..., seq). Rotates the two halves of the head (not interleaved
    pairs), with angles in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (half,)
    angles = positions[..., :, None].float() * freqs              # (..., S, half)
    angles = angles[..., :, None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                 mode: str = "fill") -> torch.Tensor:
    """``table[ids]`` along the first axis with JAX's gather semantics
    instead of an indexing error: negative ids count from the end, and
    ids outside [-R, R) give a NaN row (the dtype's minimum for integer
    tables) under ``mode="fill"`` (``jnp.take``), or the nearest row
    under ``mode="clip"`` (``x[ids]`` on a JAX array). One
    ``index_select``; for ``fill``, one host synchronisation asks whether
    any id is out of range, and only then is the mask written in place,
    so there is never a second buffer of the result's size nor, in the
    common case, a second pass over it.

    The gather is ``F.embedding`` (an ``index_select`` forward) for its
    backward: ``index_select``'s accumulates the table's gradient with
    ``index_add_``, whose atomics on CUDA sum repeated ids in a varying
    order, so two trainings would differ in the last bits; the
    embedding backward sums them in a fixed order."""
    if mode not in ("fill", "clip"):
        raise ValueError(f"embed_lookup: mode must be fill or clip "
                         f"(got {mode!r})")
    r = table.shape[0]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + r, flat)
    rows = F.embedding(flat.clamp(0, max(r - 1, 0)), table.reshape(r, -1))
    rows = rows.view((-1,) + tuple(table.shape[1:]))
    if mode == "fill":
        oob = (flat < 0) | (flat >= r)
        if bool(oob.any()):
            fill = (float("nan") if table.is_floating_point()
                    else torch.iinfo(table.dtype).min)
            rows.masked_fill_(oob.view((-1,) + (1,) * (table.dim() - 1)),
                              fill)
    return rows.view(tuple(ids.shape) + tuple(table.shape[1:]))
