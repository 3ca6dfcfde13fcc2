"""Gradient compression with error feedback, the port of
``repro.optim.compression``: an int8 quantisation with one scale a
tensor, and top-k sparsification by ``|g|``, each carrying the
residual it dropped into the next step so that the bias vanishes over
steps.

Grads and the residual state are lists of tensors in one order (the
port's optimizer layout). ``torch.round`` rounds half to even, as
``jnp.round`` does. The top-k threshold is the k-th largest ``|g|``;
only its value is used (every entry at or above it is kept), so
``torch.topk`` stands in for ``lax.top_k``.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, which rounds twice
    scale = torch.clamp(x.abs().max(), min=1e-12) / torch.tensor(
        127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_topk(g: torch.Tensor, residual: torch.Tensor,
                        ratio: float = 0.01):
    """Returns (compressed_dense, new_residual). Keeps top-k by |value|."""
    g = g.float() + residual
    flat = g.reshape(-1)
    k = max(int(ratio * flat.numel()), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(g.abs() >= thresh, g, 0.0)
    return kept, g - kept


@torch.no_grad()
def compressed_gradients(grads, state, scheme: str = "int8",
                         topk_ratio: float = 0.01):
    """Lists of grads and residuals -> (compressed grads, new residuals,
    wire_bytes_estimate)."""
    out, new_res, wire = [], [], 0
    for g, r in zip(grads, state):
        if scheme == "int8":
            gq = g.float() + r
            q, scale = quantize_int8(gq)
            deq = dequantize_int8(q, scale)
            out.append(deq)
            new_res.append(gq - deq)
            wire += q.numel() + 4
        elif scheme == "topk":
            kept, nr = error_feedback_topk(g, r, topk_ratio)
            out.append(kept)
            new_res.append(nr)
            wire += int(topk_ratio * g.numel()) * 8
        else:
            raise ValueError(scheme)
    return out, new_res, wire


def init_compression_state(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
