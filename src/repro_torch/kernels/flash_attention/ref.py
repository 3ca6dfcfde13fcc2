"""Plain PyTorch version of the flash-attention kernel (GQA + causal +
sliding window), on any device: the float32 score matrix, a -1e30 mask
and one softmax, as ``repro/kernels/flash_attention/ref.py`` computes
it. Query head ``h`` reads KV head ``h // (H // Hk)``; positions start
at 0 for queries and keys alike."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B, Sq, H, D); k, v (B, Skv, Hk, D) -> q's shape and dtype."""
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    qg = q.reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
