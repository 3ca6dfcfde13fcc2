"""Attention: GQA/MQA/MHA with causal + sliding-window masking, as
``repro/models/attention.py`` computes it.

Three implementations share one interface:

- ``naive``     : materialises the (Sq, Skv) score matrix. Reference.
- ``xla_flash`` : block-pair streaming attention (online softmax over the
  visible (q-block, kv-block) pairs, masked pairs pruned ahead of time),
  in plain PyTorch, differentiable (the LM trains through it, as the
  JAX package's ``lm_loss`` does). Falls back to naive when both
  sequences fit in one chunk, as the JAX dispatcher does.
- ``pallas``    : the flash-attention op (``kernels/flash_attention``):
  the hand-written CUDA kernel for CUDA tensors, its plain version for
  CPU tensors.

Shapes: q (B, Sq, H, Dh); k, v (B, Skv, Hk, Dh); H % Hk == 0. Query head
h reads KV head h // (H // Hk). Rounding follows the JAX package: the QK
product is taken in float32 (``preferred_element_type=f32``), and the
softmax weights are cast to v's dtype before the PV product, which is
accumulated in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hk, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """Additive bias (Sq, Skv) with NEG_INF at masked positions."""
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        ok &= (qpos[:, None] - kpos[None, :]) < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _pv(p: torch.Tensor, v: torch.Tensor, spec: str) -> torch.Tensor:
    """The PV product of ``p`` rounded to v's dtype, accumulated in
    float32 (the rounded operands are exact in float32)."""
    return torch.einsum(spec, p.to(v.dtype).float(), v.float())


# ---------------------------------------------------------------------------
# Naive reference
# ---------------------------------------------------------------------------


def attention_naive(q, k, v, *, causal=True, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    qg = _group(q, hk)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    s = s + _mask_bias(qpos, kpos, causal, window)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v, "bhgqk,bkhd->bqhgd")
    return o.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Block-pair streaming attention ("xla flash")
# ---------------------------------------------------------------------------


def _visible_pairs(n_q: int, n_k: int, cq: int, ck: int, causal: bool,
                   window: int | None, q_offset: int) -> np.ndarray:
    """Enumerate the (i, j) block pairs with any unmasked entry."""
    pairs = []
    for i in range(n_q):
        q_lo, q_hi = q_offset + i * cq, q_offset + i * cq + cq - 1
        for j in range(n_k):
            k_lo, k_hi = j * ck, j * ck + ck - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            pairs.append((i, j))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def attention_xla_flash(q, k, v, *, causal=True, window=None,
                        q_chunk=512, kv_chunk=1024, q_offset: int = 0):
    """Online softmax over the visible block pairs, in the JAX package's
    order: a pair's masked entries are -1e30 (a row that has seen only
    masked keys accumulates weight 1 each until a visible key's
    ``exp(-1e30 - m)`` wipes it, as in the reference)."""
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    g = h // hk
    cq, ck = min(q_chunk, sq), min(kv_chunk, skv)
    pq, pk = (-sq) % cq, (-skv) % ck      # padded keys are masked below
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    n_q, n_k = (sq + pq) // cq, (skv + pk) // ck
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    # (n, B, H, C, D)
    qb = q.reshape(b, n_q, cq, h, d).permute(1, 0, 3, 2, 4)
    kb = k.reshape(b, n_k, ck, h, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, n_k, ck, h, d).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    # each query block's running (o, m, l), rebound on every visible pair
    # and stacked once at the end: no in-place write, so autograd can
    # differentiate through the loop
    acc_o = [torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)] * n_q
    acc_m = [torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                        device=dev)] * n_q
    acc_l = [torch.zeros((b, h, cq), dtype=torch.float32, device=dev)] * n_q
    for i, j in _visible_pairs(n_q, n_k, cq, ck, causal, window,
                               q_offset).tolist():
        s = torch.einsum("bhqd,bhkd->bhqk", qb[i].float(),
                         kb[j].float()) * scale
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        kpos = j * ck + torch.arange(ck, device=dev)
        ok = (kpos < skv)[None, :].expand(cq, ck)
        if causal:
            ok = ok & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            ok = ok & ((qpos[:, None] - kpos[None, :]) < window)
        s = torch.where(ok, s, NEG_INF)
        m_i = acc_m[i]
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        acc_l[i] = acc_l[i] * alpha + p.sum(dim=-1)
        acc_o[i] = acc_o[i] * alpha[..., None] + _pv(p, vb[j],
                                                     "bhqk,bhkd->bhqd")
        acc_m[i] = m_new
    acc_o, acc_l = torch.stack(acc_o), torch.stack(acc_l)
    out = acc_o / torch.clamp(acc_l[..., None], min=1e-30)
    out = out.permute(1, 0, 3, 2, 4).reshape(b, n_q * cq, h, d)
    return out[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def attention(q, k, v, *, causal=True, window=None, impl="xla_flash",
              q_chunk=512, kv_chunk=1024, q_offset: int = 0) -> torch.Tensor:
    if impl == "naive" or (impl == "xla_flash" and q.shape[1] <= q_chunk
                           and k.shape[1] <= kv_chunk):
        return attention_naive(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "xla_flash":
        return attention_xla_flash(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   q_offset=q_offset)
    if impl == "pallas":
        if q_offset:
            # the JAX dispatcher drops q_offset here (its kernel numbers
            # queries from 0); refuse rather than answer for offset 0
            raise ValueError("impl='pallas' numbers queries from 0; "
                             f"q_offset={q_offset} is not supported")
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Static-shape KV cache: (B, S_max, Hk, Dh) per layer, stacked on L."""

    k: torch.Tensor      # (L, B, S, Hk, D)
    v: torch.Tensor      # (L, B, S, Hk, D)

    @classmethod
    def zeros(cls, n_layers, batch, max_len, n_kv, d_head,
              dtype=torch.bfloat16, device=None):
        shape = (n_layers, batch, max_len, n_kv, d_head)
        dev = device_lib.resolve(device)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))

    @classmethod
    def abstract(cls, n_layers, batch, max_len, n_kv, d_head,
                 dtype=torch.bfloat16):
        """The cache's shape and dtype on ``meta`` (nothing allocated)."""
        return cls.zeros(n_layers, batch, max_len, n_kv, d_head, dtype,
                         "meta")


def cache_update(cache_k, cache_v, new_k, new_v, pos: int):
    """Write one decode step at position ``pos`` (an int; clamped into
    the cache as ``dynamic_update_slice`` clamps it). new_*: (B, 1, Hk, D).

    Unlike the JAX package's functional update, this writes into
    ``cache_k``/``cache_v`` in place (a decode step would otherwise copy
    the whole cache) and returns them."""
    start = min(max(int(pos), 0), cache_k.shape[1] - new_k.shape[1])
    cache_k[:, start:start + new_k.shape[1]] = new_k.to(cache_k.dtype)
    cache_v[:, start:start + new_v.shape[1]] = new_v.to(cache_v.dtype)
    return cache_k, cache_v


def decode_attention(q, cache_k, cache_v, pos: int,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode attention against a cache.

    q: (B, 1, H, D); cache: (B, S, Hk, D); pos: index of the current token
    (already written to the cache). With a sliding window shorter than
    the cache, only a window-sized slice is read."""
    b, _, h, d = q.shape
    s_max = cache_k.shape[1]
    pos = int(pos)
    if window is not None and window < s_max:
        w = window
        start = min(max(pos - (w - 1), 0), s_max - w)
        k_slc = cache_k[:, start:start + w]
        v_slc = cache_v[:, start:start + w]
        kpos = start + torch.arange(w, device=q.device)
    else:
        k_slc, v_slc = cache_k, cache_v
        kpos = torch.arange(s_max, device=q.device)
    hk = k_slc.shape[2]
    qg = _group(q, hk)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_slc.float()) * scale
    ok = kpos <= pos
    if window is not None:
        ok &= kpos > pos - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v_slc, "bhgqk,bkhd->bqhgd")
    return o.reshape(b, 1, h, d).to(q.dtype)
