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
from repro_torch.distributed.meshrules import (einsum, from_local,
                                               is_dtensor, local_op,
                                               replicated, shard_hint,
                                               whole_dims)
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hk, G, D). A DTensor whose heads are cut
    over more shards than Hk divides into gathers its heads first."""
    b, s, h, d = q.shape
    if is_dtensor(q) and any(
            getattr(p, "dim", None) == 2 and n_kv % q.device_mesh.size(i)
            for i, p in enumerate(q.placements)):
        q = whole_dims(q, (2,))
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
    return einsum(spec, p.to(v.dtype).float(), v.float())


# ---------------------------------------------------------------------------
# Naive reference
# ---------------------------------------------------------------------------


def attention_naive(q, k, v, *, causal=True, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    qg = _group(q, hk)
    scale = 1.0 / math.sqrt(d)
    s = einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
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

    def pad(t, n):
        return local_op(lambda u: torch.nn.functional.pad(
            u, (0, 0, 0, 0, 0, n)), t, (1,),
            (t.shape[0], t.shape[1] + n) + tuple(t.shape[2:]))

    q, k, v = pad(q, pq), pad(k, pk), pad(v, pk)
    n_q, n_k = (sq + pq) // cq, (skv + pk) // ck
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    # (n, B, H, C, D): on a mesh the batch and head dims are sharded and
    # the block and in-block dims whole, so a pair's blocks are local
    blk = (None, "batch", "heads", None, None)
    qb = shard_hint(q.reshape(b, n_q, cq, h, d).permute(1, 0, 3, 2, 4), *blk)
    kb = shard_hint(k.reshape(b, n_k, ck, h, d).permute(1, 0, 3, 2, 4), *blk)
    vb = shard_hint(v.reshape(b, n_k, ck, h, d).permute(1, 0, 3, 2, 4), *blk)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    # each query block's running (o, m, l), rebound on every visible pair
    # and stacked once at the end: no in-place write, so autograd can
    # differentiate through the loop
    acc_o = [shard_hint(replicated(torch.zeros(
        (b, h, cq, d), dtype=torch.float32, device=dev)), *blk[1:])] * n_q
    acc_m = [shard_hint(replicated(torch.full(
        (b, h, cq), NEG_INF, dtype=torch.float32, device=dev)),
        *blk[1:4])] * n_q
    acc_l = [shard_hint(replicated(torch.zeros(
        (b, h, cq), dtype=torch.float32, device=dev)), *blk[1:4])] * n_q
    sharded = qb if is_dtensor(qb) else None
    if sharded is not None:
        # each rank runs the pair loop on its own batch and head shard
        qb, kb, vb, acc_o, acc_m, acc_l = (
            t.to_local() if is_dtensor(t) else t
            for t in (qb, kb, vb, acc_o[0], acc_m[0], acc_l[0]))
        acc_o, acc_m, acc_l = [acc_o] * n_q, [acc_m] * n_q, [acc_l] * n_q
    for i, j in _visible_pairs(n_q, n_k, cq, ck, causal, window,
                               q_offset).tolist():
        s = einsum("bhqd,bhkd->bhqk", qb[i].float(),
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
    out = out.permute(1, 0, 3, 2, 4)
    out = out.reshape(out.shape[0], n_q * cq, out.shape[3], d)[:, :sq]
    out = out.to(q.dtype)
    if sharded is None:
        return out
    # the blocks' (n, B, H, C, D) placements on the output's (B, S, H, D)
    from torch.distributed.tensor import Shard
    place = [Shard({1: 0, 2: 2}[p.dim]) if isinstance(p, Shard) else p
             for p in sharded.placements]
    return from_local(out, sharded.device_mesh, place, (b, sq, h, d))


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
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        if is_dtensor(cache):
            _write_rows_local(cache, new.to(cache.dtype), start)
        else:
            cache[:, start:start + new.shape[1]] = new.to(cache.dtype)
    return cache_k, cache_v


def _write_rows_local(cache, new, start: int) -> None:
    """``cache[:, start:start + T] = new`` on a DTensor cache, in place on
    each rank's shard: ``new`` is laid out as the cache is but whole along
    the sequence dim, and each rank writes the rows its shard holds (the
    cache's own layout is kept; no rank writes another's rows)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in cache.placements]
    if not is_dtensor(new):
        new = replicated(new)
    if is_dtensor(new):
        new = new.redistribute(cache.device_mesh, want).to_local()
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    lo, hi = max(start, offset[1]), min(start + new.shape[1],
                                         offset[1] + shape[1])
    if lo < hi:
        local[:, lo - offset[1]:hi - offset[1]] = new[:, lo - start:hi - start]


def decode_attention(q, cache_k, cache_v, pos: int,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode attention against a cache.

    q: (B, 1, H, D); cache: (B, S, Hk, D); pos: index of the current token
    (already written to the cache). With a sliding window shorter than
    the cache, only a window-sized slice is read."""
    b, _, h, d = q.shape
    s_max = cache_k.shape[1]
    pos = int(pos)
    # on a mesh the one query's heads are gathered (a few bytes), so the
    # products' merged batch dims are cut over one mesh dim at most
    q = whole_dims(q, (2,))
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
    s = einsum("bqhgd,bkhd->bhgqk", qg.float(), k_slc.float()) * scale
    ok = kpos <= pos
    if window is not None:
        ok &= kpos > pos - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v_slc, "bhgqk,bkhd->bqhgd")
    return o.reshape(b, 1, h, d).to(q.dtype)
