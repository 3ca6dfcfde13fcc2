"""Embedding tables + EmbeddingBag, the port of
``repro/models/recsys/embedding.py``.

All field tables are concatenated into ONE table, so a batch lookup is a
single gather. ``take_rows`` (``lookup_fields``' and DIEN's gathers)
runs it through the hand-written ``embedding_bag`` kernel on the card
(bags of one, weight 1, ``sum``: one launch per forward, bit-equal to
the plain gather), and its table gradient through the hand-written
``embedding_bag_backward`` kernel (one launch per backward, XLA's
scatter-add order bit for bit).
``embedding_bag``, ``embedding_bag_ragged`` and ``retrieval_topk`` are
plain mirrors of the JAX functions, whose semantics differ from the
kernel's (products in the table's dtype, ``max(denom, 1.0)``, a ``max``
combiner, ``lax.top_k``'s order).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.distributed.meshrules import (einsum, is_dtensor,
                                               like_local, shard_hint,
                                               whole_dims)
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.order import total_order_key
from repro_torch.models.gnn.segment import scatter_sum_plain
from repro_torch.models.layers import embed_lookup


def table_offsets(vocab_sizes, pad_to: int = 1) -> tuple[np.ndarray, int]:
    """Per-field row offsets into the concatenated table (+ padded total)."""
    offs = np.zeros(len(vocab_sizes), np.int64)
    np.cumsum(np.asarray(vocab_sizes[:-1], np.int64), out=offs[1:])
    total = int(np.sum(vocab_sizes))
    return offs, -(-total // pad_to) * pad_to


@torch.no_grad()
def init_table(vocab_sizes, dim: int, dtype: torch.dtype,
               generator: torch.Generator, device=None, pad_to: int = 512):
    """The concatenated (rows padded to ``pad_to``, dim) table drawn from
    normal(0, dim^-0.5) in place, in ``dtype``, on the generator's device
    (a 48 GB bf16 table leaves no room for a float32 draw beside it), and
    the int64 field offsets on the same device."""
    dev = device_lib.resolve(device)
    if dev.type != "meta" and torch.device(generator.device).type != dev.type:
        raise ValueError(f"init_table: generator on {generator.device}, "
                         f"table on {dev}; draw on the table's device")
    offs, total = table_offsets(vocab_sizes, pad_to)
    table = torch.empty((total, dim), dtype=dtype, device=dev)
    table.normal_(0.0, dim ** -0.5, generator=generator)
    return table, torch.from_numpy(offs).to(dev)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for ids of any shape ->
    ids.shape + (D,), differentiable with respect to the table: one
    ``embedding_bag`` call over bags of one id each, and one
    ``embedding_bag_backward`` call for its gradient."""
    rows = bag_ops.lookup(table, ids.reshape(-1).contiguous())
    return rows.view(tuple(ids.shape) + (table.shape[1],))


def lookup_fields(table: torch.Tensor, offsets: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) per-field local ids -> (B, F, D) embeddings."""
    return shard_hint(take_rows(table, ids + offsets[None, :].to(ids.dtype)),
                      "batch", "fields", "embed_dim")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Fixed-shape bag: ids (B, L) -> (B, D). mask (B, L) marks valid ids."""
    emb = embed_lookup(table, ids)                        # (B, L, D)
    if mask is not None:
        emb = emb * mask[..., None].to(emb.dtype)
    if combiner == "sum":
        return emb.sum(1)
    if combiner == "mean":
        if mask is None:
            return emb.sum(1) / max(float(ids.shape[1]), 1.0)
        denom = mask.sum(1, keepdim=True).clamp_min(1.0)
        if not mask.is_floating_point():    # JAX: weak float, emb's dtype
            denom = denom.to(emb.dtype)
        return emb.sum(1) / denom
    if combiner == "max":
        if mask is not None:
            emb = torch.where(mask[..., None] > 0, emb,
                              torch.finfo(emb.dtype).min)
        return emb.amax(1)
    raise ValueError(combiner)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         bag_ids: torch.Tensor, n_bags: int,
                         weights: torch.Tensor | None = None,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged bag: flat_ids (T,), bag_ids (T,) -> (n_bags, D); bag ids
    outside [0, n_bags) are dropped, as ``segment_sum`` drops them."""
    emb = embed_lookup(table, flat_ids)                   # (T, D)
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    s = scatter_sum_plain(emb, bag_ids, n_bags)
    if combiner == "sum":
        return s
    if combiner == "mean":
        cnt = scatter_sum_plain(torch.ones(flat_ids.shape, dtype=emb.dtype,
                                           device=emb.device),
                                bag_ids, n_bags)
        return s / cnt.clamp_min(1.0)[:, None]
    raise ValueError(combiner)


def retrieval_topk(query: torch.Tensor, item_table: torch.Tensor,
                   k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score query (B, D) against all candidates (N, D) with one batched
    dot, return the top k (scores (B, k), ids (B, k) int64) in
    ``lax.top_k``'s order: IEEE total order, exact ties by lower id."""
    scores = einsum("bd,nd->bn", query, item_table.to(query.dtype))
    scores = shard_hint(scores, "batch", "candidates")
    # the selection runs on each rank's rows with the candidates whole
    whole = whole_dims(scores, (1,))
    local = whole.to_local() if is_dtensor(whole) else whole
    idx = torch.sort(total_order_key(local), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    top = torch.gather(local, 1, idx)
    shape = (scores.shape[0], idx.shape[1])
    return like_local(top, whole, shape), like_local(idx, whole, shape)
