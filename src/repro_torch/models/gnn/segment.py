"""Message-passing segment primitives, the port of
``repro/models/gnn/segment.py``: graph aggregation from index scatters
over edge lists, with ``jax.ops.segment_*``'s semantics. Segment ids
outside ``[0, n)`` are dropped; an empty segment sums to 0 and its
float max is ``-inf`` (``segment_softmax`` then shifts it by 0). The
fused gather-GEMM-scatter of the hot path is
``repro_torch.kernels.segment_mm``.

On the card ``gather_src`` is the ``embedding_bag`` kernel
(``kernels/embedding_bag/ops.lookup``: bags of one, its backward the
``embedding_bag_backward`` kernel) and ``scatter_sum`` the
``embedding_bag_backward`` kernel (``ops.segment_sum``): each segment's
rows added in position order with no atomics, as XLA's scatter-add adds
on the CPU, so two trainings give the same bits. On CPU tensors both
run the kernels' plain versions. ``scatter_sum_plain`` is the
``index_add_`` scatter, for the plain versions of other kernels
(``kernels/segment_mm/ref.py``) and the plain mirrors of JAX functions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.layers import embed_lookup


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Node features (N, ...) float32/bfloat16 -> per-edge source
    features (E, ...) (``jnp.take``: wrap, NaN rows for ids out of
    range), differentiable with respect to x."""
    rows = bag_ops.lookup(x.reshape(x.shape[0], -1), src.reshape(-1))
    return rows.view((src.numel(),) + tuple(x.shape[1:]))


def scatter_sum(msgs: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` of float32/bfloat16 ``msgs`` (E, ...) by
    ``dst`` (E,): ``ops.segment_sum``, the rows of each segment added in
    position order in ``msgs``' dtype; ids outside [0, n_nodes) are
    dropped."""
    return bag_ops.segment_sum(msgs, dst, n_nodes)


def scatter_sum_plain(msgs: torch.Tensor, dst: torch.Tensor,
                      n_nodes: int) -> torch.Tensor:
    """``scatter_sum`` as one ``index_add_`` (any dtype, any device: on
    CUDA its atomics add in no fixed order): rows of ``msgs`` summed by
    ``dst``; ids outside [0, n_nodes) are dropped (they land in a spill
    row past the end, cut off)."""
    idx = dst.long()
    idx = torch.where((idx >= 0) & (idx < n_nodes), idx, n_nodes)
    out = torch.zeros((n_nodes + 1,) + msgs.shape[1:], dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, idx, msgs)[:n_nodes]


def scatter_mean(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(msgs, dst, n_nodes)
    cnt = scatter_sum(torch.ones((msgs.shape[0],), dtype=msgs.dtype,
                                 device=msgs.device), dst, n_nodes)
    return s / cnt.clamp_min(eps).view((-1,) + (1,) * (msgs.dim() - 1))


def scatter_max(msgs: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    low = (float("-inf") if msgs.is_floating_point()
           else torch.iinfo(msgs.dtype).min)
    # ids outside [0, n_nodes) go to a spill row past the end, cut off
    out = torch.full((n_nodes + 1,) + msgs.shape[1:], low, dtype=msgs.dtype,
                     device=msgs.device)
    idx = dst.long()
    idx = torch.where((idx >= 0) & (idx < n_nodes), idx, n_nodes)
    idx = idx.view((-1,) + (1,) * (msgs.dim() - 1)).expand(msgs.shape)
    return out.scatter_reduce_(0, idx, msgs, "amax",
                               include_self=True)[:n_nodes]


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically-stable softmax over variable-length segments.

    logits (E, ...) grouped by segment_ids (E,) — the GNN edge-softmax.
    """
    seg_max = scatter_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    expv = torch.exp(logits - embed_lookup(seg_max, segment_ids, mode="clip"))
    denom = scatter_sum(expv, segment_ids, num_segments)
    return expv / embed_lookup(denom, segment_ids, mode="clip").clamp_min(1e-30)


def degree(dst: torch.Tensor, n_nodes: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return scatter_sum(torch.ones(dst.shape, dtype=dtype, device=dst.device),
                       dst, n_nodes)
