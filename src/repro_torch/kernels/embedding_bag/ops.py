"""Public EmbeddingBag op: fused gather + weighted bag reduce.

``embedding_bag(table, ids, weights=None, *, combiner="sum")`` computes
``out[b] = combine_l w[b, l] * table[ids[b, l]]`` (``weights=None``
means ones): the CUDA kernel (``csrc/embedding_bag.cu``, one group of
lanes per bag, float32 accumulation, no atomics) for CUDA tensors, the
plain version (``ref.py``) for CPU tensors. Both follow ``jnp.take`` for
ids out of range: negative ids wrap once, ids ``>= R`` or ``< -R`` give
a NaN bag.

The recsys forward's field lookup is this op with bags of one, weight 1
and ``sum`` (FBGEMM's table-batched-embedding pattern at pooling factor
1), which equals the plain gather bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I, L, P
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

COMBINERS = ("sum", "mean")
_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_DTYPES = (torch.int32, torch.int64)

KERNEL = cuda_lib.CudaKernel(
    "embedding_bag", "adaparse_embedding_bag",
    [P, I, L, L, I, P, I, P, L, I, I, I, P, P])


def _check(table, ids, weights, combiner) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"embedding_bag: combiner {combiner!r} not in "
                         f"{COMBINERS}")
    if table.dim() != 2 or table.dtype not in _TABLE_DTYPES:
        raise ValueError(f"embedding_bag: table must be (R, D) float32 or "
                         f"bfloat16 (got {tuple(table.shape)} {table.dtype})")
    if ids.dim() != 2 or ids.dtype not in _ID_DTYPES:
        raise ValueError(f"embedding_bag: ids must be (B, L) int32 or int64 "
                         f"(got {tuple(ids.shape)} {ids.dtype})")
    if weights is not None and (weights.shape != ids.shape
                                or weights.dtype != torch.float32):
        raise ValueError(f"embedding_bag: weights must be float32 of the "
                         f"ids' shape {tuple(ids.shape)} (got "
                         f"{tuple(weights.shape)} {weights.dtype})")
    devs = {table.device, ids.device} | (
        {weights.device} if weights is not None else set())
    if len(devs) != 1:
        raise ValueError("embedding_bag: table, ids and weights must share "
                         "one device")
    if table.device.type == "cuda":
        if table.stride(1) != 1:
            raise ValueError("embedding_bag: table rows must be contiguous")
        if not ids.is_contiguous() or (weights is not None
                                       and not weights.is_contiguous()):
            raise ValueError("embedding_bag: ids and weights must be "
                             "contiguous")
    elif table.device.type != "cpu":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")


def _launch(table, ids, weights, out, *, combiner: str) -> None:
    """One kernel launch into a preallocated contiguous ``out`` (B, D) of
    the table's dtype; no synchronisation."""
    r, d = table.shape
    b, bag = ids.shape
    el = table.element_size()
    vec16 = int((d * el) % 16 == 0 and (table.stride(0) * el) % 16 == 0
                and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    KERNEL(table.data_ptr(), _TABLE_DTYPES[table.dtype], r, table.stride(0),
           d, ids.data_ptr(), int(ids.dtype == torch.int64),
           0 if weights is None else weights.data_ptr(), b, bag,
           int(combiner == "mean"), vec16, out.data_ptr(),
           cuda_lib.stream_of(table.device))


def embedding_bag(table, ids, weights=None, *, combiner: str = "sum"):
    """table (R, D) f32/bf16; ids (B, L) int32/int64; weights (B, L) f32
    or None (ones) -> (B, D) in the table's dtype."""
    _check(table, ids, weights, combiner)
    if table.device.type == "cpu":
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32)
        return embedding_bag_ref(table, ids, weights, combiner=combiner)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        _launch(table, ids, weights, out, combiner=combiner)
    return out
