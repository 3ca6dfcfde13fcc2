"""Float comparison semantics of the JAX package, for the port's
selection code.

``lax.top_k`` orders float32 by IEEE total order (-NaN below -inf,
-0.0 below +0.0, +NaN above +inf); ``torch.topk`` and ``torch.sort``
rank every NaN above +inf. ``total_order_key`` gives int32 keys whose
order is the total order, so a sort or top-k over the keys reproduces
``lax.top_k``.

XLA flushes float32 subnormals to zero when it compares floats (and a
TPU has none); PyTorch keeps them. ``flush_subnormal`` makes a value
with |x| < 2^-126 a zero of the same sign, so ``flush(a) > flush(b)``
and ``flush(a) == flush(b)`` compare as XLA does. The order itself is
not flushed: ``lax.top_k`` ranks subnormals by their bits.

Lives in the kernels layer so the kernels' wrappers can use it (kernels
must not depend on core).
"""
from __future__ import annotations

import torch


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is IEEE total order on ``x`` in float32."""
    bits = x.float().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 with every subnormal replaced by a zero of its
    sign (NaN, infinities and normal values unchanged)."""
    bits = x.float().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    return torch.where((bits & 0x7F800000) == 0, sign, bits).view(
        torch.float32)
