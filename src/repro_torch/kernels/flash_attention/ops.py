"""Public flash-attention op (forward only): the LM's prefill attention
for ``attention_impl="pallas"``.

``flash_attention(q, k, v, causal=, window=)`` takes q (B, Sq, H, D) and
k, v (B, Skv, Hk, D) in the JAX package's layout, float32 or bfloat16,
and returns q's shape and dtype: the CUDA kernel
(``csrc/flash_attention.cu``: bfloat16 on the tensor cores with p kept
at float32 precision, float32 on the CUDA cores) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors; meta tensors (the dry run) give q's shape
and charge the kernel's work (``kernels/meta.py``), with no score matrix.
The kernel reads q, k and v through their strides (the head dim must be
contiguous) and writes a new contiguous output; the wrapper makes no
padded copies.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed.meshrules import is_dtensor, replicated
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import meta as meta_lib
from repro_torch.kernels.cuda_lib import F, I, L, P
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

MAX_HEAD_DIM = 256                 # csrc kMaxHeadDim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = cuda_lib.CudaKernel(
    "flash_attention", "adaparse_flash_attention",
    [P, P, P, P, I, I, I, I, I, I, I] + [L] * 9 + [I, I, F, P])


def launch_smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory, in bytes, that a launch for ``dtype`` at
    head dim ``d`` asks for, as the library computes it (builds it on
    first use)."""
    fn = cuda_lib.library().adaparse_flash_attention_smem
    fn.argtypes, fn.restype = [I, I], L
    return fn(_DTYPES[dtype], d)


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q (B, Sq, H, D) and k, v "
                         f"(B, Skv, Hk, D) (got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)})")
    b, _, h, d = q.shape
    bk, skv, hk, dk = k.shape
    if (bk, dk) != (b, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    if hk == 0 or h % hk:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hk={hk}")
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv=0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: q, k and v must share one device")
    if len({t.dtype for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if q.device.type == "cuda":
        if q.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: the kernel takes float32 or "
                             f"bfloat16 (got {q.dtype})")
        if d > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {d} > "
                             f"{MAX_HEAD_DIM}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("flash_attention: the head dim of q, k and v "
                             "must be contiguous")
    elif q.device.type not in ("cpu", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def visible_pairs(sq: int, skv: int, causal: bool,
                  window: int | None) -> int:
    """(query, key) pairs the mask keeps, queries and keys numbered from
    0: ``k <= q`` when causal, ``q - k < window`` with a window."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q, k, v, *, causal: bool, window: int | None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call, as the kernel's bound counts them: 4 D
    operations (the QK and PV multiply-adds) a visible pair and query
    head; q, k and v read once, the output written once."""
    b, sq, h, d = q.shape
    flops = 4 * d * visible_pairs(sq, k.shape[1], causal, window) * b * h
    return flops, 2 * meta_lib.nbytes(q) + meta_lib.nbytes(k, v)


def _launch(q, k, v, out, *, causal: bool, window: int | None) -> None:
    """One kernel launch into a preallocated contiguous ``out`` of q's
    shape and dtype; no synchronisation."""
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           _DTYPES[q.dtype], b, sq, skv, h, hk, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           int(causal), 0 if window is None else int(window),
           1.0 / math.sqrt(d), cuda_lib.stream_of(q.device))


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B, Sq, H, D); k, v (B, Skv, Hk, D); H % Hk == 0. Query head h
    attends with KV head h // (H // Hk); causal positions start at 0 for
    queries and keys, and the window keeps ``qpos - kpos < window``.
    DTensors run ``_sharded``."""
    if any(is_dtensor(t) for t in (q, k, v)):
        return _sharded(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.is_meta:
        meta_lib.charge(KERNEL.name, *cost(q, k, v, causal=causal,
                                           window=window), q.dtype)
        return meta_lib.empty(q.shape, q.dtype, q)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        _launch(q, k, v, out, causal=causal, window=window)
    return out


def _sharded(q, k, v, *, causal: bool, window):
    """``flash_attention`` on DTensors through ``local_map``: each rank
    calls the op on its local q, k and v, which the mesh may cut over the
    batch and head dims only (a launch on a sequence or ``d_head`` shard
    would number positions or sum dot products wrongly: refused, as is a
    partial sum). Where q's heads are cut over a mesh dim, k and v are
    cut over it the same way when their heads divide (a rank's q heads
    h then read kv heads h // G of its own shard); otherwise q's heads
    are gathered on that dim. The output has q's placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    q, k, v = (replicated(t) for t in (q, k, v))
    if not all(is_dtensor(t) for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must all be DTensors "
                         "or all plain")
    mesh = q.device_mesh
    for t in (q, k, v):
        if any(not isinstance(p, (Shard, Replicate)) or
               (isinstance(p, Shard) and p.dim % 4 in (1, 3))
               for p in t.placements):
            raise ValueError(f"flash_attention: placements {t.placements}: "
                             f"only the batch and head dims may be sharded")
    qp, kp = list(q.placements), list(k.placements)
    for i, (a, b) in enumerate(zip(qp, kp)):
        if a == b:
            continue
        if a == Shard(2) and k.shape[2] % mesh.size(i) == 0:
            kp[i] = Shard(2)
        elif a == Shard(0) or b == Shard(0):
            qp[i] = kp[i] = Shard(0) if q.shape[0] % mesh.size(i) == 0 \
                else Replicate()
        else:
            qp[i] = kp[i] = Replicate()
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kp) for t in (k, v))
    fn = local_map(lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                                   window=window),
                   out_placements=qp, in_placements=(qp, kp, kp),
                   device_mesh=mesh)
    return fn(q, k, v)
