"""Public fused edge-GEMM + segment-scatter op (GNN message passing).

``segment_matmul(x, src, dst, w, *, n_nodes)`` is the full step
``out[d] = sum_{e: dst_e = d} x[src_e] @ W``, a copy of
``repro/kernels/segment_mm/ops.py``: a stable argsort of ``dst``, the
gather of ``x[src]`` in that order (``jnp.take``'s semantics: negative
ids wrap, ids out of range give NaN rows), then
``segment_matmul_kernel`` on the sorted edges. That runs the CUDA kernel
(``csrc/segment_mm.cu``: one block per range of output nodes, which
sums each node's rows of ``x[src]`` in edge order, then multiplies the
sums by W with float32 FMAs; no atomics) for CUDA tensors, the plain version (``ref.py``) for CPU
tensors. Both drop edges whose ``dst`` lies outside ``[0, n_nodes)``
(the TPU kernel clamps them onto the last node; its oracle drops them).
The wrapper refuses a ``dst`` that is not sorted ascending. Meta tensors
(the dry run) give the output's shape and charge the kernel's work
(``kernels/meta.py``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.meshrules import refuse_dtensor
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import meta as meta_lib
from repro_torch.kernels.cuda_lib import I, L, P
from repro_torch.kernels.segment_mm.ref import segment_matmul_ref
from repro_torch.models.layers import embed_lookup

MAX_NODES = 64                     # csrc kMaxNodes: nodes and ring rows
MAX_COLS = 64                      # columns of W a phase-2 pass stages
SMEM_BYTES = 232448 - 1024         # shared memory a block may use (H100),
#                                    less the kernel's static arrays
_ID_DTYPES = (torch.int32, torch.int64)

KERNEL = cuda_lib.CudaKernel(
    "segment_mm", "adaparse_segment_mm",
    [P, P, P, I, L, I, I, L, I, I, P, P])


def smem_bytes(d_in: int, nodes: int) -> int:
    """Shared memory of one block that owns ``nodes`` nodes (csrc
    smem_bytes): the (nodes x D_in) node-sum tile, a two-stage ring of
    ``nodes`` rows and its dst ids."""
    d_in4 = -(-d_in // 4) * 4
    return 4 * (-(-nodes // 4) * 4 + 2 * nodes) * d_in4 + 16 * nodes


def block_plan(d_in: int, d_out: int) -> tuple[int, int]:
    """(nodes a block owns, also the rows a ring stage holds; columns of
    W a phase-2 pass stages in the ring's space): the most nodes, up to
    MAX_NODES, that fit in shared memory. Raises when not even a ring of
    two rows fits beside two nodes' sums."""
    for n in range(MAX_NODES, 1, -1):
        if smem_bytes(d_in, n) <= SMEM_BYTES:
            cols = min(MAX_COLS, 2 * n, -(-d_out // 4) * 4)
            return n, cols // 4 * 4
    raise ValueError(f"segment_matmul: D_in={d_in} leaves no room in "
                     f"shared memory for a node's row and a ring of two")


def _check(xg, w, dst, n_nodes) -> None:
    if xg.dim() != 2 or w.dim() != 2 or xg.shape[1] != w.shape[0]:
        raise ValueError(f"segment_matmul: need x_gathered (E, D_in) and w "
                         f"(D_in, D_out) (got {tuple(xg.shape)}, "
                         f"{tuple(w.shape)})")
    if dst.dim() != 1 or dst.shape[0] != xg.shape[0] \
            or dst.dtype not in _ID_DTYPES:
        raise ValueError(f"segment_matmul: dst must be (E,) = "
                         f"({xg.shape[0]},) int32 or int64 (got "
                         f"{tuple(dst.shape)} {dst.dtype})")
    if not (xg.is_floating_point() and w.is_floating_point()):
        raise ValueError("segment_matmul: x and w must be floating point")
    if n_nodes < 0:
        raise ValueError(f"segment_matmul: n_nodes {n_nodes} < 0")
    if len({xg.device, w.device, dst.device}) != 1:
        raise ValueError("segment_matmul: x, w and dst must share one "
                         "device")
    if xg.device.type == "cuda":
        if xg.dtype != torch.float32 or w.dtype != torch.float32:
            raise ValueError(f"segment_matmul: the kernel takes float32 x "
                             f"and w (got {xg.dtype}, {w.dtype})")
        if not (xg.is_contiguous() and w.is_contiguous()
                and dst.is_contiguous()):
            raise ValueError("segment_matmul: x, w and dst must be "
                             "contiguous")
        block_plan(w.shape[0], w.shape[1])
    elif xg.device.type not in ("cpu", "meta"):
        raise ValueError(f"segment_matmul: unsupported device {xg.device}")
    if dst.shape[0] > 1 and not dst.is_meta \
            and not bool((dst[1:] >= dst[:-1]).all()):
        raise ValueError("segment_matmul: dst must be sorted ascending")


def _launch(xg, w, dst, out, *, n_nodes: int) -> None:
    """One kernel launch into a preallocated contiguous float32 ``out``
    (n_nodes, D_out); the kernel writes every row. No synchronisation."""
    e, d_in = xg.shape
    d_out = w.shape[1]
    KERNEL(xg.data_ptr(), w.data_ptr(), dst.data_ptr(),
           int(dst.dtype == torch.int64), e, d_in, d_out, n_nodes,
           *block_plan(d_in, d_out), out.data_ptr(),
           cuda_lib.stream_of(xg.device))


def segment_matmul_kernel(x_gathered, w, dst_sorted, *, n_nodes: int):
    """x_gathered (E, D_in) = x[src] in dst order; w (D_in, D_out);
    dst_sorted (E,) ascending -> (n_nodes, D_out) float32."""
    refuse_dtensor("segment_matmul", x_gathered, w, dst_sorted)
    _check(x_gathered, w, dst_sorted, n_nodes)
    if x_gathered.device.type == "cpu":
        return segment_matmul_ref(x_gathered, w, dst_sorted, n_nodes=n_nodes)
    if x_gathered.is_meta:
        e, d_in = x_gathered.shape
        d_out = w.shape[1]
        out = meta_lib.empty((n_nodes, d_out), torch.float32, x_gathered)
        # E * D_in adds and one GEMV a destination (at most min(E, n)
        # of them); x, W and dst read once, the output written once
        n_dst = min(e, n_nodes)
        meta_lib.charge(KERNEL.name, e * d_in + 2 * n_dst * d_in * d_out,
                        meta_lib.nbytes(x_gathered, w, out)
                        + 8 * e, x_gathered.dtype)
        return out
    out = torch.empty((n_nodes, w.shape[1]), dtype=torch.float32,
                      device=x_gathered.device)
    if out.numel():
        _launch(x_gathered, w, dst_sorted, out, n_nodes=n_nodes)
    return out


def segment_matmul(x, src, dst, w, *, n_nodes: int):
    """Full message-passing step: out[d] = sum_{e: dst_e = d} x[src_e] @ W.
    Sorts edges by dst (stable) before the fused kernel."""
    refuse_dtensor("segment_matmul", x, src, dst, w)
    order = torch.argsort(dst, stable=True)
    xg = embed_lookup(x, src[order])
    return segment_matmul_kernel(xg, w, dst[order], n_nodes=n_nodes)
