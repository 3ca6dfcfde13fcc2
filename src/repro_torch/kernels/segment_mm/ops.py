"""Public fused edge-GEMM + segment-scatter op (GNN message passing).

``segment_matmul(x, src, dst, w, *, n_nodes)`` is the full step
``out[d] = sum_{e: dst_e = d} x[src_e] @ W``, a copy of
``repro/kernels/segment_mm/ops.py``: a stable argsort of ``dst``, the
gather of ``x[src]`` in that order (``jnp.take``'s semantics: negative
ids wrap, ids out of range give NaN rows), then
``segment_matmul_kernel`` on the sorted edges. That runs the CUDA kernel
(``csrc/segment_mm.cu``: one block per range of output nodes, W in
shared memory, float32 FMAs, runs of equal ``dst`` summed in registers,
no atomics) for CUDA tensors, the plain version (``ref.py``) for CPU
tensors. Both drop edges whose ``dst`` lies outside ``[0, n_nodes)``
(the TPU kernel clamps them onto the last node; its oracle drops them).
The wrapper refuses a ``dst`` that is not sorted ascending.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I, L, P
from repro_torch.kernels.segment_mm.ref import segment_matmul_ref
from repro_torch.models.layers import embed_lookup

TILE_E = 16                        # csrc kTileE: edges staged per step
MAX_COLS = 128                     # csrc kThreads: one column per thread
SMEM_BYTES = 232448                # shared memory one block may use (H100)
_ID_DTYPES = (torch.int32, torch.int64)

KERNEL = cuda_lib.CudaKernel(
    "segment_mm", "adaparse_segment_mm",
    [P, P, P, I, L, I, I, L, I, P, P])


def column_chunk(d_in: int, d_out: int) -> int:
    """Output columns one block computes: W's (d_in, chunk) slice and a
    tile of TILE_E edges must fit in shared memory (csrc layout)."""
    d_in4 = -(-d_in // 4) * 4
    room = (SMEM_BYTES - 8 * TILE_E) // (4 * d_in4) - TILE_E
    cw = min(MAX_COLS, d_out, room)
    if cw < 1:
        raise ValueError(f"segment_matmul: D_in={d_in} leaves no room in "
                         f"shared memory for a column of W")
    return cw


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
        column_chunk(w.shape[0], w.shape[1])
    elif xg.device.type != "cpu":
        raise ValueError(f"segment_matmul: unsupported device {xg.device}")
    if dst.shape[0] > 1 and not bool((dst[1:] >= dst[:-1]).all()):
        raise ValueError("segment_matmul: dst must be sorted ascending")


def _launch(xg, w, dst, out, *, n_nodes: int) -> None:
    """One kernel launch into a preallocated contiguous float32 ``out``
    (n_nodes, D_out); the kernel writes every row. No synchronisation."""
    e, d_in = xg.shape
    d_out = w.shape[1]
    KERNEL(xg.data_ptr(), w.data_ptr(), dst.data_ptr(),
           int(dst.dtype == torch.int64), e, d_in, d_out, n_nodes,
           column_chunk(d_in, d_out), out.data_ptr(),
           cuda_lib.stream_of(xg.device))


def segment_matmul_kernel(x_gathered, w, dst_sorted, *, n_nodes: int):
    """x_gathered (E, D_in) = x[src] in dst order; w (D_in, D_out);
    dst_sorted (E,) ascending -> (n_nodes, D_out) float32."""
    _check(x_gathered, w, dst_sorted, n_nodes)
    if x_gathered.device.type == "cpu":
        return segment_matmul_ref(x_gathered, w, dst_sorted, n_nodes=n_nodes)
    out = torch.empty((n_nodes, w.shape[1]), dtype=torch.float32,
                      device=x_gathered.device)
    if out.numel():
        _launch(x_gathered, w, dst_sorted, out, n_nodes=n_nodes)
    return out


def segment_matmul(x, src, dst, w, *, n_nodes: int):
    """Full message-passing step: out[d] = sum_{e: dst_e = d} x[src_e] @ W.
    Sorts edges by dst (stable) before the fused kernel."""
    order = torch.argsort(dst, stable=True)
    xg = embed_lookup(x, src[order])
    return segment_matmul_kernel(xg, w, dst[order], n_nodes=n_nodes)
