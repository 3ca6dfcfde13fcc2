"""Public EmbeddingBag op: fused gather + weighted bag reduce.

``embedding_bag(table, ids, weights=None, *, combiner="sum")`` computes
``out[b] = combine_l w[b, l] * table[ids[b, l]]`` (``weights=None``
means ones): the CUDA kernel (``csrc/embedding_bag.cu``, lanes flat over
(bag, vector) with the widest vector the row and its addresses allow,
float32 accumulation, no atomics) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors. Both follow ``jnp.take`` for
ids out of range: negative ids wrap once, ids ``>= R`` or ``< -R`` give
a NaN bag.

The recsys forward's field lookup is this op with bags of one, weight 1
and ``sum`` (FBGEMM's table-batched-embedding pattern at pooling factor
1), which equals the plain gather bit for bit.

``lookup(table, ids)`` is that lookup as an ``autograd.Function``: the
forward is ``embedding_bag``, the backward ``embedding_bag_backward``,
the table gradient of bags of one (``csrc/embedding_bag.cu``'s second
kernel on CUDA tensors, ``ref.embedding_bag_backward_ref`` on CPU ones),
added in the table's dtype in position order as XLA's scatter-add adds.
Its plumbing (``row_offsets``: the wrap, a stable sort and the first
sorted position of every tile of rows) makes no host synchronisation.

Meta tensors (the dry run) give each kernel's output shape and charge
its work (``kernels/meta.py``: every id's row read, as if none
repeated).

``segment_sum(msgs, ids, n)`` is ``jax.ops.segment_sum`` as an
``autograd.Function``: the forward is that same backward kernel, which
sums the rows of each segment in position order, rounding each add to
the dtype (no atomics, the same bits every run); ids outside ``[0, n)``
are mapped past the end, so they are dropped and never wrap. Its
backward is a plain gather of the gradient by id (zero for a dropped
id). The GNN's aggregations (``models/gnn/segment.scatter_sum``) run
through it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.meshrules import (is_dtensor, refuse_dtensor,
                                               replicated, whole_dims)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import meta as meta_lib
from repro_torch.kernels.cuda_lib import I, L, P
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_backward_ref, embedding_bag_ref, sorted_rows)

COMBINERS = ("sum", "mean")
_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ID_DTYPES = (torch.int32, torch.int64)

KERNEL = cuda_lib.CudaKernel(
    "embedding_bag", "adaparse_embedding_bag",
    [P, I, L, L, I, P, I, P, L, I, I, I, P, P])
BACKWARD = cuda_lib.CudaKernel(
    "embedding_bag_backward", "adaparse_embedding_bag_backward",
    [P, I, L, I, P, P, L, P, I, I, P, P])

#: a run of more ids than this on one row is a long run: a pair of
#: warps of its own streams its rows through a shared-memory ring
#: (``kLongRun`` in ``csrc/embedding_bag.cu``)
LONG_RUN = 64
#: the most rows a warp of the backward takes (``kMaxTile``)
MAX_TILE = 256


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
    elif table.device.type not in ("cpu", "meta"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")


def _launch(table, ids, weights, out, *, combiner: str) -> None:
    """One kernel launch into a preallocated contiguous ``out`` (B, D) of
    the table's dtype; no synchronisation."""
    r, d = table.shape
    b, bag = ids.shape
    el = table.element_size()
    vb = vec_bytes(el, d * el, table.stride(0) * el, table.data_ptr(),
                   out.data_ptr())
    KERNEL(table.data_ptr(), _TABLE_DTYPES[table.dtype], r, table.stride(0),
           d, ids.data_ptr(), int(ids.dtype == torch.int64),
           0 if weights is None else weights.data_ptr(), b, bag,
           int(combiner == "mean"), vb, out.data_ptr(),
           cuda_lib.stream_of(table.device))


def vec_bytes(element_size: int, *multiples: int) -> int:
    """The kernels' vector: the widest of 16, 8, 4 and 2 bytes (not below
    one element) that divides every one of ``multiples`` (row widths and
    strides in bytes, base addresses)."""
    for vb in (16, 8, 4, 2):
        if vb >= element_size and all(m % vb == 0 for m in multiples):
            return vb
    return element_size


def embedding_bag(table, ids, weights=None, *, combiner: str = "sum"):
    """table (R, D) f32/bf16; ids (B, L) int32/int64; weights (B, L) f32
    or None (ones) -> (B, D) in the table's dtype."""
    refuse_dtensor("embedding_bag", table, ids, weights)
    _check(table, ids, weights, combiner)
    if table.device.type == "cpu":
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32)
        return embedding_bag_ref(table, ids, weights, combiner=combiner)
    if table.is_meta:
        out = meta_lib.empty((ids.shape[0], table.shape[1]), table.dtype,
                             table)
        # each distinct looked-up row read once (at most one an id, and
        # at most every row of the table), each bag written once, the
        # ids and weights read once
        meta_lib.charge(KERNEL.name, 0, min(ids.numel(), table.shape[0])
                        * table.shape[1] * table.element_size()
                        + meta_lib.nbytes(out, ids, weights), table.dtype)
        return out
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        _launch(table, ids, weights, out, combiner=combiner)
    return out


def embedding_bag_backward(grad, ids, rows: int):
    """grad (N, D) f32/bf16; ids (N,) int32/int64 -> the (rows, D)
    table gradient of ``embedding_bag`` with bags of one, in grad's
    dtype: ids wrap from the end, ids outside [-rows, rows) add nothing,
    and each row's adds are rounded to the dtype in ascending position
    order."""
    refuse_dtensor("embedding_bag_backward", grad, ids)
    if grad.dim() != 2 or grad.dtype not in _TABLE_DTYPES:
        raise ValueError(f"embedding_bag_backward: grad must be (N, D) "
                         f"float32 or bfloat16 (got {tuple(grad.shape)} "
                         f"{grad.dtype})")
    if ids.dim() != 1 or ids.dtype not in _ID_DTYPES \
            or ids.shape[0] != grad.shape[0]:
        raise ValueError(f"embedding_bag_backward: ids must be (N,) int32 "
                         f"or int64 with N = {grad.shape[0]} (got "
                         f"{tuple(ids.shape)} {ids.dtype})")
    if grad.device != ids.device:
        raise ValueError("embedding_bag_backward: grad and ids must share "
                         "one device")
    if grad.device.type == "cpu":
        return embedding_bag_backward_ref(grad, ids, rows)
    if grad.is_meta:
        out = meta_lib.empty((rows, grad.shape[1]), grad.dtype, grad)
        if out.numel():
            # the plumbing's sort and searchsorted run as on the card
            el = grad.element_size()
            row_offsets(ids, rows, tile_rows(
                grad.shape[1] * el // vec_bytes(el, grad.shape[1] * el),
                ids.numel(), rows))
        # the grad rows and ids read once, the dense gradient written once
        meta_lib.charge(BACKWARD.name, 0, meta_lib.nbytes(grad, ids, out),
                        grad.dtype)
        return out
    if grad.device.type != "cuda":
        raise ValueError(f"embedding_bag_backward: unsupported device "
                         f"{grad.device}")
    grad = grad.contiguous()
    out = torch.empty((rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    if out.numel():
        el, d = grad.element_size(), grad.shape[1]
        vb = vec_bytes(el, d * el, grad.data_ptr(), out.data_ptr())
        tile = tile_rows(d * el // vb, ids.numel(), rows)
        keys, perm, tile_ptr = row_offsets(ids, rows, tile)
        BACKWARD(grad.data_ptr(), _TABLE_DTYPES[grad.dtype], rows, d,
                 keys.data_ptr(), perm.data_ptr(), keys.numel(),
                 tile_ptr.data_ptr(), tile, vb, out.data_ptr(),
                 cuda_lib.stream_of(grad.device))
    return out


def tile_rows(row_vecs: int, n_ids: int, rows: int) -> int:
    """Output rows a warp of the backward takes: a power of two in [1,
    MAX_TILE], about 2,048 row vectors times the ids a row holds on
    average (at least one), so that a sparse table's warp covers many
    empty rows and a dense one's few full ones."""
    per_row = max(1.0, n_ids / max(rows, 1))
    want = max(1, int(2048 / (row_vecs * per_row)))
    return min(MAX_TILE, 1 << (want.bit_length() - 1))


def row_offsets(ids, rows: int, step: int = 1):
    """The backward kernel's plumbing, with no host synchronisation: the
    ids wrapped and stably sorted (``sorted_rows``: keys, an id outside
    [-rows, rows) as ``rows``, and perm, the positions they came from),
    and ptr (ceil(rows / step) + 1,) int64: ptr[t] is the first sorted
    position whose key is at least min(t * step, rows). With step 1 that
    is the dense row offsets (row r's positions are perm[ptr[r] :
    ptr[r + 1]]); the kernel takes one entry a tile of ``step`` rows, and
    ptr[-1] is the count of valid ids."""
    keys, perm = sorted_rows(ids, rows)
    n = -(-rows // step)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=keys.device)
    bounds.mul_(step).clamp_(max=rows)
    return keys, perm, torch.searchsorted(keys, bounds)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return embedding_bag(table, ids.view(-1, 1), None, combiner="sum")

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return embedding_bag_backward(grad, ids, ctx.rows), None


def lookup(table, ids):
    """table (R, D); ids (N,) int32/int64 contiguous -> (N, D) rows in
    the table's dtype (``jnp.take``: wrapped ids, a NaN row outside
    [-R, R)), differentiable with respect to the table through
    ``embedding_bag_backward``. One forward and one backward launch on
    the card. A DTensor table or ids run ``_lookup_sharded``."""
    if ids.dim() != 1:
        raise ValueError(f"lookup: ids must be (N,) (got "
                         f"{tuple(ids.shape)})")
    if is_dtensor(table) or is_dtensor(ids):
        return _lookup_sharded(table, ids)
    return _Lookup.apply(table, ids)


def _lookup_sharded(table, ids):
    """``lookup`` of a DTensor table whose rows are cut over mesh dims
    (``table_rows``): the ids are made whole on every rank, each rank
    looks up through ``embedding_bag`` on its own shard only the ids in
    its row range (the others masked to local row 0 before the launch,
    since the kernel clamps an id past the shard onto its last row,
    another rank's row, and zeroed after it), and the result is a
    partial sum over those mesh dims (one owner a row; the caller's
    ``shard_hint`` sums it). An id outside [-R, R) is a NaN row, written
    by the first row shard alone, as ``jnp.take`` gives it. Forward
    only: the mesh's backward is the next slice's."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError("lookup: no backward on a DTensor table")
    table = whole_dims(replicated(table), (1,))
    if is_dtensor(ids):
        ids = ids.full_tensor()
    if not is_dtensor(table):
        return lookup(table, ids)
    mesh, placements = table.device_mesh, table.placements
    shape, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, placements)
    r, lo, n = table.shape[0], offset[0], shape[0]
    flat = ids.long()
    flat = torch.where(flat < 0, flat + r, flat)
    mine = (flat >= lo) & (flat < lo + n)
    # the rules cut a table's rows only where they divide: n >= 1
    rows = embedding_bag(table.to_local(), torch.where(
        mine, flat - lo, 0).to(ids.dtype).view(-1, 1), None, combiner="sum")
    rows = torch.where(mine[:, None], rows, 0)
    if lo == 0 and table.is_floating_point():
        rows = torch.where(((flat < 0) | (flat >= r))[:, None],
                           float("nan"), rows)
    out = [Partial("sum") if isinstance(p, Shard) else p for p in placements]
    return DTensor.from_local(rows, mesh, out, run_check=False,
                              shape=torch.Size((ids.shape[0], table.shape[1])),
                              stride=(table.shape[1], 1))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, ids, n):
        idx = ids.long()
        # a dropped id goes to row n, which the kernel drops (>= rows)
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
        ctx.save_for_backward(idx)
        ctx.n, ctx.shape = n, msgs.shape
        flat = msgs.reshape(msgs.shape[0], math.prod(msgs.shape[1:]))
        return embedding_bag_backward(flat, idx, n).view(
            (n,) + tuple(msgs.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = grad.reshape(ctx.n, math.prod(ctx.shape[1:]))
        if ctx.n == 0:
            rows = g.new_zeros((idx.numel(), g.shape[1]))
        else:
            rows = g.index_select(0, idx.clamp_max(ctx.n - 1))
            rows.masked_fill_((idx == ctx.n)[:, None], 0)
        return rows.view(ctx.shape), None, None


def segment_sum(msgs, ids, n: int):
    """msgs (E, ...) float32/bfloat16; ids (E,) int -> (n, ...) in msgs'
    dtype: row s is ``((0 + m[p0]) + m[p1]) + ...`` over the positions
    p0 < p1 < ... whose id is s, each add rounded to the dtype, as XLA's
    scatter-add adds; ids outside [0, n) add nothing. Differentiable with
    respect to msgs. One ``embedding_bag_backward`` launch on the card
    (its plain version on the CPU), none in the backward."""
    refuse_dtensor("segment_sum", msgs, ids)
    if ids.dim() != 1 or msgs.dim() < 1 or ids.shape[0] != msgs.shape[0]:
        raise ValueError(f"segment_sum: ids must be (E,) with E = "
                         f"msgs.shape[0] (got ids {tuple(ids.shape)}, msgs "
                         f"{tuple(msgs.shape)})")
    return _SegmentSum.apply(msgs, ids, int(n))
