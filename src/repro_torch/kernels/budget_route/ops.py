"""Public fused budget-route op: top-k threshold + CUDA select-and-compact.

``budget_route(scores, tokens, alpha)`` is the device-side realization of
scheduler.plan_batch: tau = the floor(alpha*N)-th largest score in
IEEE total order (one ``torch.topk`` of the total-order keys, outside the
kernel, as ``lax.top_k`` sits outside the Pallas kernel in the JAX
package), clamped to the shared positive threshold, then the
select+compact kernel (``csrc/budget_route.cu``) for CUDA tensors or the
plain version (``ref.py``) for CPU tensors. Both compare scores with tau
after flushing subnormals to zero, as XLA's compare does. Beyond 4,096
rows the kernel's cooperative grid takes ``block_rows`` rows a block a
chunk: the winner the autotune store holds for the shape
(``autotune.tuned_block_rows``; dispatch reads it, never sweeps), else
512.

Semantics are the exact device mirror of ``scheduler.plan_batch``:
floor capacity (floor(alpha*N) == 0 routes nothing), tau clamped to
``POSITIVE_TAU``, ties at tau kept in row order up to capacity. Only
the value of the k-th largest score is taken from ``torch.topk``, so its
unspecified tie order cannot change the selection. The device plan may
differ from ``plan_batch`` at NaN or subnormal scores, as the JAX
package's device op differs from its host mirror there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.budget_route import autotune
from repro_torch.kernels.budget_route.autotune import (DEFAULT_BLOCK_ROWS,
                                                       tuned_block_rows)
from repro_torch.kernels.budget_route.ref import budget_route_ref
from repro_torch.kernels.cuda_lib import I, P
from repro_torch.kernels.order import total_order_key

# keep in sync with scheduler.POSITIVE_TAU (not imported: kernels must not
# depend on core)
POSITIVE_TAU = 1e-12
MAX_THREADS = 1024                 # threads of one block (csrc kMaxThreads)
SINGLE_BLOCK_ROWS = 4 * MAX_THREADS  # the largest N one block routes
GRID_ROWS = 4                      # rows a thread of a grid
GRID_THREADS = DEFAULT_BLOCK_ROWS // GRID_ROWS   # a grid's block, by default

KERNEL = cuda_lib.CudaKernel(
    "budget_route", "adaparse_budget_route",
    [P, P, P, I, I, I, I, P, P, P, P, I, I, I, I, P])


def capacity_floor(alpha: float, k: int) -> int:
    """⌊α·k⌋ with an epsilon guard against float dust.

    ``int(alpha * k)`` under-floors rational α whose product is an exact
    integer (0.29 * 100 → 28.999999999999996 → 28, not 29). Snap the
    product to the nearest integer when it is within 1e-9 *relative*
    tolerance — tight enough that genuinely fractional products
    (0.2899999 * 100) still truncate — then floor and clamp to [0, k].

    Single source of truth for every selection path: the host mirror
    (``scheduler.plan_batch`` / ``budget_topk``) and the device op
    (``budget_route``) all call this, so capacity parity holds by
    construction. Lives in the kernels layer because kernels must not
    depend on core (core imports kernels, not the reverse).
    """
    v = alpha * k
    r = round(v)
    if abs(v - r) <= 1e-9 * max(abs(v), 1.0):
        v = r
    return max(min(int(v), k), 0)


def _check(scores, tokens, tau) -> None:
    if scores.dim() != 1 or scores.dtype != torch.float32:
        raise ValueError(f"budget_route: scores must be (N,) float32 (got "
                         f"{tuple(scores.shape)} {scores.dtype})")
    if tokens.dim() != 2 or tokens.shape[0] != scores.shape[0]:
        raise ValueError(f"budget_route: tokens must be (N, D) with N = "
                         f"{scores.shape[0]} (got {tuple(tokens.shape)})")
    if tokens.device != scores.device or tau.device != scores.device:
        raise ValueError("budget_route: scores, tokens and tau must share "
                         "one device")
    if scores.device.type == "cuda":
        if tokens.element_size() != 4:
            raise ValueError(f"budget_route: the kernel moves 4-byte "
                             f"token elements (got {tokens.dtype})")
        if not (scores.is_contiguous() and tokens.is_contiguous()):
            raise ValueError("budget_route: scores and tokens must be "
                             "contiguous")
        if tau.dtype != torch.float32 or tau.numel() != 1:
            raise ValueError("budget_route: tau must be one float32")
    elif scores.device.type != "cpu":
        raise ValueError(f"budget_route: unsupported device "
                         f"{scores.device}")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(n: int, sms: int, block_rows: int = DEFAULT_BLOCK_ROWS
                ) -> tuple[int, int, int, int]:
    """(blocks, threads, rows a thread, chunks a block) of the one launch
    that routes N rows on a card of ``sms`` SMs: one block of the fewest
    whole warps, a row a thread up to 1024 rows, four up to 4096; beyond,
    a cooperative grid of at most one block an SM, ``block_rows`` /
    ``GRID_ROWS`` threads of ``GRID_ROWS`` rows (each block taking
    several such chunks of ``block_rows`` when N needs them)."""
    if n <= MAX_THREADS:
        return 1, max(32, -(-n // 32) * 32), 1, 1
    if n <= SINGLE_BLOCK_ROWS:
        return 1, -(-n // (32 * 4)) * 32, 4, 1
    if block_rows not in autotune.DEFAULT_CANDIDATES:
        raise ValueError(f"budget_route: block_rows {block_rows} outside "
                         f"{autotune.DEFAULT_CANDIDATES}")
    chunks = -(-n // (block_rows * sms))
    return (-(-n // (block_rows * chunks)), block_rows // GRID_ROWS,
            GRID_ROWS, chunks)


def launch_grid(n: int, device) -> list[tuple[int, int, int]]:
    """(blocks, threads, cooperative) of the one kernel a default launch
    runs."""
    blocks, threads, _, _ = launch_plan(n, sm_count(device))
    return [(blocks, threads, int(blocks > 1))]


def scratch_ints(blocks: int) -> int:
    """int32 scratch of a launch of ``blocks`` blocks: a (gt, eq) pair a
    block of a grid; one block needs none."""
    return 2 * blocks if blocks > 1 else 0


def _launch(scores, tokens, tau, out, idx, count, *, capacity: int,
            scratch=None, block_rows: int = DEFAULT_BLOCK_ROWS) -> None:
    """One kernel launch into preallocated outputs, every element of
    which it writes; no synchronisation. A grid needs ``scratch`` of two
    int32 a block (allocated here when not given)."""
    n, d = tokens.shape
    plan = launch_plan(n, sm_count(scores.device), block_rows)
    need = scratch_ints(plan[0])
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.int32, device=scores.device)
    elif scratch.numel() < need:
        raise ValueError(f"budget_route: scratch holds {scratch.numel()} "
                         f"ints; the launch needs {need}")
    row_bytes = 4 * d
    vec16 = int(row_bytes % 16 == 0 and tokens.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0)
    KERNEL(scores.data_ptr(), tau.data_ptr(), tokens.data_ptr(),
           n, row_bytes, capacity, vec16, out.data_ptr(), idx.data_ptr(),
           count.data_ptr(), scratch.data_ptr(), *plan,
           cuda_lib.stream_of(scores.device))


def route_tau(scores, capacity: int, require_positive: bool = True):
    """The capacity-th largest score in IEEE total order (a 1-element
    tensor on the scores' device), clamped to ``POSITIVE_TAU`` when
    ``require_positive``. ``lax.top_k``'s order: a negative NaN ranks
    below -inf, where ``torch.topk`` on the floats would rank it first."""
    kth = scores[torch.topk(total_order_key(scores), capacity).indices[-1:]]
    if require_positive:
        kth = torch.clamp(kth, min=POSITIVE_TAU)
    return kth


def budget_route_kernel(scores, tokens, tau, *, capacity: int,
                        block_rows: int | None = None):
    """The CUDA kernel on CUDA tensors: (routed (capacity, D), idx
    (capacity,) int32 source rows (-1 = empty), count () int32).
    ``block_rows=None`` reads the tuned winner for (N, D, capacity), or
    the default."""
    if scores.device.type != "cuda":
        raise ValueError(f"budget_route_kernel: CUDA tensors only (got "
                         f"{scores.device})")
    dev = scores.device
    n, d = tokens.shape
    if block_rows is None:
        block_rows = tuned_block_rows(n, d, capacity, device=dev)
    blocks = launch_plan(n, sm_count(dev), block_rows)[0]
    out = torch.empty((capacity, d), dtype=tokens.dtype, device=dev)
    # idx, count and the grid's scratch in one allocation
    ints = torch.empty((capacity + 1 + scratch_ints(blocks),),
                       dtype=torch.int32, device=dev)
    _launch(scores, tokens, tau.reshape(1), out, ints[:capacity],
            ints[capacity:capacity + 1], capacity=capacity,
            scratch=ints[capacity + 1:], block_rows=block_rows)
    return out, ints[:capacity], ints[capacity]


def budget_route(scores, tokens, alpha: float, *,
                 require_positive: bool = True):
    """scores (N,) f32, tokens (N, D), routing fraction ``alpha`` ->
    (routed (⌊αN⌋, D), idx (⌊αN⌋,) int32, count () int32). CPU tensors
    run the plain version, CUDA tensors the kernel."""
    n = scores.shape[0]
    capacity = capacity_floor(alpha, n)
    if capacity == 0:
        d = tokens.shape[1]
        return (torch.zeros((0, d), dtype=tokens.dtype,
                            device=tokens.device),
                torch.zeros((0,), dtype=torch.int32, device=tokens.device),
                torch.zeros((), dtype=torch.int32, device=tokens.device))
    tau = route_tau(scores, capacity, require_positive)
    _check(scores, tokens, tau)
    if scores.device.type == "cpu":
        return budget_route_ref(scores, tokens, tau[0], capacity=capacity)
    return budget_route_kernel(scores, tokens, tau, capacity=capacity)
