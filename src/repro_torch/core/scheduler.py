"""Budget-constrained parser assignment (§4.1, App. C).

The optimization:  max_j Σ E[A(φ_{j_i}) | φ¹(d_i)]  s.t.  Σ T(φ_{j_i}) ≤ T̄

Two-parser case (AdaParse production config): sort documents by predicted
improvement of the expensive parser and route the top ⌊αk⌋ of each batch
of k — streaming, node-local, embarrassingly parallel. The general
m-parser case is solved by a greedy cost-benefit knapsack (host-side,
``assign_parsers_greedy``); ``alpha_for_budget`` turns a node's share
of the campaign budget into its α (core/campaign).

``budget_topk`` is the device-side selection op on torch tensors; the
fused select-and-compact CUDA kernel lives in
``repro_torch.kernels.budget_route``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.kernels.budget_route.ops import capacity_floor
from repro_torch.kernels.order import flush_subnormal, total_order_key


def alpha_for_budget(t_budget: float, n_docs: int, t_cheap: float,
                     t_expensive: float) -> float:
    """α ≤ (T̄ − n·T_cheap) / (n·(T_exp − T_cheap)), clipped to [0, 1]."""
    if n_docs == 0 or t_expensive <= t_cheap:
        return 1.0
    a = (t_budget - n_docs * t_cheap) / (n_docs * (t_expensive - t_cheap))
    return float(np.clip(a, 0.0, 1.0))


def budget_topk(scores: torch.Tensor, alpha: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side per-batch rule: route the ⌊α·k⌋ highest-scoring items.

    scores (k,) predicted improvement (E[A_exp] − E[A_cheap]).
    Returns (mask (k,) bool, indices (⌊αk⌋,) of selected items).
    Only items with positive predicted improvement are routed. The order
    is ``lax.top_k``'s: IEEE total order (-0.0 below +0.0), exact ties
    by lower index — a stable descending sort of the total-order keys,
    since ``torch.topk`` promises no tie order. The sign test flushes
    subnormals to zero first, as XLA's compare does.
    """
    k = scores.shape[0]
    n_sel = capacity_floor(alpha, k)
    mask = torch.zeros((k,), dtype=torch.bool, device=scores.device)
    if n_sel == 0:
        return mask, torch.zeros((0,), dtype=torch.int64,
                                 device=scores.device)
    idx = torch.sort(total_order_key(scores), descending=True,
                     stable=True).indices[:n_sel]
    mask[idx] = flush_subnormal(scores[idx]) > 0
    return mask, idx


def reissue_candidates(node: int, pools: list[str] | None, device: str,
                       n_nodes: int,
                       exclude: set[int] | frozenset | tuple = ()
                       ) -> list[int]:
    """Nodes eligible to take over work stuck on ``node`` (straggler
    re-issue, pool-aware).

    Same-pool peers come first: a straggling stage re-issues inside its
    own device pool. Crossing pools is allowed only when the backend's
    device permits it — a "cpu" backend runs anywhere (every node has
    host cores), while "gpu" work cannot leave the GPU pool; with no
    eligible peer the stuck task simply runs to completion. Without
    pools every other node is a peer.

    ``exclude`` removes nodes from the fleet *before* the same-pool
    short-circuit (the worker runtime passes its dead workers): if
    every same-pool peer is gone, CPU work still falls through to the
    cross-pool nodes instead of concluding no peer exists."""
    obs.metrics().count("sched.reissue_lookups")
    gone = set(exclude)
    gone.add(node)
    if pools is None:
        return [i for i in range(n_nodes) if i not in gone]
    same = [i for i in range(n_nodes)
            if i not in gone and pools[i] == pools[node]]
    if same:
        return same
    if device == "cpu":
        return [i for i in range(n_nodes) if i not in gone]
    obs.metrics().count("sched.reissue_no_peer")
    return []


def least_loaded(candidates: list[int], clocks) -> int:
    """The candidate with the smallest simulated clock (deterministic:
    ties break on node index via min's stable comparison order)."""
    return min(candidates, key=lambda i: (float(clocks[i]), i))


def expected_goodput(alpha: float, t_cheap: float, t_expensive: float,
                     router_cost: float = 0.0) -> float:
    """Docs/node-second of the adaptive strategy (amortized)."""
    per_doc = (1 - alpha) * t_cheap + alpha * t_expensive + router_cost
    return 1.0 / per_doc


# ---------------------------------------------------------------------------
# General m-parser greedy knapsack (reference / benchmark path)
# ---------------------------------------------------------------------------


def assign_parsers_greedy(pred_acc: np.ndarray, costs: np.ndarray,
                          budget: float,
                          devices: list[str] | None = None,
                          device_budgets: dict[str, float] | None = None
                          ) -> np.ndarray:
    """pred_acc (n, m), costs (m,) per-doc node-seconds, budget in
    node-seconds. Start everyone on the cheapest parser, then greedily buy
    the best accuracy-per-cost upgrades until the budget is exhausted.
    Returns assignment (n,) parser indices.

    Pool-aware mode: ``devices`` names each parser's device pool (len m,
    e.g. "cpu"/"gpu" per backends.BackendInfo.device) and
    ``device_budgets`` caps the node-seconds each pool may absorb. An
    upgrade must then fit the target parser's pool budget as well as the
    total budget — a small GPU pool bounds how much Nougat/Marker work
    the campaign can buy regardless of the overall budget (§5 / App. C).
    """
    n, m = pred_acc.shape
    cheapest = int(np.argmin(costs))
    assign = np.full(n, cheapest, np.int64)
    spent = n * costs[cheapest]
    pooled = devices is not None and device_budgets is not None
    if pooled:
        if len(devices) != m:
            raise ValueError(f"need {m} parser devices, got {len(devices)}")
        pool_spent = {d: 0.0 for d in devices}
        pool_spent[devices[cheapest]] = spent
    # candidate upgrades: (gain/extra_cost, doc, parser)
    gains = pred_acc - pred_acc[:, cheapest:cheapest + 1]
    extra = np.maximum(costs - costs[cheapest], 1e-12)[None, :]
    ratio = gains / extra
    order = np.dstack(np.unravel_index(np.argsort(-ratio, axis=None),
                                       ratio.shape))[0]
    cur_gain = np.zeros(n)
    for doc, p in order:
        if p == cheapest:
            continue
        g = gains[doc, p]
        if g <= cur_gain[doc]:
            continue
        cur = assign[doc]
        delta_cost = (costs[p] - costs[cur])
        if spent + delta_cost > budget:
            continue
        if pooled:
            refund = costs[cur] if devices[cur] == devices[p] else 0.0
            cap = device_budgets.get(devices[p], np.inf)
            if pool_spent[devices[p]] - refund + costs[p] > cap:
                continue
            pool_spent[devices[p]] += costs[p] - refund
            if devices[cur] != devices[p]:
                pool_spent[devices[cur]] -= costs[cur]
        spent += delta_cost
        assign[doc] = p
        cur_gain[doc] = g
    return assign


@dataclasses.dataclass
class BatchPlan:
    """One batch's routing decision."""

    expensive_idx: np.ndarray        # docs routed to the expensive parser
    cheap_idx: np.ndarray
    alpha_effective: float


# Minimum selection threshold: only documents with (strictly) positive
# predicted improvement are ever routed. Shared by the host mirror and
# the device op so both paths make identical decisions.
POSITIVE_TAU = 1e-12


def plan_batch(improvement: np.ndarray, alpha: float,
               require_positive: bool = True) -> BatchPlan:
    """Host-side numpy mirror of the fused device selection
    (``kernels.budget_route``): identical capacity, threshold, and
    tie-break semantics, so host and device choose the same documents.

    Rule: capacity = ⌊α·k⌋; τ = capacity-th largest score, clamped to
    ``POSITIVE_TAU`` (never route a non-improving doc). Every row with
    score > τ is selected (there are at most capacity−1 of them by
    definition of τ), then ties *at* τ fill the remaining slots in row
    order — so a strictly better document is never displaced by a tie,
    and ties resolve first-come exactly like the kernel's compaction.
    """
    improvement = np.asarray(improvement)
    k = len(improvement)
    capacity = capacity_floor(alpha, k)
    if capacity == 0:
        return BatchPlan(np.zeros(0, np.int64), np.arange(k), 0.0)
    kth = np.partition(improvement, k - capacity)[k - capacity]
    tau = max(kth, POSITIVE_TAU) if require_positive else kth
    gt = np.nonzero(improvement > tau)[0]
    eq = np.nonzero(improvement == tau)[0][:capacity - len(gt)]
    top = np.sort(np.concatenate([gt, eq]))
    cheap = np.setdiff1d(np.arange(k), top, assume_unique=False)
    return BatchPlan(top.astype(np.int64), cheap, len(top) / max(k, 1))
