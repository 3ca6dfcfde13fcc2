"""Mixture-of-experts FFN: the port of ``repro/models/moe.py``.

Two routers, as in the reference:

- ``topk``: token-choice softmax top-k with a per-expert capacity and
  sort-based dispatch (no (T, E, C) one-hot), plus the Switch
  load-balancing aux loss. OLMoE routes top-8 of 64, grok top-2 of 8.
- ``budget``: expert choice under a global slot budget: every expert
  takes its ⌊α·T⌋ highest-scoring tokens.

Routing is a function of ``(xt, probs)``: ``topk_dispatch`` and
``budget_select`` give its integers, so a test can feed both packages
the same probabilities and compare them exactly. The selections follow
``lax.top_k``: a stable descending sort of ``kernels/order``'s
total-order keys (``torch.topk`` fixes neither the order of ties nor the
rank of NaN), so ties go to the lower index.

The expert products are three batched matmuls (``_expert_ffn``), plain
products in the reference too. Every gather is ``F.embedding``, whose
backward sums repeated rows in a fixed order, and the combine adds each
token's contributions one at a time in ascending expert id from a zero
in the compute dtype: the order XLA's scatter-add adds them in, and no
atomics, so two runs on the card are bit-equal and a remat recompute
routes and sums exactly as the first pass did.

The dispatch (routing, sort and gathers), the expert products and the
combine run inside ``record_function`` ranges named ``moe.dispatch``,
``moe.experts`` and ``moe.combine``, so a profiler can split a
forward's device time by them.

Under mesh rules (``distributed/meshrules``) on a mesh of more than one
device, or with DTensor activations, ``moe_ffn`` runs ``_moe_shardmap``,
the reference's ``shard_map``: tokens on their data shard, expert
weights tensor-parallel on their ``d_ff`` over "model" ("expert
slicing"), ``_moe_local`` on each rank's local tensors, then one sum of
``y`` over "model" and the mean of ``aux`` over the data dims, as
functional collectives. The capacity is each data shard's own, as in
the reference, so a mesh with more than one data shard routes
differently from one device. The budget router on a mesh with a
"model" dim raises, as the reference's ``shard_map`` does (its partial
sums are never summed over "model"; ROADMAP §3).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.common import normal_init, param, unwrap
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.meshrules import (current_rules, is_dtensor,
                                               replicated)
from repro_torch.kernels.order import total_order_key
from repro_torch.models.layers import swiglu, torch_dtype

#: per-call routing records while ``routing_trace`` is open, else None
_TRACE: list | None = None


@contextlib.contextmanager
def routing_trace():
    """Record each ``moe_ffn`` call's routing while open: yields a list
    that gains, per call, ``{"eids" (T, k), "keep" (T, k) bool}`` for the
    top-k router and ``{"tok" (E, cap)}`` for the budget router, as
    tensors on the call's device."""
    global _TRACE
    prev, _TRACE = _TRACE, []
    try:
        yield _TRACE
    finally:
        _TRACE = prev


def moe_shapes(d_model: int, cfg: MoEConfig) -> dict:
    """name -> (per-layer shape, init std, logical axes) of one layer's
    experts, in the reference's order."""
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    return {
        "router": ((d_model, E), 1.0 / math.sqrt(d_model),
                   ("d_model", "experts")),
        "w_gate": ((E, d_model, Fe), 1.0 / math.sqrt(d_model),
                   ("experts", "d_model", "expert_ff")),
        "w_up": ((E, d_model, Fe), 1.0 / math.sqrt(d_model),
                 ("experts", "d_model", "expert_ff")),
        "w_down": ((E, Fe, d_model), 1.0 / math.sqrt(Fe),
                   ("experts", "expert_ff", "d_model")),
    }


@torch.no_grad()
def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype, layers: int | None = None,
             device=None, keep_axes: bool = False) -> dict:
    """Random expert params in ``dtype``, drawn in float32 from
    ``generator`` on ``device`` (the generator's own by default;
    ``init_lm`` passes the params', which may be ``meta``), with a
    leading ``layers`` axis when given; with ``keep_axes`` the ``Param``
    tree of their logical axes."""
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    dev = generator.device if device is None else device
    tree = {k: param(generator, lead + s, lax_ + axes, normal_init(std),
                     dtype, device=dev)
            for k, (s, std, axes) in moe_shapes(d_model, cfg).items()}
    return tree if keep_axes else unwrap(tree)


def _expert_ffn(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """buf (E, C, D) -> (E, C, D): SwiGLU through each expert's weights,
    three batched products."""
    g = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, p["w_up"].to(buf.dtype))
    return torch.bmm(swiglu(g, u), p["w_down"].to(buf.dtype))


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoEConfig):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux float32 scalar).
    Under rules of a mesh of more than one device, or on DTensors, the
    mesh branch (``_moe_shardmap``)."""
    rules = current_rules()
    if rules is not None and (rules.size > 1 or is_dtensor(x)):
        return _moe_shardmap(x, p, cfg, rules)
    b, s, d = x.shape
    y, aux = _moe_local(x.reshape(b * s, d), p, cfg)
    return y.reshape(b, s, d), aux


def _moe_shardmap(x: torch.Tensor, p: dict, cfg: MoEConfig, rules):
    """The reference's ``_moe_shardmap`` on DTensors: the tokens (B * S,
    D) laid out on ``tok_spec`` (sharded over the mesh's pod and data
    dims), ``router`` replicated and ``w_gate``/``w_up``/``w_down``
    sharded on their ``d_ff`` over "model" (the ``w_specs``), each as
    shard_map's ``in_specs`` lay them out; ``_moe_local`` on every
    rank's local tensors; ``y`` summed over "model" and ``aux``
    averaged over the data dims. Returns y as a DTensor on ``tok_spec``
    reshaped to (B, S, D) and aux replicated. On a mesh of one device
    there is nothing to send and this is ``_moe_local`` on the whole
    tensors."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, sizes = rules.mesh, rules.shape
    names = list(sizes)
    data_axes = [a for a in ("pod", "data") if a in sizes]
    has_model = "model" in sizes
    if cfg.router == "budget" and has_model and rules.size > 1:
        raise ValueError(
            "moe budget router on a mesh with a 'model' dim: its y is a "
            "partial sum over 'model' that is never summed, so shard_map's "
            "out_specs cannot be met (the reference raises the same)")
    b, s, d = x.shape
    t = b * s
    n_data = math.prod(sizes[a] for a in data_axes)
    if b % n_data:
        # batch-major tokens: a batch shard is then the token shard
        # shard_map's tok_spec gives (every cell's batch divides)
        raise ValueError(f"moe: batch {b} does not divide over the data "
                         f"dims {data_axes} ({n_data} shards)")

    def spec(shard: dict) -> list:
        return [Shard(shard[a]) if a in shard and sizes[a] > 1
                else Replicate() for a in names]

    def local(v, placements):
        v = replicated(v)
        return v.redistribute(mesh, placements).to_local() \
            if is_dtensor(v) else v

    tok = spec({a: 0 for a in data_axes})
    w_specs = {"router": spec({}), "w_gate": spec({"model": 2}),
               "w_up": spec({"model": 2}), "w_down": spec({"model": 1})}
    xt = local(x, tok).reshape(-1, d)
    y, aux = _moe_local(xt, {k: local(v, w_specs[k]) for k, v in p.items()},
                        cfg)
    if has_model and sizes["model"] > 1:
        y = funcol.wait_tensor(funcol.all_reduce(
            y, "sum", (mesh, names.index("model"))))
    if n_data > 1:
        for a in data_axes:
            if sizes[a] > 1:
                aux = funcol.wait_tensor(funcol.all_reduce(
                    aux, "sum", (mesh, names.index(a))))
        aux = aux / n_data
    y = DTensor.from_local(y, mesh, tok, run_check=False,
                           shape=torch.Size((t, d)), stride=(d, 1))
    aux = DTensor.from_local(aux, mesh, spec({}), run_check=False)
    return y.reshape(b, s, d), aux


def router_probs(xt: torch.Tensor, router: torch.Tensor,
                 cfg: MoEConfig) -> torch.Tensor:
    """xt (T, D) -> (T, E) float32 softmax of the router logits, which
    are computed in ``cfg.router_dtype`` from xt cast to it."""
    rdt = torch_dtype(cfg.router_dtype)
    logits = xt.to(rdt) @ router.to(rdt)
    return torch.softmax(logits.float(), dim=-1)


def _moe_local(xt: torch.Tensor, p: dict, cfg: MoEConfig):
    probs = router_probs(xt, p["router"], cfg)
    if cfg.router == "budget":
        return _budget_route(xt, probs, p, cfg)
    return _topk_route(xt, probs, p, cfg)


# ---------------------------------------------------------------------------
# Token-choice top-k (sort-based dispatch)
# ---------------------------------------------------------------------------


def topk_dispatch(probs: torch.Tensor, cfg: MoEConfig) -> dict:
    """The top-k router's integers for probs (T, E): ``eids`` (T, k) in
    ``lax.top_k`` order, ``order`` the stable sort of the flat expert
    ids, and in that sorted order the expert ``se``, token ``st``,
    ``slot`` (``cap`` for an overflow), ``keep`` and the flat buffer
    ``rows``; also ``counts`` (E,), ``starts`` (E,) and ``cap``, the
    slots an expert: ``ceil_div(int(capacity_factor * T * k), E)``, at
    least 1, with the reference's truncation by ``int()``."""
    t, E = probs.shape
    k = cfg.top_k
    cap = max(-(-int(cfg.capacity_factor * t * k) // E), 1)
    eids = torch.sort(total_order_key(probs), dim=-1, descending=True,
                      stable=True).indices[:, :k]
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")
    if flat_e.is_meta:
        # bincount's length depends on the ids; a meta run (the dry run)
        # counts them with a scatter of ones into E slots, the same shape
        counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device
                             ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    else:
        counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=probs.device) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    return {"eids": eids, "order": order, "se": se, "st": st,
            "slot": slot, "keep": keep, "rows": se * (cap + 1) + slot,
            "counts": counts, "starts": starts, "cap": cap}


def combine_topk(contrib: torch.Tensor, st: torch.Tensor, t: int,
                 k: int) -> torch.Tensor:
    """``zeros((t, D)).at[st].add(contrib)`` as XLA adds it: each
    token's k contributions (in ``st``'s order, which after the stable
    sort is ascending expert id) one at a time from a zero, rounding in
    contrib's dtype at each add. A fixed order and no atomics."""
    grouped = contrib[torch.argsort(st, stable=True)].reshape(t, k, -1)
    y = torch.zeros((t, contrib.shape[-1]), dtype=contrib.dtype,
                    device=contrib.device)
    for m in range(k):
        y = y + grouped[:, m]
    return y


def _topk_route(xt: torch.Tensor, probs: torch.Tensor, p: dict,
                cfg: MoEConfig):
    t, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    with record_function("moe.dispatch"):
        r = topk_dispatch(probs, cfg)
        cap, eids = r["cap"], r["eids"]
        if _TRACE is not None:
            keep = torch.empty_like(r["keep"])
            keep[r["order"]] = r["keep"]
            _TRACE.append({"eids": eids, "keep": keep.reshape(t, k)})

        gate = probs.gather(1, eids)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        sg = gate.reshape(-1)[r["order"]]

        # buf[e, j] is the j-th token routed to e (j < min(count_e,
        # cap)): the reference's scatter into an (E, cap + 1) buffer,
        # read here as a gather of the sorted tokens
        j = torch.arange(cap, device=xt.device)
        src = r["starts"][:, None] + j[None, :]
        filled = j[None, :] < r["counts"][:, None]
        tok = r["st"][src.clamp(max=t * k - 1)]
        buf = torch.where(filled[..., None], F.embedding(tok, xt),
                          torch.zeros((), dtype=xt.dtype, device=xt.device))

    with record_function("moe.experts"):
        out_buf = _expert_ffn(buf, p)                        # (E, cap, D)
    with record_function("moe.combine"):
        out_flat = torch.cat([out_buf, out_buf.new_zeros((E, 1, d))],
                             dim=1).reshape(E * (cap + 1), d)
        contrib = F.embedding(r["rows"], out_flat) \
            * (sg * r["keep"])[:, None].to(out_buf.dtype)
        y = combine_topk(contrib, r["st"], t, k)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    f = r["counts"].float() / (t * k)
    aux = cfg.aux_loss_weight * E * torch.sum(f * probs.mean(0))
    return y, aux


# ---------------------------------------------------------------------------
# Budget (expert choice with a global slot budget)
# ---------------------------------------------------------------------------


def budget_select(probs: torch.Tensor, cfg: MoEConfig):
    """The budget router's choice for probs (T, E): each expert's top
    ``cap = max(int(budget_alpha * T), 1)`` tokens, ``lax.top_k`` order
    over its column -> (gates (E, cap) float32, tok (E, cap))."""
    t = probs.shape[0]
    cap = max(int(cfg.budget_alpha * t), 1)
    scores = probs.T
    tok = torch.sort(total_order_key(scores), dim=-1, descending=True,
                     stable=True).indices[:, :cap]
    return scores.gather(1, tok), tok


def combine_budget(upd: torch.Tensor, tok: torch.Tensor,
                   t: int) -> torch.Tensor:
    """``zeros((t, D)).at[tok.reshape(-1)].add(upd.reshape(-1, D))`` in
    XLA's order: one expert at a time in ascending id. An expert's
    tokens are distinct, so each step is a gather, an add and a put
    with unique indices."""
    y = torch.zeros((t, upd.shape[-1]), dtype=upd.dtype,
                    device=upd.device)
    for e in range(tok.shape[0]):
        y = y.index_put((tok[e],), y[tok[e]] + upd[e])
    return y


def _budget_route(xt: torch.Tensor, probs: torch.Tensor, p: dict,
                  cfg: MoEConfig):
    t = xt.shape[0]
    g, tok = budget_select(probs, cfg)
    if _TRACE is not None:
        _TRACE.append({"tok": tok})
    buf = F.embedding(tok, xt)                               # (E, cap, D)
    out_buf = _expert_ffn(buf, p)
    y = combine_budget(out_buf * g[..., None].to(out_buf.dtype), tok, t)
    # budget routing is balanced by construction; aux regularizes entropy
    aux = cfg.aux_loss_weight * torch.mean(
        torch.sum(probs * torch.log(torch.clamp(probs, min=1e-9)), dim=-1))
    return y, aux
