"""Cell factory: (arch x shape) -> a step function and its inputs, the
port of ``repro/launch/specs.py`` on one card.

``build_cell`` gives every (arch, shape) pair of ``all_cells`` as a
``Cell``: its step (train, prefill, decode or serve) and the step's
arguments (params, optimizer state, the step as a 0-d int32 tensor,
batches, caches). ``abstract=True`` builds every argument on
``torch.device("meta")``, where the reference builds
``jax.ShapeDtypeStruct``s, so a full-size cell allocates nothing (the
optimizer state is ``opt.init`` of the meta params, where the reference
takes ``jax.eval_shape`` of it);
``abstract=False`` builds them on ``device`` (cuda unless "cpu"), with
the reference's batches bit for bit (both draw them from numpy
``RandomState(seed)``) and params from a generator seeded with ``seed``
(JAX's PRNG is not reproduced: tests carry the reference's params
across with the ``*_from_jax_params`` functions). Given ``rules`` (a
``distributed/meshrules.AxisRules``), a cell carries the reference's
``in_shardings``: a tree of ``meshrules.NamedSharding`` matching its
arguments (params from the inits' logical axes, the optimizer state
from ``_opt_state_shardings``, the batch from ``_batch_shardings``, the
step and position replicated), and ``place_args`` lays its arguments
out on the mesh as DTensors, on which a forward cell's step runs under
``meshrules.use_rules`` (a train cell's waits for the mesh's backward).
A meta argument stands for a value its step reads on the host (a
decode position, the step number) by the concrete cell's value
(``_host_int``).

Params are dict trees (a recsys MLP is a list of layer dicts; the
router's ``Encoder`` module is carried as the JAX package's raw dict,
``router_param_tree``); the optimizers take lists of tensors.
``lm_param_leaves``, ``gnn_param_leaves``, ``recsys_param_leaves``,
``vit_parser_param_leaves`` and ``router_param_leaves`` give the leaves
in the order ``jax.tree_util.tree_leaves`` gives the reference's params
(sorted keys, lists in index order), so the optimizer state, the global
norm and the checkpoint line up with the JAX package's leaf for leaf,
and ``opt_state_from_jax`` carries a JAX run's optimizer state across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.common import (Param, default_generator, is_param,
                                tree_map, unwrap)
from repro_torch.common import tree_leaves as _tree_leaves
from repro_torch.configs.base import (ArchConfig, EncoderConfig, GNNConfig,
                                      LMConfig, RecsysConfig, ShapeConfig,
                                      VitParserConfig, get_config, round_up)
from repro_torch.core.dpo import dpo_loss
from repro_torch.core.router import make_route_step
from repro_torch.distributed.meshrules import (AxisRules, NamedSharding,
                                               from_local, is_dtensor)
from repro_torch.models import vit_parser as vp_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.encoder import Encoder, _named_params, init_encoder
from repro_torch.models.encoder import param_axes as encoder_param_axes
from repro_torch.models.gnn import sampler as sampler_lib
from repro_torch.models.gnn.equiformer import equiformer_loss, init_equiformer
from repro_torch.models.gnn.so3 import n_coeff_full
from repro_torch.models.layers import from_numpy, torch_dtype
from repro_torch.models.recsys.models import (init_recsys, recsys_loss,
                                              recsys_retrieval,
                                              recsys_scores)
from repro_torch.models.transformer import (decode_step, init_lm, lm_loss,
                                            prefill)
from repro_torch.models.vit_parser import init_vit_parser, parser_loss
from repro_torch.optim import adafactor, adamw, apply_updates, chain_clip


def _optimizer_for(arch: ArchConfig):
    if arch.arch_id.startswith("grok"):
        return adafactor(1e-4), "adafactor"
    return chain_clip(adamw(3e-4, weight_decay=0.1), 1.0), "adamw"


def _reduce_shape(family: str, shape: ShapeConfig) -> ShapeConfig:
    """Shrink a workload cell for CPU runs (same kind), as the JAX
    function does; a family it has no branch for keeps its shape."""
    d = dict(shape.dims)
    if family in ("lm", "encoder", "vit_parser"):
        if "seq_len" in d:
            d["seq_len"] = min(d["seq_len"], 64)
        if "global_batch" in d:
            d["global_batch"] = min(d["global_batch"], 4)
        if "dec_len" in d:
            d["dec_len"] = min(d["dec_len"], 16)
    elif family == "gnn":
        scale = {"full_graph_sm": dict(n_nodes=64, n_edges=256, d_feat=16),
                 "minibatch_lg": dict(n_nodes=0, n_edges=0, batch_nodes=8,
                                      fanout0=3, fanout1=2),
                 "ogb_products": dict(n_nodes=128, n_edges=512, d_feat=16),
                 "molecule": dict(n_nodes=6, n_edges=12, batch=4)}
        d.update(scale[shape.name])
    elif family == "recsys":
        if "batch" in d:
            d["batch"] = min(d["batch"], 16)
        if "n_candidates" in d:
            d["n_candidates"] = min(d["n_candidates"], 64)
    return ShapeConfig(shape.name, shape.kind, d, shape.note)


def lm_param_leaves(params: dict) -> list[torch.Tensor]:
    """The LM's leaves in ``jax.tree_util.tree_leaves`` order."""
    return _tree_leaves(params)


def gnn_param_leaves(params: dict) -> list[torch.Tensor]:
    """Equiformer's leaves in ``jax.tree_util.tree_leaves`` order:
    ``embed_w``, the stacked ``layers`` leaves by sorted name, then
    ``out_w1``, ``out_w2``."""
    return _tree_leaves(params)


def recsys_param_leaves(params: dict) -> list[torch.Tensor]:
    """A recsys model's leaves in ``jax.tree_util.tree_leaves`` order:
    sorted keys, an MLP's layers in index order."""
    return _tree_leaves(params)


def vit_parser_param_leaves(params: dict) -> list[torch.Tensor]:
    """The ViT parser's leaves in ``jax.tree_util.tree_leaves`` order:
    ``dec_layers`` and ``enc_layers`` (each's stacked leaves by sorted
    name) between the sorted top-level leaves."""
    return _tree_leaves(params)


def router_param_tree(enc: Encoder) -> dict:
    """The encoder's tensors as the JAX package's raw dict, on its
    device and in its dtype: the top-level leaves by name and the layers'
    stacked on a leading axis under ``"layers"`` (copies)."""
    tree: dict = {}
    per_layer: dict = {}
    for name, i, prm in _named_params(enc):
        if i is None:
            tree[name] = prm.detach().clone()
        else:
            per_layer.setdefault(name, []).append(prm.detach())
    tree["layers"] = {k: torch.stack(v) for k, v in per_layer.items()}
    return tree


def init_router_params(cfg: EncoderConfig,
                       generator: torch.Generator | None = None,
                       device=None, keep_axes: bool = False) -> dict:
    """``init_encoder``'s params as ``router_param_tree``: its weights are
    drawn on the CPU from a generator seeded with ``generator``'s seed
    (0 by default), then put on ``device`` (cuda unless "cpu"). With
    ``keep_axes`` the ``Param`` tree of their logical axes
    (``encoder.param_axes``)."""
    seed = 0 if generator is None else generator.initial_seed()
    tree = router_param_tree(init_encoder(
        cfg, torch.Generator().manual_seed(seed),
        device_lib.resolve(device)))
    if not keep_axes:
        return tree
    return tree_map(lambda t, axes: Param(t, axes), tree,
                    encoder_param_axes(cfg))


def router_param_leaves(params: dict) -> list[torch.Tensor]:
    """The router's leaves in ``jax.tree_util.tree_leaves`` order."""
    return _tree_leaves(params)


def opt_state_from_jax(raw_state: dict, params: dict, kind: str) -> dict:
    """The JAX package's optimizer state (numpy leaves) for an LM's, a
    GNN's or a recsys model's params -> the port's: AdamW's ``{"m",
    "v"}`` trees as lists, or Adafactor's ``{"v": tree of {"vr", "vc"}
    | {"v"}}`` as a list of dicts, each leaf a float32 tensor on the
    params' device.
    Raises on a leaf whose count or shape does not match the params."""
    leaves = _tree_leaves(params)
    dev = leaves[0].device

    def take(states, shapes_of):
        """Per-leaf dicts of float32 tensors, shapes checked."""
        if len(states) != len(leaves):
            raise ValueError(f"{kind} state: {len(states)} leaves for "
                             f"{len(leaves)} params")
        out = []
        for st, p in zip(states, leaves):
            want = shapes_of(tuple(p.shape), st)
            got = {k: tuple(np.shape(a)) for k, a in st.items()}
            if got != want:
                raise ValueError(f"{kind} state {got} for a param of "
                                 f"shape {tuple(p.shape)}: want {want}")
            out.append({k: from_numpy(a).to(device=dev, dtype=torch.float32)
                        for k, a in st.items()})
        return out

    if kind == "adamw":
        states = take([{"m": m, "v": v} for m, v in zip(
            _tree_leaves(raw_state["m"]), _tree_leaves(raw_state["v"]))],
            lambda shape, st: {"m": shape, "v": shape})
        return {name: [st[name] for st in states] for name in ("m", "v")}
    if kind == "adafactor":
        states = _tree_leaves(raw_state["v"], lambda x: isinstance(x, dict)
                              and ("v" in x or "vr" in x))
        return {"v": take(states, lambda shape, st: (
            {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
            if "vr" in st else {"v": shape}))}
    raise ValueError(f"unknown optimizer kind {kind!r}")


def _lm_train_batch(cfg: LMConfig, b: int, s: int, seed: int = 0,
                    device=None) -> dict:
    """A copy of the JAX train cell's concrete batch: numpy
    ``RandomState(seed)`` draws (b, s + 1) int32 tokens, split into
    tokens and next-token labels. Tensors on ``device`` (cuda unless
    "cpu")."""
    dev = device_lib.resolve(device)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def _nougat_batch(cfg: VitParserConfig, shape: ShapeConfig, seed: int = 0,
                  device=None) -> dict:
    """A copy of the JAX ``_nougat_cell``'s ``train_pages`` batch:
    ``patches`` (b, n_patches, patch * patch * 3) from numpy
    ``RandomState(seed).randn``, rounded once to the compute dtype, and
    zero int32 ``tokens`` of length ``min(dec_len, max_dec_len)``, which
    are also the ``labels``. Tensors on ``device`` (cuda unless "cpu")."""
    dev = device_lib.resolve(device)
    b, t = shape["global_batch"], min(shape["dec_len"], cfg.max_dec_len)
    toks = torch.zeros((b, t), dtype=torch.int32, device=dev)
    return {"patches": _nougat_patches(cfg, b, seed, dev),
            "tokens": toks, "labels": toks}


def _nougat_patches(cfg: VitParserConfig, b: int, seed: int = 0,
                    device=None) -> torch.Tensor:
    """The JAX ``_nougat_cell``'s page patches: (b, n_patches, patch *
    patch * 3) from numpy ``RandomState(seed).randn``, rounded once to
    the compute dtype, on ``device`` (cuda unless "cpu")."""
    patches = np.random.RandomState(seed).randn(
        b, cfg.n_patches, cfg.patch * cfg.patch * 3)
    return torch.from_numpy(patches).to(torch_dtype(cfg.compute_dtype)).to(
        device_lib.resolve(device))


def _router_batch(cfg: EncoderConfig, shape: ShapeConfig, seed: int = 0,
                  device=None) -> dict:
    """A copy of the JAX ``_router_cell``'s ``sft_4k`` batch: int32
    ``tokens`` ``randint(2, vocab)`` from numpy ``RandomState(seed)``,
    of length ``min(seq_len, max_len)``, an all-ones float32 ``mask``
    and float32 ``targets`` of 0.5 for each of the ``n_outputs``
    parsers. Tensors on ``device`` (cuda unless "cpu")."""
    dev = device_lib.resolve(device)
    b, s = shape["global_batch"], min(shape["seq_len"], cfg.max_len)
    toks = np.random.RandomState(seed).randint(2, cfg.vocab_size, (b, s))
    return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev),
            "mask": torch.ones((b, s), dtype=torch.float32, device=dev),
            "targets": torch.full((b, cfg.n_outputs), 0.5,
                                  dtype=torch.float32, device=dev)}


def _host_int(t: torch.Tensor, meta_value: int) -> int:
    """A 0-d tensor's value on the host; a meta tensor has none and
    stands for ``meta_value`` (the concrete cell's), which changes no
    shape of the step."""
    if isinstance(t, torch.Tensor) and t.is_meta:
        return meta_value
    return int(t)


def _update(opt, leaves, grads, opt_state, step):
    """One update of ``opt`` applied to ``leaves`` in place."""
    updates, opt_state = opt.update(list(grads), opt_state, leaves,
                                    _host_int(step, 0))
    apply_updates(leaves, updates)
    return opt_state


def _train_step(loss_fn, leaves_of, opt):
    def train_step(params, opt_state, step, batch):
        leaves = leaves_of(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, _ = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        opt_state = _update(opt, leaves, grads, opt_state, step)
        return params, opt_state, loss.detach()

    return train_step


def lm_train_step(cfg: LMConfig, opt):
    """``(params, opt_state, step, batch) -> (params, opt_state, loss)``:
    the gradient of ``lm_loss`` with respect to every leaf, one optimizer
    update (``step`` a host int), applied to the params in place. It runs
    where the params and the batch are (``init_lm`` and
    ``_lm_train_batch`` put them on cuda unless asked for "cpu")."""
    return _train_step(lambda p, b: lm_loss(p, cfg, b), lm_param_leaves, opt)


def vit_parser_train_step(cfg: VitParserConfig, opt):
    """The ViT parser's ``train_pages`` step, as ``lm_train_step`` is the
    LM's: the gradient of ``parser_loss`` with respect to every leaf, one
    update of ``opt`` (``_optimizer_for``: ``chain_clip(adamw(3e-4, wd
    0.1), 1.0)``), applied in place."""
    return _train_step(lambda p, b: parser_loss(p, cfg, b),
                       vit_parser_param_leaves, opt)


def _encoder_of(encoders: dict, cfg: EncoderConfig, params: dict,
                slot: int = 0) -> Encoder:
    """An ``Encoder`` on the tree's device (one kept per device and
    ``slot`` in ``encoders``) holding a copy of ``router_param_tree``
    params; DTensor params are bound as its parameters, not copied
    (a plain parameter cannot hold a DTensor's value)."""
    if is_dtensor(params["tok_embed"]):
        enc = Encoder(cfg, "meta")
        for name, i, _ in list(_named_params(enc)):
            owner = enc if i is None else enc.layers[i]
            owner.p[name] = torch.nn.Parameter(
                params[name] if i is None else params["layers"][name][i],
                requires_grad=False)
        return enc
    dev = params["tok_embed"].device
    if (dev, slot) not in encoders:
        encoders[dev, slot] = Encoder(cfg, dev)
    enc = encoders[dev, slot]
    with torch.no_grad():
        for name, i, prm in _named_params(enc):
            prm.copy_(params[name] if i is None
                      else params["layers"][name][i])
    return enc


def _router_update(opt, enc: Encoder, params: dict, loss_of, opt_state,
                   step):
    """Differentiate ``loss_of(enc)`` with respect to the encoder's
    parameters, stack each per-layer leaf's gradients as the tree stacks
    the leaf (a parameter the loss does not reach gets none: a zero
    gradient that still decays), apply one update of ``opt`` to the
    tree in place; returns (opt_state, loss)."""
    named = list(_named_params(enc))
    prms = [prm for _, _, prm in named]
    for p in prms:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_of(enc)
            grads = torch.autograd.grad(loss, prms, allow_unused=True)
    finally:
        for p in prms:
            p.requires_grad_(False)
    grad_tree: dict = {}
    per_layer: dict = {}
    for (name, i, _), g in zip(named, grads):
        if i is None:
            grad_tree[name] = g
        else:
            per_layer.setdefault(name, []).append(g)
    grad_tree["layers"] = {k: torch.stack(gs)
                           for k, gs in per_layer.items()}
    opt_state = _update(opt, router_param_leaves(params),
                        router_param_leaves(grad_tree), opt_state, step)
    return opt_state, loss.detach()


def router_train_step(cfg: EncoderConfig, opt):
    """The router's ``sft_4k`` step on ``router_param_tree`` params:
    the tree's values are copied into an ``Encoder`` on the params'
    device, ``Encoder.regression_loss`` is differentiated with respect to
    its parameters (the preference head, which the loss does not reach,
    gets a zero gradient that still decays), and one update of ``opt``
    is applied to the tree in place."""
    encoders: dict = {}

    def train_step(params, opt_state, step, batch):
        enc = _encoder_of(encoders, cfg, params)
        opt_state, loss = _router_update(
            opt, enc, params, lambda e: e.regression_loss(batch), opt_state,
            step)
        return params, opt_state, loss

    return train_step


def router_dpo_step(cfg: EncoderConfig, opt):
    """The router's ``dpo_*`` step ``(params, ref_params, opt_state,
    step, batch) -> (params, opt_state, loss)``, the reference's
    five-argument step: ``core/dpo.dpo_loss`` of the params against the
    frozen ``ref_params`` (both ``router_param_tree``s), differentiated
    with respect to the params only, one update of ``opt`` applied to
    them in place."""
    encoders: dict = {}

    def train_step(params, ref_params, opt_state, step, batch):
        enc = _encoder_of(encoders, cfg, params)
        ref = _encoder_of(encoders, cfg, ref_params, slot=1)
        opt_state, loss = _router_update(
            opt, enc, params, lambda e: dpo_loss(e, ref, batch), opt_state,
            step)
        return params, opt_state, loss

    return train_step


def router_route_step(cfg: EncoderConfig, alpha: float):
    """The router's ``route_*`` step ``(params, tokens, mask,
    valid_logit) -> dict``: ``core/router.make_route_step(alpha)`` (the
    encoder, then the ``budget_route`` kernel) on an ``Encoder`` holding
    the ``router_param_tree`` params."""
    encoders: dict = {}
    route = make_route_step(alpha)

    def route_step(params, tokens, mask, valid_logit):
        return route(_encoder_of(encoders, cfg, params), tokens, mask,
                     valid_logit)

    return route_step


def gnn_train_step(cfg: GNNConfig, opt):
    """The GNN train cell's step, as ``lm_train_step`` is the LM's: the
    gradient of ``equiformer_loss`` with respect to every leaf, one update
    of ``opt`` (``_optimizer_for``: ``chain_clip(adamw(3e-4, wd 0.1),
    1.0)``), applied in place. ``cfg`` is the cell's (``gnn_cell_config``)."""
    return _train_step(lambda p, b: equiformer_loss(p, cfg, b),
                       gnn_param_leaves, opt)


def recsys_train_step(cfg: RecsysConfig, opt):
    """The recsys train cell's step, as ``lm_train_step`` is the LM's:
    the gradient of ``recsys_loss`` with respect to every leaf (the
    tables' through ``embedding_bag_backward`` on the card), one update
    of ``opt`` (``_optimizer_for``: ``chain_clip(adamw(3e-4, wd 0.1),
    1.0)``), applied in place."""
    return _train_step(lambda p, b: recsys_loss(p, cfg, b),
                       recsys_param_leaves, opt)


def recsys_retrieval_step(cfg: RecsysConfig, shape: ShapeConfig):
    """The retrieval cell's step ``(params, batch) -> (scores, ids)``,
    with the cell's ``n_cand = min(n_candidates, rows)`` (unpadded
    rows) and ``k = min(100, n_cand)``; returns (step, n_cand)."""
    n_cand = min(shape["n_candidates"], int(sum(cfg.vocab_sizes)))
    k_top = min(100, n_cand)

    def retrieval_step(params, batch):
        return recsys_retrieval(params, cfg, dict(batch, n_candidates=n_cand),
                                k=k_top)

    return retrieval_step, n_cand


def _retrieval_query(cfg: RecsysConfig, b: int, seed: int = 0,
                     device=None) -> dict:
    """The retrieval cell's batch: ``user_query`` (b, D) float32 from
    numpy ``RandomState(seed).randn``."""
    q = np.random.RandomState(seed).randn(b, cfg.embed_dim).astype(
        np.float32)
    return {"user_query": torch.from_numpy(q).to(device_lib.resolve(device))}


def _recsys_batch(cfg: RecsysConfig, b: int, seed: int = 0,
                  device=None) -> dict:
    """A copy of the JAX function's concrete branch: numpy
    ``RandomState(seed)``, uniform ids per field (int32), labels with
    P(1) = 0.3, standard normal dense features; DIEN adds the history.
    Returns tensors on ``device`` (cuda unless "cpu")."""
    dev = device_lib.resolve(device)
    rng = np.random.RandomState(seed)
    sparse = np.stack([rng.randint(0, v, b) for v in cfg.vocab_sizes], 1)
    batch = {"sparse": sparse.astype(np.int32),
             "labels": (rng.rand(b) < 0.3).astype(np.float32)}
    if cfg.kind == "dlrm":
        batch["dense"] = rng.randn(b, cfg.n_dense).astype(np.float32)
    if cfg.kind == "dien":
        t = cfg.seq_len
        v0, v1 = cfg.vocab_sizes[0], sum(cfg.vocab_sizes)
        batch.update(
            hist=rng.randint(0, v0, (b, t)).astype(np.int32),
            hist_cat=rng.randint(v0, v1, (b, t)).astype(np.int32),
            hist_mask=np.ones((b, t), np.float32),
            target=rng.randint(0, v0, b).astype(np.int32),
            target_cat=rng.randint(v0, v1, b).astype(np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_DATASETS = {
    # shape -> (d_in, n_out, classification?)
    "full_graph_sm": (1433, 7, True),        # Cora
    "minibatch_lg": (602, 41, True),         # Reddit (sampled)
    "ogb_products": (100, 47, True),         # ogbn-products
    "molecule": (16, 1, False),              # batched small molecules
}


def _gnn_dims(shape: ShapeConfig) -> tuple[int, int]:
    """(nodes, edges) of a GNN train cell: the static sampler's counts
    for ``minibatch_lg``, ``batch`` molecules for ``molecule``, else the
    graph's counts padded to a multiple of 512 (the padding edges are
    zero-length self-loops, which the model drops)."""
    if shape.name == "minibatch_lg":
        fan = [shape["fanout0"], shape["fanout1"]]
        return (sampler_lib.static_node_count(shape["batch_nodes"], fan),
                sampler_lib.static_edge_count(shape["batch_nodes"], fan))
    if shape.name == "molecule":
        return (shape["n_nodes"] * shape["batch"],
                shape["n_edges"] * shape["batch"])
    return (round_up(shape["n_nodes"], 512), round_up(shape["n_edges"], 512))


def gnn_cell_config(arch: ArchConfig, shape: ShapeConfig) -> GNNConfig:
    """The model config of a GNN train cell: the arch's with the
    dataset's input width and output count."""
    d_in, n_out, _ = GNN_DATASETS[shape.name]
    return dataclasses.replace(arch.model, d_in=d_in, n_out=n_out)


def gnn_one_card_bytes(cfg: GNNConfig, shape: ShapeConfig) -> dict:
    """What one step of the cell must hold, in bytes at the compute
    dtype: one node state (N, (l_max+1)^2, C), one edge tensor (E,
    (l_max+1)^2, C), and the remat checkpoints (one node state a
    layer)."""
    n, e = _gnn_dims(shape)
    el = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    row = n_coeff_full(cfg.l_max) * cfg.d_hidden * el
    return {"n_nodes": n, "n_edges": e, "node_state": n * row,
            "edge_tensor": e * row, "checkpoints": cfg.n_layers * n * row}


def gnn_refusal(cfg: GNNConfig, shape: ShapeConfig,
                card_bytes: float = 80e9) -> str | None:
    """Why the cell cannot train on one card, or None: one edge tensor
    or the layer checkpoints alone beyond the card's memory (the
    reference shards such a graph over a mesh)."""
    b = gnn_one_card_bytes(cfg, shape)
    if max(b["edge_tensor"], b["checkpoints"]) <= card_bytes:
        return None
    return (f"{shape.name}: N = {b['n_nodes']:,}, E = {b['n_edges']:,}: one "
            f"(E, {n_coeff_full(cfg.l_max)}, {cfg.d_hidden}) "
            f"{cfg.compute_dtype} edge tensor is "
            f"{b['edge_tensor'] / 1e9:.0f} GB and the node state "
            f"{b['node_state'] / 1e9:.1f} GB ({b['checkpoints'] / 1e9:.0f} "
            f"GB for the {cfg.n_layers} remat checkpoints), beyond one "
            f"{card_bytes / 1e9:.0f} GB card; the reference shards it over "
            f"a mesh; launch/dryrun.py reckons what it needs a device, and "
            f"running it on one waits for ROADMAP.md item 13e-4b")


def _gnn_batch(shape: ShapeConfig, seed: int = 0, device=None) -> dict:
    """A copy of the JAX GNN train cell's concrete batch
    (``gnn_batch_arrays``) as tensors on ``device`` (cuda unless "cpu"),
    with ``n_graphs`` an int for ``molecule``."""
    dev = device_lib.resolve(device)
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in gnn_batch_arrays(shape, seed).items()}


def gnn_batch_arrays(shape: ShapeConfig, seed: int = 0) -> dict:
    """The JAX GNN train cell's concrete batch as numpy arrays (host
    work only): ``RandomState(seed)`` draws pos (N, 3), src and dst (E,)
    int32, node_feat (N, d_in) and the labels ((N,) int32 classes, or
    (batch, 1) float32 targets for ``molecule``, which adds
    ``graph_ids`` (N,) and ``n_graphs``), in the reference's order."""
    d_in, n_out, is_cls = GNN_DATASETS[shape.name]
    n, e = _gnn_dims(shape)
    mol = shape.name == "molecule"
    lbl_shape = (shape["batch"], n_out) if mol else (n,)
    rng = np.random.RandomState(seed)
    batch = {"pos": rng.randn(n, 3).astype(np.float32),
             "src": rng.randint(0, n, e).astype(np.int32),
             "dst": rng.randint(0, n, e).astype(np.int32),
             "node_feat": rng.randn(n, d_in).astype(np.float32),
             "labels": (rng.randint(0, n_out, lbl_shape).astype(np.int32)
                        if is_cls else
                        rng.randn(*lbl_shape).astype(np.float32))}
    if mol:
        batch["graph_ids"] = np.repeat(
            np.arange(shape["batch"], dtype=np.int32), shape["n_nodes"])
        batch["n_graphs"] = shape["batch"]
    return batch


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                         # train | prefill | decode | serve
    fn: Callable
    args: tuple                       # on meta (abstract) or concrete
    in_shardings: Any = None          # NamedSharding tree, given rules
    donate_argnums: tuple = ()        # the args the step may overwrite
    note: str = ""


def _opt_state_shardings(rules, params, kind: str):
    """The optimizer state's shardings, in the port's state layout (a
    list a param in ``tree_leaves`` order): AdamW's moments take the
    param's ZeRO spec (its spec plus ``data`` on the first free divisible
    dim); Adafactor's factored rows and columns take the spec of the
    param's axes without the last or the second last dim, an unfactored
    leaf the ZeRO spec. ``params`` is the Param tree."""
    if rules is None:
        return None
    leaves = _tree_leaves(params, is_param)
    if kind == "adamw":
        t = [rules.zero_sharding_for(p.axes, p.shape) for p in leaves]
        return {"m": t, "v": list(t)}

    def leaf(p):
        shp = p.shape
        if len(shp) >= 2 and shp[-1] >= 128 and shp[-2] >= 128:
            return {"vr": rules.sharding_for(p.axes[:-1], shp[:-1]),
                    "vc": rules.sharding_for(p.axes[:-2] + p.axes[-1:],
                                             shp[:-2] + shp[-1:])}
        return {"v": rules.zero_sharding_for(p.axes, shp)}

    return {"v": [leaf(p) for p in leaves]}


def _batch_shardings(rules, axes_map: dict, batch: dict):
    """Each batch leaf's sharding by its logical axes in ``axes_map``."""
    if rules is None:
        return None
    return {k: rules.sharding_for(axes_map[k], tuple(v.shape))
            for k, v in batch.items()}


def _train_shardings(rules, params, kind: str, axes_map: dict, batch: dict,
                     frozen: bool = False):
    """A train step's ``in_shardings``: (params, [frozen params,]
    optimizer state, step, batch)."""
    if rules is None:
        return None
    p_sh = rules.param_shardings(params)
    return ((p_sh,) + ((p_sh,) if frozen else ())
            + (_opt_state_shardings(rules, params, kind),
               rules.sharding_for((), ()),
               _batch_shardings(rules, axes_map, batch)))


def _cell_device(abstract: bool, device) -> torch.device:
    return torch.device("meta") if abstract else device_lib.resolve(device)


def _sds(shape, dtype) -> torch.Tensor:
    """The shape and dtype of an argument, on meta."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _step0(dev: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def _meta_batch(spec: dict) -> dict:
    return {k: _sds(shape, dtype) for k, (shape, dtype) in spec.items()}


def _train_batch(arch: ArchConfig, shape: ShapeConfig, seed: int,
                 device) -> dict:
    """A train cell's concrete batch, the builder the cell and each step
    of ``launch/train.py`` (at ``seed = step + 1``) share: the GNN
    cell's without ``n_graphs``, which its step adds."""
    cfg = arch.model
    if arch.family == "lm":
        return _lm_train_batch(cfg, shape["global_batch"], shape["seq_len"],
                               seed, device)
    if arch.family == "gnn":
        return {k: v for k, v in _gnn_batch(shape, seed, device).items()
                if k != "n_graphs"}
    if arch.family == "recsys":
        return _recsys_batch(cfg, shape["batch"], seed, device)
    if arch.family == "vit_parser":
        return _nougat_batch(cfg, shape, seed, device)
    if arch.family == "encoder" and shape.name.startswith("sft"):
        return _router_batch(cfg, shape, seed, device)
    raise ValueError(f"{arch.arch_id}/{shape.name}: no train batch")


def _lm_train_cell(arch: ArchConfig, shape: ShapeConfig, rules, abstract,
                   seed=0, device=None) -> Cell:
    cfg: LMConfig = arch.model
    dev = _cell_device(abstract, device)
    opt, kind = _optimizer_for(arch)
    tree = init_lm(cfg, default_generator(dev, seed), dev, keep_axes=True)
    params = unwrap(tree)
    opt_state = opt.init(lm_param_leaves(params))
    b, s = shape["global_batch"], shape["seq_len"]
    batch = (_meta_batch({"tokens": ((b, s), torch.int32),
                          "labels": ((b, s), torch.int32)}) if abstract
             else _train_batch(arch, shape, seed, dev))
    in_sh = _train_shardings(rules, tree, kind,
                             {"tokens": ("batch", "seq"),
                              "labels": ("batch", "seq")}, batch)
    return Cell(arch.arch_id, shape.name, "train", lm_train_step(cfg, opt),
                (params, opt_state, _step0(dev), batch), in_sh,
                donate_argnums=(0, 1))


def _lm_prefill_cell(arch, shape, rules, abstract, seed=0,
                     device=None) -> Cell:
    cfg: LMConfig = arch.model
    dev = _cell_device(abstract, device)
    tree = init_lm(cfg, default_generator(dev, seed), dev, keep_axes=True)
    params = unwrap(tree)
    b, s = shape["global_batch"], shape["seq_len"]

    @torch.no_grad()
    def prefill_step(params, tokens):
        return prefill(params, cfg, tokens)

    tokens = (_sds((b, s), torch.int32) if abstract else
              torch.from_numpy(np.random.RandomState(seed).randint(
                  0, cfg.vocab_size, size=(b, s)).astype(np.int32)).to(dev))
    in_sh = None
    if rules is not None:
        in_sh = (rules.param_shardings(tree),
                 rules.sharding_for(("batch", "seq"), (b, s)))
    return Cell(arch.arch_id, shape.name, "prefill", prefill_step,
                (params, tokens), in_sh)


def _lm_decode_cell(arch, shape, rules, abstract, seed=0,
                    device=None) -> Cell:
    """One decode step at ``pos = seq_len - 1`` over a zero cache of
    ``seq_len`` positions; the step writes its keys and values into the
    cache in place (``attention.cache_update``)."""
    cfg: LMConfig = arch.model
    dev = _cell_device(abstract, device)
    tree = init_lm(cfg, default_generator(dev, seed), dev, keep_axes=True)
    params = unwrap(tree)
    b, s = shape["global_batch"], shape["seq_len"]
    dims = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim,
            torch_dtype(cfg.compute_dtype))

    def serve_step(params, tokens, cache, pos):
        return decode_step(params, cfg, tokens, cache,
                           _host_int(pos, s - 1))

    if abstract:
        tokens, cache = _sds((b, 1), torch.int32), KVCache.abstract(*dims)
        pos = _sds((), torch.int32)
    else:
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        cache = KVCache.zeros(*dims, device=dev)
        pos = torch.tensor(s - 1, dtype=torch.int32, device=dev)
    in_sh = None
    if rules is not None:
        cache_sh = rules.sharding_for(
            ("layers", "batch", "kv_seq", "kv_heads", "d_head"), dims[:5])
        in_sh = (rules.param_shardings(tree),
                 rules.sharding_for(("batch", None), (b, 1)),
                 KVCache(cache_sh, cache_sh), rules.sharding_for((), ()))
    return Cell(arch.arch_id, shape.name, "decode", serve_step,
                (params, tokens, cache, pos), in_sh, donate_argnums=(2,))


def _gnn_train_cell(arch, shape, rules, abstract, seed=0,
                    device=None) -> Cell:
    d_in, n_out, is_cls = GNN_DATASETS[shape.name]
    cfg = gnn_cell_config(arch, shape)
    dev = _cell_device(abstract, device)
    opt, kind = _optimizer_for(arch)
    tree = init_equiformer(cfg, default_generator(dev, seed), dev,
                           keep_axes=True)
    params = unwrap(tree)
    opt_state = opt.init(gnn_param_leaves(params))
    n, e = _gnn_dims(shape)
    mol = shape.name == "molecule"
    step = gnn_train_step(cfg, opt)

    def train_step(params, opt_state, step_no, batch):
        if mol:
            batch = dict(batch, n_graphs=shape["batch"])
        return step(params, opt_state, step_no, batch)

    if abstract:
        lbl = (((shape["batch"], n_out) if mol else (n,)),
               torch.int32 if is_cls else torch.float32)
        spec = {"pos": ((n, 3), torch.float32),
                "src": ((e,), torch.int32), "dst": ((e,), torch.int32),
                "node_feat": ((n, d_in), torch.float32), "labels": lbl}
        if mol:
            spec["graph_ids"] = ((n,), torch.int32)
        batch = _meta_batch(spec)
    else:
        batch = _train_batch(arch, shape, seed, dev)
    in_sh = _train_shardings(rules, tree, kind, {
        "pos": ("nodes", None), "src": ("edges",), "dst": ("edges",),
        "node_feat": ("nodes", "d_feat"),
        "labels": ("graphs", None) if mol else ("nodes",),
        "graph_ids": ("nodes",)}, batch)
    return Cell(arch.arch_id, shape.name, "train", train_step,
                (params, opt_state, _step0(dev), batch), in_sh,
                donate_argnums=(0, 1), note=f"N={n} E={e}")


_RS_AXES = {"sparse": ("batch", "fields"), "labels": ("batch",),
            "dense": ("batch", None), "hist": ("batch", None),
            "hist_cat": ("batch", None), "hist_mask": ("batch", None),
            "target": ("batch",), "target_cat": ("batch",),
            "user_query": ("batch", "embed_dim")}


def _recsys_meta_batch(cfg: RecsysConfig, b: int) -> dict:
    spec = {"sparse": ((b, cfg.n_sparse), torch.int32),
            "labels": ((b,), torch.float32)}
    if cfg.kind == "dlrm":
        spec["dense"] = ((b, cfg.n_dense), torch.float32)
    if cfg.kind == "dien":
        t = cfg.seq_len
        spec.update(hist=((b, t), torch.int32),
                    hist_cat=((b, t), torch.int32),
                    hist_mask=((b, t), torch.float32),
                    target=((b,), torch.int32),
                    target_cat=((b,), torch.int32))
    return _meta_batch(spec)


def _recsys_cell(arch, shape, rules, abstract, seed=0,
                 device=None) -> Cell:
    cfg: RecsysConfig = arch.model
    dev = _cell_device(abstract, device)
    tree = init_recsys(cfg, default_generator(dev, seed), dev, keep_axes=True)
    params = unwrap(tree)

    def serve_shardings(batch):
        if rules is None:
            return None
        return (rules.param_shardings(tree),
                _batch_shardings(rules, _RS_AXES, batch))

    if shape.name == "retrieval_cand":
        step, n_cand = recsys_retrieval_step(cfg, shape)
        b = shape["batch"]
        batch = ({"user_query": _sds((b, cfg.embed_dim), torch.float32)}
                 if abstract else _retrieval_query(cfg, b, seed, dev))
        return Cell(arch.arch_id, shape.name, "serve", step,
                    (params, batch), serve_shardings(batch),
                    note=f"n_cand={n_cand}")

    b = shape["batch"]
    batch = (_recsys_meta_batch(cfg, b) if abstract
             else _recsys_batch(cfg, b, seed, dev))
    if shape.kind == "train":
        opt, kind = _optimizer_for(arch)
        opt_state = opt.init(recsys_param_leaves(params))
        return Cell(arch.arch_id, shape.name, "train",
                    recsys_train_step(cfg, opt),
                    (params, opt_state, _step0(dev), batch),
                    _train_shardings(rules, tree, kind, _RS_AXES, batch),
                    donate_argnums=(0, 1))

    @torch.no_grad()
    def serve_step(params, batch):
        return recsys_scores(params, cfg, batch)

    serve_batch = {k: v for k, v in batch.items() if k != "labels"}
    return Cell(arch.arch_id, shape.name, "serve", serve_step,
                (params, serve_batch), serve_shardings(serve_batch))


ROUTE_ALPHA = 0.05      # the route_* cell's budget, as the reference's


def _router_cell(arch, shape, rules, abstract, seed=0,
                 device=None) -> Cell:
    cfg: EncoderConfig = arch.model
    dev = _cell_device(abstract, device)
    tree = init_router_params(cfg, default_generator(dev, seed), dev,
                              keep_axes=True)
    params = unwrap(tree)
    b = shape["global_batch"]
    s = min(shape["seq_len"], cfg.max_len)

    def mk_tok():
        if abstract:
            return _sds((b, s), torch.int32), _sds((b, s), torch.float32)
        toks = np.random.RandomState(seed).randint(2, cfg.vocab_size, (b, s))
        return (torch.from_numpy(toks.astype(np.int32)).to(dev),
                torch.ones((b, s), dtype=torch.float32, device=dev))

    if shape.name.startswith(("sft", "dpo")):
        opt, kind = _optimizer_for(arch)
        opt_state = opt.init(router_param_leaves(params))
        if shape.name.startswith("sft"):
            batch = (_meta_batch({"tokens": ((b, s), torch.int32),
                                  "mask": ((b, s), torch.float32),
                                  "targets": ((b, cfg.n_outputs),
                                              torch.float32)})
                     if abstract else _train_batch(arch, shape, seed, dev))
            in_sh = _train_shardings(rules, tree, kind, {
                "tokens": ("batch", "seq"), "mask": ("batch", "seq"),
                "targets": ("batch", None)}, batch)
            return Cell(arch.arch_id, shape.name, "train",
                        router_train_step(cfg, opt),
                        (params, opt_state, _step0(dev), batch), in_sh,
                        donate_argnums=(0, 1))
        # the reference draws both sides from one seed: pos == neg
        tp, mp = mk_tok()
        tn, mn = mk_tok()
        batch = {"tok_pos": tp, "mask_pos": mp, "tok_neg": tn,
                 "mask_neg": mn}
        # the frozen reference is a copy: the step updates params in place
        ref = {k: ({n: t.clone() for n, t in v.items()} if k == "layers"
                   else v.clone()) for k, v in params.items()}
        in_sh = _train_shardings(rules, tree, kind,
                                 {k: ("batch", "seq") for k in batch},
                                 batch, frozen=True)
        return Cell(arch.arch_id, shape.name, "train",
                    router_dpo_step(cfg, opt),
                    (params, ref, opt_state, _step0(dev), batch), in_sh,
                    donate_argnums=(0, 2))

    toks, mask = mk_tok()
    valid = (_sds((b,), torch.float32) if abstract
             else torch.ones((b,), dtype=torch.float32, device=dev))
    in_sh = None
    if rules is not None:
        in_sh = (rules.param_shardings(tree),
                 rules.sharding_for(("batch", "seq"), (b, s)),
                 rules.sharding_for(("batch", "seq"), (b, s)),
                 rules.sharding_for(("batch",), (b,)))
    return Cell(arch.arch_id, shape.name, "serve",
                router_route_step(cfg, ROUTE_ALPHA),
                (params, toks, mask, valid), in_sh,
                note=f"alpha={ROUTE_ALPHA}")


def _nougat_cell(arch, shape, rules, abstract, seed=0,
                 device=None) -> Cell:
    cfg: VitParserConfig = arch.model
    dev = _cell_device(abstract, device)
    tree = init_vit_parser(cfg, default_generator(dev, seed), dev,
                           keep_axes=True)
    params = unwrap(tree)
    b = shape["global_batch"]
    patch_dim = cfg.patch * cfg.patch * 3
    n_p = cfg.n_patches
    cdt = torch_dtype(cfg.compute_dtype)

    def mk_patches():
        if abstract:
            return _sds((b, n_p, patch_dim), cdt)
        return _nougat_patches(cfg, b, seed, dev)

    if shape.kind == "train":
        t = min(shape["dec_len"], cfg.max_dec_len)
        opt, kind = _optimizer_for(arch)
        opt_state = opt.init(vit_parser_param_leaves(params))
        if abstract:
            toks = _sds((b, t), torch.int32)
            batch = {"patches": mk_patches(), "tokens": toks,
                     "labels": toks}
        else:
            batch = _train_batch(arch, shape, seed, dev)
        in_sh = _train_shardings(rules, tree, kind, {
            "patches": ("pages", "patches", None),
            "tokens": ("pages", "seq"), "labels": ("pages", "seq")}, batch)
        return Cell(arch.arch_id, shape.name, "train",
                    vit_parser_train_step(cfg, opt),
                    (params, opt_state, _step0(dev), batch), in_sh,
                    donate_argnums=(0, 1))

    if shape.name == "parse_encode":
        @torch.no_grad()
        def encode_step(params, patches):
            # init_dec_state's cross keys and values, without its zero
            # self-attention cache, which the step does not return
            memory = vp_lib.encode_pages(params, cfg, patches)
            return vp_lib.cross_kv(params, cfg, memory)

        in_sh = None
        if rules is not None:
            in_sh = (rules.param_shardings(tree),
                     rules.sharding_for(("pages", "patches", None),
                                        (b, n_p, patch_dim)))
        return Cell(arch.arch_id, shape.name, "serve", encode_step,
                    (params, mk_patches()), in_sh)

    # parse_decode: one token for the in-flight page batch
    t = min(shape["dec_len"], cfg.max_dec_len)
    dh = cfg.dec_d_model // cfg.dec_heads

    def dec_step(params, tok, cache_k, cache_v, xk, xv, pos):
        state = vp_lib.DecState(KVCache(cache_k, cache_v), xk, xv)
        logits, state = vp_lib.dec_step(params, cfg, tok, state,
                                        _host_int(pos, t - 1))
        return logits, state.cache.k, state.cache.v

    cshape = (cfg.dec_layers, b, t, cfg.dec_heads, dh)
    xshape = (cfg.dec_layers, b, n_p, cfg.dec_heads, dh)
    if abstract:
        tok, pos = _sds((b, 1), torch.int32), _sds((), torch.int32)
        ck, cv = _sds(cshape, cdt), _sds(cshape, cdt)
        xk, xv = _sds(xshape, cdt), _sds(xshape, cdt)
    else:
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        ck, cv, xk, xv = (torch.zeros(sh, dtype=cdt, device=dev)
                          for sh in (cshape, cshape, xshape, xshape))
        pos = torch.tensor(t - 1, dtype=torch.int32, device=dev)
    in_sh = None
    if rules is not None:
        c_sh = rules.sharding_for(("layers", "pages", "kv_seq", "heads",
                                   "d_head"), cshape)
        x_sh = rules.sharding_for(("layers", "pages", "patches", "heads",
                                   "d_head"), xshape)
        in_sh = (rules.param_shardings(tree),
                 rules.sharding_for(("pages", None), (b, 1)), c_sh, c_sh,
                 x_sh, x_sh, rules.sharding_for((), ()))
    return Cell(arch.arch_id, shape.name, "decode", dec_step,
                (params, tok, ck, cv, xk, xv, pos), in_sh,
                donate_argnums=(2, 3))


_BUILDERS = {"gnn": _gnn_train_cell, "recsys": _recsys_cell,
             "encoder": _router_cell, "vit_parser": _nougat_cell}


def cell_shape(arch_id: str, shape_name: str, reduced: bool = False,
               model_override=None) -> tuple[ArchConfig, ShapeConfig]:
    """The arch (``model_override`` in place of its model; its tiny
    config when ``reduced``) and the shape ``build_cell`` builds,
    ``_reduce_shape`` applied when ``reduced``. A shape the arch skips
    raises ValueError unless ``reduced``."""
    arch = get_config(arch_id)
    if model_override is not None:
        arch = dataclasses.replace(arch, model=model_override)
    if reduced:
        arch = arch.reduced()
        shape = _reduce_shape(arch.family, arch.shape(shape_name))
    else:
        shape = arch.shape(shape_name)
    if shape_name in arch.skips and not reduced:
        raise ValueError(f"{arch_id}/{shape_name} skipped: "
                         f"{arch.skips[shape_name]}")
    return arch, shape


def build_cell(arch_id: str, shape_name: str, rules=None,
               abstract: bool = True, reduced: bool = False, seed: int = 0,
               model_override=None, device=None) -> Cell:
    """The (arch, shape) cell: its step and arguments on meta
    (``abstract``) or on ``device`` (cuda unless "cpu"), with the
    ``in_shardings`` of ``rules`` (an ``AxisRules``) when given."""
    arch, shape = cell_shape(arch_id, shape_name, reduced, model_override)
    return build_cell_for(arch, shape, rules, abstract, seed, device)


def _check_rules(rules) -> None:
    if rules is not None and not isinstance(rules, AxisRules):
        raise TypeError(f"launch.specs: rules must be a "
                        f"distributed.meshrules.AxisRules or None (got "
                        f"{type(rules).__name__})")


def build_cell_for(arch: ArchConfig, shape: ShapeConfig, rules=None,
                   abstract: bool = True, seed: int = 0,
                   device=None) -> Cell:
    """``build_cell`` of a given arch and shape (a cut of a registered
    one, as ``chip_smoke.py`` runs at full width on one card)."""
    _check_rules(rules)
    if arch.family == "lm":
        build = {"train": _lm_train_cell,
                 "prefill": _lm_prefill_cell}.get(shape.kind,
                                                  _lm_decode_cell)
    elif arch.family in _BUILDERS:
        build = _BUILDERS[arch.family]
    else:
        raise ValueError(arch.family)
    return build(arch, shape, rules, abstract, seed, device)


def place_tensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole value, the same on every rank) as a DTensor laid
    out by ``sharding``: each rank keeps a view of its own shard, cut as
    DTensor cuts it, and nothing is sent (every rank built the same
    cell). A meta ``t`` gives a meta DTensor whose local tensor has the
    shard's shape (the dry run's collectives)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, placements = sharding.mesh, sharding.placements
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    if t.is_meta:
        local = torch.empty(shape, dtype=t.dtype, device="meta")
    else:
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        local = local.contiguous()
    return from_local(local, mesh, placements, t.shape)


def place_args(cell: Cell) -> tuple:
    """The cell's arguments as DTensors on its rules' mesh, each leaf
    laid out by its ``in_shardings`` (``place_tensor``): the counterpart
    of ``jax.jit(fn, in_shardings=...)``'s placement. Run the step on
    them under ``meshrules.use_rules(rules)``. Non-tensor leaves are
    kept; ``donate_argnums`` are the cell's."""
    if cell.in_shardings is None:
        raise ValueError(f"{cell.arch_id}/{cell.shape_name}: the cell was "
                         f"built without rules")
    return tuple(tree_map(
        lambda t, s: place_tensor(t, s) if isinstance(t, torch.Tensor)
        else t, arg, sh) for arg, sh in zip(cell.args, cell.in_shardings))


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, runnable shape) pair, in the reference's order."""
    from repro_torch.configs import list_archs
    return [(a, s.name) for a in list_archs()
            for s in get_config(a).runnable_shapes()]
