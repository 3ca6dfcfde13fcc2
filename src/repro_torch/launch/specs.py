"""Workload batches and the training and retrieval steps, the port of
the seeded batch functions and of the LM, GNN, recsys, ViT-parser and
router train cells of ``repro/launch/specs.py`` (its abstract and
sharded cells are the JAX package's own lowering and are not ported).

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

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import (ArchConfig, EncoderConfig, GNNConfig,
                                      LMConfig, RecsysConfig, ShapeConfig,
                                      VitParserConfig, round_up)
from repro_torch.models.encoder import Encoder, _named_params, init_encoder
from repro_torch.models.gnn import sampler as sampler_lib
from repro_torch.models.gnn.equiformer import equiformer_loss
from repro_torch.models.gnn.so3 import n_coeff_full
from repro_torch.models.layers import from_numpy, torch_dtype
from repro_torch.models.recsys.models import recsys_loss, recsys_retrieval
from repro_torch.models.transformer import lm_loss
from repro_torch.models.vit_parser import parser_loss
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


def _tree_leaves(tree, is_leaf=lambda x: False):
    """``jax.tree_util.tree_leaves``' order: dict keys sorted, lists and
    tuples in index order."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v, is_leaf)]
    return [tree]


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
                       device=None) -> dict:
    """``init_encoder``'s params as ``router_param_tree``: its weights are
    drawn on the CPU from a generator seeded with ``generator``'s seed
    (0 by default), then put on ``device`` (cuda unless "cpu")."""
    seed = 0 if generator is None else generator.initial_seed()
    return router_param_tree(init_encoder(
        cfg, torch.Generator().manual_seed(seed),
        device_lib.resolve(device)))


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
    patches = np.random.RandomState(seed).randn(
        b, cfg.n_patches, cfg.patch * cfg.patch * 3)
    toks = torch.zeros((b, t), dtype=torch.int32, device=dev)
    return {"patches": torch.from_numpy(patches).to(
                torch_dtype(cfg.compute_dtype)).to(dev),
            "tokens": toks, "labels": toks}


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


def _update(opt, leaves, grads, opt_state, step):
    """One update of ``opt`` applied to ``leaves`` in place."""
    updates, opt_state = opt.update(list(grads), opt_state, leaves,
                                    int(step))
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


def router_train_step(cfg: EncoderConfig, opt):
    """The router's ``sft_4k`` step on ``router_param_tree`` params:
    the tree's values are copied into an ``Encoder`` on the params'
    device, ``Encoder.regression_loss`` is differentiated with respect to
    its parameters, each stacked leaf's gradient is the stack of its
    layers' (the preference head, which the loss does not reach, gets
    none: a zero gradient that still decays), and one update of ``opt``
    is applied to the tree in place."""
    encoders: dict = {}

    def train_step(params, opt_state, step, batch):
        leaves = router_param_leaves(params)
        dev = leaves[0].device
        if dev not in encoders:
            encoders[dev] = Encoder(cfg, dev)
        named = list(_named_params(encoders[dev]))
        with torch.no_grad():
            for name, i, prm in named:
                prm.copy_(params[name] if i is None
                          else params["layers"][name][i])
        prms = [prm for _, _, prm in named]
        for p in prms:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = encoders[dev].regression_loss(batch)
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
        opt_state = _update(opt, leaves, router_param_leaves(grad_tree),
                            opt_state, step)
        return params, opt_state, loss.detach()

    return train_step


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
            f"a mesh, which waits for ROADMAP.md item 13e's distributed/*")


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
