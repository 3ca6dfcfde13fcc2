"""Recsys model zoo, the port of ``repro/models/recsys/models.py``: DLRM
(MLPerf), DeepFM, AutoInt, DIEN.

Public surface:
    init_recsys(cfg, generator, device)        -> params
    recsys_from_jax_params(raw, cfg, device)   -> params
    recsys_logits(params, cfg, batch)          -> (B,) logits
    recsys_loss(params, cfg, batch)            -> BCE loss, metrics
    recsys_scores(params, cfg, batch)          -> (B,) sigmoid CTR scores
    recsys_retrieval(params, cfg, batch, k)    -> top-k (scores, ids)

Params are a plain dict in the JAX package's raw layout (``_shapes``
lists every leaf): ``table (rows padded to 512, D)`` for every kind;
DLRM adds ``bot`` and ``top``, DeepFM ``lin_table``, ``bias`` and
``deep``, AutoInt ``attn`` and ``out``, DIEN ``gru``, ``augru``, ``att``,
``hist_proj`` and ``mlp``; an MLP is a list of ``{"w": (a, b), "b":
(b,)}``. ``batch`` holds ``sparse (B, n_sparse)`` field-local ids, DLRM
adds ``dense``, DIEN ``hist``, ``hist_cat``, ``hist_mask``, ``target``
and ``target_cat`` (``launch.specs._recsys_batch``). Every table lookup
is the hand-written ``embedding_bag`` kernel on the card, and its
gradient the hand-written ``embedding_bag_backward``; the MLPs,
interactions and GRUs are plain torch products, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.common import Param, default_generator, unwrap
from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import from_numpy, mlp_apply, torch_dtype
from repro_torch.models.recsys import embedding as emb
from repro_torch.models.recsys import interactions as inter

#: leaves drawn in place by ``emb.init_table`` (normal(0, dim^-0.5))
_TABLES = ("table", "lin_table")


def _mlp_shapes(dims, hidden_axis: str = "mlp_hidden") -> list[dict]:
    """An MLP's layers, each leaf (shape, std, logical axes): hidden
    dims on ``hidden_axis``, the input and the output replicated."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        last = i == len(dims) - 2
        o = None if last else hidden_axis
        out.append({"w": ((a, b), a ** -0.5,
                          (hidden_axis if i > 0 else None, o)),
                    "b": ((b,), None, (o,))})
    return out


def _none(shape, std) -> tuple:
    return (shape, std, (None,) * len(shape))


def _shapes(cfg: RecsysConfig) -> dict:
    """The params tree of ``cfg.kind`` with each leaf's (shape, std,
    logical axes): weights normal(0, std), std None for a zero bias. The
    JAX ``init_recsys``'s leaves, shapes, scales and axes."""
    d = cfg.embed_dim
    rows = emb.table_offsets(cfg.vocab_sizes, 512)[1]
    table_axes = ("table_rows", "embed_dim")
    p: dict = {"table": ((rows, d), d ** -0.5, table_axes)}
    if cfg.kind == "dlrm":
        f = cfg.n_sparse + 1
        d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
        p["bot"] = _mlp_shapes((cfg.n_dense,) + cfg.bot_mlp)
        p["top"] = _mlp_shapes((d_int,) + cfg.top_mlp)
    elif cfg.kind == "deepfm":
        p["lin_table"] = ((rows, 1), 1.0, table_axes)
        p["bias"] = _none((1,), None)
        p["deep"] = _mlp_shapes((cfg.n_sparse * d,) + cfg.mlp + (1,))
    elif cfg.kind == "autoint":
        dh = cfg.d_attn // cfg.n_attn_heads
        p["attn"] = []
        d_in = d
        for _ in range(cfg.n_attn_layers):
            w = _none((d_in, cfg.n_attn_heads, dh), d_in ** -0.5)
            p["attn"].append({"wq": w, "wk": w, "wv": w,
                              "w_res": _none((d_in, cfg.d_attn),
                                             d_in ** -0.5)})
            d_in = cfg.d_attn
        p["out"] = _mlp_shapes((cfg.n_sparse * cfg.d_attn, 1))
    elif cfg.kind == "dien":
        d_item = 2 * d                      # item + category embeddings
        g = cfg.gru_dim
        p["gru"] = inter.gru_shapes(d_item, g)
        p["augru"] = inter.gru_shapes(g, g)
        p["att"] = {"w1": _none((4 * g, 64), (4 * g) ** -0.5),
                    "b1": _none((64,), None),
                    "w2": _none((64, 1), 64 ** -0.5),
                    "b2": _none((1,), None)}
        p["hist_proj"] = _none((d_item, g), d_item ** -0.5)
        p["mlp"] = _mlp_shapes((g + d_item,) + cfg.mlp + (1,))
    else:
        raise ValueError(f"{cfg.name}: unknown recsys kind {cfg.kind!r}")
    return p


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_recsys(cfg: RecsysConfig, generator: torch.Generator | None = None,
                device=None, keep_axes: bool = False) -> dict:
    """Random params in ``cfg.param_dtype`` on ``device`` (cuda unless
    "cpu"), drawn from ``generator``, which must live there (default:
    seed 0 there). The tables are drawn in place (``init_table``). On
    ``meta`` (any generator) nothing is drawn. With ``keep_axes`` the
    ``Param`` tree of their logical axes."""
    dev = device_lib.resolve(device)
    g = generator if generator is not None else \
        default_generator(dev)
    dtype = torch_dtype(cfg.param_dtype)

    def build(spec, name):
        if isinstance(spec, dict):
            return {k: build(v, k) for k, v in spec.items()}
        if isinstance(spec, list):
            return [build(v, name) for v in spec]
        shape, std, axes = spec
        if name in _TABLES:
            return Param(emb.init_table(cfg.vocab_sizes, shape[1], dtype, g,
                                        dev)[0], axes)
        return Param(inter.draw(shape, std, dtype, g, dev), axes)

    tree = build(_shapes(cfg), None)
    return tree if keep_axes else unwrap(tree)


@torch.no_grad()
def recsys_from_jax_params(raw: dict, cfg: RecsysConfig, device=None) -> dict:
    """The JAX package's raw params of any recsys kind (numpy leaves,
    ``unwrap``-ed ``init_recsys``) -> the port's params with the same
    values, bf16 bit for bit. Raises on a missing, extra or misshapen
    leaf."""
    dev = device_lib.resolve(device)
    dtype = torch_dtype(cfg.param_dtype)

    def take(spec, node, where):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"recsys params{where}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: take(v, node[k], f"{where}[{k!r}]")
                    for k, v in spec.items()}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or \
                    len(node) != len(spec):
                n = len(node) if isinstance(node, (list, tuple)) else node
                raise ValueError(f"recsys params{where}: {n} layers != "
                                 f"{len(spec)}")
            return [take(v, x, f"{where}[{i}]")
                    for i, (v, x) in enumerate(zip(spec, node))]
        t = from_numpy(node)
        if tuple(t.shape) != spec[0]:
            raise ValueError(f"recsys param{where}: shape {tuple(t.shape)} "
                             f"!= {spec[0]}")
        return t.to(device=dev, dtype=dtype)

    return take(_shapes(cfg), raw, "")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def recsys_logits(params: dict, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    table = params["table"].to(cdt)             # no copy when already cdt
    offsets = torch.from_numpy(emb.table_offsets(cfg.vocab_sizes)[0]
                               .astype("int32")).to(table.device)

    if cfg.kind == "dlrm":
        dense = batch["dense"].to(cdt)
        bot = mlp_apply(dense, params["bot"], final_act=F.relu)
        vecs = emb.lookup_fields(table, offsets, batch["sparse"])
        z = inter.dot_interaction(torch.cat([bot[:, None, :], vecs], dim=1))
        z = torch.cat([bot, z], dim=-1)
        return mlp_apply(z, params["top"])[:, 0]

    if cfg.kind == "deepfm":
        vecs = emb.lookup_fields(table, offsets, batch["sparse"])
        lin = emb.lookup_fields(params["lin_table"].to(cdt), offsets,
                                batch["sparse"])[..., 0].sum(-1)
        fm = inter.fm_interaction(vecs)
        deep = mlp_apply(vecs.reshape(vecs.shape[0], -1),
                         params["deep"])[:, 0]
        return lin + fm + deep + params["bias"].to(cdt)[0]

    if cfg.kind == "autoint":
        x = emb.lookup_fields(table, offsets, batch["sparse"])
        for lp in params["attn"]:
            x = inter.autoint_layer(x, lp, cfg.n_attn_heads)
        return mlp_apply(x.reshape(x.shape[0], -1), params["out"])[:, 0]

    if cfg.kind == "dien":
        # the reference's four takes (item and category of the history
        # and of the target) as one lookup: ids paired on a last axis
        # give the concatenation [item, category] of each row pair
        b, t = batch["hist"].shape
        pairs = [torch.stack([batch["hist"], batch["hist_cat"]], -1),
                 torch.stack([batch["target"], batch["target_cat"]], -1)]
        rows = emb.take_rows(table, torch.cat([x.reshape(-1)
                                               for x in pairs]))
        hist = rows[:2 * b * t].reshape(b, t, -1)             # (B, T, 2D)
        tgt = rows[2 * b * t:].reshape(b, -1)                 # (B, 2D)
        hs = inter.gru_scan(hist, params["gru"],
                            unroll=cfg.unroll_gru)            # (B, T, H)
        tgt_h = tgt @ params["hist_proj"].to(cdt)
        att = inter.attention_scores(hs, tgt_h, params["att"])
        mask = batch.get("hist_mask")
        if mask is not None:
            att = torch.where(mask > 0, att, -1e30)
        att = torch.softmax(att.float(), dim=-1).to(cdt)
        h_final = inter.augru_scan(hs, att, params["augru"],
                                   unroll=cfg.unroll_gru)
        z = torch.cat([h_final, tgt], dim=-1)
        return mlp_apply(z, params["mlp"])[:, 0]

    raise ValueError(f"{cfg.name}: unknown recsys kind {cfg.kind!r}")


def recsys_loss(params: dict, cfg: RecsysConfig, batch: dict):
    """The reference's stable binary cross-entropy on the logits, in
    float32: ``max(l, 0) - l * y + log1p(exp(-|l|))``, averaged."""
    logits = recsys_logits(params, cfg, batch).float()
    y = batch["labels"].float()
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"bce": loss}


def recsys_scores(params: dict, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """Serving: sigmoid CTR scores in float32."""
    return torch.sigmoid(recsys_logits(params, cfg, batch).float())


def recsys_retrieval(params: dict, cfg: RecsysConfig, batch: dict,
                     k: int = 100):
    """retrieval_cand cell: one user context scored against
    ``n_candidates`` rows of the table from ``cand_offset`` (default 0)
    with one batched dot, the top k as (scores, ids) in ``lax.top_k``'s
    order (``retrieval_topk``). The start is clamped into [0, R -
    n_candidates], as ``lax.dynamic_slice_in_dim`` clamps it."""
    cdt = torch_dtype(cfg.compute_dtype)
    table = params["table"].to(cdt)
    n = int(batch["n_candidates"])
    r = table.shape[0]
    if not 0 < n <= r:
        raise ValueError(f"recsys_retrieval: n_candidates {n} not in "
                         f"[1, {r}] (the table's rows)")
    start = min(max(int(batch.get("cand_offset", 0)), 0), r - n)
    return emb.retrieval_topk(batch["user_query"].to(cdt),
                              table[start:start + n], k)
