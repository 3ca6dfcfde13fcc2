"""Recsys models, the port of ``repro/models/recsys/models.py``: DLRM
(MLPerf) serving. DeepFM, AutoInt and DIEN are not ported yet (ROADMAP.md
queue 1, item 13e), nor are training (``recsys_loss``) and
``recsys_retrieval``.

Public surface:
    init_recsys(cfg, generator, device)        -> params
    recsys_from_jax_params(raw, cfg, device)   -> params
    recsys_logits(params, cfg, batch)          -> (B,) logits
    recsys_scores(params, cfg, batch)          -> (B,) sigmoid CTR scores

Params are a plain dict in the JAX package's raw layout: ``table (rows
padded to 512, D)``, ``bot`` and ``top`` lists of ``{"w": (a, b), "b":
(b,)}``. ``batch`` holds ``dense (B, n_dense)`` floats and ``sparse (B,
n_sparse)`` field-local ids (``launch.specs._recsys_batch``). The field
lookup is the hand-written ``embedding_bag`` kernel on the card; the MLPs
and the dot interaction are plain matmuls, as the JAX package leaves them
to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import from_numpy, torch_dtype
from repro_torch.models.recsys import embedding as emb
from repro_torch.models.recsys import interactions as inter


def _check_dlrm(cfg: RecsysConfig) -> None:
    if cfg.kind != "dlrm":
        raise NotImplementedError(
            f"{cfg.name}: recsys kind {cfg.kind!r} is not ported yet "
            f"(ROADMAP.md queue 1, item 13e)")


def _mlp_dims(cfg: RecsysConfig) -> dict:
    f = cfg.n_sparse + 1
    d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
    return {"bot": (cfg.n_dense,) + cfg.bot_mlp,
            "top": (d_int,) + cfg.top_mlp}


def _mk_mlp(dims, dtype, generator, device) -> list[dict]:
    """Weights normal(0, fan_in^-0.5) drawn in float32, zero biases."""
    return [{"w": (torch.randn((a, b), generator=generator, device=device)
                   * a ** -0.5).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(x, layers, act=F.relu, final_act=None):
    for i, p in enumerate(layers):
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


@torch.no_grad()
def init_recsys(cfg: RecsysConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random params in ``cfg.param_dtype`` on ``device`` (cuda unless
    "cpu"), drawn from ``generator``, which must live there (default:
    seed 0 there). The table is drawn in place (``init_table``)."""
    _check_dlrm(cfg)
    dev = device_lib.resolve(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg.param_dtype)
    table, _ = emb.init_table(cfg.vocab_sizes, cfg.embed_dim, dtype, g, dev)
    return {"table": table,
            **{k: _mk_mlp(dims, dtype, g, dev)
               for k, dims in _mlp_dims(cfg).items()}}


@torch.no_grad()
def recsys_from_jax_params(raw: dict, cfg: RecsysConfig, device=None) -> dict:
    """The JAX package's raw DLRM params (numpy leaves, ``unwrap``-ed
    ``init_recsys``) -> the port's params with the same values, bf16 bit
    for bit. Raises on a missing, extra or misshapen leaf."""
    _check_dlrm(cfg)
    dev = device_lib.resolve(device)
    dtype = torch_dtype(cfg.param_dtype)
    dims = _mlp_dims(cfg)
    if set(raw) != {"table"} | set(dims):
        raise ValueError(f"recsys params: keys {sorted(raw)} != "
                         f"{sorted({'table'} | set(dims))}")

    def take(a, shape, where):
        t = from_numpy(a)
        if tuple(t.shape) != shape:
            raise ValueError(f"recsys param{where}: shape {tuple(t.shape)} "
                             f"!= {shape}")
        return t.to(device=dev, dtype=dtype)

    rows = emb.table_offsets(cfg.vocab_sizes, 512)[1]
    out = {"table": take(raw["table"], (rows, cfg.embed_dim), "['table']")}
    for name, ds in dims.items():
        if len(raw[name]) != len(ds) - 1:
            raise ValueError(f"recsys params[{name!r}]: {len(raw[name])} "
                             f"layers != {len(ds) - 1}")
        out[name] = []
        for i, (layer, a, b) in enumerate(zip(raw[name], ds[:-1], ds[1:])):
            if set(layer) != {"w", "b"}:
                raise ValueError(f"recsys params[{name!r}][{i}]: keys "
                                 f"{sorted(layer)} != ['b', 'w']")
            where = f"[{name!r}][{i}]"
            out[name].append({"w": take(layer["w"], (a, b), where + "['w']"),
                              "b": take(layer["b"], (b,), where + "['b']")})
    return out


def recsys_logits(params: dict, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    _check_dlrm(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    table = params["table"].to(cdt)             # no copy when already cdt
    offsets = torch.from_numpy(emb.table_offsets(cfg.vocab_sizes)[0]
                               .astype("int32")).to(table.device)
    dense = batch["dense"].to(cdt)
    bot = _mlp(dense, params["bot"], final_act=F.relu)
    vecs = emb.lookup_fields(table, offsets, batch["sparse"])
    z = inter.dot_interaction(torch.cat([bot[:, None, :], vecs], dim=1))
    z = torch.cat([bot, z], dim=-1)
    return _mlp(z, params["top"])[:, 0]


def recsys_scores(params: dict, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """Serving: sigmoid CTR scores in float32."""
    return torch.sigmoid(recsys_logits(params, cfg, batch).float())
