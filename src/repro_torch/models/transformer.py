"""Decoder-only dense transformer LM: GQA/SWA attention, RoPE, qk-norm,
KV-cache decode. The serve and training paths of
``repro/models/transformer.py``.

Public surface:
    init_lm(cfg, generator, device)         -> params
    lm_from_jax_params(raw, cfg, device)    -> params
    lm_logits(params, cfg, tokens)          -> (B, S, V) logits, aux
    lm_loss(params, cfg, batch)             -> loss, {"ce", "aux"}
    prefill(params, cfg, tokens)            -> last-position logits, KVCache
    decode_step(params, cfg, tok, cache, pos) -> logits, cache

Params are a plain dict in the JAX package's raw layout: ``embed (V, d)``,
``ln_final (d,)``, ``lm_head (d, V)`` (absent when tied) and
``layers``, whose leaves are stacked on a leading layer axis (``wq (L, d,
h, dh)``, ``wk``/``wv (L, d, hk, dh)``, ``wo (L, h, dh, d)``, ``w_gate``/
``w_up (L, d, f)``, ``w_down (L, f, d)``, norm scales ``(L, d)``). So
``lm_from_jax_params`` is a checked copy and both packages compute the
same function. ``cfg.attention_impl`` picks the prefill attention
(``"pallas"`` is the hand-written flash kernel on the card, forward
only); decode attends with ``decode_attention``. ``lm_logits`` and
``lm_loss`` run under autograd: training attends through
``"xla_flash"`` (the configs' default), as the JAX package trains, and
with ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint(nothing_saveable)``. A config with
experts (``cfg.moe``) carries them as ``layers["moe"] = {"router" (L, d,
E), "w_gate"/"w_up" (L, E, d, Fe), "w_down" (L, E, Fe, d)}`` in place of
the dense FFN's leaves, and its FFN is ``models/moe.moe_ffn``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.common import default_generator, normal_init, param, unwrap, zeros_init
from repro_torch.configs.base import LMConfig
from repro_torch.distributed.meshrules import einsum, gathered, shard_hint
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_rope, cross_entropy_loss,
                                       embed_lookup, from_numpy, rms_norm,
                                       softcap, swiglu, torch_dtype)
from repro_torch.models.moe import init_moe, moe_ffn, moe_shapes


def _layer_shapes(cfg: LMConfig) -> dict:
    """name -> (per-layer shape, init std, logical axes), in the JAX
    package's order; ``"moe"`` maps to the experts' own such dict."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "ln_attn": ((d,), 0.0, ("d_model",)),
        "ln_ffn": ((d,), 0.0, ("d_model",)),
        "wq": ((d, h, dh), d ** -0.5, ("d_model", "heads", "d_head")),
        "wk": ((d, hk, dh), d ** -0.5, ("d_model", "kv_heads", "d_head")),
        "wv": ((d, hk, dh), d ** -0.5, ("d_model", "kv_heads", "d_head")),
        "wo": ((h, dh, d), (h * dh) ** -0.5, ("heads", "d_head", "d_model")),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = ((dh,), 0.0, ("d_head",))
        shapes["k_norm"] = ((dh,), 0.0, ("d_head",))
    if cfg.moe is not None:
        shapes["moe"] = moe_shapes(d, cfg.moe)
    else:
        shapes["w_gate"] = ((d, cfg.d_ff), d ** -0.5, ("d_model", "d_ff"))
        shapes["w_up"] = ((d, cfg.d_ff), d ** -0.5, ("d_model", "d_ff"))
        shapes["w_down"] = ((cfg.d_ff, d), cfg.d_ff ** -0.5,
                            ("d_ff", "d_model"))
    return shapes


def _top_shapes(cfg: LMConfig) -> dict:
    d = cfg.d_model
    shapes = {"embed": ((cfg.vocab_size, d), 0.02, ("vocab", "d_model")),
              "ln_final": ((d,), 0.0, ("d_model",))}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, cfg.vocab_size), d ** -0.5,
                             ("d_model", "vocab"))
    return shapes


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_lm(cfg: LMConfig, generator: torch.Generator | None = None,
            device=None, keep_axes: bool = False) -> dict:
    """Random params in ``cfg.param_dtype`` on ``device`` (cuda unless
    "cpu"): normal(std) draws in float32 from ``generator``, which must
    live on that device (default: seed 0 there), so the full width is
    drawn on the card; the norm scales are zero (the norms scale by
    ``1 + scale``). On ``meta`` (any generator) nothing is drawn. With
    ``keep_axes`` the ``Param`` tree (each leaf with the reference's
    logical axes, ``"layers"`` first on the stacked leaves)."""
    dev = device_lib.resolve(device)
    g = generator if generator is not None else \
        default_generator(dev)
    if dev.type != "meta" and torch.device(g.device).type != dev.type:
        raise ValueError(f"init_lm: generator on {g.device}, params on "
                         f"{dev}; draw on the params' device")
    dtype = torch_dtype(cfg.param_dtype)

    def draw(shape, std, axes):
        init = zeros_init if std == 0.0 else normal_init(std)
        return param(g, shape, axes, init, dtype, device=dev)

    L = cfg.n_layers
    params = {k: draw(*spec) for k, spec in _top_shapes(cfg).items()}
    params["layers"] = {
        k: (init_moe(g, cfg.d_model, cfg.moe, dtype, layers=L,
                     device=dev, keep_axes=True)
            if k == "moe" else draw((L,) + spec[0], spec[1],
                                    ("layers",) + spec[2]))
        for k, spec in _layer_shapes(cfg).items()}
    return params if keep_axes else unwrap(params)


@torch.no_grad()
def lm_from_jax_params(raw: dict, cfg: LMConfig, device=None) -> dict:
    """The JAX package's raw LM params (numpy leaves, ``unwrap``-ed
    ``init_lm``) -> the port's params with the same values, bf16 bit for
    bit. Raises on a missing, extra or misshapen leaf."""
    dev = device_lib.resolve(device)
    dtype = torch_dtype(cfg.param_dtype)
    L = cfg.n_layers

    def take(tree, shapes, lead, where):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"lm params{where}: keys {got} != "
                             f"{sorted(shapes)}")
        out = {}
        for k, spec in shapes.items():
            if isinstance(spec, dict):
                out[k] = take(tree[k], spec, lead, f"{where}[{k!r}]")
                continue
            t = from_numpy(tree[k])
            if tuple(t.shape) != lead + spec[0]:
                raise ValueError(f"lm param{where}[{k!r}]: shape "
                                 f"{tuple(t.shape)} != {lead + spec[0]}")
            out[k] = t.to(device=dev, dtype=dtype)
        return out

    top = {k: v for k, v in raw.items() if k != "layers"}
    return {**take(top, _top_shapes(cfg), (), ""),
            "layers": take(raw["layers"], _layer_shapes(cfg), (L,),
                           "['layers']")}


# ---------------------------------------------------------------------------
# Forward blocks
# ---------------------------------------------------------------------------


def _layers(params: dict) -> list[dict]:
    """Each layer's leaves (the experts' nested too), the stacked (L,
    ...) leaves taken apart once with ``unbind``: its backward stacks
    the L grads once, where indexing ``v[i]`` per layer would allocate a
    zero tensor of the whole stacked leaf for every layer's grad. The
    steps take each layer through ``meshrules.gathered`` as its turn
    comes (on a mesh, its weights gathered over the data dims)."""
    def split(tree):
        names = list(tree)
        cols = [split(tree[k]) if isinstance(tree[k], dict)
                else tree[k].unbind(0) for k in names]
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    return split(params["layers"])


def _qkv(x, lp, cfg: LMConfig, positions):
    cdt = torch_dtype(cfg.compute_dtype)
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = einsum("bsd,dhk->bshk", h, lp["wq"].to(cdt))
    k = einsum("bsd,dhk->bshk", h, lp["wk"].to(cdt))
    v = einsum("bsd,dhk->bshk", h, lp["wv"].to(cdt))
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # seq whole here: the residual stream shards seq, attention gathers
    # it and shards heads (Megatron TP)
    q = shard_hint(q, "batch", None, "heads", "d_head")
    k = shard_hint(k, "batch", None, "kv_heads", "d_head")
    v = shard_hint(v, "batch", None, "kv_heads", "d_head")
    return q, k, v


def _attn_out(x, o, lp, hint=None):
    o = einsum("bshk,hkd->bsd", o, lp["wo"].to(o.dtype))
    o = o.to(x.dtype)
    return x + (o if hint is None else hint(o))


def _ffn_block(x, lp, cfg: LMConfig):
    """-> (y in x's dtype, the layer's float32 aux loss; None for a dense
    layer, which has none)."""
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_ffn(h, lp["moe"], cfg.moe)
        return y.to(x.dtype), aux
    g = einsum("bsd,df->bsf", h, lp["w_gate"].to(h.dtype))
    u = einsum("bsd,df->bsf", h, lp["w_up"].to(h.dtype))
    z = shard_hint(swiglu(g, u), "batch", "seq", "d_ff")
    y = einsum("bsf,fd->bsd", z, lp["w_down"].to(h.dtype))
    return y.to(x.dtype), None


def _prefill_layer(x, lp, cfg: LMConfig, positions, stream: bool = False):
    """-> (x, k, v, aux) of one layer. ``stream``: the training layer's
    hints (the reference's ``_layer_fn``): the residual stream pinned
    seq-sharded, and each branch's output resharded at its residual add;
    else the prefill layer's one hint, on its output. Either way the
    stream is gathered over seq once before attention and once before
    the FFN (the reference's training layer does so; its prefill layer
    leaves that to GSPMD, and DTensor's products are cut best from a
    whole seq)."""
    def hint(t, seq="seq"):
        return shard_hint(t, "batch", seq, "d_model")

    if stream:
        x = hint(x)
    q, k, v = _qkv(hint(x, None), lp, cfg, positions)
    o = attn_lib.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           impl=cfg.attention_impl, q_chunk=cfg.q_chunk,
                           kv_chunk=cfg.kv_chunk)
    x = _attn_out(x, o, lp, hint if stream else None)
    y, aux = _ffn_block(hint(x, None), lp, cfg)
    return hint(x + (hint(y) if stream else y)), k, v, aux


def _head(params: dict, cfg: LMConfig, x):
    cdt = torch_dtype(cfg.compute_dtype)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    head = gathered(params["lm_head"] if "lm_head" in params
                    else params["embed"].T)
    return softcap(einsum("bsd,dv->bsv", x, head.to(cdt)),
                   cfg.logits_softcap)


def _embed(params: dict, cfg: LMConfig, tokens):
    return embed_lookup(params["embed"].to(torch_dtype(cfg.compute_dtype)),
                        tokens)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def lm_logits(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> logits (B, S, V), and the MoE aux loss summed
    over the layers (float32; zero for a dense config). Differentiable;
    with ``cfg.remat`` and grad enabled each layer saves only its input
    and is recomputed in the backward pass, its aux included (the
    recompute routes exactly as the first pass: every op of the layer is
    deterministic)."""
    x = shard_hint(_embed(params, cfg, tokens), "batch", "seq", "d_model")
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in map(gathered, _layers(params)):
        if remat:
            x, _, _, aux_l = checkpoint(_prefill_layer, x, lp, cfg,
                                        positions, True, use_reentrant=False)
        else:
            x, _, _, aux_l = _prefill_layer(x, lp, cfg, positions, True)
        if aux_l is not None:
            aux = aux + aux_l
    return shard_hint(_head(params, cfg, x), "batch", "seq", "vocab"), aux


def lm_loss(params: dict, cfg: LMConfig, batch: dict):
    """batch: {"tokens": (B, S), "labels": (B, S), optional "mask"} ->
    (loss, {"ce": ..., "aux": ...}); the loss is the float32 mean token
    cross entropy plus the MoE aux loss."""
    logits, aux = lm_logits(params, cfg, batch["tokens"])
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """Full-sequence forward that also builds the KV cache.

    Returns (last-position logits (B, V), KVCache of (L, B, S, Hk, Dh));
    the MoE aux loss is dropped, as the reference drops it."""
    x = shard_hint(_embed(params, cfg, tokens), "batch", "seq", "d_model")
    positions = torch.arange(tokens.shape[1], device=x.device)
    ks, vs = [], []
    for lp in map(gathered, _layers(params)):
        x, k, v, _ = _prefill_layer(x, lp, cfg, positions)
        ks.append(k)
        vs.append(v)
    logits = _head(params, cfg, x[:, -1:])[:, 0]
    cache_axes = ("layers", "batch", "kv_seq", "kv_heads", "d_head")
    return logits, KVCache(shard_hint(torch.stack(ks), *cache_axes),
                           shard_hint(torch.stack(vs), *cache_axes))


@torch.no_grad()
def decode_step(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                cache: KVCache, pos: int):
    """One-token decode. tokens (B, 1); cache (L, B, S, Hk, Dh); pos (an
    int) is the position at which the new token sits. Returns (logits
    (B, V), cache); the new keys and values are written into ``cache``
    in place. A MoE step routes its B tokens alone (their own capacity)
    and drops the aux loss, as the reference does."""
    x = _embed(params, cfg, tokens)
    positions = torch.full((tokens.shape[0], 1), int(pos), device=x.device)
    for i, lp in enumerate(map(gathered, _layers(params))):
        q, k, v = _qkv(x, lp, cfg, positions)
        ck, cv = attn_lib.cache_update(cache.k[i], cache.v[i], k, v, pos)
        o = attn_lib.decode_attention(q, ck, cv, pos,
                                      window=cfg.sliding_window)
        x = _attn_out(x, o, lp)
        x = x + _ffn_block(x, lp, cfg)[0]
    return _head(params, cfg, x[:, -1:])[:, 0], cache
