"""Nougat-class high-quality parser, the port of
``repro/models/vit_parser.py``: a windowed-attention image encoder and a
causal cross-attention text decoder (Swin -> mBART, per Blecher et al.
2023), the expensive parser AdaParse routes hard documents to.

- The Swin windows are 1D windows over the flattened patch sequence,
  with a half-window shift (a roll) on every odd layer. The sequence is
  padded with zero rows up to a multiple of the window and the padded
  rows are not masked: as keys with k = v = 0 they take softmax weight
  inside the last window, as in the reference.
- The pixel -> patch frontend is a stub: inputs are flattened patch
  vectors (pages, n_patches, patch * patch * 3).

Public surface:
    init_vit_parser(cfg, generator, device)         -> params
    vit_parser_from_jax_params(raw, cfg, device)    -> params
    vit_parser_param_count(cfg)                     -> leaves' element count
    encode_pages(params, cfg, patches)              -> memory (B, N, De)
    decode_logits(params, cfg, memory, tokens)      -> (B, T, V)
    parser_loss(params, cfg, batch)                 -> loss, {}
    cross_kv(params, cfg, memory)                   -> (xk, xv)
    init_dec_state(params, cfg, memory)             -> DecState
    dec_step(params, cfg, tok, state, pos)          -> logits (B, V), state
    generate(params, cfg, patches, max_len)         -> tokens (B, max_len)

Params are a plain dict in the JAX package's raw layout: ``patch_proj
(P, De)``, ``patch_pos (N, De)``, ``enc_ln``, ``tok_embed (V, Dd)``,
``dec_ln``, ``lm_head (Dd, V)``, and ``enc_layers`` / ``dec_layers``,
whose leaves are stacked on a leading layer axis. Every norm is an RMS
norm whose scale starts at zero. Attention is the reference's: the
naive form in the encoder windows and both decoder attentions
(``models/attention.attention_naive``), and ``decode_attention`` over
the self-attention cache in ``dec_step``; RoPE with theta 1e4, which
the reference hard-codes. With ``cfg.remat`` and grad enabled each
encoder and decoder layer runs under ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint(nothing_saveable)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.common import default_generator, normal_init, param, unwrap, zeros_init
from repro_torch.configs.base import VitParserConfig
from repro_torch.distributed.meshrules import (einsum, gathered, local_op,
                                               shard_hint, whole_dims)
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_rope, cross_entropy_loss,
                                       embed_lookup, from_numpy, gelu,
                                       rms_norm, swiglu, torch_dtype)

ROPE_THETA = 1e4            # the reference's decoder hard-codes it


_W_IN = ("d_model", "heads", "d_head")
_W_OUT = ("heads", "d_head", "d_model")
_D = ("d_model",)


def _enc_layer_shapes(cfg: VitParserConfig) -> dict:
    """name -> (per-layer shape, init std, logical axes)."""
    de, he, fe = cfg.enc_d_model, cfg.enc_heads, cfg.enc_d_ff
    dhe = de // he
    return {
        "ln1": ((de,), 0.0, _D),
        "ln2": ((de,), 0.0, _D),
        "wq": ((de, he, dhe), de ** -0.5, _W_IN),
        "wk": ((de, he, dhe), de ** -0.5, _W_IN),
        "wv": ((de, he, dhe), de ** -0.5, _W_IN),
        "wo": ((he, dhe, de), de ** -0.5, _W_OUT),
        "w_in": ((de, fe), de ** -0.5, ("d_model", "d_ff")),
        "w_out": ((fe, de), fe ** -0.5, ("d_ff", "d_model")),
    }


def _dec_layer_shapes(cfg: VitParserConfig) -> dict:
    dd, hd, fd, de = (cfg.dec_d_model, cfg.dec_heads, cfg.dec_d_ff,
                      cfg.enc_d_model)
    dhd = dd // hd
    return {
        "ln1": ((dd,), 0.0, _D),
        "ln_x": ((dd,), 0.0, _D),
        "ln2": ((dd,), 0.0, _D),
        "wq": ((dd, hd, dhd), dd ** -0.5, _W_IN),
        "wk": ((dd, hd, dhd), dd ** -0.5, _W_IN),
        "wv": ((dd, hd, dhd), dd ** -0.5, _W_IN),
        "wo": ((hd, dhd, dd), dd ** -0.5, _W_OUT),
        "xq": ((dd, hd, dhd), dd ** -0.5, _W_IN),
        "xk": ((de, hd, dhd), de ** -0.5, _W_IN),
        "xv": ((de, hd, dhd), de ** -0.5, _W_IN),
        "xo": ((hd, dhd, dd), dd ** -0.5, _W_OUT),
        "w_gate": ((dd, fd), dd ** -0.5, ("d_model", "d_ff")),
        "w_up": ((dd, fd), dd ** -0.5, ("d_model", "d_ff")),
        "w_down": ((fd, dd), fd ** -0.5, ("d_ff", "d_model")),
    }


def _shapes(cfg: VitParserConfig) -> dict:
    """The whole tree: name -> (shape, std, logical axes), or a layer
    stack's (layer count, per-layer shapes)."""
    patch_dim = cfg.patch * cfg.patch * 3
    de, dd = cfg.enc_d_model, cfg.dec_d_model
    return {
        "patch_proj": ((patch_dim, de), patch_dim ** -0.5,
                       (None, "d_model")),
        "patch_pos": ((cfg.n_patches, de), 0.02, ("patches", "d_model")),
        "enc_layers": (cfg.enc_layers, _enc_layer_shapes(cfg)),
        "enc_ln": ((de,), 0.0, _D),
        "tok_embed": ((cfg.vocab_size, dd), 0.02, ("vocab", "d_model")),
        "dec_layers": (cfg.dec_layers, _dec_layer_shapes(cfg)),
        "dec_ln": ((dd,), 0.0, _D),
        "lm_head": ((dd, cfg.vocab_size), dd ** -0.5, ("d_model", "vocab")),
    }


def vit_parser_param_count(cfg: VitParserConfig) -> int:
    """The tree's element count, reckoned from the shapes (466,362,368
    at ``nougat-base``; the config's ``n_params`` says 372,375,552)."""
    total = 0
    for spec in _shapes(cfg).values():
        if isinstance(spec[1], dict):
            total += spec[0] * sum(math.prod(s[0])
                                   for s in spec[1].values())
        else:
            total += math.prod(spec[0])
    return total


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_vit_parser(cfg: VitParserConfig,
                    generator: torch.Generator | None = None,
                    device=None, keep_axes: bool = False) -> dict:
    """Random params in ``cfg.param_dtype`` on ``device`` (cuda unless
    "cpu"): normal(std) draws in float32 from ``generator``, which must
    live on that device (default: seed 0 there); the norm scales are
    zero (the norms scale by ``1 + scale``). On ``meta`` (any
    generator) nothing is drawn. With ``keep_axes`` the ``Param`` tree of
    their logical axes."""
    dev = device_lib.resolve(device)
    g = generator if generator is not None else \
        default_generator(dev)
    if dev.type != "meta" and torch.device(g.device).type != dev.type:
        raise ValueError(f"init_vit_parser: generator on {g.device}, "
                         f"params on {dev}; draw on the params' device")
    dtype = torch_dtype(cfg.param_dtype)

    def draw(shape, std, axes):
        init = zeros_init if std == 0.0 else normal_init(std)
        return param(g, shape, axes, init, dtype, device=dev)

    params = {}
    for name, spec in _shapes(cfg).items():
        if isinstance(spec[1], dict):
            params[name] = {k: draw((spec[0],) + s, std, ("layers",) + ax)
                            for k, (s, std, ax) in spec[1].items()}
        else:
            params[name] = draw(*spec)
    return params if keep_axes else unwrap(params)


@torch.no_grad()
def vit_parser_from_jax_params(raw: dict, cfg: VitParserConfig,
                               device=None) -> dict:
    """The JAX package's raw parser params (numpy leaves, ``unwrap``-ed
    ``init_vit_parser``) -> the port's params with the same values, bf16
    bit for bit. Raises on a missing, extra or misshapen leaf."""
    dev = device_lib.resolve(device)
    dtype = torch_dtype(cfg.param_dtype)
    shapes = _shapes(cfg)

    def take(a, shape, where):
        t = from_numpy(a)
        if tuple(t.shape) != shape:
            raise ValueError(f"vit_parser param{where}: shape "
                             f"{tuple(t.shape)} != {shape}")
        return t.to(device=dev, dtype=dtype)

    def keys_match(tree, want, where):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"vit_parser params{where}: keys {got} != "
                             f"{sorted(want)}")

    keys_match(raw, shapes, "")
    out = {}
    for name, spec in shapes.items():
        if isinstance(spec[1], dict):
            keys_match(raw[name], spec[1], f"[{name!r}]")
            out[name] = {k: take(raw[name][k], (spec[0],) + s,
                                 f"[{name!r}][{k!r}]")
                         for k, (s, *_) in spec[1].items()}
        else:
            out[name] = take(raw[name], spec[0], f"[{name!r}]")
    return out


def _layers(stack: dict) -> list[dict]:
    """Each layer's leaves, the stacked (L, ...) leaves taken apart once
    with ``unbind`` (its backward stacks the L grads once)."""
    names = list(stack)
    return [dict(zip(names, vals))
            for vals in zip(*(stack[k].unbind(0) for k in names))]


# ---------------------------------------------------------------------------
# Encoder: 1D windowed attention with alternating shifts
# ---------------------------------------------------------------------------


def _window_attn(x, lp, cfg: VitParserConfig, shift: int):
    """x: (B, N, D) -> windowed self-attention, window size cfg.window:
    roll by -shift, pad with zero rows to a multiple of the window (not
    masked), attend within each window, crop, roll back by +shift."""
    b, n, d = x.shape
    w = cfg.window
    pad = (-n) % w
    x_sh = local_op(lambda t: F.pad(torch.roll(t, -shift, dims=1),
                                    (0, 0, 0, pad)), x, (1,),
                    (b, n + pad, d))
    xw = x_sh.reshape(b * ((n + pad) // w), w, d)
    q = einsum("bsd,dhk->bshk", xw, lp["wq"].to(xw.dtype))
    k = einsum("bsd,dhk->bshk", xw, lp["wk"].to(xw.dtype))
    v = einsum("bsd,dhk->bshk", xw, lp["wv"].to(xw.dtype))
    o = attn_lib.attention_naive(q, k, v, causal=False)
    o = einsum("bshk,hkd->bsd", o, lp["wo"].to(o.dtype))
    o = o.reshape(b, n + pad, d)[:, :n]
    return local_op(lambda t: torch.roll(t, shift, dims=1), o, (1,),
                    (b, n, d))


def _enc_layer(x, lp, cfg: VitParserConfig, shift: int):
    """One encoder layer; on a mesh the patch-cut stream is taken whole
    over its patches into the window attention and the FFN (a layout of
    the port's own: DTensor cuts their products best from whole
    patches)."""
    cdt = torch_dtype(cfg.compute_dtype)

    def whole_patches(t):
        return shard_hint(t, "pages", None, "d_model")

    h = whole_patches(rms_norm(x, lp["ln1"], cfg.norm_eps))
    x = x + _window_attn(h, lp, cfg, shift)
    h = whole_patches(rms_norm(x, lp["ln2"], cfg.norm_eps))
    h = gelu(einsum("bnd,df->bnf", h, lp["w_in"].to(cdt)))
    h = shard_hint(h, "pages", "patches", "d_ff")
    return shard_hint(x + einsum("bnf,fd->bnd", h, lp["w_out"].to(cdt)),
                      "pages", "patches", "d_model")


def encode_pages(params: dict, cfg: VitParserConfig,
                 patches: torch.Tensor) -> torch.Tensor:
    """patches: (B_pages, n_patches, patch*patch*3) -> (B_pages, N, De).
    Layer i shifts its windows by ``window // 2`` when i is odd."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = einsum("bnp,pd->bnd", patches.to(cdt),
                     gathered(params["patch_proj"]).to(cdt))
    x = x + params["patch_pos"].to(cdt)[None]
    x = shard_hint(x, "pages", "patches", "d_model")
    half = cfg.window // 2
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(map(gathered, _layers(params["enc_layers"]))):
        shift = 0 if i % 2 == 0 else half
        x = (checkpoint(_enc_layer, x, lp, cfg, shift, use_reentrant=False)
             if remat else _enc_layer(x, lp, cfg, shift))
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _ffn(x, lp, cfg: VitParserConfig, hint: bool = False):
    """The SwiGLU FFN and its residual add; ``hint``: the teacher-forced
    layer's hints (``dec_step`` has none, as in the reference)."""
    cdt = torch_dtype(cfg.compute_dtype)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    z = swiglu(einsum("bsd,df->bsf", h, lp["w_gate"].to(cdt)),
               einsum("bsd,df->bsf", h, lp["w_up"].to(cdt)))
    if hint:
        z = shard_hint(z, "pages", "seq", "d_ff")
    x = x + einsum("bsf,fd->bsd", z, lp["w_down"].to(cdt))
    return shard_hint(x, "pages", "seq", "d_model") if hint else x


def _self_qkv(x, lp, cfg: VitParserConfig, positions):
    cdt = torch_dtype(cfg.compute_dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = einsum("bsd,dhk->bshk", h, lp["wq"].to(cdt))
    k = einsum("bsd,dhk->bshk", h, lp["wk"].to(cdt))
    v = einsum("bsd,dhk->bshk", h, lp["wv"].to(cdt))
    return (apply_rope(q, positions, ROPE_THETA),
            apply_rope(k, positions, ROPE_THETA), v)


def _dec_layer_fn(cfg: VitParserConfig, memory, positions, causal=True):
    """The teacher-forced decoder layer ``(x, lp) -> x`` over ``memory``
    (B, N, De) at ``positions`` (T,): causal self-attention, then
    cross-attention (keys and values projected from the memory in each
    layer), then the SwiGLU FFN."""
    cdt = torch_dtype(cfg.compute_dtype)

    def layer(x, lp):
        q, k, v = _self_qkv(x, lp, cfg, positions)
        o = attn_lib.attention(q, k, v, causal=causal, impl="naive")
        x = x + einsum("bshk,hkd->bsd", o, lp["wo"].to(cdt))
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = einsum("bsd,dhk->bshk", h, lp["xq"].to(cdt))
        k = einsum("bnd,dhk->bnhk", memory, lp["xk"].to(cdt))
        v = einsum("bnd,dhk->bnhk", memory, lp["xv"].to(cdt))
        o = attn_lib.attention_naive(q, k, v, causal=False)
        x = x + einsum("bshk,hkd->bsd", o, lp["xo"].to(cdt))
        return _ffn(x, lp, cfg, hint=True)

    return layer


def _head(params: dict, cfg: VitParserConfig, x):
    x = rms_norm(x, params["dec_ln"], cfg.norm_eps)
    return einsum("bsd,dv->bsv", x,
                        gathered(params["lm_head"]).to(
                            torch_dtype(cfg.compute_dtype)))


def decode_logits(params: dict, cfg: VitParserConfig, memory: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass. memory (B, N, De); tokens (B, T) ->
    logits (B, T, V) in the compute dtype."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["tok_embed"].to(cdt), tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    layer = _dec_layer_fn(cfg, memory, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in map(gathered, _layers(params["dec_layers"])):
        x = (checkpoint(layer, x, lp, use_reentrant=False) if remat
             else layer(x, lp))
    return _head(params, cfg, x)


def parser_loss(params: dict, cfg: VitParserConfig, batch: dict):
    """Training objective: the float32 mean token cross entropy of the
    page text given the page patches. batch: ``patches`` (B, N, P),
    ``tokens`` and ``labels`` (B, T), optional ``mask``. -> (loss, {})."""
    memory = encode_pages(params, cfg, batch["patches"])
    logits = decode_logits(params, cfg, memory, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"],
                              batch.get("mask")), {}


# -- autoregressive generation ----------------------------------------------


class DecState(NamedTuple):
    cache: KVCache            # self-attention (L, B, S, H, Dh)
    xk: torch.Tensor          # cross-attn keys  (L, B, N, H, Dh)
    xv: torch.Tensor


@torch.no_grad()
def cross_kv(params: dict, cfg: VitParserConfig, memory: torch.Tensor):
    """Every decoder layer's cross-attention keys and values of
    ``memory`` (B, N, De): two (L, B, N, H, Dh) tensors in the compute
    dtype (what the parse_encode step returns)."""
    cdt = torch_dtype(cfg.compute_dtype)
    memory = shard_hint(memory, "pages", None, "d_model")
    return tuple(shard_hint(einsum("bnd,ldhk->lbnhk", memory,
                                         gathered(params["dec_layers"][name])
                                         .to(cdt)),
                            "layers", "pages", "patches", "heads", "d_head")
                 for name in ("xk", "xv"))


@torch.no_grad()
def init_dec_state(params: dict, cfg: VitParserConfig,
                   memory: torch.Tensor) -> DecState:
    """``cross_kv`` of ``memory`` and a zero self-attention cache of
    ``cfg.max_dec_len`` positions."""
    shape = (cfg.dec_layers, memory.shape[0], cfg.max_dec_len,
             cfg.dec_heads, cfg.dec_d_model // cfg.dec_heads)
    cdt = torch_dtype(cfg.compute_dtype)
    cache = KVCache(torch.zeros(shape, dtype=cdt, device=memory.device),
                    torch.zeros(shape, dtype=cdt, device=memory.device))
    return DecState(cache, *cross_kv(params, cfg, memory))


@torch.no_grad()
def dec_step(params: dict, cfg: VitParserConfig, tok: torch.Tensor,
             state: DecState, pos: int):
    """One decode token: tok (B, 1) at position ``pos`` (an int) ->
    (logits (B, V), state); the new keys and values are written into
    ``state.cache`` in place. The cross-attention takes its scores in
    float32, its softmax weights rounded to the compute dtype before the
    PV product, as the reference does."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["tok_embed"].to(cdt), tok)
    positions = torch.full((tok.shape[0], 1), int(pos), device=x.device)
    for i, lp in enumerate(map(gathered, _layers(params["dec_layers"]))):
        q, k, v = _self_qkv(x, lp, cfg, positions)
        ck, cv = attn_lib.cache_update(state.cache.k[i], state.cache.v[i],
                                       k, v, pos)
        o = attn_lib.decode_attention(q, ck, cv, pos)
        x = x + einsum("bshk,hkd->bsd", o, lp["wo"].to(cdt))
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = whole_dims(einsum("bsd,dhk->bshk", h, lp["xq"].to(cdt)),
                       (2,))
        s = einsum("bqhd,bnhd->bhqn", q.float(), state.xk[i].float())
        s = s * (q.shape[-1] ** -0.5)
        p = torch.softmax(s, dim=-1).to(cdt)
        o = einsum("bhqn,bnhd->bqhd", p, state.xv[i])
        x = x + einsum("bqhd,hdm->bqm", o, lp["xo"].to(cdt))
        x = _ffn(x, lp, cfg)
    return _head(params, cfg, x[:, -1:])[:, 0], state


@torch.no_grad()
def generate(params: dict, cfg: VitParserConfig, patches: torch.Tensor,
             max_len: int, bos_id: int = 1) -> torch.Tensor:
    """Greedy autoregressive page parse from ``bos_id``: (B, max_len)
    int32 tokens, each the first maximum of its step's logits (as
    ``jnp.argmax``)."""
    memory = encode_pages(params, cfg, patches)
    state = init_dec_state(params, cfg, memory)
    tok = torch.full((patches.shape[0], 1), bos_id, dtype=torch.int32,
                     device=patches.device)
    out = []
    for pos in range(max_len):
        logits, state = dec_step(params, cfg, tok, state, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1)
