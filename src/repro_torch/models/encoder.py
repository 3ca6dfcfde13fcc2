"""BERT-style bidirectional encoder — the AdaParse CLS-III router model
(SciBERT-class, ~110M at full config), as an ``nn.Module``. Supports:

- per-parser accuracy regression head (m outputs in [0,1]) — stage-1 SFT
  target of Appendix A;
- scalar preference head — the g_phi scorer used by DPO (stage 2);
- multi-class parser-selection readout (argmax over predicted accuracies).

Parameters keep the JAX package's layouts (``wq (d, h, dh)``,
``wo (h, dh, d)``, ``w_in (d, f)``, ...) and names, so
``encoder_from_jax_params`` carries its weights across unchanged and
both packages compute the same function. Attention is the plain einsum
form of ``repro/models/encoder.py``: the QK product is taken into
float32 (as ``preferred_element_type=f32`` does), the mask bias is
-1e30, and the softmax runs in float32 before casting to the compute
dtype.

Parameters are created with ``requires_grad=False``: serving runs under
``torch.inference_mode``, and the trainers of ``core/dpo.py`` switch
grads on for the length of a fit. With ``cfg.remat`` set and grad
enabled, each layer runs under ``torch.utils.checkpoint`` and saves only
its input, recomputing the rest in the backward pass: the counterpart of
the JAX package's ``jax.checkpoint(nothing_saveable)``, with the same
values. ``scan_layers`` has no counterpart (the layers are a Python
loop either way).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.configs.base import EncoderConfig
from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import (embed_lookup, from_numpy, gelu,
                                      layer_norm, torch_dtype as _dtype)


def _layer_shapes(cfg: EncoderConfig) -> dict:
    """name -> (shape, init std or "zeros"/"ones"), in the JAX package's
    initialisation order."""
    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    dh = d // h
    return {
        "wq": ((d, h, dh), d ** -0.5),
        "wk": ((d, h, dh), d ** -0.5),
        "wv": ((d, h, dh), d ** -0.5),
        "wo": ((h, dh, d), d ** -0.5),
        "ln1_s": ((d,), "ones"),
        "ln1_b": ((d,), "zeros"),
        "w_in": ((d, f), d ** -0.5),
        "b_in": ((f,), "zeros"),
        "w_out": ((f, d), f ** -0.5),
        "b_out": ((d,), "zeros"),
        "ln2_s": ((d,), "ones"),
        "ln2_b": ((d,), "zeros"),
    }


def _top_shapes(cfg: EncoderConfig) -> dict:
    d = cfg.d_model
    return {
        "tok_embed": ((cfg.vocab_size, d), 0.02),
        "pos_embed": ((cfg.max_len, d), 0.02),
        "ln_embed_s": ((d,), "ones"),
        "ln_embed_b": ((d,), "zeros"),
        "pool_w": ((d, d), d ** -0.5),
        "pool_b": ((d,), "zeros"),
        "head_w": ((d, cfg.n_outputs), d ** -0.5),
        "head_b": ((cfg.n_outputs,), "zeros"),
        "pref_w": ((d, 1), d ** -0.5),
        "pref_b": ((1,), "zeros"),
    }


def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.zeros(s, dtype=dtype, device=device),
                        requires_grad=False)
        for k, (s, _) in shapes.items()})


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.p = _params(_layer_shapes(cfg), _dtype(cfg.param_dtype), device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                cfg: EncoderConfig) -> torch.Tensor:
        p = self.p
        cdt = _dtype(cfg.compute_dtype)
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
        dh = q.shape[-1]
        # compute-dtype operands are exact in float32, so this is the
        # float32-accumulated product preferred_element_type=f32 gives
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * dh ** -0.5
        s = s + bias[:, None, None, :]
        prob = torch.softmax(s, dim=-1).to(cdt)
        o = torch.einsum("bhqk,bkhd->bqhd", prob, v)
        o = torch.einsum("bqhd,hdm->bqm", o, p["wo"].to(cdt))
        x = layer_norm(x + o, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        h = gelu(torch.einsum("bsd,df->bsf", x, p["w_in"].to(cdt))
                 + p["b_in"].to(cdt))
        h = torch.einsum("bsf,fd->bsd", h, p["w_out"].to(cdt)) \
            + p["b_out"].to(cdt)
        return layer_norm(x + h, p["ln2_s"], p["ln2_b"], cfg.norm_eps)


class Encoder(nn.Module):
    """The CLS-III encoder; parameters in ``cfg.param_dtype`` on
    ``device`` (zeros until loaded — see ``init_encoder`` and
    ``encoder_from_jax_params``)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = device_lib.resolve(device)
        self.p = _params(_top_shapes(cfg), _dtype(cfg.param_dtype), dev)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.p["tok_embed"].device

    def encode(self, tokens: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S) -> pooled CLS representation (B, D)."""
        cfg, p = self.cfg, self.p
        cdt = _dtype(cfg.compute_dtype)
        b, s = tokens.shape
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32,
                              device=tokens.device)
        x = embed_lookup(p["tok_embed"].to(cdt), tokens)
        x = x + p["pos_embed"][:s].to(cdt)[None]
        x = layer_norm(x, p["ln_embed_s"], p["ln_embed_b"], cfg.norm_eps)
        bias = torch.where(mask > 0, 0.0, NEG_INF).float()
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (checkpoint(layer, x, bias, cfg, use_reentrant=False)
                 if remat else layer(x, bias, cfg))
        return torch.tanh(x[:, 0] @ p["pool_w"].to(cdt) + p["pool_b"].to(cdt))

    def predict_accuracies(self, tokens, mask=None) -> torch.Tensor:
        """(B, S) tokens -> (B, m) predicted per-parser accuracy in [0, 1]."""
        pooled = self.encode(tokens, mask)
        out = pooled @ self.p["head_w"].to(pooled.dtype) \
            + self.p["head_b"].to(pooled.dtype)
        return torch.sigmoid(out.float())

    forward = predict_accuracies

    def preference_score(self, tokens, mask=None) -> torch.Tensor:
        """g_phi(x): positive scalar preference density (B,) for DPO."""
        pooled = self.encode(tokens, mask)
        z = pooled @ self.p["pref_w"].to(pooled.dtype) \
            + self.p["pref_b"].to(pooled.dtype)
        return torch.nn.functional.softplus(z.float())[:, 0] + 1e-6

    def regression_loss(self, batch: dict) -> torch.Tensor:
        """L_REG = E ||pi(x) - y||^2 with a validity mask over parsers."""
        pred = self.predict_accuracies(batch["tokens"], batch.get("mask"))
        y = batch["targets"].float()
        err = (pred - y).square()
        w = batch.get("target_mask")
        if w is not None:
            w = w.float()
            return (err * w).sum() / torch.clamp(w.sum(), min=1.0)
        return err.mean()


def _named_params(enc: Encoder):
    """(jax-style name, layer index or None, parameter) in the JAX
    package's initialisation order."""
    cfg = enc.cfg
    for k in ("tok_embed", "pos_embed", "ln_embed_s", "ln_embed_b"):
        yield k, None, enc.p[k]
    for k in _layer_shapes(cfg):
        for i, layer in enumerate(enc.layers):
            yield k, i, layer.p[k]
    for k in ("pool_w", "pool_b", "head_w", "head_b", "pref_w", "pref_b"):
        yield k, None, enc.p[k]


@torch.no_grad()
def init_encoder(cfg: EncoderConfig, generator: torch.Generator | None = None,
                 device=None) -> Encoder:
    """Random encoder params in ``cfg.param_dtype``: normal(std) weights
    drawn in float32 from ``generator`` (a CPU generator; default seed
    0), ones for norm scales, zeros for biases."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    enc = Encoder(cfg, device)
    shapes = {**_top_shapes(cfg), **_layer_shapes(cfg)}
    for name, _, prm in _named_params(enc):
        shape, init = shapes[name]
        if init == "ones":
            prm.fill_(1.0)
        elif init == "zeros":
            prm.zero_()
        else:
            prm.copy_((torch.randn(shape, generator=g) * init).to(prm.dtype))
    return enc


@torch.no_grad()
def encoder_from_jax_params(raw: dict, cfg: EncoderConfig,
                            device=None) -> Encoder:
    """The JAX package's raw encoder param dict (numpy leaves, per-layer
    weights stacked on a leading axis under ``"layers"``, as
    ``WorkerSpec`` ships them) -> the port's module with the same
    tensors."""
    enc = Encoder(cfg, device)
    for name, i, prm in _named_params(enc):
        src = raw["layers"][name][i] if i is not None else raw[name]
        t = from_numpy(src)
        if tuple(t.shape) != tuple(prm.shape):
            raise ValueError(f"encoder param {name}"
                             f"{'' if i is None else f'[{i}]'}: shape "
                             f"{tuple(t.shape)} != {tuple(prm.shape)}")
        prm.copy_(t.to(prm.dtype))
    return enc


@torch.no_grad()
def encoder_to_jax_params(enc: Encoder) -> dict:
    """The inverse of ``encoder_from_jax_params``: the JAX package's raw
    param dict with numpy leaves on the host, per-layer weights stacked
    on a leading axis under ``"layers"``. numpy has no bfloat16, so bf16
    params come out as float32, which holds them exactly and which
    ``encoder_from_jax_params`` casts back to ``cfg.param_dtype``."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    layers: dict = {}
    raw: dict = {"layers": layers}
    for name, i, prm in _named_params(enc):
        if i is None:
            raw[name] = host(prm)
        else:
            layers.setdefault(name, []).append(host(prm))
    for name, per_layer in layers.items():
        layers[name] = np.stack(per_layer)
    return raw
