"""Shared neural layers of the port (``repro.models.layers``): layer and
RMS norms computed in float32 and their inits, rotary embeddings, the
dense layer, plain MLP stacks, tanh-GELU, SwiGLU, the logit soft cap,
the embedding init and lookup and the LM's cross-entropy loss; plus the
dtype-name map and the numpy-to-tensor copy that carry the JAX package's
params across.

The inits draw random tensors in float32 from an explicit
``torch.Generator`` on ``device`` and cast them to ``dtype``;
``abstract=True`` gives the same shapes and dtypes on
``torch.device("meta")`` and draws nothing. They return plain tensors,
or with ``keep_axes=True`` the reference's ``Param`` tree: each tensor
with its logical axes (``repro_torch.common``), which the mesh rules
(``distributed/meshrules.py``) map onto a mesh."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.common import (Param, normal_init, ones_init, param, unwrap,
                                zeros_init)
from repro_torch.distributed.meshrules import (is_dtensor, shard_hint,
                                               whole_dims)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ...) -> the torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def from_numpy(a) -> torch.Tensor:
    """A writable tensor copy of a numpy leaf, bfloat16 (``ml_dtypes``,
    which numpy has no native type for) included, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalise the last axis in float32 and scale by ``1 + scale``
    (the LM's scales start at zero), return in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Normalise over the last axis in float32, return in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def _init_device(abstract: bool, device):
    return torch.device("meta") if abstract else device_lib.resolve(device)


def _param(generator, shape, axes, init, dtype, abstract: bool,
           device) -> Param:
    return param(generator, shape, axes, init, dtype, abstract,
                 None if abstract else device_lib.resolve(device))


def _out(tree, keep_axes: bool):
    return tree if keep_axes else unwrap(tree)


def init_rms_norm(d: int, dtype, abstract: bool = False,
                  layers: int | None = None, device=None,
                  keep_axes: bool = False):
    """The RMS norm's scale, zeros of (d,) or (layers, d) (the norm
    scales by ``1 + scale``)."""
    shape = (d,) if layers is None else (layers, d)
    axes = ("d_model",) if layers is None else ("layers", "d_model")
    return _out(_param(None, shape, axes, zeros_init, dtype, abstract,
                       device), keep_axes)


def init_layer_norm(d: int, dtype, abstract: bool = False,
                    layers: int | None = None, device=None,
                    keep_axes: bool = False) -> dict:
    """The layer norm's ``scale`` (ones) and ``bias`` (zeros), (d,) or
    (layers, d)."""
    shape = (d,) if layers is None else (layers, d)
    axes = ("d_model",) if layers is None else ("layers", "d_model")
    return _out({"scale": _param(None, shape, axes, ones_init, dtype,
                                 abstract, device),
                 "bias": _param(None, shape, axes, zeros_init, dtype,
                                abstract, device)}, keep_axes)


def rope_frequencies(d_head: int, theta: float,
                     device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to
    (..., seq). Rotates the two halves of the head (not interleaved
    pairs), with angles in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (half,)
    angles = positions[..., :, None].float() * freqs              # (..., S, half)
    angles = angles[..., :, None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(generator: torch.Generator | None, d_in: int, d_out: int,
               axes: Sequence[str | None], dtype, abstract: bool = False,
               bias: bool = False, layers: int | None = None,
               stddev: float | None = None, device=None,
               keep_axes: bool = False) -> dict:
    """A dense layer ``{"w": (d_in, d_out)}`` (``(layers, d_in, d_out)``
    with ``layers``), plus a zero ``"b"`` of (d_out,) or (layers, d_out)
    with ``bias``. ``w`` is normal(stddev), or LeCun-normal on d_in
    (std ``d_in ** -0.5``) without one. ``axes`` names w's logical axes
    (a leading ``"layers"`` is added with ``layers``); the bias takes
    the last."""
    shape = (d_in, d_out)
    axes = tuple(axes)
    if layers is not None:
        shape, axes = (layers,) + shape, ("layers",) + axes
    std = stddev if stddev is not None else 1.0 / math.sqrt(max(d_in, 1))
    p = {"w": _param(generator, shape, axes, normal_init(std), dtype,
                     abstract, device)}
    if bias:
        bshape = (d_out,) if layers is None else (layers, d_out)
        baxes = (axes[-1],) if layers is None else ("layers", axes[-1])
        p["b"] = _param(None, bshape, baxes, zeros_init, dtype, abstract,
                        device)
    return _out(p, keep_axes)


def dense(x: torch.Tensor, p: dict,
          out_hint: tuple[str | None, ...] | None = None) -> torch.Tensor:
    """``x @ w`` (w cast to x's dtype), plus ``b`` in the product's
    dtype when the layer has one. ``out_hint`` names the output's logical
    axes (``meshrules.shard_hint``; nothing with no rules in force)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if out_hint is not None:
        y = shard_hint(y, *out_hint)
    return y


def mlp_stack(generator: torch.Generator | None, dims: Sequence[int], dtype,
              abstract: bool = False, in_axis: str | None = None,
              hidden_axis: str | None = "d_ff", bias: bool = True,
              device=None, keep_axes: bool = False) -> list[dict]:
    """A plain MLP as a list of ``init_dense`` layers dims[i] ->
    dims[i + 1], drawn from ``generator`` in order; hidden dims on
    ``hidden_axis``, the input on ``in_axis``, the output replicated."""
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        last = i == len(dims) - 2
        axes = (in_axis if i == 0 else hidden_axis,
                None if last else hidden_axis)
        layers.append(init_dense(generator, a, b, axes, dtype, abstract,
                                 bias=bias, device=device,
                                 keep_axes=keep_axes))
    return layers


def mlp_apply(x: torch.Tensor, layers: list[dict], act=F.relu,
              final_act=None) -> torch.Tensor:
    """``dense`` through each layer, ``act`` between them and
    ``final_act`` (if any) after the last."""
    for i, p in enumerate(layers):
        x = dense(x, p)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in float32: ``logsumexp`` minus the
    gold logit. logits (..., V), labels (...); with a mask, the masked
    mean ``sum(nll * mask) / max(sum(mask), 1)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def init_embedding(generator: torch.Generator | None, vocab: int, d: int,
                   dtype, abstract: bool = False, axes=("vocab", "d_model"),
                   device=None, keep_axes: bool = False):
    """A (vocab, d) table drawn from normal(0.02), on logical ``axes``."""
    return _out(_param(generator, (vocab, d), axes, normal_init(0.02),
                       dtype, abstract, device), keep_axes)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                 mode: str = "fill") -> torch.Tensor:
    """``table[ids]`` along the first axis with JAX's gather semantics
    instead of an indexing error: negative ids count from the end, and
    ids outside [-R, R) give a NaN row (the dtype's minimum for integer
    tables) under ``mode="fill"`` (``jnp.take``), or the nearest row
    under ``mode="clip"`` (``x[ids]`` on a JAX array). One
    ``index_select``; for ``fill``, one host synchronisation asks whether
    any id is out of range, and only then is the mask written in place,
    so there is never a second buffer of the result's size nor, in the
    common case, a second pass over it.

    The gather is ``F.embedding`` (an ``index_select`` forward) for its
    backward: ``index_select``'s accumulates the table's gradient with
    ``index_add_``, whose atomics on CUDA sum repeated ids in a varying
    order, so two trainings would differ in the last bits; the
    embedding backward sums them in a fixed order."""
    if mode not in ("fill", "clip"):
        raise ValueError(f"embed_lookup: mode must be fill or clip "
                         f"(got {mode!r})")
    if is_dtensor(ids):
        # the ids whole on every rank, so the range check below gives
        # every rank the same answer and the gather sees a plain index
        ids = ids.full_tensor()
    r = table.shape[0]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + r, flat)
    rows = F.embedding(flat.clamp(0, max(r - 1, 0)), table.reshape(r, -1))
    # a row-sharded table gives masked partial sums tied to this shape:
    # sum them before any view
    rows = whole_dims(rows, ())
    rows = rows.view((-1,) + tuple(table.shape[1:]))
    # a meta lookup (the dry run) has no ids to test: its shape is the
    # same whether any row is filled or not
    if mode == "fill" and not flat.is_meta:
        oob = (flat < 0) | (flat >= r)
        if bool(oob.any()):
            fill = (float("nan") if table.is_floating_point()
                    else torch.iinfo(table.dtype).min)
            mask = oob.view((-1,) + (1,) * (table.dim() - 1))
            if is_dtensor(rows):
                # a row-sharded table's rows are partial sums: no write
                # in place
                rows = torch.where(mask, fill, rows)
            else:
                rows.masked_fill_(mask, fill)
    return rows.view(tuple(ids.shape) + tuple(table.shape[1:]))
