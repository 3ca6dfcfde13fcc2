"""Feature-interaction ops, the port of
``repro/models/recsys/interactions.py``: the DLRM dot interaction, the
FM term, AutoInt's self-attention layer, and DIEN's GRU, AUGRU and
target attention. Every product here is a plain ``torch`` matmul or
einsum: the JAX package leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshrules import einsum


def dot_interaction(vecs: torch.Tensor,
                    keep_self: bool = False) -> torch.Tensor:
    """DLRM pairwise dots. vecs (B, F, D) -> (B, F*(F-1)/2 [+F])."""
    f = vecs.shape[1]
    g = einsum("bfd,bgd->bfg", vecs, vecs)
    iu, ju = torch.triu_indices(f, f, offset=0 if keep_self else 1,
                                device=vecs.device)
    return g[:, iu, ju]


def fm_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """2nd-order FM term: 0.5 * sum_d ((Σ_f v)^2 - Σ_f v^2). (B, F, D)->(B,)."""
    s = vecs.sum(1)
    sq = vecs.square().sum(1)
    return 0.5 * (s.square() - sq).sum(-1)


def autoint_layer(x: torch.Tensor, p: dict, n_heads: int) -> torch.Tensor:
    """Multi-head self-attention over feature fields with ReLU residual.

    x (B, F, D_in); p: wq/wk/wv (D_in, H, Dh), w_res (D_in, H*Dh). The
    scores are float32 products of the compute-dtype q and k (the JAX
    function's ``preferred_element_type``: a product of two bf16 values
    is exact in float32), the softmax is taken in float32 and cast back.
    """
    q = einsum("bfd,dhk->bfhk", x, p["wq"].to(x.dtype))
    k = einsum("bfd,dhk->bfhk", x, p["wk"].to(x.dtype))
    v = einsum("bfd,dhk->bfhk", x, p["wv"].to(x.dtype))
    s = einsum("bfhk,bghk->bhfg", q.float(), k.float())
    a = torch.softmax(s * (q.shape[-1] ** -0.5), dim=-1).to(x.dtype)
    o = einsum("bhfg,bghk->bfhk", a, v)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    res = einsum("bfd,de->bfe", x, p["w_res"].to(x.dtype))
    return F.relu(o + res)


# ---------------------------------------------------------------------------
# GRU / AUGRU (DIEN)
# ---------------------------------------------------------------------------


def gru_scan(x: torch.Tensor, p: dict, h0: torch.Tensor | None = None,
             unroll: bool = False) -> torch.Tensor:
    """GRU over time. x (B, T, D) -> hidden states (B, T, H).

    A Python loop over T, blended as the reference's cell is:
    ``h = (1 - z) * n + z * h``. ``unroll`` is accepted for the JAX
    signature (``lax.scan``'s unrolling) and changes nothing here: torch
    runs the loop eagerly either way."""
    del unroll
    b = x.shape[0]
    h_dim = p["wh_z"].shape[1]
    h = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    hs = []
    for t in range(x.shape[1]):
        xt = x[:, t]
        z = torch.sigmoid(xt @ p["wx_z"] + h @ p["wh_z"] + p["b_z"])
        r = torch.sigmoid(xt @ p["wx_r"] + h @ p["wh_r"] + p["b_r"])
        n = torch.tanh(xt @ p["wx_n"] + (r * h) @ p["wh_n"] + p["b_n"])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, 1)


def augru_scan(x: torch.Tensor, att: torch.Tensor, p: dict,
               h0: torch.Tensor | None = None,
               unroll: bool = False) -> torch.Tensor:
    """AUGRU: attention-scaled update gate (DIEN interest evolution).

    x (B, T, D); att (B, T) attention scores; returns the final hidden
    state (B, H). Blended as the reference's cell is, the other way
    round from ``gru_scan``: ``z *= att``, then ``h = (1 - z) * h + z *
    n``. ``unroll`` changes nothing, as in ``gru_scan``."""
    del unroll
    b = x.shape[0]
    h_dim = p["wh_z"].shape[1]
    h = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    for t in range(x.shape[1]):
        xt, at = x[:, t], att[:, t]
        z = torch.sigmoid(xt @ p["wx_z"] + h @ p["wh_z"] + p["b_z"])
        z = z * at[:, None]                 # attentional update gate
        r = torch.sigmoid(xt @ p["wx_r"] + h @ p["wh_r"] + p["b_r"])
        n = torch.tanh(xt @ p["wx_n"] + (r * h) @ p["wh_n"] + p["b_n"])
        h = (1 - z) * h + z * n
    return h


@torch.no_grad()
def draw(shape, std: float | None, dtype: torch.dtype,
         generator: torch.Generator, device=None) -> torch.Tensor:
    """normal(0, std) drawn in float32 from ``generator`` on ``device``
    (the generator's own by default; ``meta`` draws nothing) and cast to
    ``dtype``; zeros when ``std`` is None."""
    dev = generator.device if device is None else device
    if std is None:
        return torch.zeros(shape, dtype=dtype, device=dev)
    return (torch.randn(shape, generator=generator, device=dev)
            * std).to(dtype)


def gru_shapes(d_in: int, d_hidden: int) -> dict:
    """Each GRU leaf's (shape, std, logical axes): weights normal(0,
    fan_in^-0.5), biases zero (std None), every dim replicated."""
    p = {}
    for g in ("z", "r", "n"):
        p[f"wx_{g}"] = ((d_in, d_hidden), d_in ** -0.5, (None, None))
        p[f"wh_{g}"] = ((d_hidden, d_hidden), d_hidden ** -0.5,
                        (None, None))
        p[f"b_{g}"] = ((d_hidden,), None, (None,))
    return p


def init_gru(generator: torch.Generator, d_in: int, d_hidden: int,
             dtype: torch.dtype) -> dict:
    """GRU params drawn from ``generator`` on its device (``draw``)."""
    return {k: draw(shape, std, dtype, generator)
            for k, (shape, std, _) in gru_shapes(d_in, d_hidden).items()}


def attention_scores(hist: torch.Tensor, target: torch.Tensor,
                     p: dict) -> torch.Tensor:
    """DIN-style attention: MLP([h, t, h*t, h-t]) -> logits (B, T)."""
    b, t, d = hist.shape
    tgt = target[:, None, :].expand(b, t, d)
    feat = torch.cat([hist, tgt, hist * tgt, hist - tgt], dim=-1)
    h = F.silu(feat @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[..., 0]
