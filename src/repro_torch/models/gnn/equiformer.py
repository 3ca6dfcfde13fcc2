"""EquiformerV2-style equivariant graph attention with eSCN convolutions
[arXiv:2306.12059], the port of ``repro/models/gnn/equiformer.py``.

Public surface:
    init_equiformer(cfg, generator, device)       -> params
    equiformer_from_jax_params(raw, cfg, device)  -> params
    equiformer_forward(params, cfg, batch)        -> (N or G, n_out)
    equiformer_loss(params, cfg, batch)           -> loss, {}

Per layer, for every edge (s -> t) with direction r̂ and length r:

1.  Rotate source/target irrep features into the edge frame (R: r̂ -> ẑ)
    with numeric Wigner matrices (``so3.wigner_from_rotation``) and keep
    the coefficients with |m| <= m_max (the eSCN reduction).
2.  Per-m SO(2) linear maps, modulated by a radial MLP over a Gaussian
    RBF of r.
3.  Graph attention: invariant (l=0) message channels + RBF -> per-head
    logits -> segment-softmax over incoming edges -> weighted message.
4.  Rotate messages back (D^T), sum them at their destinations,
    equivariant RMS-norm (per l), gated nonlinearity, per-l channel FFN.

Readout: l=0 invariants -> MLP (node-level, or summed per graph).

Params are a plain dict in the JAX package's raw layout: ``embed_w
(d_in or 128, C)``, ``out_w1 (C, C)``, ``out_w2 (C, n_out)`` and
``layers``, whose leaves are stacked on a leading layer axis (``_shapes``
lists them), so ``equiformer_from_jax_params`` is a checked copy.

The layer is regrouped without changing what it sums. The rotation into
the edge frame and its truncation are one batched product with a
block-diagonal (n_trunc, n_lm) matrix an edge, built once a forward from
the kept rows of each D_l (the reference rotates all 2l+1 rows per l and
then takes the kept ones), and the rotation back is its transpose (the
reference scatters the messages into zeros first); source and target are
rotated apart and joined on the channel axis afterwards. The truncated
coefficients are kept m-major (m = 0, then +1, -1, +2, -2, each l
ascending: the reference's SO(2) concatenation order), so the SO(2)
inputs are slices and each m > 0 map is one product of [x_+m, x_-m] with
[[Wr, Wi], [-Wi, Wr]]. The validity mask multiplies the attention
weights (by 1 or 0, exactly) instead of the rotated messages.

On the card the gathers of node features by edge are the hand-written
``embedding_bag`` kernel and the sums by destination (the messages, the
softmax denominators, the pooled readout) the hand-written
``embedding_bag_backward`` kernel, through ``segment.gather_src`` and
``segment.scatter_sum``; the per-l FFN weights are taken with
``embedding_bag``'s ``lookup`` too, whose backward is that same kernel.
None of them adds with atomics, so two trainings give the same bits.
The SO(2) maps, the radial MLP and the FFN products are torch products,
as the JAX package leaves them to XLA. With ``cfg.remat`` each layer runs
under ``torch.utils.checkpoint`` (the counterpart of
``jax.checkpoint(nothing_saveable)``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.common import default_generator, normal_init, param, unwrap, zeros_init
from repro_torch.configs.base import GNNConfig
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.gnn import segment, so3
from repro_torch.models.layers import embed_lookup, from_numpy, torch_dtype


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: GNNConfig) -> dict:
    """name -> (per-layer shape, init std), in the JAX init's order."""
    C = cfg.d_hidden
    shapes = {
        "rad_w1": ((cfg.n_radial, 2 * C), cfg.n_radial ** -0.5),
        "rad_w2": ((2 * C, (cfg.m_max + 1) * C), (2 * C) ** -0.5),
        "attn_w": ((C + cfg.n_radial, cfg.n_heads),
                   (C + cfg.n_radial) ** -0.5),
        "ffn_w1": ((cfg.l_max + 1, C, C), C ** -0.5),
        "ffn_w2": ((cfg.l_max + 1, C, C), C ** -0.5),
        "gate_w": ((C, cfg.l_max * C), C ** -0.5),
        "norm_scale": ((cfg.l_max + 1, C), 0.0),
    }
    for m in range(cfg.m_max + 1):
        n_l = cfg.l_max - m + 1
        d_in, d_out = n_l * 2 * C, n_l * C
        names = ["so2_m0"] if m == 0 else [f"so2_m{m}_r", f"so2_m{m}_i"]
        for k in names:
            shapes[k] = ((d_in, d_out), d_in ** -0.5)
    return shapes


def _top_shapes(cfg: GNNConfig) -> dict:
    C = cfg.d_hidden
    d_in = cfg.d_in if cfg.d_in > 0 else 128
    return {"embed_w": ((d_in, C), d_in ** -0.5),
            "out_w1": ((C, C), C ** -0.5),
            "out_w2": ((C, cfg.n_out), C ** -0.5)}


#: logical axes of the leaves that name one; every other leaf is
#: replicated (all ``None``; the stacked ones ``"layers"`` first)
_AXES = {"embed_w": ("d_feat", None)}


@torch.no_grad()
def init_equiformer(cfg: GNNConfig, generator: torch.Generator | None = None,
                    device=None, keep_axes: bool = False) -> dict:
    """Random params in ``cfg.param_dtype`` on ``device`` (cuda unless
    "cpu"): normal(std) draws in float32 from ``generator``, which must
    live on that device (default: seed 0 there), with the reference's
    stds; ``norm_scale`` is zero (the norm scales by ``1 + scale``). On
    ``meta`` (any generator) nothing is drawn. With ``keep_axes`` the
    ``Param`` tree of their logical axes."""
    dev = device_lib.resolve(device)
    g = generator if generator is not None else \
        default_generator(dev)
    if dev.type != "meta" and torch.device(g.device).type != dev.type:
        raise ValueError(f"init_equiformer: generator on {g.device}, "
                         f"params on {dev}; draw on the params' device")
    dtype = torch_dtype(cfg.param_dtype)

    def draw(name, shape, std, lead=()):
        axes = lead + _AXES.get(name, (None,) * (len(shape) - len(lead)))
        init = zeros_init if std == 0.0 else normal_init(std)
        return param(g, shape, axes, init, dtype, device=dev)

    L = cfg.n_layers
    top = _top_shapes(cfg)
    params = {"embed_w": draw("embed_w", *top["embed_w"])}
    params["layers"] = {k: draw(k, (L,) + s, std, ("layers",))
                        for k, (s, std) in _layer_shapes(cfg).items()}
    params["out_w1"] = draw("out_w1", *top["out_w1"])
    params["out_w2"] = draw("out_w2", *top["out_w2"])
    return params if keep_axes else unwrap(params)


@torch.no_grad()
def equiformer_from_jax_params(raw: dict, cfg: GNNConfig,
                               device=None) -> dict:
    """The JAX package's raw params (numpy leaves, ``unwrap``-ed
    ``init_equiformer``) -> the port's with the same values, bf16 bit
    for bit. Raises on a missing, extra or misshapen leaf."""
    dev = device_lib.resolve(device)
    dtype = torch_dtype(cfg.param_dtype)

    def take(tree, shapes, lead, where):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"equiformer params{where}: keys {got} != "
                             f"{sorted(shapes)}")
        out = {}
        for k, (shape, _) in shapes.items():
            t = from_numpy(tree[k])
            if tuple(t.shape) != lead + shape:
                raise ValueError(f"equiformer param{where}[{k!r}]: shape "
                                 f"{tuple(t.shape)} != {lead + shape}")
            out[k] = t.to(device=dev, dtype=dtype)
        return out

    if not isinstance(raw, dict) or "layers" not in raw:
        raise ValueError("equiformer params: no 'layers' subtree")
    top = {k: v for k, v in raw.items() if k != "layers"}
    return {**take(top, _top_shapes(cfg), (), ""),
            "layers": take(raw["layers"], _layer_shapes(cfg),
                           (cfg.n_layers,), "['layers']")}


def equiformer_param_count(cfg: GNNConfig) -> int:
    n = sum(int(np.prod(s)) for s, _ in _top_shapes(cfg).values())
    return n + cfg.n_layers * sum(int(np.prod(s))
                                  for s, _ in _layer_shapes(cfg).values())


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def radial_basis(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Gaussian RBF with cosine cutoff envelope. r (E,) -> (E, n). The
    centres are ``jnp.linspace``'s float32 values (numpy's float32
    linspace, equal bit for bit; torch's differs in the last bit)."""
    centers = torch.from_numpy(np.linspace(
        np.float32(0.0), np.float32(cutoff), n, dtype=np.float32)).to(r.device)
    width = cutoff / n
    rbf = torch.exp(-0.5 * torch.square((r[:, None] - centers) / width))
    env = 0.5 * (torch.cos(torch.pi * torch.clamp(r / cutoff, 0, 1)) + 1.0)
    return rbf * env[:, None]


@functools.lru_cache(maxsize=32)
def _mmajor(l_max: int, m_max: int) -> np.ndarray:
    """The truncated rows (``trunc_indices`` order) in the reference's
    SO(2) concatenation order: m = 0 (l ascending), then for each m > 0
    the +m rows and the -m rows."""
    _, _, ms = so3.trunc_indices(l_max, m_max)
    order = [np.nonzero(ms == 0)[0]]
    for m in range(1, m_max + 1):
        order += [np.nonzero(ms == m)[0], np.nonzero(ms == -m)[0]]
    return np.concatenate(order)


def _so2_conv(feats: torch.Tensor, lp: dict, cfg: GNNConfig,
              rad_scale: torch.Tensor) -> torch.Tensor:
    """The reference's ``_so2_conv`` on its layout: feats (E, n_trunc,
    2C) in ``trunc_indices`` order -> (E, n_trunc, C) in that order.

    Per-|m| complex-pair linear maps across the l-stack:
      y_{+m} = Wr x_{+m} - Wi x_{-m};   y_{-m} = Wi x_{+m} + Wr x_{-m}.
    ``rad_scale`` (E, m_max+1, C) modulates each m-block (radial MLP).
    The layer runs ``_so2_mmajor`` on the m-major layout, which this
    wraps in the reference's permutation (``_mmajor``) and its inverse
    (the reference's ``np.argsort``)."""
    order = _mmajor(cfg.l_max, cfg.m_max)
    dev = feats.device
    out = _so2_mmajor(feats.index_select(1, torch.from_numpy(order).to(dev)),
                      lp, cfg, rad_scale)
    return out.index_select(1, torch.from_numpy(np.argsort(order)).to(dev))


def _so2_mmajor(feats: torch.Tensor, lp: dict, cfg: GNNConfig,
                rad_scale: torch.Tensor) -> torch.Tensor:
    """``_so2_conv`` on the m-major layout (``_mmajor``): feats (E,
    n_trunc, 2C) -> (E, n_trunc, C). Each block's input is a slice; an
    m > 0 block is one product [x_+m, x_-m] @ [[Wr, Wi], [-Wi, Wr]]."""
    e, C2 = feats.shape[0], feats.shape[-1]
    C = C2 // 2
    out_parts, lo = [], 0
    for m in range(cfg.m_max + 1):
        n_l = cfg.l_max - m + 1
        k = n_l if m == 0 else 2 * n_l
        x = feats[:, lo:lo + k].reshape(e, k * C2)
        if m == 0:
            w = lp["so2_m0"]
        else:
            wr, wi = lp[f"so2_m{m}_r"], lp[f"so2_m{m}_i"]
            w = torch.cat([torch.cat([wr, wi], dim=1),
                           torch.cat([-wi, wr], dim=1)], dim=0)
        y = (x @ w).reshape(e, k, C)
        out_parts.append(y * rad_scale[:, m][:, None, :])
        lo += k
    return torch.cat(out_parts, dim=1)


def _equi_norm(x: torch.Tensor, scale: torch.Tensor, l_max: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Equivariant RMS norm: normalize each degree-l block by its RMS over
    (m, C); learnable per-(l, C) scale. The mean of squares is taken of
    x's dtype's squares, accumulated in float32 and rounded once, as
    ``jnp.mean`` takes it; the divide and the scale then run over every
    l at once (the same elementwise operations on the same values)."""
    sq = torch.square(x)
    ms = torch.stack([sq[:, l * l:(l + 1) * (l + 1)].mean(
        dim=(1, 2), dtype=torch.float32) for l in range(l_max + 1)],
        dim=1).to(x.dtype)                                # (N, l_max+1)
    rms = torch.sqrt(ms + eps)
    l_of = _l_of(l_max, str(x.device))
    return x / rms[:, l_of, None] * (1.0 + scale)[l_of][None]


def _gated_act(x: torch.Tensor, gate_w: torch.Tensor,
               l_max: int) -> torch.Tensor:
    """l=0: SiLU; l>0: sigmoid gate from invariant channels (equivariant)."""
    inv = x[:, 0]                                        # (N, C)
    gates = torch.sigmoid(inv @ gate_w)                  # (N, l_max*C)
    c = x.shape[-1]
    outs = [F.silu(x[:, :1])]
    for l in range(1, l_max + 1):
        g = gates[:, (l - 1) * c:l * c][:, None, :]
        outs.append(x[:, l * l:(l + 1) * (l + 1)] * g)
    return torch.cat(outs, dim=1)


def _trunc_rotation(wig: list, l_max: int, m_max: int) -> torch.Tensor:
    """The rotation into the edge frame and its truncation as one
    block-diagonal matrix an edge: (E, n_trunc, n_lm) in the Wigner
    matrices' dtype, its rows the kept (l, m) in the m-major order
    (``_mmajor``), row (l, m) holding row l + m of D_l in columns
    l^2..(l+1)^2."""
    _, ls, ms = so3.trunc_indices(l_max, m_max)
    order = _mmajor(l_max, m_max)
    e = wig[0].shape[0]
    rot = wig[0].new_zeros((e, len(order), (l_max + 1) ** 2))
    for l, d in enumerate(wig):
        pos = np.nonzero(ls[order] == l)[0]               # rows of this l
        src = ms[order][pos] + l                          # rows of D_l
        rot[:, torch.from_numpy(pos).to(d.device),
            l * l:(l + 1) * (l + 1)] = d[:, torch.from_numpy(src).to(
                d.device)]
    return rot


@functools.lru_cache(maxsize=16)
def _l_of(l_max: int, device: str) -> torch.Tensor:
    """The degree l of each of the (l_max+1)^2 coefficients (int64, on
    ``device``; one copy a device, read only)."""
    return torch.tensor([l for l in range(l_max + 1)
                         for _ in range(2 * l + 1)], device=device)


def _take_per_l(w: torch.Tensor, l_of: torch.Tensor) -> torch.Tensor:
    """``jnp.take(w, l_of, axis=0)`` of (l_max+1, C, C) weights: the
    ``embedding_bag`` lookup, whose backward adds the 2l+1 copies' grads
    in position order (the ``embedding_bag_backward`` kernel on the
    card, no atomics)."""
    rows = bag_ops.lookup(w.reshape(w.shape[0], -1), l_of)
    return rows.view((l_of.numel(),) + tuple(w.shape[1:]))


def _layers(params: dict) -> list:
    """Each layer's leaves, the stacked (L, ...) leaves taken apart once
    with ``unbind`` (its backward stacks the L grads once)."""
    names = list(params["layers"])
    cols = [params["layers"][k].unbind(0) for k in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def _layer(x, lp, cfg: GNNConfig, geo: dict):
    src, dst, rot, rbf = geo["src"], geo["dst"], geo["rot"], geo["rbf"]
    n_nodes, C = x.shape[0], cfg.d_hidden
    # 1. rotate into the edge frame + m-truncate, source and target apart
    ef = torch.cat([torch.bmm(rot, segment.gather_src(x, src)),
                    torch.bmm(rot, segment.gather_src(x, dst))],
                   dim=-1)                                # (E, n_trunc, 2C)
    # 2. radial-modulated SO(2) conv (m-major rows)
    rad = F.silu(rbf @ lp["rad_w1"]) @ lp["rad_w2"]
    rad_scale = rad.reshape(-1, cfg.m_max + 1, C)
    msg = _so2_mmajor(ef, lp, cfg, rad_scale)             # (E, n_trunc, C)
    del ef
    # 3. attention over incoming edges; row 0 is (l, m) = (0, 0)
    inv_msg = msg[:, 0]
    logits = (torch.cat([inv_msg, rbf], dim=-1)
              @ lp["attn_w"]).float()                     # (E, H)
    logits = torch.where(geo["edge_valid"][:, None] > 0, logits, -1e30)
    alpha = segment.segment_softmax(logits, dst, n_nodes).to(msg.dtype)
    alpha = alpha * geo["edge_valid"][:, None]
    e, nt = msg.shape[0], msg.shape[1]
    heads = msg.reshape(e, nt, cfg.n_heads, C // cfg.n_heads)
    msg = (heads * alpha[:, None, :, None]).reshape(e, nt, C)
    # 4. un-truncate + rotate back + aggregate
    agg = segment.scatter_sum(torch.bmm(rot.transpose(1, 2), msg), dst,
                              n_nodes)
    x = x + agg.to(x.dtype)
    # norm + gated act + per-l channel FFN
    x = _equi_norm(x, lp["norm_scale"], cfg.l_max)
    w1 = _take_per_l(lp["ffn_w1"], geo["l_of"])           # (n_lm, C, C)
    w2 = _take_per_l(lp["ffn_w2"], geo["l_of"])
    h = _gated_act(x, lp["gate_w"], cfg.l_max)
    h = torch.einsum("nkc,kcd->nkd", h, w1)
    h = _gated_act(h, lp["gate_w"], cfg.l_max)
    h = torch.einsum("nkc,kcd->nkd", h, w2)
    return x + h


def _geometry(pos, src, dst, cfg: GNNConfig, cdt) -> dict:
    """Per-edge frames, shared by every layer (no gradient): the
    truncated block-diagonal rotation (``_trunc_rotation``) in the
    compute dtype, the RBF, the validity mask (zero-length edges,
    self-loops and padding, take no part)."""
    with torch.no_grad():
        rel = (embed_lookup(pos, dst, mode="clip")
               - embed_lookup(pos, src, mode="clip"))
        rel32 = rel.float()
        r = torch.sqrt(torch.sum(rel32 * rel32, dim=-1))
        edge_valid = (r > 1e-7).to(cdt)
        r_hat = rel / torch.clamp_min(r, 1e-9)[:, None]
        rot = so3.align_to_z(r_hat)
        wig = [w.to(cdt) for w in so3.wigner_from_rotation(rot, cfg.l_max)]
        rbf = radial_basis(r, cfg.n_radial, cfg.cutoff).to(cdt)
        rot = _trunc_rotation(wig, cfg.l_max, cfg.m_max)
    return {"src": src, "dst": dst, "rot": rot, "rbf": rbf,
            "edge_valid": edge_valid,
            "l_of": _l_of(cfg.l_max, str(pos.device))}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def equiformer_forward(params: dict, cfg: GNNConfig,
                       batch: dict) -> torch.Tensor:
    """batch: node_feat (N, d_in) or None, pos (N, 3), src (E,), dst (E,),
    optional graph_ids (N,) + n_graphs (an int) for the pooled readout.

    Returns (N, n_out) node outputs or (n_graphs, n_out) if pooled, in
    the compute dtype. Differentiable with respect to the params."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos, src, dst = batch["pos"], batch["src"], batch["dst"]
    n_nodes = pos.shape[0]
    C = cfg.d_hidden
    n_lm = so3.n_coeff_full(cfg.l_max)

    feat = batch.get("node_feat")
    if feat is None:
        feat = torch.ones((n_nodes, params["embed_w"].shape[0]), dtype=cdt,
                          device=pos.device)
    inv0 = feat.to(cdt) @ params["embed_w"].to(cdt)
    x = torch.cat([inv0[:, None], inv0.new_zeros((n_nodes, n_lm - 1, C))],
                  dim=1)
    geo = _geometry(pos, src, dst, cfg, cdt)

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(params):
        if remat:
            x = checkpoint(_layer, x, lp, cfg, geo, use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, geo)

    inv = x[:, 0]                                         # (N, C) invariants
    h = F.silu(inv @ params["out_w1"].to(cdt))
    out = h @ params["out_w2"].to(cdt)
    if "graph_ids" in batch:
        out = segment.scatter_sum(out, batch["graph_ids"], batch["n_graphs"])
    return out


def equiformer_loss(params: dict, cfg: GNNConfig, batch: dict):
    """Classification (integer labels: the float32 mean cross entropy,
    over the nodes a ``label_mask`` keeps if there is one) or float32
    MSE. Returns (loss, {})."""
    out = equiformer_forward(params, cfg, batch).float()
    labels = batch["labels"]
    if not labels.is_floating_point():                    # classification
        logz = torch.logsumexp(out, dim=-1)
        gold = torch.gather(out, -1, labels.long()[:, None])[:, 0]
        nll = logz - gold
        mask = batch.get("label_mask")
        if mask is not None:
            m = mask.float()
            return torch.sum(nll * m) / torch.clamp_min(m.sum(), 1.0), {}
        return nll.mean(), {}
    err = torch.square(out - labels.float())
    return err.mean(), {}
