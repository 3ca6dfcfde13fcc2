"""Config dataclasses + arch/shape registry (the subset of
``repro.configs.base`` the port needs: ``MoEConfig``, ``LMConfig``,
``EncoderConfig``, ``VitParserConfig``, ``GNNConfig``, ``RecsysConfig``,
``ShapeConfig``,
``ArchConfig``, ``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``,
``register``/``get_config``); ``round_up`` is ``repro_torch.common``'s."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.common import round_up  # noqa: F401 (re-exported)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router: str = "topk"            # "topk" (paper-of-arch faithful) | "budget" (AdaParse-style)
    budget_alpha: float = 0.125      # only for router="budget": global expert budget fraction
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense or MoE).

    ``remat``, ``scan_layers``, ``unroll_pairs``, ``q_chunk`` and
    ``kv_chunk`` are the JAX package's lowering knobs; the port reads
    only the two chunk sizes (``attention_impl="xla_flash"``)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: int | None = None  # SWA window size; None = full attention
    attention_impl: str = "xla_flash"  # "xla_flash" | "naive" | "pallas"
    q_chunk: int = 512
    kv_chunk: int = 1024
    moe: MoEConfig | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logits_softcap: float | None = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    unroll_pairs: bool = False   # unroll the flash block-pair scan (costing)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Total parameter count (embeddings included once if tied)."""
        d, h, hk, dh, f, v, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.head_dim, self.d_ff, self.vocab_size,
                                 self.n_layers)
        attn = d * h * dh + 2 * d * hk * dh + h * dh * d
        if self.moe is not None:
            ffn = d * self.moe.n_experts * 3 * self.moe.d_ff_expert \
                + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        norms = 2 * d + (2 * dh if self.qk_norm else 0)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + norms) + emb + d

    def n_active_params(self) -> int:
        """Active-per-token parameter count (MoE counts top_k experts)."""
        if self.moe is None:
            return self.n_params()
        d, h, hk, dh, L = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.head_dim, self.n_layers)
        attn = d * h * dh + 2 * d * hk * dh + h * dh * d
        ffn = 3 * d * self.moe.d_ff_expert * self.moe.top_k \
            + d * self.moe.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """BERT-style bidirectional encoder (the AdaParse CLS-III router)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    max_len: int = 512
    n_outputs: int = 6               # per-parser accuracy regression head
    norm_eps: float = 1e-12
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # training-only; no effect on inference
    scan_layers: bool = True         # training-only; no effect on inference

    def n_params(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        per_layer = 4 * d * d + 2 * d * f + 4 * d
        emb = self.vocab_size * d + self.max_len * d + 2 * d
        head = d * d + d * self.n_outputs
        return L * per_layer + emb + head


@dataclasses.dataclass(frozen=True)
class VitParserConfig:
    """Nougat-class parser: windowed-attention image encoder + causal
    cross-attention text decoder. Page pixels -> patch embeddings is a
    stub frontend (the batch provides patch vectors directly).

    ``n_params`` is the reference's formula, copied as it stands: it
    leaves out the decoder's third FFN matrix and ``lm_head`` (372.4 M
    at ``nougat-base``, where the tree holds 466,362,368); count the
    tree's leaves (``vit_parser_param_count``) for model FLOPs.
    ``scan_layers`` is the JAX package's lowering knob; the port loops
    over the layers either way."""

    name: str
    # encoder (Swin-ish, single resolution for simplicity at scale)
    enc_layers: int
    enc_d_model: int
    enc_heads: int
    enc_d_ff: int
    window: int                       # window size in patches (1D-flattened windows)
    image_hw: tuple[int, int] = (896, 672)
    patch: int = 16
    # decoder (mBART-ish causal LM with cross attention)
    dec_layers: int = 10
    dec_d_model: int = 1024
    dec_heads: int = 16
    dec_d_ff: int = 4096
    vocab_size: int = 50000
    max_dec_len: int = 4096
    pages_per_batch: int = 10         # paper's B_p
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_hw[0] // self.patch) * (self.image_hw[1] // self.patch)

    def n_params(self) -> int:
        e = self.enc_layers * (4 * self.enc_d_model**2
                               + 2 * self.enc_d_model * self.enc_d_ff)
        d = self.dec_layers * (8 * self.dec_d_model**2
                               + 2 * self.dec_d_model * self.dec_d_ff)
        emb = self.vocab_size * self.dec_d_model + self.n_patches * self.enc_d_model
        return e + d + emb


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """EquiformerV2-style eSCN equivariant graph attention network.

    ``scan_layers`` is the JAX package's lowering knob; the port loops
    over the layers either way."""

    name: str
    n_layers: int
    d_hidden: int
    l_max: int
    m_max: int
    n_heads: int
    n_radial: int = 32
    d_edge: int = 0
    d_in: int = 0                     # input node feature dim (0 = embeddings)
    n_out: int = 1                    # regression targets / classes
    cutoff: float = 5.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    @property
    def n_coeff(self) -> int:
        """Number of (l, m) spherical coefficients with |m| <= m_max."""
        return sum(min(2 * l + 1, 2 * self.m_max + 1)
                   for l in range(self.l_max + 1))


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                         # "dlrm" | "deepfm" | "autoint" | "dien"
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: tuple[int, ...]      # per sparse field
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    mlp: tuple[int, ...] = ()
    interaction: str = "dot"          # dot | fm | self-attn | augru
    # autoint
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    unroll_gru: bool = False     # unroll GRU time scans (costing variants)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def table_rows(self) -> int:
        return sum(self.vocab_sizes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One workload cell: shape name + step kind + dims."""

    name: str
    kind: str                         # "train" | "prefill" | "decode" | "serve"
    dims: dict[str, int] = dataclasses.field(default_factory=dict)
    note: str = ""

    def __getitem__(self, k):
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str
    model: Any
    shapes: tuple[ShapeConfig, ...]
    source: str = ""
    skips: dict[str, str] = dataclasses.field(default_factory=dict)
    reduced: Callable[[], "ArchConfig"] | None = None

    def shape(self, name: str) -> ShapeConfig:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")

    def runnable_shapes(self) -> list[ShapeConfig]:
        return [s for s in self.shapes if s.name not in self.skips]


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    """Every registered arch id, sorted."""
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


# LM-family shared shape set -------------------------------------------------

LM_SHAPES = (
    ShapeConfig("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeConfig("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeConfig("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeConfig("long_500k", "decode", {"seq_len": 524288, "global_batch": 1},
                note="needs sub-quadratic attention"),
)

GNN_SHAPES = (
    ShapeConfig("full_graph_sm", "train",
                {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeConfig("minibatch_lg", "train",
                {"n_nodes": 232_965, "n_edges": 114_615_892,
                 "batch_nodes": 1024, "fanout0": 15, "fanout1": 10},
                note="sampled-training via neighbor sampler"),
    ShapeConfig("ogb_products", "train",
                {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeConfig("molecule", "train",
                {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)

RECSYS_SHAPES = (
    ShapeConfig("train_batch", "train", {"batch": 65536}),
    ShapeConfig("serve_p99", "serve", {"batch": 512}),
    ShapeConfig("serve_bulk", "serve", {"batch": 262144}),
    ShapeConfig("retrieval_cand", "serve", {"batch": 1, "n_candidates": 1_000_000}),
)
