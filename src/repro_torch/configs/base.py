"""Config dataclasses + arch/shape registry (the subset of
``repro.configs.base`` the port's router needs: ``EncoderConfig``,
``ShapeConfig``, ``ArchConfig``, ``register``/``get_config``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


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
