"""Logical-axis -> mesh-dim sharding rules, the port of
``repro/distributed/meshrules.py`` over a
``torch.distributed.device_mesh.DeviceMesh``.

Model code names tensor dims by *logical* axes ("batch", "heads", ...).
An :class:`AxisRules` maps those onto the mesh's named dims
(``pod``/``data``/``model``) with the reference's divisibility guards,
giving a :class:`PartitionSpec` (the port's counterpart of JAX's: one
entry a dim, ``None``, a mesh dim's name or a tuple of names) and the
DTensor placements that spec means, one a mesh dim (``Shard(d)`` or
``Replicate()``). ``AxisRules`` reads only the mesh's dim names and
sizes, as the reference reads only ``mesh.shape``, so the specs of a
production mesh can be taken on a process group that runs nothing (the
fake backend, ``launch/mesh.py``).

Outside any rules (plain one-device runs) the helpers are no-ops, so
model code stays mesh-agnostic. The models do not call ``shard_hint``
yet: running them on DTensors is the mesh layer's second half.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch

from repro_torch.common import is_param, tree_map

# Default logical->mesh mapping. Values are *preference-ordered* tuples of
# mesh dims: a logical dim is sharded over every listed mesh dim that (a)
# exists in the mesh and (b) keeps the dim divisible. "pod" appears first
# for batch-like axes so the multi-pod mesh data-parallelizes across pods.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # LM activations. "seq" -> model is Megatron-style sequence
    # parallelism: the residual stream shards its seq dim over the TP dim
    "batch": ("pod", "data"),
    "seq": ("model",),
    "kv_seq": ("data", "model"),  # long-context KV caches (falls through to
                                  # model when batch already owns data)
    # FSDP: weight matrices shard their d_model dim over "data" (they have
    # no batch dim, so no conflict; activations' batch grabs "data" first)
    "d_model": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_head": (),
    "d_ff": ("model",),
    "experts": ("model",),
    "expert_ff": ("model",),   # picked up when n_experts isn't divisible
    "expert_cap": ("data",),   # dispatch-buffer capacity dim
    "vocab": ("model",),
    "layers": (),
    "pos": (),
    # fully-sharded (ZeRO-like) optimizer-state axes
    "fsdp": ("data",),
    # ViT parser
    "patches": ("model",),
    "pages": ("pod", "data"),
    # GNN
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "graphs": ("pod", "data"),
    "d_feat": (),
    "coeff": (),
    # recsys
    "table_rows": ("model",),
    "embed_dim": (),
    "fields": (),
    "candidates": ("pod", "data", "model"),
    "mlp_in": (),
    "mlp_out": (),
    # pipeline
    "stage": ("pod",),
}


class PartitionSpec(tuple):
    """A tuple with one entry a tensor dim (trailing ``None``s
    stripped): ``None`` (replicated), a mesh dim's name, or a tuple of
    names (sharded over those mesh dims, the first the most major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def mesh_dims(self) -> set[str]:
        return {a for e in self if e is not None
                for a in ((e,) if isinstance(e, str) else e)}


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("meshrules: the mesh's dims need names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def placements_for(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where tensor dim d is sharded over that mesh dim, else
    ``Replicate()``. A dim sharded over several mesh dims must name them
    in the mesh's order (DTensor's default: the earlier mesh dim is the
    more major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        if e is None:
            continue
        dims = (e,) if isinstance(e, str) else tuple(e)
        order = [names.index(a) for a in dims]
        if order != sorted(order):
            raise ValueError(f"placements_for: {dims} on dim {d} out of the "
                             f"mesh's order {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return out


def local_shape(spec: PartitionSpec, shape: Sequence[int], mesh
                ) -> tuple[int, ...]:
    """The largest shard's shape of a ``shape`` tensor laid out by
    ``spec``: each dim over the product of its mesh dims' sizes, rounded
    up (GSPMD pads a dim that does not divide; DTensor's first shards
    are the large ones)."""
    sizes = mesh_shape(mesh)
    out = list(int(s) for s in shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e))
        out[d] = -(-out[d] // n)
    return tuple(out)


class NamedSharding:
    """A mesh and a spec: the port's counterpart of JAX's
    ``NamedSharding``, with the DTensor placements the spec means."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return local_shape(self.spec, shape, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec!r})"


class AxisRules:
    """A mesh + logical-axis rule table, installable as ambient rules."""

    def __init__(self, mesh, rules: dict[str, tuple[str, ...]] | None = None,
                 overrides: dict[str, tuple[str, ...]] | None = None):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.rules = dict(DEFAULT_RULES if rules is None else rules)
        if overrides:
            self.rules.update(overrides)

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.shape.values())

    # -- spec construction ---------------------------------------------------

    def spec_for(self, axes: Sequence[str | None],
                 shape: Sequence[int] | None = None) -> PartitionSpec:
        """The spec of logical ``axes`` (one a dim). Guards: a mesh dim
        appears at most once in the whole spec; a dim is only sharded if
        its size is divisible by the product of its mesh dims (when
        ``shape`` is given)."""
        used: set[str] = set()
        entries = []
        for i, name in enumerate(axes):
            if name is None:
                entries.append(None)
                continue
            picked: list[str] = []
            for ax in self.rules.get(name, ()):
                if ax not in self.shape or ax in used:
                    continue
                factor = math.prod(self.shape[a] for a in picked + [ax])
                if shape is not None and shape[i] % factor != 0:
                    continue
                picked.append(ax)
            used.update(picked)
            if not picked:
                entries.append(None)
            elif len(picked) == 1:
                entries.append(picked[0])
            else:
                entries.append(tuple(picked))
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def sharding_for(self, axes: Sequence[str | None],
                     shape: Sequence[int] | None = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(axes, shape))

    def zero_spec_for(self, axes: Sequence[str | None],
                      shape: Sequence[int]) -> PartitionSpec:
        """ZeRO-style spec: the normal spec, plus the first still
        unsharded divisible dim picks up the ``data`` dim (optimizer
        state sharding)."""
        spec = self.spec_for(axes, shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if "data" in self.shape and "data" not in spec.mesh_dims():
            n = self.shape["data"]
            for i, e in enumerate(entries):
                if e is None and shape[i] % n == 0 and shape[i] >= n:
                    entries[i] = "data"
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def zero_sharding_for(self, axes, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.zero_spec_for(axes, shape))

    def placements(self, axes: Sequence[str | None],
                   shape: Sequence[int] | None = None) -> list:
        return placements_for(self.spec_for(axes, shape), self.mesh)

    # -- trees ----------------------------------------------------------------

    def param_shardings(self, params):
        """Param tree -> NamedSharding tree (the tensor tree's
        structure)."""
        return tree_map(lambda p: self.sharding_for(p.axes, p.shape),
                        params, is_leaf=is_param)

    def param_specs(self, params):
        return tree_map(lambda p: self.spec_for(p.axes, p.shape),
                        params, is_leaf=is_param)


_TLS = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_TLS, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules | None):
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield rules
    finally:
        _TLS.rules = prev


def shard_hint(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Lay out an activation by logical axes: with no rules in force,
    ``x``; a DTensor is redistributed to the rules' placements; a plain
    tensor is returned as it is on a world of one and refused on a
    larger mesh (a plain tensor there would silently stay whole on
    every rank)."""
    ctx = current_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(ctx.mesh, ctx.placements(axes, x.shape))
    if ctx.size == 1:
        return x
    raise ValueError(f"shard_hint: a plain tensor under rules of a mesh of "
                     f"{ctx.size} devices {ctx.shape}; distribute it first")


def logical_sharding(axes: Sequence[str | None],
                     shape: Sequence[int] | None = None
                     ) -> NamedSharding | None:
    ctx = current_rules()
    if ctx is None:
        return None
    return ctx.sharding_for(axes, shape)


__all__ = ["DEFAULT_RULES", "AxisRules", "NamedSharding", "P", "PartitionSpec", "current_rules", "local_shape",
           "logical_sharding", "mesh_shape", "placements_for", "shard_hint",
           "use_rules"]
