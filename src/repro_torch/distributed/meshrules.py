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
model code stays mesh-agnostic. Under rules the models run on DTensors
(``launch/specs.place_args``): ``shard_hint`` redistributes an
activation to the rules' placements, ``use_rules`` takes a plain tensor
a step makes as replicated (``implicit_replication``), and the helpers
below keep DTensor's lowering on the layouts the hints ask for:
``gathered`` (a weight's FSDP gather), ``einsum`` (products on local
operands), ``whole_dims``, ``local_op`` and ``like_local`` (an op run on
each rank's shard), ``replicated`` and ``refuse_dtensor``.
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
    ``Replicate()``. A mesh dim of one device holds the whole tensor
    either way and is given ``Replicate()``: DTensor would otherwise
    pick partial-sum strategies on it, whose reduction is a collective
    over one rank (a world of one runs none). A dim sharded over several
    mesh dims must name them in the mesh's order (DTensor's default: the
    earlier mesh dim is the more major)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
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
            if sizes[names[i]] > 1:
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
    """Install ``rules`` as the ambient rules for the block. With rules,
    the block also runs under DTensor's ``implicit_replication``: a plain
    tensor that meets a DTensor (a rope table, a mask, positions, a zero
    accumulator, the table offsets, a GRU state: values a step makes
    whole and alike on every rank) is taken as replicated."""
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        if rules is None:
            yield rules
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
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


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A tensor a step makes whole and alike on every rank, as a
    replicated DTensor on the rules' mesh (so ``shard_hint`` can lay it
    out); with no rules in force, or on a mesh of one device, ``x``."""
    ctx = current_rules()
    if ctx is None or ctx.size == 1 or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, ctx.mesh, [Replicate()] * len(ctx.shape),
                              run_check=False)


def whole_dims(x, dims: Sequence[int]):
    """A DTensor with tensor dims ``dims`` unsharded on every rank: each
    mesh dim that shards one of them, or holds a partial sum, becomes
    ``Replicate()``; the other shards stay. An op that runs on each
    rank's local tensor along those dims (a sort, a lookup, a kernel)
    then sees them whole. A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims}
    want = [p if isinstance(p, Shard) and p.dim not in dims else Replicate()
            for p in x.placements]
    return x if list(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def like_local(local: torch.Tensor, x, shape: Sequence[int]):
    """``local`` (one rank's result of a local op on ``x``'s shard) as a
    DTensor of global ``shape`` with ``x``'s mesh and placements; ``local``
    itself when ``x`` is a plain tensor."""
    if not is_dtensor(x):
        return local
    return from_local(local, x.device_mesh, x.placements, shape)


def local_op(fn, x, dims: Sequence[int], shape: Sequence[int]):
    """``fn(x)`` for an op along tensor dims ``dims`` (a roll, a pad):
    on a DTensor, ``fn`` of each rank's shard with those dims whole
    (``whole_dims``), as a DTensor of global ``shape`` (torch 2.11's
    DTensor has no sharding strategy for some such ops)."""
    if not is_dtensor(x):
        return fn(x)
    x = whole_dims(x, dims)
    return from_local(fn(x.to_local()), x.device_mesh, x.placements, shape)


def from_local(local: torch.Tensor, mesh, placements, shape):
    """``DTensor.from_local`` of one rank's shard of a tensor of global
    ``shape``, its global strides those of the local tensor's layout
    (which may be a permuted view: a view of the DTensor then follows
    the local tensor's memory)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_global_tensor_info

    stride = compute_global_tensor_info(local, mesh, placements)[1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def gathered(tree):
    """``tree`` (a weight, or a dict or list of them) with every DTensor
    leaf gathered over the mesh's data dims (``pod``, ``data``: the FSDP
    cut of a weight's ``d_model``) and its cut over "model" (heads,
    ``d_ff``, vocab: tensor parallelism) kept; the all-gather GSPMD puts
    before a weight's use, made explicit so a product's sharding is the
    Megatron layout the hints ask for. Plain leaves are kept."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gathered(v) for v in tree)
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate

    names = tree.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in ("pod", "data") else p
            for i, p in enumerate(tree.placements)]
    return tree if list(tree.placements) == want else \
        tree.redistribute(tree.device_mesh, want)


def einsum(eq: str, *operands) -> torch.Tensor:
    """``torch.einsum``, and on DTensors the same product computed on each
    rank's local operands (``local_map``'s way): every mesh dim cuts at
    most one letter (an output letter an operand is cut on first, the
    first operand's cut winning; else a contracted letter an operand is
    cut on), an operand holding that letter is cut the same way on that
    mesh dim (a whole one is sliced, which sends nothing) and one
    without it is whole there. The local products are then the global
    one's blocks, or, on a mesh dim that cuts a contracted letter,
    partial sums of them, which the output holds as ``Partial`` and the
    next redistribution reduces (the Megatron row-parallel product: a
    reduce of the output, no gather of the activation or the weight).
    DTensor's own lowering of an einsum flattens dims two mesh dims cut
    into strided shards, whose bookkeeping costs minutes a product on
    the production meshes. A plain operand beside DTensors is taken as
    replicated."""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if "." in eq or len(ins) != len(operands):
        raise ValueError(f"meshrules.einsum: unsupported equation {eq!r}")
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    ops = [o if is_dtensor(o) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for o in operands]
    sizes: dict[str, set] = {}
    for o, letters in zip(ops, ins):
        for letter, n in zip(letters, o.shape):
            sizes.setdefault(letter, set()).add(int(n))
    cut = [None] * mesh.ndim
    for in_out in (True, False):
        for o, letters in zip(ops, ins):
            for i, p in enumerate(o.placements):
                letter = letters[p.dim] if isinstance(p, Shard) else ""
                if cut[i] is None and letter and \
                        (letter in out) == in_out and len(sizes[letter]) == 1:
                    cut[i] = letter
    local = []
    for o, letters in zip(ops, ins):
        want = [Shard(letters.index(c)) if c and c in letters
                else Replicate() for c in cut]
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        local.append(o.to_local())
    return from_local(torch.einsum(eq, *local), mesh,
                      [Shard(out.index(c)) if c and c in out else
                       Partial("sum") if c else Replicate() for c in cut],
                      [max(sizes[c]) for c in out])


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise for a kernel no forward cell hands a DTensor: its wrapper
    would read a DTensor's pointers."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: no DTensor path (its kernel reads whole "
                        f"tensors); call it on local tensors")


def logical_sharding(axes: Sequence[str | None],
                     shape: Sequence[int] | None = None
                     ) -> NamedSharding | None:
    ctx = current_rules()
    if ctx is None:
        return None
    return ctx.sharding_for(axes, shape)


__all__ = ["DEFAULT_RULES", "AxisRules", "NamedSharding", "P", "PartitionSpec",
           "current_rules", "einsum", "from_local", "gathered",
           "is_dtensor", "like_local", "local_op", "local_shape",
           "logical_sharding", "mesh_shape", "placements_for",
           "refuse_dtensor", "replicated", "shard_hint", "use_rules",
           "whole_dims"]
