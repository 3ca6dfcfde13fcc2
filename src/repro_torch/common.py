"""Framework-wide primitives of the port (``repro.common``): parameters
annotated with logical axes, the initialisers, the dtype policy, the
generator dispenser and small tree utilities.

A parameter made by :func:`param` is a :class:`Param`: a tensor plus its
*logical axis names* (e.g. ``("d_model", "d_ff")``), one a dim.
``repro_torch.distributed.meshrules`` maps logical axes onto the mesh's
dims (``pod``/``data``/``model``) to give a ``PartitionSpec`` and its
DTensor placements. The models' inits return plain tensors unless asked
for the ``Param`` tree (``keep_axes=True``); ``unwrap`` turns one into
the other.

Trees are nested dicts, lists and tuples (named tuples keep their type);
:func:`tree_leaves` visits them in ``jax.tree_util.tree_leaves``' order
(dict keys sorted, sequences in index order), so a flattened port tree
lines up with the reference's leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree, is_leaf: Callable[[Any], bool] = lambda x: False
                ) -> list:
    """``jax.tree_util.tree_leaves``' order: dict keys sorted, lists and
    tuples in index order; ``None`` is a leaf here (the reference's
    trees hold none)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_leaves_with_path(tree, is_leaf: Callable[[Any], bool] =
                          lambda x: False, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is the
    tuple of dict keys and sequence indices from the root."""
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], is_leaf,
                                                path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, is_leaf, path + (i,))]
    return [(path, tree)]


def tree_map(fn: Callable, tree, *rest,
             is_leaf: Callable[[Any], bool] = lambda x: False):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), keeping the structure."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Parameter wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Param:
    """A tensor annotated with logical sharding axes: ``axes`` has one
    entry a dim, ``None`` for a dim replicated on every mesh dim."""

    value: torch.Tensor
    axes: tuple[str | None, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def is_param(x) -> bool:
    return isinstance(x, Param)


def unwrap(tree):
    """Param tree -> tensor tree (same structure, Param nodes erased;
    other leaves kept)."""
    return tree_map(lambda p: p.value if is_param(p) else p, tree,
                    is_leaf=is_param)


def axes_tree(tree):
    """Param tree -> tree of logical-axis tuples (leaves are tuples)."""
    return tree_map(lambda p: p.axes, tree, is_leaf=is_param)


def wrap_like(values, params):
    """Re-attach the axes of ``params`` onto a tensor tree ``values`` of
    the same structure."""
    return tree_map(lambda p, v: Param(v, p.axes), params, values,
                    is_leaf=is_param)


# ---------------------------------------------------------------------------
# Initialisers: init(generator, shape, dtype, device) -> tensor, drawn in
# float32 and cast; on meta nothing is drawn
# ---------------------------------------------------------------------------


def _meta(device) -> bool:
    return torch.device(device).type == "meta"


def truncated_normal_init(stddev: float) -> Callable:
    """normal(0, stddev) truncated to two standard deviations (drawn as
    ``nn.init.trunc_normal_`` draws)."""
    def init(generator, shape, dtype, device):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        if not _meta(device):
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        return (x * stddev).to(dtype)

    return init


def normal_init(stddev: float) -> Callable:
    def init(generator, shape, dtype, device):
        if _meta(device):
            return torch.empty(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=generator, device=device)
                * stddev).to(dtype)

    return init


def zeros_init(generator, shape, dtype, device):
    del generator
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(generator, shape, dtype, device):
    del generator
    return torch.ones(shape, dtype=dtype, device=device)


def fan_in_init(fan_axis: int = 0) -> Callable:
    """LeCun-normal on the given fan-in axis (default first)."""
    def init(generator, shape, dtype, device):
        fan_in = shape[fan_axis] if shape else 1
        return normal_init(1.0 / math.sqrt(max(fan_in, 1)))(
            generator, shape, dtype, device)

    return init


def param(generator: torch.Generator | None, shape: Sequence[int],
          axes: Sequence[str | None], init: Callable | None = None,
          dtype=torch.float32, abstract: bool = False,
          device=None) -> Param:
    """A sharding-annotated parameter drawn from ``generator`` on
    ``device`` by ``init`` (LeCun-normal on the first axis by default).
    ``abstract=True`` gives its shape and dtype on ``meta`` (nothing is
    drawn or allocated), where the reference gives a
    ``ShapeDtypeStruct``."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    assert len(axes) == len(shape), (shape, axes)
    dev = torch.device("meta") if abstract else torch.device(
        "cpu" if device is None else device)
    if init is None:
        init = fan_in_init(0)
    return Param(init(generator, shape, dtype, dev), axes)


# ---------------------------------------------------------------------------
# Dtype policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: params stored / compute / reductions."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32

    def cast_compute(self, tree):
        """Every floating leaf cast to ``compute_dtype``; other leaves as
        they are."""
        return tree_map(
            lambda x: x.to(self.compute_dtype)
            if torch.is_tensor(x) and x.is_floating_point() else x, tree)


# ---------------------------------------------------------------------------
# Generator dispenser
# ---------------------------------------------------------------------------


def default_generator(device, seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed`` where an init draws: on
    ``device``, or on the CPU for ``meta`` (which draws nothing)."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)


class KeyGen:
    """Hands out a fresh ``torch.Generator`` a call, each seeded from one
    root generator (``kg()`` for one, ``kg(n)`` for a list of n), where
    the reference splits a JAX PRNG key. JAX's threefry stream cannot be
    reproduced with torch's generators: the same seed gives other
    values in the two packages, so a test carries the reference's
    params across instead of drawing them again."""

    def __init__(self, seed_or_generator: int | torch.Generator,
                 device=None):
        if isinstance(seed_or_generator, torch.Generator):
            self._root = seed_or_generator
        else:
            self._root = torch.Generator().manual_seed(int(seed_or_generator))
        self._device = device

    def _one(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._root))
        dev = "cpu" if self._device is None else self._device
        return torch.Generator(device=dev).manual_seed(seed)

    def __call__(self, n: int | None = None):
        if n is None:
            return self._one()
        return [self._one() for _ in range(n)]


# ---------------------------------------------------------------------------
# Tree / math utilities
# ---------------------------------------------------------------------------


def _shaped_leaves(tree) -> list:
    return [x for x in tree_leaves(tree, is_param) if x is not None]


def tree_size(tree) -> int:
    """Total number of elements across all leaves (Params count their
    tensors)."""
    return sum(math.prod(x.shape) for x in _shaped_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in _shaped_leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """float32 root of the sum of squares over every leaf (Params count
    their tensors; ``None`` adds nothing, as a zero leaf does)."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(unwrap(tree))
                          if x is not None))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """The least multiple of ``b`` that is at least ``a``."""
    return ceil_div(a, b) * b


def stack_layers(layer_params: list):
    """Stack a list of identically-structured Param trees along a new
    axis 0, annotated as the logical ``layers`` axis (replicated)."""
    first = layer_params[0]
    return tree_map(
        lambda *ps: Param(torch.stack([p.value for p in ps]),
                          ("layers",) + ps[0].axes),
        first, *layer_params[1:], is_leaf=is_param)


def abstractify(tree):
    """Tensor tree -> the same shapes and dtypes on ``meta`` (Param
    wrappers kept)."""
    def go(x):
        if is_param(x):
            return Param(torch.empty(x.shape, dtype=x.dtype, device="meta"),
                         x.axes)
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")

    return tree_map(go, tree, is_leaf=is_param)
