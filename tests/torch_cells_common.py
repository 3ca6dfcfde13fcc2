"""Checks shared by the ``tests/test_torch_cells_*.py`` files: the
port's cell factory (``repro_torch.launch.specs``) against the JAX
package's (``repro.launch.specs``).

- ``assert_abstract_cell``: the full-size cell on meta equals the
  reference's abstract cell leaf by leaf in shape and dtype (every
  argument: params, optimizer state, step, batches, caches, in
  ``jax.tree_util.tree_leaves`` order), and in kind, donated arguments
  and note; nothing of it is allocated.
- ``assert_data_bit_equal``: the reduced concrete cell's non-parameter
  arguments (step, batches, caches, positions) equal the reference's
  bit for bit.
- ``carried``: the port's reduced cell on the CPU with the reference's
  params (and, for DPO, its frozen copy) carried across.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import specs as JS
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs as TS
from repro_torch.models.encoder import encoder_from_jax_params
from repro_torch.models.recsys.models import recsys_from_jax_params
from repro_torch.models.transformer import lm_from_jax_params
from repro_torch.models.vit_parser import vit_parser_from_jax_params

_TORCH_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                 torch.float16: "float16", torch.int32: "int32",
                 torch.int64: "int64", torch.bool: "bool"}


def family_cells(family: str) -> list[tuple[str, str]]:
    """The reference's (arch, shape) pairs of one family, in order."""
    return [(a, s) for a, s in JS.all_cells()
            if jax_config(a).family == family]


def signature(x) -> tuple:
    """(shape, dtype name) of a torch tensor, a JAX array or a
    ``jax.ShapeDtypeStruct``."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), _TORCH_DTYPES[x.dtype]
    return tuple(x.shape), np.dtype(x.dtype).name


def host(x) -> np.ndarray:
    """A leaf's values as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_registry_matches() -> None:
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 12
    assert TS.all_cells() == JS.all_cells()
    assert len(TS.all_cells()) == 42


def assert_abstract_cell(arch: str, shape: str, jax_kw=None,
                         port_kw=None) -> None:
    """``jax_kw`` / ``port_kw``: more arguments of each package's
    ``build_cell`` (a ``model_override`` is each package's own config)."""
    want = JS.build_cell(arch, shape, abstract=True, **(jax_kw or {}))
    got = TS.build_cell(arch, shape, abstract=True, **(port_kw or {}))
    assert (got.arch_id, got.shape_name, got.kind, got.donate_argnums,
            got.note) == (want.arch_id, want.shape_name, want.kind,
                          want.donate_argnums, want.note)
    assert got.in_shardings is None and want.in_shardings is None
    assert len(got.args) == len(want.args)
    for i, (g, w) in enumerate(zip(got.args, want.args)):
        gl, wl = TS._tree_leaves(g), jax.tree_util.tree_leaves(w)
        assert all(isinstance(x, torch.Tensor) and x.is_meta for x in gl), \
            (arch, shape, i)
        assert [signature(x) for x in gl] == [signature(x) for x in wl], \
            (arch, shape, i)


def data_positions(cell) -> range:
    """The arguments after the params and the optimizer state (a train
    cell's last donated argument), or after the params."""
    first = cell.donate_argnums[-1] + 1 if cell.kind == "train" else 1
    return range(first, len(cell.args))


def assert_data_bit_equal(arch: str, shape: str, seed: int) -> None:
    want = JS.build_cell(arch, shape, abstract=False, reduced=True,
                         seed=seed)
    got = TS.build_cell(arch, shape, abstract=False, reduced=True,
                        seed=seed, device="cpu")
    assert list(data_positions(got)) == list(data_positions(want))
    for i in data_positions(want):
        gl = TS._tree_leaves(got.args[i])
        wl = jax.tree_util.tree_leaves(want.args[i])
        assert [signature(x) for x in gl] == [signature(x) for x in wl], i
        for g, w in zip(gl, wl):
            np.testing.assert_array_equal(host(g), host(w))


def port_params(family: str, raw, cfg):
    """The reference's raw params (numpy leaves) as the port's."""
    if family == "lm":
        return lm_from_jax_params(raw, cfg, "cpu")
    if family == "recsys":
        return recsys_from_jax_params(raw, cfg, "cpu")
    if family == "vit_parser":
        return vit_parser_from_jax_params(raw, cfg, "cpu")
    if family == "encoder":
        return TS.router_param_tree(encoder_from_jax_params(raw, cfg, "cpu"))
    raise ValueError(family)


def carried(arch: str, shape: str, seed: int = 0):
    """(the reference's reduced cell, the port's on the CPU with its
    params carried across)."""
    want = JS.build_cell(arch, shape, abstract=False, reduced=True,
                         seed=seed)
    got = TS.build_cell(arch, shape, abstract=False, reduced=True,
                        seed=seed, device="cpu")
    tarch = get_config(arch).reduced()
    raw = jax.tree_util.tree_map(np.asarray, want.args[0])
    params = port_params(tarch.family, raw, tarch.model)
    args = list(got.args)
    args[0] = params
    if shape.startswith("dpo"):
        args[1] = port_params(tarch.family, raw, tarch.model)
    got.args = tuple(args)
    return want, got


def close(got, want, tol: float = 2e-5) -> None:
    """Leaf by leaf: equal shapes, values within ``tol`` (integers and
    booleans equal)."""
    gl = TS._tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        g = g.detach().float().numpy() if g.is_floating_point() \
            else g.numpy()
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=tol,
                                       atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


def assert_refusals(family: str) -> None:
    """A skipped shape raises ValueError as the reference does, unless
    reduced; ``rules`` that is not an ``AxisRules`` (nor None) raises
    TypeError, and an ``AxisRules`` gives a sharding for every
    argument."""
    for arch in sorted({a for a, _ in family_cells(family)}):
        for shape in get_config(arch).skips:
            with pytest.raises(ValueError, match="skipped") as got:
                TS.build_cell(arch, shape)
            with pytest.raises(ValueError, match="skipped") as want:
                JS.build_cell(arch, shape)
            assert str(got.value) == str(want.value)
            assert TS.build_cell(arch, shape, reduced=True).shape_name \
                == shape
    arch, shape = family_cells(family)[0]
    with pytest.raises(TypeError, match="AxisRules"):
        TS.build_cell(arch, shape, rules=object())
    from repro_torch.common import tree_leaves
    from repro_torch.distributed.meshrules import AxisRules, NamedSharding

    class _OneByOne:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    cell = TS.build_cell(arch, shape, rules=AxisRules(_OneByOne()))
    shs = tree_leaves(cell.in_shardings,
                      lambda x: isinstance(x, NamedSharding))
    assert len(shs) == len(tree_leaves(cell.args))
