"""The logical axes of every param, from the port's own inits
(``keep_axes=True``), against ``repro.common.axes_tree`` of the JAX
package's abstract inits: for every arch of ``list_archs()``, leaf by key
path, the same axes, shapes and dtypes; and the default (plain tensors)
equal to ``unwrap`` of the Param tree."""
import jax
import pytest
import torch

from repro import common as JC
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro_torch import common as TC
from repro_torch.configs import get_config, list_archs


def _jax_init(arch):
    from repro.models import encoder, transformer, vit_parser
    from repro.models.gnn import equiformer
    from repro.models.recsys import models as recsys
    init = {"lm": transformer.init_lm, "encoder": encoder.init_encoder,
            "gnn": equiformer.init_equiformer,
            "recsys": recsys.init_recsys,
            "vit_parser": vit_parser.init_vit_parser}[arch.family]
    return init(arch.model, 0, abstract=True)


def _port_init(arch, **kw):
    from repro_torch.launch import specs
    from repro_torch.models import transformer, vit_parser
    from repro_torch.models.gnn import equiformer
    from repro_torch.models.recsys import models as recsys
    init = {"lm": transformer.init_lm,
            "encoder": specs.init_router_params,
            "gnn": equiformer.init_equiformer,
            "recsys": recsys.init_recsys,
            "vit_parser": vit_parser.init_vit_parser}[arch.family]
    return init(arch.model, torch.Generator().manual_seed(0), "meta", **kw)


def _jax_leaves(tree) -> dict:
    out = {}
    for path, p in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=JC.is_param)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        out[key] = (tuple(p.axes), tuple(p.value.shape),
                    str(p.value.dtype))
    return out


def _port_leaves(tree) -> dict:
    return {path: (tuple(p.axes), p.shape,
                   str(p.dtype).removeprefix("torch."))
            for path, p in TC.tree_leaves_with_path(tree, TC.is_param)}


def test_same_archs():
    assert list_archs() == jax_archs()


@pytest.mark.parametrize("arch_id", list_archs())
def test_axes_tree_equals_reference(arch_id):
    want = _jax_leaves(_jax_init(jax_config(arch_id)))
    tree = _port_init(get_config(arch_id), keep_axes=True)
    got = _port_leaves(tree)
    assert got == want
    # axes_tree gives the same tuples in the same structure
    axes = TC.tree_leaves_with_path(TC.axes_tree(tree),
                                    lambda x: isinstance(x, tuple))
    assert {p: a for p, a in axes} == {k: v[0] for k, v in want.items()}


@pytest.mark.parametrize("arch_id", list_archs())
def test_default_is_the_unwrapped_tree(arch_id):
    arch = get_config(arch_id)
    plain = _port_init(arch)
    tree = TC.unwrap(_port_init(arch, keep_axes=True))
    a = TC.tree_leaves_with_path(plain)
    b = TC.tree_leaves_with_path(tree)
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(x.shape == y.shape and x.dtype == y.dtype and x.is_meta
               for (_, x), (_, y) in zip(a, b))
