"""``repro_torch.common`` against ``repro.common`` on the same numpy
inputs: the tree utilities (``tree_size``, ``tree_bytes``,
``global_norm`` in float32 within 1e-6, ``stack_layers``, ``wrap_like``,
``unwrap``, ``axes_tree``), ``ceil_div``/``round_up`` and
``Policy.cast_compute``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import common as JC
from repro_torch import common as TC
from repro_torch.models.layers import from_numpy

DTYPES = [(np.float32, jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16),
          (np.int32, jnp.int32, torch.int32)]


def _arrays(seed: int) -> dict:
    r = np.random.RandomState(seed)
    return {"a": r.randn(3, 4).astype(np.float32),
            "b": [r.randn(5).astype(np.float32),
                  r.randint(-9, 9, (2, 2, 3)).astype(np.int32)],
            "c": {"d": r.randn(7, 2).astype(np.float32), "e": r.randn(1)
                  .astype(np.float32)}}


AXES = {"a": ("d_model", "d_ff"), "b": [(None,), ("layers", None, "heads")],
        "c": {"d": ("vocab", None), "e": (None,)}}


def _jax_tree(arrs, dtype=None):
    def go(x, ax):
        v = jnp.asarray(x) if dtype is None or x.dtype == np.int32 \
            else jnp.asarray(x, dtype)
        return JC.Param(v, ax)
    return jax.tree_util.tree_map(go, arrs, AXES,
                                  is_leaf=lambda x: isinstance(x, np.ndarray))


def _port_tree(arrs, dtype=None):
    def go(x, ax):
        v = from_numpy(x)
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        return TC.Param(v, ax)
    return TC.tree_map(go, arrs, AXES,
                       is_leaf=lambda x: isinstance(x, np.ndarray))


def _np(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_size_and_bytes(seed):
    arrs = _arrays(seed)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        jt, pt = _jax_tree(arrs, jdt), _port_tree(arrs, tdt)
        assert TC.tree_size(pt) == JC.tree_size(JC.unwrap(jt))
        assert TC.tree_bytes(pt) == JC.tree_bytes(JC.unwrap(jt))
        assert TC.tree_bytes(TC.unwrap(pt)) == JC.tree_bytes(JC.unwrap(jt))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm(seed):
    arrs = _arrays(seed)
    want = float(JC.global_norm(JC.unwrap(_jax_tree(arrs))))
    got = float(TC.global_norm(TC.unwrap(_port_tree(arrs))))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    # a Param tree counts its tensors
    assert float(TC.global_norm(_port_tree(arrs))) == got


@pytest.mark.parametrize("a", [0, 1, 7, 8, 9, 511, 512, 513, 61859140])
@pytest.mark.parametrize("b", [1, 8, 512])
def test_ceil_div_and_round_up(a, b):
    assert TC.ceil_div(a, b) == JC.ceil_div(a, b)
    assert TC.round_up(a, b) == JC.round_up(a, b)


def test_unwrap_axes_tree_and_wrap_like():
    arrs = _arrays(3)
    jt, pt = _jax_tree(arrs), _port_tree(arrs)
    want = jax.tree_util.tree_leaves(JC.unwrap(jt))
    got = TC.tree_leaves(TC.unwrap(pt))
    assert len(got) == len(want)
    assert all(np.array_equal(_np(g), np.asarray(w))
               for g, w in zip(got, want))
    ja = jax.tree_util.tree_leaves(JC.axes_tree(jt),
                                   is_leaf=lambda x: isinstance(x, tuple))
    pa = TC.tree_leaves(TC.axes_tree(pt), lambda x: isinstance(x, tuple))
    assert pa == ja
    # wrap_like re-attaches the axes onto new values, structure kept
    doubled = TC.tree_map(lambda t: t * 2, TC.unwrap(pt))
    w = TC.wrap_like(doubled, pt)
    assert TC.axes_tree(w) == TC.axes_tree(pt)
    jw = JC.wrap_like(jax.tree_util.tree_map(lambda x: x * 2,
                                             JC.unwrap(jt)), jt)
    assert all(np.array_equal(_np(g), np.asarray(v)) for g, v in zip(
        TC.tree_leaves(TC.unwrap(w)),
        jax.tree_util.tree_leaves(JC.unwrap(jw))))


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stack_layers(n_layers):
    layers = [_arrays(10 + i) for i in range(n_layers)]
    jt = JC.stack_layers([_jax_tree(a) for a in layers])
    pt = TC.stack_layers([_port_tree(a) for a in layers])
    assert TC.tree_leaves(TC.axes_tree(pt), lambda x: isinstance(x, tuple)) \
        == jax.tree_util.tree_leaves(JC.axes_tree(jt),
                                     is_leaf=lambda x: isinstance(x, tuple))
    for g, w in zip(TC.tree_leaves(TC.unwrap(pt)),
                    jax.tree_util.tree_leaves(JC.unwrap(jt))):
        assert g.shape == w.shape and np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("src", [0, 1, 2], ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("dst", [0, 1], ids=["to_f32", "to_bf16"])
def test_policy_cast_compute(src, dst):
    arrs = {k: v for k, v in _arrays(4).items() if k != "b"}
    arrs["i"] = np.arange(6, dtype=np.int32)
    jdt, tdt = DTYPES[src][1], DTYPES[src][2]
    jtree = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if x.dtype == np.int32
        else jnp.asarray(x, jdt), arrs)
    ptree = TC.tree_map(lambda x: from_numpy(x) if x.dtype == np.int32
                        else from_numpy(x).to(tdt), arrs)
    want = JC.Policy(compute_dtype=DTYPES[dst][1]).cast_compute(jtree)
    got = TC.Policy(compute_dtype=DTYPES[dst][2]).cast_compute(ptree)
    for g, w in zip(TC.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert np.array_equal(_np(g), np.asarray(w, np.float32)
                              if w.dtype == jnp.bfloat16 else np.asarray(w))


def test_param_init_and_abstractify():
    g = torch.Generator().manual_seed(0)
    p = TC.param(g, (4, 6), ("d_model", None), TC.normal_init(0.5),
                 torch.bfloat16)
    assert p.shape == (4, 6) and p.dtype == torch.bfloat16
    assert p.axes == ("d_model", None)
    a = TC.param(None, (4, 6), ("d_model", None), abstract=True)
    assert a.value.is_meta and a.dtype == torch.float32
    t = TC.abstractify({"p": p, "x": torch.ones(3)})
    assert t["p"].value.is_meta and t["p"].axes == p.axes
    assert t["x"].is_meta and t["x"].shape == (3,)
    with pytest.raises(AssertionError):
        TC.param(None, (4, 6), ("d_model",))


def test_keygen_hands_out_distinct_seeded_generators():
    a, b = TC.KeyGen(3), TC.KeyGen(3)
    ga, gb = a(2), b(2)
    draws = [torch.randn(4, generator=g) for g in ga + gb]
    assert torch.equal(draws[0], draws[2]) and torch.equal(draws[1],
                                                           draws[3])
    assert not torch.equal(draws[0], draws[1])
    assert isinstance(TC.KeyGen(torch.Generator().manual_seed(1))(),
                      torch.Generator)
