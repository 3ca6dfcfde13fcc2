"""The port's optimizer core and AdamW (``repro_torch.optim``) against
``repro.optim`` on seeded numpy trees, for several steps.

The JAX package works on dict trees; the port on lists of tensors, here
in the dict's sorted-key order (``jax.tree_util.tree_leaves``). A leaf
whose grad the port gets as ``None`` gets a zero grad on the JAX side,
which is what ``jax.grad`` gives a parameter the loss does not reach: it
must still decay and still count in the global norm.

Tolerance: 1e-6 in float32 (the two frameworks may round a fused
multiply-add apart); bf16 params must be bit-equal (the update is rounded
to bf16 before the add in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 2), "frozen": (3,)}


def _tree(rng, scale=1.0):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_jax(tree, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype):
    return [torch.tensor(tree[k]).to(dtype) for k in sorted(tree)]


def _as_f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _assert_close(j_tree, t_list, bf16, atol=1e-6):
    for k, t in zip(sorted(j_tree), t_list):
        if bf16:
            np.testing.assert_array_equal(_as_f32(t), _as_f32(j_tree[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(_as_f32(t), _as_f32(j_tree[k]),
                                       atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [3.0, 0.01])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_chain_clip_steps_match_jax(dtype, grad_scale, weight_decay):
    """``chain_clip(adamw(lr, wd), 1.0)`` for 6 steps: a global norm
    above max_norm (grad_scale 3) and below it (0.01); ``frozen`` has a
    ``None`` grad in the port and a zero grad in JAX."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(0)
    init = _tree(rng)
    jp, tp = _to_jax(init, jdt), _to_torch(init, tdt)
    jo = jopt.chain_clip(jopt.adamw(1e-2, weight_decay=weight_decay), 1.0)
    to = topt.chain_clip(topt.adamw(1e-2, weight_decay=weight_decay), 1.0)
    js, ts = jo.init(jp), to.init(tp)
    norms = []
    for step in range(6):
        g = _tree(rng, grad_scale)
        g["frozen"] = np.zeros(SHAPES["frozen"], np.float32)
        jg = _to_jax(g, jdt)
        tg = _to_torch(g, tdt)
        tg[sorted(g).index("frozen")] = None
        norms.append(float(jopt.base.global_norm(jg)))
        np.testing.assert_allclose(float(topt.global_norm(tg)), norms[-1],
                                   rtol=1e-6)
        ju, js = jo.update(jg, js, jp, jnp.asarray(step))
        tu, ts = to.update(tg, ts, tp, step)
        _assert_close(ju, tu, bf16=False)          # float32 updates
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        _assert_close(jp, tp, bf16=dtype == "bfloat16")
        for name in ("m", "v"):
            _assert_close(js[name], ts[name], bf16=False)
    assert (min(norms) > 1.0) if grad_scale > 1 else (max(norms) < 1.0)
    frozen = tp[sorted(init).index("frozen")]
    if weight_decay and dtype == "float32":
        assert not torch.equal(frozen, _to_torch(init, tdt)[
            sorted(init).index("frozen")])              # it decayed


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(max_norm, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    g = _tree(np.random.RandomState(1))
    jg, jn = jopt.clip_by_global_norm(_to_jax(g, jdt), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(g, tdt), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert all(t.dtype == tdt for t in tg)
    _assert_close(jg, tg, bf16=dtype == "bfloat16")
    # a None leaf is passed through and adds nothing to the norm
    tg2, tn2 = topt.clip_by_global_norm(_to_torch(g, tdt) + [None],
                                        max_norm)
    assert tg2[-1] is None and float(tn2) == float(tn)


def test_apply_updates_rounds_update_first():
    """bf16 params + float32 updates: the update is cast to bf16 before
    the add, bit for bit as ``p + u.astype(p.dtype)``; an update that a
    single rounding of the float32 sum would keep is lost here."""
    rng = np.random.RandomState(2)
    p = _tree(rng)
    u = {k: (v * 1e-3).astype(np.float32) for k, v in _tree(rng).items()}
    jp = jopt.apply_updates(_to_jax(p, jnp.bfloat16), _to_jax(u, jnp.float32))
    tp = topt.apply_updates(_to_torch(p, torch.bfloat16),
                            _to_torch(u, torch.float32))
    _assert_close(jp, tp, bf16=True)
    # u = 2^-8 + 2^-20 rounds to 2^-8 in bf16, and 1 + 2^-8 is a tie
    # that rounds to 1; one rounding of the float32 sum gives 1 + 2^-7
    u = torch.full((1,), 2.0 ** -8 + 2.0 ** -20)
    one = torch.ones(1, dtype=torch.bfloat16)
    topt.apply_updates([one], [u])
    assert float(one) == 1.0
    assert float(torch.ones(1, dtype=torch.bfloat16).add_(u)) == 1.0078125


@pytest.mark.parametrize("b", [0.9, 0.95])
def test_bias_correction_equals_xla_float32(b):
    """``1 - b ** t`` with a float32 ``t`` as XLA computes it, for the
    first 5,000 steps: the port's float64 power rounded once gives the
    same float32 bits (torch's and numpy's float32 ``pow`` do not)."""
    from repro_torch.optim.adamw import _bias_correction

    t = np.arange(1, 5001, dtype=np.float32)
    want = np.asarray(1 - b ** jnp.asarray(t))
    got = np.array([_bias_correction(b, x) for x in t], np.float32)
    np.testing.assert_array_equal(got, want)
