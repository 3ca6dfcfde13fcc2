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


# -- Adafactor, schedules, compression ----------------------------------

AF_SHAPES = {"big": (16, 32), "c3": (2, 8, 12), "small": (4,),
             "thin": (4, 32)}            # factored, factored, -, -


def _af_tree(rng, scale=1.0):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in AF_SHAPES.items()}


def _j_schedules():
    return [jopt.constant(0.01), jopt.linear_warmup(0.01, 7),
            jopt.cosine_decay(0.01, 50), jopt.warmup_cosine(0.01, 5, 40)]


def _t_schedules():
    return [topt.constant(0.01), topt.linear_warmup(0.01, 7),
            topt.cosine_decay(0.01, 50), topt.warmup_cosine(0.01, 5, 40)]


def test_schedules_match_jax():
    """The four schedules over steps 0..79 (warm-up, decay and the
    clipped tail), as float32 values within 1e-6 relative."""
    for j, t in zip(_j_schedules(), _t_schedules()):
        for step in range(80):
            got = t(step)
            assert isinstance(got, np.float32)
            np.testing.assert_allclose(got, float(j(jnp.asarray(step))),
                                       rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("sched", [0, 3])
def test_adafactor_steps_match_jax(weight_decay, sched):
    """``adafactor(..., min_dim_factored=8)`` for 8 steps on factored
    (2-D and batched 3-D) and unfactored (1-D, a 2-D leaf with a dim
    below 8) leaves, with a constant lr and ``warmup_cosine``: updates,
    params and the factored state within 1e-6."""
    rng = np.random.RandomState(3)
    init = _af_tree(rng)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = [torch.tensor(init[k]) for k in sorted(init)]
    jo = jopt.adafactor(_j_schedules()[sched], min_dim_factored=8,
                        weight_decay=weight_decay)
    to = topt.adafactor(_t_schedules()[sched], min_dim_factored=8,
                        weight_decay=weight_decay)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(8):
        g = _af_tree(rng, 0.3)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, jnp.asarray(step))
        tu, ts = to.update([torch.tensor(g[k]) for k in sorted(g)], ts, tp,
                           step)
        _assert_close(ju, tu, bf16=False)
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        _assert_close(jp, tp, bf16=False)
        for k, st in zip(sorted(g), ts["v"]):
            assert set(st) == set(js["v"][k])
            for name in st:
                np.testing.assert_allclose(st[name].numpy(),
                                           np.asarray(js["v"][k][name]),
                                           rtol=1e-6, atol=1e-9)


def test_adafactor_beta2_equals_xla_float32():
    """``1 - t**(-0.8)`` for the first 5,000 steps: the port's host value
    has XLA's float32 bits."""
    from repro_torch.optim.adafactor import _beta2

    t = jnp.arange(5000, dtype=jnp.float32) + 1.0
    want = np.asarray(1.0 - t ** (-0.8))
    got = np.array([_beta2(s, 0.8) for s in range(5000)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_adafactor_state_is_factored():
    """The port of ``tests/test_integration.py``'s test."""
    opt = topt.adafactor(1e-2, min_dim_factored=8)
    st = opt.init([torch.zeros(16, 32), torch.zeros(4)])
    assert set(st["v"][0]) == {"vr", "vc"}
    assert st["v"][0]["vr"].shape == (16,)
    assert st["v"][0]["vc"].shape == (32,)
    assert set(st["v"][1]) == {"v"}


def test_adamw_and_adafactor_reduce_quadratic():
    """The port of ``tests/test_integration.py``'s test: 200 steps of
    each optimizer take a quadratic below 1e-2."""
    def loss(p):
        return (p[0] - 3.0).square().sum() + (p[1] + 1.0).square().sum()

    for opt in (topt.adamw(0.1),
                topt.adafactor(lambda s: 0.5 / (1.0 + 0.05 * s))):
        params = [torch.zeros(4, 4), torch.zeros(4)]
        state = opt.init(params)
        for step in range(200):
            leaves = [p.clone().requires_grad_(True) for p in params]
            g = torch.autograd.grad(loss(leaves), leaves)
            upd, state = opt.update(list(g), state, params, step)
            topt.apply_updates(params, upd)
        assert float(loss(params)) < 1e-2


def test_adamw_with_a_schedule_matches_jax():
    """``chain_clip(adamw(warmup_cosine(...)))``: the callable lr, taken
    in float32, for 10 steps through warm-up into the decay."""
    rng = np.random.RandomState(4)
    init = _tree(rng)
    jp, tp = _to_jax(init, jnp.float32), _to_torch(init, torch.float32)
    jo = jopt.chain_clip(jopt.adamw(jopt.warmup_cosine(0.01, 3, 12),
                                    weight_decay=0.1), 1.0)
    to = topt.chain_clip(topt.adamw(topt.warmup_cosine(0.01, 3, 12),
                                    weight_decay=0.1), 1.0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(10):
        g = _tree(rng, 2.0)
        ju, js = jo.update(_to_jax(g, jnp.float32), js, jp,
                           jnp.asarray(step))
        tu, ts = to.update(_to_torch(g, torch.float32), ts, tp, step)
        _assert_close(ju, tu, bf16=False)
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
    _assert_close(jp, tp, bf16=False)


def test_int8_and_topk_compression_match_jax():
    from repro.optim import compression as JC
    from repro_torch.optim import compression as TC

    rng = np.random.RandomState(5)
    x = rng.randn(7, 9).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max()      # not a tie at the max
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TC.dequantize_int8(tq, ts).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))
    # half-way values round to even in both
    h = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])
    assert TC.quantize_int8(h)[0].tolist() == \
        np.asarray(JC.quantize_int8(jnp.asarray(h.numpy()))[0]).tolist()
    r = rng.randn(7, 9).astype(np.float32) * 0.1
    for ratio in (0.01, 0.1, 0.5):
        jk, jr = JC.error_feedback_topk(jnp.asarray(x), jnp.asarray(r),
                                        ratio)
        tk, tr = TC.error_feedback_topk(torch.from_numpy(x),
                                        torch.from_numpy(r), ratio)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_gradients_match_jax(scheme):
    """Five steps of ``compressed_gradients`` with its residual state:
    the compressed grads, the residuals and the wire estimate."""
    from repro.optim import compression as JC
    from repro_torch.optim import compression as TC

    rng = np.random.RandomState(6)
    keys = sorted(SHAPES)
    jstate = JC.init_compression_state(_to_jax(_tree(rng), jnp.float32))
    tstate = TC.init_compression_state(_to_torch(_tree(rng), torch.float32))
    for _ in range(5):
        g = _tree(rng)
        jc, jstate, jw = JC.compressed_gradients(
            _to_jax(g, jnp.float32), jstate, scheme=scheme, topk_ratio=0.2)
        tc, tstate, tw = TC.compressed_gradients(
            _to_torch(g, torch.float32), tstate, scheme=scheme,
            topk_ratio=0.2)
        assert tw == jw
        for k, a, b in zip(keys, tc, tstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(jc[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
            np.testing.assert_allclose(b.numpy(), np.asarray(jstate[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(ValueError):
        TC.compressed_gradients(tc, tstate, scheme="fp4")


def test_compressed_allreduce_error_feedback_converges():
    """The port of ``tests/test_integration.py``'s test: int8-compressed
    gradients with error feedback track the true sum over 50 steps."""
    from repro_torch.optim.compression import (compressed_gradients,
                                               init_compression_state)

    rng = np.random.RandomState(0)
    g_true = [torch.tensor(rng.randn(64) * 0.01, dtype=torch.float32)]
    state = init_compression_state(g_true)
    acc = torch.zeros(64)
    acc_true = torch.zeros(64)
    for _ in range(50):
        comp, state, _ = compressed_gradients(g_true, state, scheme="int8")
        acc = acc + comp[0]
        acc_true = acc_true + g_true[0]
    assert float((acc - acc_true).abs().max() / acc_true.abs().max()) < 0.01
