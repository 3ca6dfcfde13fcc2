"""The port's attention (``repro_torch.models.attention``) and its
flash-attention op against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (the JAX package's own, ``tests/test_kernels.py``): 2e-5 in
float32 and 2e-2 in bfloat16, atol and rtol; the two frameworks sum in
another order. On CPU tensors ``ops.flash_attention`` runs the plain
version; the CUDA kernel is held against it in
``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as TA

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the grid of tests/test_kernels.py::test_flash_attention_sweep, plus D=120
SHAPES = [
    (2, 64, 64, 4, 2, 16),
    (1, 48, 80, 4, 4, 32),      # Sq != Skv
    (2, 96, 96, 8, 1, 8),       # MQA
    (1, 100, 100, 2, 2, 64),    # padding path
    (1, 72, 72, 4, 2, 120),     # danube's head dim
]
MASKS = [(True, None), (False, None), (True, 24)]


def _qkv(b, sq, skv, h, hk, d, dtype, seed=0):
    """numpy float32 inputs, rounded to ``dtype`` once, as (jax, torch)
    triples holding the same values."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32) for s in
            ((b, sq, h, d), (b, skv, hk, d), (b, skv, hk, d))]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jj = [jnp.asarray(t.float().numpy()).astype(dtype) for t in tt]
    return jj, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("b,sq,skv,h,hk,d", SHAPES)
def test_flash_ref_and_op_match_jax_ref(b, sq, skv, h, hk, d, causal,
                                        window, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, sq, skv, h, hk, d, dtype)
    want = _np(j_ref(jq, jk, jv, causal=causal, window=window))
    got_ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    got_op = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got_ref.dtype == q.dtype and got_ref.shape == q.shape
    for got in (got_ref, got_op):
        np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("b,sq,skv,h,hk,d,causal,window,dtype", [
    (1, 100, 100, 2, 2, 64, True, None, "float32"),   # padding path
    (2, 96, 96, 8, 1, 8, False, None, "float32"),     # MQA
    (2, 64, 64, 4, 2, 16, True, 24, "float32"),       # window
    (1, 48, 80, 4, 4, 32, True, None, "float32"),     # Sq != Skv
    (1, 48, 80, 4, 4, 32, True, 24, "bfloat16"),
])
def test_flash_op_matches_jax_kernel(b, sq, skv, h, hk, d, causal, window,
                                     dtype):
    """The JAX Pallas kernel in interpret mode, small blocks."""
    (jq, jk, jv), (q, k, v) = _qkv(b, sq, skv, h, hk, d, dtype, seed=1)
    want = _np(flash_attention_kernel(jq, jk, jv, causal=causal,
                                      window=window, block_q=32, block_k=32,
                                      interpret=True))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


def _tensor_core_order(q, k, v, *, causal, window, tile=64):
    """The bf16 CUDA body's order of operations in plain PyTorch: float32
    sums of bf16 q.k products, an online softmax over 64-key tiles in
    the log2 domain (the row maximum of the raw scores, then scaled), p
    split into bf16 hi and lo halves for two bf16 P V products summed in
    float32, one rounding of the output to bf16."""
    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    kk = k.float().repeat_interleave(h // hk, dim=2)
    vv = v.float().repeat_interleave(h // hk, dim=2)
    qf = q.float()
    scale2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        kpos = torch.arange(k0, min(k0 + tile, skv))[None, :]
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= (qpos - kpos) < window
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kk[:, k0:k0 + tile])
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale2)
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s * scale2 - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = vv[:, k0:k0 + tile].permute(0, 2, 1, 3)
        o = o * alpha + hi @ vt + lo @ vt
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,skv,h,hk,d,causal,window", [
    (1, 100, 100, 2, 2, 64, True, None),
    (2, 96, 96, 8, 1, 8, False, None),
    (1, 48, 80, 4, 4, 32, True, 24),
    (1, 130, 130, 4, 2, 120, True, 40),
])
def test_tensor_core_order_matches_jax_kernel(b, sq, skv, h, hk, d, causal,
                                              window):
    """The bf16 body's arithmetic against the JAX Pallas kernel in
    interpret mode, at the bf16 bar."""
    (jq, jk, jv), (q, k, v) = _qkv(b, sq, skv, h, hk, d, "bfloat16", seed=6)
    want = _np(flash_attention_kernel(jq, jk, jv, causal=causal,
                                      window=window, block_q=32, block_k=32,
                                      interpret=True))
    got = _tensor_core_order(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_tensor_core_order_keeps_p_at_float32_precision():
    """Split p stays within the bf16 output's own rounding of the
    float32-p result (max abs error <= 4e-3); p rounded once to bf16
    would not."""
    _, (q, k, v) = _qkv(1, 512, 512, 4, 2, 128, "bfloat16", seed=7)
    want = flash_attention_ref(q, k, v, causal=True).float()
    got = _tensor_core_order(q, k, v, causal=True, window=None).float()
    assert (got - want).abs().max().item() <= 4e-3


def test_fully_masked_tile_gives_no_nan():
    """Window 8 over 200 keys: the late query rows meet whole 64-key
    tiles (and 32-key blocks) in which every key is masked for them."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 200, 200, 4, 2, 16, "float32", seed=2)
    want = _np(j_ref(jq, jk, jv, causal=True, window=8))
    for got in (ops.flash_attention(q, k, v, causal=True, window=8),
                TA.attention_xla_flash(q, k, v, causal=True, window=8,
                                       q_chunk=32, kv_chunk=32)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)


def test_flash_op_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q[:, :, :2], k, k.double())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q[:, :, :2], k, k, window=0)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[:, :, :2], torch.zeros(1, 8, 2, 8),
                            torch.zeros(1, 8, 2, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7)])
def test_naive_and_xla_flash_match_jax(causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(2, 33, 49, 4, 2, 8, dtype, seed=3)
    want = _np(JA.attention_naive(jq, jk, jv, causal=causal, window=window))
    got = TA.attention_naive(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    want = _np(JA.attention_xla_flash(jq, jk, jv, causal=causal,
                                      window=window, q_chunk=8, kv_chunk=16))
    got = TA.attention_xla_flash(q, k, v, causal=causal, window=window,
                                 q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("impl", ["naive", "xla_flash", "pallas"])
def test_dispatcher_matches_jax(impl):
    (jq, jk, jv), (q, k, v) = _qkv(1, 40, 40, 4, 2, 16, "float32", seed=4)
    kw = dict(causal=True, window=12, impl=impl, q_chunk=16, kv_chunk=16)
    want = _np(JA.attention(jq, jk, jv, **kw))
    np.testing.assert_allclose(_np(TA.attention(q, k, v, **kw)), want,
                               atol=2e-5, rtol=2e-5)


def test_dispatcher_short_xla_flash_is_naive_and_offset_pallas_refuses():
    _, (q, k, v) = _qkv(1, 16, 16, 2, 2, 8, "float32", seed=5)
    torch.testing.assert_close(
        TA.attention(q, k, v, impl="xla_flash", q_offset=3),
        TA.attention_naive(q, k, v, q_offset=3), atol=0, rtol=0)
    with pytest.raises(ValueError, match="q_offset"):
        TA.attention(q, k, v, impl="pallas", q_offset=3)
    with pytest.raises(ValueError, match="unknown"):
        TA.attention(q, k, v, impl="cudnn")


@pytest.mark.parametrize("window", [None, 5, 64])
@pytest.mark.parametrize("pos", [0, 9, 19])
def test_decode_attention_and_cache_update_match_jax(window, pos):
    rng = np.random.RandomState(pos)
    ck, cv = (rng.randn(2, 20, 2, 8).astype(np.float32) for _ in range(2))
    nk, nv = (rng.randn(2, 1, 2, 8).astype(np.float32) for _ in range(2))
    q = rng.randn(2, 1, 4, 8).astype(np.float32)
    jk, jv = JA.cache_update(jnp.asarray(ck), jnp.asarray(cv),
                             jnp.asarray(nk), jnp.asarray(nv),
                             jnp.asarray(pos))
    tk, tv = TA.cache_update(torch.from_numpy(ck.copy()),
                             torch.from_numpy(cv.copy()),
                             torch.from_numpy(nk), torch.from_numpy(nv), pos)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = _np(JA.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                   window=window))
    got = TA.decode_attention(torch.from_numpy(q), tk, tv, pos,
                              window=window)
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)


def test_cache_update_writes_in_place_and_clamps_like_jax():
    ck = torch.zeros(1, 4, 1, 2)
    cv = torch.zeros(1, 4, 1, 2)
    new = torch.ones(1, 1, 1, 2)
    out_k, _ = TA.cache_update(ck, cv, new, new, 9)
    assert out_k is ck and ck[0, 3].eq(1).all() and ck[0, :3].eq(0).all()
    jk, _ = JA.cache_update(jnp.zeros((1, 4, 1, 2)), jnp.zeros((1, 4, 1, 2)),
                            jnp.ones((1, 1, 1, 2)), jnp.ones((1, 1, 1, 2)),
                            jnp.asarray(9))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jk))


@pytest.mark.parametrize("b,sq,h,hk,d,causal,window", [
    (1, 40, 4, 2, 8, True, None),       # GQA 2, S not a multiple of 16
    (2, 37, 4, 2, 8, True, 12),         # window
    (1, 33, 2, 2, 16, False, None),     # full
])
def test_xla_flash_gradients_match_jax(b, sq, h, hk, d, causal, window):
    """``attention_xla_flash`` is differentiable (the LM trains through
    it) and its gradients of ``sum(out * ct)`` in float32 are within 2e-5
    of ``jax.grad`` of the JAX package's, with chunks of 16 (ragged last
    block, several visible pairs per query block)."""
    import jax

    (jq, jk, jv), (q, k, v) = _qkv(b, sq, sq, h, hk, d, "float32", seed=8)
    ct = np.random.RandomState(9).randn(b, sq, h, d).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=16)

    def j_loss(q, k, v):
        return (JA.attention_xla_flash(q, k, v, **kw) * ct).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = TA.attention_xla_flash(*leaves, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)
