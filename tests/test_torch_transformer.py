"""The port's dense LM serve path (``repro_torch.models.transformer``)
against the JAX package on the CPU, on the reduced ``qwen3-1.7b``
(qwen3-tiny: qk-norm, GQA) and ``h2o-danube-3-4b`` (danube-tiny: sliding
window 32) configs in float32.

The JAX LM's params (``init_lm``, unwrapped to numpy) are carried across
with ``lm_from_jax_params``; tokens are drawn with numpy. The JAX
package runs ``attention_impl="pallas"`` through its Pallas kernel in
interpret mode, the port through its flash op (the plain version, on CPU
tensors). Tolerances: 2e-5 on logits and caches against JAX (another
summation order); 1e-4 for prefill + decode against the full forward
(the bar of ``tests/test_models.py``); 2e-6 for the layer functions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.attention import KVCache as JKVCache
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.attention import KVCache

ARCHS = ["qwen3-1.7b", "h2o-danube-3-4b"]
IMPLS = ["naive", "xla_flash", "pallas"]
B, S = 2, 48                 # S > danube-tiny's window of 32


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg = j_get_config(request.param).reduced().model
    tcfg = get_config(request.param).reduced().model
    assert repr(jcfg) == repr(tcfg)
    raw = jax.tree_util.tree_map(np.asarray, unwrap(JT.init_lm(jcfg, 0)))
    toks = np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, raw, TT.lm_from_jax_params(raw, tcfg, "cpu"), toks


def _impl(cfg, impl):
    # chunks of 16 send xla_flash through its block-pair path
    return dataclasses.replace(cfg, attention_impl=impl, q_chunk=16,
                               kv_chunk=16)


def _pad(k, v):
    """Room for one decode step: pad the cache's sequence axis by 1."""
    if isinstance(k, torch.Tensor):
        return KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
                         for t in (k, v)))
    return JKVCache(*(jnp.pad(t, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
                      for t in (k, v)))


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_logits_match_jax(lm, impl):
    jcfg, tcfg, raw, params, toks = lm
    want, _ = JT.lm_logits(raw, _impl(jcfg, impl), jnp.asarray(toks))
    got, aux = TT.lm_logits(params, _impl(tcfg, impl), torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(lm, impl):
    jcfg, tcfg, raw, params, toks = lm
    jc, tc = _impl(jcfg, impl), _impl(tcfg, impl)
    j_logits, j_cache = JT.prefill(raw, jc, jnp.asarray(toks[:, :-1]))
    t_logits, t_cache = TT.prefill(params, tc, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=2e-5)
    for got, want in zip(t_cache, j_cache):
        assert got.shape == (tcfg.n_layers, B, S - 1, tcfg.n_kv_heads,
                             tcfg.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    j_dec, j_cache = JT.decode_step(raw, jc, jnp.asarray(toks[:, -1:]),
                                    _pad(*j_cache), jnp.asarray(S - 1))
    t_dec, t_cache = TT.decode_step(params, tc, torch.from_numpy(toks[:, -1:]),
                                    _pad(*t_cache), S - 1)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=2e-5)
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                               atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode_match_full_forward(lm, impl):
    """Prefill S-2 tokens, then decode two: each step's logits equal the
    full forward's at that position."""
    _, tcfg, _, params, toks = lm
    cfg = _impl(tcfg, impl)
    full, _ = TT.lm_logits(params, cfg, torch.from_numpy(toks))
    logits, cache = TT.prefill(params, cfg, torch.from_numpy(toks[:, :-2]))
    torch.testing.assert_close(logits, full[:, -3], atol=1e-4, rtol=0)
    cache = KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 2))
                      for t in cache))
    for pos in (S - 2, S - 1):
        logits, cache = TT.decode_step(
            params, cfg, torch.from_numpy(toks[:, pos:pos + 1]), cache, pos)
        torch.testing.assert_close(logits, full[:, pos], atol=1e-4, rtol=0)


def test_layer_functions_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 40, 4, 16).astype(np.float32) * 3
    scale = rng.randn(16).astype(np.float32) * 0.1
    pos = np.arange(40)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=2e-6)

    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    close(TL.rope_frequencies(16, 1e6), JL.rope_frequencies(16, 1e6))
    for theta in (1e4, 1e6):
        close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta),
              JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    g, u = x[..., :8], x[..., 8:]
    close(TL.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
          JL.swiglu(jnp.asarray(g), jnp.asarray(u)))
    for cap in (None, 30.0):
        close(TL.softcap(torch.from_numpy(x * 20), cap),
              JL.softcap(jnp.asarray(x * 20), cap))


def test_rms_norm_scales_by_one_plus_scale_and_keeps_dtype():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    zero = TL.rms_norm(x, torch.zeros(8))
    assert zero.dtype == torch.bfloat16
    xf = x.float()
    want = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    torch.testing.assert_close(zero, want.to(torch.bfloat16), atol=0, rtol=0)


def test_init_lm_layout_seed_and_device():
    cfg = get_config("qwen3-1.7b").reduced().model
    a = TT.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TT.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    c = TT.init_lm(cfg, torch.Generator().manual_seed(4), "cpu")
    raw = jax.tree_util.tree_map(
        np.asarray, unwrap(JT.init_lm(j_get_config("qwen3-1.7b")
                                      .reduced().model, 0)))
    assert set(a) == set(raw) and set(a["layers"]) == set(raw["layers"])
    for k, v in raw["layers"].items():
        assert tuple(a["layers"][k].shape) == v.shape
        assert a["layers"][k].dtype == torch.float32
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["ln_attn"].eq(0).all() and a["ln_final"].eq(0).all()
    n = sum(t.numel() for t in a["layers"].values()) + sum(
        t.numel() for k, t in a.items() if k != "layers")
    assert n == cfg.n_params()
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_lm(cfg)                        # cuda by default; no card


def test_lm_from_jax_params_copies_bf16_bit_for_bit_and_checks_shapes():
    jcfg = j_get_config("qwen3-1.7b").reduced().model
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced().model,
                               param_dtype="bfloat16")
    raw = jax.tree_util.tree_map(np.asarray, unwrap(JT.init_lm(jcfg, 1)))
    params = TT.lm_from_jax_params(raw, tcfg, "cpu")
    want = raw["layers"]["wq"].astype(np.float32)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["layers"]["wq"].float().numpy(),
                                  want)
    bad = dict(raw, layers=dict(raw["layers"],
                                wk=raw["layers"]["wk"][:, :-1]))
    with pytest.raises(ValueError, match="wk"):
        TT.lm_from_jax_params(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        TT.lm_from_jax_params({k: v for k, v in raw.items()
                               if k != "lm_head"}, tcfg, "cpu")
