"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, over small shape sweeps and edge cases, plus the
ft engine on cuda against cpu. Marked ``cuda``: every test skips on a
host without a card (the decision is taken in the fixture, at run
time). Run on the card with ``python -m pytest -m cuda tests``.

Tolerances: fast_features tokens/mask exact and features within 1e-6
(the JAX kernel's bar; the float64 assembly makes them bit-equal in
practice); budget_route exact; ngram_score float32 kernel against the
float64 plain version within atol 1e-6, rtol 1e-5; flash_attention
within 2e-5 in float32 and 2e-2 in bfloat16, atol and rtol (the JAX
kernel's bar, tests/test_kernels.py), and the reduced LMs on cuda
against cpu within 2e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.budget_route import ops as br
from repro_torch.kernels.budget_route.ref import budget_route_ref
from repro_torch.kernels.fast_features import ops as ff
from repro_torch.kernels.fast_features.ref import fast_features_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ngram_score import ops as ng
from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pages(n, seed, vocab=10000):
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append([])
        elif kind == 1:
            out.append([np.zeros(0, np.int32)] * 2)
        else:
            out.append([r.randint(0, vocab, r.randint(0, 700))
                        .astype(np.int32) for _ in range(r.randint(1, 6))])
    return out


@pytest.mark.parametrize("seed,max_len", [(0, 0), (1, 32), (2, 512)])
def test_fast_features_kernel_vs_plain(dev, seed, max_len):
    packed = ff.pack_routing_batch(_pages(37, seed), max_len=max_len)
    ins = [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in (
        packed.tok_matrix, packed.n_tok, packed.first_len, packed.n_pages,
        packed.n_empty)]
    kw = dict(max_len=max_len, ws=2, scramble=3, mangled=4, latex_lo=8010,
              ident_lo=8510, vocab_size=10000)
    before = ff.KERNEL.launches
    got = ff.fast_features(*ins, **kw)
    assert ff.KERNEL.launches == before + 1
    want = fast_features_ref(*ins, **kw)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    if max_len:
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    bad = ins[0].clone()
    bad[int(torch.nonzero(ins[1])[0]), 0] = 10000
    with pytest.raises(ValueError, match="vocab"):
        ff.fast_features(bad, *ins[1:], **kw)


@pytest.mark.parametrize("n,d,alpha", [
    (3, 4, 2 / 3), (80, 4, 0.1), (256, 512, 0.05), (1500, 7, 0.2),
    (5000, 16, 0.5), (65536, 8, 0.05)])
def test_budget_route_kernel_vs_plain(dev, n, d, alpha):
    g = torch.Generator(device=dev).manual_seed(n)
    scores = torch.round(torch.randn(n, generator=g, device=dev) * 3) / 3
    tokens = torch.randint(0, 1 << 30, (n, d), generator=g,
                           dtype=torch.int32, device=dev)
    cap = br.capacity_floor(alpha, n)
    tau = br.route_tau(scores, cap)
    got = br.budget_route_kernel(scores, tokens, tau, capacity=cap)
    want = budget_route_ref(scores, tokens, tau[0], capacity=cap)
    assert torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[0], want[0])
    full = br.budget_route(scores, tokens, alpha)
    assert torch.equal(full[1], want[1])


@pytest.mark.parametrize("b,max_len,vocab", [
    (4, 32, 6), (6, 48, 30), (3, 64, 4), (64, 256, 50), (5, 1500, 9)])
def test_ngram_kernel_vs_plain(dev, b, max_len, vocab):
    rng = np.random.RandomState(b + max_len)
    ref = rng.randint(1, vocab, (b, max_len)).astype(np.int32)
    hyp = rng.randint(1, vocab, (b, max_len)).astype(np.int32)
    lr = rng.randint(0, max_len + 1, b).astype(np.int32)
    lh = rng.randint(0, max_len + 1, b).astype(np.int32)
    lh[0] = 0
    ins = [torch.from_numpy(x).to(dev) for x in (ref, hyp, lr, lh)]
    got = ng.ngram_bleu(*ins).double()
    want = ngram_bleu_ref(*ins)
    assert got[0].item() == 0.0
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_ft_engine_cuda_equals_cpu(dev):
    from repro_torch.launch import serve

    argv = ["--docs", "90", "--batch-size", "32", "--variant", "ft"]
    assert serve.main(argv + ["--device", "cuda"]) == \
        serve.main(argv + ["--device", "cpu"])


FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _fa_inputs(dev, b, sq, skv, h, hk, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, sq, h, d), (b, skv, hk, d), (b, skv, hk, d))]


def _fa_check(q, k, v, causal, window):
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.KERNEL.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = FA_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)])
@pytest.mark.parametrize("b,sq,skv,h,hk,d", [
    (2, 64, 64, 4, 2, 16),
    (1, 48, 80, 4, 4, 32),      # Sq != Skv
    (2, 96, 96, 8, 1, 8),       # MQA
    (1, 100, 100, 2, 2, 64),    # ragged edge
])
def test_flash_kernel_vs_plain(dev, b, sq, skv, h, hk, d, causal, window,
                               dtype):
    _fa_check(*_fa_inputs(dev, b, sq, skv, h, hk, d, dtype), causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("d", [120, 128])
def test_flash_kernel_lm_head_dims(dev, d, window, dtype):
    _fa_check(*_fa_inputs(dev, 2, 1024, 1024, 8, 2, d, dtype, seed=d),
              True, window)


def test_flash_kernel_fully_masked_tile(dev):
    """Window 8 over 200 keys: late query rows meet 64-key tiles in
    which every key is masked for them."""
    _fa_check(*_fa_inputs(dev, 1, 200, 200, 4, 2, 16, torch.float32), True, 8)


def test_flash_kernel_reads_strided_inputs(dev):
    """q, k and v as views into one fused (B, S, H + 2 Hk, D) tensor."""
    qkv = _fa_inputs(dev, 2, 130, 130, 8, 8, 64, torch.bfloat16)[0]
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    _fa_check(q, k, v, True, None)


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _fa_inputs(dev, 1, 16, 16, 2, 2, 264, torch.float32)
    with pytest.raises(ValueError, match="head dim 264"):
        fa.flash_attention(q, k, v)
    q, k, v = _fa_inputs(dev, 1, 16, 16, 2, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3),
                           v.transpose(2, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-3-4b"])
def test_small_lm_cuda_matches_cpu(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch).reduced().model,
                              attention_impl="pallas")
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = {k: ({n: t.to(dev) for n, t in v.items()} if k == "layers"
               else v.to(dev)) for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(1))
    before = fa.KERNEL.launches
    lg_c, cache_c = T.prefill(gpu, cfg, toks.to(dev))
    assert fa.KERNEL.launches == before + cfg.n_layers
    lg_h, cache_h = T.prefill(params, cfg, toks)
    torch.testing.assert_close(lg_c.cpu(), lg_h, atol=2e-5, rtol=0)
    pad = (0, 0, 0, 0, 0, 1)
    cache_c = type(cache_c)(*(torch.nn.functional.pad(t, pad) for t in cache_c))
    cache_h = type(cache_h)(*(torch.nn.functional.pad(t, pad) for t in cache_h))
    nxt = lg_h.argmax(-1, keepdim=True)
    d_c, _ = T.decode_step(gpu, cfg, nxt.to(dev), cache_c, 100)
    d_h, _ = T.decode_step(params, cfg, nxt, cache_h, 100)
    torch.testing.assert_close(d_c.cpu(), d_h, atol=2e-5, rtol=0)
