"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, over small shape sweeps and edge cases, plus the
ft engine on cuda against cpu. Marked ``cuda``: every test skips on a
host without a card (the decision is taken in the fixture, at run
time). Run on the card with ``python -m pytest -m cuda tests``.

Tolerances: fast_features tokens/mask exact and features within 1e-6
(the JAX kernel's bar; the float64 assembly makes them bit-equal in
practice); budget_route exact; ngram_score float32 kernel against the
float64 plain version within atol 1e-6, rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.budget_route import ops as br
from repro_torch.kernels.budget_route.ref import budget_route_ref
from repro_torch.kernels.fast_features import ops as ff
from repro_torch.kernels.fast_features.ref import fast_features_ref
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
