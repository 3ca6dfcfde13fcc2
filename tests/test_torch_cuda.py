"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, over small shape sweeps and edge cases, plus the
ft engine on cuda against cpu, the reduced LMs and DLRM on cuda against
cpu. Marked ``cuda``: every test skips on a host without a card (the
decision is taken in the fixture, at run time). Run on the card with
``python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: fast_features tokens/mask exact and features within 1e-6
(the JAX kernel's bar; the float64 assembly makes them bit-equal in
practice, which the edge cases hold); budget_route exact; ngram_score float32 kernel against the
float64 plain version within atol 1e-6, rtol 1e-5; flash_attention
within 2e-5 in float32 and 2e-2 in bfloat16, atol and rtol (the JAX
kernel's bar, tests/test_kernels.py), and the reduced LMs on cuda
against cpu within 2e-5; embedding_bag within 2e-5 in float32 and 2e-2
in bfloat16 (the JAX kernel's bar) and bit-equal for bags of one;
segment_mm within rtol = atol = 1e-5 (the JAX kernel's bar) and
bit-identical across runs; the reduced DLRM on cuda against cpu within
2e-5; one router-tiny SFT or DPO step on cuda against cpu, the loss
within rtol 1e-5 and the params within 1e-5 (AdamW's first step moves
each element by about lr, whatever its grad; a grad near eps is where
the devices' rounding shows), and two cuda trainings bit-equal; the
reduced f32 LM's training (5 steps, through ``xla_flash`` and its
backward) on cuda against cpu, losses within rtol 1e-5 and params within
1e-4 (the router training's bar), two cuda runs and the train CLI's
restart bit-equal, a cuda checkpoint restored on the cpu bit for bit,
and Adafactor and gradient compression on cuda against cpu within 1e-6
over 20 steps; the reduced f32 MoE LMs (olmoe-tiny, grok-tiny) on cuda
against cpu within 2e-5 with equal routing, their training with the
configs' own optimizers (losses within 2e-5, params within 1e-4, two
cuda runs bit-equal), and a bf16 MoE layer's forward and backward
bit-equal across two cuda runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.budget_route import ops as br
from repro_torch.kernels.budget_route.ref import budget_route_ref
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.fast_features import ops as ff
from repro_torch.kernels.fast_features.ref import fast_features_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ngram_score import ops as ng
from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref
from repro_torch.kernels.segment_mm import ops as sm
from repro_torch.kernels.segment_mm.ref import segment_matmul_ref

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


def _route_case(dev, n, d, case):
    """Scores and tokens of one budget_route case: scores on a 1/3 grid
    (many ties at tau); "ties" all equal but one; "nonfinite" NaNs of
    both signs and infinities; "few_positive" three positive scores, so
    the positive clamp leaves count below capacity; "misaligned" views
    whose base pointers are not 16-byte aligned (tokens offset by a row
    when D is odd, by one element otherwise; scores by one element)."""
    g = torch.Generator(device=dev).manual_seed(n)
    scores = torch.round(torch.randn(n + 1, generator=g, device=dev) * 3) / 3
    scores = scores[1:] if case == "misaligned" else scores[:n]
    if case == "ties" and n:
        scores = torch.full((n,), 0.5, device=dev)
        scores[n // 2] = 1.0
    elif case == "nonfinite":
        scores[::7] = float("nan")
        scores[3::11] = float("-inf")
        scores[5::13] = float("inf")
        scores.view(torch.int32)[1::17] = -4194304         # 0xFFC00000
    elif case == "few_positive":
        scores = -scores.abs() - 1
        scores[::n // 3 + 1] = 2.0
    tokens = torch.randint(0, 1 << 30, (n + 1, d), generator=g,
                           dtype=torch.int32, device=dev)
    if case != "misaligned":
        tokens = tokens[:n]
    elif d % 4:
        tokens = tokens[1:]
    else:
        tokens = tokens.flatten()[1:n * d + 1].view(n, d)
    return scores, tokens


# (N, D, alpha, case): the main path's shape and route_64k's rows; one
# row; both sides of one block of 1024 threads and of the single-block
# limit (4096 rows); an N that gives each block of the grid several
# chunks on an H100 (more than 132 SMs x 512 rows); the cases
# of _route_case. N = 0 routes into a capacity of 3 with tau 0.5.
ROUTE_CASES = [
    (3, 4, 2 / 3, "grid"), (80, 4, 0.1, "grid"), (256, 512, 0.05, "grid"),
    (1500, 7, 0.2, "grid"), (5000, 16, 0.5, "grid"), (65536, 8, 0.05, "grid"),
    (1, 4, 1.0, "grid"), (1023, 8, 0.05, "grid"), (1024, 8, 0.3, "grid"),
    (1025, 8, 0.05, "grid"), (br.SINGLE_BLOCK_ROWS, 12, 0.5, "grid"),
    (br.SINGLE_BLOCK_ROWS + 1, 8, 0.05, "grid"), (1 << 20, 4, 0.05, "grid"),
    (256, 512, 0.05, "few_positive"), (4097, 12, 0.5, "few_positive"),
    (65536, 8, 0.05, "few_positive"),
    (300, 7, 0.1, "misaligned"), (1025, 8, 0.1, "misaligned"),
    (5000, 7, 0.1, "misaligned"),
    (1024, 8, 0.1, "ties"), (70000, 4, 0.05, "ties"),
    (256, 8, 0.3, "nonfinite"), (4097, 8, 0.1, "nonfinite"),
    (65536, 8, 0.05, "nonfinite"), (0, 4, 0.0, "grid"),
]


@pytest.mark.parametrize("n,d,alpha,case", ROUTE_CASES)
def test_budget_route_kernel_vs_plain(dev, n, d, alpha, case):
    """Bit-exact against the plain version, through the wrapper and
    through one launch into outputs filled with garbage (the kernel
    writes every element, the zero rows and the -1 tail included)."""
    scores, tokens = _route_case(dev, n, d, case)
    if n:
        cap = br.capacity_floor(alpha, n)
        tau = br.route_tau(scores, cap)
    else:
        cap, tau = 3, torch.tensor([0.5], device=dev)
    want = budget_route_ref(scores, tokens, tau[0], capacity=cap)
    got = br.budget_route_kernel(scores, tokens, tau, capacity=cap)
    assert torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[0], want[0])
    out = torch.full((cap, d), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    idx = torch.full((cap,), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    count = torch.full((1,), -7, dtype=torch.int32, device=dev)
    plan = br.launch_plan(n, br.sm_count(dev))
    scratch = torch.full((br.scratch_ints(plan[0]),), 0x5A5A5A5A,
                         dtype=torch.int32, device=dev)
    before = br.KERNEL.launches
    br._launch(scores, tokens, tau, out, idx, count, capacity=cap,
               scratch=scratch)
    assert br.KERNEL.launches == before + 1
    assert torch.equal(idx, want[1]) and int(count) == int(want[2])
    assert torch.equal(out, want[0])
    if case == "few_positive":
        assert 0 < int(want[2]) < cap
    if n:
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


# (B, L, vocab, max_n, ref lengths, hyp lengths): every token equal (the
# longest matches and the most clipping), an L that is not a multiple of
# 32 with lengths 0, 1 and L, every order from 1 to 8, and an L at the
# wrapper's limit (the shared-memory attribute path)
NGRAM_EDGES = (
    [(3, 256, 1, n, [256, 255, 100], [256, 100, 255]) for n in (4, 8)]
    + [(6, 300, 5, 4, [0, 1, 300, 299, 31, 33], [300, 0, 1, 300, 33, 31])]
    + [(4, 100, 4, n, [100, 99, 7, 64], [100, 64, 99, 8])
       for n in range(1, 9)]
    + [(2, ng.MAX_LEN, 50, 4, [ng.MAX_LEN, ng.MAX_LEN - 7],
        [ng.MAX_LEN - 3, ng.MAX_LEN])])


@pytest.mark.parametrize("b,max_len,vocab,max_n,lr,lh", NGRAM_EDGES)
def test_ngram_kernel_edge_cases(dev, b, max_len, vocab, max_n, lr, lh):
    """Padding past each length is -1 and must never count."""
    rng = np.random.RandomState(max_len + vocab + max_n)
    ref = rng.randint(0, vocab, (b, max_len)).astype(np.int32) + 7
    hyp = rng.randint(0, vocab, (b, max_len)).astype(np.int32) + 7
    lr, lh = np.array(lr, np.int32), np.array(lh, np.int32)
    pos = np.arange(max_len)
    ref[pos[None] >= lr[:, None]] = -1
    hyp[pos[None] >= lh[:, None]] = -1
    ins = [torch.from_numpy(x).to(dev) for x in (ref, hyp, lr, lh)]
    before = ng.KERNEL.launches
    got = ng.ngram_bleu(*ins, max_n=max_n).double()
    assert ng.KERNEL.launches == before + 1
    want = ngram_bleu_ref(*ins, max_n=max_n)
    assert bool((got[ins[3] == 0] == 0).all())
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_ngram_kernel_refuses_past_its_shared_memory(dev):
    z = torch.zeros((1, ng.MAX_LEN + 1), dtype=torch.int32, device=dev)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ng.ngram_bleu(z, z, n, n)


# (n, width, max_len, tokens, n_tok): one repeated token in every slot
# (every lane of a warp on one bitmap word), only ids 0 and vocab - 1,
# widths 128 and 4096, n_tok 0, one document
FF_EDGES = [(4, 4096, 512, "ws", [4096, 4095, 1, 0]),
            (3, 4096, 512, "ends", [4096, 3000, 17]),
            (5, 128, 0, "any", [0, 1, 127, 128, 64]),
            (3, 128, 128, "any", [128, 5, 0]),
            (1, 4096, 512, "any", [3333])]


@pytest.mark.parametrize("n,width,max_len,choice,nt", FF_EDGES)
def test_fast_features_kernel_edge_cases(dev, n, width, max_len, choice,
                                         nt):
    """Slots past n_tok hold -1, which must never count."""
    vocab = 10000
    rng = np.random.RandomState(width + n)
    if choice == "ws":
        tok = np.full((n, width), 2, np.int32)
    elif choice == "ends":
        tok = rng.choice([0, vocab - 1], (n, width)).astype(np.int32)
    else:
        tok = rng.randint(0, vocab, (n, width)).astype(np.int32)
    nt = np.array(nt, np.int32)
    tok[np.arange(width)[None] >= nt[:, None]] = -1
    first = np.array([rng.randint(0, t + 1) for t in nt], np.int32)
    pages = rng.randint(0, 9, n).astype(np.int32)
    empty = np.array([rng.randint(0, p + 1) for p in pages], np.int32)
    ins = [torch.from_numpy(x).to(dev) for x in (tok, nt, first, pages,
                                                 empty)]
    kw = dict(max_len=max_len, ws=2, scramble=3, mangled=4, latex_lo=8010,
              ident_lo=8510, vocab_size=vocab)
    got = ff.fast_features(*ins, **kw)
    want = fast_features_ref(*ins, **kw)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    if max_len:
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("vocab", [ff.MAX_VOCAB, 33])
def test_fast_features_kernel_vocab_range(dev, vocab):
    """The largest bitmap the wrapper accepts launches; ids at both ends
    of a vocabulary count, one past it raises."""
    rng = np.random.RandomState(vocab % 1000)
    tok = rng.choice([0, vocab - 1, vocab // 2], (2, 256)).astype(np.int32)
    ins = [torch.from_numpy(x).to(dev) for x in (
        tok, np.array([256, 200], np.int32), np.array([3, 0], np.int32),
        np.array([2, 1], np.int32), np.array([1, 0], np.int32))]
    kw = dict(max_len=0, ws=2, scramble=3, mangled=4, latex_lo=8010,
              ident_lo=8510, vocab_size=vocab)
    got = ff.fast_features(*ins, **kw)[0]
    assert (got - fast_features_ref(*ins, **kw)[0]).abs().max() <= 1e-6
    assert got[0, 5].item() == pytest.approx(3 / 256)
    ins[0][1, 7] = vocab
    with pytest.raises(ValueError, match="vocab"):
        ff.fast_features(*ins, **kw)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 192, 256])
def test_flash_kernel_padded_head_dims(dev, d, dtype):
    """Head dims that the tensor-core body pads to 128, 192 and 256."""
    _fa_check(*_fa_inputs(dev, 1, 300, 300, 4, 2, d, dtype, seed=d), True,
              None)


def test_flash_kernel_ragged_key_tile_bf16(dev):
    """S = 200 is not a multiple of the 64-key tile: the last tile's keys
    past Skv are zero-filled and masked."""
    _fa_check(*_fa_inputs(dev, 2, 200, 200, 4, 1, 128, torch.bfloat16,
                          seed=7), True, None)
    _fa_check(*_fa_inputs(dev, 1, 136, 200, 4, 4, 64, torch.bfloat16,
                          seed=8), False, None)


def test_flash_kernel_bf16_keeps_p_at_float32_precision(dev):
    """p split into bf16 hi and lo halves for P V keeps the output within
    its own bf16 rounding: max abs error <= 4e-3, where rounding p once
    to bf16 gives ~8e-3."""
    q, k, v = _fa_inputs(dev, 2, 1024, 1024, 8, 2, 128, torch.bfloat16,
                         seed=3)
    got = fa.flash_attention(q, k, v, causal=True).float()
    want = flash_attention_ref(q, k, v, causal=True).float()
    assert (got - want).abs().max().item() <= 4e-3


def test_flash_kernel_reads_unaligned_views(dev):
    """Rows that are not 16-byte aligned (head stride 36 bf16) take the
    element-by-element load path."""
    qkv = _fa_inputs(dev, 2, 70, 70, 12, 12, 36, torch.bfloat16, seed=9)[0]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _fa_check(q, k, v, True, 40)


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


# ------------------------------------------------------------ embedding_bag

EB_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _eb_check(table, ids, w, comb, exact=False):
    before = eb.KERNEL.launches
    got = eb.embedding_bag(table, ids, w, combiner=comb)
    assert eb.KERNEL.launches == before + 1
    ones = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    want = embedding_bag_ref(table, ids, ones if w is None else w,
                             combiner=comb)
    assert got.dtype == table.dtype and got.shape == want.shape
    if exact:
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    else:
        tol = EB_TOL[table.dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, equal_nan=True)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d,b,bag,comb", [
    (500, 16, 32, 8, "sum"), (1000, 8, 50, 5, "mean"), (64, 4, 7, 3, "sum"),
    (100000, 64, 4096, 16, "mean"), (300, 6, 9, 4, "sum")])
def test_embedding_bag_kernel_vs_plain(dev, r, d, b, bag, comb, dtype,
                                       id_dtype, weighted):
    g = torch.Generator(device=dev).manual_seed(r + bag)
    table = torch.randn((r, d), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, r, (b, bag), generator=g, device=dev).to(id_dtype)
    w = torch.rand((b, bag), generator=g, device=dev) if weighted else None
    _eb_check(table, ids, w, comb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 100, 6, 3])
def test_embedding_bag_kernel_bags_of_one_equal_the_gather(dev, d, dtype):
    """lookup_fields' call: bit-equal to table[ids], on the 16-byte path
    and on the scalar one."""
    g = torch.Generator(device=dev).manual_seed(d)
    table = torch.randn((5000, d), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, 5000, (3000, 1), generator=g, device=dev,
                        dtype=torch.int32)
    got = eb.embedding_bag(table, ids)
    assert torch.equal(got, table[ids[:, 0].long()])
    _eb_check(table, ids, None, "sum", exact=True)


def test_embedding_bag_kernel_out_of_range_ids_follow_jnp_take(dev):
    """A NaN bag for ids >= R or < -R, a wrap for -R <= id < 0, exactly
    as the plain version."""
    table = torch.randn((5, 4), device=dev)
    ids = torch.tensor([[0, 7], [0, -1], [-6, 1], [2, 3], [-5, 4]],
                       device=dev)
    got = eb.embedding_bag(table, ids)
    assert got[0].isnan().all() and got[2].isnan().all()
    assert torch.equal(got[1], table[0] + table[4])
    for comb in ("sum", "mean"):
        _eb_check(table, ids, None, comb, exact=True)


def test_embedding_bag_kernel_mean_guards_zero_weights(dev):
    table = torch.randn((10, 8), device=dev)
    ids = torch.tensor([[1, 2], [3, 4]], device=dev)
    w = torch.tensor([[0.0, 0.0], [0.5, 1.5]], device=dev)
    got = eb.embedding_bag(table, ids, w, combiner="mean")
    assert torch.equal(got[0], torch.zeros(8, device=dev))
    _eb_check(table, ids, w, "mean")


def test_embedding_bag_kernel_offsets_past_2_31(dev):
    """Rows past 2^31 elements, in a table and in a strided view of it."""
    rows = 2 ** 31 // 128 + 2048
    table = torch.zeros((rows, 128), dtype=torch.bfloat16, device=dev)
    tail = torch.arange(rows - 4096, rows, device=dev)
    table[tail] = torch.randn((4096, 128), device=dev).to(torch.bfloat16)
    ids = tail[torch.randperm(4096, device=dev)].view(-1, 2)
    got = eb.embedding_bag(table, ids)
    want = (table[ids[:, 0]].float() + table[ids[:, 1]].float()) \
        .to(torch.bfloat16)
    assert torch.equal(got, want)
    view = table[:, 32:96]                      # row stride 128, width 64
    got_v = eb.embedding_bag(view, ids[:, :1].contiguous())
    assert torch.equal(got_v, view[ids[:, 0]])
    del table, view


def test_embedding_bag_refuses_what_the_kernel_does_not_take(dev):
    table = torch.randn((10, 8), device=dev)
    ids = torch.zeros((3, 2), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="one device"):
        eb.embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="rows must be contiguous"):
        eb.embedding_bag(table.t(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        eb.embedding_bag(table, ids.t().contiguous().t())


# ------------------------------------------------------------ segment_mm


def _sm_inputs(dev, e, n, din, dout, seed, dst_dtype=torch.int64):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, din), generator=g, device=dev)
    w = torch.randn((din, dout), generator=g, device=dev) * din ** -0.5
    src = torch.randint(0, n, (e,), generator=g, device=dev)
    dst = torch.randint(0, n, (e,), generator=g, device=dev).to(dst_dtype)
    return x, src, dst, w


def _sm_check(xg, w, dst, n):
    before = sm.KERNEL.launches
    got = sm.segment_matmul_kernel(xg, w, dst, n_nodes=n)
    assert sm.KERNEL.launches == before + 1
    want = segment_matmul_ref(xg, w, dst, n_nodes=n)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("dst_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("e,n,din,dout", [
    (100, 20, 16, 8), (256, 64, 8, 8), (73, 10, 32, 16), (5000, 300, 100, 128),
    (3000, 50, 7, 200), (0, 5, 4, 4), (40, 1000, 3, 5)])
def test_segment_mm_kernel_vs_plain(dev, e, n, din, dout, dst_dtype):
    x, src, dst, w = _sm_inputs(dev, e, n, din, dout, e + n, dst_dtype)
    order = torch.argsort(dst, stable=True)
    if e:
        _sm_check(x[src[order]], w, dst[order], n)
    got = sm.segment_matmul(x, src, dst, w, n_nodes=n)
    want = sm.segment_matmul(x.cpu(), src.cpu(), dst.cpu(), w.cpu(),
                             n_nodes=n)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_segment_mm_kernel_drops_out_of_range_and_zeroes_empty_rows(dev):
    xg = torch.ones((8, 1), device=dev)
    w = torch.ones((1, 1), device=dev)
    dst = torch.tensor([-3, -1, 0, 2, 2, 2, 5, 9], device=dev)
    got = _sm_check(xg, w, dst, 4)
    assert got[:, 0].tolist() == [1.0, 0.0, 3.0, 0.0]
    # every row written, whatever the buffer held before
    x, src, dst, w = _sm_inputs(dev, 2000, 700, 12, 33, 3)
    dst = torch.sort(dst // 3).values           # nodes 234..699 get no edge
    junk = torch.full((700, 33), float("nan"), device=dev)
    sm._launch(x[src], w, dst, junk, n_nodes=700)
    torch.testing.assert_close(
        junk, segment_matmul_ref(x[src], w, dst, n_nodes=700), rtol=1e-5,
        atol=1e-5)


def test_segment_mm_kernel_refuses_unsorted_dst(dev):
    xg, w = torch.ones((4, 3), device=dev), torch.ones((3, 2), device=dev)
    before = sm.KERNEL.launches
    with pytest.raises(ValueError, match="sorted ascending"):
        sm.segment_matmul_kernel(xg, w, torch.tensor([0, 2, 1, 3],
                                                     device=dev), n_nodes=4)
    with pytest.raises(ValueError, match="float32"):
        sm.segment_matmul_kernel(xg.double(), w.double(),
                                 torch.arange(4, device=dev), n_nodes=4)
    assert sm.KERNEL.launches == before


def test_segment_mm_kernel_hub_node(dev):
    """One node with 50,000 edges among 20,000 uniform ones: its block
    streams the hub's whole slab. The hub's rows are drawn with standard
    deviation 50,000^-0.5, so its sum is of the size of the other nodes'
    (unscaled N(0, 1) rows sum to ~3e3 there, and the cancelling output
    elements then need more digits than float32 holds at rtol = atol =
    1e-5, whatever the order of the sum; the float32 plain version, which
    adds the 50,000 messages one by one, was ~3.5e-2 off the float64
    result on them, and this kernel ~1e-3). The yardstick for the hub is
    the function in float64; the plain version for the other rows."""
    x, src, dst, w = _sm_inputs(dev, 20_000, 3000, 100, 128, 13)
    g = torch.Generator(device=dev).manual_seed(14)
    xg = torch.cat([x[src], torch.randn((50_000, 100), generator=g,
                                        device=dev) * 50_000 ** -0.5])
    dst = torch.cat([dst, torch.full((50_000,), 1234, device=dev)])
    order = torch.argsort(dst, stable=True)
    xg, ds = xg[order], dst[order]
    got = sm.segment_matmul_kernel(xg, w, ds, n_nodes=3000)
    exact = torch.zeros((3000, 128), dtype=torch.float64,
                        device=dev).index_add_(0, ds, xg.double() @ w.double())
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
    rest = torch.arange(3000, device=dev) != 1234
    torch.testing.assert_close(got[rest], segment_matmul_ref(
        xg, w, ds, n_nodes=3000)[rest], rtol=1e-5, atol=1e-5)
    assert torch.equal(got, sm.segment_matmul_kernel(xg, w, ds, n_nodes=3000))


def test_segment_mm_kernel_unscaled_hub_is_nearer_float64_than_plain(dev):
    """A hub of 50,000 unscaled N(0, 1) rows (sums ~3e3): against the
    function in float64, the kernel's two-level sum stays within 4e-3
    (about 1e-3 on the card, where the float32 plain version, which adds
    the messages one by one, is ~3.5e-2 off) and is nearer than the
    plain version."""
    x, src, dst, w = _sm_inputs(dev, 20_000, 3000, 100, 128, 13)
    g = torch.Generator(device=dev).manual_seed(14)
    src = torch.cat([src, torch.randint(0, 3000, (50_000,), generator=g,
                                        device=dev)])
    dst = torch.cat([dst, torch.full((50_000,), 1234, device=dev)])
    order = torch.argsort(dst, stable=True)
    xg, ds = x[src[order]], dst[order]
    exact = torch.zeros((3000, 128), dtype=torch.float64,
                        device=dev).index_add_(0, ds, xg.double() @ w.double())
    err_kernel = (sm.segment_matmul_kernel(xg, w, ds, n_nodes=3000).double()
                  - exact)[1234].abs().max().item()
    err_plain = (segment_matmul_ref(xg, w, ds, n_nodes=3000).double()
                 - exact)[1234].abs().max().item()
    print(f"unscaled hub, max abs error against float64: kernel "
          f"{err_kernel}, plain {err_plain}")
    assert err_kernel <= 4e-3, (err_kernel, err_plain)
    assert err_kernel <= err_plain, (err_kernel, err_plain)


def test_segment_mm_kernel_is_deterministic(dev):
    x, src, dst, w = _sm_inputs(dev, 400_000, 9000, 100, 128, 11)
    order = torch.argsort(dst, stable=True)
    xg, ds = x[src[order]], dst[order]
    a = _sm_check(xg, w, ds, 9000)
    b = sm.segment_matmul_kernel(xg, w, ds, n_nodes=9000)
    assert torch.equal(a, b)


def test_segment_mm_kernel_offsets_past_2_31(dev):
    """E * D_in > 2^31: the last 4096 edges' rows sit past 2^31
    elements, one edge to each of nodes 1..4096; the zero rows before
    them all go to node 0."""
    e = 2 ** 31 // 100 + 4096
    xg = torch.zeros((e, 100), device=dev)
    xg[-4096:] = torch.randn((4096, 100), device=dev)
    w = torch.randn((100, 8), device=dev) * 0.1
    dst = torch.zeros(e, dtype=torch.int64, device=dev)
    dst[-4096:] = torch.arange(1, 4097, device=dev)
    got = sm.segment_matmul_kernel(xg, w, dst, n_nodes=4097)
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got[1:], xg[-4096:] @ w, rtol=1e-5, atol=1e-5)
    del xg


# ------------------------------------------------------------ dispatch


def test_cpu_tensors_never_reach_the_kernels_nor_cuda_the_plain(dev,
                                                                monkeypatch):
    before = (eb.KERNEL.launches, sm.KERNEL.launches)
    table = torch.randn((50, 8))
    ids = torch.randint(0, 50, (6, 3))
    eb.embedding_bag(table, ids)
    xg, w = torch.randn((10, 4)), torch.randn((4, 3))
    sm.segment_matmul_kernel(xg, w, torch.arange(10) // 2, n_nodes=5)
    assert (eb.KERNEL.launches, sm.KERNEL.launches) == before

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(eb, "embedding_bag_ref", boom)
    monkeypatch.setattr(sm, "segment_matmul_ref", boom)
    eb.embedding_bag(table.to(dev), ids.to(dev))
    sm.segment_matmul_kernel(xg.to(dev), w.to(dev),
                             (torch.arange(10) // 2).to(dev), n_nodes=5)
    assert (eb.KERNEL.launches, sm.KERNEL.launches) == (before[0] + 1,
                                                        before[1] + 1)


def test_small_dlrm_cuda_matches_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import _recsys_batch
    from repro_torch.models.recsys import models as M

    cfg = get_config("dlrm-mlperf").reduced().model
    host = M.init_recsys(cfg, torch.Generator().manual_seed(0), "cpu")
    card = {k: (v.to(dev) if k == "table" else
                [{n: t.to(dev) for n, t in layer.items()} for layer in v])
            for k, v in host.items()}
    batch = _recsys_batch(cfg, 300, 1, device="cpu")
    before = eb.KERNEL.launches
    got = M.recsys_scores(card, cfg, {k: v.to(dev) for k, v in batch.items()})
    assert eb.KERNEL.launches == before + 1
    want = M.recsys_scores(host, cfg, batch)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def _tiny_router_start():
    """router-tiny (f32) from one exported init, with seeded regression
    data and preference pairs on the host."""
    from repro_torch.configs import get_config
    from repro_torch.models import encoder as E

    cfg = get_config("adaparse-router").reduced().model
    raw = E.encoder_to_jax_params(
        E.init_encoder(cfg, torch.Generator().manual_seed(0), "cpu"))
    r = np.random.RandomState(0)
    n, s = 24, cfg.max_len
    toks = r.randint(2, 8000, (3, n, s)).astype(np.int32)
    lens = r.randint(1, s + 1, (3, n))
    mask = (np.arange(s) < lens[..., None]).astype(np.float32)
    reg = {"tokens": toks[0], "mask": mask[0],
           "targets": r.rand(n, cfg.n_outputs).astype(np.float32)}
    pref = {"tok_pos": toks[1], "mask_pos": mask[1], "tok_neg": toks[2],
            "mask_neg": mask[2]}
    return cfg, raw, reg, pref


@pytest.mark.parametrize("stage", ["sft", "dpo"])
def test_tiny_router_training_step_cuda_matches_cpu(dev, stage):
    """One SFT and one DPO step of router-tiny from the same init: the
    loss within rtol 1e-5 and every param within 1e-5 (TF32 is off)."""
    from repro_torch.core import dpo
    from repro_torch.models import encoder as E

    cfg, raw, reg, pref = _tiny_router_start()
    out = {}
    for d in (dev, torch.device("cpu")):
        enc = E.encoder_from_jax_params(raw, cfg, d)
        res = (dpo.fit_regression(enc, reg, steps=1) if stage == "sft"
               else dpo.fit_dpo(enc, pref, steps=1))
        out[d.type] = (res.losses, E.encoder_to_jax_params(res.encoder))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, a in out["cuda"][1].items():
        b = out["cpu"][1][name]
        for x, y in (zip(a.values(), b.values()) if name == "layers"
                     else [(a, b)]):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0,
                                       err_msg=name)


def test_tiny_router_training_is_bit_reproducible_on_cuda(dev):
    """Two trainings on the card from one init give the same bits (the
    embedding gradient sums repeated ids in a fixed order)."""
    from repro_torch.core import dpo
    from repro_torch.models import encoder as E

    cfg, raw, reg, pref = _tiny_router_start()
    runs = []
    for _ in range(2):
        enc = E.encoder_from_jax_params(raw, cfg, dev)
        enc, diag = dpo.three_stage_posttrain(enc, reg, pref, sft_steps=20,
                                              dpo_steps=10, refit_steps=10)
        runs.append((diag, [p.detach().clone() for p in enc.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# -- the campaign layer: several simulated nodes on one card --------------

CAMPAIGN_QUALITY_TOL = 1e-6     # the float32 BLEU kernel against float64


def _campaign_corpus():
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus

    ccfg = CorpusConfig(n_docs=150, seed=0)
    return ccfg, generate_corpus(ccfg)


def _same_records(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].parser, a[k].cost_s) == (b[k].parser, b[k].cost_s)
        assert all(np.array_equal(p, q)
                   for p, q in zip(a[k].pages, b[k].pages))


def test_ft_controller_cuda_equals_cpu(dev, tmp_path):
    """A 4-node pooled, prefetched, straggling, speed-skewed ft controller
    with α retuning: records, simulated clocks, weights and α decisions
    on the card equal the CPU's; the card's store replays on the CPU,
    every batch a hit."""
    from repro_torch.core import engine as TE
    from repro_torch.core.backends import DiskResultStore
    from repro_torch.core.campaign import (CampaignController,
                                           ControllerConfig, ExecutorConfig)
    from repro_torch.core.quality import QualityProbeConfig
    from repro_torch.launch import serve

    ccfg, docs = _campaign_corpus()
    routers = {d: serve.build_ft_router(docs[:75], ccfg,
                                        np.random.RandomState(1), device=d)
               for d in ("cuda", "cpu")}
    assert TE._router_fingerprint(routers["cuda"]) == \
        TE._router_fingerprint(routers["cpu"])
    ecfg = TE.EngineConfig(alpha=0.1, batch_size=8)
    xcfg = ExecutorConfig(n_nodes=4, node_pools=["cpu", "cpu", "cpu", "gpu"],
                          prefetch_depth=2, straggler_rate=0.3,
                          node_speed_factors=[1.0, 1.0, 3.0, 1.0])

    def ctl(trace=None):
        return ControllerConfig(rounds=3, alpha_bounds=(0.02, 0.3),
                                alpha_step=0.05, telemetry_trace=trace,
                                probe=QualityProbeConfig(probe_rate=1.0,
                                                         max_len=128))

    res = {d: CampaignController(ecfg, xcfg, ctl(), routers[d], ccfg,
                                 device=d).run(
        docs[75:], cache=DiskResultStore(tmp_path / d))
        for d in ("cuda", "cpu")}
    c, h = res["cuda"], res["cpu"]
    _same_records(c.records, h.records)
    for f in ("wall_s", "docs_per_s", "node_busy_frac", "reissued",
              "cache_misses", "node_alphas", "weight_history",
              "alpha_trajectory"):
        assert getattr(c, f) == getattr(h, f), f
    for tc_, th in zip(c.telemetry, h.telemetry):
        assert (tc_.throughput, tc_.decision) == (th.throughput, th.decision)
        for p in th.quality:
            assert abs(tc_.quality[p] - th.quality[p]) <= \
                CAMPAIGN_QUALITY_TOL
    replay = CampaignController(ecfg, xcfg, ctl(c.telemetry),
                                routers["cpu"], ccfg, device="cpu").run(
        docs[75:], cache=DiskResultStore(tmp_path / "cuda"))
    assert replay.cache_misses == 0 and replay.cache_hits == c.cache_misses
    _same_records(replay.records, c.records)


def test_tiny_llm_executor_cuda_equals_cpu(dev):
    """``router-tiny`` behind a 2-node executor on the card and on the
    CPU: the same records, a parser flip allowed only for documents
    within 1e-5 of tau (f32 sums in another order on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine as TE
    from repro_torch.core.campaign import CampaignExecutor, ExecutorConfig
    from repro_torch.core.router import AdaParseRouter, make_route_step
    from repro_torch.launch import serve
    from repro_torch.models.encoder import (encoder_from_jax_params,
                                            encoder_to_jax_params,
                                            init_encoder)

    ccfg, docs = _campaign_corpus()
    cfg = get_config("adaparse-router").reduced().model
    enc = init_encoder(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(2, 8000, (16, cfg.max_len),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pred = enc.predict_accuracies(toks)
    exp = int((pred[:, 1:] > pred[:, :1]).sum(0).argmax()) + 1
    ft = serve.build_ft_router(docs[:75], ccfg, np.random.RandomState(1),
                               device="cpu")
    encs = {"cpu": enc, "cuda": encoder_from_jax_params(
        encoder_to_jax_params(enc), cfg, "cuda")}
    ecfg = TE.EngineConfig(alpha=0.1, batch_size=16, seed=3)
    xcfg = ExecutorConfig(n_nodes=2, straggler_rate=0.0)
    res, routers = {}, {}
    for d in ("cuda", "cpu"):
        routers[d] = AdaParseRouter("llm", ft.cls1, None, enc_cfg=cfg,
                                    encoder=encs[d], expensive_idx=exp)
        res[d] = CampaignExecutor(ecfg, xcfg, routers[d], ccfg,
                                  device=d).run(docs[75:])
    c, h = res["cuda"], res["cpu"]
    assert c.node_alphas == h.node_alphas
    step = make_route_step(0.1, expensive_idx=exp)
    eng = TE.AdaParseEngine(ecfg, routers["cpu"], ccfg, device="cpu")
    test = docs[75:]
    for b in range(-(-len(test) // 16)):
        batch = test[b * 16:(b + 1) * 16]
        flipped = [i for i, d in enumerate(batch)
                   if c.records[d.doc_id].parser != h.records[d.doc_id].parser]
        if not flipped:
            _same_records({d.doc_id: c.records[d.doc_id] for d in batch},
                          {d.doc_id: h.records[d.doc_id] for d in batch})
            continue
        prep = eng.prepare_batch(batch, batch_key=b)
        imp = step(routers["cpu"].encoder, prep.route_host["tokens"],
                   prep.route_host["mask"],
                   torch.from_numpy(prep.route_host["valid_logit"])
                   )["improvement"].numpy()
        tau = max(float(np.sort(imp)[::-1][br.capacity_floor(0.1, len(imp))
                                          - 1]), br.POSITIVE_TAU)
        assert all(abs(imp[i] - tau) <= 1e-5 for i in flipped), flipped


@pytest.mark.parametrize("runtime", ["process", "fabric"])
def test_worker_fleet_campaign_cuda_equals_cpu(dev, runtime):
    """A 2-worker campaign over real worker processes (``process``, shm
    transport) and over loopback TCP workers (``fabric``) on the card:
    the records equal the same fleet's on the CPU, and each worker, with
    its own CUDA context, launched fast_features itself (counts read
    from the workers' metric snapshots, not this process's counters)."""
    from repro_torch.core import engine as TE
    from repro_torch.core.campaign import CampaignExecutor, ExecutorConfig
    from repro_torch.launch import serve

    ccfg, docs = _campaign_corpus()
    router = serve.build_ft_router(docs[:75], ccfg,
                                   np.random.RandomState(1), device="cpu")
    ecfg = TE.EngineConfig(alpha=0.1, batch_size=16)
    xcfg = ExecutorConfig(n_nodes=2, runtime=runtime, obs=True)
    res = {d: CampaignExecutor(ecfg, xcfg, router, ccfg, device=d).run(
        docs[75:]) for d in ("cuda", "cpu")}
    _same_records(res["cuda"].records, res["cpu"].records)
    for d, want_launches in (("cuda", True), ("cpu", False)):
        g = res[d].obs_metrics["gauges"]
        for w in (0, 1):
            n = g[f"kernel.launches.fast_features.n{w}"]
            assert (n > 0) == want_launches, (d, w, n)
        assert ("worker.peak_bytes.n0" in g) == want_launches


# -- autotune knobs and the scenario lab on the card ------------------------


def _knob_cases(dev):
    """(name, candidates, default, make) a kernel each: make(c) -> (one
    launch at knob value c into fresh outputs, the outputs)."""
    from repro_torch.kernels.budget_route import autotune as bra
    from repro_torch.kernels.fast_features import autotune as ffa
    from repro_torch.kernels.ngram_score import autotune as nga

    packed = ff.pack_routing_batch(_pages(300, 7), max_len=512)
    f_in = [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in (
        packed.tok_matrix, packed.n_tok, packed.first_len, packed.n_pages,
        packed.n_empty)]
    n = len(packed.n_tok)
    kw = dict(max_len=512, ws=2, scramble=3, mangled=4, latex_lo=8010,
              ident_lo=8510, vocab_size=10000, bos=1)

    def ff_make(c):
        outs = [torch.full((n, 8), -7.0, device=dev),
                torch.full((n, 512), -7, dtype=torch.int32, device=dev),
                torch.full((n, 512), -7.0, device=dev)]
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        return (lambda: ff._launch(*f_in, *outs, err, threads=c, **kw)), outs

    g = torch.Generator(device=dev).manual_seed(3)
    b, L = 200, 300
    n_in = [torch.randint(0, 40, (b, L), generator=g, dtype=torch.int32,
                          device=dev) for _ in range(2)]
    n_in += [torch.randint(0, L + 1, (b,), generator=g, dtype=torch.int32,
                           device=dev) for _ in range(2)]

    def ng_make(c):
        out = torch.full((b,), -7.0, device=dev)
        return (lambda: ng._launch(*n_in, out, max_n=4, threads=c)), [out]

    rn, d = 65536 + 999, 96
    scores = torch.round(torch.randn(rn, generator=g, device=dev) * 4) / 4
    tokens = torch.randint(0, 1000, (rn, d), generator=g, dtype=torch.int32,
                           device=dev)
    cap = br.capacity_floor(0.05, rn)
    tau = br.route_tau(scores, cap)

    def br_make(c):
        outs = [torch.full((cap, d), -7, dtype=torch.int32, device=dev),
                torch.full((cap,), -7, dtype=torch.int32, device=dev),
                torch.full((1,), -7, dtype=torch.int32, device=dev)]
        return (lambda: br._launch(scores, tokens, tau, *outs, capacity=cap,
                                   block_rows=c)), outs

    return {"fast_features": (ffa.DEFAULT_CANDIDATES, ffa.DEFAULT_THREADS,
                              ff_make),
            "ngram_score": (nga.DEFAULT_CANDIDATES, nga.DEFAULT_THREADS,
                            ng_make),
            "budget_route": (bra.DEFAULT_CANDIDATES, bra.DEFAULT_BLOCK_ROWS,
                             br_make)}


@pytest.mark.parametrize("name", ["fast_features", "ngram_score",
                                  "budget_route"])
def test_autotune_candidates_give_the_default_launchs_bits(dev, name):
    """Every candidate of a kernel's launch knob writes every output
    element, bit-equal to the default launch's (fast_features on 300
    documents at max_len 512, ngram_score on a dense small vocabulary
    with L = 300, budget_route on a cooperative grid of N = 66,535)."""
    cands, default, make = _knob_cases(dev)[name]
    launch, want = make(default)
    launch()
    torch.cuda.synchronize()
    for c in cands:
        launch, got = make(c)
        launch()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (name, c)


def test_tuning_dir_fleet_sweeps_cold_then_reads_warm_on_cuda(dev,
                                                              tmp_path):
    """A 2-worker process fleet over one tuning_dir on the card: the cold
    fleet sweeps fast_features (the workers' sweep counts sum above 0)
    and publishes a ``v1|fast_features|...|<card>|device`` key; a fresh
    fleet over the same directory sweeps 0 times and leaves the store's
    bytes as they were; both record sets equal the CPU fleet's."""
    from repro_torch.core import engine as TE
    from repro_torch.core.campaign import CampaignExecutor, ExecutorConfig
    from repro_torch.kernels import tuning_store
    from repro_torch.launch import serve

    ccfg, docs = _campaign_corpus()
    router = serve.build_ft_router(docs[:75], ccfg,
                                   np.random.RandomState(1), device="cpu")
    ecfg = TE.EngineConfig(alpha=0.1, batch_size=16)
    tdir = tmp_path / "tuning"
    xcfg = ExecutorConfig(n_nodes=2, runtime="process", obs=True,
                          tuning_dir=str(tdir))
    cpu = CampaignExecutor(ecfg, ExecutorConfig(n_nodes=2, runtime="process"),
                           router, ccfg, device="cpu").run(docs[75:])

    def files():
        return {p.name: p.read_bytes() for p in tdir.iterdir()
                if not p.name.startswith(".")}

    sweeps = []
    for _ in ("cold", "warm"):
        res = CampaignExecutor(ecfg, xcfg, router, ccfg,
                               device="cuda").run(docs[75:])
        _same_records(res.records, cpu.records)
        g = res.obs_metrics["gauges"]
        sweeps.append(sum(g[f"autotune.sweeps.n{w}"] for w in (0, 1)))
        if len(sweeps) == 1:
            cold_files = files()
    assert sweeps[0] > 0 and sweeps[1] == 0, sweeps
    assert files() == cold_files
    name = torch.cuda.get_device_name(0)
    keys = tuning_store.TuningStore(str(tdir)).keys()
    assert any(k.startswith("v1|fast_features|") and
               k.endswith(f"|{name}|device") for k in keys), keys


def test_elastic_join_leave_on_cuda_joiner_serves(dev):
    """The elastic fabric scenario on the card: the records equal the
    single-node engine's (inside ``run_scenario``), the crash re-issues,
    and the joiner, started mid-campaign, serves documents."""
    from repro_torch.core.scenarios import SCENARIOS, run_scenario

    res = run_scenario(SCENARIOS["elastic_join_leave"], device="cuda")
    assert res.records_match and res.reissued >= 1
    assert res.joiner_docs > 0


# -- LM training (ROADMAP 13c) ------------------------------------------

def _tiny_lm_train(dev, steps=5):
    """qwen3-tiny (f32, chunks 16/32, so xla_flash and its backward run)
    from one cpu init, ``steps`` of ``lm_train_step`` on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T

    arch = get_config("qwen3-1.7b").reduced()
    cfg = dataclasses.replace(arch.model, q_chunk=16, kv_chunk=32)
    init = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {k: ({n: t.to(dev, copy=True) for n, t in v.items()}
                  if k == "layers" else v.to(dev, copy=True))
              for k, v in init.items()}
    opt = S._optimizer_for(arch)[0]
    state = opt.init(S.lm_param_leaves(params))
    step_fn = S.lm_train_step(cfg, opt)
    losses = []
    for step in range(steps):
        batch = S._lm_train_batch(cfg, 4, 64, step + 1, dev)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return losses, [p.cpu() for p in S.lm_param_leaves(params)]


def test_tiny_lm_training_cuda_matches_cpu_and_repeats(dev):
    """Five steps: losses within rtol 1e-5 and params within 1e-4 of the
    cpu run; two cuda runs bit-equal."""
    lc, pc = _tiny_lm_train(dev)
    lh, ph = _tiny_lm_train("cpu")
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    for a, b in zip(pc, ph):
        assert (a - b).abs().max().item() <= 1e-4
    lc2, pc2 = _tiny_lm_train(dev)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2))


def test_xla_flash_gradients_cuda_match_cpu(dev):
    from repro_torch.models.attention import attention_xla_flash

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 70, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    ct = torch.randn(2, 70, 4, 16, generator=g)
    grads = []
    for d in (dev, "cpu"):
        leaves = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        out = attention_xla_flash(*leaves, causal=True, window=40,
                                  q_chunk=16, kv_chunk=32)
        grads.append([x.cpu() for x in torch.autograd.grad(
            (out * ct.to(d)).sum(), leaves)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_train_main_restart_is_bit_exact_on_cuda(dev, tmp_path):
    """``launch.train.main`` on cuda: 6 steps against 3, a checkpoint and
    a resume to 6, bit-equal; the cuda checkpoint restores on the cpu
    bit for bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train

    def main(*extra):
        return train.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                           "--reduced", "--log-every", "100", "--device",
                           "cuda", *extra])

    full = main("--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                "--ckpt-every", "100")
    assert main("--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "3") == full[:3]
    assert main("--steps", "6", "--ckpt-dir", str(tmp_path / "ck")) == \
        full[3:]
    a = ckpt._flatten(ckpt.restore(str(tmp_path / "full"), device="cuda")[1])
    for d, where in (("ck", "cuda"), ("ck", "cpu"), ("full", "cpu")):
        b = ckpt._flatten(ckpt.restore(str(tmp_path / d), device=where)[1])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert y.device.type == where and torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("what", ["adafactor", "int8", "topk"])
def test_adafactor_and_compression_cuda_match_cpu(dev, what):
    """20 steps on factored and unfactored leaves, within 1e-6."""
    from repro_torch import optim as O
    from repro_torch.optim import compression as C

    rng = np.random.RandomState(0)
    shapes = [(256, 512), (3, 128, 256), (1000,), (4, 300)]
    p0 = [(rng.randn(*sh) * 0.1).astype(np.float32) for sh in shapes]
    grads = [[rng.randn(*sh).astype(np.float32) for sh in shapes]
             for _ in range(20)]

    def run(d):
        p = [torch.tensor(a, device=d) for a in p0]
        if what == "adafactor":
            opt = O.adafactor(O.warmup_cosine(1e-2, 5, 20),
                              weight_decay=0.01)
            st = opt.init(p)
        else:
            st = C.init_compression_state(p)
        outs = []
        for step, g in enumerate(grads):
            g = [torch.tensor(x, device=d) for x in g]
            if what == "adafactor":
                u, st = opt.update(g, st, p, step)
                O.apply_updates(p, u)
                outs += [x.clone() for x in p]
            else:
                c, st, _ = C.compressed_gradients(g, st, scheme=what,
                                                  topk_ratio=0.05)
                outs += c + st
        return [x.cpu() for x in outs]

    for a, b in zip(run(dev), run("cpu")):
        assert (a - b).abs().max().item() <= 1e-6


# -- mixture-of-experts LMs (ROADMAP 13d) -------------------------------

def _tree_to(tree, d):
    return {k: _tree_to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
def test_tiny_moe_lm_cuda_matches_cpu(dev, arch):
    """olmoe-tiny and grok-tiny (f32, the flash kernel in prefill):
    prefill, 3 decode steps and ``lm_logits`` with its aux within 2e-5
    of the cpu; the routing of every layer equal."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    cfg = dataclasses.replace(get_config(arch).reduced().model,
                              attention_impl="pallas")
    host = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 90),
                         generator=torch.Generator().manual_seed(1))
    outs, traces = [], []
    for d, p in ((dev, _tree_to(host, dev)), ("cpu", host)):
        with M.routing_trace() as tr:
            full, aux = T.lm_logits(p, cfg, toks.to(d))
            lg, cache = T.prefill(p, cfg, toks[:, :-3].to(d))
        got = [full, aux, lg]
        cache = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 3)) for t in cache))
        for i in range(3):
            lg, cache = T.decode_step(p, cfg, toks[:, 87 + i:88 + i].to(d),
                                      cache, 87 + i)
            got.append(lg)
        outs.append([x.cpu() for x in got])
        traces.append([r["eids"].cpu() for r in tr])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(*traces))


def _tiny_moe_train(dev, arch, steps=5):
    """(losses, final leaves, each element's smallest nonzero |grad|
    over the steps), all on the cpu, and the sum over the steps of the
    largest |update| (the most one element moved)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T

    a = get_config(arch).reduced()
    cfg = dataclasses.replace(a.model, q_chunk=16, kv_chunk=32)
    params = _tree_to(T.init_lm(cfg, torch.Generator().manual_seed(0),
                                "cpu"), dev)
    opt = S._optimizer_for(a)[0]
    gmin, moved = [], []

    class Recording:
        init = staticmethod(opt.init)

        @staticmethod
        def update(grads, state, params, step):
            a = [g.abs().masked_fill(g == 0, float("inf")).cpu()
                 for g in grads]
            gmin[:] = a if not gmin else [x.minimum(y)
                                          for x, y in zip(gmin, a)]
            updates, state = opt.update(grads, state, params, step)
            moved.append(max(u.abs().max().item() for u in updates))
            return updates, state

    state = opt.init(S.lm_param_leaves(params))
    step_fn = S.lm_train_step(cfg, Recording)
    losses = []
    for step in range(steps):
        batch = S._lm_train_batch(cfg, 4, 64, step + 1, dev)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return (losses, [p.cpu() for p in S.lm_param_leaves(params)], gmin,
            sum(moved))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
def test_tiny_moe_training_cuda_matches_cpu_and_repeats(dev, arch):
    """Five steps with the config's own optimizer (AdamW for OLMoE,
    Adafactor for grok): losses within 2e-5 of the cpu run, and params
    within 1e-4 at every element whose nonzero gradients all reached
    1e-6. The optimizers' steps do not scale with the gradient, so the
    rounding of a leaf's large gradients, a large share of its small
    ones, moves those elements by a share of lr a step: they are held
    to the most one element moved in the run, and must be under 1% of
    all; two cuda runs bit-equal
    (the combine adds in a fixed order, and every gather's backward
    sums in a fixed order)."""
    lc, pc, _, _ = _tiny_moe_train(dev, arch)
    lh, ph, gmin, moved = _tiny_moe_train("cpu", arch)
    np.testing.assert_allclose(lc, lh, atol=2e-5, rtol=0)
    n_small = 0
    for a, b, g in zip(pc, ph, gmin):
        held = g >= 1e-6
        n_small += int((~held).sum())
        if held.any():
            assert (a - b).abs()[held].max().item() <= 1e-4
        if (~held).any():
            assert (a - b).abs()[~held].max().item() <= moved
    assert n_small <= 1e-2 * sum(p.numel() for p in ph)
    lc2, pc2, _, _ = _tiny_moe_train(dev, arch)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2))


@pytest.mark.parametrize("router", ["topk", "budget"])
def test_moe_ffn_bf16_cuda_is_deterministic_and_matches_cpu(dev, router):
    """A bf16 layer at a width where atomics would show: two cuda runs
    bit-equal, forward and backward, and the routing equal to the cpu's
    on the same probabilities; outputs within 2e-2."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M

    cfg = MoEConfig(n_experts=16, top_k=4, d_ff_expert=256, router=router,
                    budget_alpha=0.2, capacity_factor=1.0)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 512, 512, generator=g).bfloat16()
    x[:, 1::4] = x[:, ::4]                        # tied tokens
    p = M.init_moe(g, 512, cfg, torch.bfloat16)

    def run(d):
        xd = x.to(d).requires_grad_(True)
        pd = {k: v.to(d).requires_grad_(True) for k, v in p.items()}
        with M.routing_trace() as tr:
            y, aux = M.moe_ffn(xd, pd, cfg)
        (y.float().square().mean() + aux).backward()
        key = "eids" if router == "topk" else "tok"
        return [y.detach().cpu(), xd.grad.cpu(),
                *(v.grad.cpu() for v in pd.values())], tr[0][key].cpu()

    a, ra = run(dev)
    b, _ = run(dev)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    xt = x.reshape(-1, 512).to(dev)
    probs = M.router_probs(xt, p["router"].to(dev), cfg)
    got = (M.topk_dispatch(probs, cfg)["eids"] if router == "topk"
           else M.budget_select(probs, cfg)[1])
    want = (M.topk_dispatch(probs.cpu(), cfg)["eids"] if router == "topk"
            else M.budget_select(probs.cpu(), cfg)[1])
    assert torch.equal(got.cpu(), want) and torch.equal(ra, want)
    c, _ = run("cpu")
    torch.testing.assert_close(a[0].float(), c[0].float(), atol=2e-2,
                               rtol=2e-2)
