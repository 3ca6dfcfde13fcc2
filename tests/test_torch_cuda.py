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
bit-equal across two cuda runs; ``embedding_bag_backward`` bit-equal to
its plain version (the same adds in the same order, each rounded to the
dtype), the reduced recsys zoo's scores on cuda against cpu within
2e-5, and its training (5 steps, AdamW) within 1e-4 (losses, and params
as the MoE LMs': every element whose nonzero gradients all reached
1e-6), two cuda runs and the train CLI's restart bit-equal; nougat-tiny
(the ViT parser) on cuda against cpu within 2e-5 (encode, logits,
gradients, three steps; params as the MoE LMs' but at 2e-5), greedy
tokens equal, no kernel launched, two cuda runs bit-equal; the router's
sft_4k cell within 2e-5 (losses) and 1e-4 (params); both cells' train
CLI restarts bit-equal; one reduced ``launch.specs.build_cell`` cell of
each family (qwen3 prefill, DeepFM retrieval, the EquiformerV2 molecule
train step, route_64k, parse_decode) on cuda against cpu within 2e-5
(the train step's params within 1e-4), integer outputs equal; the
reduced qwen3 prefill and DLRM serve cells built with the ``AxisRules``
of a NCCL world of one, every argument laid out whole by its sharding;
the kernel wrappers' meta branches giving the kernels' output shapes
and dtypes, launching nothing.
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
    """A copy of a tree (nested dicts and lists) of tensors on ``d``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, d) for v in tree]
    return tree.to(d, copy=True)


def _recording(opt, gmin: list, moved: list):
    """``opt``, recording into ``gmin`` each element's smallest nonzero
    |grad| over the steps (on the cpu) and into ``moved`` each step's
    largest |update|."""
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

    return Recording


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
    state = opt.init(S.lm_param_leaves(params))
    step_fn = S.lm_train_step(cfg, _recording(opt, gmin, moved))
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


# -- the recsys zoo and its training (ROADMAP 13e) --------------------------


def _bwd_case(dev, r, d, n, dtype, id_dtype, seed):
    """ids over [-r - 3, r + 3): wrapped and out-of-range ones, and a
    hot row (row 1) taking about half of them; a normal gradient."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)

    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(-r - 3, r + 3, (n,), generator=g, device=dev)
    hot = torch.rand((n,), generator=g, device=dev) < 0.5
    ids = torch.where(hot, torch.ones_like(ids), ids).to(id_dtype)
    grad = torch.randn((n, d), generator=g, device=dev).to(dtype)
    before = eb.BACKWARD.launches
    got = eb.embedding_bag_backward(grad, ids, r)
    assert eb.BACKWARD.launches == before + 1
    want = embedding_bag_backward_ref(grad, ids, r)
    assert got.dtype == dtype and got.shape == (r, d)
    return got, want


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 10, 16, 18, 128])
def test_embedding_bag_backward_kernel_vs_plain(dev, d, dtype, id_dtype):
    """Bit-equal to the plain version (the same adds in the same order,
    rounded to the dtype after each), on the scalar and the 16-byte
    paths, with wrapped, dropped and hot ids."""
    for r, n, seed in ((37, 500, 0), (5000, 40_000, 1)):
        got, want = _bwd_case(dev, r, d, n, dtype, id_dtype, seed)
        assert torch.equal(got, want), (r, n)


def test_embedding_bag_backward_kernel_edges(dev):
    """No ids (every row the kernel's zeros), every id dropped, a long
    run of every width, and the bits equal across two launches."""
    z = eb.embedding_bag_backward(torch.randn((0, 8), device=dev),
                                  torch.zeros(0, dtype=torch.int64,
                                              device=dev), 6)
    assert z.shape == (6, 8) and not z.any()
    drop = eb.embedding_bag_backward(
        torch.randn((3, 8), device=dev),
        torch.tensor([9, -9, 6], device=dev), 6)
    assert not drop.any()
    ids = torch.zeros(100_000, dtype=torch.int32, device=dev)
    ids[::7] = 3
    grad = torch.randn((100_000, 10), device=dev).to(torch.bfloat16)
    a = eb.embedding_bag_backward(grad, ids, 4)
    b = eb.embedding_bag_backward(grad, ids, 4)
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)
    assert torch.equal(a, b)
    assert torch.equal(a, embedding_bag_backward_ref(grad, ids, 4))
    with pytest.raises(ValueError, match="one device"):
        eb.embedding_bag_backward(grad, ids.cpu(), 4)


def _bwd_into_nan(grad, ids, rows):
    """The backward kernel's C entry on the wrapper's plumbing, into an
    output filled with NaN first: an element the kernel does not write
    stays NaN and fails ``torch.equal`` against the plain version."""
    from repro_torch.kernels import cuda_lib

    el, d = grad.element_size(), grad.shape[1]
    out = torch.full((rows, d), float("nan"), dtype=grad.dtype,
                     device=grad.device)
    vb = eb.vec_bytes(el, d * el, grad.data_ptr(), out.data_ptr())
    tile = eb.tile_rows(d * el // vb, ids.numel(), rows)
    keys, perm, ptr = eb.row_offsets(ids, rows, tile)
    eb.BACKWARD(grad.data_ptr(), eb._TABLE_DTYPES[grad.dtype], rows, d,
                keys.data_ptr(), perm.data_ptr(), keys.numel(),
                ptr.data_ptr(), tile, vb, out.data_ptr(),
                cuda_lib.stream_of(grad.device))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("d,dtype", [(10, torch.bfloat16),
                                     (18, torch.float32)])
def test_embedding_bag_backward_one_long_run_through_the_ring(dev, d, dtype):
    """50,000 ids on one row (past the long-run threshold, round the
    ring many times), a few on others: bit-equal to the plain version,
    every element written, and two launches bit-equal."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)

    g = torch.Generator(device=dev).manual_seed(d)
    n, r = 50_000, 40
    ids = torch.full((n,), 17, dtype=torch.int32, device=dev)
    ids[::997] = torch.randint(0, r, (ids[::997].numel(),), generator=g,
                               device=dev, dtype=torch.int32)
    grad = torch.randn((n, d), generator=g, device=dev).to(dtype)
    want = embedding_bag_backward_ref(grad, ids, r)
    a = _bwd_into_nan(grad, ids, r)
    assert torch.equal(a, want)
    assert torch.equal(eb.embedding_bag_backward(grad, ids, r), a)


@pytest.mark.parametrize("d,dtype", [(10, torch.bfloat16),
                                     (18, torch.float32),
                                     (1, torch.bfloat16),
                                     (6272, torch.bfloat16)])
def test_embedding_bag_backward_writes_untouched_and_once_touched_rows(
        dev, d, dtype):
    """A grad whose rows are all untouched (every id dropped: zeros
    everywhere), and one that touches every row exactly once (the rows
    permuted), each into a NaN-filled output."""
    g = torch.Generator(device=dev).manual_seed(d)
    r = 3000 if d < 1000 else 300
    grad = torch.randn((r, d), generator=g, device=dev).to(dtype)
    dropped = torch.randint(r, 2 * r, (r,), generator=g, device=dev)
    assert torch.equal(_bwd_into_nan(grad, dropped, r),
                       torch.zeros((r, d), dtype=dtype, device=dev))
    perm = torch.randperm(r, generator=g, device=dev)
    want = torch.empty_like(grad)
    want[perm] = grad
    assert torch.equal(_bwd_into_nan(grad, perm, r), want)


@pytest.mark.parametrize("d,dtype", [(10, torch.bfloat16),
                                     (18, torch.float32),
                                     (3, torch.bfloat16),
                                     (128, torch.bfloat16)])
def test_embedding_bag_backward_runs_at_the_long_threshold(dev, d, dtype):
    """Runs of LONG_RUN - 1, LONG_RUN (the tile's warp sums them) and
    LONG_RUN + 1, 2 LONG_RUN + 1 (their own warp and ring) ids, shuffled
    among short ones: bit-equal, every element written."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)

    g = torch.Generator(device=dev).manual_seed(d + 1)
    lens = [eb.LONG_RUN - 1, eb.LONG_RUN, eb.LONG_RUN + 1,
            2 * eb.LONG_RUN + 1]
    r = 200
    runs = torch.cat([torch.full((m,), 3 + 5 * i, dtype=torch.int64)
                      for i, m in enumerate(lens)]).to(dev)
    rest = 1 + 5 * (torch.arange(400, device=dev) % 40)   # 10 ids a row
    ids = torch.cat([runs, rest])
    ids = ids[torch.randperm(ids.numel(), generator=g, device=dev)]
    grad = torch.randn((ids.numel(), d), generator=g, device=dev).to(dtype)
    _, _, ptr = eb.row_offsets(ids, r)
    assert [int(ptr[3 + 5 * i + 1] - ptr[3 + 5 * i]) for i in
            range(len(lens))] == lens
    assert torch.equal(_bwd_into_nan(grad, ids, r),
                       embedding_bag_backward_ref(grad, ids, r))


@pytest.mark.parametrize("d,dtype", [(10, torch.bfloat16),
                                     (1, torch.bfloat16),
                                     (16, torch.bfloat16),
                                     (18, torch.float32)])
def test_embedding_bag_backward_sparse_table_tiles(dev, d, dtype):
    """A sparse table (a tenth of an id a row: tiles of 256 rows, most
    found by scatter), with a hot row of 5,000 ids whose tile has more
    keys than a scatter takes (binary search), runs at the long
    threshold, and ids that wrap or drop: bit-equal, every element
    written."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)

    g = torch.Generator(device=dev).manual_seed(d + 7)
    r, n = 400_000, 40_000
    ids = torch.randint(-r - 50, r + 50, (n,), generator=g, device=dev)
    ids[:5000] = 123_457
    ids[5000:5000 + eb.LONG_RUN] = 9
    ids[6000:6000 + eb.LONG_RUN + 1] = 300_001
    ids = ids[torch.randperm(n, generator=g, device=dev)]
    grad = torch.randn((n, d), generator=g, device=dev).to(dtype)
    el = grad.element_size()
    assert eb.tile_rows(d * el // eb.vec_bytes(el, d * el, 512, 512), n,
                        r) >= 128
    assert torch.equal(_bwd_into_nan(grad, ids, r),
                       embedding_bag_backward_ref(grad, ids, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 10, 16, 18])
def test_embedding_bag_kernel_every_vector_width(dev, d, dtype):
    """The forward at every vector width the wrapper picks: D in {1, 2,
    3, 5, 10, 16, 18} of a table taken as a slice at an element offset,
    so the base address is only 2- or 4-byte aligned, and of the whole
    table; bags of one exactly (NaN for ids out of range), weighted bags
    of 3 within the tolerance."""
    g = torch.Generator(device=dev).manual_seed(d)
    r = 4000
    full = torch.randn((r, d + 1), generator=g, device=dev).to(dtype)
    flat = torch.randn(r * d + 1, generator=g, device=dev).to(dtype)
    whole = full[:, :d].contiguous()
    # a row stride of d + 1, and contiguous rows one element past the
    # allocation's start (a 2-byte address in bf16, 4-byte in f32)
    for table in (whole, full[:, 1:], flat[1:].view(r, d)):
        el = table.element_size()
        vb = eb.vec_bytes(el, d * el, table.stride(0) * el,
                          table.data_ptr(), 512)
        ids = torch.randint(-r - 5, r + 5, (3000, 1), generator=g,
                            device=dev)
        _eb_check(table, ids, None, "sum", exact=True)
        ids3 = torch.randint(0, r, (2000, 3), generator=g, device=dev,
                             dtype=torch.int32)
        w = torch.rand((2000, 3), generator=g, device=dev)
        _eb_check(table, ids3, w, "sum")
        _eb_check(table, ids3, w, "mean")
        assert vb in ((2, 4, 8, 16) if el == 2 else (4, 8, 16))
    if d == 10 and dtype == torch.bfloat16:
        assert eb.vec_bytes(2, 20, 20, flat[1:].data_ptr(), 512) == 2
        assert eb.vec_bytes(2, 20, 20, whole.data_ptr(), 512) == 4


def test_backward_and_segment_sum_make_no_host_sync(dev):
    """``embedding_bag_backward`` and ``segment_sum`` (forward and
    backward) run under ``set_sync_debug_mode("error")``: their plumbing
    waits for nothing on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    grad = torch.randn((5000, 10), generator=g, device=dev).to(
        torch.bfloat16)
    ids = torch.randint(-300, 300, (5000,), generator=g, device=dev)
    ids[:2000] = 4
    msgs = torch.randn((5000, 6), generator=g, device=dev,
                       requires_grad=True)
    cot = torch.randn((250, 6), generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = eb.embedding_bag_backward(grad, ids, 250)
        out = eb.segment_sum(msgs, ids, 250)
        (gm,) = torch.autograd.grad(out, msgs, cot)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)
    assert torch.equal(a, embedding_bag_backward_ref(grad, ids, 250))
    assert torch.equal(out.detach().cpu(),
                       eb.segment_sum(msgs.detach().cpu(), ids.cpu(), 250))
    assert gm.shape == msgs.shape


def test_lookup_autograd_launches_both_kernels(dev):
    """``lookup`` on the card: one forward and one backward launch, the
    rows equal to the gather and the table gradient to the plain
    backward's."""
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_ref)

    table = torch.randn((300, 16), device=dev).to(torch.bfloat16)
    table.requires_grad_(True)
    ids = torch.randint(0, 300, (5000,), device=dev, dtype=torch.int32)
    w = torch.randn((5000, 16), device=dev).to(torch.bfloat16)
    f0, b0 = eb.KERNEL.launches, eb.BACKWARD.launches
    rows = eb.lookup(table, ids)
    (g,) = torch.autograd.grad(rows, table, w)
    assert (eb.KERNEL.launches, eb.BACKWARD.launches) == (f0 + 1, b0 + 1)
    assert torch.equal(rows, table.detach()[ids.long()])
    assert torch.equal(g, embedding_bag_backward_ref(w, ids, 300))


def _tiny_recsys_train(dev, arch, steps=5):
    """The reduced f32 config from one cpu init, ``steps`` of
    ``recsys_train_step`` with its optimizer on ``dev``: (losses, final
    leaves, each element's smallest nonzero |grad|, all on the cpu, and
    the sum over the steps of the largest |update|)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models.recsys import models as M

    a = get_config(arch).reduced()
    cfg = a.model
    params = _tree_to(M.init_recsys(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), dev)
    opt = S._optimizer_for(a)[0]
    gmin, moved = [], []
    state = opt.init(S.recsys_param_leaves(params))
    step_fn = S.recsys_train_step(cfg, _recording(opt, gmin, moved))
    losses = []
    for step in range(steps):
        batch = S._recsys_batch(cfg, 64, step + 1, dev)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return (losses, [p.cpu() for p in S.recsys_param_leaves(params)], gmin,
            sum(moved))


@pytest.mark.parametrize("arch", ["deepfm", "autoint", "dien",
                                  "dlrm-mlperf"])
def test_tiny_recsys_training_cuda_matches_cpu_and_repeats(dev, arch):
    """Five steps of the reduced f32 config: losses within 1e-4 of the
    cpu run and params within 1e-4 at every element whose nonzero
    gradients all reached 1e-6 (AdamW's step does not scale with the
    gradient, so the rest are held to the most one element moved); one
    backward launch per table a step; two cuda runs bit-equal (both
    table kernels add in a fixed order)."""
    b0 = eb.BACKWARD.launches
    lc, pc, _, _ = _tiny_recsys_train(dev, arch)
    n_tables = 2 if arch == "deepfm" else 1
    assert eb.BACKWARD.launches == b0 + 5 * n_tables
    lh, ph, gmin, moved = _tiny_recsys_train("cpu", arch)
    np.testing.assert_allclose(lc, lh, atol=1e-4, rtol=0)
    for a, b, g in zip(pc, ph, gmin):
        held = g >= 1e-6
        if held.any():
            assert (a - b).abs()[held].max().item() <= 1e-4
        if (~held).any():
            assert (a - b).abs()[~held].max().item() <= moved
    lc2, pc2, _, _ = _tiny_recsys_train(dev, arch)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2))


@pytest.mark.parametrize("arch", ["deepfm", "autoint", "dien"])
def test_small_zoo_scores_cuda_match_cpu(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import _recsys_batch
    from repro_torch.models.recsys import models as M

    cfg = get_config(arch).reduced().model
    host = M.init_recsys(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _recsys_batch(cfg, 300, 1, device="cpu")
    before = eb.KERNEL.launches
    got = M.recsys_scores(_tree_to(host, dev), cfg,
                          {k: v.to(dev) for k, v in batch.items()})
    assert eb.KERNEL.launches == before + (2 if arch == "deepfm" else 1)
    want = M.recsys_scores(host, cfg, batch)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_recsys_train_main_restart_is_bit_exact_on_cuda(dev, tmp_path):
    """``launch.train.main --arch deepfm --reduced`` on cuda: 6 steps
    against 3, a checkpoint and a resume to 6, bit-equal."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train

    def main(*extra):
        return train.main(["--arch", "deepfm", "--shape", "train_batch",
                           "--reduced", "--log-every", "100", "--device",
                           "cuda", *extra])

    full = main("--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                "--ckpt-every", "100")
    assert main("--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "3") == full[:3]
    assert main("--steps", "6", "--ckpt-dir", str(tmp_path / "ck")) == \
        full[3:]
    a = ckpt._flatten(ckpt.restore(str(tmp_path / "full"), device="cpu")[1])
    b = ckpt._flatten(ckpt.restore(str(tmp_path / "ck"), device="cpu")[1])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


# -- equiformer-v2 (ROADMAP 13e, its GNN part) -----------------------------


@pytest.mark.parametrize("d", [1, 8, 6272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_vs_plain(dev, d, dtype):
    """``ops.segment_sum``: one ``embedding_bag_backward`` launch, equal
    bit for bit to the plain version's position-order adds on the cpu
    (ids below 0 or past n dropped, a long segment); its backward is a
    gather with no launch, zero for a dropped id."""
    g = torch.Generator(device=dev).manual_seed(d)
    n, e = 300, 2000
    ids = torch.randint(-20, n + 20, (e,), generator=g, device=dev)
    ids[:500] = 7
    msgs = torch.randn((e, d), generator=g, device=dev).to(dtype)
    before = eb.BACKWARD.launches
    got = eb.segment_sum(msgs, ids, n)
    assert eb.BACKWARD.launches == before + 1
    assert torch.equal(got.cpu(), eb.segment_sum(msgs.cpu(), ids.cpu(), n))
    msgs.requires_grad_(True)
    cot = torch.randn((n, d), generator=g, device=dev).to(dtype)
    out = eb.segment_sum(msgs, ids, n)
    b0 = (eb.KERNEL.launches, eb.BACKWARD.launches)
    (gm,) = torch.autograd.grad(out, msgs, cot)
    assert (eb.KERNEL.launches, eb.BACKWARD.launches) == b0
    valid = ((ids >= 0) & (ids < n))[:, None]
    assert torch.equal(gm, torch.where(valid, cot[ids.clamp(0, n - 1)], 0))


def _tiny_gnn(shape_name, layers=None):
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models.gnn import equiformer as E

    arch = get_config("equiformer-v2").reduced()
    shape = S._reduce_shape("gnn", arch.shape(shape_name))
    cfg = S.gnn_cell_config(arch, shape)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    host = E.init_equiformer(cfg, torch.Generator().manual_seed(0), "cpu")
    return arch, shape, cfg, host


def _tiny_gnn_train(d, arch, shape, cfg, host, steps=3):
    from repro_torch.launch import specs as S

    params = _tree_to(host, d)
    opt = S._optimizer_for(arch)[0]
    gmin, moved = [], []
    state = opt.init(S.gnn_param_leaves(params))
    step_fn = S.gnn_train_step(cfg, _recording(opt, gmin, moved))
    losses = []
    for step in range(steps):
        batch = S._gnn_batch(shape, step + 1, d)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return (losses, [p.cpu() for p in S.gnn_param_leaves(params)], gmin,
            sum(moved))


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "molecule"])
def test_tiny_equiformer_cuda_matches_cpu_and_repeats(dev, shape_name):
    """eq-tiny (f32, 3 layers) on cuda against cpu: the forward, the loss
    and every gradient within 2e-5; three steps, losses within 2e-5 and
    params within 1e-4 at every element whose nonzero gradients all
    reached 1e-6 (the rest held to the most one element moved); the
    launches of a remat step exactly (8 embedding_bag and 8
    embedding_bag_backward a layer, one more for the pooled readout);
    two cuda runs bit-equal."""
    from repro_torch.launch import specs as S
    from repro_torch.models.gnn import equiformer as E

    arch, shape, cfg, host = _tiny_gnn(shape_name, layers=3)
    bc = S._gnn_batch(shape, 1, "cpu")
    bg = S._gnn_batch(shape, 1, dev)
    with torch.no_grad():
        torch.testing.assert_close(
            E.equiformer_forward(_tree_to(host, dev), cfg, bg).cpu(),
            E.equiformer_forward(host, cfg, bc), atol=2e-5, rtol=0)

    def loss_grads(params, batch):
        leaves = S.gnn_param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = E.equiformer_loss(params, cfg, batch)
        return loss, torch.autograd.grad(loss, leaves)

    lh, gh = loss_grads(_tree_to(host, "cpu"), bc)
    k0 = (eb.KERNEL.launches, eb.BACKWARD.launches)
    lc, gc = loss_grads(_tree_to(host, dev), bg)
    pooled = int(shape_name == "molecule")
    assert (eb.KERNEL.launches - k0[0], eb.BACKWARD.launches - k0[1]) == \
        (8 * cfg.n_layers, 8 * cfg.n_layers + pooled)
    assert abs(float(lc) - float(lh)) <= 2e-5
    for a, b in zip(gc, gh):
        torch.testing.assert_close(a.cpu(), b, atol=2e-5, rtol=0)
    lc, pc, _, _ = _tiny_gnn_train(dev, arch, shape, cfg, host)
    lh, ph, gmin, moved = _tiny_gnn_train("cpu", arch, shape, cfg, host)
    np.testing.assert_allclose(lc, lh, atol=2e-5, rtol=0)
    for a, b, g in zip(pc, ph, gmin):
        held = g >= 1e-6
        if held.any():
            assert (a - b).abs()[held].max().item() <= 1e-4
        if (~held).any():
            assert (a - b).abs()[~held].max().item() <= moved
    lc2, pc2, _, _ = _tiny_gnn_train(dev, arch, shape, cfg, host)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2))


def test_equiformer_bf16_training_is_bit_reproducible_on_cuda(dev):
    """Two bf16 trainings of eq-tiny (3 steps) on the card give the same
    bits: every sum by index adds in a fixed order."""
    arch, shape, cfg, host = _tiny_gnn("minibatch_lg", layers=3)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    host = {k: (v.to(torch.bfloat16) if not isinstance(v, dict) else
                {a: b.to(torch.bfloat16) for a, b in v.items()})
            for k, v in host.items()}
    la, pa, _, _ = _tiny_gnn_train(dev, arch, shape, cfg, host)
    lb, pb, _, _ = _tiny_gnn_train(dev, arch, shape, cfg, host)
    assert all(np.isfinite(la))
    assert la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_gnn_train_main_restart_is_bit_exact_on_cuda(dev, tmp_path):
    """``launch.train.main --arch equiformer-v2 --shape molecule
    --reduced`` on cuda: 6 steps against 3, a checkpoint and a resume to
    6, bit-equal."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train

    def main(*extra):
        return train.main(["--arch", "equiformer-v2", "--shape", "molecule",
                           "--reduced", "--log-every", "100", "--device",
                           "cuda", *extra])

    full = main("--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                "--ckpt-every", "100")
    assert main("--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "3") == full[:3]
    assert main("--steps", "6", "--ckpt-dir", str(tmp_path / "ck")) == \
        full[3:]
    a = ckpt._flatten(ckpt.restore(str(tmp_path / "full"), device="cpu")[1])
    b = ckpt._flatten(ckpt.restore(str(tmp_path / "ck"), device="cpu")[1])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def _tiny_vit_train(d, host, steps=3):
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S

    arch = get_config("nougat-base").reduced()
    shape = S._reduce_shape("vit_parser", arch.shape("train_pages"))
    params = _tree_to(host, d)
    opt = S._optimizer_for(arch)[0]
    gmin, moved = [], []
    state = opt.init(S.vit_parser_param_leaves(params))
    step_fn = S.vit_parser_train_step(arch.model,
                                      _recording(opt, gmin, moved))
    losses = []
    for step in range(steps):
        batch = S._nougat_batch(arch.model, shape, step + 1, d)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return (losses, [p.cpu() for p in S.vit_parser_param_leaves(params)],
            gmin, sum(moved))


def test_tiny_vit_parser_cuda_matches_cpu_and_repeats(dev):
    """nougat-tiny (f32; 12 patches in windows of 8: padded) on cuda
    against cpu: encode, logits, the loss and every gradient within
    2e-5, greedy tokens equal; three steps, losses within 2e-5 and params
    within 2e-5 at every element whose nonzero gradients all reached
    1e-6 (the rest held to the most one element moved); no hand kernel
    launched; two cuda runs bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models import vit_parser as V

    cfg = get_config("nougat-base").reduced().model
    host = V.init_vit_parser(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(0)
    patches = torch.from_numpy(rng.randn(3, cfg.n_patches, 768).astype(
        np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (3, 12)).astype(
        np.int32))
    batch = {"patches": patches, "tokens": toks,
             "labels": toks.roll(-1, dims=1)}

    def loss_grads(params, b):
        leaves = S.vit_parser_param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = V.parser_loss(params, cfg, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    k0 = {n: k.launches for n, k in _all_kernels().items()}
    lc, gc = loss_grads(_tree_to(host, dev),
                        {k: v.to(dev) for k, v in batch.items()})
    lh, gh = loss_grads(_tree_to(host, "cpu"), batch)
    assert {n: k.launches for n, k in _all_kernels().items()} == k0
    assert abs(float(lc) - float(lh)) <= 2e-5
    for a, b in zip(gc, gh):
        torch.testing.assert_close(a.cpu(), b, atol=2e-5, rtol=0)
    with torch.no_grad():
        mc = V.encode_pages(_tree_to(host, dev), cfg, patches.to(dev))
        mh = V.encode_pages(host, cfg, patches)
        torch.testing.assert_close(mc.cpu(), mh, atol=2e-5, rtol=0)
        torch.testing.assert_close(
            V.decode_logits(_tree_to(host, dev), cfg, mc, toks.to(dev)).cpu(),
            V.decode_logits(host, cfg, mh, toks), atol=2e-5, rtol=0)
    assert torch.equal(
        V.generate(_tree_to(host, dev), cfg, patches.to(dev), 16).cpu(),
        V.generate(host, cfg, patches, 16))
    lc, pc, _, _ = _tiny_vit_train(dev, host)
    lh, ph, gmin, moved = _tiny_vit_train("cpu", host)
    np.testing.assert_allclose(lc, lh, atol=2e-5, rtol=0)
    for a, b, g in zip(pc, ph, gmin):
        held = g >= 1e-6
        if held.any():
            assert (a - b).abs()[held].max().item() <= 2e-5
        if (~held).any():
            assert (a - b).abs()[~held].max().item() <= moved
    lc2, pc2, _, _ = _tiny_vit_train(dev, host)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2))


def _all_kernels():
    return {"fast_features": ff.KERNEL, "budget_route": br.KERNEL,
            "ngram_score": ng.KERNEL, "flash_attention": fa.KERNEL,
            "embedding_bag": eb.KERNEL, "embedding_bag_backward":
            eb.BACKWARD, "segment_mm": sm.KERNEL}


def test_router_sft_cell_cuda_matches_cpu(dev):
    """The router-tiny ``sft_4k`` cell (``router_train_step``, AdamW with
    clipping) from one cpu init, 3 steps on cuda against cpu: losses
    within 2e-5 and params within 1e-4 (the router training's bar)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S

    arch = get_config("adaparse-router").reduced()
    shape = S._reduce_shape("encoder", arch.shape("sft_4k"))
    host = S.init_router_params(arch.model, torch.Generator().manual_seed(0),
                                "cpu")

    def run(d):
        params = _tree_to(host, d)
        opt = S._optimizer_for(arch)[0]
        state = opt.init(S.router_param_leaves(params))
        step_fn = S.router_train_step(arch.model, opt)
        losses = []
        for step in range(3):
            batch = S._router_batch(arch.model, shape, step + 1, d)
            _, state, loss = step_fn(params, state, step, batch)
            losses.append(float(loss))
        return losses, [p.cpu() for p in S.router_param_leaves(params)]

    lc, pc = run(dev)
    lh, ph = run("cpu")
    np.testing.assert_allclose(lc, lh, atol=2e-5, rtol=0)
    for a, b in zip(pc, ph):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch, shape", [("nougat-base", "train_pages"),
                                         ("adaparse-router", "sft_4k")])
def test_parser_and_router_train_main_restart_is_bit_exact_on_cuda(
        dev, tmp_path, arch, shape):
    """``launch.train.main --reduced`` on cuda for the ViT parser's
    train_pages and the router's sft_4k: 6 steps against 3, a checkpoint
    and a resume to 6, bit-equal."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train

    def main(*extra):
        return train.main(["--arch", arch, "--shape", shape, "--reduced",
                           "--log-every", "100", "--device", "cuda",
                           *extra])

    full = main("--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                "--ckpt-every", "100")
    assert all(np.isfinite(full))
    assert main("--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "3") == full[:3]
    assert main("--steps", "6", "--ckpt-dir", str(tmp_path / "ck")) == \
        full[3:]
    a = ckpt._flatten(ckpt.restore(str(tmp_path / "full"), device="cpu")[1])
    b = ckpt._flatten(ckpt.restore(str(tmp_path / "ck"), device="cpu")[1])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def _cell_args_to(x, d):
    if isinstance(x, torch.Tensor):
        return x.to(d, copy=True)
    if isinstance(x, dict):
        return {k: _cell_args_to(v, d) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cell_args_to(v, d) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_cell_args_to(v, d) for v in x)
    return x


@pytest.mark.parametrize("arch, shape", [
    ("qwen3-1.7b", "prefill_32k"), ("deepfm", "retrieval_cand"),
    ("equiformer-v2", "molecule"), ("adaparse-router", "route_64k"),
    ("nougat-base", "parse_decode")])
def test_reduced_cell_cuda_matches_cpu(dev, arch, shape):
    """One reduced cell of each family from ``launch.specs.build_cell``
    (built on the cpu), one step on cuda and on cpu from the same
    arguments: floating outputs within 2e-5 (the f32 tiny configs),
    integer outputs (top-k ids, the route plan) equal; the molecule
    train cell's loss within 2e-5 and its params within 1e-4 (the router
    training's bar: AdamW's first step moves an element by about lr
    whatever its grad)."""
    from repro_torch.launch import specs as S

    cell = S.build_cell(arch, shape, abstract=False, reduced=True,
                        device="cpu")
    on_card = _cell_args_to(cell.args, dev)
    got, want = cell.fn(*on_card), cell.fn(*cell.args)
    if cell.kind == "train":
        assert abs(float(got[-1]) - float(want[-1])) <= 2e-5
        got, want, tol = got[0], want[0], 1e-4
    else:
        tol = 2e-5
    gl, wl = S._tree_leaves(got), S._tree_leaves(want)
    assert len(gl) == len(wl) > 0
    for a, b in zip(gl, wl):
        a = a.detach().cpu()
        assert a.shape == b.shape and a.dtype == b.dtype
        if b.is_floating_point():
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
        else:
            assert torch.equal(a, b)


@pytest.fixture
def world_of_one(dev):
    """A NCCL process group of one rank on the card, and AxisRules on its
    1x1 (data, model) mesh; destroyed after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield AxisRules(make_mesh((1, 1), ("data", "model"), "cuda"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch, shape", [("qwen3-1.7b", "prefill_32k"),
                                         ("dlrm-mlperf", "serve_p99")])
def test_cell_shardings_lay_out_every_argument_on_a_world_of_one(
        dev, world_of_one, arch, shape):
    """A reduced cell built on the card with the rules of a NCCL world
    of one has a sharding for every argument, and ``distribute_tensor``
    with its placements on the card's 1x1 mesh keeps each argument
    whole on its one rank; ``shard_hint`` on a plain tensor under those
    rules gives it back."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common import tree_leaves
    from repro_torch.distributed.meshrules import (NamedSharding,
                                                   shard_hint, use_rules)
    from repro_torch.launch import specs as S

    cell = S.build_cell(arch, shape, rules=world_of_one, reduced=True,
                        abstract=False, device="cuda")
    args = tree_leaves(cell.args)
    shs = tree_leaves(cell.in_shardings,
                      lambda x: isinstance(x, NamedSharding))
    assert len(shs) == len(args) > 0
    for t, sh in zip(args, shs):
        assert sh.shard_shape(t.shape) == tuple(t.shape)
        d = distribute_tensor(t, world_of_one.mesh, sh.placements)
        assert torch.equal(d.to_local(), t)
    with use_rules(world_of_one):
        assert shard_hint(args[0], "batch") is args[0]


@pytest.mark.parametrize("cell, kernel", [
    ("qwen3-1.7b/prefill_32k", "flash_attention"),
    ("dlrm-mlperf/serve_p99", "embedding_bag"),
    ("adaparse-router/route_64k", "budget_route")])
def test_forward_cells_on_dtensors_bit_equal_on_a_world_of_one(
        dev, world_of_one, cell, kernel):
    """A reduced forward cell built on the card, its arguments placed as
    DTensors on the NCCL world of one (``specs.place_args``) and run
    under the rules, gives the bits of the same cell with
    ``rules=None``; its hand kernel launches through its DTensor branch
    (the prefill's flash_attention with ``attention_impl="pallas"``),
    and no collective runs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.common import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.meshrules import use_rules
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import specs as S

    arch_id, shape_name = cell.split("/")
    arch, shape = S.cell_shape(arch_id, shape_name, reduced=True)
    if arch.family == "lm":
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, attention_impl="pallas"))
    if shape_name == "route_64k":       # a batch whose plan selects rows
        shape = ShapeConfig(shape.name, shape.kind,
                            {**shape.dims, "global_batch": 64})

    def build(rules):
        return S.build_cell_for(arch, shape, rules, abstract=False,
                                device="cuda")

    plain = build(None)
    want = tree_leaves(plain.fn(*plain.args))
    c = build(world_of_one)
    before = cuda_lib.launch_counts().get(kernel, 0)
    with use_rules(world_of_one), CommDebugMode() as comm:
        got = tree_leaves(c.fn(*S.place_args(c)))
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()[kernel] > before
    assert comm.get_total_counts() == 0
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        g = g.to_local()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            g, w = g.view(torch.uint8), w.view(torch.uint8)
        assert torch.equal(g, w)


def test_kernel_meta_branches_give_the_kernels_shapes(dev):
    """Each wrapper's meta call returns the shapes and dtypes the kernel
    writes on the card, and launches nothing."""
    from repro_torch.kernels import cuda_lib

    def meta(x):
        return (torch.empty(x.shape, dtype=x.dtype, device="meta")
                if isinstance(x, torch.Tensor) else x)

    bf, i32 = torch.bfloat16, torch.int32
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(  # noqa: E731
        s, generator=g, device=dev).to(dt)
    ids = lambda hi, *s: torch.randint(  # noqa: E731
        0, hi, s, generator=g, device=dev, dtype=i32)
    ffkw = dict(max_len=64, ws=2, scramble=3, mangled=4, latex_lo=800,
                ident_lo=850, vocab_size=1000)
    calls = [
        (lambda *a: ff.fast_features(*a, **ffkw),
         (ids(1000, 4, 128), *[torch.full((4,), 3, dtype=i32,
                                          device=dev)] * 4)),
        (lambda s, t: br.budget_route(s, t, 0.25), (r(64), r(64, 16))),
        (ng.ngram_bleu, (ids(9, 4, 16), ids(9, 4, 16),
                         torch.full((4,), 16, dtype=i32, device=dev),
                         torch.full((4,), 12, dtype=i32, device=dev))),
        (fa.flash_attention, (r(2, 64, 4, 32, dt=bf), r(2, 64, 2, 32, dt=bf),
                              r(2, 64, 2, 32, dt=bf))),
        (eb.embedding_bag, (r(100, 16, dt=bf), ids(100, 8, 3))),
        (lambda gr, i: eb.embedding_bag_backward(gr, i, 100),
         (r(20, 16), ids(100, 20).long())),
        (lambda x, s, d, w: sm.segment_matmul(x, s, d, w, n_nodes=10),
         (r(10, 8), ids(10, 30), ids(10, 30), r(8, 4))),
    ]
    for fn, args in calls:
        want = fn(*args)
        before = cuda_lib.launch_counts()
        got = fn(*[meta(a) for a in args])
        assert cuda_lib.launch_counts() == before
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if b is not None:
                assert a.is_meta and a.shape == b.shape \
                    and a.dtype == b.dtype
