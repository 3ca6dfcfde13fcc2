#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda/bin) and
the repository's ``src/``; exits non-zero, printing no result, without
them. Imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (one JSON line each; any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), then the
   kernel library built from ``src/repro_torch/kernels/**/csrc/*.cu``
   with nvcc for sm_90a (set-up), with ptxas's registers and shared
   memory for the bf16 tensor-core flash body and segment_mm.
1. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes, with the tolerance stated:
   fast_features (n=256 real packed batches, max_len 0 and 512),
   budget_route (N=256, D=512, alpha=0.05, and route_64k: N=65536; one
   launch into outputs filled with garbage, its empty-kernel floor at the
   same grid and launch kind, and a torch.profiler pass of the whole
   ``budget_route()`` op at N=256: device launches and time a call),
   ngram_score (B=64 and 256, L=256), flash_attention (the qwen3-1.7b
   prefill shape B=4 S=4096 H=16 Hk=8 D=128 causal in bf16 and in f32,
   the h2o-danube-3-4b shape B=1 S=8192 H=32 Hk=8 D=120 window 4096
   in bf16, and the olmoe-1b-7b (H=Hk=16) and phi3-medium-14b (H=40
   Hk=10) prefill shapes at B=4 S=4096 D=128 in bf16, each also timed against PyTorch's
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
   the qwen3 and danube bf16 rows' max abs error must also stay within
   4e-3, which a control that rounds p once to bf16 must exceed: the
   design check of the bf16 body, made at those two shapes),
   embedding_bag (the dlrm-mlperf ``serve_bulk`` lookup: 262,144 x 26
   bags of one over the 48.07 GB bf16 table, bit-equal; and a 100,000 x
   64 f32 table, B=4096, L=16, sum and mean; timed beside
   ``torch.nn.functional.embedding_bag``), segment_mm (``ogb_products``:
   N=2,449,029, E=61,859,140, 100 -> 128, f32; timed beside
   ``torch.matmul`` then ``index_add_``). ``ms`` is the CUDA-event median
   of one launch (host time included for a small kernel: the first event
   fires before the host has submitted it); ``ms_device`` is the device
   time per launch over 100 back-to-back launches queued behind a sleep
   kernel (``launch.kernel_timing.device_ms``). Rows 1-3 also give the
   torch.profiler durations of the kernels themselves (``profiler_ms``)
   and ``empty_launch_ms`` / ``empty_profiler_ms``: a do-nothing kernel
   at the same grid, the floor under them (not a bound). Each row also
   gives ``tflops`` (the function's operations over ``ms``, where they
   are counted), ``x_bound`` and ``x_bound_device`` (``ms`` and
   ``ms_device`` over the bound). Then the adversarial cases of the
   redesigned ngram_score (every token equal, an L that is not a
   multiple of 32, lengths 0, 1 and L, max_n 1 to 8, L at the wrapper's
   limit), fast_features (one repeated token, ids 0 and vocab - 1,
   widths 128 and 4096, n_tok 0, one document) and budget_route (one
   row, both sides of the single-block limits, a grid of several chunks,
   count below capacity into garbage, misaligned views, all ties, NaN
   and infinite scores) against their plain versions, and the
   routing-parity probes: a negative NaN and
   subnormal scores through the CUDA budget_route and budget_topk,
   asserted against the JAX package's answers written in as constants.
2. ft: ``serve.main`` with ``--variant ft --device cuda`` and with
   ``--device cpu``: the metric dicts must be equal, and fast_features
   must have launched at least once per batch.
3. train: the router's three stages (``core/dpo.py``) at full width,
   ``adaparse-router`` as registered (12 layers, d=768, S=512, bf16,
   remat; random init from a seeded generator), on inputs drawn from the
   corpus through the fast_features kernel: SFT and refit at batch 256
   (``sft_4k`` is 4096), DPO at 64 pairs (``dpo_2k`` is 2048), one
   warm-up and 3 timed steps a stage: ms a step, samples/s, peak GB, the
   losses and model TFLOP/s (3x the forward's matmul and attention
   FLOPs, DPO's frozen reference 1x) against 989 TFLOP/s bf16; a
   torch.profiler pass over one SFT step. Holds: finite losses; SFT,
   from the init, changes every parameter its loss reaches but the norm
   scales still at 1.0, which bf16 cannot move by a step below 2^-9; DPO
   and the refit change the head they train (the reached parameters
   that did not move, and the share of elements that did, are
   reported); DPO leaves the regression head as it was. Also the
   embedding gradient of one SFT batch, taken twice through
   ``index_select`` and through ``embed_lookup`` (the latter must give
   the same bits).
4. train_small_parity: the reduced f32 ``router-tiny`` from one exported
   init, 20 steps a stage on cuda and on cpu: losses within rtol 1e-5,
   params within 1e-4; then ``serve.build_llm_router`` twice on cuda:
   the two routers must have the same bits.
5. serve_llm: ``serve.main`` with ``--variant llm`` (SFT+DPO training of
   the reduced router included) at the ft phase's sizes on cuda and on
   cpu: fast_features and budget_route must have launched, each cuda
   batch's device plan must equal ``plan_batch`` on its scores, and
   ``frac_expensive`` <= alpha in both runs.
6. llm: the full-width bf16 ``adaparse-router`` encoder that phase
   ``train`` trained behind a fitted CLS-I stage, run by
   ``AdaParseEngine(..., device="cuda", probe=QualityProbe(rate 1.0))``
   and evaluated: every kernel must have launched, every batch's device
   plan must equal ``plan_batch`` on the same improvement scores, and
   the predictions must be finite in [0, 1]. A reduced f32 encoder then
   runs the same engine on cuda and on cpu, whose records must agree
   (a flip allowed only within 1e-5 of tau).
7. campaign: that router over the 3,072 test documents of a 4,608
   document corpus (12 batches of 256) through the campaign layer, four
   simulated nodes sharing the card: A1 one ``AdaParseEngine``; A2 a
   ``CampaignController`` (pools cpu:3,gpu:1, speed factors 1/1/3/1,
   prefetch 2, probe rate 0.5, straggler rate 0.5, a DiskResultStore),
   whose records must equal A1's; A2r the same with two GPU-pool nodes
   and hung stragglers, which must re-issue, records equal; A3 a warm
   replay of A2's store on the card and on the CPU, every batch a hit;
   A4 alpha retuning inside 0.02:0.2 (step 0.05, probe rate 1.0) and a
   fresh controller replaying its telemetry on a cold store: the same
   records, weights and alpha trajectory. Card seconds and documents/s
   (host clock, synchronised) are reported apart from the simulated
   node-second clocks. B: ``serve.main`` with the campaign flags
   (``--variant ft --docs 1200 --nodes 4 --adaptive-rounds 3`` ...) on
   cuda, with the cpu run in a child process beside it: equal metric
   dicts and report lines, and the two result stores hold the same
   entries. fast_features, budget_route and ngram_score must launch.
8. fleet: the same router and documents on real worker processes, each
   with its own CUDA context on the one card (no MPS: they time-slice
   it). F1: 4 workers (``runtime="process"``, shm transport, prefetch
   2, probe rate 0.5, a disk store, 3 controller rounds); F2: F1 over
   the pickle transport; F2p: F2 with pools cpu:3,gpu:1, so every
   routed prepare is forwarded from card to card through the
   coordinator; F3: a crash (``crash_after``) and a flap (mute, then
   unmute) on 2 workers over the first 1,024 documents, their heartbeat
   timeouts chosen from F1's measured batch time (the flap's slowdown
   outlasts the largest deadline its window can grant by one more
   timeout); F4: 4 loopback TCP fabric workers, then an elastic fabric
   controller with one join and one crash. Records must equal A1's (or
   its first 1,024 documents'), every document counted once, something
   re-issued in F3 and F4's elastic run, and no /dev/shm entry left.
   Each worker's launches of the three kernels and its peak memory come
   from the worker's own metric snapshot (the gauges it ships when
   tracing is on), never from this process's counters, which must not
   move; each worker must launch fast_features and budget_route, and
   the workers ngram_score at least once per probed batch. The shm and
   inline payload counts are printed (F1 must carry all by shm, F2 all
   inline). F5: ``serve --workers 2`` and ``serve --fabric-workers 2``
   with the ``campaign`` phase's serve flags on cuda and on cpu, all
   four at once in child processes but one: equal metric dicts and
   report lines but for what they measure (wall, documents/s, busy, the
   adaptive weights that follow the measured clocks, and
   ``throughput_docs_per_node_s``), and equal result stores.
9. scenarios: the scenario lab's eight scenarios (``run_scenario`` on
   cuda: the local, process and fabric runtimes, each over its spec's
   150-document corpus and an ft router trained on its first half; each
   holds its records to its single-node reference), with each one's
   seconds, goodput, re-issues, duplicates dropped, cache hits and
   misses, and whether the elastic joiner served a batch (it must);
   ``serve --scenario bursty_arrivals`` on cuda beside cpu, equal but for
   the goodput; ``serve --workers 2 --status-interval 0.5`` on cuda at
   2,400 documents, which must print the live status line.
10. autotune: every candidate of the three main-path kernels' launch
   knobs (fast_features and ngram_score threads a block, budget_route
   rows a block of its grid) at the path's shapes and at route_64k:
   bit-equal to the default launch, held against the plain version, with
   its ``ms_device`` and the fastest; then a 2-worker process fleet over
   one ``tuning_dir`` with the ``campaign`` phase's router and documents,
   twice: the cold fleet sweeps and publishes a fast_features key for
   this card, the warm one sweeps nothing and leaves the store's bytes
   as they were, and both record sets equal A1's.
11. lm: the full-width bf16 ``qwen3-1.7b`` (28 layers, d=2048, random
   weights from a seeded CUDA generator) with
   ``attention_impl="pallas"``: ``prefill`` of B=4 x S=4096 seeded tokens
   (``prefill_32k`` is batch 32 x 32768; cut to fit one card and the
   run's time), then 16 greedy ``decode_step``s on the cache padded to
   S+16. flash_attention must launch once per layer; the logits must be
   finite and within 2e-2 relative L2 of a naive-attention prefill (last
   position) and of ``lm_logits`` over the S+1 tokens (first decode step).
   Also reported: both bf16 prefills against one computed in float32
   (the model's bf16 noise floor), and a torch.profiler pass over a
   prefill and two decode steps (device busy share, top kernels).
12. lm_small_parity: the reduced f32 qwen3-tiny and danube-tiny (window
   32) run ``prefill`` and ``decode_step`` on cuda (the kernel) and on
   cpu (the plain version); the logits must agree within 2e-5.
13. lm_train: the full-width bf16 ``qwen3-1.7b`` as registered (28
   layers, d=2048, untied head, remat, ``xla_flash`` attention with
   chunks of 512 and 1024; random weights from a seeded CUDA generator)
   trained through ``launch.specs.lm_train_step`` with
   ``chain_clip(adamw(3e-4, 0.1), 1.0)`` on ``_lm_train_batch`` batches
   of 2 x 4096 (``train_4k`` is global batch 256 x 4096; cut to one
   card): one warm-up step and 3 timed steps (seeds 1-4): ms a step,
   tokens/s, peak GB, the losses, model TFLOP/s (6 x matmul params x
   tokens plus 3 x the causal attention) against 989 TFLOP/s bf16, and a
   torch.profiler pass over one step (busy share, top kernels,
   ``cudaLaunchKernel`` calls). Holds: finite losses, the first within
   2.0 of ln V and within 1e-2 relative of a no-grad float32 forward of
   the same params and batch, every parameter leaf moved by the first
   step, and no flash_attention launch (training attends through
   ``xla_flash``, as the JAX package trains).
14. lm_train_small_parity: the reduced f32 qwen3-tiny (chunks 16/32, so
   ``xla_flash`` and its backward run) from one exported init, 5 steps
   on cuda and on cpu (losses within rtol 1e-5, params within 1e-4) and
   twice on cuda (bit-equal); ``launch.train.main`` on cuda, 6 steps
   against 3, a checkpoint and a resume to 6 (losses and final state
   bit-equal), the cuda checkpoint restored on the cpu bit for bit;
   Adafactor and ``compressed_gradients`` (int8, top-k) on cuda against
   cpu over 20 steps, within 1e-6.
15. lm_moe: the full-width bf16 ``olmoe-1b-7b`` as registered (16
   layers, d=2048, 64 experts top-8, 6,919,100,416 params, random
   weights drawn on the card) with ``attention_impl="pallas"``:
   ``prefill`` of B=4 x S=4096 (``prefill_32k`` is 32 x 32768, whose KV
   cache alone is 137.4 GB), then 16 decode steps. Holds: the param
   count, 16 flash_attention launches, finite logits, two prefills and
   two decode runs bit-equal; layer 0's MoE on 1,024 of its real bf16
   inputs on the card against the port's float32 computation on the
   cpu from the same weights: equal routing (expert sets, kept slots)
   but for flips at a float32 probability gap below 1e-4, outputs
   within 2e-2 relative L2. Reports prefill s, tokens/s and model
   TFLOP/s (2 x active params x tokens), decode ms a step, peak GB, the
   share of routed slots dropped by the capacity in each layer, the
   naive-attention prefill's relative L2 and routing flips per layer,
   and a torch.profiler split of one prefill's device time: expert
   products, dispatch and combine (the ``moe.*`` ranges), flash_attention
   and the rest.
16. lm_moe_small_parity: the reduced f32 olmoe-tiny and grok-tiny on
   cuda against cpu: prefill, 4 decode steps and ``lm_logits`` with its
   aux within 2e-5; 5 ``lm_train_step``s (AdamW for OLMoE, Adafactor
   for grok) within 2e-5 on the losses and 1e-4 on the params, and two
   cuda trainings bit-equal; the budget router (duplicated tokens that
   tie) with equal token choices and outputs within 2e-5.
17. lm_phi3: the full-width bf16 ``phi3-medium-14b`` (40 layers,
   d=5120, H 40 / Hk 10, 14,659,507,200 params) with
   ``attention_impl="pallas"``: prefill of B=4 x S=4096 and 4 decode
   steps; 40 flash_attention launches; reported: the prefill's
   relative L2 to a naive-attention prefill (run one sequence at a
   time: at B=4 its float32 scores do not fit beside the weights) and
   the first decode step's to ``lm_logits``, the dense phase's two bars,
   which at 40 layers sit at the bf16 noise of the random-weight model;
   held, on sequence 0 against the model computed in float32: the
   kernel's bf16 prefill no further from it than the naive one (within
   10%), and the float32 first decode step within 1e-3 of the float32
   full forward; prefill s and peak GB (the init's too: it draws the
   largest stacked leaf in float32).
18. recsys: ``recsys_scores`` of the full-width bf16 ``dlrm-mlperf``
   (the 187,767,808 x 128 table, 48.07 GB, drawn in place from a seeded
   CUDA generator) at ``serve_p99`` (batch 512) and ``serve_bulk`` (batch
   262,144), batches from ``launch.specs._recsys_batch`` (seed 0):
   wall ms per forward, exactly one embedding_bag launch per forward,
   finite scores in (0, 1) bit-equal to a forward whose lookup is a
   plain ``index_select``, peak memory, and a torch.profiler pass over
   one ``serve_bulk`` forward.
19. recsys_small_parity: the reduced f32 dlrm-tiny on cuda against cpu,
   scores within 2e-5.
20. gnn: ``segment_matmul(x, src, dst, w, n_nodes)`` at ``ogb_products``
   (uniform random edges from a seeded CUDA generator, d_out 128, f32):
   a torch.profiler pass over the first (cold, uncounted) step at full
   size, then wall ms of a warm step and of its argsort, gather and
   kernel, one segment_mm launch, the kernel within rtol = atol = 1e-5
   of the plain version, two runs bit-identical, and a torch.profiler
   pass over a warm step.

The phases free the card's memory between them: the DLRM table and the
GNN step's ~60 GB (with its plain version) do not fit together.

The line before the last is the per-kernel JSON summary; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12         # H100 SXM non-tensor FP32 peak, used for
#                                  the n-gram kernel's integer compares
#                                  and for float32 attention
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
ALPHA = 0.05
SEED = 0
DEVICE = "cuda"
GNN_D_OUT = 128                  # equiformer-v2's d_hidden (the repo's GNN)


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one ``fn()`` call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def synced(fn):
    """(``fn()``, host-clock seconds of the call), synchronised with the
    card before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def small_kernel_times(launch, grids, dev) -> dict:
    """Rows 1-3: the back-to-back device time, the profiler's kernel time
    and the empty-kernel floor at the same grids."""
    from repro_torch.launch.kernel_timing import (device_ms, empty_ms,
                                                  profiled_ms)

    prof = profiled_ms(launch)
    return {"ms_device": device_ms(launch), "profiler_ms": prof["ms"],
            "profiler_kernels": prof["kernels"], **empty_ms(grids, dev)}


def bound(bytes_moved: float, ops: float = 0.0,
          ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- phase 1


def corpus_batch(n_docs: int):
    """The cheap parser's output on a seeded corpus: the prepare stage's
    real input."""
    import numpy as np

    from repro_torch.core import parsers as P
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus

    ccfg = CorpusConfig(n_docs=n_docs, seed=SEED)
    docs = generate_corpus(ccfg)
    pages = P.run_parser_batch(P.CHEAP_PARSER, docs, ccfg,
                               np.random.RandomState(SEED))
    return ccfg, docs, pages


def check_fast_features(ccfg, pages, dev) -> list[dict]:
    import torch

    from repro_torch.data.synthetic import MANGLED, SCRAMBLE, WS
    from repro_torch.kernels.fast_features import ops, ref

    rows = []
    for max_len in (0, 512):
        packed = ops.pack_routing_batch(pages, max_len=max_len)

        def t(a):
            return torch.from_numpy(a.astype("int32")).to(dev)

        ins = (t(packed.tok_matrix), t(packed.n_tok), t(packed.first_len),
               t(packed.n_pages), t(packed.n_empty))
        kw = dict(max_len=max_len, ws=WS, scramble=SCRAMBLE,
                  mangled=MANGLED, latex_lo=ccfg.latex_lo,
                  ident_lo=ccfg.ident_lo, vocab_size=ccfg.vocab_size)
        got = ops.fast_features(*ins, **kw)
        want = ref.fast_features_ref(*ins, **kw)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        # tolerance: 1e-6 on the features (the JAX kernel's own bar);
        # tokens and mask exact
        assert err <= 1e-6, f"fast_features max_len={max_len}: {err}"
        if max_len:
            assert torch.equal(got[1], want[1]), "fast_features toks"
            assert torch.equal(got[2], want[2]), "fast_features mask"
        # a token outside [0, vocab_size) must raise through the flag
        bad = ins[0].clone()
        bad[int(torch.nonzero(ins[1])[0]), 0] = ccfg.vocab_size
        try:
            ops.fast_features(bad, *ins[1:], **kw)
        except ValueError:
            pass
        else:
            raise AssertionError("fast_features accepted an id >= vocab")
        n = len(pages)
        fast = torch.empty((n, 8), dtype=torch.float32, device=dev)
        toks = mask = None
        if max_len:
            toks = torch.empty((n, max_len), dtype=torch.int32, device=dev)
            mask = torch.empty((n, max_len), dtype=torch.float32,
                               device=dev)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        def launch():
            ops._launch(*ins, fast, toks, mask, flag, bos=1, **kw)

        ms = time_ms(launch)
        times = small_kernel_times(launch, ops.launch_grid(n), dev)
        plain_ms = time_ms(lambda: ref.fast_features_ref(*ins, **kw))
        # data-dependent bytes: each valid token read once, 4 per-doc
        # scalars, the features and the token/mask pair written once
        nbytes = (4 * int(packed.n_tok.sum()) + 16 * n + 32 * n
                  + 8 * n * max_len)
        b_ms, b_by = bound(nbytes)
        rows.append(dict(name="fast_features", shape=dict(
            n=n, width=packed.width, max_len=max_len), max_abs_err=err,
            ms=ms, **times, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_budget_route(dev) -> list[dict]:
    import torch

    from repro_torch.kernels.budget_route import ops, ref
    from repro_torch.launch.kernel_timing import profiled_ms

    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for n in (256, 65536):
        d = 512
        # scores on a 0.25 grid: many ties at tau, the rule's hard case
        scores = torch.round(torch.randn(n, generator=g, device=dev) * 4) / 4
        tokens = torch.randint(0, 10000, (n, d), generator=g,
                               dtype=torch.int32, device=dev)
        cap = ops.capacity_floor(ALPHA, n)
        tau = ops.route_tau(scores, cap)
        got = ops.budget_route_kernel(scores, tokens, tau, capacity=cap)
        want = ref.budget_route_ref(scores, tokens, tau[0], capacity=cap)
        torch.cuda.synchronize()
        # tolerance: exact (idx, count and the routed rows)
        assert torch.equal(got[1], want[1]), f"budget_route idx n={n}"
        assert int(got[2]) == int(want[2]), f"budget_route count n={n}"
        assert torch.equal(got[0], want[0]), f"budget_route rows n={n}"
        # the preallocated path: one launch writes every element
        out = torch.full((cap, d), 0x5A5A5A5A, dtype=torch.int32,
                         device=dev)
        idx = torch.full((cap,), 0x5A5A5A5A, dtype=torch.int32, device=dev)
        count = torch.full((1,), -1, dtype=torch.int32, device=dev)
        scratch = torch.empty(ops.scratch_ints(ops.launch_grid(n, dev)[0][0]),
                              dtype=torch.int32, device=dev)

        def launch():
            ops._launch(scores, tokens, tau, out, idx, count, capacity=cap,
                        scratch=scratch)

        launch()
        torch.cuda.synchronize()
        assert torch.equal(idx, want[1]) and torch.equal(out, want[0]) \
            and int(count) == int(want[2]), f"budget_route prealloc n={n}"
        ms = time_ms(launch)
        times = small_kernel_times(launch, ops.launch_grid(n, dev), dev)
        plain_ms = time_ms(lambda: ref.budget_route_ref(
            scores, tokens, tau[0], capacity=cap))
        kept = int(want[2])
        nbytes = 4 * n + 4 + 2 * 4 * d * kept + 4 * cap + 4
        b_ms, b_by = bound(nbytes)
        row = dict(name="budget_route", shape=dict(n=n, d=d, capacity=cap),
                   grid=ops.launch_grid(n, dev), max_abs_err=0.0, ms=ms, **times,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if n == 256:
            # the whole op (route_tau, allocations, kernel): device
            # launches and device time a call
            op = profiled_ms(lambda: ops.budget_route(scores, tokens, ALPHA))
            row["op_profile"] = {"launches": op["launches"],
                                 "device_ms": op["ms"],
                                 "kernels": op["kernels"]}
        rows.append(row)
    return rows


def check_ngram_score(docs, pages_by_parser, dev) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.kernels.ngram_score import ops, ref

    rows = []
    refs = [d.full_text() for d in docs]
    hyps = []
    for outs in pages_by_parser:
        hyps += [np.concatenate(o) if sum(map(len, o))
                 else np.zeros(0, np.int32) for o in outs]
    for b in (64, 256):
        L = 256
        ra, rl = M._pad_batch((refs * 2)[:b], L)
        ha, hl = M._pad_batch(hyps[:b], L)
        ins = [torch.from_numpy(x).to(dev) for x in (ra, ha, rl, hl)]
        got = ops.ngram_bleu(*ins).double()
        want = ref.ngram_bleu_ref(*ins)
        torch.cuda.synchronize()
        # tolerance: the f32 kernel against the float64 plain version,
        # atol 1e-6 and rtol 1e-5 (the JAX kernel's own bar)
        diff = (got - want).abs()
        assert bool((diff <= 1e-6 + 1e-5 * want.abs()).all()), \
            f"ngram_score B={b}: max err {diff.max().item()}"
        out = torch.empty(b, dtype=torch.float32, device=dev)
        def launch():
            ops._launch(*ins, out, max_n=4)

        ms = time_ms(launch)
        times = small_kernel_times(launch, ops.launch_grid(b, L), dev)
        plain_ms = time_ms(lambda: ref.ngram_bleu_ref(*ins))
        lr = rl.astype(np.int64)
        lh = hl.astype(np.int64)
        pairs = float((lh * lr + lh * (lh - 1) // 2).sum())
        b_ms, b_by = bound(2 * 4 * b * L + 8 * b + 4 * b, ops=pairs)
        rows.append(dict(name="ngram_score", shape=dict(b=b, L=L),
                         max_abs_err=diff.max().item(), ms=ms, **times,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=pairs))
    return rows


def ngram_edge_cases():
    """(name, B, L, vocab, max_n, ref lengths, hyp lengths): every token
    equal (the longest matches, the most clipping), an L that is not a
    multiple of 32 with lengths 0, 1 and L, every order from 1 to 8, and
    an L at the wrapper's limit (the shared-memory attribute path)."""
    from repro_torch.kernels.ngram_score.ops import MAX_LEN

    return ([("all_equal", 3, 256, 1, n, [256, 255, 100], [256, 100, 255])
             for n in (4, 8)]
            + [("ragged_L", 6, 300, 5, 4, [0, 1, 300, 299, 31, 33],
                [300, 0, 1, 300, 33, 31])]
            + [("max_n", 4, 100, 4, n, [100, 99, 7, 64], [100, 64, 99, 8])
               for n in range(1, 9)]
            + [("near_limit", 2, MAX_LEN, 50, 4, [MAX_LEN, MAX_LEN - 7],
                [MAX_LEN - 3, MAX_LEN])])


def ngram_edge_inputs(case, dev):
    """Seeded (ref, hyp, ref_len, hyp_len) of one edge case on ``dev``,
    padded with -1 past each length."""
    import numpy as np
    import torch

    _, b, L, vocab, _, lr, lh = case
    rng = np.random.RandomState(L + vocab)
    ref = rng.randint(0, vocab, (b, L)).astype(np.int32) + 7
    hyp = rng.randint(0, vocab, (b, L)).astype(np.int32) + 7
    lr, lh = np.array(lr, np.int32), np.array(lh, np.int32)
    pos = np.arange(L)
    ref[pos[None] >= lr[:, None]] = -1
    hyp[pos[None] >= lh[:, None]] = -1
    return [torch.from_numpy(x).to(dev) for x in (ref, hyp, lr, lh)]


def ff_edge_cases():
    """(name, n, width, max_len, token choice, n_tok): one repeated
    token in every slot (every lane of a warp on one bitmap word), only
    ids 0 and vocab - 1, widths 128 and 4096, n_tok 0, one document."""
    return [("one_token", 4, 4096, 512, "ws", [4096, 4095, 1, 0]),
            ("extreme_ids", 3, 4096, 512, "ends", [4096, 3000, 17]),
            ("width_128", 5, 128, 0, "any", [0, 1, 127, 128, 64]),
            ("width_128_first_page", 3, 128, 128, "any", [128, 5, 0]),
            ("one_doc", 1, 4096, 512, "any", [3333])]


def ff_edge_inputs(case, vocab: int, ws: int, dev):
    """Seeded (tok, n_tok, first_len, n_pages, n_empty) of one edge case
    on ``dev``; slots past n_tok hold -1, which must never count."""
    import numpy as np
    import torch

    _, n, width, _, choice, nt = case
    rng = np.random.RandomState(width + n)
    if choice == "ws":
        tok = np.full((n, width), ws, np.int32)
    elif choice == "ends":
        tok = rng.choice([0, vocab - 1], (n, width)).astype(np.int32)
    else:
        tok = rng.randint(0, vocab, (n, width)).astype(np.int32)
    nt = np.array(nt, np.int32)
    tok[np.arange(width)[None] >= nt[:, None]] = -1
    first = np.array([rng.randint(0, t + 1) for t in nt], np.int32)
    pages = rng.randint(0, 9, n).astype(np.int32)
    empty = np.array([rng.randint(0, p + 1) for p in pages], np.int32)
    return [torch.from_numpy(x).to(dev) for x in (tok, nt, first, pages,
                                                  empty)]


# (N, D, alpha, case) of budget_route's edge cases: one row; both sides
# of 1024 and 4096 rows (one block); a grid of several chunks a block on
# a 132-SM card; "few_positive": three positive scores, so count <
# capacity; "misaligned": views whose base pointers are not 16-byte
# aligned; "ties": all equal but one; "nonfinite": NaNs of both signs
# and infinities (at alpha 0.1 tau is a NaN and keeps nothing).
ROUTE_EDGES = (
    (1, 4, 1.0, "grid"), (1024, 8, 0.3, "grid"), (1025, 8, 0.05, "grid"),
    (4096, 12, 0.5, "grid"), (4097, 8, 0.05, "grid"),
    (1 << 20, 4, 0.05, "grid"), (256, 512, 0.05, "few_positive"),
    (65536, 8, 0.05, "few_positive"), (1025, 7, 0.1, "misaligned"),
    (5000, 8, 0.1, "misaligned"), (70000, 4, 0.05, "ties"),
    (4097, 8, 0.1, "nonfinite"), (65536, 8, 0.05, "nonfinite"))


def route_edge_inputs(n, d, case, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(n)
    scores = torch.round(torch.randn(n + 1, generator=g, device=dev) * 3) / 3
    scores = scores[1:] if case == "misaligned" else scores[:n]
    if case == "ties":
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


def phase_kernel_edge_cases(dev) -> None:
    """The redesigned ngram_score, fast_features and budget_route kernels
    against their plain versions on the adversarial cases, with the main
    rows' tolerances (budget_route exact, launched into garbage)."""
    import torch

    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.budget_route.ref import budget_route_ref

    from repro_torch.data.synthetic import MANGLED, SCRAMBLE, WS
    from repro_torch.kernels.fast_features import ops as ff
    from repro_torch.kernels.fast_features.ref import fast_features_ref
    from repro_torch.kernels.ngram_score import ops as ng
    from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref

    out = {}
    for case in ngram_edge_cases():
        ins = ngram_edge_inputs(case, dev)
        got = ng.ngram_bleu(*ins, max_n=case[4]).double()
        want = ngram_bleu_ref(*ins, max_n=case[4])
        diff = (got - want).abs()
        name = f"ngram_score/{case[0]}/L{case[2]}/max_n{case[4]}"
        assert bool((diff <= 1e-6 + 1e-5 * want.abs()).all()), \
            f"{name}: max err {diff.max().item()}"
        assert bool((got[ins[3] == 0] == 0).all()), f"{name}: empty hyp"
        out[name] = diff.max().item()
        del ins, got, want, diff
        free_cuda()
    vocab = 10000
    for case in ff_edge_cases():
        ins = ff_edge_inputs(case, vocab, WS, dev)
        kw = dict(max_len=case[3], ws=WS, scramble=SCRAMBLE, mangled=MANGLED,
                  latex_lo=8010, ident_lo=8510, vocab_size=vocab)
        got = ff.fast_features(*ins, **kw)
        want = fast_features_ref(*ins, **kw)
        name = f"fast_features/{case[0]}/w{case[2]}/max_len{case[3]}"
        err = (got[0] - want[0]).abs().max().item()
        assert err <= 1e-6, f"{name}: {err}"
        if case[3]:
            assert torch.equal(got[1], want[1]), f"{name}: toks"
            assert torch.equal(got[2], want[2]), f"{name}: mask"
        out[name] = err
    for n, d, alpha, case in ROUTE_EDGES:
        scores, tokens = route_edge_inputs(n, d, case, dev)
        cap = br.capacity_floor(alpha, n)
        tau = br.route_tau(scores, cap)
        want = budget_route_ref(scores, tokens, tau[0], capacity=cap)
        got = [torch.full((cap, d), 0x5A5A5A5A, dtype=torch.int32,
                          device=dev),
               torch.full((cap,), 0x5A5A5A5A, dtype=torch.int32, device=dev),
               torch.full((1,), -1, dtype=torch.int32, device=dev)]
        br._launch(scores, tokens, tau, *got, capacity=cap)
        name = f"budget_route/{case}/n{n}/d{d}"
        assert torch.equal(got[1], want[1]) and int(got[2]) == int(
            want[2]) and torch.equal(got[0], want[0]), name
        if case == "few_positive":
            assert 0 < int(want[2]) < cap, name
        out[name] = 0.0
        del scores, tokens, want, got
    emit({"phase": "kernel_edge_cases", "max_abs_err": out})


def f32_scores(vals, dev):
    """float32 scores on ``dev``; the string "-nan" is the negative quiet
    NaN 0xFFC00000."""
    import numpy as np
    import torch

    a = np.array([0.0 if v == "-nan" else v for v in vals], np.float32)
    a.view(np.uint32)[[v == "-nan" for v in vals]] = 0xFFC00000
    return torch.from_numpy(a).to(dev)


# The JAX package's answers on the CPU (jax 0.9.0), written in because
# the card has no JAX: (scores, alpha, require_positive, idx, count).
# lax.top_k ranks a negative NaN below -inf; XLA flushes subnormals to
# zero when it compares, so 0.0 and 1e-38 tie at a tau of 1e-38.
ROUTE_PROBES = (
    (("-nan", 1.0, 0.5, 0.2), 0.5, True, [1, 2], 2),
    ((0.0, 1e-38, -1.0, -2.0), 0.25, False, [0], 1),
    ((-0.0, 0.0, 1e-39, -1.0), 0.25, False, [0], 1),
)


def phase_routing_parity(dev) -> None:
    """The NaN-order and subnormal probes through the CUDA budget_route
    and budget_topk on the card, against the JAX package's answers."""
    import torch

    from repro_torch.core import scheduler
    from repro_torch.kernels.budget_route import ops

    out = []
    for vals, alpha, positive, want_idx, want_count in ROUTE_PROBES:
        scores = f32_scores(vals, dev)
        tokens = torch.arange(4 * len(vals), dtype=torch.int32,
                              device=dev).reshape(-1, 4)
        before = ops.KERNEL.launches
        rows, idx, count = ops.budget_route(scores, tokens, alpha,
                                            require_positive=positive)
        assert ops.KERNEL.launches == before + 1
        got = (idx.tolist(), int(count))
        assert got == (want_idx, want_count), (vals, alpha, got)
        assert rows[:want_count].equal(tokens[[i for i in want_idx
                                               if i >= 0]])
        out.append({"scores": [str(v) for v in vals], "alpha": alpha,
                    "require_positive": positive, "idx": got[0],
                    "count": got[1]})
    mask, idx = scheduler.budget_topk(f32_scores((1e-38, -1.0, -2.0, -3.0),
                                                 dev), 0.5)
    assert not bool(mask.any()) and idx.tolist() == [0, 1], (mask, idx)
    emit({"phase": "routing_parity", "budget_route": out,
          "budget_topk_subnormal_mask": mask.tolist(),
          "equal_to_jax": True})


# (row name, B, S, H, Hk, D, window, dtype, tolerance, max abs error
# limit): causal, Sq = Skv. The qwen3 and danube rows' limit, 4e-3, is
# one bf16 ulp at |o| in [0.5, 1): the bf16 rounding of the float32-p
# result, which the tensor-core body keeps by splitting p; rounding p
# once to bf16 misses it (the control below). Every bf16 row is also
# held elementwise against the float32 result before its rounding
# (FLASH_ROUNDING_LIMIT), which scales with |o|.
FLASH_ROWS = (
    ("qwen3_prefill_bf16", 4, 4096, 16, 8, 128, None, "bfloat16", 2e-2,
     4e-3),
    ("danube_prefill_bf16", 1, 8192, 32, 8, 120, 4096, "bfloat16", 2e-2,
     4e-3),
    ("qwen3_prefill_f32", 4, 4096, 16, 8, 128, None, "float32", 2e-5,
     None),
    ("olmoe_prefill_bf16", 4, 4096, 16, 16, 128, None, "bfloat16", 2e-2,
     None),
    ("phi3_prefill_bf16", 4, 4096, 40, 10, 128, None, "bfloat16", 2e-2,
     None),
)


#: The bf16 rows' design limit on |got - o32| / ulp(max(|o32|, 0.5)),
#: o32 the plain version's float32 result: correct rounding reads at
#: most 0.5, and 1/16 ulp is left for the body's float32 arithmetic
#: (split p, another summation order), far above its error (about 1e-5
#: of |o|) and below what rounding p once to bf16 adds (the control).
FLASH_ROUNDING_LIMIT = 0.5 + 1 / 16


def bf16_ulp(x):
    """One bf16 ulp at each element of the float32 ``x`` (normal
    numbers): 2 ** (exponent - 7) with |x| in [2 ** exponent, 2 **
    (exponent + 1))."""
    import torch

    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def rounding_excess(got, want32) -> float:
    """max |got - want32| / ulp(max(|want32|, 0.5)) over the elements:
    how far the bf16 ``got`` is from the float32 ``want32``, in bf16
    ulps of |want32| floored at 0.5 (one ulp there is 2 ** -8, the
    absolute floor near o = 0)."""
    return float(((got.float() - want32).abs()
                  / bf16_ulp(want32.abs().clamp_min(0.5))).max())


def visible_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal, optionally windowed, S x S attention
    computes."""
    return sum(min(q + 1, window or q + 1) for q in range(s))


def flash_bf16_p_control(q, k, v, *, causal, window):
    """The design the bf16 body must not take, as the control of its max
    abs error limit: the plain version with the unnormalised
    p = exp(s - max) rounded once to bf16 before P V, as a kernel that
    feeds p to the tensor cores in bf16 does; float32 otherwise."""
    import torch

    b, sq, h, d = q.shape
    _, skv, hk, _ = k.shape
    qg = q.reshape(b, sq, hk, h // hk, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (b, q, h, g, 1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.bfloat16().float(), v.float())
    return (o / l).reshape(b, sq, h, d).to(q.dtype)


def check_flash_attention(dev) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.kernel_timing import device_ms

    rows = []
    for name, b, s, h, hk, d, window, dtype, tol, max_err in FLASH_ROWS:
        dt = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
        kw = dict(causal=True, window=window)
        got = ops.flash_attention(q, k, v, **kw).float()
        # the plain version in float32 (exact from bf16 inputs), and its
        # rounding to the row's dtype: what the plain version returns
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw)
        want = want32.to(dt).float()
        torch.cuda.synchronize()
        # tolerance: atol = rtol = 2e-2 in bf16, 2e-5 in f32 (the JAX
        # kernel's bar, tests/test_kernels.py)
        diff = (got - want).abs()
        assert bool((diff <= tol + tol * want.abs()).all()), \
            f"flash_attention {name}: max err {diff.max().item()}"
        err = diff.max().item()
        ctl_err = excess = ctl_excess = None
        if dt == torch.bfloat16:
            ctl = flash_bf16_p_control(q, k, v, **kw)
            ctl_err = (ctl.float() - want).abs().max().item()
            excess = rounding_excess(got, want32)
            ctl_excess = rounding_excess(ctl, want32)
            del ctl
            assert excess <= FLASH_ROUNDING_LIMIT < ctl_excess, (
                f"flash_attention {name}: {excess} ulp from the float32 "
                f"result, limit {FLASH_ROUNDING_LIMIT}, bf16-p control "
                f"{ctl_excess}")
        if max_err is not None:
            assert err <= max_err < ctl_err, (
                f"flash_attention {name}: max abs err {err}, limit "
                f"{max_err}, bf16-p control {ctl_err}")
        # the yardstick: PyTorch's fused attention on the same tensors,
        # in its (B, H, S, D) layout (views, no copies)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib_kw = dict(is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            dist = pos[:, None] - pos[None, :]
            lib_kw = dict(attn_mask=(dist >= 0) & (dist < window))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **lib_kw)

        lib_err = (library().transpose(1, 2).float() - want).abs().max().item()
        del got, want, want32, diff
        out = torch.empty_like(q)
        ms = time_ms(lambda: ops._launch(q, k, v, out, **kw), reps=10,
                     warmup=2)
        ms_device = device_ms(lambda: ops._launch(q, k, v, out, **kw))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                           reps=3, warmup=1)
        library_ms = time_ms(library, reps=10, warmup=2)
        # 4 D operations (QK and PV multiply-adds) per visible pair and
        # head; q, k, v read once and the output written once
        n_ops = 4 * d * visible_pairs(s, window) * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, n_ops, BF16_OPS_PER_S
                           if dt == torch.bfloat16 else SCALAR_OPS_PER_S)
        rows.append(dict(name="flash_attention", row=name, shape=dict(
            b=b, s=s, h=h, hk=hk, d=d, window=window, dtype=dtype),
            tolerance=tol, max_abs_err=err, max_abs_err_limit=max_err,
            bf16_p_control_max_abs_err=ctl_err,
            rounding_excess_ulp=excess,
            rounding_excess_limit=(FLASH_ROUNDING_LIMIT
                                   if excess is not None else None),
            bf16_p_control_rounding_excess_ulp=ctl_excess,
            library_max_abs_err=lib_err,
            ms=ms, ms_device=ms_device, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, ops=n_ops,
            bytes=nbytes))
        del q, k, v, out
        torch.cuda.empty_cache()
    return rows


def free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def dlrm_lookup_ids(cfg, b: int, dev):
    """The serve batch's concatenated-table ids as ``lookup_fields``
    hands them to the kernel: (b * 26, 1) int32 bags of one."""
    import torch

    from repro_torch.launch.specs import _recsys_batch
    from repro_torch.models.recsys import embedding as E

    sparse = _recsys_batch(cfg, b, seed=SEED, device=dev)["sparse"]
    offs = torch.from_numpy(E.table_offsets(cfg.vocab_sizes)[0]
                            .astype("int32")).to(dev)
    return (sparse + offs[None, :]).reshape(-1, 1)


def check_embedding_bag(dev) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch.kernel_timing import device_ms
    from repro_torch.models.recsys import embedding as E

    rows = []
    arch = get_config("dlrm-mlperf")
    cfg = arch.model
    bulk = arch.shape("serve_bulk")["batch"]
    # (row, table rows, D, dtype, bags, bag length, combiner, tolerance)
    shapes = (("dlrm_serve_bulk", None, cfg.embed_dim, "bfloat16",
               bulk * cfg.n_sparse, 1, "sum", 0.0),
              ("bench_sum", 100_000, 64, "float32", 4096, 16, "sum", 2e-5),
              ("bench_mean", 100_000, 64, "float32", 4096, 16, "mean", 2e-5))
    for name, r, d, dtype, b, bag, comb, tol in shapes:
        dt = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(SEED)
        if r is None:       # the full 48.07 GB bf16 DLRM table
            table, _ = E.init_table(cfg.vocab_sizes, d, dt, g, dev)
            ids = dlrm_lookup_ids(cfg, bulk, dev)
            weights = None
            w_plain = torch.ones(ids.shape, dtype=torch.float32, device=dev)
        else:
            table = torch.randn((r, d), generator=g, device=dev).to(dt)
            ids = torch.randint(0, r, (b, bag), generator=g, device=dev)
            weights = w_plain = torch.rand((b, bag), generator=g, device=dev)
        got = ops.embedding_bag(table, ids, weights, combiner=comb)
        want = ref.embedding_bag_ref(table, ids, w_plain, combiner=comb)
        torch.cuda.synchronize()
        # tolerance: bit-equal for bags of one (one f32 product by 1.0,
        # narrowed back); atol = rtol = 2e-5 in f32 for bags of 16 (the
        # JAX kernel's bar; another summation order in the mean's sum(w))
        if tol == 0.0:
            assert torch.equal(got, want), f"embedding_bag {name}"
            err = 0.0
        else:
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= tol + tol * want.float().abs()).all()), \
                f"embedding_bag {name}: max err {diff.max().item()}"
            err = diff.max().item()
        del got, want
        lib_ms = None
        if weights is None:    # the path's unweighted bags of one
            lib_ms = time_ms(lambda: F.embedding_bag(ids, table, mode="sum"),
                             reps=10, warmup=2)
        elif comb == "sum":    # per_sample_weights is for mode="sum" only
            lib_w = weights.to(dt)
            lib_ms = time_ms(lambda: F.embedding_bag(
                ids, table, mode="sum", per_sample_weights=lib_w),
                reps=10, warmup=2)
            del lib_w
        out = torch.empty((ids.shape[0], d), dtype=dt, device=dev)
        def launch():
            ops._launch(table, ids, weights, out, combiner=comb)

        ms = time_ms(launch)
        ms_device = device_ms(launch)
        plain_ms = time_ms(lambda: ref.embedding_bag_ref(
            table, ids, w_plain, combiner=comb), reps=5, warmup=1)
        # each looked-up row read once, each bag written once, the ids
        # (and the weights, where given) read once
        nbytes = (ids.numel() * d * table.element_size()
                  + ids.shape[0] * d * table.element_size()
                  + ids.numel() * ids.element_size()
                  + (weights.numel() * 4 if weights is not None else 0))
        b_ms, b_by = bound(nbytes)
        rows.append(dict(name="embedding_bag", row=name, shape=dict(
            table_rows=table.shape[0], d=d, dtype=dtype, bags=ids.shape[0],
            bag=ids.shape[1], combiner=comb), tolerance=tol,
            max_abs_err=err, ms=ms, ms_device=ms_device, plain_ms=plain_ms,
            library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        del table, ids, weights, w_plain, out
        free_cuda()
    return rows


def gnn_inputs(dev):
    """ogb_products at the GNN config's width: x (N, 100), W (100, 128)
    scaled by 100^-0.5, uniform src and dst (int64), all float32, from a
    seeded CUDA generator."""
    import torch

    from repro_torch.configs.base import GNN_SHAPES

    shp = next(s for s in GNN_SHAPES if s.name == "ogb_products")
    n, e, d_in = shp["n_nodes"], shp["n_edges"], shp["d_feat"]
    d_out = GNN_D_OUT
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, d_in), generator=g, device=dev)
    w = torch.randn((d_in, d_out), generator=g, device=dev) * d_in ** -0.5
    src = torch.randint(0, n, (e,), generator=g, device=dev)
    dst = torch.randint(0, n, (e,), generator=g, device=dev)
    return x, src, dst, w


def compare_segment_mm(out, xg, w, dsorted, n_nodes) -> dict:
    """``out`` against ``ref.segment_matmul_ref`` on the card, within
    rtol = atol = 1e-5 (the JAX kernel's bar). The plain version holds
    all (E, D_out) float32 messages; when the card cannot hold them, it
    runs over the first whole dst segments that fit."""
    import torch

    from repro_torch.kernels.segment_mm import ref

    e, d_out = xg.shape[0], w.shape[1]
    per_edge = 4 * d_out + 16          # a message row and its index
    room = torch.cuda.mem_get_info()[0] - 4 * (n_nodes + 1) * d_out - (2 << 30)
    nodes = n_nodes
    if room < per_edge * e:
        nodes = int(dsorted[max(room // per_edge, 1) - 1])
    e_cut = int(torch.searchsorted(dsorted, nodes)) if nodes < n_nodes else e
    want = ref.segment_matmul_ref(xg[:e_cut], w, dsorted[:e_cut],
                                  n_nodes=nodes)
    diff = (out[:nodes] - want).abs()
    ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
    err = diff.max().item()
    del want, diff
    free_cuda()
    assert ok, f"segment_mm vs plain: max err {err}"
    return {"nodes_compared": nodes, "edges_compared": e_cut,
            "max_abs_err": err}


def check_segment_mm(dev) -> list[dict]:
    import torch

    from repro_torch.kernels.segment_mm import ops, ref
    from repro_torch.launch.kernel_timing import device_ms
    from repro_torch.models.layers import embed_lookup

    x, src, dst, w = gnn_inputs(dev)
    n, d_in = x.shape
    d_out = w.shape[1]
    order = torch.argsort(dst, stable=True)
    xg = embed_lookup(x, src[order])
    dsorted = dst[order]
    del x, src, dst, order
    free_cuda()
    got = ops.segment_matmul_kernel(xg, w, dsorted, n_nodes=n)
    cmp = compare_segment_mm(got, xg, w, dsorted, n)
    ms = time_ms(lambda: ops._launch(xg, w, dsorted, got, n_nodes=n),
                 reps=10, warmup=2)
    ms_device = device_ms(lambda: ops._launch(xg, w, dsorted, got,
                                              n_nodes=n))
    del got
    free_cuda()
    plain_ms = time_ms(lambda: ref.segment_matmul_ref(xg, w, dsorted,
                                                      n_nodes=n),
                       reps=3, warmup=1)

    def library():     # two calls: the message GEMM, then the scatter-add
        return torch.zeros((n, d_out), device=dev).index_add_(
            0, dsorted, torch.matmul(xg, w))

    library_ms = time_ms(library, reps=3, warmup=1)
    e = xg.shape[0]
    # the function's least work: by linearity out[d] = (sum of d's rows
    # of xg) @ W, so E * D_in adds and one GEMV per node with edges
    n_dst = int((dsorted[1:] != dsorted[:-1]).sum()) + 1 if e else 0
    n_ops = e * d_in + 2 * n_dst * d_in * d_out
    nbytes = 4 * e * d_in + 4 * d_in * d_out + 8 * e + 4 * n * d_out
    b_ms, b_by = bound(nbytes, n_ops)
    del xg, dsorted, w
    free_cuda()
    return [dict(name="segment_mm", row="ogb_products", shape=dict(
        n_nodes=n, n_edges=e, d_in=d_in, d_out=d_out, dtype="float32"),
        tolerance=1e-5, **cmp, ms=ms, ms_device=ms_device, plain_ms=plain_ms,
        library_ms=library_ms, library="torch.matmul + index_add_ (two "
        "calls)", bound_ms=b_ms, bound_by=b_by, ops=n_ops, bytes=nbytes)]


# -------------------------------------------------------------- phases 2-11


def kernels():
    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fast_features import ops as ff
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ngram_score import ops as ng
    from repro_torch.kernels.segment_mm import ops as sm

    return {"fast_features": ff.KERNEL, "budget_route": br.KERNEL,
            "ngram_score": ng.KERNEL, "flash_attention": fa.KERNEL,
            "embedding_bag": eb.KERNEL, "segment_mm": sm.KERNEL}


def reset_counts() -> None:
    for k in kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in kernels().items()}


def phase_ft() -> dict:
    import io
    from contextlib import redirect_stdout

    from repro_torch.launch import serve

    argv = ["--docs", "600", "--batch-size", "256", "--variant", "ft",
            "--seed", str(SEED)]
    reset_counts()
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        res_cuda = serve.main(argv + ["--device", "cuda"])
    counts = read_counts()
    wall = time.perf_counter() - t0
    with redirect_stdout(io.StringIO()):
        res_cpu = serve.main(argv + ["--device", "cpu"])
    assert res_cuda == res_cpu, f"ft metrics differ: {res_cuda} vs {res_cpu}"
    n_batches = math.ceil((600 - 600 // 3) / 256)
    assert counts["fast_features"] >= n_batches, counts
    emit({"phase": "ft", "metrics": res_cuda, "launches": counts,
          "batches": n_batches, "cuda_wall_s": wall,
          "equal_to_cpu": True})
    return counts


def route_outputs(enc, device) -> tuple[int, int]:
    """(cheap_idx, expensive_idx) for a router with random weights, or
    trained a few steps.

    Such weights rank the six outputs alike for every document, so
    with the default pair (0, 2) the improvement may have one sign
    throughout and the budget route nothing. Take the pair whose
    improvement is positive for the share of 16 random-token documents
    nearest one half: the route step then has documents to rank, clamp
    and compact."""
    import torch

    toks = torch.randint(2, 8000, (16, enc.cfg.max_len),
                         generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        pred = enc.predict_accuracies(toks.to(device)).float().cpu()
    m = pred.shape[1]
    pairs = [(c, e) for c in range(m) for e in range(m) if c != e]
    return min(pairs, key=lambda p: abs(
        float((pred[:, p[1]] > pred[:, p[0]]).float().mean()) - 0.5))


def build_llm_engine(cfg, n_docs, device, probe_rate, prefetch_depth=0,
                     outputs=None, encoder=None):
    """An llm-variant engine over the test split of an ``n_docs``
    corpus: a fitted CLS-I stage and ``encoder`` (default: random
    weights from a seeded generator) on ``device``."""
    import numpy as np
    import torch

    from repro_torch.core.engine import AdaParseEngine, EngineConfig
    from repro_torch.core.quality import QualityProbe, QualityProbeConfig
    from repro_torch.core.router import AdaParseRouter
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus
    from repro_torch.launch.serve import fit_cls1_stage
    from repro_torch.models.encoder import init_encoder

    ccfg = CorpusConfig(n_docs=n_docs, seed=SEED)
    docs = generate_corpus(ccfg)
    train, test = docs[:n_docs // 3], docs[n_docs // 3:]
    _, _, cls1, _, _ = fit_cls1_stage(train, ccfg,
                                      np.random.RandomState(SEED + 1),
                                      max_len=cfg.max_len, device=device)
    enc = encoder if encoder is not None else init_encoder(
        cfg, torch.Generator().manual_seed(SEED), device=device)
    cheap_idx, expensive_idx = outputs or route_outputs(enc, device)
    router = AdaParseRouter("llm", cls1, None, enc_cfg=cfg, encoder=enc,
                            cheap_idx=cheap_idx,
                            expensive_idx=expensive_idx)
    probe = (QualityProbe(QualityProbeConfig(probe_rate=probe_rate),
                          device=device) if probe_rate else None)
    eng = AdaParseEngine(EngineConfig(alpha=ALPHA, batch_size=256,
                                      seed=SEED,
                                      prefetch_depth=prefetch_depth),
                         router, ccfg, probe=probe, device=device)
    return eng, test


def batch_plans(eng, test):
    """Per batch: the route step's outputs on the engine's device and
    the host mirror's plan on the same improvement scores."""
    import torch

    from repro_torch.core import scheduler
    from repro_torch.core.router import make_route_step

    step = make_route_step(ALPHA, cheap_idx=eng.router.cheap_idx,
                           expensive_idx=eng.router.expensive_idx)
    bs = eng.cfg.batch_size
    out = []
    for b, i in enumerate(range(0, len(test), bs)):
        prep = eng.prepare_batch(test[i:i + bs], batch_key=b)
        res = step(eng.router.encoder, prep.route_host["tokens"],
                   prep.route_host["mask"],
                   torch.from_numpy(prep.route_host["valid_logit"]).to(
                       eng.device))
        imp = res["improvement"].float().cpu().numpy()
        idx = res["selected_idx"].cpu().numpy()
        host = scheduler.plan_batch(imp, ALPHA)
        out.append((prep, res, imp, set(idx[idx >= 0].tolist()),
                    set(host.expensive_idx.tolist())))
    return out


def batch_stage_times(eng, docs) -> dict:
    """Host-clock seconds of one batch's stages on the card, each ended
    by a synchronise; the second of two passes (warm) is kept. The
    encoder forward and the probe are also timed alone."""
    import torch

    for _ in range(2):
        prep, prepare_s = synced(lambda: eng.prepare_batch(docs,
                                                           batch_key=0))
        plan, route_s = synced(lambda: eng.route_batch(prep))
        recs, complete_s = synced(lambda: eng.complete_batch(prep, plan))
        with torch.inference_mode():
            _, encoder_s = synced(
                lambda: eng.router.encoder.predict_accuracies(
                    prep.route_host["tokens"], prep.route_host["mask"]))
        _, probe_s = synced(lambda: eng.probe.score_records(docs, recs))
    return {"docs": len(docs), "prepare_s": prepare_s, "route_s": route_s,
            "encoder_forward_s": encoder_s,
            "complete_with_probe_s": complete_s, "probe_s": probe_s}


def phase_llm(trained):
    """``trained``: the full-width encoder that phase ``train`` trained.
    Returns the launch counts and the router (the fitted CLS-I stage
    behind ``trained``), which phase ``campaign`` runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                      capacity_floor)

    cfg = get_config("adaparse-router").model          # full width, bf16
    assert trained.cfg == cfg, trained.cfg
    eng, test = build_llm_engine(cfg, 600, "cuda", probe_rate=1.0,
                                 prefetch_depth=2, encoder=trained)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = eng.run(test)
    res = eng.evaluate(test, recs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for name in ("fast_features", "budget_route", "ngram_score"):
        assert counts[name] > 0, \
            f"{name} did not launch on the llm path: {counts}"
    plans = batch_plans(eng, test)
    bs = eng.cfg.batch_size
    for b, (prep, out, imp, dev_set, host_set) in enumerate(plans):
        assert dev_set == host_set, (b, dev_set, host_set)
        pred = out["pred_acc"].float()
        assert bool(torch.isfinite(pred).all()), "non-finite predictions"
        assert bool(((pred >= 0) & (pred <= 1)).all()), "pred outside [0,1]"
        routed = {i for i, d in enumerate(test[b * bs:(b + 1) * bs])
                  if recs[d.doc_id].parser == eng.cfg.expensive}
        assert routed == dev_set, (b, routed, dev_set)
    qual = [t.quality for t in eng.telemetry]
    assert all(q for q in qual), "probe did not score every batch"
    assert all(np.isfinite(v[0]) and 0 <= v[0] <= 1
               for q in qual for v in q.values()), qual
    stages = batch_stage_times(eng, test[:bs])
    emit({"phase": "llm", "config": cfg.name, "weights": "phase train",
          "outputs": [eng.router.cheap_idx, eng.router.expensive_idx],
          "docs": len(test),
          "batches": len(plans), "launches": counts, "wall_s": wall,
          "routed": [len(p[3]) for p in plans],
          "metrics": res, "probe_quality": qual,
          "device_plan_equals_plan_batch": True,
          "batch0_stage_s": stages})

    # reduced f32 encoder: cuda against cpu on the same records
    small = get_config("adaparse-router").reduced().model
    runs = {}
    outputs = None
    for dev in ("cuda", "cpu"):
        e, t = build_llm_engine(small, 150, dev, probe_rate=0.0,
                                outputs=outputs)
        outputs = (e.router.cheap_idx, e.router.expensive_idx)
        runs[dev] = (e, t, e.run(t), batch_plans(e, t))
    (_, t, rc, pc), (_, _, rh, ph) = runs["cuda"], runs["cpu"]
    # a selection may differ only for documents within 1e-5 of tau
    # (f32 sums run in another order on the card)
    tau_gap = []
    for (_, _, _, set_c, _), (_, _, imp_h, set_h, _) in zip(pc, ph):
        cap = capacity_floor(ALPHA, len(imp_h))
        if not cap:
            continue
        tau = max(float(np.sort(imp_h)[::-1][cap - 1]), POSITIVE_TAU)
        tau_gap += [abs(float(imp_h[i]) - tau) for i in set_c ^ set_h]
    assert all(gp <= 1e-5 for gp in tau_gap), tau_gap
    same = sum(rc[d.doc_id].parser == rh[d.doc_id].parser for d in t)
    emit({"phase": "llm_small_parity", "config": small.name,
          "docs": len(t), "routed": [len(p[3]) for p in pc],
          "records_same_parser": same,
          "flips_within_1e-5_of_tau": len(tau_gap)})
    return counts, eng.router


# -------------------------------------------------------------- campaign

CAMPAIGN_DOCS = 4608    # 3,072 test documents: 12 batches of 256, so
#                         three rounds of several batches a node
CAMPAIGN_NODES = ["cpu", "cpu", "cpu", "gpu"]        # --pools cpu:3,gpu:1
CAMPAIGN_SPEEDS = [1.0, 1.0, 3.0, 1.0]
CAMPAIGN_ROUNDS = 3
STRAGGLER_RATE = 0.5
HUNG_SLOWDOWN = 50.0    # A2r: a hung batch, far past the re-issue deadline
SERVE_CAMPAIGN = ["--variant", "ft", "--docs", "1200", "--nodes", "4",
                  "--adaptive-rounds", "3", "--quality-probe-rate", "0.5",
                  "--alpha-bounds", "0.02:0.2", "--alpha-step", "0.05",
                  "--warm-cache", "--seed", str(SEED)]


def same_records(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        (a[k].parser, a[k].cost_s, len(a[k].pages))
        == (b[k].parser, b[k].cost_s, len(b[k].pages))
        and all(np.array_equal(p, q) for p, q in zip(a[k].pages, b[k].pages))
        for k in a)


def campaign_run(label, fn, n_docs) -> tuple:
    """Run one controller campaign on the card: (result, its JSON
    summary). Card figures are host-clock seconds with a synchronise;
    ``simulated`` are the fleet's node-second clocks, the same on any
    device."""
    counts0 = read_counts()
    res, seconds = synced(fn)
    counts = {k: v - counts0[k] for k, v in read_counts().items()}
    tele = res.telemetry
    row = {
        "run": label, "card_wall_s": seconds,
        "card_docs_per_s": n_docs / seconds, "launches": counts,
        "simulated": {"wall_s": res.wall_s, "docs_per_s": res.docs_per_s,
                      "node_busy_frac": res.node_busy_frac},
        "reissued": res.reissued, "reissued_reparse": res.reissued_reparse,
        "cache_hits": res.cache_hits, "cache_misses": res.cache_misses,
        "node_alphas": res.node_alphas,
        "weight_history": res.weight_history,
        "alpha_trajectory": [t.alpha for t in tele],
        "decisions": [t.decision for t in tele],
        "probe_quality": [t.quality for t in tele]}
    emit({"phase": "campaign_run", **row})
    return res, row


def serve_process(argv, card: bool = False):
    """``serve.main(argv)`` in a child process, which cannot see the card
    unless ``card`` (host-bound BLEU runs beside the card's run there);
    ``finish`` reads its metric dict and report lines."""
    import os

    code = ("import json, sys\n"
            "from repro_torch.launch import serve\n"
            "res = serve.main(sys.argv[1:])\n"
            "print('RESULT ' + json.dumps(res))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, "-c", code, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def finish(proc, timeout: float = 600.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    if proc.returncode:
        raise RuntimeError(f"cpu serve exited {proc.returncode}:\n"
                           f"{err[-3000:]}")
    lines = out.splitlines()
    return json.loads(lines[-1][len("RESULT "):]), lines


def serve_with_cpu_beside(cuda_argv, cpu_argv):
    """``serve.main`` on the card in this process while the cpu run goes
    on in a child: ((metrics, lines) on cuda, (metrics, lines) on cpu)."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.launch import serve

    proc = serve_process(cpu_argv + ["--device", "cpu"])
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = serve.main(cuda_argv + ["--device", "cuda"])
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return (res, buf.getvalue().splitlines()), finish(proc)


def report_lines(lines) -> list[str]:
    return [ln for ln in lines
            if ln.startswith(("[serve] executor[", "[serve]   "))]


def cache_counts(lines) -> list[list[int]]:
    """(hits, misses) of each executor pass, from its report line."""
    out = []
    for ln in lines:
        if ln.startswith("[serve] executor["):
            h, m = ln.rsplit("cache=", 1)[1].split("/")
            out.append([int(h[:-1]), int(m[:-1])])
    return out


def store_entries(path) -> dict:
    """A DiskResultStore's batches by file name (the hash of the key),
    each as its records keyed by doc id."""
    import pickle

    return {f.name: {r.doc_id: r for r in pickle.loads(f.read_bytes())}
            for f in Path(path).glob("*.pkl")}


def phase_campaign(router) -> dict:
    """The campaign layer on the card with the full-width router that
    phases ``train`` and ``llm`` left: A1 the single-node engine, A2 the
    4-node controller (pools cpu:3,gpu:1, speeds 1/1/3/1, prefetch 2,
    probe rate 0.5, a disk store), A2r the same fleet with a two-node
    GPU pool so that the seeded stragglers re-issue, A3 a warm replay of
    A2's store on the card and on the CPU, A4 α retuning and its replay;
    B ``serve`` with the campaign flags on cuda and cpu."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.core import obs
    from repro_torch.core.backends import DiskResultStore
    from repro_torch.core.campaign import (CampaignController,
                                           ControllerConfig, ExecutorConfig)
    from repro_torch.core.engine import AdaParseEngine, EngineConfig
    from repro_torch.core.quality import QualityProbeConfig
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus
    from repro_torch.launch import obs_report
    from repro_torch.models.encoder import (encoder_from_jax_params,
                                            encoder_to_jax_params)

    ccfg = CorpusConfig(n_docs=CAMPAIGN_DOCS, seed=SEED)
    test = generate_corpus(ccfg)[CAMPAIGN_DOCS // 3:]
    n, bs = len(test), 256
    n_batches = -(-n // bs)
    ecfg = EngineConfig(alpha=ALPHA, batch_size=bs, seed=SEED)
    xcfg = ExecutorConfig(n_nodes=len(CAMPAIGN_NODES),
                          node_pools=CAMPAIGN_NODES, prefetch_depth=2,
                          node_speed_factors=CAMPAIGN_SPEEDS,
                          straggler_rate=STRAGGLER_RATE, seed=SEED)
    probed = ControllerConfig(rounds=CAMPAIGN_ROUNDS, probe=QualityProbeConfig(
        probe_rate=0.5, seed=SEED))
    retune = dict(rounds=CAMPAIGN_ROUNDS, alpha_bounds=(0.02, 0.2),
                  alpha_step=0.05,
                  probe=QualityProbeConfig(probe_rate=1.0, seed=SEED))
    runs = []

    def controller(ctl, xc=xcfg, dev="cuda", rtr=router):
        return CampaignController(ecfg, xc, ctl, rtr, ccfg, device=dev)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        eng = AdaParseEngine(ecfg, router, ccfg, device="cuda")
        single, seconds = synced(lambda: eng.run(test))
        # one node: its clock is the engine's charged node-seconds
        runs.append({"run": "A1 single node", "card_wall_s": seconds,
                     "card_docs_per_s": n / seconds,
                     "launches": read_counts(),
                     "simulated": {"wall_s": eng.stats.node_seconds,
                                   "docs_per_s": eng.stats.throughput}})
        emit({"phase": "campaign_run", **runs[-1]})

        a2, row = campaign_run(
            "A2 controller", lambda: controller(probed).run(
                test, cache=DiskResultStore(tmp / "a2")), n)
        runs.append(row)
        assert same_records(a2.records, single), "A2 records differ from A1"
        assert a2.cache_misses == n_batches, a2.cache_misses

        # with one GPU-pool node a forwarded re-parse has no eligible
        # peer (GPU work cannot leave its pool), so A2's stragglers run
        # to completion at the 4x slowdown; with two GPU nodes, and the
        # seeded stragglers hung, they re-issue
        two_gpu = dataclasses.replace(xcfg,
                                      node_pools=["cpu", "cpu", "gpu", "gpu"],
                                      straggler_slowdown=HUNG_SLOWDOWN)
        a2r, row = campaign_run(
            "A2r controller, re-issue", lambda: controller(
                probed, two_gpu).run(test), n)
        runs.append(row)
        assert a2r.reissued >= 1, "the seeded stragglers re-issued nothing"
        assert same_records(a2r.records, single), "A2r records differ"

        a3, row = campaign_run(
            "A3 warm replay", lambda: controller(probed).run(
                test, cache=DiskResultStore(tmp / "a2")), n)
        runs.append(row)
        assert (a3.cache_hits, a3.cache_misses) == (n_batches, 0), row
        assert same_records(a3.records, single), "A3 records differ"

        # the card's store on the CPU, with the same router's weights
        cpu_router = dataclasses.replace(router, encoder=encoder_from_jax_params(
            encoder_to_jax_params(router.encoder), router.enc_cfg, "cpu"))
        t0 = time.perf_counter()
        a3c = controller(probed, dev="cpu", rtr=cpu_router).run(
            test, cache=DiskResultStore(tmp / "a2"))
        runs.append({"run": "A3 warm replay on the cpu",
                     "host_wall_s": time.perf_counter() - t0,
                     "cache_hits": a3c.cache_hits,
                     "cache_misses": a3c.cache_misses})
        emit({"phase": "campaign_run", **runs[-1]})
        assert (a3c.cache_hits, a3c.cache_misses) == (n_batches, 0), \
            "the card's store did not replay on the cpu"
        assert same_records(a3c.records, single), "A3 cpu records differ"
        del cpu_router

        a4, row = campaign_run(
            "A4 alpha retuning", lambda: controller(
                ControllerConfig(**retune)).run(
                    test, cache=DiskResultStore(tmp / "a4")), n)
        runs.append(row)
        traj = a4.alpha_trajectory
        assert all(0.02 <= a <= 0.2 for a in traj + a4.node_alphas), traj
        a4r, row = campaign_run(
            "A4 replay, cold store", lambda: controller(ControllerConfig(
                telemetry_trace=a4.telemetry, **retune)).run(
                    test, cache=DiskResultStore(tmp / "a4r")), n)
        runs.append(row)
        assert a4r.alpha_trajectory == traj, (a4r.alpha_trajectory, traj)
        assert a4r.weight_history == a4.weight_history
        assert all(t.decision == "replay" for t in a4r.telemetry)
        assert same_records(a4r.records, a4.records), "A4 replay differs"

        def argv(tag):
            return SERVE_CAMPAIGN + [
                "--cache-dir", str(tmp / f"store_{tag}"),
                "--trace-dir", str(tmp / f"trace_{tag}"),
                "--metrics-out", str(tmp / f"metrics_{tag}.txt")]

        t0 = time.perf_counter()
        (b_cuda, l_cuda), (b_cpu, l_cpu) = serve_with_cpu_beside(
            argv("cuda"), argv("cpu"))
        b_s = time.perf_counter() - t0
        assert b_cuda == b_cpu, f"serve metrics differ: {b_cuda} {b_cpu}"
        assert report_lines(l_cuda) == report_lines(l_cpu), \
            (report_lines(l_cuda), report_lines(l_cpu))
        trace = obs_report.summarize(*obs.load_spans(tmp / "trace_cuda"))
        # the card's store holds the CPU's entries, key for key (the
        # keys embed the router fingerprint and each round's α)
        stored = {dev: store_entries(tmp / f"store_{dev}")
                  for dev in ("cuda", "cpu")}
        assert stored["cuda"].keys() == stored["cpu"].keys(), \
            "the card's and the cpu's stores hold different keys"
        assert all(same_records(stored["cuda"][k], stored["cpu"][k])
                   for k in stored["cuda"]), "stored records differ"
    counts = read_counts()
    for name in ("fast_features", "budget_route", "ngram_score"):
        assert counts[name] > 0, \
            f"{name} did not launch in phase campaign: {counts}"
    emit({"phase": "campaign", "config": router.enc_cfg.name,
          "docs": n, "batches": n_batches, "nodes": CAMPAIGN_NODES,
          "speed_factors": CAMPAIGN_SPEEDS, "straggler_rate": STRAGGLER_RATE,
          "runs": runs, "launches": counts,
          "phase_s": time.perf_counter() - t_phase,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "serve": {"argv": SERVE_CAMPAIGN, "metrics": b_cuda,
                    "equal_on_cpu": True, "wall_s_both": b_s,
                    "report": report_lines(l_cuda),
                    "cache": cache_counts(l_cuda),
                    "store_entries_equal_to_cpu": len(stored["cuda"]),
                    "trace": {k: trace[k] for k in
                              ("n_spans", "complete", "complete_cached")}}})
    return counts, (ccfg, test, single)


# -------------------------------------------------------------- fleet

FLEET_WORKERS = 4
FAULT_DOCS = 1024       # F3: the fault runs' 4 batches of 256
MAIN_KERNELS = ("fast_features", "budget_route", "ngram_score")
MEASURED_FIELDS = [(r"(wall|docs/s|busy)=[0-9.]+", r"\1=*"),
                   (r"weights [0-9./]+ -> [0-9./]+", "weights *")]


def worker_gauges(res, n_workers: int) -> list[dict]:
    """Each worker's kernel launches and peak card memory, as the
    worker published them in the metrics snapshot it shipped (its
    launches never reach this process's counters)."""
    g = res.obs_metrics["gauges"]
    return [{"worker": w,
             "launches": {k: int(g.get(f"kernel.launches.{k}.n{w}", 0))
                          for k in MAIN_KERNELS},
             "peak_gb": g.get(f"worker.peak_bytes.n{w}", 0.0) / 1e9}
            for w in range(n_workers)]


def shm_entries() -> list[str]:
    """/dev/shm segments of any pool this process made."""
    import glob
    import os

    return sorted(glob.glob(f"/dev/shm/adaparse-{os.getpid():x}-*"))


def fleet_run(label, fn, n_docs: int, n_workers: int, **extra) -> tuple:
    """One campaign over real worker processes on the card: (result,
    its JSON row). ``card_wall_s`` is the pool's drain wall (first task
    sent to last record, workers up); ``run_s`` adds spawning the
    workers and building their engines."""
    counts0 = read_counts()
    t0 = time.perf_counter()
    res = fn()
    run_s = time.perf_counter() - t0
    assert read_counts() == counts0, \
        f"{label}: the coordinator launched a kernel itself"
    c = res.obs_metrics["counters"]
    row = {"run": label, "card_wall_s": res.wall_s,
           "card_docs_per_s": n_docs / res.wall_s, "run_s": run_s,
           "workers": worker_gauges(res, n_workers),
           "payloads_shm": c.get("pool.payloads_shm", 0),
           "payloads_inline": c.get("pool.payloads_inline", 0),
           "shm_fallbacks": c.get("shm.fallbacks", 0),
           "reissued": res.reissued,
           "duplicates_dropped": res.duplicates_dropped,
           "docs_counted": sum(st.n_docs for st in res.node_stats),
           "shm_left": shm_entries(), **extra}
    emit({"phase": "fleet_run", **row})
    assert not row["shm_left"], f"{label}: /dev/shm entries left"
    assert row["docs_counted"] == n_docs, row["docs_counted"]
    return res, row


def masked_report(lines) -> list[str]:
    """A real fleet's report lines with what it measures (wall,
    documents/s, busy share, and the adaptive weights, which follow the
    measured clocks) masked out."""
    import re

    out = []
    for ln in report_lines(lines):
        for pat, sub in MEASURED_FIELDS:
            ln = re.sub(pat, sub, ln)
        out.append(ln)
    return out


def phase_fleet(router, ccfg, test, single) -> dict:
    """The campaign on real worker processes, each with its own CUDA
    context on the one card, with the router of phase ``campaign`` and
    its single-node records (A1). F1: 4 workers, shm transport,
    prefetch 2, probe 0.5, a disk store, 3 controller rounds. F2: F1 on
    the pickle transport; F2p the same with pools cpu:3,gpu:1, so that
    every routed batch's prepare is forwarded (from card to card through
    the coordinator) to the GPU-pool worker. F3: a crash run and a flap
    run (2 workers, 1,024 documents), their heartbeat timeouts chosen
    from F1's measured batch time. F4: 4 loopback fabric workers, then
    an elastic fabric campaign with one join and one crash. F5: ``serve
    --workers 2`` and ``serve --fabric-workers 2`` on cuda, each beside
    the same on the cpu in a child process."""
    import dataclasses
    import tempfile

    from repro_torch.core.backends import DiskResultStore
    from repro_torch.core.campaign import (CampaignController,
                                           CampaignExecutor,
                                           ControllerConfig, ExecutorConfig,
                                           FaultInjection)
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.fabric import FabricElastic
    from repro_torch.core.quality import QualityProbe, QualityProbeConfig

    free_cuda()
    n, bs = len(test), 256
    n_batches = -(-n // bs)
    ecfg = EngineConfig(alpha=ALPHA, batch_size=bs, seed=SEED)
    probe_cfg = QualityProbeConfig(probe_rate=0.5, seed=SEED)
    probed = ControllerConfig(rounds=CAMPAIGN_ROUNDS, probe=probe_cfg)
    n_probed = sum(QualityProbe(probe_cfg, device="cpu").should_probe(k)
                   for k in range(n_batches))
    fleet = ExecutorConfig(n_nodes=FLEET_WORKERS, runtime="process",
                           transport="shm", prefetch_depth=2, obs=True,
                           seed=SEED)
    runs, totals = [], dict.fromkeys(MAIN_KERNELS, 0)

    def add(row):
        runs.append(row)
        for wk in row["workers"]:
            for k, v in wk["launches"].items():
                totals[k] += v

    def sub_single(docs):
        return {d.doc_id: single[d.doc_id] for d in docs}

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        f1, row = fleet_run(
            "F1 process, shm", lambda: CampaignController(
                ecfg, fleet, probed, router, ccfg, device="cuda").run(
                    test, cache=DiskResultStore(tmp / "f1")),
            n, FLEET_WORKERS)
        add(row)
        assert same_records(f1.records, single), "F1 records differ from A1"
        assert f1.cache_misses == n_batches, f1.cache_misses
        for wk in row["workers"]:
            assert wk["launches"]["fast_features"] > 0, wk
            assert wk["launches"]["budget_route"] > 0, wk
        assert totals["ngram_score"] >= n_probed, (totals, n_probed)
        assert row["payloads_shm"] == 2 * n_batches, row
        assert row["payloads_inline"] == 0, row

        pickled = dataclasses.replace(fleet, transport="pickle")
        f2, row = fleet_run(
            "F2 process, pickle", lambda: CampaignController(
                ecfg, pickled, probed, router, ccfg, device="cuda").run(test),
            n, FLEET_WORKERS)
        add(row)
        assert same_records(f2.records, f1.records), "F2 records differ"
        assert (row["payloads_shm"], row["payloads_inline"]) == \
            (0, 2 * n_batches), row

        pooled = dataclasses.replace(pickled, node_pools=CAMPAIGN_NODES)
        f2p, row = fleet_run(
            "F2p process, pickle, pools cpu:3,gpu:1", lambda:
            CampaignController(ecfg, pooled, probed, router, ccfg,
                               device="cuda").run(test),
            n, FLEET_WORKERS)
        add(row)
        assert same_records(f2p.records, single), "F2p records differ"
        assert f2p.node_stats[3].n_expensive > 0, "nothing was forwarded"

        # F3: the fault runs' heartbeat timeouts follow the measured
        # batch time (F1's busy seconds a batch, four workers sharing
        # the card, so an upper estimate for two)
        batch_s = float(sum(st.node_seconds for st in f1.node_stats)
                        / n_batches)
        fault_docs = test[:FAULT_DOCS]
        crash_timeout = max(5.0, 10 * batch_s)
        crash = dataclasses.replace(
            fleet, n_nodes=2, prefetch_depth=0,
            heartbeat_timeout_s=crash_timeout, heartbeat_interval_s=0.1,
            fault_injection=FaultInjection(crash_after=((1, 1),)))
        f3c, row = fleet_run(
            "F3 crash", lambda: CampaignExecutor(
                ecfg, crash, router, ccfg, device="cuda").run(fault_docs),
            FAULT_DOCS, 2, batch_s=batch_s,
            heartbeat_timeout_s=crash_timeout)
        add(row)
        assert f3c.reissued >= 1, row
        assert same_records(f3c.records, sub_single(fault_docs)), \
            "F3 crash records differ"
        # the flap: worker 1 mutes after one task and unmutes after
        # two; the muted task's slowdown outlasts the largest deadline
        # _deadline_for can grant at a window of 3 (the timeout times
        # 1 + 3 queued tasks) by one more timeout
        flap_timeout = max(1.0, batch_s)
        slowdown = flap_timeout * (1 + 3) + flap_timeout
        flap = dataclasses.replace(
            fleet, n_nodes=2, prefetch_depth=2,
            heartbeat_timeout_s=flap_timeout, heartbeat_interval_s=0.1,
            straggler_grace_s=slowdown + 5.0,
            fault_injection=FaultInjection(mute_after=((1, 0),),
                                           unmute_after=((1, 2),),
                                           mute_slowdown_s=slowdown))
        f3f, row = fleet_run(
            "F3 flap", lambda: CampaignExecutor(
                ecfg, flap, router, ccfg, device="cuda").run(fault_docs),
            FAULT_DOCS, 2, batch_s=batch_s,
            heartbeat_timeout_s=flap_timeout, mute_slowdown_s=slowdown)
        add(row)
        assert f3f.reissued >= 1, row
        assert same_records(f3f.records, sub_single(fault_docs)), \
            "F3 flap records differ"

        fabric = dataclasses.replace(fleet, runtime="fabric",
                                     heartbeat_interval_s=0.2)
        f4, row = fleet_run(
            "F4 fabric, 4 loopback workers", lambda: CampaignExecutor(
                ecfg, fabric, router, ccfg, device="cuda").run(test),
            n, FLEET_WORKERS)
        add(row)
        assert same_records(f4.records, single), "F4 records differ"
        for wk in row["workers"]:
            assert wk["launches"]["fast_features"] > 0, wk
        elastic = dataclasses.replace(
            fabric, n_nodes=3, heartbeat_timeout_s=crash_timeout,
            heartbeat_interval_s=0.1,
            fault_injection=FaultInjection(crash_after=((1, 2),)),
            fabric=FabricElastic(join_after=((2, 3),)))
        f4e, row = fleet_run(
            "F4 fabric, elastic join and crash", lambda: CampaignController(
                ecfg, elastic, ControllerConfig(rounds=2), router, ccfg,
                device="cuda").run(test), n, 3)
        spans = {}
        for sp in f4e.spans or []:
            spans[sp.name] = spans.get(sp.name, 0) + 1
        row["membership_spans"] = {k: spans.get(k, 0)
                                   for k in ("join", "leave")}
        add(row)
        assert same_records(f4e.records, single), "F4 elastic records differ"
        assert f4e.reissued >= 1 and spans.get("leave") == 1, spans

        # the campaign phase's serve flags, with the fleet in worker
        # processes instead of 4 in-process nodes (the serve coordinator
        # itself launches fast_features for its router and evaluation)
        i = SERVE_CAMPAIGN.index("--nodes")
        serve_argv = SERVE_CAMPAIGN[:i] + SERVE_CAMPAIGN[i + 2:]
        served, out = {}, {}
        counts0 = read_counts()
        t0 = time.perf_counter()
        flags = ("--workers", "--fabric-workers")

        def argv(flag, dev):
            return serve_argv + [flag, "2", "--device", dev, "--cache-dir",
                                 str(tmp / f"serve{flag}_{dev}")]

        # all four at once (their time is mostly host BLEU): the first
        # flag's cuda run here, the other three in child processes
        procs = {(f, "cpu"): serve_process(argv(f, "cpu")) for f in flags}
        procs[flags[1], "cuda"] = serve_process(argv(flags[1], "cuda"),
                                                card=True)
        try:
            import io
            from contextlib import redirect_stdout

            from repro_torch.launch import serve

            buf = io.StringIO()
            with redirect_stdout(buf):
                res = serve.main(argv(flags[0], "cuda"))
            out[flags[0], "cuda"] = res, buf.getvalue().splitlines()
        except BaseException:
            for proc in procs.values():
                proc.kill()
                proc.wait()
            raise
        out.update({key: finish(proc) for key, proc in procs.items()})
        for flag in flags:
            (m_cuda, l_cuda), (m_cpu, l_cpu) = out[flag, "cuda"], \
                out[flag, "cpu"]
            measured = {d: m.pop("throughput_docs_per_node_s")
                        for d, m in (("cuda", m_cuda), ("cpu", m_cpu))}
            assert m_cuda == m_cpu, (flag, m_cuda, m_cpu)
            assert masked_report(l_cuda) == masked_report(l_cpu), \
                (masked_report(l_cuda), masked_report(l_cpu))
            stored = {d: store_entries(tmp / f"serve{flag}_{d}")
                      for d in ("cuda", "cpu")}
            assert stored["cuda"].keys() == stored["cpu"].keys(), flag
            assert all(same_records(stored["cuda"][k], stored["cpu"][k])
                       for k in stored["cuda"]), flag
            served[flag] = {"metrics": m_cuda,
                            "throughput_docs_per_node_s": measured,
                            "report_cuda": report_lines(l_cuda),
                            "report_cpu": report_lines(l_cpu),
                            "store_entries_equal_to_cpu":
                                len(stored["cuda"])}
        serve_s = time.perf_counter() - t0
        coordinator = {k: v - counts0[k] for k, v in read_counts().items()}
    assert not shm_entries(), shm_entries()
    for name in MAIN_KERNELS:
        assert totals[name] > 0, f"{name} launched in no worker: {totals}"
    from repro_torch.core import shm, specs

    def nbytes(x):
        return (sum(map(nbytes, x.values())) if isinstance(x, dict)
                else x.nbytes)

    emit({"phase": "fleet", "config": router.enc_cfg.name, "docs": n,
          "router_numpy_mb": nbytes(specs.portable_router(router)
                                    .enc_params) / 1e6,
          "batch_payload_mb": shm.pack_payload(test[:bs])[3] / 1e6,
          "batches": n_batches, "workers": FLEET_WORKERS,
          "fault_docs": FAULT_DOCS, "probed_batches": n_probed,
          "runs": runs, "worker_launches": totals,
          "serve": {"argv": serve_argv, "runs": served,
                    "wall_s_both": serve_s,
                    "coordinator_launches": coordinator},
          "phase_s": time.perf_counter() - t_phase})
    return {k: v + totals.get(k, 0) for k, v in coordinator.items()}


# -------------------------------------------------------------- autotune


def knob_rows(dev, ccfg, docs, pages, exp_pages) -> list[dict]:
    """Every candidate of each main-path kernel's autotune knob at the
    path's shapes (and budget_route at route_64k): the outputs equal the
    default launch's bit for bit and, with the kernel rows' tolerances,
    the plain version's; ``ms_device`` of each (100 back-to-back
    launches, as phase ``kernels`` times them) and the fastest."""
    import numpy as np
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.data.synthetic import MANGLED, SCRAMBLE, WS
    from repro_torch.kernels.autotune_common import device_ms
    from repro_torch.kernels.budget_route import autotune as br_at
    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.budget_route import ref as br_ref
    from repro_torch.kernels.fast_features import autotune as ff_at
    from repro_torch.kernels.fast_features import ops as ff
    from repro_torch.kernels.fast_features import ref as ff_ref
    from repro_torch.kernels.ngram_score import autotune as ng_at
    from repro_torch.kernels.ngram_score import ops as ng
    from repro_torch.kernels.ngram_score import ref as ng_ref

    def row(kernel, param, shape, cands, default, make, check):
        """make(c) -> (launch, outputs); check(outputs) -> max abs err
        against the plain version."""
        launch, want = make(default)
        launch()
        torch.cuda.synchronize()
        want = [None if t is None else t.clone() for t in want]
        times, err = {}, 0.0
        for c in cands:
            launch, got = make(c)
            for t in got:
                if t is not None:
                    t.fill_(-7)          # garbage: every element rewritten
            launch()
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert (a is None) == (b is None) and (
                    a is None or torch.equal(a, b)), \
                    f"{kernel} {param}={c} at {shape}: not the default's bits"
            err = max(err, check(got))
            times[c] = device_ms(launch)
        win = min(times, key=times.get)
        out = dict(kernel=kernel, param=param, shape=shape, default=default,
                   ms_device=times, winner=win,
                   winner_over_default=times[win] / times[default],
                   max_abs_err=err, bit_equal_to_default=True)
        emit({"phase": "autotune_knob", **out})
        return out

    rows = []
    # fast_features: the prepare stage's batch, max_len 0 (ft) and 512
    for max_len in (0, 512):
        packed = ff.pack_routing_batch(pages, max_len=max_len)
        ins = [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in (
            packed.tok_matrix, packed.n_tok, packed.first_len,
            packed.n_pages, packed.n_empty)]
        kw = dict(max_len=max_len, ws=WS, scramble=SCRAMBLE,
                  mangled=MANGLED, latex_lo=ccfg.latex_lo,
                  ident_lo=ccfg.ident_lo, vocab_size=ccfg.vocab_size, bos=1)
        plain = ff_ref.fast_features_ref(*ins, **kw)
        n = len(pages)

        def make(c, ins=ins, kw=kw, n=n, max_len=max_len):
            fast = torch.empty((n, 8), dtype=torch.float32, device=dev)
            toks = mask = None
            if max_len:
                toks = torch.empty((n, max_len), dtype=torch.int32,
                                   device=dev)
                mask = torch.empty((n, max_len), dtype=torch.float32,
                                   device=dev)
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            return (lambda: ff._launch(*ins, fast, toks, mask, flag,
                                       threads=c, **kw)), [fast, toks, mask]

        def check(got, plain=plain, max_len=max_len):
            err = (got[0] - plain[0]).abs().max().item()
            assert err <= 1e-6, err
            if max_len:
                assert torch.equal(got[1], plain[1]) and torch.equal(
                    got[2], plain[2])
            return err

        rows.append(row("fast_features", "threads",
                        dict(n=n, width=packed.width, max_len=max_len),
                        ff_at.DEFAULT_CANDIDATES, ff_at.DEFAULT_THREADS,
                        make, check))
    # budget_route: the path's N = 256 (one block: one candidate) and
    # route_64k
    g = torch.Generator(device=dev).manual_seed(SEED)
    for n, d in ((256, 512), br_at.ROUTE_64K):
        scores = torch.round(torch.randn(n, generator=g, device=dev) * 4) / 4
        tokens = torch.randint(0, 10000, (n, d), generator=g,
                               dtype=torch.int32, device=dev)
        cap = br.capacity_floor(ALPHA, n)
        tau = br.route_tau(scores, cap)
        plain = br_ref.budget_route_ref(scores, tokens, tau[0], capacity=cap)

        def make(c, scores=scores, tokens=tokens, tau=tau, cap=cap, n=n,
                 d=d):
            out = torch.empty((cap, d), dtype=torch.int32, device=dev)
            idx = torch.empty(cap, dtype=torch.int32, device=dev)
            count = torch.empty(1, dtype=torch.int32, device=dev)
            plan = br.launch_plan(n, br.sm_count(dev), c)
            scratch = torch.empty(br.scratch_ints(plan[0]),
                                  dtype=torch.int32, device=dev)
            return (lambda: br._launch(scores, tokens, tau, out, idx, count,
                                       capacity=cap, scratch=scratch,
                                       block_rows=c)), [out, idx, count]

        def check(got, plain=plain):
            assert torch.equal(got[0], plain[0]) and torch.equal(
                got[1], plain[1]) and int(got[2]) == int(plain[2])
            return 0.0

        r = row("budget_route", "block_rows", dict(n=n, d=d, capacity=cap),
                br_at._clamp_candidates(br_at.DEFAULT_CANDIDATES, n),
                br_at.DEFAULT_BLOCK_ROWS, make, check)
        r["grids"] = {c: br.launch_plan(n, br.sm_count(dev), c)
                      for c in r["ms_device"]}
        rows.append(r)
    # ngram_score: the probe's B = 256, L = 256 (cheap and expensive
    # parses against the references)
    refs = [doc.full_text() for doc in docs]
    hyps = [np.concatenate(o) if sum(map(len, o)) else np.zeros(0, np.int32)
            for outs in (pages, exp_pages) for o in outs]
    ra, rl = M._pad_batch((refs * 2)[:256], 256)
    ha, hl = M._pad_batch(hyps[:256], 256)
    ins = [torch.from_numpy(x).to(dev) for x in (ra, ha, rl, hl)]
    plain = ng_ref.ngram_bleu_ref(*ins)

    def make(c):
        out = torch.empty(256, dtype=torch.float32, device=dev)
        return (lambda: ng._launch(*ins, out, max_n=4, threads=c)), [out]

    def check(got):
        diff = (got[0].double() - plain).abs()
        assert bool((diff <= 1e-6 + 1e-5 * plain.abs()).all()), diff.max()
        return diff.max().item()

    rows.append(row("ngram_score", "threads", dict(b=256, L=256, max_n=4),
                    ng_at.DEFAULT_CANDIDATES, ng_at.DEFAULT_THREADS, make,
                    check))
    return rows


# -------------------------------------------------------------- scenarios

GOODPUT = (r"goodput=[0-9.]+docs/s", "goodput=*")
# 200 batches of 8: a drain of about a second, so the 0.5 s status
# pulse fires; the router trains on 800 documents
STATUS_ARGV = ["--docs", "2400", "--batch-size", "8", "--workers", "2",
               "--status-interval", "0.5"]


def phase_scenarios() -> dict:
    """The scenario lab on the card: ``run_scenario`` of all eight
    scenarios (their own corpus and ft router, every engine and worker on
    cuda; each asserts its records equal its single-node reference), the
    elastic scenario's joiner serving documents; ``serve --scenario
    bursty_arrivals`` on cuda and on cpu (a child process), equal but for
    the goodput; and ``serve --workers 2 --status-interval 0.5`` on cuda
    in a child process, which must print the live status line. Launches:
    this process's (the local scenarios and the cuda serve); the
    workers' are not read here."""
    import re

    from repro_torch.core.scenarios import SCENARIOS, run_scenario

    free_cuda()
    t_phase = time.perf_counter()
    counts0 = read_counts()
    status = serve_process(STATUS_ARGV + ["--device", "cuda"], card=True)
    try:
        rows = []
        for name, spec in SCENARIOS.items():
            t0 = time.perf_counter()
            res = run_scenario(spec, device="cuda")
            row = {"scenario": name, "seconds": time.perf_counter() - t0,
                   **res.metrics(),
                   "joiner_served_a_batch": (None if res.joiner_docs is None
                                             else res.joiner_docs > 0)}
            emit({"phase": "scenario_run", **row})
            assert res.records_match, name
            rows.append(row)
        elastic = next(r for r in rows if r["scenario"] ==
                       "elastic_join_leave")
        assert elastic["joiner_served_a_batch"] and elastic["reissued"] >= 1
        assert all(r["reissued"] >= 1 for r in rows if r["scenario"] in (
            "crash_storm", "shm_crash_reissue", "slowdown_skew"))
        assert next(r for r in rows if r["scenario"] ==
                    "cold_warm_shared_store")["warm_cache_misses"] == 0
        t0 = time.perf_counter()
        argv = ["--scenario", "bursty_arrivals"]
        (m_cuda, l_cuda), (m_cpu, l_cpu) = serve_with_cpu_beside(argv, argv)
        masked = [[re.sub(*GOODPUT, ln) for ln in ls
                   if ln.startswith("[serve]")] for ls in (l_cuda, l_cpu)]
        assert masked[0] == masked[1], masked
        measured = {d: {k: m.pop(k) for k in ("wall_s", "goodput_docs_per_s")}
                    for d, m in (("cuda", m_cuda), ("cpu", m_cpu))}
        assert m_cuda == m_cpu, (m_cuda, m_cpu)
        serve_s = time.perf_counter() - t0
        counts = {k: v - counts0[k] for k, v in read_counts().items()}
        out, err = status.communicate(timeout=900)
    finally:
        status.kill()
    if status.returncode:
        raise RuntimeError(f"serve --status-interval exited "
                           f"{status.returncode}:\n{err[-3000:]}")
    lines = [ln for ln in err.splitlines() if ln.startswith("[status] ")]
    assert lines, "serve --status-interval printed no status line"
    emit({"phase": "scenarios", "runs": rows, "launches": counts,
          "serve_scenario": {"argv": argv, "report": masked[0],
                             "metrics": m_cuda, "measured": measured,
                             "seconds_both": serve_s},
          "serve_status": {"argv": STATUS_ARGV, "status_lines": len(lines),
                           "first": lines[0], "last": lines[-1],
                           "report": report_lines(out.splitlines())},
          "phase_s": time.perf_counter() - t_phase})
    return counts


# -------------------------------------------------------------- autotune

TUNE_WORKERS = 2


def phase_autotune(router, ccfg, test, single, knob_inputs) -> tuple:
    """Every candidate of the three main-path kernels' launch knobs at
    the path's shapes (``knob_rows``; uncounted), then a 2-worker process
    fleet over one ``tuning_dir`` with the campaign's router and
    documents on the card, twice: the cold fleet sweeps (the workers'
    ``sweeps_run()`` sum above 0) and publishes a
    ``v1|fast_features|...|<card>|device`` key; a fresh fleet over the
    same directory sweeps 0 times and leaves the store's bytes as they
    were; both record sets equal A1's. Returns (the fleets' launches,
    the knob rows)."""
    import tempfile

    from repro_torch.core.campaign import CampaignExecutor, ExecutorConfig
    from repro_torch.core.engine import EngineConfig
    import torch

    from repro_torch.kernels import tuning_store

    free_cuda()
    t_phase = time.perf_counter()
    knobs = knob_rows(*knob_inputs)
    n = len(test)
    ecfg = EngineConfig(alpha=ALPHA, batch_size=256, seed=SEED)
    totals = dict.fromkeys(MAIN_KERNELS, 0)
    runs = []
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        tdir = Path(tmp) / "tuning"
        xcfg = ExecutorConfig(n_nodes=TUNE_WORKERS, runtime="process",
                              obs=True, seed=SEED, tuning_dir=str(tdir))

        def files():
            return {p.name: p.read_bytes() for p in tdir.iterdir()
                    if not p.name.startswith(".")}

        for label in ("cold", "warm"):
            res, row = fleet_run(
                f"T {label}, tuning_dir", lambda: CampaignExecutor(
                    ecfg, xcfg, router, ccfg, device="cuda").run(test),
                n, TUNE_WORKERS)
            assert same_records(res.records, single), f"T {label} records"
            g = res.obs_metrics["gauges"]
            sweeps = [int(g[f"autotune.sweeps.n{w}"])
                      for w in range(TUNE_WORKERS)]
            keys = tuning_store.TuningStore(str(tdir)).keys()
            runs.append({"run": label, "sweeps": sweeps, "store_keys": keys,
                         "store_bytes": sum(map(len, files().values())),
                         "start_and_stop_s": row["run_s"] - row["card_wall_s"],
                         "card_wall_s": row["card_wall_s"],
                         "workers": row["workers"]})
            for wk in row["workers"]:
                for k, v in wk["launches"].items():
                    totals[k] += v
            if label == "cold":
                cold_files = files()
        assert sum(runs[0]["sweeps"]) > 0, runs[0]
        assert sum(runs[1]["sweeps"]) == 0, runs[1]
        assert files() == cold_files, "the warm fleet changed the store"
        assert any(k.startswith("v1|fast_features|")
                   and k.endswith(f"|{card}|device")
                   for k in runs[0]["store_keys"]), runs[0]["store_keys"]
        winners = {k: tuning_store.TuningStore(str(tdir)).get(k)
                   for k in runs[0]["store_keys"]}
    for name in ("fast_features", "budget_route"):
        assert totals[name] > 0, totals
    emit({"phase": "autotune", "knobs": knobs, "fleet": runs,
          "fleet_winners": winners, "worker_launches": totals,
          "phase_s": time.perf_counter() - t_phase})
    return {k: totals.get(k, 0) for k in read_counts()}, knobs


# -------------------------------------------------------------- train

TRAIN_DOCS = 800        # 266 training docs: one SFT minibatch of 256
TRAIN_STEPS = 3         # timed steps a stage, after one warm-up step
SFT_BATCH = 256         # cut from sft_4k's 4096 (a TPU pod's global batch)
DPO_BATCH = 64          # pairs; cut from dpo_2k's 2048; the pairs of the
#                         first 64 training docs, as build_llm_router makes
SMALL_STEPS = 20        # train_small_parity: steps a stage


def encoder_forward_flops(cfg, b: int) -> float:
    """Matmul and attention FLOPs of one encoder forward over ``b``
    sequences of ``cfg.max_len`` tokens: Q, K, V, O and the two FFN
    matmuls, QK^T and PV over every key (the mask is a bias, so all S^2
    products are computed), and the pooler; the heads are negligible."""
    d, f, s = cfg.d_model, cfg.d_ff, cfg.max_len
    per_layer = 2 * b * s * (4 * d * d + 2 * d * f) + 4 * b * s * s * d
    return cfg.n_layers * per_layer + 2 * b * d * d


def embedding_grad_repeats(table, ids) -> dict:
    """The table's gradient of one lookup of ``ids``, taken twice from
    the same output grad, through ``index_select`` (whose backward is
    ``index_add_``) and through ``embed_lookup``: the largest difference
    between the two passes. Then one more pass of each under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (off
    again after it): the warnings it raised."""
    import warnings

    import torch

    from repro_torch.models.layers import embed_lookup

    flat = ids.reshape(-1).long()
    g = torch.randn((flat.numel(), table.shape[1]), device=table.device,
                    generator=torch.Generator(table.device).manual_seed(
                        SEED)).to(table.dtype)
    lookups = {"index_select": lambda t: t.index_select(0, flat),
               "embed_lookup": lambda t: embed_lookup(t, flat)}

    def grad(fn):
        t = table.detach().clone().requires_grad_(True)
        return torch.autograd.grad(fn(t), t, g)[0]

    out = {}
    for name, fn in lookups.items():
        a, b = grad(fn), grad(fn)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                grad(fn)
            finally:
                torch.use_deterministic_algorithms(False)
        out[name] = {
            "max_abs_diff": float((a.float() - b.float()).abs().max()),
            "deterministic_mode_warnings": sorted(
                {str(w.message)[:90] for w in caught})}
    assert out["embed_lookup"]["max_abs_diff"] == 0.0, out
    return out


def phase_train():
    """The router's three stages at full width through ``core/dpo.py``.
    Returns (launch counts, the trained encoder)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dpo
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus
    from repro_torch.launch.serve import llm_training_data
    from repro_torch.models.encoder import init_encoder

    cfg = get_config("adaparse-router").model
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.max_len, cfg.param_dtype, cfg.remat) == \
        (12, 768, 12, 3072, 31090, 512, "bfloat16", True), cfg
    ccfg = CorpusConfig(n_docs=TRAIN_DOCS, seed=SEED)
    train = generate_corpus(ccfg)[:TRAIN_DOCS // 3]
    reset_counts()
    t0 = time.perf_counter()
    _, reg, pref = llm_training_data(train, ccfg,
                                     np.random.RandomState(SEED + 1),
                                     cfg.max_len, "cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    counts = read_counts()
    assert counts["fast_features"] > 0, counts
    assert reg["tokens"].shape == (len(train), cfg.max_len)
    assert pref["tok_pos"].shape == (DPO_BATCH, cfg.max_len)
    enc = init_encoder(cfg, torch.Generator().manual_seed(SEED), "cuda")
    n_params = sum(p.numel() for p in enc.parameters())

    # (stage, trainer, data, lr, batch, prefix of the head the stage's
    # loss does not reach, model FLOPs a step: 3x the forward for the
    # trained pass, 1x for DPO's frozen reference)
    f_sft = 3 * encoder_forward_flops(cfg, SFT_BATCH)
    f_dpo = 4 * encoder_forward_flops(cfg, 2 * DPO_BATCH)
    stages = (("sft", dpo.fit_regression, reg, 1e-3, SFT_BATCH, "p.pref_",
               f_sft),
              ("dpo", dpo.fit_dpo, pref, 5e-4, DPO_BATCH, "p.head_", f_dpo),
              ("refit", dpo.fit_regression, reg, 1e-4, SFT_BATCH, "p.pref_",
               f_sft))
    out = {}
    for name, fit, data, lr, bs, unreached, flops in stages:
        _, first_s = synced(lambda: fit(enc, data, steps=1, lr=lr, bs=bs))
        before = {n: p.detach().clone() for n, p in enc.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        res, wall = synced(lambda: fit(enc, data, steps=TRAIN_STEPS, lr=lr,
                                       bs=bs))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert all(math.isfinite(x) for x in res.losses), res.losses
        moved = {n: int((p != before[n]).sum())
                 for n, p in enc.named_parameters()}
        changed = {n for n, k in moved.items() if k}
        reached = {n for n in before if not n.startswith(unreached)}
        still = sorted(reached - changed)
        if name == "sft":
            # from the init every parameter the loss reaches moves, but
            # for the norm scales: bf16 has no value between 1 - 2^-8
            # and 1 + 2^-7, so a scale of ones stays put under steps
            # below 2^-9 (AdamW's steps are about lr)
            assert lr < 2 ** -9 and all(
                bool((before[n] == 1).all()) for n in still), still
        else:
            # later stages: grads that have shrunk below AdamW's eps move
            # some bf16 weights not at all (reported); the head the stage
            # trains moves
            assert ("p.pref_w" if name == "dpo" else "p.head_w") in changed
        if name == "dpo":       # no grad, no decay: the regression head
            assert not changed - reached, changed - reached
        ms = wall / TRAIN_STEPS * 1e3
        out[name] = {"steps": TRAIN_STEPS, "batch": bs, "lr": lr,
                     "first_step_ms": first_s * 1e3, "ms_per_step": ms,
                     "samples_per_s": bs / (ms / 1e3), "peak_gb": peak_gb,
                     "losses": res.losses,
                     "model_tflop_per_step": flops / 1e12,
                     "model_tflops": flops / (ms / 1e3) / 1e12,
                     "share_of_989_bf16": flops / (ms / 1e3) / BF16_OPS_PER_S,
                     "unchanged_reached_params": still,
                     "moved_share_of_reached": sum(
                         moved[n] for n in reached) / sum(
                         before[n].numel() for n in reached)}
    prof = device_profile(lambda: dpo.fit_regression(enc, reg, steps=1,
                                                     lr=1e-4, bs=SFT_BATCH))
    emb = embedding_grad_repeats(enc.p["tok_embed"],
                                 reg["tokens"][:SFT_BATCH])
    emit({"phase": "train", "config": cfg.name, "card": card_line(),
          "params": n_params, "docs": len(train), "data_s": data_s,
          "reduced": {"sft_batch": f"{SFT_BATCH} of sft_4k's 4096",
                      "dpo_batch": f"{DPO_BATCH} pairs of dpo_2k's 2048",
                      "steps": f"1 + {TRAIN_STEPS} a stage"},
          "launches": counts, "stages": out,
          "sft_step_profile": prof, "embedding_grad_repeats": emb})
    return counts, enc


def phase_train_small_parity() -> None:
    """router-tiny (f32) from one exported init: 20 steps a stage on cuda
    and on cpu; then serve's build_llm_router twice on cuda."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dpo
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus
    from repro_torch.launch.serve import build_llm_router, llm_training_data
    from repro_torch.models.encoder import (encoder_from_jax_params,
                                            encoder_to_jax_params,
                                            init_encoder)

    small = get_config("adaparse-router").reduced().model
    ccfg = CorpusConfig(n_docs=150, seed=SEED)
    train = generate_corpus(ccfg)[:50]
    _, reg, pref = llm_training_data(train, ccfg,
                                     np.random.RandomState(SEED + 1),
                                     small.max_len, "cpu")
    raw = encoder_to_jax_params(
        init_encoder(small, torch.Generator().manual_seed(SEED), "cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        enc = encoder_from_jax_params(raw, small, dev)
        t0 = time.perf_counter()
        enc, diag = dpo.three_stage_posttrain(
            enc, reg, pref, sft_steps=SMALL_STEPS, dpo_steps=SMALL_STEPS,
            refit_steps=SMALL_STEPS)
        runs[dev] = (diag, encoder_to_jax_params(enc),
                     time.perf_counter() - t0)
    (dc, pc, wc), (dh, ph, wh) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for k in dh
                   for a, b in zip(dc[k], dh[k]))
    leaves = lambda t: [t[k] for k in sorted(t) if k != "layers"] + [
        t["layers"][k] for k in sorted(t["layers"])]
    param_diff = max(float(np.abs(a - b).max())
                     for a, b in zip(leaves(pc), leaves(ph)))
    assert all(len(dc[k]) == SMALL_STEPS for k in dc), dc
    assert loss_rel <= 1e-5 and param_diff <= 1e-4, (loss_rel, param_diff)

    # serve's reduced router, trained twice on the card: the same bits
    t0 = time.perf_counter()
    routers = [build_llm_router(train, ccfg, np.random.RandomState(SEED + 1),
                                device="cuda") for _ in range(2)]
    build_s = (time.perf_counter() - t0) / 2
    a, b = (list(r.encoder.parameters()) for r in routers)
    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
        "two cuda trainings differ"
    assert np.array_equal(routers[0].cls1.w, routers[1].cls1.w)
    emit({"phase": "train_small_parity", "config": small.name,
          "steps_a_stage": SMALL_STEPS, "loss_max_rel_diff": loss_rel,
          "param_max_abs_diff": param_diff, "tolerance":
          {"loss_rtol": 1e-5, "param_atol": 1e-4},
          "cuda_s": wc, "cpu_s": wh, "final_losses":
          {k: [dc[k][-1], dh[k][-1]] for k in dh},
          "build_llm_router_s": build_s, "two_cuda_trainings_bit_equal": True})


def phase_serve_llm() -> dict:
    """``serve --variant llm`` at the ft phase's sizes on cuda and on
    cpu. Each route step the engine makes is recorded (the engine's
    ``make_route_step`` is wrapped for the run) so that its device plan
    can be held against ``plan_batch`` on the same scores."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from repro_torch.core import engine, scheduler
    from repro_torch.launch import serve

    argv = ["--docs", "600", "--batch-size", "256", "--variant", "llm",
            "--seed", str(SEED)]
    steps = []
    real = engine.make_route_step

    def recording(alpha, **kw):
        step = real(alpha, **kw)

        def route_step(encoder, tokens, mask, valid_logit):
            res = step(encoder, tokens, mask, valid_logit)
            steps.append((alpha, encoder,
                          res["improvement"].float().cpu().numpy(),
                          res["selected_idx"].cpu().numpy()))
            return res
        return route_step

    engine.make_route_step = recording
    try:
        reset_counts()
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            res_cuda = serve.main(argv + ["--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        cuda_steps, steps[:] = list(steps), []
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            res_cpu = serve.main(argv + ["--device", "cpu"])
        cpu_wall = time.perf_counter() - t0
    finally:
        engine.make_route_step = real
    for name in ("fast_features", "budget_route"):
        assert counts[name] > 0, f"{name} did not launch: {counts}"
    n_batches = math.ceil((600 - 600 // 3) / 256)
    assert len(cuda_steps) == len(steps) == n_batches, (cuda_steps, steps)
    routed = []
    for alpha, enc, imp, idx in cuda_steps:
        assert enc.device.type == "cuda" and np.isfinite(imp).all()
        got = set(idx[idx >= 0].tolist())
        assert got == set(scheduler.plan_batch(imp, alpha).expensive_idx
                          .tolist()), (got, imp)
        routed.append(len(got))
    for res in (res_cuda, res_cpu):
        assert res["frac_expensive"] <= ALPHA, res
        assert all(math.isfinite(v) for v in res.values()), res
    cuda_enc, cpu_enc = cuda_steps[0][1], steps[0][1]
    assert cpu_enc.device.type == "cpu"
    diff = max(float((p.detach().cpu() - q).abs().max()) for p, q in
               zip(cuda_enc.parameters(), cpu_enc.parameters()))
    emit({"phase": "serve_llm", "argv": argv, "metrics_cuda": res_cuda,
          "metrics_cpu": res_cpu, "launches": counts,
          "batches": n_batches, "routed": routed,
          "device_plan_equals_plan_batch": True,
          "router_param_max_abs_diff_cuda_cpu": diff,
          "cuda_wall_s": wall, "cpu_wall_s": cpu_wall})
    return counts


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def device_profile(fn, top: int = 5, split: dict | None = None,
                   ranges: tuple = ()) -> dict:
    """One ``fn()`` under torch.profiler: host-clock wall time, the summed
    device time of the kernels and copies it ran, their share of the wall
    time (the device's busy share), their count, the ``top`` longest, and
    the four CUDA runtime calls (cudaMalloc, cudaLaunchKernel, ...) with
    the most host time, and the count of kernel launch calls. ``split``
    (name -> regex) also sums the device ms of the kernels whose name
    each regex finds first, the rest under "other". ``ranges`` names
    ``record_function`` ranges whose kernels' device ms are summed
    (``range_ms``; a range's own device-side annotation is not counted
    as a kernel). ``trace_stop_s`` and ``aggregate_s``: the host seconds
    the profiler then took to stop and to aggregate its events."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t_stop = time.perf_counter()
    t_agg = time.perf_counter()
    averages = prof.key_averages()      # aggregated once: it walks
    ops = [e for e in averages            # every event of the trace
           if e.device_type == DeviceType.CUDA and e.key not in ranges]
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    by_time = sorted(ops, key=lambda e: -e.self_device_time_total)

    def split_ms(patterns):
        out = dict.fromkeys([*patterns, "other"], 0.0)
        for e in ops:
            name = next((k for k, rx in patterns.items()
                         if re.search(rx, e.key)), "other")
            out[name] += e.self_device_time_total / 1e3
        return out

    runtime = sorted((e for e in averages
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith("cuda")),
                     key=lambda e: -e.self_cpu_time_total)[:4]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "device_ops": sum(e.count for e in ops),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in by_time[:top]],
            "host_runtime_top": [[e.key, e.self_cpu_time_total / 1e3,
                                  e.count] for e in runtime],
            "launch_calls": sum(e.count for e in averages
                                if e.key in ("cudaLaunchKernel",
                                             "cudaLaunchKernelExC",
                                             "cuLaunchKernel")),
            **({"split_ms": split_ms(split)} if split else {}),
            **({"range_ms": {
                r: sum(e.device_time_total for e in averages
                       if e.key == r and e.device_type == DeviceType.CPU)
                / 1e3 for r in ranges}} if ranges else {}),
            "trace_stop_s": t_agg - t_stop,
            "aggregate_s": time.perf_counter() - t_agg}


def phase_lm() -> dict:
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    cfg = dataclasses.replace(get_config("qwen3-1.7b").model,
                              attention_impl="pallas")   # full width, bf16
    assert (cfg.n_layers, cfg.d_model, cfg.param_dtype) == \
        (28, 2048, "bfloat16"), cfg
    dev = torch.device("cuda")
    b, s, n_dec = 4, 4096, 16
    t0 = time.perf_counter()
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    assert n_params == cfg.n_params(), (n_params, cfg.n_params())
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 1))
    T.prefill(params, cfg, toks[:, :256])          # warm the GEMM paths
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, cfg, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, n_dec)) for t in cache))
    nxt = logits.argmax(-1, keepdim=True)
    first_tok, dec_logits = nxt, []
    t0 = time.perf_counter()
    for i in range(n_dec):
        lg, cache = T.decode_step(params, cfg, nxt, cache, s + i)
        dec_logits.append(lg)
        nxt = lg.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert counts["flash_attention"] == cfg.n_layers, counts
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(lg).all()) for lg in dec_logits), \
        "non-finite decode logits"
    # where the time goes: two more decode steps (rewriting the last two
    # cache slots) and one prefill under the profiler
    decode_prof = device_profile(lambda: [
        T.decode_step(params, cfg, nxt, cache, s + n_dec - 2 + i)
        for i in range(2)])
    del cache
    prefill_prof = device_profile(lambda: T.prefill(params, cfg, toks))
    # the same prefill with naive attention: relative L2 of the last
    # position's logits within 2e-2 (bf16 rounding of p in naive; the
    # kernel keeps p in float32)
    t0 = time.perf_counter()
    logits_naive, cache_naive = T.prefill(
        params, dataclasses.replace(cfg, attention_impl="naive"), toks)
    torch.cuda.synchronize()
    naive_prefill_s = time.perf_counter() - t0
    del cache_naive
    err_naive = rel_l2(logits, logits_naive)
    assert err_naive <= 2e-2, f"pallas vs naive prefill: rel L2 {err_naive}"
    # both bf16 prefills against one computed in float32 from the same
    # bf16 weights (the kernel in f32): the bf16 noise floor of the model
    logits_f32, _ = T.prefill(
        params, dataclasses.replace(cfg, compute_dtype="float32"), toks)
    err_f32 = {"pallas_bf16": rel_l2(logits, logits_f32),
               "naive_bf16": rel_l2(logits_naive, logits_f32)}
    # the first decode step against the full forward at position S
    full, _ = T.lm_logits(params, cfg, torch.cat([toks, first_tok], 1))
    err_full = rel_l2(dec_logits[0], full[:, s])
    err_full_prefill = rel_l2(logits, full[:, s - 1])
    del full
    assert err_full <= 2e-2, f"decode vs full forward: rel L2 {err_full}"
    assert err_full_prefill <= 2e-2, err_full_prefill
    emit({"phase": "lm", "config": cfg.name, "attention_impl": "pallas",
          "n_params": n_params, "batch": b, "seq_len": s,
          "decode_steps": n_dec,
          "reduced": "batch 4 x 4096 tokens, where prefill_32k is global "
                     "batch 32 x 32768 (its KV cache alone would exceed "
                     "one card); full width and depth; random weights",
          "launches": counts, "init_s": init_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": b * s / prefill_s,
          "decode_s": decode_s, "decode_ms_per_step": decode_s / n_dec * 1e3,
          "decode_tokens_per_s": b * n_dec / decode_s,
          "naive_prefill_s": naive_prefill_s,
          "max_memory_allocated_gb": peak_gb,
          "rel_l2_vs_naive_prefill": err_naive,
          "rel_l2_decode_vs_full_forward": err_full,
          "rel_l2_prefill_vs_full_forward": err_full_prefill,
          "rel_l2_vs_f32_compute_prefill": err_f32,
          "profile": {"prefill": prefill_prof,
                      "decode_2_steps": decode_prof}})
    del params
    torch.cuda.empty_cache()
    return counts


def phase_lm_small_parity() -> None:
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    out = {}
    for arch in ("qwen3-1.7b", "h2o-danube-3-4b"):
        cfg = dataclasses.replace(get_config(arch).reduced().model,
                                  attention_impl="pallas")
        host = T.init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
        card = {k: ({n: t.cuda() for n, t in v.items()} if k == "layers"
                    else v.cuda()) for k, v in host.items()}
        toks = torch.randint(0, cfg.vocab_size, (2, 100),
                             generator=torch.Generator().manual_seed(SEED))
        errs = []
        runs = {}
        for name, p, dev in (("cuda", card, "cuda"), ("cpu", host, "cpu")):
            lg, cache = T.prefill(p, cfg, toks.to(dev))
            runs[name] = [lg.cpu()], KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 4))
                                               for t in cache))
        nxt = runs["cpu"][0][0].argmax(-1, keepdim=True)
        for i in range(4):
            for name, p, dev in (("cuda", card, "cuda"), ("cpu", host, "cpu")):
                lg, _ = T.decode_step(p, cfg, nxt.to(dev), runs[name][1],
                                      100 + i)
                runs[name][0].append(lg.cpu())
            nxt = runs["cpu"][0][-1].argmax(-1, keepdim=True)
        errs = [(a - b).abs().max().item()
                for a, b in zip(runs["cuda"][0], runs["cpu"][0])]
        # tolerance: 2e-5 on float32 logits (another summation order)
        assert max(errs) <= 2e-5, f"{cfg.name} cuda vs cpu: {errs}"
        out[cfg.name] = max(errs)
    emit({"phase": "lm_small_parity", "prefill_len": 100, "decode_steps": 4,
          "max_abs_err": out})


LM_TRAIN_BATCH = 2       # cut from train_4k's 256 (the TPU pod's global
#                          batch; the port, like the reference, does no
#                          gradient accumulation)
LM_TRAIN_STEPS = 3       # timed steps, after one warm-up step
LM_SMALL_STEPS = 5       # lm_train_small_parity: steps a device
OPT_SMALL_STEPS = 20     # Adafactor and compression: steps a device
# the training step's device time by kernel kind (first match wins):
# float32 GEMMs (xla_flash's score and PV products; TF32 is off), the
# other GEMMs (bf16), dtype casts and copies, reductions, and the other
# elementwise kernels
LM_TRAIN_SPLIT = {"gemm_f32": r"sgemm|f32f32_f32",
                  "gemm_bf16": r"gemm|nvjet|cutlass",
                  "copy": r"copy",
                  "reduce": r"reduce",
                  "elementwise": r"elementwise"}


def lm_train_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul params (the
    untied head included, the embedding gather not) x tokens, plus 3 x
    the causal attention's 4·B·H·S²·Dh/2 a layer."""
    d, h, hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_layer = d * h * dh + 2 * d * hk * dh + h * dh * d + 3 * d * f
    matmul = cfg.n_layers * per_layer + d * cfg.vocab_size
    attn = cfg.n_layers * 4 * b * h * s * s * dh / 2
    return 6 * matmul * b * s + 3 * attn


def phase_lm_train() -> dict:
    """Full-width bf16 qwen3-1.7b training steps through the port's
    ``lm_train_step`` (xla_flash attention, remat, chain_clip(AdamW))."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T

    arch = get_config("qwen3-1.7b")
    cfg = arch.model
    assert (cfg.n_layers, cfg.d_model, cfg.param_dtype, cfg.remat,
            cfg.attention_impl, cfg.q_chunk, cfg.kv_chunk,
            cfg.tie_embeddings) == (28, 2048, "bfloat16", True,
                                    "xla_flash", 512, 1024, False), cfg
    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")
    b, s = LM_TRAIN_BATCH, arch.shape("train_4k")["seq_len"]
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    leaves = S.lm_param_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    assert n_params == cfg.n_params(), (n_params, cfg.n_params())
    opt, kind = S._optimizer_for(arch)
    assert kind == "adamw"
    opt_state = opt.init(leaves)
    step_fn = S.lm_train_step(cfg, opt)
    batches = [S._lm_train_batch(cfg, b, s, seed, dev) for seed in
               range(1, LM_TRAIN_STEPS + 3)]
    # the first loss against a no-grad float32 forward of the same params
    with torch.no_grad():
        f32_loss, f32_s = synced(lambda: float(T.lm_loss(
            params, dataclasses.replace(cfg, compute_dtype="float32"),
            batches[0])[0]))
    free_cuda()
    before = [p.clone() for p in leaves]

    reset_counts()
    (_, opt_state, loss), first_s = synced(
        lambda: step_fn(params, opt_state, 0, batches[0]))
    losses = [float(loss)]
    unchanged = [i for i, (p, q) in enumerate(zip(leaves, before))
                 if torch.equal(p, q)]
    del before
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(1, LM_TRAIN_STEPS + 1):
        (_, opt_state, loss), sec = synced(
            lambda: step_fn(params, opt_state, i, batches[i]))
        losses.append(float(loss))
        step_s.append(sec)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab_size)) <= 2.0, losses
    rel_f32 = abs(losses[0] - f32_loss) / abs(f32_loss)
    assert rel_f32 <= 1e-2, (losses[0], f32_loss)
    assert not unchanged, f"leaves {unchanged} did not move in a step"
    assert counts["flash_attention"] == 0, counts   # xla_flash, as JAX

    def profiled():
        nonlocal opt_state
        _, opt_state, _ = step_fn(params, opt_state, LM_TRAIN_STEPS + 1,
                                  batches[-1])

    t0 = time.perf_counter()
    prof = device_profile(profiled, top=25, split=LM_TRAIN_SPLIT)
    profile_s = time.perf_counter() - t0
    ms = statistics.median(step_s) * 1e3
    flops = lm_train_flops(cfg, b, s)
    emit({"phase": "lm_train", "config": cfg.name, "card": card_line(),
          "n_params": n_params, "batch": b, "seq_len": s,
          "optimizer": "chain_clip(adamw(3e-4, weight_decay=0.1), 1.0)",
          "attention_impl": cfg.attention_impl, "remat": cfg.remat,
          "reduced": f"batch {b} x {s} where train_4k is global batch "
                     f"256 x 4096 (no gradient accumulation, as in the "
                     f"reference); full width and depth; random weights",
          "launches": counts, "first_step_ms": first_s * 1e3,
          "step_ms": [x * 1e3 for x in step_s], "ms_per_step": ms,
          "tokens_per_s": b * s / (ms / 1e3), "peak_gb": peak_gb,
          "losses": losses, "f32_forward_loss": f32_loss,
          "first_loss_rel_diff_vs_f32": rel_f32,
          "f32_forward_s": f32_s, "profile_s": profile_s,
          "phase_s": time.perf_counter() - phase_t0,
          "model_tflop_per_step": flops / 1e12,
          "model_tflops": flops / (ms / 1e3) / 1e12,
          "share_of_989_bf16": flops / (ms / 1e3) / BF16_OPS_PER_S,
          "profile": prof})
    del params, opt_state, leaves, batches
    free_cuda()
    return counts


class _GradScale:
    """An optimizer that records, per element, the smallest nonzero
    |gradient| any step handed it (inf where every one was zero), and
    the sum over the steps of the largest |update| of any element (the
    most one element can have moved), and otherwise is ``opt``."""

    def __init__(self, opt):
        self.opt, self.gmin, self.moved = opt, None, 0.0

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, step):
        a = [g.abs().masked_fill(g == 0, float("inf")) for g in grads]
        self.gmin = a if self.gmin is None else [
            x.minimum(y) for x, y in zip(self.gmin, a)]
        updates, state = self.opt.update(grads, state, params, step)
        self.moved += max(float(u.abs().max()) for u in updates)
        return updates, state


def _small_lm_steps(arch, cfg, init, dev, steps):
    """``steps`` of ``lm_train_step`` from ``init`` (cpu tensors, copied
    to ``dev``) with the arch's optimizer, on the seed t + 1 batches of
    the reduced train_4k: (losses, final leaves on the cpu, each leaf's
    smallest nonzero |gradient| over the steps on the cpu, and the sum
    over the steps of the largest |update|)."""
    from repro_torch.launch import specs as S

    shape = S._reduce_shape("lm", arch.shape("train_4k"))
    params = tree_to(init, dev)
    opt = _GradScale(S._optimizer_for(arch)[0])
    state = opt.init(S.lm_param_leaves(params))
    step_fn = S.lm_train_step(cfg, opt)
    losses = []
    for step in range(steps):
        batch = S._lm_train_batch(cfg, shape["global_batch"],
                                  shape["seq_len"], step + 1, dev)
        _, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    return (losses, [p.cpu() for p in S.lm_param_leaves(params)],
            [g.cpu() for g in opt.gmin], opt.moved)


#: AdamW's step, m_hat / (sqrt(v_hat) + eps), does not depend on the
#: gradient's scale above eps (1e-8): a gradient of 1e-7 moves its
#: element by about lr, as one of 1 does. The rounding of a leaf's
#: largest gradients (another summation order on another device) puts
#: an absolute error into every gradient of the leaf, a large share of
#: a small one, and AdamW turns that share into the same share of lr.
#: Elements ever handed a nonzero |gradient| below SMALL_GRAD are held
#: to what the optimizer can move one element in the run; the 1e-4
#: parameter bar holds every other element.
SMALL_GRAD = 1e-6


def param_gap(a, b, gmin, names, moved) -> dict:
    """Max |a - b| over the elements whose every nonzero gradient
    (``gmin``: the smallest) reached ``SMALL_GRAD``; for the rest, the
    small-gradient elements, their count, max gap, its limit ``moved``
    (the most one element moved in the run) and their count by leaf
    (``names``, the leaves' key paths)."""
    held, rest, by_leaf = 0.0, 0.0, {}
    for x, y, g, name in zip(a, b, gmin, names):
        d = (x - y).abs()
        m = g >= SMALL_GRAD
        if bool(m.any()):
            held = max(held, float(d[m].max()))
        if bool((~m).any()):
            rest = max(rest, float(d[~m].max()))
            by_leaf[name] = int((~m).sum())
    return {"held_max_abs_diff": held,
            "small_grad_elements": sum(by_leaf.values()),
            "small_grad_max_abs_diff": rest, "small_grad_limit": moved,
            "small_grad_by_leaf": by_leaf,
            "elements": sum(x.numel() for x in a)}


def _restart_on_cuda(tmp) -> dict:
    """``launch.train.main`` on cuda: 6 steps against 3, a checkpoint and
    a resume to 6 (bit-equal losses and final state), and the cuda
    checkpoint restored on the cpu bit for bit."""
    import contextlib
    import io

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train

    def main(*extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return train.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                               "--reduced", "--log-every", "100",
                               "--device", "cuda", *extra])

    full = main("--steps", "6", "--ckpt-dir", f"{tmp}/full",
                "--ckpt-every", "100")
    part = main("--steps", "3", "--ckpt-dir", f"{tmp}/ck", "--ckpt-every",
                "3")
    resumed = main("--steps", "6", "--ckpt-dir", f"{tmp}/ck",
                   "--ckpt-every", "100")
    assert part == full[:3] and resumed == full[3:], (full, part, resumed)
    trees = {(d, dev): ckpt._flatten(ckpt.restore(f"{tmp}/{d}",
                                                  device=dev)[1])
             for d in ("full", "ck") for dev in ("cuda", "cpu")}
    ref = trees[("full", "cuda")]
    for key, leaves in trees.items():
        assert [p for p, _ in leaves] == [p for p, _ in ref], key
        for (path, x), (_, y) in zip(leaves, ref):
            assert x.device.type == key[1], (key, path)
            assert torch.equal(x.cpu(), y.cpu()), (key, path)
    return {"losses": full, "leaves": len(ref)}


def phase_lm_train_small_parity() -> None:
    """qwen3-tiny (f32, chunks 16/32: xla_flash and its backward) from one
    exported init on cuda and cpu; two cuda runs; the train CLI's
    restart on cuda; Adafactor and compression on cuda against cpu."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as C

    arch = get_config("qwen3-1.7b").reduced()
    cfg = dataclasses.replace(arch.model, q_chunk=16, kv_chunk=32)
    init = T.init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
    runs = [_small_lm_steps(arch, cfg, init, dev, LM_SMALL_STEPS)[:2]
            for dev in ("cuda", "cpu", "cuda")]
    (lc, pc), (lh, ph), (lc2, pc2) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    assert loss_rel <= 1e-5 and param_diff <= 1e-4, (loss_rel, param_diff)
    assert lc == lc2 and all(torch.equal(a, b) for a, b in zip(pc, pc2)), \
        "two cuda trainings differ"
    with tempfile.TemporaryDirectory() as tmp:
        restart = _restart_on_cuda(tmp)

    # Adafactor (factored and unfactored leaves, a schedule, decay) and
    # int8 / top-k compression with error feedback, cuda against cpu
    rng = np.random.RandomState(SEED)
    shapes = [(256, 512), (3, 128, 256), (1000,), (4, 300)]
    p0 = [(rng.randn(*sh) * 0.1).astype(np.float32) for sh in shapes]
    grads = [[rng.randn(*sh).astype(np.float32) for sh in shapes]
             for _ in range(OPT_SMALL_STEPS)]

    def adafactor_run(dev):
        opt = O.adafactor(O.warmup_cosine(1e-2, 5, OPT_SMALL_STEPS),
                          weight_decay=0.01)
        p = [torch.tensor(a, device=dev) for a in p0]
        st = opt.init(p)
        for step, g in enumerate(grads):
            u, st = opt.update([torch.tensor(x, device=dev) for x in g], st,
                               p, step)
            O.apply_updates(p, u)
        assert [set(x) for x in st["v"]] == [{"vr", "vc"}] * 2 + [{"v"}] * 2
        return [x.cpu() for x in p]

    def compression_run(dev, scheme):
        st = C.init_compression_state([torch.tensor(a, device=dev)
                                       for a in p0])
        outs = []
        for g in grads:
            c, st, _ = C.compressed_gradients(
                [torch.tensor(x, device=dev) for x in g], st, scheme=scheme,
                topk_ratio=0.05)
            outs += [x.cpu() for x in c + st]
        return outs

    opt_diff = {"adafactor": max(float((a - b).abs().max()) for a, b in zip(
        adafactor_run("cuda"), adafactor_run("cpu")))}
    for scheme in ("int8", "topk"):
        opt_diff[scheme] = max(float((a - b).abs().max()) for a, b in zip(
            compression_run("cuda", scheme), compression_run("cpu", scheme)))
    assert max(opt_diff.values()) <= 1e-6, opt_diff
    emit({"phase": "lm_train_small_parity", "config": cfg.name,
          "steps": LM_SMALL_STEPS, "loss_max_rel_diff": loss_rel,
          "param_max_abs_diff": param_diff, "losses": {"cuda": lc,
                                                       "cpu": lh},
          "tolerance": {"loss_rtol": 1e-5, "param_atol": 1e-4,
                        "optimizer_atol": 1e-6},
          "two_cuda_trainings_bit_equal": True,
          "train_main_restart_bit_equal": True,
          "cuda_checkpoint_restores_on_cpu_bit_equal": True,
          "train_main_losses": restart["losses"],
          "optimizer_steps": OPT_SMALL_STEPS,
          "optimizer_max_abs_diff": opt_diff})


# ------------------------------------------------------- phases 18-20: MoE


def tree_to(tree: dict, dev) -> dict:
    """A copy of a (nested) dict of tensors on ``dev``."""
    return {k: tree_to(v, dev) if isinstance(v, dict)
            else v.to(dev, copy=True) for k, v in tree.items()}


def lm_param_count(params: dict) -> int:
    from repro_torch.launch.specs import lm_param_leaves

    return sum(t.numel() for t in lm_param_leaves(params))


def kept_by_expert(rec: dict, n_experts: int):
    """A top-k routing record -> (T, E) bool: token t's slot at expert e
    was kept (chosen and within the capacity)."""
    import torch

    eids = rec["eids"].cpu()
    return torch.zeros((eids.shape[0], n_experts), dtype=torch.bool) \
        .scatter_(1, eids, rec["keep"].cpu())


def routing_flips(a: list, b: list, n_experts: int) -> list[dict]:
    """Per layer: tokens whose top-k expert set differs between two
    routing traces, and (token, expert) pairs kept in one and not the
    other."""
    out = []
    for ra, rb in zip(a, b):
        ea = ra["eids"].sort(-1).values
        eb = rb["eids"].sort(-1).values
        out.append({"tokens": int((ea != eb).any(-1).sum()),
                    "kept_pairs": int((kept_by_expert(ra, n_experts)
                                       != kept_by_expert(rb, n_experts))
                                      .sum())})
    return out


def moe_layer0_parity(params, cfg, toks, n_tok: int = 1024) -> dict:
    """Layer 0's MoE on the first ``n_tok`` of its real bf16 inputs (the
    prefill's own layer 0 up to the FFN norm): the card's bf16 result
    against the port's plain float32 computation on the cpu from the
    same weights. Routing (expert sets and the kept mask) must agree but
    for flips whose float32 probability gap (between the k-th and the
    (k+1)-th expert) is below 1e-4, and each flip is counted; the
    outputs within 2e-2 relative L2."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm

    lp = T._layers(params)[0]
    with torch.no_grad():
        x = T._embed(params, cfg, toks[:1, :n_tok])
        pos = torch.arange(n_tok, device=x.device)
        q, k, v = T._qkv(x, lp, cfg, pos)
        o = A.attention(q, k, v, causal=True, window=cfg.sliding_window,
                        impl=cfg.attention_impl, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
        h = rms_norm(T._attn_out(x, o, lp), lp["ln_ffn"], cfg.norm_eps)
        xt = h.reshape(n_tok, cfg.d_model)
        with M.routing_trace() as tr_card:
            y_card, aux_card = M._moe_local(xt, lp["moe"], cfg.moe)
        p32 = {n: w.float().cpu() for n, w in lp["moe"].items()}
        xt32 = xt.float().cpu()
        with M.routing_trace() as tr_cpu:
            y_cpu, aux_cpu = M._moe_local(xt32, p32, cfg.moe)
        probs = M.router_probs(xt32, p32["router"], cfg.moe)
    kk = cfg.moe.top_k
    top = probs.sort(-1, descending=True).values
    gap = (top[:, kk - 1] - top[:, kk])
    ea = tr_card[0]["eids"].cpu().sort(-1).values
    eb = tr_cpu[0]["eids"].sort(-1).values
    flipped = (ea != eb).any(-1)
    E = cfg.moe.n_experts
    keep_diff = int((kept_by_expert(tr_card[0], E)
                     != kept_by_expert(tr_cpu[0], E)).sum())
    flip_gaps = [float(g) for g in gap[flipped]]
    err = rel_l2(y_card.cpu(), y_cpu)
    assert all(g < 1e-4 for g in flip_gaps), \
        f"layer-0 routing flips at probability gaps {flip_gaps}"
    assert err <= 2e-2, f"layer-0 MoE cuda bf16 vs cpu f32: rel L2 {err}"
    return {"tokens": n_tok, "rel_l2_vs_cpu_f32": err,
            "aux": {"cuda": float(aux_card), "cpu_f32": float(aux_cpu)},
            "routing_flips": int(flipped.sum()), "flip_prob_gaps": flip_gaps,
            "kept_pair_diffs": keep_diff,
            "median_prob_gap": float(gap.median()),
            "min_prob_gap": float(gap.min())}


MOE_RANGES = ("moe.dispatch", "moe.experts", "moe.combine")


def phase_lm_moe() -> dict:
    """OLMoE-1B-7B as registered: 16 layers, d = 2048, 64 experts top-8,
    bf16, random weights drawn on the card; prefill 4 x 4096 with the
    flash_attention kernel, then 16 decode steps."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").model,
                              attention_impl="pallas")
    assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.param_dtype) == (16, 2048, 64, 8, "bfloat16"), cfg
    dev = torch.device("cuda")
    b, s, n_dec = 4, 4096, 16
    t0 = time.perf_counter()
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm_param_count(params)
    assert n_params == cfg.n_params() == 6_919_100_416, n_params
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 1))
    T.prefill(params, cfg, toks[:, :256])          # warm the GEMM paths
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    with M.routing_trace() as trace:
        (logits, cache), prefill_s = synced(
            lambda: T.prefill(params, cfg, toks))
    cache = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, n_dec)) for t in cache))
    cache0 = KVCache(cache.k.clone(), cache.v.clone())

    def decode(c):
        nxt, out = logits.argmax(-1, keepdim=True), []
        for i in range(n_dec):
            lg, c = T.decode_step(params, cfg, nxt, c, s + i)
            out.append(lg)
            nxt = lg.argmax(-1, keepdim=True)
        return out

    dec_logits, decode_s = synced(lambda: decode(cache))
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert counts["flash_attention"] == cfg.n_layers, counts
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(lg).all()) for lg in dec_logits), \
        "non-finite decode logits"
    dropped = [float(1.0 - r["keep"].float().mean()) for r in trace]

    # determinism: a second prefill and a second decode run (from the
    # same cache) equal the first bit for bit
    logits2, cache2 = T.prefill(params, cfg, toks)
    assert torch.equal(logits, logits2), "two prefills differ"
    assert torch.equal(cache2.k, cache0.k[:, :, :s]), "two prefill caches"
    del cache2
    dec2 = decode(cache0)
    assert all(torch.equal(a, c) for a, c in zip(dec_logits, dec2)), \
        "two decode runs differ"
    del cache0, dec2

    layer0 = moe_layer0_parity(params, cfg, toks)
    # the prefill with naive attention: relative L2 of the last
    # position's logits and each layer's routing flips (reported: a
    # flipped expert moves a token by far more than bf16 noise)
    ncfg = dataclasses.replace(cfg, attention_impl="naive")
    with M.routing_trace() as trace_naive:
        logits_naive, _ = T.prefill(params, ncfg, toks)
    flips = routing_flips(trace, trace_naive, cfg.moe.n_experts)
    err_naive = rel_l2(logits, logits_naive)
    del logits_naive, trace_naive
    prof = device_profile(lambda: T.prefill(params, cfg, toks), top=8,
                          split={"flash_attention": r"flash"},
                          ranges=MOE_RANGES)
    rng_ms = prof["range_ms"]
    other = prof["device_ms"] - sum(rng_ms.values()) \
        - prof["split_ms"]["flash_attention"]
    tokens = b * s
    flops = 2 * cfg.n_active_params() * tokens
    emit({"phase": "lm_moe", "config": cfg.name, "attention_impl": "pallas",
          "n_params": n_params, "n_active_params": cfg.n_active_params(),
          "batch": b, "seq_len": s, "decode_steps": n_dec,
          "reduced": "batch 4 x 4096 tokens, where prefill_32k is global "
                     "batch 32 x 32768 (its KV cache alone is 137.4 GB); "
                     "full width and depth; random weights",
          "launches": counts, "init_s": init_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": tokens / prefill_s,
          "prefill_model_tflops": flops / prefill_s / 1e12,
          "model_flops": "2 x active params x tokens",
          "decode_s": decode_s, "decode_ms_per_step": decode_s / n_dec * 1e3,
          "decode_tokens_per_s": b * n_dec / decode_s,
          "max_memory_allocated_gb": peak_gb,
          "capacity_dropped_share_by_layer": dropped,
          "two_prefills_bit_equal": True, "two_decodes_bit_equal": True,
          "layer0_moe_vs_cpu_f32": layer0,
          "rel_l2_vs_naive_prefill": err_naive,
          "routing_flips_vs_naive_by_layer": flips,
          "prefill_device_split_ms": {
              "expert_products": rng_ms["moe.experts"],
              "dispatch_combine": rng_ms["moe.dispatch"]
              + rng_ms["moe.combine"],
              "flash_attention": prof["split_ms"]["flash_attention"],
              "other": other},
          "profile": prof, "phase_s": time.perf_counter() - t_phase})
    del params, cache, logits
    free_cuda()
    return counts


def phase_lm_moe_small_parity() -> None:
    """olmoe-tiny and grok-tiny (f32) on cuda against cpu: prefill,
    decode and lm_logits within 2e-5; 5 train steps with each config's
    optimizer (AdamW, Adafactor) within 2e-5 on the losses and 1e-4 on
    the params (small-gradient elements: within the most one element
    moved), and two cuda trainings bit-equal; the budget router cuda
    against cpu."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    t_phase = time.perf_counter()
    out = {}
    for arch_id in ("olmoe-1b-7b", "grok-1-314b"):
        arch = get_config(arch_id).reduced()
        cfg = dataclasses.replace(arch.model, attention_impl="pallas")
        host = T.init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
        card = tree_to(host, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 100),
                             generator=torch.Generator().manual_seed(SEED))
        runs = {}
        for name, p, dev in (("cuda", card, "cuda"), ("cpu", host, "cpu")):
            lg, cache = T.prefill(p, cfg, toks.to(dev))
            full, aux = T.lm_logits(p, cfg, toks.to(dev))
            runs[name] = [lg.cpu(), full.cpu(), aux.cpu()], KVCache(
                *(F.pad(t, (0, 0, 0, 0, 0, 4)) for t in cache))
        nxt = runs["cpu"][0][0].argmax(-1, keepdim=True)
        for i in range(4):
            for name, p, dev in (("cuda", card, "cuda"), ("cpu", host, "cpu")):
                lg, _ = T.decode_step(p, cfg, nxt.to(dev), runs[name][1],
                                      100 + i)
                runs[name][0].append(lg.cpu())
            nxt = runs["cpu"][0][-1].argmax(-1, keepdim=True)
        errs = [float((a - c).abs().max())
                for a, c in zip(runs["cuda"][0], runs["cpu"][0])]
        # tolerance: 2e-5 on float32 logits and aux (another summation
        # order; the routing is equal)
        assert max(errs) <= 2e-5, f"{cfg.name} cuda vs cpu: {errs}"

        tcfg = dataclasses.replace(arch.model, q_chunk=16, kv_chunk=32)
        init = T.init_lm(tcfg, torch.Generator().manual_seed(SEED), "cpu")
        (lc, pc, _, _), (lh, ph, gmin, moved), (lc2, pc2, _, _) = [
            _small_lm_steps(arch, tcfg, init, dev, LM_SMALL_STEPS)
            for dev in ("cuda", "cpu", "cuda")]
        loss_diff = max(abs(a - c) for a, c in zip(lc, lh))
        names = ["/".join(map(str, path))
                 for path, _ in ckpt_lib._flatten(init)]
        gap = param_gap(pc, ph, gmin, names, moved)
        # params within 1e-4, but at small-gradient elements, which
        # must be rare (under 1% of the elements) and within what the
        # optimizer moved one element in the run
        assert loss_diff <= 2e-5 and gap["held_max_abs_diff"] <= 1e-4 \
            and gap["small_grad_elements"] <= 1e-2 * gap["elements"] \
            and gap["small_grad_max_abs_diff"] <= moved, \
            (cfg.name, loss_diff, gap)
        assert lc == lc2 and all(torch.equal(a, c)
                                 for a, c in zip(pc, pc2)), \
            f"{cfg.name}: two cuda trainings differ"
        out[cfg.name] = {"forward_max_abs_err": max(errs),
                         "train_loss_max_abs_diff": loss_diff,
                         "train_param_gap": gap,
                         "losses": {"cuda": lc, "cpu": lh}}

    # the budget router (expert choice), with duplicated tokens that tie
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, router="budget",
                     budget_alpha=0.2)
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(2, 64, 128, generator=g)
    x[:, 1::2] = x[:, ::2]
    p = M.init_moe(g, 128, mcfg, torch.float32)
    with M.routing_trace() as tc:
        yc, ac = M.moe_ffn(x.cuda(), tree_to(p, "cuda"), mcfg)
    with M.routing_trace() as th:
        yh, ah = M.moe_ffn(x, p, mcfg)
    assert torch.equal(tc[0]["tok"].cpu(), th[0]["tok"]), "budget routing"
    budget_err = max(float((yc.cpu() - yh).abs().max()),
                     abs(float(ac) - float(ah)))
    assert budget_err <= 2e-5, budget_err
    emit({"phase": "lm_moe_small_parity", "prefill_len": 100,
          "decode_steps": 4, "train_steps": LM_SMALL_STEPS,
          "optimizers": {"olmoe-tiny": "adamw", "grok-tiny": "adafactor"},
          "tolerance": {"forward_atol": 2e-5, "loss_atol": 2e-5,
                        "param_atol": 1e-4,
                        "param_atol_small_grad": "elements ever handed "
                                                 "a nonzero |grad| < 1e-6 "
                                                 "are held to the most "
                                                 "one element moved: sum "
                                                 "over steps of max "
                                                 "|update|"},
          "two_cuda_trainings_bit_equal": True, "configs": out,
          "budget_router_max_abs_err": budget_err,
          "phase_s": time.perf_counter() - t_phase})


#: lm_phi3: how much further than the naive bf16 prefill the kernel's
#: bf16 prefill may lie from the float32 one (rel L2 of the four
#: sequences' logits). Errors add in quadrature, so 1.02 admits a kernel
#: error of about a fifth of the model's bf16 noise.
PHI3_NOISE_MARGIN = 1.02
TILE = 64                # lm_phi3's control: the KV tile it loses


def tile_lost_prefill(params, cfg, toks):
    """The control of lm_phi3's bar: the bf16 prefill through a
    flash_attention that loses the first KV tile's values (V of keys 0
    to TILE - 1 read as zero, their weight kept in the normaliser), as
    a kernel that skips a tile's P V product would."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T

    real = fa_ops.flash_attention

    def lossy(q, k, v, **kw):
        v = v.clone()
        v[:, :TILE] = 0
        return real(q, k, v, **kw)

    fa_ops.flash_attention = lossy
    try:
        return T.prefill(params, cfg, toks)[0]
    finally:
        fa_ops.flash_attention = real


def phase_lm_phi3() -> dict:
    """phi3-medium-14b as registered (40 layers, d = 5120, H 40 / Hk 10),
    bf16, random weights drawn on the card: prefill 4 x 4096 with the
    flash_attention kernel and 4 decode steps, held to the dense bars."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("phi3-medium-14b").model,
                              attention_impl="pallas")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.param_dtype) == (40, 5120, 40, 10, "bfloat16"), cfg
    dev = torch.device("cuda")
    b, s, n_dec = 4, 4096, 4
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced(lambda: T.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = lm_param_count(params)
    assert n_params == cfg.n_params() == 14_659_507_200, n_params
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 1))
    T.prefill(params, cfg, toks[:, :256])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), prefill_s = synced(lambda: T.prefill(params, cfg, toks))
    cache = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, n_dec)) for t in cache))
    nxt = logits.argmax(-1, keepdim=True)
    first_tok, dec_logits = nxt, []
    t0 = time.perf_counter()
    for i in range(n_dec):
        lg, cache = T.decode_step(params, cfg, nxt, cache, s + i)
        dec_logits.append(lg)
        nxt = lg.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert counts["flash_attention"] == cfg.n_layers, counts
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    assert all(bool(torch.isfinite(lg).all()) for lg in dec_logits)
    del cache
    torch.cuda.empty_cache()
    # the naive prefill one sequence at a time: at B = 4 its float32
    # (B, H, S, S) scores are 10.7 GB a tensor, and beside 29.3 GB of
    # weights its einsums do not fit the card
    ncfg = dataclasses.replace(cfg, attention_impl="naive")
    logits_naive = torch.cat([T.prefill(params, ncfg, toks[i:i + 1])[0]
                              for i in range(b)])
    err_naive = rel_l2(logits, logits_naive)
    full, _ = T.lm_logits(params, cfg, torch.cat([toks, first_tok], 1))
    err_full = rel_l2(dec_logits[0], full[:, s])
    del full
    # At 40 layers the two bf16 bars above sit at the model's own bf16
    # noise (random weights: qwen3's two bf16 prefills are equally far,
    # 0.0177, from its float32 one), so they are reported; held instead,
    # on all four sequences against the model computed in float32: the
    # kernel's bf16 prefill no further from it than the naive bf16
    # prefill (within PHI3_NOISE_MARGIN), where a kernel that loses a KV
    # tile (the control) lands far past it; and in float32, on sequence
    # 0, the first decode step within 1e-3 of the full forward (the
    # cache, off bf16 noise)
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits32, cache32 = T.prefill(params, c32, toks[:1])
    logits32 = torch.cat([logits32] + [T.prefill(params, c32,
                                                 toks[i:i + 1])[0]
                                       for i in range(1, b)])
    cache32 = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 1)) for t in cache32))
    dec32, _ = T.decode_step(params, c32, first_tok[:1], cache32, s)
    del cache32
    full32, _ = T.lm_logits(params, c32, torch.cat([toks[:1],
                                                     first_tok[:1]], 1))
    err_dec32 = rel_l2(dec32, full32[:, s])
    del full32
    torch.cuda.empty_cache()
    logits_ctl = tile_lost_prefill(params, cfg, toks)
    vs_f32 = {"pallas_bf16": rel_l2(logits, logits32),
              "naive_bf16": rel_l2(logits_naive, logits32),
              "tile_lost_control": rel_l2(logits_ctl, logits32)}
    vs_f32_seq = {k: [rel_l2(x[i], logits32[i]) for i in range(b)]
                  for k, x in (("pallas_bf16", logits),
                               ("naive_bf16", logits_naive),
                               ("tile_lost_control", logits_ctl))}
    del logits_naive, logits_ctl
    bar = PHI3_NOISE_MARGIN * vs_f32["naive_bf16"]
    assert vs_f32["pallas_bf16"] <= bar < vs_f32["tile_lost_control"], \
        vs_f32
    assert err_dec32 <= 1e-3, f"f32 decode vs full forward: {err_dec32}"
    tokens = b * s
    emit({"phase": "lm_phi3", "config": cfg.name, "attention_impl": "pallas",
          "n_params": n_params, "batch": b, "seq_len": s,
          "decode_steps": n_dec,
          "reduced": "batch 4 x 4096 tokens, where prefill_32k is global "
                     "batch 32 x 32768; full width and depth; random "
                     "weights",
          "launches": counts, "init_s": init_s,
          "init_peak_gb": init_peak_gb, "prefill_s": prefill_s,
          "prefill_tokens_per_s": tokens / prefill_s,
          "prefill_model_tflops": 2 * n_params * tokens / prefill_s / 1e12,
          "decode_ms_per_step": decode_s / n_dec * 1e3,
          "max_memory_allocated_gb": peak_gb,
          "rel_l2_vs_naive_prefill": err_naive,
          "rel_l2_decode_vs_full_forward": err_full,
          "rel_l2_vs_f32_compute_prefill": vs_f32,
          "rel_l2_vs_f32_compute_prefill_per_seq": vs_f32_seq,
          "vs_f32_margin": PHI3_NOISE_MARGIN,
          "rel_l2_f32_decode_vs_full_forward_seq0": err_dec32,
          "phase_s": time.perf_counter() - t_phase})
    del params, logits
    free_cuda()
    return counts


def dlrm_scores_plain_lookup(params, cfg, batch):
    """``recsys_scores`` itself, with only ``emb.lookup_fields`` swapped
    for a plain ``index_select`` on the same table for this one call."""
    from repro_torch.models.recsys import embedding as E
    from repro_torch.models.recsys import models as M

    def plain_lookup(table, offsets, ids):
        flat = (ids + offsets[None, :].to(ids.dtype)).reshape(-1)
        return table.index_select(0, flat).view(*ids.shape, table.shape[1])

    kernel_lookup = E.lookup_fields
    E.lookup_fields = plain_lookup
    try:
        return M.recsys_scores(params, cfg, batch)
    finally:
        E.lookup_fields = kernel_lookup


def phase_recsys() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import _recsys_batch
    from repro_torch.models.recsys import embedding as E
    from repro_torch.models.recsys import models as M

    arch = get_config("dlrm-mlperf")
    cfg = arch.model                                   # full width, bf16
    assert (cfg.n_dense, cfg.n_sparse, cfg.embed_dim, cfg.param_dtype) == \
        (13, 26, 128, "bfloat16"), cfg
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params = M.init_recsys(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_gb = params["table"].numel() * params["table"].element_size() / 1e9
    assert params["table"].shape == (E.table_offsets(cfg.vocab_sizes, 512)[1],
                                     cfg.embed_dim), params["table"].shape
    batches = {s.name: {k: v for k, v in _recsys_batch(
        cfg, s["batch"], seed=SEED, device=dev).items() if k != "labels"}
        for s in arch.shapes if s.name in ("serve_p99", "serve_bulk")}
    reps = {"serve_p99": 20, "serve_bulk": 5}
    res = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        for name, batch in batches.items():
            M.recsys_scores(params, cfg, batch)        # warm the GEMM paths
            walls = []
            for _ in range(reps[name]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = M.recsys_scores(params, cfg, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            res[name] = {"batch": batch["dense"].shape[0],
                         "forwards": reps[name] + 1, "scores": scores,
                         "wall_ms": statistics.median(walls),
                         "wall_ms_min": min(walls)}
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = sum(r["forwards"] for r in res.values())
    # exactly one embedding_bag launch per forward, and nothing else
    assert counts["embedding_bag"] == n_fwd, (counts, n_fwd)
    assert all(v == 0 for k, v in counts.items() if k != "embedding_bag"), \
        counts
    with torch.inference_mode():
        for name, r in res.items():
            s = r.pop("scores")
            assert s.shape == (r["batch"],) and s.dtype == torch.float32
            assert bool(torch.isfinite(s).all()), f"{name}: non-finite"
            assert bool(((s > 0) & (s < 1)).all()), f"{name}: outside (0, 1)"
            plain = dlrm_scores_plain_lookup(params, cfg, batches[name])
            # the kernel's lookup equals the gather bit for bit, so the
            # scores must too
            assert torch.equal(s, plain), f"{name}: differs from the " \
                f"plain-lookup forward by {(s - plain).abs().max().item()}"
            r.update(equal_to_plain_lookup=True,
                     samples_per_s=r["batch"] / r["wall_ms"] * 1e3,
                     score_mean=float(s.mean()), score_std=float(s.std()))
        prof = device_profile(lambda: M.recsys_scores(
            params, cfg, batches["serve_bulk"]))
    emit({"phase": "recsys", "config": cfg.name,
          "table": {"rows": params["table"].shape[0], "gb": table_gb,
                    "dtype": cfg.param_dtype},
          "reduced": "none: full width and the full MLPerf Criteo-1TB "
                     "vocab; random weights", "init_s": init_s,
          "launches": counts, "shapes": res,
          "max_memory_allocated_gb": peak_gb,
          "max_memory_beyond_table_gb": peak_gb - table_gb,
          "profile_serve_bulk": prof})
    del params, batches
    free_cuda()
    return counts


def phase_recsys_small_parity() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.launch.specs import _recsys_batch
    from repro_torch.models.recsys import models as M

    cfg = get_config("dlrm-mlperf").reduced().model     # dlrm-tiny, f32
    host = M.init_recsys(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = {k: (v.to(DEVICE) if k == "table" else
                [{n: t.to(DEVICE) for n, t in layer.items()} for layer in v])
            for k, v in host.items()}
    batch = {k: v for k, v in _recsys_batch(cfg, 256, seed=SEED,
                                            device="cpu").items()
             if k != "labels"}
    before = eb.KERNEL.launches
    got = M.recsys_scores(card, cfg, {k: v.to(DEVICE)
                                      for k, v in batch.items()})
    assert eb.KERNEL.launches == before + 1
    want = M.recsys_scores(host, cfg, batch)
    err = (got.cpu() - want).abs().max().item()
    # tolerance: 2e-5 on float32 scores (another summation order)
    assert err <= 2e-5, f"{cfg.name} cuda vs cpu: {err}"
    emit({"phase": "recsys_small_parity", "config": cfg.name, "batch": 256,
          "max_abs_err": err})


def phase_gnn() -> dict:
    import torch

    from repro_torch.kernels.segment_mm import ops
    from repro_torch.models.layers import embed_lookup

    dev = torch.device(DEVICE)
    x, src, dst, w = gnn_inputs(dev)
    n = x.shape[0]

    # the first step at full size (not counted), profiled: it finds no
    # block of the caching allocator and no sort workspace in place
    cold = device_profile(lambda: ops.segment_matmul(x, src, dst, w,
                                                     n_nodes=n))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, wall_s = synced(lambda: ops.segment_matmul(x, src, dst, w,
                                                    n_nodes=n))
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert counts["segment_mm"] == 1, counts
    assert all(v == 0 for k, v in counts.items() if k != "segment_mm"), counts
    assert out.shape == (n, w.shape[1]) and bool(torch.isfinite(out).all())
    # the same step in its three parts, each ended by a synchronise
    order, argsort_s = synced(lambda: torch.argsort(dst, stable=True))
    (xg, dsorted), gather_s = synced(
        lambda: (embed_lookup(x, src[order]), dst[order]))
    del order
    free_cuda()
    out2, kernel_s = synced(lambda: ops.segment_matmul_kernel(
        xg, w, dsorted, n_nodes=n))
    assert torch.equal(out, out2), "segment_matmul: two runs differ"
    del out2
    cmp = compare_segment_mm(out, xg, w, dsorted, n)
    prof = device_profile(lambda: ops.segment_matmul(x, src, dst, w,
                                                     n_nodes=n))
    emit({"phase": "gnn", "shape": "ogb_products",
          "n_nodes": n, "n_edges": xg.shape[0], "d_in": x.shape[1],
          "d_out": w.shape[1], "dtype": "float32",
          "reduced": "none: the ogb_products node and edge counts and "
                     "d_feat; d_out = equiformer-v2's d_hidden; uniform "
                     "random edges and features",
          "launches": counts, "wall_ms": wall_s * 1e3,
          "split_ms": {"argsort": argsort_s * 1e3, "gather": gather_s * 1e3,
                       "kernel_with_sorted_check": kernel_s * 1e3},
          "cold_step_profile": cold,
          "two_runs_bit_identical": True, "vs_plain": cmp,
          "max_memory_allocated_gb": peak_gb, "profile": prof})
    del x, src, dst, w, xg, dsorted, out
    free_cuda()
    return counts


# -------------------------------------------------------------- main


def body_resources(ptxas: list[str]) -> dict:
    """Registers and static shared memory that ptxas reports for the
    bf16 tensor-core flash body (per padded head dim), the segment_mm
    kernel (per id type) and the budget_route kernel (per rows a thread
    and block size bound), with the dynamic shared memory each launch
    asks for, as the library and the wrapper compute it (segment_mm's at
    ``ogb_products``, D_in = 100)."""
    import re

    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.segment_mm import ops as sm

    seg_dyn = sm.smem_bytes(100, sm.block_plan(100, GNN_D_OUT)[0])
    out, entry, dyn = {}, None, 0
    for ln in ptxas:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            tc = re.search(r"flash_fwd_tc_kernelILi(\d+)E", name)
            seg = re.search(r"segmm_kernelI([a-z])E", name)
            route = re.search(r"route_kernelILi(\d+)ELi(\d+)E", name)
            entry = (f"flash_attention bf16 DP={tc.group(1)}" if tc else
                     f"segment_mm dst {'int64' if seg.group(1) == 'x' else 'int32'}"
                     if seg else
                     f"budget_route R={route.group(1)} threads<={route.group(2)}"
                     if route else None)
            dyn = (fa.launch_smem_bytes(torch.bfloat16, int(tc.group(1)))
                   if tc else 0 if route else seg_dyn)
        elif entry and "registers" in ln:
            out[entry] = f"{ln.split(': ', 1)[-1]}, {dyn} bytes dynamic smem"
            entry = None
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: torch and numpy are needed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "library": lib.name,
          "sources": [str(p.relative_to(ROOT))
                      for p in cuda_lib.sources()], "ptxas": ptxas,
          "ptxas_kernel_bodies": body_resources(ptxas)})
    dev = torch.device("cuda")

    ccfg, docs, pages = corpus_batch(256)
    from repro_torch.core import parsers as P

    exp_pages = P.run_parser_batch(P.EXPENSIVE_PARSER, docs, ccfg,
                                   np.random.RandomState(1))
    rows = (check_fast_features(ccfg, pages, dev) + check_budget_route(dev)
            + check_ngram_score(docs, [pages, exp_pages], dev)
            + check_flash_attention(dev) + check_embedding_bag(dev)
            + check_segment_mm(dev))
    torch.cuda.synchronize()
    for r in rows:
        # the function's operations over the kernel's time (rows whose
        # function is data movement only count none), and time / bound
        r["tflops"] = r["ops"] / r["ms"] / 1e9 if "ops" in r else None
        r["x_bound"] = r["ms"] / r["bound_ms"]
        r["x_bound_device"] = r["ms_device"] / r["bound_ms"]
    emit({"phase": "kernels", "card": card, "results": rows})
    phase_kernel_edge_cases(dev)
    phase_routing_parity(dev)

    train_counts, trained = phase_train()
    phase_train_small_parity()
    path_counts = [phase_ft(), train_counts, phase_serve_llm()]
    llm_counts, router = phase_llm(trained)
    campaign_counts, a1 = phase_campaign(router)
    path_counts += [llm_counts, campaign_counts, phase_fleet(router, *a1)]
    path_counts.append(phase_scenarios())
    tune_counts, knobs = phase_autotune(router, *a1,
                                        (dev, ccfg, docs, pages, exp_pages))
    path_counts.append(tune_counts)
    del trained, router, a1
    free_cuda()
    path_counts.append(phase_lm())
    phase_lm_small_parity()
    path_counts.append(phase_lm_train())
    phase_lm_train_small_parity()
    path_counts.append(phase_lm_moe())
    phase_lm_moe_small_parity()
    path_counts.append(phase_lm_phi3())
    path_counts.append(phase_recsys())
    phase_recsys_small_parity()
    path_counts.append(phase_gnn())

    replaces = {
        "fast_features": "src/repro/kernels/fast_features/kernel.py:94",
        "budget_route": "src/repro/kernels/budget_route/kernel.py:76",
        "ngram_score": "src/repro/kernels/ngram_score/kernel.py:93",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
        "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:47",
        "segment_mm": "src/repro/kernels/segment_mm/kernel.py:59",
    }
    main_shape = {"fast_features": dict(max_len=512),
                  "budget_route": dict(n=256),
                  "ngram_score": dict(b=256),
                  "flash_attention": dict(d=128, dtype="bfloat16"),
                  "embedding_bag": dict(bag=1),
                  "segment_mm": dict(d_out=GNN_D_OUT)}
    summary = []
    for name, src in replaces.items():
        row = next(r for r in rows if r["name"] == name and all(
            r["shape"][k] == v for k, v in main_shape[name].items()))
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": src,
            "launches": sum(c[name] for c in path_counts),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["name"] == name),
            "ms": row["ms"], "ms_device": row["ms_device"],
            **{k: row[k] for k in ("profiler_ms", "empty_launch_ms")
               if k in row},
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            **({"knobs": [{k: r[k] for k in ("param", "shape", "default",
                                              "winner", "ms_device")}
                          for r in knobs if r["kernel"] == name]}
               if name in MAIN_KERNELS else {})})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
