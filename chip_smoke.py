#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda/bin) and
the repository's ``src/``; exits non-zero, printing no result, without
them. Imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (one JSON line each; any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), then the
   kernel library built from ``src/repro_torch/kernels/**/csrc/*.cu``
   with nvcc for sm_90a (set-up).
1. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes, with the tolerance stated:
   fast_features (n=256 real packed batches, max_len 0 and 512),
   budget_route (N=256, D=512, alpha=0.05, and route_64k: N=65536),
   ngram_score (B=64 and 256, L=256). Times are CUDA-event medians.
2. ft: ``serve.main`` with ``--variant ft --device cuda`` and with
   ``--device cpu``: the metric dicts must be equal, and fast_features
   must have launched at least once per batch.
3. llm: the full-width bf16 ``adaparse-router`` encoder (random weights
   from a seeded generator) behind a fitted CLS-I stage, run by
   ``AdaParseEngine(..., device="cuda", probe=QualityProbe(rate 1.0))``
   and evaluated: every kernel must have launched, every batch's device
   plan must equal ``plan_batch`` on the same improvement scores, and
   the predictions must be finite in [0, 1]. A reduced f32 encoder then
   runs the same engine on cuda and on cpu, whose records must agree
   (a flip allowed only within 1e-5 of tau).

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
ALPHA = 0.05
SEED = 0


def emit(obj) -> None:
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


def bound(bytes_moved: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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
        ms = time_ms(lambda: ops._launch(*ins, fast, toks, mask, flag,
                                         bos=1, **kw))
        plain_ms = time_ms(lambda: ref.fast_features_ref(*ins, **kw))
        # data-dependent bytes: each valid token read once, 4 per-doc
        # scalars, the features and the token/mask pair written once
        nbytes = (4 * int(packed.n_tok.sum()) + 16 * n + 32 * n
                  + 8 * n * max_len)
        b_ms, b_by = bound(nbytes)
        rows.append(dict(name="fast_features", shape=dict(
            n=n, width=packed.width, max_len=max_len), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_budget_route(dev) -> list[dict]:
    import torch

    from repro_torch.kernels.budget_route import ops, ref

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
        out = torch.zeros((cap, d), dtype=torch.int32, device=dev)
        idx = torch.empty(cap, dtype=torch.int32, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        counts = torch.empty(2 * (-(-n // ops.BLOCK_ROWS)),
                             dtype=torch.int32, device=dev)
        ms = time_ms(lambda: ops._launch(scores, tokens, tau, counts, out,
                                         idx, count, capacity=cap))
        plain_ms = time_ms(lambda: ref.budget_route_ref(
            scores, tokens, tau[0], capacity=cap))
        kept = int(want[2])
        nbytes = 4 * n + 4 + 2 * 4 * d * kept + 4 * cap + 4
        b_ms, b_by = bound(nbytes)
        rows.append(dict(name="budget_route", shape=dict(
            n=n, d=d, capacity=cap), max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
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
        ms = time_ms(lambda: ops._launch(*ins, out, max_n=4))
        plain_ms = time_ms(lambda: ref.ngram_bleu_ref(*ins))
        lr = rl.astype(np.int64)
        lh = hl.astype(np.int64)
        pairs = float((lh * lr + lh * (lh - 1) // 2).sum())
        b_ms, b_by = bound(2 * 4 * b * L + 8 * b + 4 * b, ops=pairs)
        rows.append(dict(name="ngram_score", shape=dict(b=b, L=L),
                         max_abs_err=diff.max().item(), ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


# -------------------------------------------------------------- phases 2-3


def kernels():
    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.fast_features import ops as ff
    from repro_torch.kernels.ngram_score import ops as ng

    return {"fast_features": ff.KERNEL, "budget_route": br.KERNEL,
            "ngram_score": ng.KERNEL}


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
    """(cheap_idx, expensive_idx) for a router with random weights.

    Random weights rank the six outputs alike for every document, so
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
                     outputs=None):
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
    enc = init_encoder(cfg, torch.Generator().manual_seed(SEED),
                       device=device)
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

    def t(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for _ in range(2):
        prep, prepare_s = t(lambda: eng.prepare_batch(docs, batch_key=0))
        plan, route_s = t(lambda: eng.route_batch(prep))
        recs, complete_s = t(lambda: eng.complete_batch(prep, plan))
        with torch.inference_mode():
            _, encoder_s = t(lambda: eng.router.encoder.predict_accuracies(
                prep.route_host["tokens"], prep.route_host["mask"]))
        _, probe_s = t(lambda: eng.probe.score_records(docs, recs))
    return {"docs": len(docs), "prepare_s": prepare_s, "route_s": route_s,
            "encoder_forward_s": encoder_s,
            "complete_with_probe_s": complete_s, "probe_s": probe_s}


def phase_llm() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                      capacity_floor)

    cfg = get_config("adaparse-router").model          # full width, bf16
    assert (cfg.n_layers, cfg.d_model, cfg.param_dtype) == \
        (12, 768, "bfloat16"), cfg
    eng, test = build_llm_engine(cfg, 600, "cuda", probe_rate=1.0,
                                 prefetch_depth=2)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = eng.run(test)
    res = eng.evaluate(test, recs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for name, c in counts.items():
        assert c > 0, f"{name} did not launch on the llm path: {counts}"
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
    emit({"phase": "llm", "config": cfg.name,
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
    return counts


# -------------------------------------------------------------- main


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
          "build_s": time.perf_counter() - t0, "library": lib.name,
          "sources": [str(p.relative_to(ROOT))
                      for p in cuda_lib.sources()], "ptxas": ptxas})
    dev = torch.device("cuda")

    ccfg, docs, pages = corpus_batch(256)
    from repro_torch.core import parsers as P

    exp_pages = P.run_parser_batch(P.EXPENSIVE_PARSER, docs, ccfg,
                                   np.random.RandomState(1))
    rows = (check_fast_features(ccfg, pages, dev) + check_budget_route(dev)
            + check_ngram_score(docs, [pages, exp_pages], dev))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "card": card, "results": rows})

    ft_counts = phase_ft()
    llm_counts = phase_llm()

    replaces = {
        "fast_features": "src/repro/kernels/fast_features/kernel.py:94",
        "budget_route": "src/repro/kernels/budget_route/kernel.py:76",
        "ngram_score": "src/repro/kernels/ngram_score/kernel.py:93",
    }
    main_shape = {"fast_features": dict(max_len=512),
                  "budget_route": dict(n=256),
                  "ngram_score": dict(b=256)}
    summary = []
    for name, src in replaces.items():
        row = next(r for r in rows if r["name"] == name and all(
            r["shape"][k] == v for k, v in main_shape[name].items()))
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": src,
            "launches": ft_counts[name] + llm_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["name"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
