"""AdaParse parsing-campaign driver, single node (the paper's end-to-end
system on one card).

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 \
        --alpha 0.05 [--variant ft] [--device cuda|cpu]

Builds the corpus, trains the CLS-I/II linear stages, then runs the
engine over the test split and reports Table-1-style metrics +
throughput. Routing inputs (the fast_features kernel) and evaluation
run on ``--device`` (cuda by default; asking for cuda without a card is
an error, never a silent CPU run).

This is the single-node subset of ``repro.launch.serve``. Not ported
yet, and refused with an argparse error rather than substituted:

- ``--variant llm``: the LLM router needs its SFT+DPO post-training
  (``core/dpo.py``) first.
- every flag that routes the campaign through the fleet layer
  (``CampaignExecutor``/``CampaignController``, worker processes, the
  fabric, result stores, scenarios, tracing): ``FLEET_FLAGS`` below.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import features as F
from repro_torch.core import metrics as M
from repro_torch.core import parsers as P
from repro_torch.core.engine import AdaParseEngine, EngineConfig
from repro_torch.core.router import (AdaParseRouter, LinearStage,
                                     make_cls1_labels, make_cls2_labels)
from repro_torch.data.synthetic import CorpusConfig, generate_corpus

# flags of repro.launch.serve whose campaign runs through the fleet layer
# (core/campaign, core/workers, core/fabric, core/scenarios, obs), which
# the port has not reached yet
FLEET_FLAGS = (
    "--nodes", "--workers", "--heartbeat-timeout", "--transport",
    "--fabric-workers", "--coordinator", "--connect", "--pools",
    "--warm-cache", "--cache-dir", "--cache-max-bytes", "--tuning-dir",
    "--adaptive-rounds", "--quality-probe-rate", "--alpha-bounds",
    "--alpha-step", "--quality-target", "--trace-dir", "--metrics-out",
    "--status-interval", "--scenario",
)


def bleu_matrix(docs, ccfg, rng, parsers=P.REGRESSION_PARSERS):
    """(n, m) BLEU of every parser on every doc — one batched channel
    application per parser (the per-doc loop only scores)."""
    mat = np.zeros((len(docs), len(parsers)))
    cheap_pages = []
    refs = [d.full_text() for d in docs]
    for j, name in enumerate(parsers):
        outs = P.run_parser_batch(name, docs, ccfg, rng)
        if name == P.CHEAP_PARSER:
            cheap_pages = outs
        for i, out in enumerate(outs):
            hyp = (np.concatenate(out) if sum(map(len, out))
                   else np.zeros(0, np.int32))
            mat[i, j] = M.bleu(refs[i], hyp)
    return mat, cheap_pages


def fit_cls1_stage(train_docs, ccfg, rng, max_len=None, device=None):
    """Shared CLS-I training pipeline for both router variants: score
    the regression parsers, derive the fast features — and, when
    ``max_len`` is given, the first-page encoder inputs — through the
    fused prepare-stage entry (``F.prepare_routing_inputs`` on
    ``device``, the same call site the engine dispatches through), and
    fit the stage.

    Returns (bleu matrix, cheap-parser pages, fitted stage, toks, mask);
    toks/mask are None without ``max_len``."""
    mat, cheap_pages = bleu_matrix(train_docs, ccfg, rng)
    fast, toks, mask = F.prepare_routing_inputs(cheap_pages, ccfg,
                                                max_len=max_len,
                                                device=device)
    cls1 = LinearStage.fit(fast.cpu().numpy(), make_cls1_labels(mat[:, 0]))
    return mat, cheap_pages, cls1, toks, mask


def build_ft_router(train_docs, ccfg, rng, device=None) -> AdaParseRouter:
    mat, _, cls1, _, _ = fit_cls1_stage(train_docs, ccfg, rng,
                                        device=device)
    meta = np.stack([d.metadata_features() for d in train_docs])
    cls2 = LinearStage.fit(meta, make_cls2_labels(mat, 0))
    return AdaParseRouter("ft", cls1, cls2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=600)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--variant", default="ft", choices=["ft", "llm"])
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="overlap host channel prep with routing (>0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for routing inputs and scoring: "
                         "cuda (default; an error without a card) or cpu")
    for flag in FLEET_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    given = [f for f in FLEET_FLAGS
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        ap.error(f"{', '.join(given)}: the fleet layer (CampaignExecutor, "
                 f"worker processes, result stores, scenarios, tracing) "
                 f"is not ported to repro_torch yet; run "
                 f"repro.launch.serve for these, or drop them for the "
                 f"single-node campaign")
    if args.variant == "llm":
        ap.error("--variant llm needs the router's SFT+DPO post-training "
                 "(core/dpo.py), which is not ported to repro_torch yet; "
                 "use --variant ft, or repro.launch.serve")
    if args.docs < 3:
        ap.error(f"--docs must be >= 3 (got {args.docs}): the corpus is "
                 f"split 1/3 train, 2/3 test")
    if args.batch_size < 1:
        ap.error(f"--batch-size must be >= 1 (got {args.batch_size})")
    if args.prefetch_depth < 0:
        ap.error(f"--prefetch-depth must be >= 0 (got "
                 f"{args.prefetch_depth}); 0 disables prefetch overlap, "
                 f"N > 0 prefetches N batches ahead")
    try:
        device = device_lib.resolve(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {args.device}: {e}")

    ccfg = CorpusConfig(n_docs=args.docs, seed=args.seed)
    docs = generate_corpus(ccfg)
    n_train = args.docs // 3
    train, test = docs[:n_train], docs[n_train:]
    rng = np.random.RandomState(args.seed + 1)
    router = build_ft_router(train, ccfg, rng, device=device)
    ecfg = EngineConfig(alpha=args.alpha, batch_size=args.batch_size,
                        seed=args.seed, prefetch_depth=args.prefetch_depth)
    eng = AdaParseEngine(ecfg, router, ccfg, device=device)
    recs = eng.run(test)
    res = eng.evaluate(test, recs)
    print(f"[serve] AdaParse({args.variant}) alpha={args.alpha} "
          f"n_test={len(test)} device={device}")
    for k, v in res.items():
        print(f"  {k:28s} {v:.4f}")
    return res


if __name__ == "__main__":
    main()
