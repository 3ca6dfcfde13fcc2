"""AdaParse parsing-campaign driver, single node (the paper's end-to-end
system on one card).

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 \
        --alpha 0.05 [--variant ft|llm] [--device cuda|cpu]

Builds the corpus, trains the CLS-I/II linear stages (and, for the LLM
variant, SFT+DPO post-trains a reduced SciBERT router on ``--device``),
then runs the engine over the test split and reports Table-1-style
metrics + throughput. Routing inputs (the fast_features kernel), router
training, routing and evaluation run on ``--device`` (cuda by default;
asking for cuda without a card is an error, never a silent CPU run).

This is the single-node subset of ``repro.launch.serve``. Not ported
yet, and refused with an argparse error rather than substituted: every
flag that routes the campaign through the fleet layer
(``CampaignExecutor``/``CampaignController``, worker processes, the
fabric, result stores, scenarios, tracing): ``FLEET_FLAGS`` below.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config
from repro_torch.core import dpo as dpo_lib
from repro_torch.core import features as F
from repro_torch.core import metrics as M
from repro_torch.core import parsers as P
from repro_torch.core.engine import AdaParseEngine, EngineConfig
from repro_torch.core.router import (AdaParseRouter, LinearStage,
                                     make_cls1_labels, make_cls2_labels)
from repro_torch.data.synthetic import (CorpusConfig, generate_corpus,
                                        preference_utility)
from repro_torch.models.encoder import Encoder, init_encoder

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


def llm_training_data(train_docs, ccfg, rng, max_len, device=None):
    """The LLM router's training data, drawn from ``rng`` in the JAX
    package's order: the fitted CLS-I stage; the regression set (the
    first-page tokens/mask of every training doc from
    ``fit_cls1_stage`` on ``device``, BLEU targets of the m parsers);
    and preference pairs from the first 64 docs, the oracle's
    (``preference_utility``) better and worse of the cheap and the
    expensive parse (it stands in for the 23-expert study).

    Returns (cls1, reg, pref): ``reg`` holds tensors on ``device``,
    ``pref`` numpy arrays."""
    mat, _, cls1, toks, masks = fit_cls1_stage(train_docs, ccfg, rng,
                                               max_len=max_len,
                                               device=device)
    reg = {"tokens": toks, "mask": masks,
           "targets": torch.from_numpy(mat.astype(np.float32)).to(
               toks.device)}
    pos_t, pos_m, neg_t, neg_m = [], [], [], []
    for d in train_docs[:64]:
        outs = {n: P.run_parser(n, d, ccfg, rng)
                for n in (P.CHEAP_PARSER, P.EXPENSIVE_PARSER)}
        ref = d.full_text()
        utils = {n: preference_utility(
            ref, np.concatenate(o) if sum(map(len, o)) else np.zeros(0),
            rng) for n, o in outs.items()}
        better = max(utils, key=utils.get)
        worse = min(utils, key=utils.get)
        tp, mp = F.first_page_tokens(outs[better], max_len)
        tn, mn = F.first_page_tokens(outs[worse], max_len)
        pos_t.append(tp); pos_m.append(mp); neg_t.append(tn); neg_m.append(mn)
    pref = {"tok_pos": np.stack(pos_t), "mask_pos": np.stack(pos_m),
            "tok_neg": np.stack(neg_t), "mask_neg": np.stack(neg_m)}
    return cls1, reg, pref


def build_llm_router(train_docs, ccfg, rng, *, sft_steps=150,
                     dpo_steps=60, seed=0, device=None,
                     encoder: Encoder | None = None) -> AdaParseRouter:
    """The reduced ``adaparse-router`` (``router-tiny``), post-trained
    SFT -> DPO -> refit on ``device``. It starts from ``encoder`` when
    given (the JAX package's PRNG cannot be reproduced in torch, so a
    parity run passes the reference's init through
    ``encoder_from_jax_params``), else from ``init_encoder`` with a
    generator seeded by ``seed``."""
    enc_cfg = get_config("adaparse-router").reduced().model
    dev = device_lib.resolve(device)
    cls1, reg, pref = llm_training_data(train_docs, ccfg, rng,
                                        enc_cfg.max_len, dev)
    if encoder is None:
        encoder = init_encoder(enc_cfg, torch.Generator().manual_seed(seed),
                               dev)
    elif encoder.cfg != enc_cfg or encoder.device.type != dev.type:
        raise ValueError(f"build_llm_router: the starting encoder must be "
                         f"{enc_cfg.name} on {dev}, got {encoder.cfg.name} "
                         f"on {encoder.device}")
    enc, _ = dpo_lib.three_stage_posttrain(
        encoder, reg, pref, sft_steps=sft_steps, dpo_steps=dpo_steps,
        refit_steps=max(sft_steps // 3, 10))
    return AdaParseRouter("llm", cls1, None, enc_cfg=enc_cfg, encoder=enc)


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
    router = (build_ft_router(train, ccfg, rng, device=device)
              if args.variant == "ft"
              else build_llm_router(train, ccfg, rng, device=device))
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
