"""AdaParse parsing-campaign driver (the paper's end-to-end system on one
card).

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 \
        --alpha 0.05 [--variant ft|llm] [--nodes 1] [--device cuda|cpu]

Builds the corpus, trains the CLS-I/II linear stages (and, for the LLM
variant, SFT+DPO post-trains a reduced SciBERT router on ``--device``),
then runs the engine over the test split and reports Table-1-style
metrics + throughput. Routing inputs (the fast_features kernel), router
training, routing, probe scoring and evaluation run on ``--device``
(cuda by default; asking for cuda without a card is an error, never a
silent CPU run).

The campaign layer (core/campaign, in-process simulated fleet): with
``--nodes N > 1`` the corpus is executed by ``CampaignExecutor`` (a real
engine per simulated node over batch shards, all of them on the one
``--device``); batch-keyed rng streams make the record set identical to
``--nodes 1``. ``--pools cpu:3,gpu:1`` partitions the fleet into the
simulated backends' device pools (cheap-channel ingest on the CPU pool,
expensive re-parse forwarded to the GPU pool); a pool is not a torch
device. ``--warm-cache`` runs the campaign twice against one result
store (the second pass reports the hit counters; records are
identical); ``--cache-dir DIR`` persists results in a
content-addressed ``DiskResultStore`` (``--cache-max-bytes`` bounds it)
so a warm replay also works across process restarts and devices.
``--adaptive-rounds N`` dispatches through the round-based
``CampaignController`` that autotunes the node budget weights from
observed (simulated) throughput. ``--quality-probe-rate R`` samples a
deterministic batch-keyed fraction of completed batches and scores them
per parser (the ngram_score kernel on cuda); ``--alpha-bounds LO:HI``
then lets the controller move the campaign α inside those bounds toward
``--quality-target`` (at most ``--alpha-step`` per round).
``--trace-dir DIR`` turns the observability plane on and writes the
run's span log, Chrome timeline and folded metrics (summarise with
``repro_torch.launch.obs_report``); ``--metrics-out FILE`` writes the
folded metrics as Prometheus text.

Real worker fleets: ``--workers N`` runs the campaign on N spawned
worker processes (core/workers.ProcessWorkerPool; ``--transport shm``
or ``pickle`` carries their batch payloads, ``--heartbeat-timeout S``
sets the silence after which a worker's batches re-issue), and
``--fabric-workers N`` on N workers over TCP (core/fabric): loopback
workers serve spawns itself, or, with ``--coordinator HOST:PORT``,
N standalone workers that dial in with ``--connect HOST:PORT``. Every
worker builds its engine on ``--device`` (a standalone worker on its
own ``--device``); several share one card. Records equal the
single-node run's; ``wall``, ``docs/s`` and ``busy`` are measured.
``--status-interval S`` prints a live one-line fleet status to stderr
every S seconds while such a fleet drains.

Scenario lab (core/scenarios): ``--scenario NAME`` runs one named,
fully declarative stress scenario over its worker runtime on
``--device``, asserts byte-identical records against the scenario's
single-node reference, and reports its goodput / re-issue / dedup /
cache counters; ``--scenario list`` prints the registry. The fleet
shape and fault schedule live in the spec, so campaign-shape flags
conflict with ``--scenario``.

Kernel autotune (kernels/tuning_store): ``--tuning-dir DIR`` opens a
flock-shared tuning store that this process and every worker of its
fleet share: the first to meet a packed shape sweeps fast_features'
block size on the card and publishes the winner, the rest (and a warm
restart) read it; budget_route and ngram_score launch at any winner the
store holds. On the CPU the plain versions run, which have no knob.
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
from repro_torch.core import obs
from repro_torch.core import parsers as P
from repro_torch.core.backends import DiskResultStore, ResultCache
from repro_torch.core.campaign import (CampaignController, CampaignExecutor,
                                       ControllerConfig, ExecutorConfig)
from repro_torch.core.engine import AdaParseEngine, EngineConfig
from repro_torch.core.quality import QualityProbeConfig
from repro_torch.core.router import (AdaParseRouter, LinearStage,
                                     make_cls1_labels, make_cls2_labels)
from repro_torch.data.synthetic import (CorpusConfig, generate_corpus,
                                        preference_utility)
from repro_torch.models.encoder import Encoder, init_encoder

# flags of repro.launch.serve that the port has not reached yet, each
# with the ROADMAP item it waits for: none is left
UNPORTED_FLAGS: dict[str, str] = {}


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


def parse_alpha_bounds(spec: str) -> tuple[float, float]:
    """"0.05:0.4" -> (0.05, 0.4).

    Raises ValueError with an actionable message on malformed specs
    (the CLI surfaces it as an argparse error instead of a traceback
    from deep inside ControllerConfig)."""
    hint = "expected LO:HI with 0 <= LO <= HI <= 1, e.g. '0.05:0.4'"
    lo_s, sep, hi_s = spec.partition(":")
    if not sep:
        raise ValueError(f"--alpha-bounds {spec!r} has no ':'; {hint}")
    try:
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise ValueError(f"--alpha-bounds {spec!r} is not a pair of "
                         f"floats; {hint}") from None
    if not 0.0 <= lo <= hi <= 1.0:
        raise ValueError(f"--alpha-bounds {spec!r} out of order or out "
                         f"of range; {hint}")
    return lo, hi


def parse_pools(spec: str) -> list[str]:
    """"cpu:3,gpu:1" -> ["cpu", "cpu", "cpu", "gpu"].

    Raises ValueError with an actionable message on malformed specs
    (the CLI surfaces it as an argparse error instead of a traceback
    from deep inside ExecutorConfig)."""
    hint = ("expected DEVICE[:COUNT] entries separated by commas, "
            "e.g. 'cpu:3,gpu:1' or 'cpu,cpu,gpu'")
    pools: list[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty entry in --pools spec {spec!r}; {hint}")
        dev, _, count = part.partition(":")
        if dev not in ("cpu", "gpu"):
            raise ValueError(f"unknown pool device {dev!r} in --pools "
                             f"{spec!r} (choose cpu or gpu); {hint}")
        if count:
            try:
                n = int(count)
            except ValueError:
                raise ValueError(
                    f"pool count {count!r} in --pools {spec!r} is not an "
                    f"integer; {hint}") from None
            if n < 1:
                raise ValueError(f"pool count for {dev!r} in --pools "
                                 f"{spec!r} must be >= 1, got {n}")
        else:
            n = 1
        pools.extend([dev] * n)
    if not pools:
        raise ValueError(f"empty --pools spec {spec!r}; {hint}")
    return pools


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=600)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--variant", default="ft", choices=["ft", "llm"])
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0,
                    help="run the campaign on N real worker processes "
                         "(core/workers spawn runtime) instead of the "
                         "in-process simulated fleet; 0 disables")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds of worker silence before its "
                         "in-flight batches re-issue to a pool peer "
                         "(needs --workers; default 30)")
    ap.add_argument("--transport", default=None,
                    help="batch-payload transport for the worker "
                         "processes: shm (zero-copy shared-memory "
                         "arenas, the default; falls back to pickle "
                         "with a warning when /dev/shm is unavailable) "
                         "or pickle (queue-serialized payloads; needs "
                         "--workers)")
    ap.add_argument("--fabric-workers", type=int, default=0,
                    help="run the campaign on N cross-machine fabric "
                         "workers (core/fabric TCP runtime): without "
                         "--coordinator serve spawns N loopback "
                         "workers itself; with it, the fleet is N "
                         "standalone workers dialing in with --connect. "
                         "0 disables")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="bind the fabric coordinator's listener here "
                         "and wait for --fabric-workers standalone "
                         "workers to dial in (instead of spawning "
                         "loopback workers); needs --fabric-workers")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="run as a standalone fabric worker on --device: "
                         "dial the coordinator at HOST:PORT, join its "
                         "fleet (spec-fingerprint admission), serve "
                         "batches until shutdown. Excludes every "
                         "campaign flag — the coordinator ships the "
                         "worker its spec")
    ap.add_argument("--pools", default=None,
                    help="heterogeneous node pools, e.g. cpu:3,gpu:1 "
                         "(overrides --nodes)")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="overlap host channel prep with routing (>0)")
    ap.add_argument("--warm-cache", action="store_true",
                    help="run the campaign twice against one result store "
                         "and report replay hit counters")
    ap.add_argument("--cache-dir", default=None,
                    help="persist batch results in a content-addressed "
                         "DiskResultStore under this directory (replays "
                         "across process restarts)")
    ap.add_argument("--cache-max-bytes", type=int, default=None,
                    help="LRU byte budget for --cache-dir")
    ap.add_argument("--tuning-dir", default=None,
                    help="persist kernel autotune winners in a "
                         "flock-shared TuningStore under this directory "
                         "(kernels/tuning_store); worker processes share "
                         "one store, so block-size sweeps run once per "
                         "shape across the fleet and a warm restart "
                         "re-sweeps nothing")
    ap.add_argument("--adaptive-rounds", type=int, default=0,
                    help=">0: dispatch through the adaptive "
                         "CampaignController with this many rounds "
                         "(online-autotuned node budget weights)")
    ap.add_argument("--quality-probe-rate", type=float, default=0.0,
                    help="fraction of batches the online quality probe "
                         "scores (deterministic batch-keyed sampling; "
                         "0 disables the probe)")
    ap.add_argument("--alpha-bounds", default=None,
                    help="LO:HI operator bounds for online α retuning, "
                         "e.g. 0.05:0.4 (needs --adaptive-rounds and "
                         "--quality-probe-rate > 0)")
    ap.add_argument("--alpha-step", type=float, default=0.05,
                    help="max per-round α movement for the retuner")
    ap.add_argument("--quality-target", type=float, default=0.45,
                    help="blended probe quality the retuner aims at")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="turn the observability plane on and write the "
                         "run's span log (spans.jsonl), Chrome "
                         "trace_event timeline (trace.json) and folded "
                         "metrics there; summarize with "
                         "repro_torch.launch.obs_report")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the fleet-folded metrics registry "
                         "(counters, gauges, log2-bucket latency "
                         "histograms) as Prometheus text to FILE")
    ap.add_argument("--status-interval", type=float, default=0.0,
                    metavar="S",
                    help="print a live one-line status to stderr every "
                         "S seconds while the worker fleet drains "
                         "(docs/s, alpha, cache hit rate, in-flight, "
                         "re-issues; needs --workers; 0 disables)")
    ap.add_argument("--scenario", default=None, metavar="NAME",
                    help="run one named stress scenario from the "
                         "scenario lab (core/scenarios) on --device and "
                         "report its counters; 'list' prints the "
                         "registry. The fleet shape, fault schedule, and "
                         "retune settings live in the spec, so "
                         "campaign-shape flags conflict with this one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for routing inputs and scoring: "
                         "cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    if args.connect is not None:
        # standalone fabric worker: everything about the campaign —
        # corpus, router, engine config — arrives from the coordinator
        # in the admission reply, so no campaign flag makes sense here;
        # the worker runs on its own --device
        busy = [flag for flag, changed in (
            ("--scenario", args.scenario is not None),
            ("--workers", args.workers != 0),
            ("--fabric-workers", args.fabric_workers != 0),
            ("--coordinator", args.coordinator is not None),
            ("--nodes", args.nodes != 1),
        ) if changed]
        if busy:
            ap.error(f"--connect runs this process as a standalone "
                     f"fabric worker (the coordinator owns the whole "
                     f"campaign shape); drop {', '.join(busy)}")
        from repro_torch.core.fabric import parse_addr
        from repro_torch.launch.fabric_worker import run_worker
        try:
            addr = parse_addr(args.connect)
        except ValueError as e:
            ap.error(str(e))
        try:
            device = device_lib.resolve(args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(f"--device {args.device}: {e}")
        run_worker(addr, device=device)
        return None

    if args.scenario:
        from repro_torch.core.scenarios import (SCENARIOS, get_scenario,
                                                run_scenario)
        if args.scenario == "list":
            for name, spec in SCENARIOS.items():
                print(f"{name:24s} [{spec.runtime}] {spec.description}")
            return None
        conflicts = [flag for flag, changed in (
            ("--nodes", args.nodes != 1),
            ("--workers", args.workers != 0),
            ("--fabric-workers", args.fabric_workers != 0),
            ("--coordinator", args.coordinator is not None),
            ("--pools", args.pools is not None),
            ("--adaptive-rounds", args.adaptive_rounds != 0),
            ("--quality-probe-rate", args.quality_probe_rate != 0.0),
            ("--alpha-bounds", args.alpha_bounds is not None),
            ("--warm-cache", args.warm_cache),
            ("--cache-dir", args.cache_dir is not None),
            ("--tuning-dir", args.tuning_dir is not None),
            ("--heartbeat-timeout", args.heartbeat_timeout is not None),
            ("--transport", args.transport is not None),
            ("--metrics-out", args.metrics_out is not None),
            ("--status-interval", args.status_interval != 0.0),
        ) if changed]
        if conflicts:
            ap.error(f"--scenario {args.scenario} is fully declarative "
                     f"(fleet topology, fault schedule, and retune "
                     f"settings all live in the scenario spec); drop "
                     f"{', '.join(conflicts)}, or run those campaign "
                     f"flags without --scenario")
        try:
            spec = get_scenario(args.scenario)
        except KeyError as e:
            ap.error(e.args[0])
        try:
            device = device_lib.resolve(args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(f"--device {args.device}: {e}")
        res = run_scenario(spec, trace_dir=args.trace_dir, device=device)
        print(f"[serve] scenario {res.name} [{res.runtime}] "
              f"nodes={res.n_nodes} docs={res.n_docs} "
              f"records_match={res.records_match} "
              f"goodput={res.goodput_docs_per_s:.1f}docs/s "
              f"reissued={res.reissued} "
              f"dup_dropped={res.duplicates_dropped} "
              f"cache={res.cache_hits}h/{res.cache_misses}m "
              f"warm={res.warm_cache_hits}h/{res.warm_cache_misses}m")
        if res.alpha_trajectory:
            print("[serve]   alpha "
                  + "->".join(f"{a:.2f}" for a in res.alpha_trajectory))
        if res.joiner_docs is not None:
            print(f"[serve]   elastic joiners served "
                  f"{res.joiner_docs} docs")
        if args.trace_dir:
            print(f"[serve] trace written to {args.trace_dir}; summarize "
                  f"with: python -m repro_torch.launch.obs_report "
                  f"--trace-dir {args.trace_dir}")
        return res.metrics()

    if args.docs < 3:
        ap.error(f"--docs must be >= 3 (got {args.docs}): the corpus is "
                 f"split 1/3 train, 2/3 test")
    if args.batch_size < 1:
        ap.error(f"--batch-size must be >= 1 (got {args.batch_size})")
    if args.nodes < 1:
        ap.error(f"--nodes must be >= 1 (got {args.nodes})")
    if args.prefetch_depth < 0:
        ap.error(f"--prefetch-depth must be >= 0 (got "
                 f"{args.prefetch_depth}); 0 disables prefetch overlap, "
                 f"N > 0 prefetches N batches ahead")
    if args.adaptive_rounds < 0:
        ap.error(f"--adaptive-rounds must be >= 0 (got "
                 f"{args.adaptive_rounds}); 0 uses the one-shot executor")
    if args.workers < 0:
        ap.error(f"--workers must be >= 0 (got {args.workers}); 0 runs "
                 f"the in-process simulated fleet, N > 0 spawns N real "
                 f"worker processes")
    if args.workers and args.nodes != 1:
        ap.error(f"--workers {args.workers} and --nodes {args.nodes} "
                 f"both set the fleet size; choose one (--workers runs "
                 f"real processes, --nodes simulates in-process)")
    if args.fabric_workers < 0:
        ap.error(f"--fabric-workers must be >= 0 (got "
                 f"{args.fabric_workers}); 0 disables the fabric "
                 f"runtime, N > 0 runs the campaign on N fabric workers")
    if args.fabric_workers and args.workers:
        ap.error(f"--workers {args.workers} and --fabric-workers "
                 f"{args.fabric_workers} both pick a real worker "
                 f"runtime; choose one (--workers spawns local queue-"
                 f"connected processes, --fabric-workers runs the "
                 f"TCP fabric)")
    if args.fabric_workers and args.nodes != 1:
        ap.error(f"--fabric-workers {args.fabric_workers} and --nodes "
                 f"{args.nodes} both set the fleet size; choose one")
    if args.coordinator is not None and not args.fabric_workers:
        ap.error("--coordinator binds the fabric listener and waits "
                 "for standalone workers to dial in; it needs "
                 "--fabric-workers N > 0 to size the fleet")
    if args.coordinator is not None:
        from repro_torch.core.fabric import parse_addr
        try:
            parse_addr(args.coordinator)
        except ValueError as e:
            ap.error(str(e))
    if args.heartbeat_timeout is not None and not (args.workers
                                                   or args.fabric_workers):
        ap.error("--heartbeat-timeout only applies to the process and "
                 "fabric runtimes; add --workers or --fabric-workers "
                 "N > 0")
    if args.transport is not None and args.transport not in ("shm",
                                                             "pickle"):
        ap.error(f"unknown --transport {args.transport!r} (choose shm "
                 f"or pickle); shm moves batch payloads through "
                 f"zero-copy shared-memory arenas, pickle serializes "
                 f"them onto the worker queues")
    if args.transport is not None and not args.workers:
        ap.error(f"--transport {args.transport} only applies to the "
                 f"process runtime (payloads of real worker "
                 f"processes); add --workers N > 0")
    if args.heartbeat_timeout is not None and args.heartbeat_timeout <= 0.5:
        ap.error(f"--heartbeat-timeout must exceed the 0.5 s worker "
                 f"heartbeat interval (got {args.heartbeat_timeout}); a "
                 f"deadline at or below the beat period would re-issue "
                 f"healthy workers' batches")
    if args.status_interval < 0:
        ap.error(f"--status-interval must be >= 0 (got "
                 f"{args.status_interval}); 0 disables the live status "
                 f"line")
    if args.status_interval > 0 and not (args.workers
                                         or args.fabric_workers):
        ap.error("--status-interval only applies to the process and "
                 "fabric runtimes (the live status line is printed "
                 "from the worker-fleet drain loop); add --workers or "
                 "--fabric-workers N > 0")
    if ((args.workers or args.fabric_workers) and args.warm_cache
            and not args.cache_dir):
        ap.error("--warm-cache with a real worker fleet needs "
                 "--cache-dir: an in-memory result store cannot be "
                 "shared across worker processes")
    if args.cache_max_bytes is not None and args.cache_dir is None:
        ap.error("--cache-max-bytes only applies with --cache-dir")
    if args.cache_max_bytes is not None and args.cache_max_bytes < 1:
        ap.error(f"--cache-max-bytes must be >= 1 (got "
                 f"{args.cache_max_bytes})")
    if not 0.0 <= args.quality_probe_rate <= 1.0:
        ap.error(f"--quality-probe-rate must be in [0, 1] (got "
                 f"{args.quality_probe_rate}); it is the fraction of "
                 f"batches the quality probe scores")
    if args.quality_probe_rate > 0.0 and not args.adaptive_rounds:
        ap.error("--quality-probe-rate needs --adaptive-rounds > 0: "
                 "probe scores are collected and reported through the "
                 "adaptive controller's round telemetry")
    if args.alpha_step <= 0.0:
        ap.error(f"--alpha-step must be > 0 (got {args.alpha_step})")
    bounds = None
    if args.alpha_bounds is not None:
        if not args.adaptive_rounds:
            ap.error("--alpha-bounds needs --adaptive-rounds > 0: α "
                     "retuning happens at the controller's round "
                     "boundaries")
        if args.quality_probe_rate <= 0.0:
            ap.error("--alpha-bounds needs --quality-probe-rate > 0: "
                     "without probe samples there is no quality signal "
                     "to retune α from")
        try:
            bounds = parse_alpha_bounds(args.alpha_bounds)
        except ValueError as e:
            ap.error(str(e))
        if not bounds[0] <= args.alpha <= bounds[1]:
            ap.error(f"--alpha {args.alpha} lies outside --alpha-bounds "
                     f"{bounds[0]}:{bounds[1]}; start the campaign "
                     f"inside the operator bounds")
    try:
        pools = parse_pools(args.pools) if args.pools else None
    except ValueError as e:
        ap.error(str(e))
    fleet = args.workers or args.fabric_workers
    if fleet and pools and len(pools) != fleet:
        ap.error(f"a {fleet}-worker fleet with --pools needs the pool "
                 f"spec to name exactly {fleet} nodes, got "
                 f"{len(pools)} ({args.pools}); size the pools to the "
                 f"worker fleet")
    try:
        device = device_lib.resolve(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {args.device}: {e}")

    if args.tuning_dir:
        # coordinator-side store handle: router training and single-node
        # runs consult (and, on the card, populate) the same winners the
        # worker fleet shares via WorkerSpec.tuning_dir
        from repro_torch.kernels import tuning_store
        tuning_store.configure(args.tuning_dir)

    ccfg = CorpusConfig(n_docs=args.docs, seed=args.seed)
    docs = generate_corpus(ccfg)
    n_train = args.docs // 3
    train, test = docs[:n_train], docs[n_train:]
    rng = np.random.RandomState(args.seed + 1)
    router = (build_ft_router(train, ccfg, rng, device=device)
              if args.variant == "ft"
              else build_llm_router(train, ccfg, rng, device=device))
    nodes = (args.workers or args.fabric_workers
             or (len(pools) if pools else args.nodes))
    ecfg = EngineConfig(alpha=args.alpha, batch_size=args.batch_size,
                        seed=args.seed, prefetch_depth=args.prefetch_depth)
    eng = AdaParseEngine(ecfg, router, ccfg, device=device)
    if args.cache_dir:
        cache = DiskResultStore(args.cache_dir,
                                max_bytes=args.cache_max_bytes)
    elif args.warm_cache:
        cache = ResultCache()
    else:
        cache = None
    obs_on = bool(args.trace_dir or args.metrics_out)
    if (nodes > 1 or pools or args.adaptive_rounds or args.workers
            or args.fabric_workers or cache is not None or obs_on):
        runtime = ("fabric" if args.fabric_workers
                   else "process" if args.workers else "local")
        xcfg = ExecutorConfig(
            n_nodes=nodes, node_pools=pools,
            prefetch_depth=args.prefetch_depth,
            runtime=runtime,
            heartbeat_timeout_s=(args.heartbeat_timeout
                                 if args.heartbeat_timeout is not None
                                 else 30.0),
            transport=args.transport or "shm",
            tuning_dir=args.tuning_dir,
            coordinator=args.coordinator or "127.0.0.1:0",
            # an explicit --coordinator means standalone workers dial
            # in from elsewhere; without it serve provisions its
            # own loopback fleet
            fabric_spawn=args.coordinator is None,
            obs=obs_on, status_interval_s=args.status_interval)
        if args.adaptive_rounds:
            probe = (QualityProbeConfig(probe_rate=args.quality_probe_rate,
                                        seed=args.seed)
                     if args.quality_probe_rate > 0 else None)
            executor = CampaignController(
                ecfg, xcfg,
                ControllerConfig(rounds=args.adaptive_rounds,
                                 alpha_bounds=bounds,
                                 alpha_step=args.alpha_step,
                                 quality_target=args.quality_target,
                                 probe=probe),
                router, ccfg, device=device)
        else:
            executor = CampaignExecutor(ecfg, xcfg, router, ccfg,
                                        device=device)
        cold = executor.run(test, cache=cache)
        # evaluate() throughput comes from the COLD run's real parse
        # costs (a warm replay charges ~no node-seconds)
        for st in cold.node_stats:
            eng.stats.n_docs += st.n_docs
            eng.stats.n_expensive += st.n_expensive
            eng.stats.node_seconds += st.node_seconds
        pool_desc = ",".join(pools) if pools else f"{nodes}x homogeneous"

        def report(label, xres):
            print(f"[serve] executor[{label}] nodes={nodes} ({pool_desc}) "
                  f"runtime={xcfg.runtime} "
                  f"prefetch={args.prefetch_depth} "
                  f"wall={xres.wall_s:.1f}s docs/s={xres.docs_per_s:.1f} "
                  f"busy={xres.node_busy_frac:.2f} reissued={xres.reissued} "
                  f"cache={xres.cache_hits}h/{xres.cache_misses}m")
            if getattr(xres, "weight_history", None):
                w = ["/".join(f"{x:.2f}" for x in ws)
                     for ws in (xres.weight_history[0],
                                xres.weight_history[-1])]
                print(f"[serve]   adaptive rounds={xres.rounds} "
                      f"weights {w[0]} -> {w[1]}")
                if args.quality_probe_rate > 0 and xres.telemetry:
                    traj = "->".join(f"{t.alpha:.2f}"
                                     for t in xres.telemetry)
                    n_probe = sum(t.n_probe_docs for t in xres.telemetry)
                    print(f"[serve]   quality probe docs={n_probe} "
                          f"alpha {traj} "
                          f"(bounds={args.alpha_bounds or 'off'})")

        report("cold", cold)
        recs = cold.records
        runs = [cold]
        if args.warm_cache:
            warm = executor.run(test, cache=cache)
            report("warm", warm)
            recs = warm.records
            runs.append(warm)
        if obs_on:
            spans = [s for r in runs for s in (r.spans or [])]
            folded = obs.fold([r.obs_metrics or {} for r in runs])
            if args.trace_dir:
                path = obs.TraceWriter(args.trace_dir).write(spans)
                print(f"[serve] trace written to {args.trace_dir} "
                      f"({len(spans)} spans; Chrome timeline at {path}); "
                      f"summarize with: python -m "
                      f"repro_torch.launch.obs_report --trace-dir "
                      f"{args.trace_dir}")
            if args.metrics_out:
                with open(args.metrics_out, "w") as f:
                    f.write(obs.prometheus_text(folded))
                print(f"[serve] metrics written to {args.metrics_out}")
    else:
        recs = eng.run(test)
    res = eng.evaluate(test, recs)
    if eng.stats.n_docs and eng.stats.node_seconds == 0.0:
        # every batch replayed from a pre-warmed store: there are no
        # real parse costs to report a throughput from
        print("[serve] all batches replayed from cache; "
              "throughput_docs_per_node_s reported as 0")
        res["throughput_docs_per_node_s"] = 0.0
    print(f"[serve] AdaParse({args.variant}) alpha={args.alpha} "
          f"n_test={len(test)} device={device}")
    for k, v in res.items():
        print(f"  {k:28s} {v:.4f}")
    return res

if __name__ == "__main__":
    main()
