"""Multi-node parsing campaigns (Fig. 5 + §7.3): real executor,
adaptive controller, and the analytic simulator.

``CampaignExecutor`` runs a *real* ``AdaParseEngine`` per node over
shards of the global batch sequence: per-node work queues, per-node
warm-start, straggler re-issue of actual batches, and per-node α
budgets that partition the campaign budget (the §4.1 argument: node
budgets sum to the campaign budget, so scheduling stays embarrassingly
parallel and node-local).

The executor is built on the parser-backend runtime (core/backends):

- **Heterogeneous pools** (``ExecutorConfig.node_pools``): nodes are
  partitioned by device; batches shard over the pool matching the cheap
  backend's device (the ingest pool runs prepare + route), and the
  expensive re-parse of each routed batch is forwarded to the
  least-loaded node of the pool matching the expensive backend's device
  (cheap CPU heuristics next to GPU models — the paper's
  resource-scaling axis).
- **Pool-aware straggler re-issue** (``scheduler.reissue_candidates``):
  a hung ingest batch re-issues to a peer of the ingest pool; a
  forwarded expensive re-parse stuck on a GPU-pool node re-issues to
  the least-loaded peer *in that pool*, crossing pools only when the
  backend's device allows (CPU work runs anywhere, GPU work cannot
  leave the GPU pool).
- **Prefetch overlap** (``ExecutorConfig.prefetch_depth``): each ingest
  node streams its queue through ``data/pipeline.Prefetcher`` so the
  host channel application of the next batch overlaps the
  routing/re-parse of the current one.
- **Result store** (any ``backends.ResultStore`` passed to ``run``):
  batches already parsed in a prior campaign are replayed instead of
  re-parsed; hit/miss counters land in ``ExecutorResult``. With a
  ``DiskResultStore`` the replay works across process restarts.
- **Speed-weighted sharding**: ``node_budget_weights`` skews both the
  expensive-parse budget *and* the shard sizes toward faster nodes
  (uniform round-robin by default).

``CampaignController`` is the *adaptive* layer on top (the paper's
headline claim — resource scaling that responds to observed throughput,
not operator-set constants): it dispatches the batch sequence in
rounds, reads the per-stage timing telemetry the engines emit
(``engine.BatchTelemetry`` / per-node clocks), maintains an EWMA
throughput estimate per ingest node, and re-derives the shard weights —
and with them the per-node α-budget split, which follows shard sizes —
before every round. Slow nodes shed shards, fast nodes absorb them,
without operator tuning. Because per-node budgets stay proportional to
shard sizes, every node routes at the campaign α, so the adaptive
record set is *identical* to the single-node run no matter how the
weights evolve; replaying a recorded telemetry trace
(``ControllerConfig.telemetry_trace``) additionally pins the weight
trajectory itself.

With ``ControllerConfig.alpha_bounds`` set the controller also closes
the *quality* loop (core/quality): a deterministic batch-keyed
``QualityProbe`` scores sampled batches with the batched jitted
scorers in core/metrics, per-parser EWMAs accumulate in a
``QualityMonitor``, and at round boundaries the campaign α itself
moves — inside the operator bounds, at most ``alpha_step`` per round —
toward the cheapest α that meets ``quality_target``. Every
(round, α, quality) decision is recorded in
``ControllerResult.telemetry`` and replayable, so a recorded retuned
campaign reproduces its α trajectory and record set bit-identically
across restarts; without a trace, divergence is round-granular.

Both the executor and the controller dispatch through one
``workers.WorkerPool``: ``ExecutorConfig.runtime="local"`` (the
default, and the only runtime ported so far) runs the simulated
in-process fleet (``workers.LocalWorkerPool``). ``runtime="process"``
(real OS worker processes) and ``runtime="fabric"`` (workers over TCP)
are ROADMAP items 12b and 12c; ``workers.make_worker_pool`` raises for
them. ``ExecutorConfig`` keeps every field of theirs, so configs
round-trip.

Device: every node's engine and the controller's quality probe run on
the one torch device the campaign is given (``device``, cuda unless
the caller passes "cpu"; asking for cuda without a card raises). N
simulated nodes share that card and one router; a node's pool
("cpu"/"gpu") names the simulated backend's device, never a torch
device. The simulated clocks (``wall_s``, ``docs_per_s``,
``node_busy_frac``) come from the cost models and are the same on
either device.

Batch rng streams are keyed by the batch's *global* index
(engine.process_batch batch_key) and carried from prepare into
complete, so an N-node campaign — pooled, prefetched, cached,
re-issued, crash-recovered, adaptive, or all of the above, in either
runtime — produces exactly the record set of a single-node run over
the same corpus.

``simulate_parser_campaign`` remains the analytic fast path: per-backend
node throughput, warm-start costs, shared-filesystem bandwidth contention
(the PyMuPDF/pypdf plateau), Marker's scale ceiling, and straggler
injection + re-issue, all in closed-form cost arithmetic (used by the
scaling benchmarks, where running 128 real engines would be pointless).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import backends as B
from repro_torch.core import obs
from repro_torch.core import scheduler
from repro_torch.core.engine import (AdaParseEngine, EngineConfig,
                                     ParseRecord)
from repro_torch.core.quality import (QualityMonitor, QualityProbe,
                                      QualityProbeConfig, propose_alpha)
from repro_torch.core.workers import (FaultInjection,  # noqa: F401
                                      LocalWorkerPool, make_worker_pool)
from repro_torch.data.pipeline import BatchSource, batches_for_indices


@dataclasses.dataclass
class CampaignConfig:
    n_nodes: int = 128
    n_docs: int = 100_000
    fs_bandwidth_Bps: float = 650e9     # Eagle Lustre aggregate
    fs_share: float = 0.001             # campaign's share of aggregate BW
    straggler_rate: float = 0.005       # per-batch probability
    straggler_slowdown: float = 4.0
    deadline_factor: float = 2.5        # re-issue if > factor * mean batch
    batch_size: int = 256
    seed: int = 0


@dataclasses.dataclass
class CampaignResult:
    wall_s: float
    docs_per_s: float
    node_busy_frac: float
    reissued: int


def simulate_parser_campaign(parser: str, cfg: CampaignConfig,
                             alpha: float | None = None,
                             router_cost_s: float = 0.0,
                             cheap: str | None = None,
                             expensive: str | None = None
                             ) -> CampaignResult:
    """Simulate a campaign. ``parser`` is a backend name or "adaparse_ft" /
    "adaparse_llm" (α-budget two-parser mix)."""
    from repro_torch.core import parsers as P

    rng = np.random.RandomState(cfg.seed)
    adaptive = parser.startswith("adaparse")
    if adaptive:
        cheap_info = B.get_backend(cheap or P.CHEAP_PARSER).info
        exp_info = B.get_backend(expensive or P.EXPENSIVE_PARSER).info
        a = 0.05 if alpha is None else alpha
        t_doc = ((1 - a) / cheap_info.pdf_per_sec_node
                 + a / exp_info.pdf_per_sec_node
                 + router_cost_s)
        warm = exp_info.warm_start_s
        io_doc = cheap_info.io_bytes_per_doc
        cap_nodes = 10 ** 9
    else:
        info = B.get_backend(parser).info
        t_doc = 1.0 / info.pdf_per_sec_node
        warm = info.warm_start_s
        io_doc = info.io_bytes_per_doc
        cap_nodes = info.scale_cap_nodes

    eff_nodes = min(cfg.n_nodes, cap_nodes)
    n_batches = max(cfg.n_docs // cfg.batch_size, 1)
    batch_t = t_doc * cfg.batch_size
    # shared-FS ceiling: bytes/s this campaign may draw
    fs_Bps = cfg.fs_bandwidth_Bps * cfg.fs_share
    io_batch_t = io_doc * cfg.batch_size / fs_Bps * cfg.n_nodes
    # node clocks
    clocks = np.full(eff_nodes, warm, np.float64)
    reissued = 0
    mean_batch = batch_t + io_batch_t
    for _ in range(n_batches):
        i = int(np.argmin(clocks))
        dur = batch_t + io_batch_t
        if rng.rand() < cfg.straggler_rate:
            dur_straggle = dur * cfg.straggler_slowdown
            if dur_straggle > cfg.deadline_factor * mean_batch:
                # re-issue on the next-fastest node after the deadline
                reissued += 1
                clocks[i] += cfg.deadline_factor * mean_batch
                j = int(np.argmin(clocks))
                clocks[j] += dur
                continue
            dur = dur_straggle
        clocks[i] += dur
    wall = float(np.max(clocks))
    busy = float(np.sum(clocks - warm) / (eff_nodes * wall))
    return CampaignResult(wall, cfg.n_docs / wall, busy, reissued)


# ---------------------------------------------------------------------------
# Real multi-node executor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecutorConfig:
    n_nodes: int = 2
    straggler_rate: float = 0.01        # per-batch hang probability
    straggler_slowdown: float = 4.0
    deadline_factor: float = 2.5        # re-issue if > factor * mean batch
    seed: int = 0
    # relative per-node budget weights (len n_nodes); None = uniform.
    # Uniform weights recover the campaign alpha on every node (exact
    # single-node record parity); heterogeneous weights give faster
    # nodes a larger share of the expensive-parse budget AND a
    # proportionally larger shard of the corpus (speed-weighted
    # sharding).
    node_budget_weights: list[float] | None = None
    # device per node ("cpu" | "gpu", len n_nodes); None = homogeneous
    # (every node runs the full prepare->route->complete pipeline).
    # With pools, ingest work shards over the nodes matching the cheap
    # backend's device and expensive re-parses are forwarded to the
    # least-loaded node matching the expensive backend's device.
    node_pools: list[str] | None = None
    # >0: each ingest node overlaps the host prepare of upcoming batches
    # with routing/re-parse of the current one (data/pipeline.Prefetcher)
    prefetch_depth: int = 0
    # simulation-only per-node slowdown multipliers (len n_nodes, > 0;
    # 4.0 = node runs 4x slower). Scales the simulated clocks — and
    # therefore the telemetry the adaptive controller observes — but
    # never the records (batch rng streams are placement-independent).
    node_speed_factors: list[float] | None = None
    # --- worker runtime (core/workers) ---
    # "local": the in-process simulated fleet (LocalWorkerPool —
    # injected stragglers, simulated clocks/speed factors).
    # "process" and "fabric" are ROADMAP items 12b and 12c, not ported:
    # workers.make_worker_pool raises for them. In the reference:
    # "process": real OS worker processes (ProcessWorkerPool — spawn
    # context, one engine per worker, heartbeat-deadline straggler
    # detection, worker-crash recovery). straggler_rate /
    # straggler_slowdown / deadline_factor / node_speed_factors are
    # simulation-only and ignored (or rejected) by the process runtime.
    # "fabric": the cross-machine socket runtime (core/fabric —
    # FabricWorkerPool): a coordinator listens on `coordinator` and
    # workers dial in over TCP with elastic membership (join / leave /
    # admission-rejected mid-campaign), same dedup + re-issue brain as
    # the process runtime, payloads inline (no shm across machines).
    runtime: str = "local"
    # fabric runtime: the coordinator's listen address as HOST:PORT
    # (port 0 = auto-bind an ephemeral port; the pool exposes the bound
    # address as `pool.addr` for workers to dial)
    coordinator: str = "127.0.0.1:0"
    # fabric runtime: True (default) has the pool launch its own
    # loopback worker processes (launch/fabric_worker.spawn_loopback);
    # False leaves every slot open for external workers dialing in
    # (serve.py --connect from other terminals or machines)
    fabric_spawn: bool = True
    # fabric runtime: deterministic elastic-membership schedule for
    # tests and the scenario lab (core/fabric.FabricElastic: deferred
    # mid-campaign joins + intentionally-rejected dialers); production
    # campaigns leave this None
    fabric: object | None = None
    # a worker that sends no heartbeat for this long is treated as
    # wedged: its in-flight batches re-issue to the least-loaded
    # eligible pool peer (it rejoins on its next heartbeat; late
    # duplicate results are dropped)
    heartbeat_timeout_s: float = 30.0
    heartbeat_interval_s: float = 0.5
    # bounded drain-exit linger for a recovered straggler's late
    # duplicate result (dedup accounting only — records are final at
    # first completion, and the linger is excluded from wall_s)
    straggler_grace_s: float = 2.0
    # spawn + imports + engine build budget per worker fleet
    worker_start_timeout_s: float = 180.0
    # deterministic fault hooks for the process runtime (tests/chaos
    # demos): workers.FaultInjection
    fault_injection: FaultInjection | None = None
    # ((module, attr), ...) backend factories re-registered inside each
    # worker process, so custom backends flow into the process runtime
    # the same way they flow through the in-process registry
    worker_backend_specs: tuple = ()
    # batch payload transport for the process runtime: "shm" moves the
    # numpy-heavy bulk (docs, forwarded preps, records) through
    # zero-copy generation-tagged shared-memory arenas (core/shm),
    # falling back to pickled payloads with a warning when /dev/shm is
    # unavailable; "pickle" forces the queue-serialized path. Ignored
    # by the local runtime (no process boundary to cross).
    transport: str = "shm"
    # fleet-shared persistent autotune store directory
    # (kernels/tuning_store): every worker process opens a handle on
    # the same dir, so kernel block-size sweeps run once per
    # (kernel, shape, backend, device) across the fleet's lifetime —
    # a warm restart re-sweeps nothing. None disables persistence
    # (workers fall back to per-process defaults, no sweeps).
    tuning_dir: str | None = None
    # --- observability plane (core/obs) ---
    # span tracing: False keeps the provably-free noop recorder in
    # every process; True installs bounded ring recorders (coordinator
    # + each worker), with worker spans piggybacked on the existing
    # BatchDone/Heartbeat messages — no new queues, drop-counted on
    # overflow, never blocking the hot path
    obs: bool = False
    obs_span_cap: int = 8192
    # >0 (process runtime): a periodic one-line stderr status pulse
    # from the coordinator drain loop (docs/s, α, cache hit rate,
    # in-flight, re-issues) — serve.py --status-interval
    status_interval_s: float = 0.0


@dataclasses.dataclass
class ExecutorResult:
    records: dict[int, ParseRecord]
    wall_s: float
    docs_per_s: float
    node_busy_frac: float
    reissued: int
    node_alphas: list[float]
    node_stats: list                    # per-node EngineStats
    cache_hits: int = 0
    cache_misses: int = 0
    reissued_reparse: int = 0           # of `reissued`: forwarded re-parses
    # process runtime only: late results from re-issued stragglers that
    # lost the first-completion race (dropped, never double-emitted)
    duplicates_dropped: int = 0
    # observability plane (core/obs): the run's collected spans (empty
    # unless ExecutorConfig.obs) and the fleet-folded metrics snapshot
    # (coordinator registry diffed against the run baseline + the last
    # per-worker snapshots) — feed obs.TraceWriter / obs.prometheus_text
    spans: list = dataclasses.field(default_factory=list)
    obs_metrics: dict | None = None


def _obs_begin(xcfg) -> dict:
    """Per-run observability setup: install a fresh ring recorder in
    this (coordinator) process when tracing is on — discarding spans
    from any earlier run — and take the registry baseline so the run's
    folded metrics report this run only (counters are cumulative per
    process, and tests run many campaigns in one interpreter)."""
    if getattr(xcfg, "obs", False):
        obs.configure(True, cap=getattr(xcfg, "obs_span_cap", 8192),
                      node=-1)
    return obs.metrics().snapshot()


def _obs_collect(pool, baseline: dict) -> tuple[list, dict]:
    """Assemble the run's observability artifacts: worker spans/snaps
    absorbed by the pool, plus this process's recorder drain and
    baseline-diffed registry, folded fleet-wide."""
    spans, snaps = pool.obs_drain()
    spans = spans + obs.recorder().drain(None)
    spans.sort(key=lambda s: s.start)
    local = obs.diff(obs.metrics().snapshot(), baseline)
    if obs.recorder().enabled:
        # tracing never outlives its run: restore the noop recorder so
        # later (untraced) campaigns in this process pay nothing
        obs.configure(False)
    return spans, obs.fold(snaps + [local])


def document_shard_source(docs, batch_size: int, shard: int,
                          n_shards: int, seed: int = 0) -> BatchSource:
    """Per-node work queue over the corpus: shard ``shard`` yields the
    global batches ``shard, shard + n_shards, ...`` (round-robin), each
    tagged with its global batch index so any node reproduces the same
    stateless rng stream for it."""

    def fn(step, rng):
        g = step * n_shards + shard
        lo = g * batch_size
        if lo >= len(docs):
            raise StopIteration
        return {"batch_key": g, "docs": docs[lo:lo + batch_size]}

    return BatchSource(fn, seed=seed, shard=shard)


def weighted_shard_batches(n_batches: int,
                           weights: list[float]) -> list[list[int]]:
    """Assign global batch indices to shards so shard sizes follow the
    weights (deficit round-robin: batch g goes to the shard furthest
    below its quota w_i·(g+1)). Uniform weights recover plain
    round-robin, and the assignment is deterministic — batch keys stay
    global, so records are placement-independent.

    Degenerate inputs fall back to uniform: all-zero weights carry no
    signal, and with more shards than batches the quota arithmetic
    would pile the few batches onto the heaviest shard while other
    nodes idle — round-robin (one batch per shard) is optimal there.
    Negative weights are an error."""
    w = np.asarray(weights, np.float64)
    if np.any(w < 0):
        raise ValueError("shard weights must be non-negative")
    if w.sum() <= 0 or n_batches < len(w):
        w = np.ones(len(w), np.float64)
    w = w / w.sum()
    assigned = np.zeros(len(w), np.float64)
    shards: list[list[int]] = [[] for _ in w]
    for g in range(n_batches):
        i = int(np.argmax(w * (g + 1) - assigned))
        shards[i].append(g)
        assigned[i] += 1.0
    return shards


#: The simulated in-process dispatch loop moved to core/workers as
#: ``LocalWorkerPool`` (one of the two ``WorkerPool`` runtimes); the
#: old name stays importable.
_CampaignRun = LocalWorkerPool


class CampaignExecutor:
    """Run a real engine per node over shards of the batch sequence.

    The campaign α-budget T̄ = K·((1−α)·T_cheap + α·T_exp) is partitioned
    across ingest nodes proportionally to their shard sizes; each node
    solves its own α_i = alpha_for_budget(T̄_i) (node budgets sum to the
    campaign budget). For homogeneous shards α_i = α exactly (snapped
    against float round-trip), which is what makes the N-node record set
    identical to the single-node run.

    Every engine runs on ``device`` (resolved once; cuda unless "cpu").
    The nodes share ``router``: one encoder on the card, and one memoised
    cache fingerprint (``engine._router_fingerprint``)."""

    def __init__(self, ecfg: EngineConfig, xcfg: ExecutorConfig, router,
                 corpus_cfg, image_degraded=False, text_degraded=False,
                 probe: QualityProbe | None = None, device=None):
        self.device = device_lib.resolve(device)
        self.ecfg = ecfg
        self.xcfg = xcfg
        self.router = router
        self.ccfg = corpus_cfg
        self.image_degraded = image_degraded
        self.text_degraded = text_degraded
        self.probe = probe

    def _topology(self, n_batches: int):
        """(n_nodes, ingest_nodes, reparse_nodes, pools) for this run."""
        pools = self.xcfg.node_pools
        if pools is None:
            n_nodes = max(min(self.xcfg.n_nodes, n_batches), 1)
            ingest_nodes = list(range(n_nodes))
            reparse_nodes = ingest_nodes
            return n_nodes, ingest_nodes, reparse_nodes, None
        n_nodes = self.xcfg.n_nodes
        if len(pools) != n_nodes:
            raise ValueError(f"need {n_nodes} node pool entries, got "
                             f"{len(pools)}")
        cheap_dev = B.get_backend(self.ecfg.cheap).info.device
        exp_dev = B.get_backend(self.ecfg.expensive).info.device
        all_nodes = list(range(n_nodes))
        ingest_nodes = [i for i in all_nodes
                        if pools[i] == cheap_dev] or all_nodes
        reparse_nodes = [i for i in all_nodes
                         if pools[i] == exp_dev] or all_nodes
        return n_nodes, ingest_nodes, reparse_nodes, pools

    def _build_engines(self, n_nodes: int, alpha_of: dict[int, float],
                       cache, probe=None) -> list[AdaParseEngine]:
        return [
            AdaParseEngine(
                dataclasses.replace(self.ecfg,
                                    alpha=alpha_of.get(i, self.ecfg.alpha)),
                self.router, self.ccfg,
                image_degraded=self.image_degraded,
                text_degraded=self.text_degraded, cache=cache,
                probe=probe if probe is not None else self.probe,
                device=self.device)
            for i in range(n_nodes)]

    def _make_pool(self, n_nodes: int, ingest_nodes: list[int],
                   reparse_nodes: list[int], pools: list[str] | None,
                   alpha_of: dict[int, float], cache, probe=None):
        """Build the worker pool for this run (``ExecutorConfig
        .runtime``): the local simulated fleet over caller-built
        engines. Real workers — spawned processes or fabric dialers,
        ROADMAP items 12b and 12c — are not ported: ``make_worker_pool``
        raises for them before any engine is built."""
        probe = probe if probe is not None else self.probe
        if getattr(self.xcfg, "runtime", "local") in ("process",
                                                      "fabric"):
            return make_worker_pool(
                self.ecfg, self.xcfg, self.router, self.ccfg, n_nodes,
                ingest_nodes, reparse_nodes, pools, alpha_of=alpha_of,
                cache=cache, probe=probe,
                image_degraded=self.image_degraded,
                text_degraded=self.text_degraded)
        engines = self._build_engines(n_nodes, alpha_of, cache, probe)
        return make_worker_pool(
            self.ecfg, self.xcfg, self.router, self.ccfg, n_nodes,
            ingest_nodes, reparse_nodes, pools, engines=engines)

    def _node_alphas(self, shard_sizes: list[int],
                     weights: list[float] | None) -> list[float]:
        """Partition the campaign budget T̄ = K·((1−α)T_c + α·T_e) into
        per-node budgets T̄_i and solve each node's α_i. Budget shares
        follow ``weights`` (scaled by shard size); with uniform weights
        every α_i is exactly the campaign α."""
        a = self.ecfg.alpha
        n = len(shard_sizes)
        if weights is None:
            # uniform partition ≡ campaign alpha on every node; skip the
            # round-trip so record parity with a single-node run is exact
            return [a] * n
        t_c = 1.0 / B.get_backend(self.ecfg.cheap).info.pdf_per_sec_node
        t_e = 1.0 / B.get_backend(self.ecfg.expensive).info.pdf_per_sec_node
        total_budget = sum(shard_sizes) * ((1 - a) * t_c + a * t_e)
        shares = np.asarray(weights, np.float64) * np.asarray(
            shard_sizes, np.float64)
        shares = shares / max(shares.sum(), 1e-12)
        return [
            scheduler.alpha_for_budget(float(total_budget * s), k_i, t_c,
                                       t_e) if k_i else a
            for s, k_i in zip(shares, shard_sizes)]

    def run(self, docs, cache: B.ResultStore | None = None
            ) -> ExecutorResult:
        bs = self.ecfg.batch_size
        n_batches = max(-(-len(docs) // bs), 1)
        n_nodes, ingest_nodes, reparse_nodes, pools = \
            self._topology(n_batches)

        w = self.xcfg.node_budget_weights
        if w is not None and len(w) != n_nodes:
            raise ValueError(f"need {n_nodes} node weights, got {len(w)}")
        ingest_w = [w[i] for i in ingest_nodes] if w is not None else None
        if ingest_w is None:
            queues = {
                node: list(document_shard_source(docs, bs, j,
                                                 len(ingest_nodes),
                                                 seed=self.ecfg.seed))
                for j, node in enumerate(ingest_nodes)}
        else:
            shards = weighted_shard_batches(n_batches, ingest_w)
            queues = {
                node: batches_for_indices(docs, bs, shard)
                for node, shard in zip(ingest_nodes, shards)}
        alphas = self._node_alphas(
            [sum(len(b["docs"]) for b in queues[i]) for i in ingest_nodes],
            ingest_w)
        alpha_of = {node: a for node, a in zip(ingest_nodes, alphas)}
        obs_base = _obs_begin(self.xcfg)
        pool = self._make_pool(n_nodes, ingest_nodes, reparse_nodes,
                               pools, alpha_of, cache)
        try:
            hits0, miss0 = pool.snapshot_cache(cache)
            pool.drain(queues)
            node_alphas = [alpha_of.get(i, self.ecfg.alpha)
                           for i in range(n_nodes)]
            spans, folded = _obs_collect(pool, obs_base)
            return ExecutorResult(
                node_alphas=node_alphas, spans=spans,
                obs_metrics=folded,
                **pool.finalize(len(docs), cache, hits0, miss0))
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# Round-based adaptive controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ControllerConfig:
    """Knobs of the adaptive round loop."""

    rounds: int = 4                  # dispatch the batch sequence in rounds
    ewma: float = 0.5                # weight of the newest observation
    min_weight: float = 0.02         # per-node floor of normalized weights
    # replayed telemetry: per-round observations used INSTEAD of the
    # measured clocks / probe signal. A recorded trace
    # (ControllerResult.telemetry, RoundTelemetry entries) replayed
    # here pins the whole weight trajectory AND the α trajectory,
    # making adaptive runs reproducible across cache states and process
    # restarts; the older format (bare per-ingest-node docs/s lists)
    # still works and pins the weights only.
    telemetry_trace: list | None = None
    # --- online α retuning (core/quality; None = fixed campaign α) ---
    # operator bounds (lo, hi) the retuned campaign α must stay inside;
    # None disables retuning (quality is still monitored when a probe
    # is configured)
    alpha_bounds: tuple[float, float] | None = None
    alpha_step: float = 0.05         # max per-round α movement
    quality_target: float = 0.45     # blended quality the campaign aims at
    quality_ewma: float = 0.5        # QualityMonitor EWMA weight
    # probe sampling config; defaulted when retuning is enabled without
    # one (alpha_bounds set, probe None)
    probe: QualityProbeConfig | None = None


@dataclasses.dataclass
class RoundTelemetry:
    """One adaptive round's recorded observations + decisions — the
    unit of ``ControllerResult.telemetry`` and of trace replay
    (``ControllerConfig.telemetry_trace``)."""

    alpha: float                     # campaign α used for this round
    throughput: list[float]          # measured per-ingest-node docs/s
    # per-parser quality EWMAs after absorbing this round's probe
    # samples (empty before the first probed batch)
    quality: dict[str, float] = dataclasses.field(default_factory=dict)
    n_probe_docs: int = 0            # fresh probe docs observed this round
    # α decision taken at this round's boundary: "raise" | "lower" |
    # "hold" | "no-signal" (no fresh probe docs — never retune on a
    # stale EWMA) | "replay" (α pinned by a replayed trace) | "fixed"
    # (retuning disabled)
    decision: str = "fixed"


@dataclasses.dataclass
class ControllerResult(ExecutorResult):
    rounds: int = 0
    # weights used for round r (normalized over ingest nodes), plus one
    # final post-update entry — the weights a further round would use
    weight_history: list[list[float]] = dataclasses.field(
        default_factory=list)
    # per-round RoundTelemetry (measured throughput, α, quality EWMAs,
    # retune decisions) — replayable as ControllerConfig.telemetry_trace
    telemetry: list[RoundTelemetry] = dataclasses.field(
        default_factory=list)

    @property
    def alpha_trajectory(self) -> list[float]:
        return [t.alpha for t in self.telemetry]


def _round_trace(trace, r) -> tuple[list[float] | None, float | None]:
    """(throughput_obs, alpha) replayed for round ``r``: accepts
    RoundTelemetry entries (a recorded ControllerResult.telemetry),
    equivalent dicts, or bare per-node docs/s lists (which pin
    the weights but leave α live)."""
    if trace is None or r >= len(trace):
        return None, None
    entry = trace[r]
    if isinstance(entry, RoundTelemetry):
        return list(entry.throughput), entry.alpha
    if isinstance(entry, dict):
        tp = entry.get("throughput")
        return (list(tp) if tp is not None else None), entry.get("alpha")
    return list(entry), None


class CampaignController:
    """Round-based adaptive campaign: online-autotuned budget weights.

    Each round takes the next contiguous chunk of the global batch
    sequence and shards it over the ingest pool with
    ``weighted_shard_batches`` under the *current* weights. After the
    round, per-node throughput observed from the simulated clocks (or
    taken from a replayed telemetry trace) updates an EWMA estimate,
    which — normalized with a small floor — becomes the next round's
    weights: slow nodes shed shards, fast nodes absorb them.

    The α-budget split follows the shard sizes: per-node expensive-parse
    budgets T̄_i = k_i·((1−α)T_c + α·T_e) sum to the campaign budget in
    every round and put every node at exactly the campaign α. That is
    the determinism contract — however the weights evolve, each batch is
    routed with the same α and parsed under its global batch key, so the
    adaptive record set equals the single-node run byte-for-byte.

    **Online α retuning** (``ControllerConfig.alpha_bounds``,
    core/quality): with bounds set, a deterministic batch-keyed
    ``QualityProbe`` scores sampled batches per parser, a
    ``QualityMonitor`` keeps per-parser quality EWMAs, and at every
    round boundary the controller moves the *campaign* α at most
    ``alpha_step`` toward the cheapest α inside the bounds that meets
    ``quality_target`` — every engine follows (``AdaParseEngine
    .set_alpha``), so all nodes still route at one campaign α. Rounds
    with no fresh probe docs (warm-cache replays, α too small to route)
    hold α ("no-signal") rather than retune on a stale EWMA. Every
    (round, α, quality) decision lands in ``ControllerResult
    .telemetry``; replaying it via ``telemetry_trace`` pins the exact α
    trajectory, so a recorded retuned campaign reproduces its record
    set bit-identically across restarts (cache keys embed α) — the
    relaxed-determinism story: bit-identical under replay,
    round-granular divergence otherwise."""

    def __init__(self, ecfg: EngineConfig, xcfg: ExecutorConfig,
                 ctl: ControllerConfig, router, corpus_cfg,
                 image_degraded=False, text_degraded=False, device=None):
        self.device = device_lib.resolve(device)
        if ctl.rounds < 1:
            raise ValueError(f"need at least 1 round, got {ctl.rounds}")
        if not 0.0 < ctl.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ctl.ewma}")
        if ctl.alpha_bounds is not None:
            lo, hi = ctl.alpha_bounds
            if not 0.0 <= lo <= hi <= 1.0:
                raise ValueError(f"alpha_bounds must satisfy 0 <= lo <= "
                                 f"hi <= 1, got ({lo}, {hi})")
            if not lo <= ecfg.alpha <= hi:
                raise ValueError(f"campaign alpha {ecfg.alpha} lies "
                                 f"outside alpha_bounds ({lo}, {hi}); "
                                 f"start the campaign inside the "
                                 f"operator bounds")
            if ctl.alpha_step <= 0.0:
                raise ValueError(f"alpha_step must be > 0, got "
                                 f"{ctl.alpha_step}")
        self.ecfg = ecfg
        self.xcfg = xcfg
        self.ctl = ctl
        # a probe is configured explicitly, or defaulted as soon as
        # retuning is on (no signal -> nothing to retune from); it
        # scores on the campaign's device
        self.probe = (QualityProbe(ctl.probe, device=self.device)
                      if ctl.probe is not None
                      else QualityProbe(QualityProbeConfig(),
                                        device=self.device)
                      if ctl.alpha_bounds is not None else None)
        self.executor = CampaignExecutor(ecfg, xcfg, router, corpus_cfg,
                                         image_degraded=image_degraded,
                                         text_degraded=text_degraded,
                                         probe=self.probe,
                                         device=self.device)

    def _normalize(self, est: list[float]) -> list[float]:
        w = np.asarray(est, np.float64)
        w = w / max(w.sum(), 1e-12)
        w = np.maximum(w, self.ctl.min_weight)
        return list(w / w.sum())

    def run(self, docs, cache: B.ResultStore | None = None
            ) -> ControllerResult:
        bs = self.ecfg.batch_size
        n_batches = max(-(-len(docs) // bs), 1)
        n_nodes, ingest_nodes, reparse_nodes, pools = \
            self.executor._topology(n_batches)
        obs_base = _obs_begin(self.xcfg)
        # every node at the campaign alpha (see class docstring)
        pool = self.executor._make_pool(n_nodes, ingest_nodes,
                                        reparse_nodes, pools, {}, cache)
        try:
            return self._run_rounds(pool, docs, cache, n_nodes,
                                    ingest_nodes, obs_base=obs_base)
        finally:
            pool.close()

    def _run_rounds(self, pool, docs, cache, n_nodes: int,
                    ingest_nodes: list[int],
                    obs_base: dict | None = None) -> ControllerResult:
        bs = self.ecfg.batch_size
        n_batches = max(-(-len(docs) // bs), 1)
        hits0, miss0 = pool.snapshot_cache(cache)

        w0 = self.xcfg.node_budget_weights
        if w0 is not None and len(w0) != n_nodes:
            raise ValueError(f"need {n_nodes} node weights, got {len(w0)}")
        weights = self._normalize(
            [w0[i] for i in ingest_nodes] if w0 is not None
            else [1.0] * len(ingest_nodes))
        est: list[float] | None = None
        rounds = max(min(self.ctl.rounds, n_batches), 1)
        trace = self.ctl.telemetry_trace
        weight_history: list[list[float]] = []
        telemetry: list[RoundTelemetry] = []
        monitor = QualityMonitor(ewma=self.ctl.quality_ewma)
        retune = self.ctl.alpha_bounds is not None
        alpha = self.ecfg.alpha
        # quality samples come from ALL nodes' telemetry (re-parse
        # pool nodes complete forwarded batches onto ingest engines,
        # but re-issue paths can append anywhere) — track a per-node
        # high-water mark
        qmark = [len(pool.node_telemetry(i)) for i in range(n_nodes)]

        for r in range(rounds):
            lo = r * n_batches // rounds
            hi = (r + 1) * n_batches // rounds
            if hi <= lo:
                continue
            trace_tp, trace_alpha = _round_trace(trace, r)
            if trace_alpha is not None and trace_alpha != alpha:
                # replayed α trajectory: pin this round's campaign α
                # (and with it the cache tags) before dispatching
                alpha = trace_alpha
                pool.set_alpha(alpha)
            t_round0 = time.time()
            # elastic fleets (the fabric runtime) re-shard over the
            # *live* ingest nodes at every round boundary: a worker
            # that joined since last round absorbs shards, one that
            # left sheds them. Records are placement-independent
            # (global batch keys), so membership churn never changes
            # the record set — only who computes it.
            live = ingest_nodes
            if hasattr(pool, "live_ingest_nodes"):
                live = [i for i in pool.live_ingest_nodes()
                        if i in ingest_nodes] or ingest_nodes
            if live == ingest_nodes:
                round_w = weights
            else:
                idx = {n: j for j, n in enumerate(ingest_nodes)}
                round_w = self._normalize(
                    [weights[idx[i]] for i in live])
            shards = weighted_shard_batches(hi - lo, round_w)
            queues = {
                node: batches_for_indices(docs, bs,
                                          [lo + j for j in shard])
                for node, shard in zip(live, shards)}
            weight_history.append(list(weights))
            tele0 = [len(pool.node_telemetry(i)) for i in ingest_nodes]
            clk0 = pool.clocks.copy()
            pool.drain(queues)
            measured = []
            for j, i in enumerate(ingest_nodes):
                # docs from the round's per-stage telemetry records,
                # excluding cache replays (their docs advance no clock)
                # and abandoned straggler attempts (their docs were
                # re-produced elsewhere) — counting either would inflate
                # the node's observed docs/s and mis-steer the weights
                d_docs = sum(t.n_docs
                             for t in pool.node_telemetry(i)[tele0[j]:]
                             if not (t.cached or t.abandoned))
                d_clk = float(pool.clocks[i] - clk0[i])
                measured.append(d_docs / d_clk if d_clk > 0 else 0.0)
            # absorb this round's fresh probe samples into the quality
            # EWMAs (cached/abandoned batches carry quality=None).
            # Batch-key order, not completion order: the process
            # runtime completes batches in nondeterministic order, and
            # the EWMA is order-sensitive — sorting keys the quality
            # signal to the corpus, so both runtimes derive the same
            # estimates from the same probed set
            fresh = []
            for i in range(n_nodes):
                tele = pool.node_telemetry(i)
                fresh.extend(t for t in tele[qmark[i]:]
                             if not (t.cached or t.abandoned))
                qmark[i] = len(tele)
            fresh.sort(key=lambda t: (t.batch_key is None, t.batch_key))
            n_probe = 0
            for t in fresh:
                n_probe += monitor.observe(t.quality)
            observed = trace_tp if trace_tp is not None else measured
            if len(observed) != len(ingest_nodes):
                raise ValueError(
                    f"telemetry round {r}: need {len(ingest_nodes)} "
                    f"ingest-node observations, got {len(observed)}")
            # EWMA feedback: a zero observation (no work / warm cache
            # replay charged no time) keeps the previous estimate
            if est is None:
                # unobserved nodes start at the mean of the observed
                # ones (neutral), not at an arbitrary constant that
                # would floor-pin them before they ever ran a batch
                pos = [o for o in observed if o > 0]
                fill = sum(pos) / len(pos) if pos else 1.0
                est = [o if o > 0 else fill for o in observed]
            else:
                a = self.ctl.ewma
                est = [(1 - a) * e + a * o if o > 0 else e
                       for e, o in zip(est, observed)]
            weights = self._normalize(est)
            # round-boundary α decision (applied to the NEXT round;
            # a replayed trace overrides it there)
            # a trace entry only pins α when it carries one — a
            # bare throughput list pins the weights but leaves the α
            # decision live, as documented on _round_trace
            next_alpha = alpha
            if trace_alpha is not None:
                decision = "replay"
            elif not retune:
                decision = "fixed"
            elif n_probe == 0:
                decision = "no-signal"
            else:
                next_alpha, decision = propose_alpha(
                    alpha, monitor, self.ecfg.cheap, self.ecfg.expensive,
                    bounds=self.ctl.alpha_bounds,
                    step=self.ctl.alpha_step,
                    quality_target=self.ctl.quality_target)
            telemetry.append(RoundTelemetry(
                alpha=alpha, throughput=measured,
                quality=monitor.snapshot(), n_probe_docs=n_probe,
                decision=decision))
            rec = obs.recorder()
            if rec.enabled:
                # the α trajectory inline in the timeline: one span per
                # adaptive round carrying the boundary decision, so a
                # bimodal_retune trace shows exactly where α moved
                rec.span("round", f"round-{r}", t_round0,
                         time.time() - t_round0,
                         detail=f"alpha={alpha:.4f} decision={decision}"
                                f" -> {next_alpha:.4f}"
                                f" probe_docs={n_probe}")
            if next_alpha != alpha and r + 1 < rounds:
                # the decision is recorded either way; only apply it
                # when another round will actually route with it
                alpha = next_alpha
                pool.set_alpha(alpha)
        weight_history.append(list(weights))
        spans, folded = _obs_collect(pool, obs_base or {})
        return ControllerResult(
            node_alphas=[alpha] * n_nodes,
            rounds=rounds, weight_history=weight_history,
            telemetry=telemetry, spans=spans, obs_metrics=folded,
            **pool.finalize(len(docs), cache, hits0, miss0))


def autotune_convergence_rounds(weight_history: list[list[float]],
                                rtol: float = 0.05) -> int:
    """Rounds until the controller's weights stabilized: the first round
    index r such that every subsequent update changed no weight by more
    than ``rtol`` relative. len(weight_history) - 1 (i.e. "never, within
    this run") if the last update still moved."""
    n = len(weight_history)
    stable_from = n - 1
    for r in range(n - 1, 0, -1):
        prev, cur = weight_history[r - 1], weight_history[r]
        if all(abs(c - p) <= rtol * max(p, 1e-12)
               for c, p in zip(cur, prev)):
            stable_from = r - 1
        else:
            break
    return stable_from


def scaling_curve(parser: str, node_counts, cfg: CampaignConfig,
                  **kw) -> list[tuple[int, float]]:
    out = []
    for n in node_counts:
        c = dataclasses.replace(cfg, n_nodes=n,
                                n_docs=max(cfg.n_docs, n * 2048))
        out.append((n, simulate_parser_campaign(parser, c, **kw).docs_per_s))
    return out
