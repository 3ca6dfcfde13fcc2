"""Named deterministic stress scenarios over both worker runtimes.

The scenario lab (ROADMAP): every scheduler/runtime change is regression-
tested against a whole matrix of adversarial campaign shapes instead of
one happy path. A scenario is a declarative ``ScenarioSpec`` — corpus
shape, fleet topology/pools, fault schedule (``workers.FaultInjection``),
straggler/speed-skew knobs, cache warmth, adaptive/retune settings — and
``run_scenario`` executes it, asserts the determinism invariant (the
fleet's record set is byte-identical to the single-node in-process
reference), and returns per-scenario goodput/re-issue/dedup counters.

The reference is chosen by the spec: a fixed-α campaign must reproduce a
plain ``AdaParseEngine.run`` (the PR-2..5 contract — batch rng streams
are keyed by global batch index, so placement, pools, prefetch, caches,
re-issues and weight evolution never change a record); an α-retuned
campaign must reproduce the same ``CampaignController`` at ``n_nodes=1``
(the α trajectory is a pure function of the batch-keyed probe signal,
absorbed in batch-key order, hence node-count independent).

Eight shipped scenarios (``SCENARIOS``):

- ``crash_storm``          two of four real worker processes hard-crash
                           mid-campaign (heartbeat liveness + re-issue)
- ``wedged_straggler_flap`` a worker mutes, its work re-issues, it
                           heartbeats back while still owing late
                           results (the recovery-window bound)
- ``bursty_arrivals``      highly uneven per-node queues via a replayed
                           throughput trace (weighted sharding)
- ``bimodal_retune``       easy/hard-scan bimodal corpus under online α
                           retuning (quality probe + bounds)
- ``cold_warm_shared_store`` 4-process fleet shares one disk store cold,
                           then a fresh fleet replays it warm
- ``slowdown_skew``        pathological per-node speed skew + injected
                           stragglers on the local simulated runtime
- ``elastic_join_leave``   cross-machine fabric runtime over loopback
                           TCP: one worker joins mid-campaign, one
                           hard-crashes (its connection drops and its
                           work re-issues), one dialer is rejected at
                           admission for a fingerprint mismatch — the
                           record set must still match single-node
                           byte-for-byte
- ``shm_crash_reissue``    4-worker fleet over the zero-copy shared-
                           memory transport: a crash mid-campaign plus
                           a muted straggler force re-issues and late
                           duplicate replies through generation-tagged
                           arena slots

``serve.py --scenario NAME`` reproduces any one from the CLI;
``tests/test_torch_scenarios.py`` runs the fast subset and one process
scenario on the CPU against the JAX package's scenario lab, and
``chip_smoke.py`` runs all eight on the card.

This is the JAX package's scenario lab (``repro.core.scenarios``) with
its specs unchanged, on a torch device: ``run_scenario(spec,
device=...)`` builds the router, the single-node reference engine and
every fleet (each worker's engine too) on ``device`` (cuda unless
"cpu"). One addition: a scenario whose fabric schedule launches a
joiner reports the documents its joiners served
(``ScenarioResult.joiner_docs``), and fails (``JoinNotExercised``) when
they served none, so an elastic scenario never passes without its join.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import backends as B
from repro_torch.core import obs
from repro_torch.core.campaign import (CampaignController, CampaignExecutor,
                                 ControllerConfig, ExecutorConfig,
                                 FaultInjection)
from repro_torch.core.engine import AdaParseEngine, EngineConfig
from repro_torch.core.fabric import FabricElastic
from repro_torch.core.quality import QualityProbeConfig
from repro_torch.data.synthetic import CorpusConfig, generate_corpus


class ScenarioMismatch(AssertionError):
    """The fleet's record set diverged from the single-node reference —
    the determinism invariant every scenario asserts."""


class JoinNotExercised(AssertionError):
    """An elastic scenario's scheduled joiners served no batch: the
    campaign ended (or its last round was sharded) before any joined,
    so the scenario would say nothing about a mid-campaign join."""


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named stress scenario, fully declarative: everything the
    runner needs to build the fleet, schedule its faults, and pick the
    correct single-node reference."""

    name: str
    description: str
    # -- corpus (first half trains the router, second half is parsed) --
    n_docs: int = 150
    corpus_seed: int = 0
    # easiest+hardest thirds of the test split (difficulty-sorted):
    # the easy/hard-scan bimodal quality spread the α retuner reacts to
    bimodal: bool = False
    # -- engine --
    alpha: float = 0.1
    batch_size: int = 16
    # -- fleet topology --
    runtime: str = "local"            # "local" | "process" | "fabric"
    n_nodes: int = 2
    node_pools: tuple[str, ...] | None = None
    prefetch_depth: int = 0
    # local-runtime simulation knobs
    node_speed_factors: tuple[float, ...] | None = None
    straggler_rate: float = 0.0
    straggler_slowdown: float = 4.0
    deadline_factor: float = 2.5
    # -- process-runtime liveness + fault schedule --
    fault: FaultInjection | None = None
    heartbeat_timeout_s: float = 30.0
    heartbeat_interval_s: float = 0.5
    straggler_grace_s: float = 2.0
    # batch-payload transport for the process runtime ("shm" | "pickle");
    # ignored by the local simulated runtime
    transport: str = "shm"
    # fabric-runtime elastic membership schedule (core/fabric
    # .FabricElastic: deferred joiners + rejected mismatched dialers)
    fabric: object | None = None
    # -- adaptive controller (rounds == 0: one-shot executor) --
    rounds: int = 0
    # per-round per-ingest-node docs/s traces (bare PR-3 lists): pins
    # the weight trajectory -> deterministic uneven per-node queues
    arrival_skew: tuple[tuple[float, ...], ...] | None = None
    # online α retuning (None = fixed campaign α)
    alpha_bounds: tuple[float, float] | None = None
    alpha_step: float = 0.05
    quality_target: float = 0.45
    quality_ewma: float = 0.5
    probe_rate: float = 0.0
    # -- shared disk store --
    disk_cache: bool = False
    cache_max_bytes: int | None = None
    # second fresh-store fleet run over the same dir; must replay the
    # cold run entirely (zero misses)
    warm_replay: bool = False


@dataclasses.dataclass
class ScenarioResult:
    """Per-scenario counters recorded into BENCH_scenarios.json. A
    result is only ever constructed after the determinism invariant
    held (``run_scenario`` raises ``ScenarioMismatch`` otherwise)."""

    name: str
    runtime: str
    n_nodes: int
    n_docs: int
    records_match: bool               # asserted True; recorded for the
    wall_s: float                     # bench artifact's per-scenario keys
    goodput_docs_per_s: float
    reissued: int
    reissued_reparse: int
    duplicates_dropped: int
    cache_hits: int
    cache_misses: int
    rounds: int = 0
    alpha_trajectory: list[float] = dataclasses.field(default_factory=list)
    warm_cache_hits: int = 0
    warm_cache_misses: int = 0
    # documents the fabric schedule's joiners served (None: the
    # scenario schedules no join); never 0 in a returned result
    joiner_docs: int | None = None

    def metrics(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Shared scenario context (corpus + trained router), cached per shape
# ---------------------------------------------------------------------------

_CTX_CACHE: dict = {}


def scenario_context(spec: ScenarioSpec, device=None):
    """(corpus_cfg, test_docs, router) for ``spec`` — the corpus and the
    FT router (its features taken on ``device``) are cached per
    (n_docs, seed, bimodal, device) so a sweep over the registry pays
    corpus generation and router training once."""
    dev = str(device_lib.resolve(device))
    key = (spec.n_docs, spec.corpus_seed, spec.bimodal, dev)
    hit = _CTX_CACHE.get(key)
    if hit is not None:
        return hit
    base = _CTX_CACHE.get((spec.n_docs, spec.corpus_seed, False, dev))
    if base is None:
        from repro_torch.launch.serve import build_ft_router  # lazy: no cycle
        ccfg = CorpusConfig(n_docs=spec.n_docs, seed=spec.corpus_seed)
        docs = generate_corpus(ccfg)
        train, test = docs[:spec.n_docs // 2], docs[spec.n_docs // 2:]
        router = build_ft_router(train, ccfg, np.random.RandomState(1),
                                 device=dev)
        base = (ccfg, test, router)
        _CTX_CACHE[(spec.n_docs, spec.corpus_seed, False, dev)] = base
    if not spec.bimodal:
        return base
    ccfg, test, router = base
    pool = sorted(test, key=lambda d: d.difficulty)
    seg = max(len(pool) // 3, 1)
    ctx = (ccfg, pool[:seg] + pool[-seg:], router)
    _CTX_CACHE[key] = ctx
    return ctx


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _controller_cfg(spec: ScenarioSpec, *, trace) -> ControllerConfig:
    return ControllerConfig(
        rounds=spec.rounds, telemetry_trace=trace,
        alpha_bounds=spec.alpha_bounds, alpha_step=spec.alpha_step,
        quality_target=spec.quality_target,
        quality_ewma=spec.quality_ewma,
        probe=(QualityProbeConfig(probe_rate=spec.probe_rate, max_len=192)
               if spec.probe_rate > 0 else None))


def _reference_records(spec: ScenarioSpec, ccfg, test, router,
                       ecfg: EngineConfig, device=None) -> dict:
    """The single-node in-process record set the fleet must reproduce
    byte-for-byte. Fixed-α scenarios reference a plain engine run;
    α-retuned scenarios reference the same controller at n_nodes=1
    (the α trajectory is node-count independent, a plain run is not a
    valid reference once α moves between rounds)."""
    if spec.alpha_bounds is None:
        return AdaParseEngine(ecfg, router, ccfg, device=device).run(test)
    ref = CampaignController(
        ecfg, ExecutorConfig(n_nodes=1, straggler_rate=0.0),
        _controller_cfg(spec, trace=None), router, ccfg,
        device=device).run(test)
    return ref.records


def _assert_records_match(name: str, reference: dict, got: dict) -> None:
    if set(reference) != set(got):
        raise ScenarioMismatch(
            f"scenario {name}: fleet produced doc ids "
            f"{sorted(set(got) ^ set(reference))[:8]}... differing from "
            f"the single-node reference")
    for i, ref in reference.items():
        rec = got[i]
        same = (rec.parser == ref.parser and rec.cost_s == ref.cost_s
                and len(rec.pages) == len(ref.pages)
                and all(np.array_equal(a, b)
                        for a, b in zip(rec.pages, ref.pages)))
        if not same:
            raise ScenarioMismatch(
                f"scenario {name}: record for doc {i} diverged from the "
                f"single-node reference (parser {rec.parser!r} vs "
                f"{ref.parser!r})")


def _write_scenario_trace(spec: ScenarioSpec, res, t_run0: float,
                          trace_dir: str) -> None:
    """Emit the fleet run's observability artifacts: the span log +
    Chrome trace (with one enclosing ``scenario`` annotation span on
    the coordinator lane) and the folded fleet-wide metrics as
    Prometheus text."""
    spans = list(getattr(res, "spans", None) or [])
    spans.append(obs.Span(
        "scenario", spec.name, -1, os.getpid(), t_run0,
        time.time() - t_run0,
        detail=f"{spec.runtime} runtime x{spec.n_nodes}: "
               f"{spec.description}"))
    spans.sort(key=lambda s: s.start)
    obs.TraceWriter(trace_dir).write(spans)
    folded = getattr(res, "obs_metrics", None) or obs.fold([])
    with open(os.path.join(trace_dir, "metrics.prom"), "w") as f:
        f.write(obs.prometheus_text(folded))


def _joiner_docs(spec: ScenarioSpec, res) -> int | None:
    """Documents served by the nodes the fabric schedule launches late
    (None when it schedules none)."""
    joiners = [w for w, _ in getattr(spec.fabric, "join_after", ()) or ()]
    if not joiners:
        return None
    return sum(res.node_stats[w].n_docs for w in joiners
               if w < len(res.node_stats))


def run_scenario(spec: ScenarioSpec,
                 cache_dir: str | None = None,
                 trace_dir: str | None = None,
                 device=None) -> ScenarioResult:
    """Execute ``spec``, assert the byte-identical-records invariant
    against its single-node reference, and return the scenario's
    counters. ``cache_dir`` overrides where a disk-cache scenario puts
    its shared store (default: a fresh temp dir). ``trace_dir`` turns
    the observability plane on for the fleet run and writes the span
    log, Chrome trace, and folded Prometheus metrics there — the whole
    scenario is wrapped in one ``scenario`` annotation span so retune
    timelines (e.g. ``bimodal_retune``) show the α-moving ``round``
    spans inline. ``device``: where the router's features, the
    reference engine and every node's engine run (cuda unless "cpu";
    a process or fabric worker builds its engine there too)."""
    device = device_lib.resolve(device)
    ccfg, test, router = scenario_context(spec, device)
    ecfg = EngineConfig(alpha=spec.alpha, batch_size=spec.batch_size)
    reference = _reference_records(spec, ccfg, test, router, ecfg,
                                   device)
    xcfg = ExecutorConfig(
        obs=trace_dir is not None,
        n_nodes=spec.n_nodes, runtime=spec.runtime,
        node_pools=(list(spec.node_pools)
                    if spec.node_pools is not None else None),
        prefetch_depth=spec.prefetch_depth,
        node_speed_factors=(list(spec.node_speed_factors)
                            if spec.node_speed_factors is not None
                            else None),
        straggler_rate=spec.straggler_rate,
        straggler_slowdown=spec.straggler_slowdown,
        deadline_factor=spec.deadline_factor,
        fault_injection=spec.fault,
        heartbeat_timeout_s=spec.heartbeat_timeout_s,
        heartbeat_interval_s=spec.heartbeat_interval_s,
        straggler_grace_s=spec.straggler_grace_s,
        transport=spec.transport,
        fabric=spec.fabric)

    tmp = None
    store = None
    if spec.disk_cache:
        if cache_dir is None:
            tmp = tempfile.TemporaryDirectory(prefix="adaparse-scn-")
            cache_dir = tmp.name
        store = B.DiskResultStore(cache_dir,
                                  max_bytes=spec.cache_max_bytes)
    try:
        t_run0 = time.time()
        if spec.rounds > 0:
            trace = ([list(t) for t in spec.arrival_skew]
                     if spec.arrival_skew is not None else None)
            res = CampaignController(
                ecfg, xcfg, _controller_cfg(spec, trace=trace), router,
                ccfg, device=device).run(test, cache=store)
        else:
            res = CampaignExecutor(ecfg, xcfg, router, ccfg,
                                   device=device).run(test, cache=store)
        _assert_records_match(spec.name, reference, res.records)
        if trace_dir is not None:
            # before the join check: a run whose joiner served nothing
            # is the one whose timeline is wanted
            _write_scenario_trace(spec, res, t_run0, trace_dir)
        joiner_docs = _joiner_docs(spec, res)
        if joiner_docs == 0:
            raise JoinNotExercised(
                f"scenario {spec.name}: the join was not exercised — the "
                f"scheduled joiners {[w for w, _ in spec.fabric.join_after]}"
                f" served no batch before the campaign ended")

        warm_hits = warm_misses = 0
        if spec.warm_replay:
            # a FRESH store handle over the same dir: the warm fleet
            # must replay everything the cold fleet's workers stored
            # (the multi-process-safe WAL contract)
            warm_store = B.DiskResultStore(cache_dir,
                                           max_bytes=spec.cache_max_bytes)
            warm = CampaignExecutor(
                ecfg, ExecutorConfig(n_nodes=2, straggler_rate=0.0),
                router, ccfg, device=device).run(test, cache=warm_store)
            _assert_records_match(spec.name + ":warm", reference,
                                  warm.records)
            warm_hits, warm_misses = warm.cache_hits, warm.cache_misses
            if warm_misses:
                raise ScenarioMismatch(
                    f"scenario {spec.name}: warm replay re-parsed "
                    f"{warm_misses} batches the cold fleet already "
                    f"stored")
        return ScenarioResult(
            name=spec.name, runtime=spec.runtime, n_nodes=spec.n_nodes,
            n_docs=len(test), records_match=True, wall_s=res.wall_s,
            goodput_docs_per_s=res.docs_per_s, reissued=res.reissued,
            reissued_reparse=res.reissued_reparse,
            duplicates_dropped=res.duplicates_dropped,
            cache_hits=res.cache_hits, cache_misses=res.cache_misses,
            rounds=getattr(res, "rounds", 0),
            alpha_trajectory=[t.alpha for t in
                              getattr(res, "telemetry", [])],
            warm_cache_hits=warm_hits, warm_cache_misses=warm_misses,
            joiner_docs=joiner_docs)
    finally:
        if tmp is not None:
            tmp.cleanup()


# ---------------------------------------------------------------------------
# The shipped scenario registry
# ---------------------------------------------------------------------------

_SPECS = (
    ScenarioSpec(
        name="crash_storm",
        description="two of four worker processes hard-crash "
                    "mid-campaign; heartbeat liveness re-issues their "
                    "work to the survivors",
        runtime="process", n_nodes=4, batch_size=8, prefetch_depth=1,
        heartbeat_timeout_s=5.0, heartbeat_interval_s=0.1,
        fault=FaultInjection(crash_after=((1, 1), (2, 0)))),
    ScenarioSpec(
        name="wedged_straggler_flap",
        description="a worker stops heartbeating but keeps working, "
                    "its batches re-issue, then it heartbeats back "
                    "while still owing late results (mute + recover "
                    "+ race)",
        runtime="process", n_nodes=2, prefetch_depth=2,
        heartbeat_timeout_s=0.5, heartbeat_interval_s=0.1,
        straggler_grace_s=2.5,
        fault=FaultInjection(mute_after=((1, 0),),
                             unmute_after=((1, 2),),
                             mute_slowdown_s=0.9)),
    ScenarioSpec(
        name="bursty_arrivals",
        description="highly uneven per-node queues: a replayed "
                    "throughput trace drives the weighted sharding to "
                    "pile work onto alternating nodes",
        runtime="local", n_nodes=4, batch_size=8, rounds=2,
        arrival_skew=((8.0, 1.0, 1.0, 0.25), (0.25, 1.0, 1.0, 8.0))),
    ScenarioSpec(
        name="bimodal_retune",
        description="easy/hard-scan bimodal corpus under online alpha "
                    "retuning (full-rate quality probe, operator "
                    "bounds)",
        runtime="local", n_nodes=2, batch_size=8, bimodal=True,
        rounds=3, alpha_bounds=(0.05, 0.9), alpha_step=0.3,
        quality_target=0.5, quality_ewma=1.0, probe_rate=1.0),
    ScenarioSpec(
        name="cold_warm_shared_store",
        description="a 4-process fleet (3 cpu + 1 gpu pool) shares one "
                    "disk store cold, then a fresh fleet over the same "
                    "dir replays it warm with zero misses",
        runtime="process", n_nodes=4,
        node_pools=("cpu", "cpu", "cpu", "gpu"), prefetch_depth=2,
        disk_cache=True, warm_replay=True),
    ScenarioSpec(
        name="shm_crash_reissue",
        description="4-worker fleet over the zero-copy shared-memory "
                    "transport: one worker hard-crashes mid-campaign "
                    "and another mutes then flaps back, so re-issued "
                    "tasks and late duplicate replies all travel "
                    "through generation-tagged arena slots; the record "
                    "set must still match single-node byte-for-byte",
        runtime="process", n_nodes=4, batch_size=8, prefetch_depth=2,
        transport="shm",
        heartbeat_timeout_s=2.0, heartbeat_interval_s=0.1,
        straggler_grace_s=2.5,
        fault=FaultInjection(crash_after=((2, 1),),
                             mute_after=((1, 0),),
                             unmute_after=((1, 2),),
                             mute_slowdown_s=0.9)),
    ScenarioSpec(
        name="elastic_join_leave",
        description="elastic fabric fleet over loopback TCP: slot 2 "
                    "joins after 4 batches, worker 1 hard-crashes "
                    "after 3 (its dropped connection re-issues its "
                    "in-flight + queued batches), and one extra "
                    "dialer is rejected at admission for a spec-"
                    "fingerprint mismatch; the adaptive controller "
                    "re-shards over the live fleet at every round "
                    "boundary and the record set must match single-"
                    "node byte-for-byte",
        runtime="fabric", n_nodes=3, batch_size=8, prefetch_depth=1,
        rounds=3,
        heartbeat_timeout_s=5.0, heartbeat_interval_s=0.1,
        fault=FaultInjection(crash_after=((1, 3),)),
        fabric=FabricElastic(join_after=((2, 4),), reject=1)),
    ScenarioSpec(
        name="slowdown_skew",
        description="pathological per-node speed skew (one node 6x "
                    "slower) plus injected stragglers on the local "
                    "simulated runtime",
        runtime="local", n_nodes=4, batch_size=8,
        node_speed_factors=(1.0, 1.0, 1.0, 6.0),
        straggler_rate=0.5, straggler_slowdown=8.0),
)

SCENARIOS: dict[str, ScenarioSpec] = {s.name: s for s in _SPECS}

#: Scenarios cheap enough for tier-1 (no process spawns): the local
#: simulated fleet end-to-end. The process scenarios run in the bench
#: sweep and the CI fast lane.
FAST_SCENARIOS = ("bursty_arrivals", "bimodal_retune", "slowdown_skew")


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(SCENARIOS))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") \
            from None
