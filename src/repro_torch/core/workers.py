"""Worker runtime: the execution layer behind campaign dispatch.

Every campaign path — pooled, prefetched, adaptive, quality-retuned —
dispatches through one ``WorkerPool`` protocol with two
implementations:

- ``LocalWorkerPool`` is the in-process *simulated* fleet (the former
  ``campaign._CampaignRun``): one real ``AdaParseEngine`` per node,
  per-node clocks advanced by the backends' cost models, injected
  stragglers (``ExecutorConfig.straggler_rate``), and
  ``node_speed_factors`` skew. It is the analytic/testing path — fast,
  fully deterministic, and the fleet the 128-node scaling stories run
  on. Its engines all run on the one torch device the campaign was
  given (several simulated nodes share one card and one router); a
  node's pool (``"cpu"``/``"gpu"``) names the simulated backend's
  device, never a torch device.

- ``ProcessWorkerPool`` backs the same dispatch with **real OS worker
  processes** (``multiprocessing`` spawn context; entrypoint
  ``repro_torch.launch.worker_main``). Each worker rebuilds its own
  engine from a serialized ``WorkerSpec`` (``EngineConfig`` + router +
  corpus config + backend registry spec + result-store dir + torch
  device) on its own device, and a small
  message protocol — ``PrepareTask`` / ``CompleteTask`` / ``BatchDone``
  / ``Heartbeat`` dataclasses over multiprocessing queues — carries
  batch work out and ``engine.BatchTelemetry`` back. Straggler
  detection is no longer simulated: workers heartbeat on a fixed
  interval, and a worker that misses ``heartbeat_timeout_s`` (wedged)
  or whose process dies (crashed) has its in-flight batches re-issued
  to the least-loaded eligible peer (``scheduler.reissue_candidates``
  — same pool first, crossing pools only when the backend's device
  allows). First completion wins: late results from a straggler that
  recovers are deduplicated by task id, so a re-issue never duplicates
  an emitted record.

Batch payloads default to the zero-copy shared-memory transport
(``core/shm``): the ``PrepareTask``/``CompleteTask``/``BatchDone``
dataclasses stay control-plane messages, while the numpy-heavy bulk
(documents, forwarded prepared batches, result records) travels through
generation-tagged ``ShmArena`` slots — re-issue-safe (a straggler
reading a reclaimed slot gets a clean stale error, and its late reply
drops at the dedup gate), cleaned up by the coordinator on worker crash
and in ``close()``, and falling back to inline pickled payloads
whenever ``/dev/shm`` is unavailable or a payload outgrows its slot
(``ExecutorConfig.transport="pickle"`` forces the old path).

Devices: a worker runs on ``WorkerSpec.device`` (cuda unless the
campaign was given "cpu"); several workers share one card, each with
its own CUDA context. The coordinator opens none for them: the router
ships as host numpy (``core/specs.portable_router``) and every payload
that crosses a process boundary holds numpy only. Before it spawns
workers on a card, the coordinator builds the kernel library once
(``kernels/cuda_lib.build`` runs ``nvcc`` and touches no card), so N
workers load one library instead of compiling N. A worker asked for
cuda on a host without a card fails the pool's start with its
traceback; nothing falls back to the CPU.

Determinism contract (shared by both pools): batch rng streams are
keyed by the batch's *global* index and carried from prepare into
complete, so an N-process campaign — pooled, prefetched, disk-cached,
crash-recovered, adaptive, or all of the above — produces exactly the
record set of a single-node in-process run over the same corpus.
Telemetry differs (real wall-clock vs simulated node-seconds); records
never do. A shared on-disk ``backends.DiskResultStore`` works across
worker processes (multi-process-safe WAL appends): each worker opens
the store dir itself, and a later single-process warm run replays the
fleet's records byte-identically.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue as queue_lib
import sys
import time
import uuid
from collections import deque
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core import obs
from repro_torch.core import scheduler
from repro_torch.core.engine import (AdaParseEngine, BatchTelemetry,
                                     EngineConfig, EngineStats)
from repro_torch.core.shm import (CoordinatorShmTransport,  # noqa: F401
                                  ShmArena, ShmRef)
from repro_torch.data.pipeline import Prefetcher

TRANSPORTS = ("shm", "pickle")

# ---------------------------------------------------------------------------
# Message protocol (coordinator <-> worker, over multiprocessing queues)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrepareTask:
    """One batch of ingest work: prepare + route on the receiving
    worker. With ``forward`` set and expensive work routed, the worker
    returns the prepared payload (``BatchDone.prep``/``plan``) for the
    coordinator to forward as a ``CompleteTask`` to the re-parse pool;
    otherwise the worker completes locally and returns records.
    ``alpha`` pins the routing budget per task (round-boundary retunes
    and per-node α budgets ride on the task, not on worker state)."""

    task_id: int
    batch_key: int
    docs: list
    alpha: float
    forward: bool = False
    use_cache: bool = True
    payload: ShmRef | None = None    # shm transport: docs ride here
    attempt: int = 0                 # coordinator-side (re-)send count


@dataclasses.dataclass
class CompleteTask:
    """The expensive re-parse of a routed batch, forwarded to a node of
    the pool matching the expensive backend's device. ``prep``/``plan``
    are the ingest worker's ``engine.PreparedBatch`` / ``BatchPlan``
    (the batch's stateless rng stream travels inside ``prep``, so the
    completing worker emits byte-identical records). ``prep`` holds
    host numpy only: the ingest worker moved its routing tensors off
    the card before replying."""

    task_id: int
    batch_key: int
    prep: object
    plan: object
    alpha: float
    payload: ShmRef | None = None    # shm transport: (prep, plan) ride here
    attempt: int = 0                 # coordinator-side (re-)send count


@dataclasses.dataclass
class Heartbeat:
    """Liveness beacon, sent by every worker on a fixed interval (and
    once at startup, the ready signal). ``task_id`` names the batch the
    worker is currently executing, None when idle.

    Beyond liveness the beacon carries load context: ``sent_mono`` is
    the sender's ``time.monotonic()`` — a *same-host-only* diagnostic:
    CLOCK_MONOTONIC is per-machine (an arbitrary epoch each boot), so
    the coordinator compares it against its own monotonic clock only
    when sender and coordinator share a host (the process runtime;
    the cross-machine fabric runtime ignores it). Liveness deadlines
    never touch it — they run on coordinator *receive* time — and
    ``queue_depth`` is the worker's task-queue depth at send time (-1
    when the platform cannot report it) — together they let the
    coordinator distinguish a wedged worker from one that is alive but
    digesting a deep backlog before firing a re-issue. ``spans`` and
    ``metrics`` piggyback the observability plane (a bounded drain of
    the worker's span ring and its cumulative metrics snapshot) — no
    extra queues, None when tracing is disabled."""

    worker: int
    sent_at: float
    task_id: int | None = None
    sent_mono: float = 0.0
    queue_depth: int = -1
    spans: list | None = None
    metrics: dict | None = None


@dataclasses.dataclass
class BatchDone:
    """A worker's reply to one task. Exactly one of three shapes:
    records set (completed batch, ``telemetry`` riding along),
    ``prep``/``plan`` set (ingest stage of a forwarded batch), or
    ``error`` set (the traceback of a worker-side failure). ``wall_s``
    is the real measured stage duration — the process runtime's
    replacement for the simulated clocks."""

    task_id: int
    worker: int
    batch_key: int
    records: list | None = None
    telemetry: BatchTelemetry | None = None
    prep: object | None = None
    plan: object | None = None
    cached: bool = False
    wall_s: float = 0.0
    error: str | None = None
    # shm transport: the bulk reply (records, or the forwarded
    # (prep, plan)) rides in a response-arena slot instead of the queue
    payload: ShmRef | None = None
    payload_kind: str = ""           # "records" | "prep"
    # observability piggyback: which (re-)send this reply answers, a
    # bounded drain of the worker's span ring, and its cumulative
    # metrics snapshot (None when tracing is disabled)
    attempt: int = 0
    spans: list | None = None
    metrics: dict | None = None


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Deterministic fault hooks for the process runtime (tests and
    chaos demos; production campaigns leave this None).

    ``crash_after``: ``((worker, n), ...)`` — the worker hard-exits
    (``os._exit``) on receiving its (n+1)-th task, losing the
    in-flight batch (the crash-recovery path: heartbeats stop, the
    coordinator re-issues to a pool peer).
    ``mute_after``: ``((worker, n), ...)`` — the worker stops
    heartbeating after n completed tasks but keeps working (a
    wedged-looking straggler whose late duplicate results the
    coordinator must drop).
    ``mute_slowdown_s``: extra per-task sleep once muted, so the
    re-issued attempt and the straggler race.
    ``unmute_after``: ``((worker, n), ...)`` — the worker resumes
    heartbeating after n completed tasks; with ``mute_after`` this
    makes the mute window ``[mute_after, unmute_after)`` in completed
    tasks (a flapping straggler: quiet → re-issue → recover → the
    coordinator must re-admit it without overcommitting its in-flight
    window while late results are still owed)."""

    crash_after: tuple = ()
    mute_after: tuple = ()
    mute_slowdown_s: float = 0.0
    unmute_after: tuple = ()


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawned worker needs to rebuild its engine: the
    serialized engine/corpus configs, the router (content-addressed —
    ``engine._router_fingerprint`` reproduces the same cache tag in
    every process), the result-store directory, and a backend registry
    spec (``(module, attr)`` factories re-registered in the child, so
    custom backends flow into worker processes the same way they flow
    through the in-process registry)."""

    worker_id: int
    ecfg: EngineConfig
    router: object                      # core/specs.PortableRouter or ft
    corpus_cfg: object
    # the torch device the worker builds its engine on: several workers
    # share one card. Not part of the fingerprint (records are equal on
    # either device)
    device: str = "cuda"
    image_degraded: bool = False
    text_degraded: bool = False
    alpha: float | None = None          # per-node α override (weighted budgets)
    cache_dir: str | None = None
    cache_max_bytes: int | None = None
    probe_cfg: object | None = None     # quality.QualityProbeConfig
    backend_specs: tuple = ()           # ((module, attr) factory pairs)
    heartbeat_interval_s: float = 0.5
    fault: FaultInjection | None = None
    # zero-copy transport (core/shm): arena namespace + fleet geometry;
    # shm_base None means pickled payloads (transport="pickle")
    shm_base: str | None = None
    n_workers: int = 1
    shm_resp_slots: int = 8
    # fleet-shared persistent autotune store (kernels/tuning_store):
    # every worker configures this dir, so launch-knob sweeps amortize
    # across the fleet and a warm restart performs zero re-sweeps. Not
    # part of the fingerprint (a knob never changes a record)
    tuning_dir: str | None = None
    # observability plane (core/obs): span tracing defaults off (noop
    # recorder); when on, the worker records into a bounded ring and
    # ships drained slices on its outgoing messages
    obs_enabled: bool = False
    obs_span_cap: int = 8192
    # content fingerprint (core/specs.spec_fingerprint) stamped by the
    # coordinator before the spec ships; the receiving worker recomputes
    # it after deserializing and refuses to run on a mismatch (guards
    # serialization drift, and the fabric runtime's admission check
    # compares a dialing worker's fingerprint against the same value)
    fingerprint: dict | None = None


# ---------------------------------------------------------------------------
# WorkerPool protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class WorkerPool(Protocol):
    """What campaign dispatch needs from a fleet, local or real.

    ``drain`` runs per-node work queues to completion (callable
    repeatedly — the controller's rounds); ``clocks`` accumulates
    per-node busy node-seconds (simulated or measured);
    ``node_telemetry`` is the per-node ``BatchTelemetry`` stream the
    adaptive controller reads; ``set_alpha`` applies a round-boundary
    retune to every node."""

    n_nodes: int
    records: dict
    clocks: np.ndarray
    reissued: int
    reissued_reparse: int

    def drain(self, queues: dict[int, list]) -> None: ...

    def node_telemetry(self, node: int) -> list[BatchTelemetry]: ...

    def set_alpha(self, alpha: float) -> None: ...

    def node_stats(self) -> list[EngineStats]: ...

    def snapshot_cache(self, cache) -> tuple[int, int]: ...

    def finalize(self, n_docs: int, cache, hits0: int, miss0: int) -> dict: ...

    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# LocalWorkerPool: the in-process simulated fleet
# ---------------------------------------------------------------------------


class LocalWorkerPool:
    """Simulated in-process fleet (the former ``campaign._CampaignRun``):
    mutable campaign state + the work-conserving dispatch loop, shared
    by the one-shot ``CampaignExecutor`` and the round-based
    ``CampaignController`` (which calls ``drain`` once per round while
    clocks, engines, and straggler statistics persist across rounds).
    Stragglers are injected (``ExecutorConfig.straggler_rate``) and
    node speed skew is simulated (``node_speed_factors``) — clocks and
    telemetry only, never records."""

    def __init__(self, ecfg: EngineConfig, xcfg, engines: list[AdaParseEngine],
                 n_nodes: int, ingest_nodes: list[int],
                 reparse_nodes: list[int], pools: list[str] | None):
        self.ecfg = ecfg
        self.xcfg = xcfg
        self.engines = engines
        self.n_nodes = n_nodes
        self.ingest_nodes = ingest_nodes
        self.reparse_nodes = reparse_nodes
        self.pools = pools
        self.cheap_dev = B.get_backend(ecfg.cheap).info.device
        self.exp_dev = B.get_backend(ecfg.expensive).info.device
        self.clocks = np.zeros(n_nodes, np.float64)
        self.records: dict = {}
        self.reissued = 0
        self.reissued_reparse = 0
        self.mean_batch = 0.0
        self.n_done = 0
        self.rng = np.random.RandomState(xcfg.seed)
        sf = xcfg.node_speed_factors
        if sf is None:
            self.speed = np.ones(n_nodes, np.float64)
        else:
            # sized to the *configured* fleet; a small corpus may clamp
            # the effective node count below it, so slice rather than
            # reject a config that is valid at full scale
            if len(sf) != xcfg.n_nodes:
                raise ValueError(f"need {xcfg.n_nodes} node speed factors "
                                 f"(one per configured node), got "
                                 f"{len(sf)}")
            self.speed = np.asarray(sf[:n_nodes], np.float64)
            if np.any(self.speed <= 0):
                raise ValueError("node speed factors must be positive")

    # -- WorkerPool protocol -------------------------------------------------

    def node_telemetry(self, node: int) -> list[BatchTelemetry]:
        return self.engines[node].telemetry

    def set_alpha(self, alpha: float) -> None:
        for e in self.engines:
            e.set_alpha(alpha)

    def node_stats(self) -> list[EngineStats]:
        return [e.stats for e in self.engines]

    def obs_drain(self) -> tuple[list, list]:
        """The simulated fleet records into this process's recorder and
        registry directly; the executor reads those itself."""
        return [], []

    def close(self) -> None:
        """Nothing to tear down in-process."""

    # -- one batch -----------------------------------------------------------

    def execute(self, node, batch, prep_item=None, use_cache=True,
                force_reparse=None):
        """Full pipeline for one batch: prepare+route on ``node``,
        complete on the reparse pool (or on ``force_reparse``). Returns
        (records, ingest_dur, reparse_dur, reparse_node, cache_hit)
        with durations in *unscaled* node-seconds (speed factors apply
        at clock-advance time). ``use_cache=False`` (straggler
        re-issue) forces a real re-parse: the abandoned attempt has
        already stored this key, and replaying it would model the
        re-issued work as free."""
        eng = self.engines[node]
        if prep_item is None:
            key, prep, cached = eng.prepare_or_lookup(
                batch["docs"], batch_key=batch["batch_key"],
                use_cache=use_cache)
        else:
            key, prep, cached = prep_item
        if cached is not None:
            eng._account_cache_hit(cached, batch["batch_key"])
            return cached, 0.0, 0.0, node, True
        plan = eng.route_batch(prep)
        # forward the re-parse to the matching pool only when there is
        # re-parse work; otherwise finish locally
        if plan.expensive_idx.size == 0:
            g = node
        elif force_reparse is not None:
            g = force_reparse
        elif self.pools is None:
            g = node
        else:
            g = scheduler.least_loaded(self.reparse_nodes, self.clocks)
        geng = self.engines[g]
        ingest_dur = (prep.ingest_cost_s
                      + eng.cfg.router_cost_s * len(prep.docs))
        before = eng.stats.node_seconds + (
            geng.stats.node_seconds if geng is not eng else 0.0)
        recs = geng.complete_batch(prep, plan, node_id=g,
                                   ingest_engine=eng)
        after = eng.stats.node_seconds + (
            geng.stats.node_seconds if geng is not eng else 0.0)
        reparse_dur = (after - before) - ingest_dur
        if key is not None:
            eng.cache.store(key, recs)
        return recs, ingest_dur, reparse_dur, g, False

    def advance(self, node, ing, rep, g):
        """Advance the simulated clocks by one batch's work, scaled by
        the per-node speed factors."""
        self.clocks[node] += ing * self.speed[node]
        if g == node:
            self.clocks[node] += rep * self.speed[node]
        else:
            # the reparse node picks the batch up when both it and
            # the ingest hand-off are ready
            self.clocks[g] = (max(self.clocks[g], self.clocks[node])
                              + rep * self.speed[g])

    def _wall(self, node, ing, rep, g) -> float:
        """Wall-clock cost of one batch under the speed factors."""
        return float(ing * self.speed[node] + rep * self.speed[g])

    # -- dispatch loop -------------------------------------------------------

    def drain(self, queues: dict[int, list]) -> None:
        """Run every batch in ``queues`` (node -> work list) to
        completion, with prefetch overlap and pool-aware straggler
        re-issue. May be called repeatedly (the controller's rounds)."""
        xcfg = self.xcfg
        heads = {node: 0 for node in queues}

        def _make_prep(eng):
            return lambda batch: eng.prepare_or_lookup(
                batch["docs"], batch_key=batch["batch_key"])

        streams = {}
        if xcfg.prefetch_depth > 0:
            streams = {
                node: Prefetcher(iter(queues[node]),
                                 depth=xcfg.prefetch_depth,
                                 transform=_make_prep(self.engines[node]))
                for node in queues}

        try:
            while True:
                # work-conserving dispatch: fastest node with work goes next
                ready = [i for i in queues if heads[i] < len(queues[i])]
                if not ready:
                    break
                node = scheduler.least_loaded(ready, self.clocks)
                batch = queues[node][heads[node]]
                heads[node] += 1
                prep_item = (next(streams[node]) if node in streams
                             else None)
                recs, ing, rep, g, hit = self.execute(node, batch,
                                                      prep_item)
                if hit:
                    # replays cost nothing and cannot straggle; keep
                    # their zero duration out of the mean_batch deadline
                    # baseline (a partially warm run would otherwise
                    # collapse the deadline and re-issue real batches
                    # spuriously)
                    for r in recs:
                        self.records[r.doc_id] = r
                    rec_ = obs.recorder()
                    if rec_.enabled:
                        rec_.span("complete", batch["batch_key"],
                                  time.time(), 0.0, node=node,
                                  cached=True)
                    continue
                dur = self._wall(node, ing, rep, g)
                if self.rng.rand() < xcfg.straggler_rate and self.n_done:
                    hung = dur * xcfg.straggler_slowdown
                    deadline = xcfg.deadline_factor * self.mean_batch
                    if hung > deadline:
                        recs, dur = self._reissue(node, batch, recs,
                                                  ing, rep, g, hung,
                                                  deadline)
                    else:
                        self.advance(node, ing * xcfg.straggler_slowdown,
                                     rep * xcfg.straggler_slowdown, g)
                        dur = hung
                else:
                    self.advance(node, ing, rep, g)
                for r in recs:
                    self.records[r.doc_id] = r
                rec_ = obs.recorder()
                if rec_.enabled:
                    # one winning complete span per batch; dur is the
                    # simulated wall cost under the speed factors
                    rec_.span("complete", batch["batch_key"],
                              time.time() - dur, dur, node=g)
                self.n_done += 1
                self.mean_batch += (dur - self.mean_batch) / self.n_done
        finally:
            for pf in streams.values():
                pf.close()

    def _reissue(self, node, batch, recs, ing, rep, g, hung, deadline):
        """Past-deadline straggler: re-issue the ACTUAL batch to the
        least-loaded eligible peer (``scheduler.reissue_candidates``:
        same pool first, crossing pools only when the backend's device
        allows); same batch_key -> identical records. Both attempts
        performed real work, so both stay charged in the per-node
        EngineStats. With no eligible peer the hung task just runs to
        completion at the slowdown."""
        xcfg = self.xcfg
        if g != node and rep > 0:
            # the forwarded expensive re-parse hung on the pool node
            peers = scheduler.reissue_candidates(g, self.pools,
                                                 self.exp_dev, self.n_nodes)
            if peers:
                self.reissued += 1
                self.reissued_reparse += 1
                obs.metrics().count("pool.reissued")
                obs.metrics().count("pool.reissued_reparse")
                rec_ = obs.recorder()
                if rec_.enabled:
                    rec_.span("reissue", batch["batch_key"],
                              time.time(), 0.0, node=g, abandoned=True,
                              detail=f"simulated straggler, reparse "
                                     f"stage on node {g}")
                # ingest completed normally; the reparse node abandons
                # the hung attempt at the deadline. The re-run below
                # appends its own telemetry, so the abandoned attempt's
                # docs must not count toward observed throughput
                self.engines[node].telemetry[-1].abandoned = True
                self.clocks[node] += ing * self.speed[node]
                self.clocks[g] = (max(self.clocks[g], self.clocks[node])
                                  + deadline)
                g2 = scheduler.least_loaded(peers, self.clocks)
                recs, ing, rep, g = self.execute(node, batch,
                                                 use_cache=False,
                                                 force_reparse=g2)[:4]
                # the repeated prepare exists only to regenerate the
                # batch's stateless rng stream — the ingest already ran
                # (and was charged) once, so only the re-issued re-parse
                # advances the clocks
                self.clocks[g] = (max(self.clocks[g], self.clocks[node])
                                  + rep * self.speed[g])
                self.engines[g].stats.reissued_tasks += 1
                return recs, self._wall(node, ing, rep, g)
        else:
            peers = scheduler.reissue_candidates(node, self.pools,
                                                 self.cheap_dev,
                                                 self.n_nodes)
            if peers:
                # give up on the hung ingest at the deadline and re-run
                # the whole batch on the fastest eligible peer; the
                # abandoned attempt's docs re-appear in the peer's
                # telemetry, so skip them in throughput measurement
                self.engines[node].telemetry[-1].abandoned = True
                self.reissued += 1
                obs.metrics().count("pool.reissued")
                rec_ = obs.recorder()
                if rec_.enabled:
                    rec_.span("reissue", batch["batch_key"],
                              time.time(), 0.0, node=node,
                              abandoned=True,
                              detail="simulated straggler, full batch")
                self.clocks[node] += deadline
                other = scheduler.least_loaded(peers, self.clocks)
                recs, ing, rep, g = self.execute(other, batch,
                                                 use_cache=False)[:4]
                self.advance(other, ing, rep, g)
                self.engines[other].stats.reissued_tasks += 1
                return recs, self._wall(other, ing, rep, g)
        # no eligible peer: the straggler runs to completion
        self.advance(node, ing * xcfg.straggler_slowdown,
                     rep * xcfg.straggler_slowdown, g)
        return recs, hung

    # -- result assembly -----------------------------------------------------

    def snapshot_cache(self, cache) -> tuple[int, int]:
        return ((cache.hits, cache.misses) if cache is not None
                else (0, 0))

    def finalize(self, n_docs: int, cache, hits0: int,
                 miss0: int) -> dict:
        """Shared ExecutorResult field assembly (flush the store, wall /
        busy from the clocks, cache-delta counters)."""
        if cache is not None:
            cache.flush()       # persist batched LRU bumps (disk store)
        wall = float(self.clocks.max()) if n_docs else 0.0
        busy = (float(self.clocks.sum()) / (self.n_nodes * wall)) \
            if wall else 0.0
        return dict(
            records=self.records,
            wall_s=wall,
            docs_per_s=n_docs / wall if wall else 0.0,
            node_busy_frac=busy,
            reissued=self.reissued,
            node_stats=[e.stats for e in self.engines],
            cache_hits=(cache.hits - hits0) if cache is not None else 0,
            cache_misses=(cache.misses - miss0) if cache is not None
            else 0,
            reissued_reparse=self.reissued_reparse)


# ---------------------------------------------------------------------------
# ProcessWorkerPool: real OS worker processes
# ---------------------------------------------------------------------------


class _TaskState:
    """Coordinator-side record of one batch's lifecycle: which stage it
    is in, which workers currently owe a result for it (more than one
    after a re-issue), and whether it already completed (the dedup
    gate — first completion wins, late duplicates are dropped)."""

    __slots__ = ("task_id", "node", "batch_key", "docs", "alpha",
                 "stage", "prep", "plan", "ingest_worker", "current",
                 "done", "needs_reissue", "prep_ref", "comp_ref",
                 "attempt")

    def __init__(self, task_id, node, batch_key, docs, alpha):
        self.task_id = task_id
        self.node = node                 # ingest node the batch was queued on
        self.batch_key = batch_key
        self.docs = docs
        self.alpha = alpha
        self.attempt = 0                 # sends so far (re-issues bump it)
        self.stage = "prepare"           # "prepare" | "complete"
        self.prep = None                 # kept for complete-stage re-issue
        self.plan = None
        self.ingest_worker = None        # worker that ran the ingest stage
        self.current: set[int] = set()   # workers owing a result
        self.done = False
        # stalled with its previous attempt lost: the next dispatch is
        # a (deferred) re-issue and must be counted as one
        self.needs_reissue = False
        # shm task-arena slots: packed once per stage, shared by every
        # (re-)issue of that stage, reclaimed when the task completes
        self.prep_ref = None
        self.comp_ref = None


class ProcessWorkerPool:
    """Real worker processes behind campaign dispatch.

    One spawned process per node (``repro_torch.launch.worker_main``), one
    task queue per worker (the coordinator targets placement), one
    shared result queue back. ``drain`` keeps up to
    ``1 + prefetch_depth`` tasks in flight per worker — the process
    runtime's prefetch overlap: the worker's host prepare of a queued
    batch overlaps the coordinator round-trip of the previous one.

    Straggler detection runs on real heartbeat deadlines: a worker that
    misses ``heartbeat_timeout_s`` (wedged) or whose process dies
    (crashed) has its in-flight batches re-issued to the least-loaded
    eligible peer (``scheduler.reissue_candidates`` — same pool first,
    crossing pools only when the backend's device allows). A dead
    worker's queued-but-unstarted work re-routes the same way. First
    completion wins; a recovered straggler's late duplicates are
    dropped (``duplicates_dropped``), so re-issue never duplicates an
    emitted record.

    ``clocks`` accumulate *measured* per-batch wall seconds per worker
    — the controller's throughput EWMA therefore adapts to real node
    speed, not a simulated skew. Records stay placement-independent
    (stateless batch keys), so however batches land, re-issue, or
    replay from a shared ``DiskResultStore``, the record set equals the
    single-node in-process run byte-for-byte."""

    _POLL_S = 0.05
    #: a drain with work open that hears no ``BatchDone`` and sends no
    #: task for this long raises instead of waiting on (a worker whose
    #: heartbeat thread beats while its engine never returns is never
    #: quieted, so no re-issue ends the wait). The port's own limit:
    #: the reference's drain waits without one.
    DRAIN_STALL_S = 600.0
    #: heartbeat ``sent_mono`` stamps are comparable with the
    #: coordinator's monotonic clock only when every worker shares its
    #: host (true for spawned processes; the cross-machine fabric
    #: subclass sets this False). Liveness deadlines never depend on it
    #: — they run on coordinator *receive* time (``_beat``) — it only
    #: gates the same-host queue-delay diagnostic (``_hb_delay``).
    _mono_comparable = True

    @staticmethod
    def _validate_xcfg(xcfg) -> None:
        if xcfg.node_speed_factors is not None:
            raise ValueError(
                "node_speed_factors are simulation-only (they skew the "
                "simulated clocks); the process runtime measures real "
                "node speed — drop them or use runtime='local'")
        if xcfg.heartbeat_timeout_s <= 0:
            raise ValueError(f"heartbeat_timeout_s must be > 0, got "
                             f"{xcfg.heartbeat_timeout_s}")
        if not 0 < xcfg.heartbeat_interval_s < xcfg.heartbeat_timeout_s:
            raise ValueError(
                f"heartbeat_interval_s must be in (0, heartbeat_timeout_s="
                f"{xcfg.heartbeat_timeout_s}), got "
                f"{xcfg.heartbeat_interval_s}")

    @staticmethod
    def _cache_cfg(cache) -> tuple[str | None, int | None]:
        if cache is None:
            return None, None
        if not isinstance(cache, B.DiskResultStore):
            raise ValueError(
                "an in-memory result store cannot be shared across "
                "worker processes; pass a DiskResultStore "
                "(serve.py --cache-dir) or use runtime='local'")
        return cache.dir, cache.max_bytes

    def __init__(self, ecfg: EngineConfig, xcfg, router, corpus_cfg,
                 n_nodes: int, ingest_nodes: list[int],
                 reparse_nodes: list[int], pools: list[str] | None, *,
                 alpha_of: dict[int, float] | None = None, cache=None,
                 probe_cfg=None, image_degraded=False, text_degraded=False,
                 backend_specs: tuple = (), device=None):
        self._validate_xcfg(xcfg)
        transport = getattr(xcfg, "transport", "shm")
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; choose "
                             f"'shm' (zero-copy shared-memory payloads) "
                             f"or 'pickle' (queue-serialized payloads)")
        cache_dir, cache_max = self._cache_cfg(cache)
        self._init_state(ecfg, xcfg, n_nodes, ingest_nodes,
                         reparse_nodes, pools, alpha_of,
                         has_cache=cache_dir is not None, device=device)

        resp_slots = self._window + 4
        self._shm: CoordinatorShmTransport | None = None
        shm_base = None
        if transport == "shm":
            shm_base = f"adaparse-{os.getpid():x}-{uuid.uuid4().hex[:8]}"
            self._shm = CoordinatorShmTransport(
                shm_base, n_nodes,
                n_task_slots=2 * n_nodes * self._window + 8,
                n_resp_slots=resp_slots)

        from repro_torch.launch.worker_main import worker_loop

        _prebuild_kernels(self.device)
        router = _portable_router(router)
        ctx = mp.get_context("spawn")
        self.result_q = ctx.Queue()
        self.task_qs = [ctx.Queue() for _ in range(n_nodes)]
        fault = getattr(xcfg, "fault_injection", None)
        fp = None
        self.procs = []
        for i in range(n_nodes):
            spec = self._worker_spec(
                i, router=router, corpus_cfg=corpus_cfg,
                cache_dir=cache_dir, cache_max=cache_max,
                probe_cfg=probe_cfg, image_degraded=image_degraded,
                text_degraded=text_degraded,
                backend_specs=tuple(backend_specs), fault=fault,
                shm_base=shm_base, resp_slots=resp_slots)
            if fp is None:
                # one fingerprint for the fleet (router fingerprint is
                # memoized, so this hashes once); the worker recomputes
                # and verifies it after deserializing
                from repro_torch.core.specs import spec_fingerprint
                fp = spec_fingerprint(spec)
            spec = dataclasses.replace(spec, fingerprint=fp)
            # the spec rides the worker's task queue, not the process
            # arguments: spawn writes the arguments into a pipe that the
            # child drains only once it has booted, so a large router
            # (the full-width encoder is ~440 MB of numpy) would start
            # the workers one after another; queued, they boot at once
            p = ctx.Process(target=worker_loop,
                            args=(self.task_qs[i], self.result_q),
                            daemon=True, name=f"adaparse-worker-{i}")
            p.start()
            self.task_qs[i].put(spec)
            self.procs.append(p)
        self._beat = [time.time()] * n_nodes
        self._await_ready()

    def _init_state(self, ecfg: EngineConfig, xcfg, n_nodes: int,
                    ingest_nodes: list[int], reparse_nodes: list[int],
                    pools: list[str] | None,
                    alpha_of: dict[int, float] | None, *,
                    has_cache: bool, device=None) -> None:
        """Coordinator bookkeeping shared by every transport subclass
        (the fabric pool re-uses all of it over sockets): dispatch
        topology, the dedup/liveness/window state, counters. ``device``
        is the workers' torch device (cuda unless "cpu"); it is named
        here and resolved in each worker, never in the coordinator."""
        self.device = str(torch.device("cuda" if device is None
                                       else device))
        self.ecfg = ecfg
        self.xcfg = xcfg
        self.n_nodes = n_nodes
        self.ingest_nodes = ingest_nodes
        self.reparse_nodes = reparse_nodes
        self.pools = pools
        self.cheap_dev = B.get_backend(ecfg.cheap).info.device
        self.exp_dev = B.get_backend(ecfg.expensive).info.device
        self.alpha = ecfg.alpha
        self._alpha_of = dict(alpha_of or {})
        self._window = 1 + max(getattr(xcfg, "prefetch_depth", 0), 0)

        self.records: dict = {}
        self.clocks = np.zeros(n_nodes, np.float64)
        self.telemetry: list[list[BatchTelemetry]] = [[] for _ in
                                                      range(n_nodes)]
        self.reissued = 0
        self.reissued_reparse = 0
        self.duplicates_dropped = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # batch payloads by carrier, both directions: a shm arena slot,
        # or inline in the control message (the pickle transport, the
        # fabric, and every shm fallback)
        self.payloads_shm = 0
        self.payloads_inline = 0
        self._has_cache = has_cache
        self._wall_s = 0.0
        self._progress_t = time.time()   # last BatchDone heard, task sent
        self._tasks: dict[int, _TaskState] = {}
        self._open: set[int] = set()     # not-yet-done task ids
        # (task_id, worker) results a live straggler still owes after a
        # re-issue won the race — drain lingers briefly for them so the
        # dedup counter is observable, then abandons them
        self._late: set[tuple[int, int]] = set()
        self._load = [0] * n_nodes       # open assignments per worker
        self._dead: set[int] = set()
        self._quiet: set[int] = set()    # missed-heartbeat workers
        # tasks with no live eligible worker *right now* (every
        # candidate is quiet, not dead) — retried each loop tick until
        # a straggler heartbeats back in
        self._stalled: set[int] = set()
        self._next_task_id = 0
        self._n_expensive = [0] * n_nodes
        self._reissued_tasks = [0] * n_nodes
        # observability plane: spans/snapshots absorbed from piggyback
        # fields on incoming messages, plus per-worker heartbeat load
        # context (last reported task-queue depth + in-flight task) so
        # liveness policing can tell backlog from wedge
        self.obs_spans: list = []
        self._obs_snaps: dict[int, dict] = {}
        self._hb_depth = [-1] * n_nodes
        self._hb_task: list[int | None] = [None] * n_nodes
        self._hb_delay = [0.0] * n_nodes
        # live status line (serve.py --status-interval)
        self._status_every = max(
            getattr(xcfg, "status_interval_s", 0.0) or 0.0, 0.0)
        self._status_next = 0.0
        self._total_batches = 0
        self._batches_done = 0
        self._docs_done = 0

    def _worker_spec(self, i: int, *, router, corpus_cfg, cache_dir,
                     cache_max, probe_cfg, image_degraded, text_degraded,
                     backend_specs: tuple, fault,
                     shm_base: str | None, resp_slots: int) -> WorkerSpec:
        """The serialized spec worker ``i`` rebuilds its engine from —
        shared verbatim by the spawn transport (shm payloads) and the
        fabric transport (``shm_base=None``, inline payloads)."""
        return WorkerSpec(
            worker_id=i, ecfg=self.ecfg, router=router,
            corpus_cfg=corpus_cfg, device=self.device,
            image_degraded=image_degraded,
            text_degraded=text_degraded,
            alpha=self._alpha_of.get(i), cache_dir=cache_dir,
            cache_max_bytes=cache_max,
            tuning_dir=getattr(self.xcfg, "tuning_dir", None),
            probe_cfg=probe_cfg,
            backend_specs=tuple(backend_specs),
            heartbeat_interval_s=self.xcfg.heartbeat_interval_s,
            fault=fault, shm_base=shm_base, n_workers=self.n_nodes,
            shm_resp_slots=resp_slots,
            obs_enabled=getattr(self.xcfg, "obs", False),
            obs_span_cap=getattr(self.xcfg, "obs_span_cap", 8192))

    # -- startup -------------------------------------------------------------

    def _await_ready(self) -> None:
        """Block until every worker has built its engine and sent the
        ready heartbeat (spawn + imports dominate; a worker that fails
        to build reports its traceback instead of hanging the pool)."""
        ready: set[int] = set()
        deadline = time.time() + self.xcfg.worker_start_timeout_s
        while len(ready) < self.n_nodes:
            timeout = deadline - time.time()
            if timeout <= 0:
                missing = sorted(set(range(self.n_nodes)) - ready)
                self.close()
                raise RuntimeError(
                    f"workers {missing} not ready within "
                    f"{self.xcfg.worker_start_timeout_s}s "
                    f"(worker_start_timeout_s)")
            try:
                msg = self.result_q.get(timeout=min(timeout, 1.0))
            except queue_lib.Empty:
                continue
            if isinstance(msg, BatchDone) and msg.error is not None:
                self.close()
                raise RuntimeError(f"worker {msg.worker} failed to "
                                   f"start:\n{msg.error}")
            if isinstance(msg, Heartbeat):
                ready.add(msg.worker)
                self._beat[msg.worker] = time.time()

    # -- WorkerPool protocol -------------------------------------------------

    def node_telemetry(self, node: int) -> list[BatchTelemetry]:
        return self.telemetry[node]

    def set_alpha(self, alpha: float) -> None:
        """Round-boundary retune: subsequent tasks carry the new α (the
        workers' engines follow per task, invalidating their route
        steps and cache tags exactly like the local path)."""
        self.alpha = alpha
        self._alpha_of = {}

    def node_stats(self) -> list[EngineStats]:
        """Per-node stats reconstructed from the coordinator's view:
        docs/expensive counts from the ingest telemetry, busy seconds
        from the measured clocks."""
        stats = []
        for i in range(self.n_nodes):
            st = EngineStats(node_seconds=float(self.clocks[i]))
            for t in self.telemetry[i]:
                st.n_docs += t.n_docs
                if t.cached:
                    st.cache_hits += 1
            st.n_expensive = self._n_expensive[i]
            st.reissued_tasks = self._reissued_tasks[i]
            stats.append(st)
        return stats

    def snapshot_cache(self, cache) -> tuple[int, int]:
        """Worker-side stores count hits/misses through BatchDone, not
        through the coordinator's store object."""
        return (0, 0)

    def finalize(self, n_docs: int, cache, hits0: int, miss0: int) -> dict:
        if cache is not None:
            cache.flush()
        wall = self._wall_s if n_docs else 0.0
        busy = (float(self.clocks.sum()) / (self.n_nodes * wall)) \
            if wall else 0.0
        return dict(
            records=self.records,
            wall_s=wall,
            docs_per_s=n_docs / wall if wall else 0.0,
            node_busy_frac=busy,
            reissued=self.reissued,
            node_stats=self.node_stats(),
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            reissued_reparse=self.reissued_reparse,
            duplicates_dropped=self.duplicates_dropped)

    def obs_drain(self) -> tuple[list, list]:
        """Spans + per-worker metric snapshots absorbed from message
        piggybacks so far (the executor folds in its own process's
        recorder and registry on top)."""
        spans, self.obs_spans = self.obs_spans, []
        return spans, list(self._obs_snaps.values())

    def close(self) -> None:
        for i, q in enumerate(self.task_qs):
            try:
                q.put_nowait(None)          # shutdown sentinel
            except (ValueError, OSError, queue_lib.Full):
                pass
        reap(self.procs)
        for q in [self.result_q, *self.task_qs]:
            try:
                q.cancel_join_thread()
                q.close()
            except (ValueError, OSError):
                pass
        if self._shm is not None:
            self._shm.close()       # unlink every remaining segment

    # -- dispatch loop -------------------------------------------------------

    def drain(self, queues: dict[int, list]) -> None:
        """Run every queued batch to completion on the worker fleet.
        May be called repeatedly (the controller's rounds); workers and
        the coordinator's dedup state persist across calls, so a late
        duplicate from a previous round is still dropped."""
        pending = {node: deque(items) for node, items in queues.items()
                   if items}
        self._total_batches += sum(len(q) for q in pending.values())
        t0 = time.perf_counter()
        if self._status_every:
            self._status_next = t0 + self._status_every
        self._progress_t = time.time()
        try:
            while True:
                self._top_up(pending)
                self._retry_stalled()
                if not pending and not self._open:
                    break
                self._pump()
                self._police()
                self._status_tick(t0)
                self._check_stall()
        finally:
            # the settle window below is bookkeeping, not batch work —
            # wall_s measures time-to-last-record
            self._wall_s += time.perf_counter() - t0
        # settle: recovered stragglers may still owe the late duplicate
        # of a re-issued batch. Linger a bounded grace period so the
        # dedup accounting is observable (records are already final —
        # first completion won); anything later is dropped unread.
        deadline = time.perf_counter() + max(
            getattr(self.xcfg, "straggler_grace_s", 0.0), 0.0)
        while self._late and time.perf_counter() < deadline:
            self._pump()
            self._police()
        for i in range(self.n_nodes):
            obs.metrics().gauge(f"pool.load.n{i}", self._load[i])
        obs.metrics().gauge("pool.window", self._window)

    def _check_stall(self) -> None:
        idle = time.time() - self._progress_t
        if idle > self.DRAIN_STALL_S:
            owed = {tid: sorted(self._tasks[tid].current)
                    for tid in sorted(self._open)}
            beats = {w: round(time.time() - self._beat[w], 1)
                     for w in range(self.n_nodes)}
            raise RuntimeError(
                f"drain made no progress for {idle:.0f} s "
                f"(DRAIN_STALL_S): open tasks and their workers {owed}, "
                f"seconds since each worker's heartbeat {beats}, dead "
                f"{sorted(self._dead)}, quiet {sorted(self._quiet)}")

    def _status_tick(self, t0: float) -> None:
        """serve.py --status-interval: a periodic one-line stderr pulse
        (docs/s, α, cache hit rate, in-flight, re-issues)."""
        if not self._status_every:
            return
        now = time.perf_counter()
        if now < self._status_next:
            return
        self._status_next = now + self._status_every
        elapsed = self._wall_s + (now - t0)
        dps = self._docs_done / elapsed if elapsed > 0 else 0.0
        print(obs.status_line(dps, self.alpha, self.cache_hits,
                              self.cache_misses, sum(self._load),
                              self.reissued, self._batches_done,
                              self._total_batches),
              file=sys.stderr, flush=True)

    def _healthy(self, w: int) -> bool:
        return w not in self._dead and w not in self._quiet

    def _owed(self, w: int) -> int:
        """Late results a live worker still owes (re-issued while it was
        quiet, but its attempt is still executing). They occupy the
        worker exactly like open assignments, so the in-flight window
        must count them: otherwise a quiet→recover cycle refills the
        full window on top of the still-running batches, overcommitting
        a just-recovered straggler. Entries clear when the late
        BatchDone arrives or the worker dies."""
        return sum(1 for _tid, lw in self._late if lw == w)

    def _effective_load(self, w: int) -> int:
        return self._load[w] + self._owed(w)

    def _send(self, w: int, task: _TaskState) -> None:
        """Packs the stage's bulk payload into a task-arena slot once
        (re-issues of the same stage reuse the ref — the slot lives
        until the task completes); a failed pack (slot pressure, shm
        unavailable) ships the payload inline instead."""
        if task.stage == "prepare":
            docs = task.docs
            if self._shm is not None:
                if task.prep_ref is None:
                    task.prep_ref = self._shm.encode_task(task.docs)
                if task.prep_ref is not None:
                    docs = None
            msg = PrepareTask(task.task_id, task.batch_key, docs,
                              task.alpha, forward=self.pools is not None,
                              payload=task.prep_ref,
                              attempt=task.attempt)
        else:
            prep, plan = task.prep, task.plan
            if self._shm is not None:
                if task.comp_ref is None:
                    task.comp_ref = self._shm.encode_task(
                        (task.prep, task.plan))
                if task.comp_ref is not None:
                    prep = plan = None
            msg = CompleteTask(task.task_id, task.batch_key, prep, plan,
                               task.alpha, payload=task.comp_ref,
                               attempt=task.attempt)
        self._count_payload(msg.payload is not None)
        self._progress_t = time.time()
        task.attempt += 1
        task.current.add(w)
        self._load[w] += 1
        self.task_qs[w].put(msg)

    def _count_payload(self, by_shm: bool) -> None:
        if by_shm:
            self.payloads_shm += 1
            obs.metrics().count("pool.payloads_shm")
        else:
            self.payloads_inline += 1
            obs.metrics().count("pool.payloads_inline")

    def _top_up(self, pending: dict[int, deque]) -> None:
        """Keep every healthy worker's in-flight window full; work
        queued on a dead/quiet node re-routes to the least-loaded
        eligible peer (same rule as re-issue)."""
        for node in list(pending):
            q = pending[node]
            while q:
                if self._healthy(node) and \
                        self._effective_load(node) < self._window:
                    target = node
                else:
                    if self._healthy(node):
                        break               # its window is full: wait
                    peers = [i for i in scheduler.reissue_candidates(
                        node, self.pools, self.cheap_dev, self.n_nodes,
                        exclude=self._dead)
                        if self._healthy(i)
                        and self._effective_load(i) < self._window]
                    if not peers:
                        if self._no_possible_worker(node):
                            raise RuntimeError(
                                f"ingest node {node} is gone and no "
                                f"eligible peer is alive; campaign "
                                f"cannot complete")
                        break               # peers busy/quiet: wait
                    target = scheduler.least_loaded(peers, self.clocks)
                    rec = obs.recorder()
                    if rec.enabled:
                        rec.span("reroute", q[0]["batch_key"],
                                 time.time(), 0.0, node=target,
                                 detail=f"queued on unhealthy node "
                                        f"{node}")
                batch = q.popleft()
                tid = self._next_task_id
                self._next_task_id += 1
                t = _TaskState(tid, node, batch["batch_key"],
                               batch["docs"],
                               self._alpha_of.get(node, self.alpha))
                self._tasks[tid] = t
                self._open.add(tid)
                self._send(target, t)
            if not q:
                del pending[node]

    def _no_possible_worker(self, node: int) -> bool:
        return node in self._dead and not scheduler.reissue_candidates(
            node, self.pools, self.cheap_dev, self.n_nodes,
            exclude=self._dead)

    def _try_dispatch(self, t: _TaskState) -> bool:
        """Send ``t`` to the least-loaded live worker eligible for its
        stage. False when every live candidate is quiet (a straggler
        that may heartbeat back — the caller stalls and retries);
        raises only when every candidate is *dead*."""
        if t.stage == "complete":
            cands = [i for i in self.reparse_nodes
                     if i not in self._dead]
        else:
            cands = ([t.node] if t.node not in self._dead else []) \
                + scheduler.reissue_candidates(
                    t.node, self.pools, self.cheap_dev, self.n_nodes,
                    exclude=self._dead)
        peers = [i for i in cands if self._healthy(i)]
        if peers:
            self._send(scheduler.least_loaded(peers, self.clocks), t)
            return True
        if not cands:
            raise RuntimeError(
                f"no live worker can run batch {t.batch_key} "
                f"({t.stage} stage); campaign cannot complete")
        return False                     # alive-but-quiet candidates

    def _retry_stalled(self) -> None:
        for tid in list(self._stalled):
            t = self._tasks[tid]
            if t.done or t.current:
                self._stalled.discard(tid)
            elif self._try_dispatch(t):
                self._stalled.discard(tid)
                if t.needs_reissue:
                    t.needs_reissue = False
                    self.reissued += 1
                    obs.metrics().count("pool.reissued")
                    if t.stage == "complete":
                        self.reissued_reparse += 1
                        obs.metrics().count("pool.reissued_reparse")
                    rec = obs.recorder()
                    if rec.enabled:
                        rec.span("reissue", t.batch_key, time.time(),
                                 0.0, attempt=t.attempt,
                                 detail=f"stalled {t.stage} stage "
                                        f"re-dispatched")

    def _pump(self) -> None:
        """Drain the result queue: the first get blocks briefly (the
        loop's pacing), the rest are opportunistic."""
        try:
            self._handle(self.result_q.get(timeout=self._POLL_S))
        except queue_lib.Empty:
            return
        while True:
            try:
                self._handle(self.result_q.get_nowait())
            except queue_lib.Empty:
                return

    def _absorb_obs(self, worker: int, spans, snap) -> None:
        """Fold a message's piggybacked observability payload into the
        coordinator's collection (spans append; the metrics snapshot is
        cumulative, so last-write-wins per worker)."""
        if spans:
            self.obs_spans.extend(spans)
        if snap is not None:
            self._obs_snaps[worker] = snap

    def _handle(self, msg) -> None:
        if isinstance(msg, Heartbeat):
            self._beat[msg.worker] = time.time()
            self._hb_depth[msg.worker] = msg.queue_depth
            self._hb_task[msg.worker] = msg.task_id
            if msg.sent_mono and self._mono_comparable:
                # same-host fleets only: CLOCK_MONOTONIC has a
                # per-machine epoch, so differencing against a remote
                # worker's stamp is meaningless — the fabric subclass
                # keeps this diagnostic off. Liveness deadlines below
                # always run on coordinator receive time (_beat).
                self._hb_delay[msg.worker] = max(
                    0.0, time.monotonic() - msg.sent_mono)
            self._absorb_obs(msg.worker, msg.spans, msg.metrics)
            if msg.worker in self._quiet and \
                    self.procs[msg.worker].is_alive():
                self._quiet.discard(msg.worker)   # straggler recovered
            return
        if not isinstance(msg, BatchDone):
            return
        self._progress_t = time.time()
        self._absorb_obs(msg.worker, msg.spans, msg.metrics)
        if msg.error is None:
            self._count_payload(msg.payload is not None)
        if msg.payload is not None:
            # copy the bulk reply out of the worker's response arena and
            # free the slot — unconditionally, so a dropped duplicate
            # can never strand a slot in the (bounded) response arena
            obj = self._shm.take_result(msg.payload)
            if msg.payload_kind == "prep":
                msg.prep, msg.plan = obj
            else:
                msg.records = obj
            msg.payload = None
        t = self._tasks.get(msg.task_id)
        if t is None:
            if msg.error is not None:
                # not tied to any known task (e.g. a worker failing
                # after the ready handshake): nothing to re-issue
                raise RuntimeError(f"worker {msg.worker} failed:\n"
                                   f"{msg.error}")
            return
        self._late.discard((msg.task_id, msg.worker))
        if msg.worker in t.current:
            t.current.discard(msg.worker)
            self._load[msg.worker] -= 1
        if t.done:
            # a re-issued straggler's late result — success or failure,
            # it lost the first-completion race and the records are
            # already final
            self.duplicates_dropped += 1
            obs.metrics().count("pool.dedup_dropped")
            rec = obs.recorder()
            if rec.enabled:
                rec.span("dedup", t.batch_key, time.time(), 0.0,
                         node=msg.worker, attempt=msg.attempt,
                         abandoned=True, detail="lost completion race")
            return
        if msg.error is not None:
            if t.current or msg.task_id in self._stalled:
                # a losing attempt failed while another attempt (or a
                # pending re-dispatch) still covers the batch — let
                # the survivor finish instead of tearing down the pool
                return
            raise RuntimeError(f"worker {msg.worker} failed on task "
                               f"{msg.task_id}:\n{msg.error}")
        if msg.prep is not None:
            if t.stage != "prepare":
                # late duplicate of an already-forwarded ingest stage
                self.duplicates_dropped += 1
                obs.metrics().count("pool.dedup_dropped")
                rec = obs.recorder()
                if rec.enabled:
                    rec.span("dedup", t.batch_key, time.time(), 0.0,
                             node=msg.worker, attempt=msg.attempt,
                             abandoned=True,
                             detail="duplicate ingest stage")
                return
            # ingest stage of a forwarded batch finished on msg.worker
            t.ingest_worker = msg.worker
            self.clocks[msg.worker] += msg.wall_s
            t.stage = "complete"
            t.prep, t.plan = msg.prep, msg.plan
            rec = obs.recorder()
            if rec.enabled:
                rec.span("forward", t.batch_key, time.time(), 0.0,
                         node=msg.worker, attempt=msg.attempt,
                         detail="prep handed to reparse pool")
            if not self._try_dispatch(t):
                self._stalled.add(t.task_id)
            return
        # final result for this batch
        t.done = True
        self._open.discard(t.task_id)
        for w in list(t.current):        # other outstanding attempts
            self._load[w] -= 1
            if w not in self._dead:
                self._late.add((t.task_id, w))
        t.current.clear()
        t.prep = t.plan = None
        t.docs = None
        if self._shm is not None:
            # reclaim the task's arena slots; freeing bumps the
            # generation, so any straggler still holding a ref fails
            # stale instead of reading a reused slot
            self._shm.free_task(t.prep_ref)
            self._shm.free_task(t.comp_ref)
            t.prep_ref = t.comp_ref = None
        for r in msg.records:
            self.records[r.doc_id] = r
        ingest = t.ingest_worker if t.ingest_worker is not None \
            else msg.worker
        if msg.telemetry is not None:
            self.telemetry[ingest].append(msg.telemetry)
            self._n_expensive[msg.worker] += msg.telemetry.n_expensive
        self.clocks[msg.worker] += msg.wall_s
        if self._has_cache:
            if msg.cached:
                self.cache_hits += 1
                obs.metrics().count("pool.cache_hits")
            else:
                self.cache_misses += 1
                obs.metrics().count("pool.cache_misses")
        self._batches_done += 1
        self._docs_done += len(msg.records)
        obs.metrics().count("pool.batches_done")
        obs.metrics().observe("pool.batch_wall_s", msg.wall_s)
        rec = obs.recorder()
        if rec.enabled:
            # the authoritative winning `complete` span: exactly one
            # per emitted batch, attributed to the worker whose attempt
            # won the first-completion race
            rec.span("complete", t.batch_key,
                     time.time() - msg.wall_s, msg.wall_s,
                     node=msg.worker, attempt=msg.attempt,
                     cached=msg.cached)

    def _police(self) -> None:
        """Liveness: a dead process (crash) is permanent — its open
        tasks re-issue and its queue re-routes. A worker that missed
        the heartbeat deadline (wedged) is quieted: its open tasks
        re-issue, no new work lands on it, and it rejoins on its next
        heartbeat (late duplicates are dropped)."""
        now = time.time()
        for w in range(self.n_nodes):
            if w in self._dead:
                continue
            if not self.procs[w].is_alive():
                self._dead.add(w)
                self._quiet.discard(w)
                self._late = {(tid, lw) for tid, lw in self._late
                              if lw != w}
                if self._shm is not None:
                    # crash recovery: drop the dead worker's response
                    # arena from /dev/shm now (the coordinator's mapping
                    # stays readable for replies it queued before dying)
                    self._shm.unlink_worker(w)
                self._reissue_from(w)
            elif (now - self._beat[w] > self._deadline_for(w)
                    and w not in self._quiet):
                self._quiet.add(w)
                self._reissue_from(w)

    def _deadline_for(self, w: int) -> float:
        """Effective heartbeat deadline for worker ``w``. A worker
        whose last beacon reported queued work is alive and digesting a
        deep backlog, not wedged — its beacons may simply be stuck
        behind bulky results in the shared queue. Grant one extra base
        timeout per reported queued task (bounded at 4x) before firing
        a re-issue; a worker that reported an empty queue, or one we
        have no depth report from, keeps the base deadline."""
        base = self.xcfg.heartbeat_timeout_s
        depth = self._hb_depth[w]
        if depth > 0:
            return base * (1.0 + min(depth, 4))
        return base

    def _reissue_from(self, w: int) -> None:
        """Re-issue every open task currently owed by ``w`` to the
        least-loaded eligible peer — same pool first, crossing pools
        only when the backend's device allows. The batch's stateless
        rng stream makes the re-run emit identical records, and the
        dedup gate keeps only the first completion."""
        for tid in list(self._open):
            t = self._tasks[tid]
            if w not in t.current:
                continue
            t.current.discard(w)
            self._load[w] -= 1
            if w not in self._dead:
                self._late.add((tid, w))
            device = self.exp_dev if t.stage == "complete" \
                else self.cheap_dev
            peers = [i for i in scheduler.reissue_candidates(
                w, self.pools, device, self.n_nodes,
                exclude=self._dead) if self._healthy(i)]
            if not peers:
                if t.current:
                    continue            # another attempt may finish
                # no live attempt remains right now: stall for retry.
                # A merely-quiet w may still deliver its own result
                # (then the stalled entry clears as done); if every
                # candidate is dead, _try_dispatch raises on the next
                # tick. A dead w's attempt is gone for good, so the
                # eventual re-dispatch counts as a re-issue.
                t.needs_reissue = w in self._dead
                self._stalled.add(tid)
                continue
            g = scheduler.least_loaded(peers, self.clocks)
            self._send(g, t)
            self.reissued += 1
            self._reissued_tasks[g] += 1
            obs.metrics().count("pool.reissued")
            if t.stage == "complete":
                self.reissued_reparse += 1
                obs.metrics().count("pool.reissued_reparse")
            rec = obs.recorder()
            if rec.enabled:
                cause = "crash" if w in self._dead else "wedged"
                rec.span("reissue", t.batch_key, time.time(), 0.0,
                         node=g, attempt=t.attempt,
                         detail=f"{cause} worker {w}, {t.stage} stage")


#: seconds a closing pool gives its workers, all together, to exit
#: after the shutdown sentinel (a worker joins its heartbeat thread and
#: tears torch down; on a loaded host that has taken over 3 s)
EXIT_WAIT_S = 10.0


def reap(procs, wait_s: float = EXIT_WAIT_S) -> None:
    """Join ``procs`` within one shared deadline of ``wait_s``, then
    terminate any still alive and kill any that outlive that, each step
    with a limit of its own: no worker outlives its pool's ``close``
    (``multiprocessing`` joins its children without a limit at
    interpreter exit)."""
    deadline = time.time() + wait_s
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)


def _portable_router(router):
    """Back-compat alias: the implementation lives in
    ``core/specs.portable_router`` (shared with the fabric runtime)."""
    from repro_torch.core.specs import portable_router

    return portable_router(router)


def _prebuild_kernels(device: str) -> None:
    """Build the kernel library once before workers on a card spawn:
    ``cuda_lib.build`` runs ``nvcc`` only and opens no CUDA context,
    and the library is keyed by its sources, so each worker then loads
    it instead of compiling its own. Without a card there is nothing to
    build for: the workers report the missing card themselves."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        from repro_torch.kernels import cuda_lib

        cuda_lib.build()


def make_worker_pool(ecfg: EngineConfig, xcfg, router, corpus_cfg,
                     n_nodes: int, ingest_nodes: list[int],
                     reparse_nodes: list[int], pools: list[str] | None, *,
                     engines: list[AdaParseEngine] | None = None,
                     alpha_of: dict[int, float] | None = None, cache=None,
                     probe=None, image_degraded=False, text_degraded=False,
                     device=None) -> "WorkerPool":
    """The one dispatch point between the three runtimes: ``local``
    wraps the caller-built engines in the simulated fleet, ``process``
    spawns real worker processes, ``fabric`` listens for workers dialing
    in over TCP (core/fabric — loopback or other machines). In the
    latter two the caller builds no engines — each worker builds its own
    from the serialized spec, on ``device`` (cuda unless "cpu")."""
    runtime = getattr(xcfg, "runtime", "local")
    if runtime in ("process", "fabric"):
        if runtime == "fabric":
            from repro_torch.core.fabric import FabricWorkerPool as pool_cls
        else:
            pool_cls = ProcessWorkerPool
        return pool_cls(
            ecfg, xcfg, router, corpus_cfg, n_nodes, ingest_nodes,
            reparse_nodes, pools, alpha_of=alpha_of, cache=cache,
            probe_cfg=(probe.cfg if probe is not None else None),
            image_degraded=image_degraded, text_degraded=text_degraded,
            backend_specs=getattr(xcfg, "worker_backend_specs", ()) or (),
            device=device)
    if runtime != "local":
        raise ValueError(f"unknown worker runtime {runtime!r}; choose "
                         f"'local' (in-process simulated fleet), "
                         f"'process' (real worker processes), or "
                         f"'fabric' (workers over TCP, core/fabric)")
    return LocalWorkerPool(ecfg, xcfg, engines, n_nodes, ingest_nodes,
                           reparse_nodes, pools)
