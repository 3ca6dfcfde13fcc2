"""Worker runtime: the execution layer behind campaign dispatch.

Every campaign path — pooled, prefetched, adaptive, quality-retuned —
dispatches through one ``WorkerPool`` protocol. This port has one
runtime so far:

- ``LocalWorkerPool`` is the in-process *simulated* fleet: one real
  ``AdaParseEngine`` per node, per-node clocks advanced by the
  backends' cost models, injected stragglers
  (``ExecutorConfig.straggler_rate``), and ``node_speed_factors`` skew.
  It is the analytic/testing path — fast, fully deterministic, and the
  fleet the 128-node scaling stories run on. Its engines all run on the
  one torch device the campaign was given (several simulated nodes
  share one card and one router); a node's pool (``"cpu"``/``"gpu"``)
  names the simulated backend's device, never a torch device.

The real worker processes (``ProcessWorkerPool``, with the shared-memory
transport of ``core/shm``) and the TCP fabric are ROADMAP items 12b and
12c: ``make_worker_pool`` refuses those runtimes with
``NotImplementedError`` rather than running them in-process.

Determinism contract: batch rng streams are keyed by the batch's
*global* index and carried from prepare into complete, so an N-node
campaign — pooled, prefetched, disk-cached, re-issued, adaptive, or all
of the above — produces exactly the record set of a single-node run
over the same corpus. A ``backends.DiskResultStore`` written by one
campaign replays in a later one, on either torch device: the records
hold numpy arrays and Python values only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import backends as B
from repro_torch.core import obs
from repro_torch.core import scheduler
from repro_torch.core.engine import (AdaParseEngine, BatchTelemetry,
                                     EngineConfig, EngineStats)
from repro_torch.data.pipeline import Prefetcher


# ---------------------------------------------------------------------------
# Fault hooks (process runtime, ROADMAP item 12b)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Deterministic fault hooks for the process runtime (tests and
    chaos demos; production campaigns leave this None). Carried by
    ``ExecutorConfig`` so configs round-trip; the process runtime that
    reads it is ROADMAP item 12b.

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


def make_worker_pool(ecfg: EngineConfig, xcfg, router, corpus_cfg,
                     n_nodes: int, ingest_nodes: list[int],
                     reparse_nodes: list[int], pools: list[str] | None, *,
                     engines: list[AdaParseEngine] | None = None,
                     alpha_of: dict[int, float] | None = None, cache=None,
                     probe=None, image_degraded=False, text_degraded=False
                     ) -> "WorkerPool":
    """The one dispatch point between the runtimes: ``local`` wraps the
    caller-built engines in the simulated fleet. ``process`` (real
    worker processes, ROADMAP item 12b) and ``fabric`` (workers over
    TCP, item 12c) are not ported: they raise instead of running the
    campaign in-process."""
    runtime = getattr(xcfg, "runtime", "local")
    if runtime == "process":
        raise NotImplementedError(
            "runtime='process' (real worker processes: ProcessWorkerPool, "
            "launch/worker_main.py, core/shm.py) is ROADMAP item 12b, not "
            "ported to repro_torch yet; use runtime='local'")
    if runtime == "fabric":
        raise NotImplementedError(
            "runtime='fabric' (workers over TCP: core/fabric.py, "
            "launch/fabric_worker.py) is ROADMAP item 12c, not ported to "
            "repro_torch yet; use runtime='local'")
    if runtime != "local":
        raise ValueError(f"unknown worker runtime {runtime!r}; choose "
                         f"'local' (in-process simulated fleet), "
                         f"'process' (real worker processes), or "
                         f"'fabric' (workers over TCP, core/fabric)")
    return LocalWorkerPool(ecfg, xcfg, engines, n_nodes, ingest_nodes,
                           reparse_nodes, pools)
