"""AdaParseEngine: the end-to-end adaptive parsing pipeline (§5).

Per batch of k documents the pipeline is three stages, each batched (no
per-doc Python loop on the hot path) and each dispatched through the
parser-backend registry (core/backends):

  prepare_batch — cheap backend channel over the whole batch + CLS-I
                  fast features (host-side; this is the stage the
                  Prefetcher overlaps with the previous batch's routing)
  route_batch   — CLS II/III improvement prediction + α-budget top-⌊αk⌋
                  selection (App. C). FT variant: host numpy mirror
                  (scheduler.plan_batch). LLM variant: the fused device
                  route step (router.make_route_step: encoder forward ->
                  the budget_route CUDA kernel) — the production device
                  path; the host mirror is tested to choose identical
                  documents.
  complete_batch— expensive backend re-parse of the selected docs
                  (batched, warm-start once per node) + emit final text
                  per doc with provenance. Cheap-channel/router cost is
                  charged to the engine that prepared the batch
                  (``ingest_engine``) so a heterogeneous campaign can
                  run prepare on a CPU-pool node and complete on a
                  GPU-pool node with correct per-node accounting.

``process_batch`` composes the three stages on one node (the
single-node production path). ``run`` with ``prefetch_depth > 0``
streams prepare through ``data/pipeline.Prefetcher`` so the host
channel application of batch i+1 overlaps the routing/re-parse of
batch i.

Determinism: with an explicit ``batch_key``, the corruption rng is
derived statelessly from (engine seed, batch key) and carried from
prepare into complete — the same batch produces the same records no
matter which node prepares it, which node completes it, whether the
prepare ran in a prefetch worker thread, or whether the records were
replayed from a ``backends.ResultCache`` (data/pipeline.stateless_rng).
``run`` keys batches by their global index, and
core/campaign.CampaignExecutor uses the same keys, so a multi-node
campaign — pooled, prefetched, cached, or all three — reproduces the
single-node record set exactly (including straggler re-issues, which
simply re-run the same key).

Quality plane: with a ``core/quality.QualityProbe`` attached, batches
the probe's deterministic batch-keyed sampler selects get per-parser
scores on their ``BatchTelemetry.quality`` (cache replays and
abandoned straggler attempts stay None) — the signal the campaign
controller retunes α from at round boundaries; ``set_alpha`` applies
such a retune, invalidating the route step and the cache tag.

Device: the engine runs its routing inputs, route step and evaluation
on ``device`` (cuda unless the caller passes "cpu"); records are host
objects and identical on either device for the ft variant.

Execution-layer features mirrored from the paper:
  - warm-start: ViT weights load once per node (15 s) and persist
  - page-batched expensive parsing (B_p = 10, ``BackendInfo.batch_docs``)
  - node-local batching (ZIP aggregation analogue): per-batch I/O is
    charged once per batch, not per document
  - straggler mitigation lives in the campaign layer (CampaignExecutor
    re-issues actual batches; campaign.simulate_parser_campaign is the
    analytic fast path)
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backends as B
from repro_torch.core import features as feat_lib
from repro_torch.core import metrics as M
from repro_torch.core import obs
from repro_torch.core import parsers as P
from repro_torch.core import scheduler
from repro_torch.core.router import (CLS1_OVERRIDE, AdaParseRouter,
                                     make_route_step)
from repro_torch.data.pipeline import Prefetcher, stateless_rng
from repro_torch.data.synthetic import (CorpusConfig, Document,
                                        batch_metadata_features)


def _router_fingerprint(router) -> str:
    """Content hash of everything in the router that shapes a routing
    decision (variant, thresholds, CLS I/II weights, encoder params).
    Stable across processes — the property the on-disk ResultStore
    needs to replay campaigns after a restart — and collision-free for
    routers with different weights, which is what made bare id() (or a
    per-process counter) unsound. Memoized on the router object."""
    fp = getattr(router, "_cache_fp", None)
    if fp is not None:
        return fp
    h = hashlib.sha256()

    def upd(x):
        # length-prefix every field so adjacent values can never
        # re-segment into the same byte stream (0.51|23 vs 0.512|3)
        if x is None:
            payload = b"\x00none"
        elif isinstance(x, (bool, int, float, str)):
            payload = repr(x).encode()
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            payload = (str(tuple(t.shape)).encode() + b"|"
                       + str(t.dtype).encode() + b"|"
                       + t.view(torch.uint8).numpy().tobytes())
        else:
            a = np.ascontiguousarray(np.asarray(x))
            payload = (str(a.shape).encode() + b"|"
                       + str(a.dtype).encode() + b"|" + a.tobytes())
        h.update(b"%d:" % len(payload) + payload)

    for x in (router.variant, router.valid_threshold,
              router.improve_threshold, router.cheap_idx,
              router.expensive_idx, router.cls1.w, router.cls1.b):
        upd(x)
    # enc_cfg shapes the encoder forward (heads, norms, dtypes) even
    # when the param leaves are identical; its dataclass repr is stable
    upd(None if router.enc_cfg is None else repr(router.enc_cfg))
    if router.cls2 is not None:
        upd(router.cls2.w)
        upd(router.cls2.b)
    else:
        upd(None)
    if router.encoder is not None:
        # encoder params by content, in sorted state_dict order
        sd = router.encoder.state_dict()
        for name in sorted(sd):
            upd(name)
            upd(sd[name])
    fp = h.hexdigest()
    router._cache_fp = fp
    return fp


@dataclasses.dataclass
class EngineConfig:
    alpha: float = 0.05              # ≤5% of docs to the expensive parser
    batch_size: int = 256            # k (App. C)
    cheap: str = P.CHEAP_PARSER      # backend names (core/backends registry)
    expensive: str = P.EXPENSIVE_PARSER
    router_cost_s: float = 0.002     # CLS-III inference per doc (amortized)
    seed: int = 0
    device_route: bool = True        # LLM variant: fused device selection
    prefetch_depth: int = 0          # >0: run() overlaps prepare via Prefetcher
    # prepare-stage routing-input path (core/features
    # .prepare_routing_inputs): "auto" = the CUDA fast_features kernel
    # on a CUDA device / its plain version on the CPU, "force" = the
    # kernel or an error, "host" = legacy unfused numpy pipeline
    feature_kernel: str = "auto"


@dataclasses.dataclass
class ParseRecord:
    doc_id: int
    parser: str
    pages: list
    cost_s: float


@dataclasses.dataclass
class EngineStats:
    n_docs: int = 0
    n_expensive: int = 0
    node_seconds: float = 0.0
    router_seconds: float = 0.0
    reissued_tasks: int = 0
    cache_hits: int = 0

    @property
    def throughput(self) -> float:
        return self.n_docs / max(self.node_seconds, 1e-9)


@dataclasses.dataclass
class BatchTelemetry:
    """Per-batch, per-stage timing emitted by the staged engine — the
    feedback signal the adaptive campaign controller autotunes
    ``node_budget_weights`` from. Appended to the *ingest* engine's
    ``telemetry`` list (the engine that prepared/routed the batch);
    ``complete_node`` records where the expensive re-parse ran."""

    batch_key: int | None
    n_docs: int
    n_expensive: int
    complete_node: int
    prepare_s: float                 # cheap channel + fast features
    route_s: float                   # CLS II/III selection
    complete_s: float                # expensive re-parse (+ warm-start)
    # quality-probe scoring cost (QualityProbeConfig.cost_s_per_doc ×
    # batch size), charged to the completing node's clock: the
    # controller's throughput EWMA sees probe overhead instead of
    # treating scoring as free measurement-plane work
    probe_s: float = 0.0
    cached: bool = False
    # straggler attempt given up at the deadline: its docs were produced
    # again elsewhere, so throughput measurement must skip this record
    abandoned: bool = False
    # per-parser probe scores {parser: (mean_quality, n_docs)} when the
    # quality probe sampled this batch (core/quality.QualityProbe);
    # None for unprobed batches AND for cache replays / abandoned
    # straggler attempts — excluded from the quality signal exactly
    # like their timing is excluded from observed throughput
    quality: dict | None = None

    @property
    def total_s(self) -> float:
        return self.prepare_s + self.route_s + self.complete_s \
            + self.probe_s


@dataclasses.dataclass
class PreparedBatch:
    """Output of the host-side prepare stage. ``rng`` is the batch's
    stateless stream, partially consumed by the cheap channel; complete
    continues it so split prepare/complete is bit-identical to the fused
    single-call path. ``route_host`` carries the host-derived routing
    inputs (first-page tokens / CLS-I logits / metadata features) so the
    consumer's route step is as close to pure device work as possible."""

    docs: list
    batch_key: int | None
    rng: np.random.RandomState
    extracted: list
    fast: np.ndarray
    cheap_cost: np.ndarray
    route_host: dict

    @property
    def ingest_cost_s(self) -> float:
        return float(self.cheap_cost.sum())


class AdaParseEngine:
    def __init__(self, ecfg: EngineConfig, router: AdaParseRouter,
                 corpus_cfg: CorpusConfig,
                 image_degraded=False, text_degraded=False,
                 cache: B.ResultStore | None = None,
                 probe=None, device=None):
        self.cfg = ecfg
        self.device = device_lib.resolve(device)
        self.router = router
        self.ccfg = corpus_cfg
        self.image_degraded = image_degraded
        self.text_degraded = text_degraded
        self.cache = cache
        # optional core/quality.QualityProbe: deterministically sampled
        # batches get per-parser scores on their BatchTelemetry (pure
        # measurement plane — never charged to node clocks or records)
        self.probe = probe
        self.cheap_backend = B.get_backend(ecfg.cheap)
        self.expensive_backend = B.get_backend(ecfg.expensive)
        self.rng = np.random.RandomState(ecfg.seed)
        self.stats = EngineStats()
        self.telemetry: list[BatchTelemetry] = []
        self._warmed_nodes: set[int] = set()
        self._route_step = None      # lazily built fused route step
        self._cache_tag = self._make_cache_tag()

    def _make_cache_tag(self):
        """Cache keys must capture everything that shapes a batch's
        records: the full corpus config (any field changes the
        documents), the routing α, and a content fingerprint of the
        router (stable across processes, so a DiskResultStore replays
        campaigns after a restart)."""
        return (self.cfg.seed, self.cfg.alpha, self.cfg.cheap,
                self.cfg.expensive, self.cfg.device_route,
                self.cfg.feature_kernel,
                self.router.variant, dataclasses.astuple(self.ccfg),
                self.image_degraded, self.text_degraded,
                _router_fingerprint(self.router))

    def set_alpha(self, alpha: float) -> None:
        """Round-boundary α retune (core/quality): swap the routing
        budget and invalidate everything derived from it — the fused
        route step (α is baked into its top-⌊αk⌋ capacity) and
        the cache tag (records parsed at a different α are different
        records, so replay only matches runs that retuned identically)."""
        if alpha == self.cfg.alpha:
            return
        self.cfg = dataclasses.replace(self.cfg, alpha=alpha)
        self._route_step = None
        self._cache_tag = self._make_cache_tag()

    # -- routing --------------------------------------------------------------

    def _route_host_features(self, docs, fast, tokens, mask) -> dict:
        """Routing inputs derived during prepare so the consumer-side
        route step is (for the LLM variant) pure device work the
        Prefetcher worker can overlap. ``tokens``/``mask`` come fused
        out of ``prepare_routing_inputs`` as tensors on the engine's
        device, feeding ``route_step`` without a host round-trip."""
        rh: dict = {}
        if self.router.variant == "llm":
            rh["tokens"], rh["mask"] = tokens, mask
            if self.cfg.device_route:
                rh["valid_logit"] = (
                    self.router.cls1.predict_proba(fast)
                    - self.router.valid_threshold).astype(np.float32)
        else:
            rh["meta"] = batch_metadata_features(docs)
        return rh

    def _device_plan(self, prep: PreparedBatch) -> scheduler.BatchPlan:
        """LLM-variant production path: encoder fwd + α-budget selection +
        compact-gather on the device (no host round-trip between scoring
        and dispatch)."""
        if self._route_step is None:
            self._route_step = make_route_step(
                self.cfg.alpha, cheap_idx=self.router.cheap_idx,
                expensive_idx=self.router.expensive_idx)
        out = self._route_step(
            self.router.encoder, prep.route_host["tokens"],
            prep.route_host["mask"],
            torch.from_numpy(prep.route_host["valid_logit"]).to(
                self.device))
        idx = out["selected_idx"].cpu().numpy()
        sel = np.sort(idx[idx >= 0]).astype(np.int64)
        k = len(prep.extracted)
        cheap = np.setdiff1d(np.arange(k), sel, assume_unique=False)
        return scheduler.BatchPlan(sel, cheap, len(sel) / max(k, 1))

    def _host_plan(self, prep: PreparedBatch) -> scheduler.BatchPlan:
        """Numpy mirror (FT variant, and the LLM fallback when
        ``device_route=False``); must agree with the device path on the
        same scores — see tests/test_routing.py."""
        toks = prep.route_host.get("tokens")
        masks = prep.route_host.get("mask")
        imp = self.router.predict_improvement(
            prep.fast, prep.route_host.get("meta"), toks, masks)
        return scheduler.plan_batch(
            np.nan_to_num(imp, posinf=CLS1_OVERRIDE), self.cfg.alpha)

    # -- pipeline stages ------------------------------------------------------

    def prepare_batch(self, docs: list[Document],
                      batch_key: int | None = None) -> PreparedBatch:
        """Ingest: cheap backend channel over the whole batch, then
        every routing input (CLS-I fast features and, for the LLM
        variant, the first-page token/mask pair) in one fused
        ``prepare_routing_inputs`` call — the CUDA fast_features kernel
        on a CUDA device (``EngineConfig.feature_kernel``). Pure w.r.t.
        engine state (no stats mutation), so it may run in a prefetch
        worker thread: bringing ``fast`` to the host synchronises with
        the kernel there, while ``tokens``/``mask`` stay on the device
        for the route step."""
        rng = (stateless_rng(self.cfg.seed, batch_key)
               if batch_key is not None else self.rng)
        extracted = self.cheap_backend.parse_batch(
            docs, self.ccfg, rng, image_degraded=self.image_degraded,
            text_degraded=self.text_degraded)
        max_len = (self.router.enc_cfg.max_len
                   if self.router.variant == "llm" else None)
        fast, tokens, mask = feat_lib.prepare_routing_inputs(
            extracted, self.ccfg, max_len=max_len,
            mode=self.cfg.feature_kernel, device=self.device)
        fast = fast.cpu().numpy()        # CLS-I predict_proba is host-side
        return PreparedBatch(docs, batch_key, rng, extracted, fast,
                             self.cheap_backend.cost_batch(docs),
                             self._route_host_features(docs, fast,
                                                       tokens, mask))

    def route_batch(self, prep: PreparedBatch) -> scheduler.BatchPlan:
        """CLS II/III + α-budget selection over a prepared batch."""
        if self.router.variant == "llm" and self.cfg.device_route:
            return self._device_plan(prep)
        return self._host_plan(prep)

    def complete_batch(self, prep: PreparedBatch, plan: scheduler.BatchPlan,
                       node_id: int = 0,
                       ingest_engine: "AdaParseEngine | None" = None
                       ) -> list[ParseRecord]:
        """Expensive re-parse of the selected docs + emit. All cost/stat
        accounting happens here: cheap-channel + router cost goes to
        ``ingest_engine`` (the engine that prepared/routed the batch —
        defaults to self, the homogeneous case), expensive-parse cost +
        warm-start to self."""
        ing = ingest_engine if ingest_engine is not None else self
        k = len(prep.docs)
        router_cost = self.cfg.router_cost_s * k
        ing.stats.n_docs += k
        ing.stats.router_seconds += router_cost
        ing.stats.node_seconds += prep.ingest_cost_s + router_cost
        sel = plan.expensive_idx
        cost = 0.0
        if sel.size and node_id not in self._warmed_nodes:
            cost += self.expensive_backend.info.warm_start_s
            self._warmed_nodes.add(node_id)
        sel_docs = [prep.docs[i] for i in sel]
        sel_pages = self.expensive_backend.parse_batch(
            sel_docs, self.ccfg, prep.rng,
            image_degraded=self.image_degraded,
            text_degraded=self.text_degraded)
        sel_cost = self.expensive_backend.cost_batch(sel_docs)
        cost += float(sel_cost.sum())
        records: list[ParseRecord] = []
        by_sel = {int(i): j for j, i in enumerate(sel)}
        for i, d in enumerate(prep.docs):
            j = by_sel.get(i)
            if j is not None:
                records.append(ParseRecord(d.doc_id, self.cfg.expensive,
                                           sel_pages[j], float(sel_cost[j])))
            else:
                records.append(ParseRecord(d.doc_id, self.cfg.cheap,
                                           prep.extracted[i],
                                           float(prep.cheap_cost[i])))
        self.stats.n_expensive += len(sel)
        self.stats.node_seconds += cost
        quality = None
        probe_cost = 0.0
        if (self.probe is not None and prep.batch_key is not None
                and self.probe.should_probe(prep.batch_key)):
            quality = self.probe.score_records(prep.docs, records)
            # probing is charged to the node that scored the batch
            # (this one), not treated as free measurement-plane work
            probe_cost = self.probe.cfg.cost_s_per_doc * k
            self.stats.node_seconds += probe_cost
        ing.telemetry.append(BatchTelemetry(
            batch_key=prep.batch_key, n_docs=k, n_expensive=len(sel),
            complete_node=node_id, prepare_s=prep.ingest_cost_s,
            route_s=router_cost, complete_s=cost, probe_s=probe_cost,
            quality=quality))
        # observability: per-stage latency histograms (always-on — a
        # handful of dict ops per *batch*) and, when tracing is
        # enabled, one span per stage reconstructed from the batch's
        # already-measured durations (one record call each, so the hot
        # path gains no extra timers)
        reg = obs.metrics()
        reg.observe("engine.prepare_s", prep.ingest_cost_s)
        reg.observe("engine.route_s", router_cost)
        reg.observe("engine.reparse_s", cost)
        if probe_cost:
            reg.observe("engine.probe_s", probe_cost)
        rec = obs.recorder()
        if rec.enabled:
            key = prep.batch_key if prep.batch_key is not None else -1
            t0 = time.time() - (prep.ingest_cost_s + router_cost + cost
                                + probe_cost)
            rec.span("prepare", key, t0, prep.ingest_cost_s,
                     node=node_id)
            t0 += prep.ingest_cost_s
            rec.span("route", key, t0, router_cost, node=node_id)
            t0 += router_cost
            rec.span("reparse", key, t0, cost, node=node_id,
                     detail=f"{len(sel)}/{k} docs expensive")
            if probe_cost:
                rec.span("probe", key, t0 + cost, probe_cost,
                         node=node_id)
        return records

    # -- result cache ---------------------------------------------------------

    def _cache_key(self, docs, batch_key):
        if self.cache is None or batch_key is None:
            return None
        return (self._cache_tag, batch_key, tuple(d.doc_id for d in docs))

    def prepare_or_lookup(self, docs, batch_key=None, use_cache=True
                          ) -> tuple:
        """One step of the ingest protocol: ``(key, prep, cached)`` where
        exactly one of ``prep``/``cached`` is set. Safe to call from a
        prefetch worker thread. ``use_cache=False`` forces a real prepare
        (used by straggler re-issue, which must model the actual re-parse
        cost rather than replay the abandoned attempt's stored result)."""
        key = self._cache_key(docs, batch_key) if use_cache else None
        cached = None
        if key is not None:
            rec = obs.recorder()
            if rec.enabled:
                tw, tp = time.time(), time.perf_counter()
                cached = self.cache.lookup(key)
                dur = time.perf_counter() - tp
                rec.span("cache_lookup", batch_key, tw, dur,
                         cached=cached is not None)
                obs.metrics().observe("engine.cache_lookup_s", dur)
            else:
                cached = self.cache.lookup(key)
        if cached is not None:
            return key, None, cached
        return key, self.prepare_batch(docs, batch_key=batch_key), None

    def _account_cache_hit(self, records: list[ParseRecord],
                           batch_key: int | None = None) -> None:
        """Replayed batch: count the docs, charge no parse time."""
        n_exp = sum(r.parser == self.cfg.expensive for r in records)
        self.stats.n_docs += len(records)
        self.stats.n_expensive += n_exp
        self.stats.cache_hits += 1
        self.telemetry.append(BatchTelemetry(
            batch_key=batch_key, n_docs=len(records), n_expensive=n_exp,
            complete_node=-1, prepare_s=0.0, route_s=0.0, complete_s=0.0,
            cached=True))

    # -- single batch ---------------------------------------------------------

    def process_batch(self, docs: list[Document], node_id: int = 0,
                      batch_key: int | None = None) -> list[ParseRecord]:
        """Parse one batch (prepare -> route -> complete on this node).
        ``batch_key`` selects the stateless rng stream (same key -> same
        records on any node); None falls back to the engine's sequential
        stream. With a ``ResultCache`` attached, a previously-parsed
        (key, doc ids) batch is replayed instead of re-parsed."""
        key, prep, cached = self.prepare_or_lookup(docs, batch_key)
        if cached is not None:
            self._account_cache_hit(cached, batch_key)
            return cached
        plan = self.route_batch(prep)
        records = self.complete_batch(prep, plan, node_id=node_id)
        if key is not None:
            self.cache.store(key, records)
        return records

    # -- full campaign (single node) -------------------------------------------

    def run(self, docs: list[Document],
            node_id: int = 0) -> dict[int, ParseRecord]:
        bs = self.cfg.batch_size
        batches = [(b, docs[i:i + bs])
                   for b, i in enumerate(range(0, len(docs), bs))]
        out: dict[int, ParseRecord] = {}
        if self.cfg.prefetch_depth > 0:
            for recs in self._overlapped_batches(batches, node_id):
                for r in recs:
                    out[r.doc_id] = r
        else:
            for b, chunk in batches:
                for r in self.process_batch(chunk, node_id=node_id,
                                            batch_key=b):
                    out[r.doc_id] = r
        return out

    def _overlapped_batches(self, batches, node_id):
        """Prefetch-overlapped campaign: the worker thread runs the host
        prepare (cheap channel + features, and cache lookups) for batch
        i+1..i+depth while the consumer routes/completes batch i. Batch
        keys make the records identical to the sequential path."""

        pf = Prefetcher(iter(batches), depth=self.cfg.prefetch_depth,
                        transform=lambda item: self.prepare_or_lookup(
                            item[1], batch_key=item[0]))
        try:
            for key, prep, cached in pf:
                if cached is not None:
                    self._account_cache_hit(cached, key[1])
                    yield cached
                    continue
                plan = self.route_batch(prep)
                records = self.complete_batch(prep, plan, node_id=node_id)
                if key is not None:
                    self.cache.store(key, records)
                yield records
        finally:
            pf.close()

    def evaluate(self, docs: list[Document],
                 records: dict[int, ParseRecord]) -> dict:
        refs = [d.full_text() for d in docs]
        hyps = [np.concatenate(records[d.doc_id].pages)
                if records[d.doc_id].pages
                and sum(map(len, records[d.doc_id].pages))
                else np.zeros(0, np.int32) for d in docs]
        res = M.evaluate_parser(
            refs, hyps,
            ref_pages=[d.pages for d in docs],
            hyp_pages=[records[d.doc_id].pages for d in docs],
            device=self.device)
        res["throughput_docs_per_node_s"] = self.stats.throughput
        res["frac_expensive"] = self.stats.n_expensive / max(
            self.stats.n_docs, 1)
        return res
