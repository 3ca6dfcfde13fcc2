"""Online quality estimation + α retuning policy (§2.2 / §7.2 closed
loop) — the layer between the batched scorers (core/metrics) and the
adaptive campaign controller (core/campaign).

AdaParse's selection policy is built on *predicted* per-document
accuracy, but a campaign can also *measure* output quality online:
parser quality varies sharply by document category (arXiv 2410.09871),
so a corpus whose composition drifts mid-campaign (a hard scanned tail,
a publisher switch) silently degrades the cheap parser while α — the
expensive-parse budget — stays wherever the operator pinned it. This
module closes that loop:

- ``QualityProbe`` samples a deterministic, *batch-keyed* subset of
  completed batches (``should_probe`` is a pure function of
  (probe seed, batch key), so the same batches are probed no matter
  which node, round, or process runs them) and scores
  hypothesis-vs-reference token streams per parser with the vectorized
  ``metrics.score_batch`` — BLEU through the hand-written CUDA n-gram
  kernel (kernels/ngram_score: one block per document counts the
  clipped n-grams in shared memory), ROUGE-L / CAR through the
  batched row DPs, all behind padding + length masks. Probe
  results ride on
  ``engine.BatchTelemetry.quality``, and the probe's *cost*
  (``QualityProbeConfig.cost_s_per_doc`` node-seconds per scored doc)
  is charged to the node that completed — and therefore scored — the
  batch (``BatchTelemetry.probe_s``): the controller's throughput EWMA
  sees probe overhead instead of treating scoring as free
  measurement-plane work, so probe rate trades against throughput.
  Records are never affected, and cache replays / abandoned straggler
  attempts carry no quality (exactly like their timing is excluded
  from throughput).

- ``QualityMonitor`` aggregates probe samples into per-parser quality
  EWMAs. A round with zero fresh probe docs (an all-replay warm round,
  or α too small to route anything) reports **no signal** — the
  controller must hold α rather than retune on a stale EWMA.

- ``propose_alpha`` is the round-boundary retuning rule: move α at most
  ``alpha_step`` per round toward ``target_alpha`` — the smallest α
  inside the operator bounds whose blended expected quality
  (1−α)·q̂_cheap + α·q̂_exp meets the quality target (the cheapest
  budget that buys the target; the bound maximizing quality when none
  does). With no expensive-parser estimate yet (α so small no routed
  doc was ever probed) it raises one step, but only while quality is
  short of target — bounded exploration.

Determinism contract ("relaxed determinism"): α moves at *round
boundaries only*, every (round, α, quality) decision is recorded in
``ControllerResult.telemetry``, and replaying that trace
(``ControllerConfig.telemetry_trace``) pins the exact α trajectory —
so a recorded campaign reproduces its record set bit-identically
across restarts (cache keys embed α), while an un-replayed re-run may
diverge, at round granularity, when its quality signal differs (e.g.
warm caches produce no probe samples).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import metrics as M
from repro_torch.data.pipeline import stateless_rng

#: metrics the probe can aggregate; "mean" averages all three.
PROBE_METRICS = M.SCORE_METRICS + ("mean",)


def record_hypothesis(record) -> np.ndarray:
    """A ``ParseRecord``'s emitted pages as one hypothesis token
    stream (empty for a parser that produced nothing) — the single
    definition every quality scorer compares against references."""
    if record.pages and sum(map(len, record.pages)):
        return np.concatenate(record.pages)
    return np.zeros(0, np.int32)


@dataclasses.dataclass(frozen=True)
class QualityProbeConfig:
    """Knobs of the online quality probe."""

    probe_rate: float = 0.25         # fraction of batches sampled
    seed: int = 0                    # probe stream seed (NOT the engine's)
    max_len: int = 256               # score truncation (metrics.score_batch)
    metric: str = "bleu"             # "bleu" | "rouge" | "car" | "mean"
    # probe cost model: scoring a probed batch costs this many
    # node-seconds per document, charged to the node that completed
    # (and therefore scored) the batch. Probing is no longer free
    # measurement-plane work — the controller's throughput EWMA sees
    # the overhead, so an operator can trade probe rate against
    # throughput. Records are never affected (clock/telemetry only).
    cost_s_per_doc: float = 1e-3

    def __post_init__(self):
        if not 0.0 <= self.probe_rate <= 1.0:
            raise ValueError(f"probe_rate must be in [0, 1], got "
                             f"{self.probe_rate}")
        if self.cost_s_per_doc < 0.0:
            raise ValueError(f"probe cost_s_per_doc must be >= 0, got "
                             f"{self.cost_s_per_doc}")
        if self.max_len < 1:
            raise ValueError(f"probe max_len must be >= 1, got "
                             f"{self.max_len}")
        if self.metric not in PROBE_METRICS:
            raise ValueError(f"unknown probe metric {self.metric!r}; "
                             f"choose from {PROBE_METRICS}")


class QualityProbe:
    """Deterministic batch-keyed sampler + per-parser batch scorer.

    Sampling is a pure function of (probe seed, batch key): the probed
    subset is identical however the campaign places, re-issues, or
    prefetches its batches — the property that keeps quality telemetry
    (and therefore the α trajectory derived from it) reproducible."""

    def __init__(self, cfg: QualityProbeConfig | None = None,
                 device=None):
        self.cfg = cfg or QualityProbeConfig()
        self.device = device_lib.resolve(device)   # where batches score

    def should_probe(self, batch_key: int) -> bool:
        if self.cfg.probe_rate >= 1.0:
            return True
        if self.cfg.probe_rate <= 0.0:
            return False
        return bool(stateless_rng(self.cfg.seed, batch_key).rand()
                    < self.cfg.probe_rate)

    def score_records(self, docs, records) -> dict[str, tuple[float, int]]:
        """Score one completed batch: hypothesis (emitted pages) vs
        reference (ground-truth token stream) per document, grouped by
        the parser that produced each record. Returns
        ``{parser: (mean_quality, n_docs)}``."""
        refs: dict[str, list[np.ndarray]] = {}
        hyps: dict[str, list[np.ndarray]] = {}
        for d, r in zip(docs, records):
            refs.setdefault(r.parser, []).append(d.full_text())
            hyps.setdefault(r.parser, []).append(record_hypothesis(r))
        metric = self.cfg.metric
        wanted = M.SCORE_METRICS if metric == "mean" else (metric,)
        out: dict[str, tuple[float, int]] = {}
        for parser in refs:
            s = M.score_batch(refs[parser], hyps[parser],
                              max_len=self.cfg.max_len, metrics=wanted,
                              device=self.device)
            vals = (np.mean([s[m] for m in M.SCORE_METRICS], axis=0)
                    if metric == "mean" else s[metric])
            out[parser] = (float(np.mean(vals)), len(vals))
        return out


class QualityMonitor:
    """Per-parser online quality EWMAs fed by probe samples.

    ``update`` blends one probe observation (a batch's per-parser mean)
    into the parser's estimate; ``estimate`` is None until the parser
    has been observed at least once — the controller treats a round
    that contributed no fresh docs as *no signal* and must not retune
    from whatever stale estimates remain."""

    def __init__(self, ewma: float = 0.5):
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"quality ewma must be in (0, 1], got {ewma}")
        self.ewma = ewma
        self._est: dict[str, float] = {}
        self.n_docs: dict[str, int] = {}

    def update(self, parser: str, quality: float, n: int) -> None:
        if n <= 0:
            return
        prev = self._est.get(parser)
        self._est[parser] = (quality if prev is None
                             else (1 - self.ewma) * prev
                             + self.ewma * quality)
        self.n_docs[parser] = self.n_docs.get(parser, 0) + n

    def observe(self, quality: dict[str, tuple[float, int]] | None) -> int:
        """Feed one ``BatchTelemetry.quality`` payload; returns the
        number of probe docs absorbed (0 for unprobed/cached/abandoned
        batches, whose payload is None)."""
        if not quality:
            return 0
        n_total = 0
        for parser in sorted(quality):
            q, n = quality[parser]
            self.update(parser, q, n)
            n_total += n
        return n_total

    def estimate(self, parser: str) -> float | None:
        return self._est.get(parser)

    def snapshot(self) -> dict[str, float]:
        return dict(self._est)


def target_alpha(q_cheap: float, q_expensive: float, quality_target: float,
                 bounds: tuple[float, float]) -> float:
    """The α the retuner steers toward: the smallest α within ``bounds``
    whose blended expected quality (1−α)·q_cheap + α·q_exp meets the
    target — i.e. the cheapest budget that buys the target — clamped to
    the best-achievable bound when no α in range does (hi when the
    expensive parser helps, lo when it measures no better)."""
    lo, hi = bounds
    if q_expensive <= q_cheap:
        return lo
    if q_cheap >= quality_target:
        return lo
    need = (quality_target - q_cheap) / (q_expensive - q_cheap)
    return float(min(max(need, lo), hi))


def propose_alpha(alpha: float, monitor: QualityMonitor, cheap: str,
                  expensive: str, *, bounds: tuple[float, float],
                  step: float, quality_target: float
                  ) -> tuple[float, str]:
    """One round-boundary retuning decision: ``(new_alpha, decision)``
    with decision in {"raise", "lower", "hold", "no-signal"}. Moves at
    most ``step`` per round toward ``target_alpha`` and never leaves
    ``bounds``; with no cheap-parser estimate there is nothing to steer
    by (no-signal), and with no expensive-parser estimate it explores
    one step upward only while measured quality is short of target."""
    lo, hi = bounds
    q_c = monitor.estimate(cheap)
    q_e = monitor.estimate(expensive)
    if q_c is None:
        return alpha, "no-signal"
    if q_e is None:
        tgt = min(alpha + step, hi) if q_c < quality_target else alpha
    else:
        tgt = target_alpha(q_c, q_e, quality_target, bounds)
    new = alpha + float(np.clip(tgt - alpha, -step, step))
    new = float(min(max(new, lo), hi))
    # float-dust moves are holds: a micro-retune would still change the
    # engines' cache tags and force a full re-parse of replayable work
    if new > alpha + 1e-9:
        return new, "raise"
    if new < alpha - 1e-9:
        return new, "lower"
    return alpha, "hold"
