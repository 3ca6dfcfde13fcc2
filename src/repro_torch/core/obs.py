"""Fleet-wide observability plane: spans, metrics, exporters.

Tracing is off by default and provably cheap when off: the module-level
recorder starts as a :class:`NoopRecorder` whose ``span`` is a
constant-time no-op, and instrumentation sites guard timestamp work
behind ``recorder().enabled``. Metrics counters stay always-on — they
are plain-int dict adds on control-plane paths only, never inside a
per-document loop.

Spans never cross the process boundary through new channels: each
worker records into a bounded ring (``collections.deque`` with
``maxlen`` — appends are GIL-atomic, so the task loop and the heartbeat
thread share it lock-free) and drains a bounded slice into the
``spans`` field piggybacked on outgoing ``BatchDone``/``Heartbeat``
messages. Overflow evicts oldest and is drop-counted; nothing ever
blocks the hot path.

Histograms use fixed log2 buckets so cross-process folding is exact:
bucket ``i`` counts observations in
``[2**(i+MIN_EXP), 2**(i+1+MIN_EXP))`` seconds, and merging snapshots
from any number of processes is element-wise addition with no
re-binning error.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import asdict, dataclass
from pathlib import Path

# ---------------------------------------------------------------- spans

#: canonical span names; anything else still records but gets no color.
#: "complete" is the coordinator-emitted *winning* completion (exactly
#: one per emitted batch — the span-conservation invariant); "reparse"
#: is the engine's expensive-stage timing, of which losing re-issue
#: attempts may emit extras.
SPAN_STAGES = ("prepare", "route", "complete", "reparse", "probe",
               "cache_lookup", "forward", "reissue", "dedup", "round",
               "scenario", "join", "leave", "admission_rejected")

#: chrome://tracing reserved color names per stage
_CNAME = {
    "prepare": "thread_state_running",
    "route": "thread_state_runnable",
    "complete": "cq_build_passed",
    "reparse": "thread_state_iowait",
    "probe": "light_memory_dump",
    "cache_lookup": "good",
    "forward": "generic_work",
    "reissue": "bad",
    "dedup": "terrible",
    "round": "vsync_highlight_color",
    "scenario": "black",
    # fabric membership lifecycle (core/fabric): one `join` per
    # admission, one `leave` per lost connection, one
    # `admission_rejected` per refused dialer — #join - #leave equals
    # the live fleet delta (the fabric conservation law)
    "join": "cq_build_attempt_passed",
    "leave": "cq_build_attempt_failed",
    "admission_rejected": "cq_build_failed",
}

#: chrome trace thread ids must be non-negative; the coordinator
#: (node -1) gets its own high lane
_COORD_TID = 999


@dataclass
class Span:
    """One timed (or instant, ``dur == 0``) event in a campaign."""

    name: str
    trace: str          # trace id — the batch key, or a synthetic id
    node: int           # global node id; -1 = coordinator
    pid: int            # OS pid of the recording process
    start: float        # epoch seconds (time.time), cross-process
    dur: float          # seconds; 0 renders as an instant event
    attempt: int = 0
    cached: bool = False
    abandoned: bool = False
    detail: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(**d)


class NoopRecorder:
    """Default recorder: every call is a constant-time no-op."""

    enabled = False
    node = -1
    recorded = 0
    shipped = 0
    dropped = 0

    def span(self, name, trace, start, dur, node=None, attempt=0,
             cached=False, abandoned=False, detail=""):
        return None

    def drain(self, limit=None):
        return []


class RingRecorder:
    """Lock-free bounded span ring for one process.

    ``deque(maxlen=cap)`` appends are GIL-atomic, so the worker task
    loop, the heartbeat thread, and prefetch threads share one ring
    without a lock. When full, the oldest span is silently evicted and
    surfaces in :attr:`dropped` — recording never blocks.
    """

    enabled = True

    def __init__(self, cap: int = 8192, node: int = -1):
        self.cap = int(cap)
        self.node = int(node)
        self.pid = os.getpid()
        self._ring: deque = deque(maxlen=self.cap)
        self.recorded = 0
        self.shipped = 0

    def span(self, name, trace, start, dur, node=None, attempt=0,
             cached=False, abandoned=False, detail=""):
        self._ring.append(Span(
            name=name, trace=str(trace),
            node=self.node if node is None else int(node),
            pid=self.pid, start=float(start), dur=float(dur),
            attempt=int(attempt), cached=bool(cached),
            abandoned=bool(abandoned), detail=detail))
        self.recorded += 1

    def drain(self, limit=None):
        """Pop up to ``limit`` spans (all if None) oldest-first."""
        out = []
        n = len(self._ring)
        if limit is not None:
            n = min(int(limit), n)
        for _ in range(n):
            try:
                out.append(self._ring.popleft())
            except IndexError:    # raced another drainer; ring is empty
                break
        self.shipped += len(out)
        return out

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.shipped - len(self._ring))


# -------------------------------------------------------------- metrics

N_BUCKETS = 34
MIN_EXP = -20          # bucket 0 starts at 2**-20 s ≈ 0.95 µs


def _bucket(v: float) -> int:
    if v <= 0.0:
        return 0
    _, e = math.frexp(v)             # v = m * 2**e with m in [0.5, 1)
    return min(N_BUCKETS - 1, max(0, e - 1 - MIN_EXP))


def bucket_bounds() -> list:
    """Upper bounds (seconds) of each bucket, for exporters."""
    return [2.0 ** (i + 1 + MIN_EXP) for i in range(N_BUCKETS)]


class Histogram:
    """Fixed-log2-bucket latency histogram; merges exactly."""

    __slots__ = ("counts", "sum", "total")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.sum = 0.0
        self.total = 0

    def observe(self, v: float):
        self.counts[_bucket(v)] += 1
        self.sum += v
        self.total += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile: geometric midpoint of the bucket that
        crosses the target rank (exact to within one log2 bucket)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                lo = 2.0 ** (i + MIN_EXP)
                return lo * math.sqrt(2.0)
        return 2.0 ** (N_BUCKETS + MIN_EXP)


class Registry:
    """Per-process metrics registry: counters, gauges, histograms."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, v: float):
        self.gauges[name] = float(v)

    def observe(self, name: str, v: float):
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(v)

    def snapshot(self) -> dict:
        """Plain-dict copy, picklable, safe to ship over a queue."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: {"counts": list(h.counts), "sum": h.sum,
                          "total": h.total}
                      for k, h in self.hists.items()},
        }


def _empty_snapshot() -> dict:
    return {"counters": {}, "gauges": {}, "hists": {}}


def fold(snapshots) -> dict:
    """Merge per-process snapshots fleet-wide: counters and histogram
    buckets add exactly; gauges are last-write-wins (they are keyed
    per node, so distinct processes never collide)."""
    out = _empty_snapshot()
    for s in snapshots:
        if not s:
            continue
        for k, v in s.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        out["gauges"].update(s.get("gauges", {}))
        for k, h in s.get("hists", {}).items():
            t = out["hists"].setdefault(
                k, {"counts": [0] * N_BUCKETS, "sum": 0.0, "total": 0})
            t["counts"] = [a + b for a, b in zip(t["counts"], h["counts"])]
            t["sum"] += h["sum"]
            t["total"] += h["total"]
    return out


def diff(snap: dict, base: dict) -> dict:
    """Subtract a baseline snapshot taken at run start, so a registry
    reused across runs in one process reports this run only."""
    out = _empty_snapshot()
    bc = base.get("counters", {})
    for k, v in snap.get("counters", {}).items():
        d = v - bc.get(k, 0)
        if d:
            out["counters"][k] = d
    out["gauges"] = dict(snap.get("gauges", {}))
    bh = base.get("hists", {})
    for k, h in snap.get("hists", {}).items():
        b = bh.get(k, {"counts": [0] * N_BUCKETS, "sum": 0.0, "total": 0})
        total = h["total"] - b["total"]
        if total <= 0:
            continue
        out["hists"][k] = {
            "counts": [a - x for a, x in zip(h["counts"], b["counts"])],
            "sum": h["sum"] - b["sum"], "total": total}
    return out


# ------------------------------------------------------------ exporters

def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_text(folded: dict) -> str:
    """Render a folded snapshot as Prometheus text exposition format."""
    lines = []
    for k in sorted(folded.get("counters", {})):
        n = f"adaparse_{_sanitize(k)}"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n}_total {folded['counters'][k]}")
    for k in sorted(folded.get("gauges", {})):
        n = f"adaparse_{_sanitize(k)}"
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {folded['gauges'][k]}")
    bounds = bucket_bounds()
    for k in sorted(folded.get("hists", {})):
        h = folded["hists"][k]
        n = f"adaparse_{_sanitize(k)}"
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for i, c in enumerate(h["counts"]):
            cum += c
            if c:
                lines.append(f'{n}_bucket{{le="{bounds[i]:.6g}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["total"]}')
        lines.append(f"{n}_sum {h['sum']:.9g}")
        lines.append(f"{n}_count {h['total']}")
    return "\n".join(lines) + "\n"


class TraceWriter:
    """Emit the two trace artifacts for a run directory:

    - ``spans.jsonl``: one JSON span per line (replayable, the source
      of truth for span-conservation checks), plus a trailing
      ``{"meta": ...}`` line with drop counts;
    - ``trace.json``: Chrome ``trace_event`` JSON — one lane per
      worker (tid = node id, coordinator on its own lane),
      stage-colored, loadable in chrome://tracing or Perfetto.
    """

    def __init__(self, trace_dir):
        self.dir = Path(trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.spans_path = self.dir / "spans.jsonl"
        self.chrome_path = self.dir / "trace.json"

    def write(self, spans, dropped: int = 0) -> Path:
        spans = list(spans)
        with open(self.spans_path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict()) + "\n")
            f.write(json.dumps({"meta": {"n_spans": len(spans),
                                         "dropped": dropped}}) + "\n")
        events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                   "args": {"name": "adaparse campaign"}}]
        for node in sorted({s.node for s in spans}):
            tid = _COORD_TID if node < 0 else node
            label = "coordinator" if node < 0 else f"worker {node}"
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": label}})
        for s in spans:
            ev = {"name": s.name, "cat": s.name, "pid": 0,
                  "tid": _COORD_TID if s.node < 0 else s.node,
                  "ts": s.start * 1e6,
                  "args": {"trace": s.trace, "attempt": s.attempt,
                           "cached": s.cached, "abandoned": s.abandoned,
                           "detail": s.detail, "pid": s.pid}}
            if s.dur > 0:
                ev["ph"] = "X"
                ev["dur"] = s.dur * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            cname = _CNAME.get(s.name)
            if cname:
                ev["cname"] = cname
            events.append(ev)
        with open(self.chrome_path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return self.chrome_path


def load_spans(trace_dir):
    """Replay ``spans.jsonl`` from a trace dir -> (spans, meta)."""
    path = Path(trace_dir) / "spans.jsonl"
    spans, meta = [], {}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if "meta" in d:
                meta = d["meta"]
            else:
                spans.append(Span.from_dict(d))
    return spans, meta


def status_line(docs_per_s: float, alpha: float, cache_hits: int,
                cache_misses: int, in_flight: int, reissued: int,
                done: int, total: int) -> str:
    """The one-line live status `serve.py --status-interval` prints."""
    lookups = cache_hits + cache_misses
    hit = (100.0 * cache_hits / lookups) if lookups else 0.0
    return (f"[status] {done}/{total} batches  {docs_per_s:7.1f} docs/s"
            f"  alpha={alpha:.3f}  cache {hit:4.1f}%"
            f"  in-flight {in_flight}  reissued {reissued}")


# ------------------------------------------------------ process globals

_recorder = NoopRecorder()
_registry = Registry()


def recorder():
    return _recorder


def metrics() -> Registry:
    return _registry


def configure(enabled: bool = False, cap: int = 8192, node: int = -1):
    """(Re)install this process's recorder. Called once per worker
    process at startup and once per run by the coordinator; installing
    a fresh ring discards spans from any earlier run in this process."""
    global _recorder
    _recorder = RingRecorder(cap=cap, node=node) if enabled \
        else NoopRecorder()
    return _recorder


def now() -> float:
    return time.time()
