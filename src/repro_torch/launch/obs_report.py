"""Summarize a run's trace directory (``serve.py --trace-dir``).

    PYTHONPATH=src python -m repro_torch.launch.obs_report --trace-dir DIR

Replays ``spans.jsonl`` (the span log ``core/obs.TraceWriter`` wrote)
and prints:

- a per-stage latency table — count, p50/p95/p99 (exact percentiles
  over the recorded durations, not histogram-bucket estimates), and
  total busy seconds per span stage;
- a per-worker table — span count, busy seconds (work-stage spans
  only: ``prepare``/``route``/``reparse``/``probe``/``cache_lookup``),
  busy fraction of the trace window, and the stages seen on that lane;
- the re-issue cause breakdown (``crash`` / ``wedged`` / ``stalled``,
  parsed from the coordinator's ``reissue`` span details) and the
  dedup / cache-hit counts the span-conservation laws guarantee;
- fabric membership (``join`` / ``leave`` / ``admission_rejected``
  lifecycle spans) when the run used the cross-machine fabric runtime —
  remote workers show up as ordinary per-worker lanes, keyed by the
  node id the coordinator assigned at admission.

It also (re)generates the Chrome ``trace_event`` artifact from the
span log — ``--chrome-out FILE`` writes it elsewhere (default: refresh
``trace.json`` inside the trace dir), so a spans.jsonl shipped without
its sibling is still loadable in chrome://tracing or Perfetto.
"""
from __future__ import annotations

import argparse
import math
import os
import shutil
from collections import Counter, defaultdict

from repro_torch.core import obs

#: Stages whose duration is real work on a worker lane. ``complete``
#: is excluded: the coordinator attributes it to the winning worker
#: with the full batch wall, which already contains the stage spans.
WORK_STAGES = ("prepare", "route", "reparse", "probe", "cache_lookup")


def _pct(vals: list, q: float) -> float:
    """Nearest-rank percentile over the raw measured durations."""
    if not vals:
        return 0.0
    rank = max(math.ceil(q * len(vals)), 1)
    return sorted(vals)[rank - 1]


def _lane(node: int) -> str:
    return "coordinator" if node < 0 else f"worker {node}"


def summarize(spans, meta: dict | None = None) -> dict:
    """The report as a plain dict (the CLI renders it; tests assert
    on it)."""
    meta = meta or {}
    starts = [s.start for s in spans]
    ends = [s.start + s.dur for s in spans]
    window = (max(ends) - min(starts)) if spans else 0.0

    by_stage: dict[str, list] = defaultdict(list)
    by_worker: dict[int, dict] = defaultdict(
        lambda: {"spans": 0, "busy_s": 0.0, "stages": Counter()})
    causes: Counter = Counter()
    n_complete = n_dedup = n_cached = 0
    fabric: Counter = Counter()
    for s in spans:
        by_stage[s.name].append(s.dur)
        w = by_worker[s.node]
        w["spans"] += 1
        w["stages"][s.name] += 1
        if s.name in WORK_STAGES:
            w["busy_s"] += s.dur
        if s.name == "reissue":
            causes[s.detail.split(" ", 1)[0] or "unknown"] += 1
        elif s.name == "complete":
            n_complete += 1
            n_cached += bool(s.cached)
        elif s.name == "dedup":
            n_dedup += 1
        elif s.name in ("join", "leave", "admission_rejected"):
            fabric[s.name] += 1

    stages = {
        name: {"n": len(durs), "p50_s": _pct(durs, 0.50),
               "p95_s": _pct(durs, 0.95), "p99_s": _pct(durs, 0.99),
               "total_s": sum(durs)}
        for name, durs in by_stage.items()}
    workers = {
        node: {"spans": w["spans"], "busy_s": w["busy_s"],
               "busy_frac": (w["busy_s"] / window) if window else 0.0,
               "stages": dict(w["stages"])}
        for node, w in by_worker.items()}
    return {"n_spans": len(spans), "dropped": meta.get("dropped", 0),
            "window_s": window, "stages": stages, "workers": workers,
            "reissue_causes": dict(causes), "complete": n_complete,
            "complete_cached": n_cached, "dedup": n_dedup,
            "fabric": {"joins": fabric["join"], "leaves": fabric["leave"],
                       "rejected": fabric["admission_rejected"]}}


def render(rep: dict) -> str:
    out = [f"[obs] {rep['n_spans']} spans over {rep['window_s']:.2f} s "
           f"({rep['dropped']} dropped at the ring)"]
    out.append(f"{'stage':<14}{'n':>6}{'p50 ms':>10}{'p95 ms':>10}"
               f"{'p99 ms':>10}{'total s':>10}")
    order = {n: i for i, n in enumerate(obs.SPAN_STAGES)}
    for name in sorted(rep["stages"], key=lambda n: order.get(n, 99)):
        st = rep["stages"][name]
        out.append(f"{name:<14}{st['n']:>6}{st['p50_s'] * 1e3:>10.2f}"
                   f"{st['p95_s'] * 1e3:>10.2f}{st['p99_s'] * 1e3:>10.2f}"
                   f"{st['total_s']:>10.2f}")
    out.append("")
    out.append(f"{'lane':<14}{'spans':>6}{'busy s':>10}{'busy %':>8}"
               f"  stages")
    for node in sorted(rep["workers"]):
        w = rep["workers"][node]
        seen = ",".join(sorted(w["stages"]))
        out.append(f"{_lane(node):<14}{w['spans']:>6}{w['busy_s']:>10.2f}"
                   f"{w['busy_frac'] * 100:>7.1f}%  {seen}")
    out.append("")
    causes = rep["reissue_causes"]
    cause_s = (", ".join(f"{c} {n}" for c, n in sorted(causes.items()))
               if causes else "none")
    out.append(f"re-issues: {cause_s}")
    out.append(f"completes: {rep['complete']} "
               f"({rep['complete_cached']} cached)  "
               f"dedup drops: {rep['dedup']}")
    fab = rep.get("fabric") or {}
    if any(fab.values()):
        out.append(f"fabric membership: {fab['joins']} joined, "
                   f"{fab['leaves']} left, {fab['rejected']} rejected "
                   f"(live delta {fab['joins'] - fab['leaves']:+d})")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="summarize an adaparse trace directory")
    ap.add_argument("--trace-dir", required=True, metavar="DIR",
                    help="directory serve.py --trace-dir wrote "
                         "(needs spans.jsonl)")
    ap.add_argument("--chrome-out", default=None, metavar="FILE",
                    help="where to write the regenerated Chrome "
                         "trace_event JSON (default: trace.json inside "
                         "the trace dir)")
    args = ap.parse_args(argv)
    try:
        spans, meta = obs.load_spans(args.trace_dir)
    except FileNotFoundError:
        ap.error(f"no spans.jsonl under {args.trace_dir!r}; run "
                 f"serve.py with --trace-dir first")
    rep = summarize(spans, meta)
    print(render(rep))
    chrome = obs.TraceWriter(args.trace_dir).write(
        spans, dropped=meta.get("dropped", 0))
    if args.chrome_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.chrome_out)),
                    exist_ok=True)
        shutil.copyfile(chrome, args.chrome_out)
        chrome = args.chrome_out
    print(f"\nChrome trace: {chrome} (open in chrome://tracing or "
          f"https://ui.perfetto.dev)")
    return rep


if __name__ == "__main__":
    main()
