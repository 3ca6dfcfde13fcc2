"""The elastic fabric scenario's join, as a timeline of its moments.

    PYTHONPATH=src python scripts/join_timeline.py \
        --runs 16 [--device cpu] [--out DIR]

A diagnostic kept beside the package, not in it. Runs the
``elastic_join_leave`` scenario ``--runs`` times with the
observability plane on and prints one JSON line per run: seconds from
the first round's start to each round's end, to the joiner's launch
(``join_spawn``), its admission (``join``) and its ready heartbeat
(``join_ready``), to the crashed worker's leave, and to every re-issued
or re-routed batch with the node it was handed to; the batches each
node completed in each round; and whether the joiner served a batch
(``JoinNotExercised`` is caught and reported, a record mismatch is
not). The last line sums the runs up. ``--out`` keeps each run's span
log (default: a temporary directory).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from collections import Counter

from repro_torch.core import obs
from repro_torch.core.scenarios import (SCENARIOS, JoinNotExercised,
                                        run_scenario)

#: the spans that place the join against the campaign's work
MOMENTS = ("join_spawn", "join", "join_ready", "leave", "reissue",
           "reroute")


def timeline(spans: list[obs.Span]) -> dict:
    """One run's span log -> its join timeline (see the module doc)."""
    rounds = sorted((s for s in spans if s.name == "round"),
                    key=lambda s: s.start)
    t0 = rounds[0].start if rounds else min(s.start for s in spans)
    ends = [s.start + s.dur for s in rounds]

    def round_of(t: float) -> int:
        return next((r for r, e in enumerate(ends) if t <= e), len(ends))

    events = [{"span": s.name, "t": round(s.start - t0, 4),
               "round": round_of(s.start), "node": s.node,
               "batch": s.trace}
              for s in sorted(spans, key=lambda s: s.start)
              if s.name in MOMENTS]
    done = Counter((round_of(s.start + s.dur), s.node)
                   for s in spans if s.name == "complete")
    return {"round_end": [round(e - t0, 4) for e in ends],
            "events": events,
            "completed": {f"r{r}": {f"n{n}": c for (rr, n), c
                                    in sorted(done.items()) if rr == r}
                          for r in range(len(ends))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="keep each run's span log under DIR/runN")
    args = ap.parse_args(argv)
    spec = SCENARIOS["elastic_join_leave"]
    tmp = None
    out = args.out
    if out is None:
        tmp = tempfile.TemporaryDirectory(prefix="join-timeline-")
        out = tmp.name
    served = 0
    try:
        for i in range(args.runs):
            tdir = os.path.join(out, f"run{i}")
            try:
                res = run_scenario(spec, trace_dir=tdir,
                                   device=args.device)
                ok, wall = True, res.wall_s
            except JoinNotExercised:
                ok, wall = False, None
            spans, _ = obs.load_spans(tdir)
            served += ok
            print(json.dumps({"run": i, "joiner_served": ok,
                              "wall_s": wall, **timeline(spans)}),
                  flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()
    print(json.dumps({"runs": args.runs, "joiner_served": served}))
    return 0 if served == args.runs else 1


if __name__ == "__main__":
    raise SystemExit(main())
