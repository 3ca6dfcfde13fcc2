"""Grid-shape autotuning for the budget_route kernel.

The knob is ``block_rows``: the rows a block of the cooperative grid
routes in one chunk (``threads`` × 4 rows a thread; 512, 1024, 2048 or
4096), the Hopper counterpart of the JAX kernel's ``block_n``. Up to
4,096 rows one block routes the whole batch and the knob has nothing to
choose: the candidate list clamps to the one launch there is, as the
reference clamps ``block_n`` to N. Beyond, a larger chunk means fewer,
larger blocks (``ops.launch_plan``). The sweep times the candidates at a
given (N, D, capacity) shape on the card through the shared
``autotune_common`` harness and caches the winner per (shape, card);
with a tuning store configured (``serve.py --tuning-dir``) it survives
the process, and a warm fleet restart re-dispatches at the tuned grid
with zero re-sweeps. Dispatch (``ops.budget_route_kernel``) only reads
a winner; it never sweeps. Every candidate selects and copies the same
rows: the output is the default launch's bit for bit.

CLI (on a card): ``python -m repro_torch.kernels.budget_route.autotune
[--route-64k] [--tuning-dir DIR] [--json OUT]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.kernels import autotune_common, tuning_store
from repro_torch.kernels.autotune_common import TuneRecord  # re-export

KERNEL_NAME = "budget_route"
DEFAULT_BLOCK_ROWS = 512
DEFAULT_CANDIDATES = (512, 1024, 2048, 4096)
# the production routing shape (configs "adaparse-router" route_64k)
ROUTE_64K = (65536, 512)

__all__ = ["TuneRecord", "autotune_budget_route", "tuned_block_rows",
           "ensure_tuned", "clear_cache", "DEFAULT_BLOCK_ROWS",
           "DEFAULT_CANDIDATES", "ROUTE_64K", "KERNEL_NAME"]


def tuned_block_rows(n: int, d_tok: int, capacity: int,
                     device=None) -> int:
    """The cached/stored winner for this shape, or the default."""
    return autotune_common.tuned_value(
        KERNEL_NAME, (n, d_tok, capacity), DEFAULT_BLOCK_ROWS,
        device=device)


def clear_cache() -> None:
    autotune_common.clear_cache()


def _make_run(n: int, d_tok: int, capacity: int, device, seed: int):
    """``make(block_rows)`` -> one launch over seeded scores (on a 0.25
    grid: many ties at tau) and tokens on the card (built at the first
    ``make``)."""
    ins: list = []

    def make(block_rows: int):
        import torch

        from repro_torch.kernels.budget_route import ops

        if not ins:
            dev = torch.device("cuda" if device is None else device)
            g = torch.Generator(device=dev).manual_seed(seed)
            scores = torch.round(
                torch.randn(n, generator=g, device=dev) * 4) / 4
            tokens = torch.randint(0, 50000, (n, d_tok), generator=g,
                                   dtype=torch.int32, device=dev)
            tau = ops.route_tau(scores, capacity)
            out = torch.empty((capacity, d_tok), dtype=torch.int32,
                              device=dev)
            ints = torch.empty(capacity + 1, dtype=torch.int32, device=dev)
            ins.extend([scores, tokens, tau, out, ints[:capacity],
                        ints[capacity:]])
        plan = ops.launch_plan(n, ops.sm_count(ins[0].device), block_rows)
        scratch = torch.empty(ops.scratch_ints(plan[0]), dtype=torch.int32,
                              device=ins[0].device)

        def run():
            ops._launch(*ins, capacity=capacity, scratch=scratch,
                        block_rows=block_rows)
        return run
    return make


def _clamp_candidates(candidates, n: int) -> tuple[int, ...]:
    from repro_torch.kernels.budget_route.ops import SINGLE_BLOCK_ROWS

    bad = sorted(set(int(c) for c in candidates) - set(DEFAULT_CANDIDATES))
    if bad:
        raise ValueError(f"budget_route: block_rows {bad} outside "
                         f"{DEFAULT_CANDIDATES}")
    # one block routes up to SINGLE_BLOCK_ROWS rows whatever the knob
    if n <= SINGLE_BLOCK_ROWS:
        return (DEFAULT_BLOCK_ROWS,)
    return tuple(sorted({int(c) for c in candidates}))


def autotune_budget_route(n: int, d_tok: int, capacity: int, *,
                          candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                          repeats: int = 2, device=None,
                          seed: int = 0) -> TuneRecord:
    """Time every ``block_rows`` candidate at (n, d_tok, capacity) on the
    card, cache (and, when a tuning store is configured, persist) the
    winner."""
    if capacity < 1 or capacity > n:
        raise ValueError(f"capacity must be in [1, n={n}] (got {capacity})")
    return autotune_common.sweep(
        KERNEL_NAME, (n, d_tok, capacity), "block_rows",
        _clamp_candidates(candidates, n),
        _make_run(n, d_tok, capacity, device, seed),
        repeats=repeats, device=device)


def ensure_tuned(n: int, d_tok: int, capacity: int, *,
                 candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                 repeats: int = 1, device=None, seed: int = 0) -> int:
    """The tuned winner, sweeping-and-persisting on a miss only when a
    tuning store is configured (else the default; on a CPU ``device``
    always the default)."""
    return autotune_common.ensure_tuned(
        KERNEL_NAME, (n, d_tok, capacity), "block_rows",
        _clamp_candidates(candidates, n),
        _make_run(n, d_tok, capacity, device, seed),
        DEFAULT_BLOCK_ROWS, repeats=repeats, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="budget_route grid-shape autotune sweep (on a card)")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d-tok", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--route-64k", action="store_true",
                    help="sweep the production route_64k shape "
                         f"{ROUTE_64K} instead of --n/--d-tok")
    ap.add_argument("--candidates", type=str, default=None,
                    help="comma-separated block_rows candidates")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--tuning-dir", type=str, default=None,
                    help="persist the winner to this fleet-shared "
                         "tuning store")
    ap.add_argument("--json", type=str, default=None,
                    help="write the TuneRecord to this path")
    args = ap.parse_args(argv)
    if args.tuning_dir:
        tuning_store.configure(args.tuning_dir)
    n, d_tok = ROUTE_64K if args.route_64k else (args.n, args.d_tok)
    from repro_torch.kernels.budget_route.ops import capacity_floor
    capacity = max(capacity_floor(args.alpha, n), 1)
    cands = DEFAULT_CANDIDATES
    if args.candidates:
        cands = tuple(int(c) for c in args.candidates.split(","))
    rec = autotune_budget_route(n, d_tok, capacity, candidates=cands,
                                repeats=args.repeats)
    print(f"budget_route autotune @ (n={n}, d={d_tok}, cap={capacity}) "
          f"[{rec.backend} device]")
    for block_rows, t in rec.timings_s:
        tag = "  <-- winner" if block_rows == rec.value else ""
        print(f"  block_rows={block_rows:<6d} {t * 1e3:8.5f} ms{tag}")
    if args.tuning_dir:
        tuning_store.get_store().flush()
        print(f"winner persisted to {args.tuning_dir}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses.asdict(rec), f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
