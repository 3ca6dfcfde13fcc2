"""Block-size autotuning for the ngram_score kernel.

The knob is ``threads``, the block one document runs on (256, 512, 768
or 1024; ``csrc/ngram_score.cu`` instantiates each): the Hopper
counterpart of the JAX kernel's ``block_b`` (documents a program). Same
harness as the other two knobs (``autotune_common``): time the
candidates at a (B, max_len, max_n) probe shape on the card, cache the
winner per (shape, card), persist it when a tuning store is configured
so a warm fleet restart re-dispatches without re-sweeping. Dispatch
(``ops.ngram_bleu``) only reads a winner; it never sweeps. Every
candidate gives the default launch's BLEU bit for bit: a document's
clipped counts are integer sums, whatever the block size.

CLI (on a card): ``python -m repro_torch.kernels.ngram_score.autotune
[--b B] [--max-len L] [--tuning-dir DIR] [--json OUT]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.kernels import autotune_common, tuning_store
from repro_torch.kernels.autotune_common import TuneRecord  # re-export

KERNEL_NAME = "ngram_score"
DEFAULT_THREADS = 768
DEFAULT_CANDIDATES = (256, 512, 768, 1024)

__all__ = ["TuneRecord", "autotune_ngram_bleu", "tuned_threads",
           "ensure_tuned", "clear_cache", "DEFAULT_THREADS",
           "DEFAULT_CANDIDATES", "KERNEL_NAME"]


def tuned_threads(b: int, max_len: int, max_n: int = 4,
                  device=None) -> int:
    """The cached/stored winner for this probe shape, or the default
    (768 threads a document)."""
    return autotune_common.tuned_value(
        KERNEL_NAME, (b, max_len, max_n), DEFAULT_THREADS, device=device)


def clear_cache() -> None:
    autotune_common.clear_cache()


def _make_run(b: int, max_len: int, max_n: int, device, seed: int):
    """``make(threads)`` -> one launch over seeded random streams on the
    card (built at the first ``make``)."""
    ins: list = []

    def make(threads: int):
        import torch

        from repro_torch.kernels.ngram_score import ops

        if not ins:
            dev = torch.device("cuda" if device is None else device)
            rng = np.random.RandomState(seed)
            arrs = (rng.randint(0, 5000, (b, max_len)),
                    rng.randint(0, 5000, (b, max_len)),
                    rng.randint(1, max_len + 1, b),
                    rng.randint(1, max_len + 1, b))
            ins.extend(torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                       for a in arrs)
            ins.append(torch.empty(b, dtype=torch.float32, device=dev))

        def run():
            ops._launch(*ins, max_n=max_n, threads=threads)
        return run
    return make


def _clamp_candidates(candidates) -> tuple[int, ...]:
    bad = sorted(set(int(c) for c in candidates) - set(DEFAULT_CANDIDATES))
    if bad:
        raise ValueError(f"ngram_score: threads {bad} not built; the "
                         f"kernel has {DEFAULT_CANDIDATES}")
    return tuple(sorted({int(c) for c in candidates}))


def autotune_ngram_bleu(b: int, max_len: int, *, max_n: int = 4,
                        candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                        repeats: int = 2, device=None,
                        seed: int = 0) -> TuneRecord:
    """Time every ``threads`` candidate at (b, max_len, max_n) on the
    card, cache (and, with a tuning store configured, persist) the
    winner."""
    return autotune_common.sweep(
        KERNEL_NAME, (b, max_len, max_n), "threads",
        _clamp_candidates(candidates),
        _make_run(b, max_len, max_n, device, seed),
        repeats=repeats, device=device)


def ensure_tuned(b: int, max_len: int, max_n: int = 4, *,
                 candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                 repeats: int = 1, device=None, seed: int = 0) -> int:
    """The tuned winner, sweeping-and-persisting on a miss only when a
    tuning store is configured (else the default; on a CPU ``device``
    always the default)."""
    return autotune_common.ensure_tuned(
        KERNEL_NAME, (b, max_len, max_n), "threads",
        _clamp_candidates(candidates),
        _make_run(b, max_len, max_n, device, seed),
        DEFAULT_THREADS, repeats=repeats, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ngram_score block-size autotune sweep (on a card)")
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-n", type=int, default=4)
    ap.add_argument("--candidates", type=str, default=None,
                    help="comma-separated threads candidates")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--tuning-dir", type=str, default=None,
                    help="persist the winner to this fleet-shared "
                         "tuning store")
    ap.add_argument("--json", type=str, default=None,
                    help="write the TuneRecord to this path")
    args = ap.parse_args(argv)
    if args.tuning_dir:
        tuning_store.configure(args.tuning_dir)
    cands = DEFAULT_CANDIDATES
    if args.candidates:
        cands = tuple(int(c) for c in args.candidates.split(","))
    rec = autotune_ngram_bleu(args.b, args.max_len, max_n=args.max_n,
                              candidates=cands, repeats=args.repeats)
    print(f"ngram_score autotune @ (b={args.b}, max_len={args.max_len}, "
          f"max_n={args.max_n}) [{rec.backend} device]")
    for threads, t in rec.timings_s:
        tag = "  <-- winner" if threads == rec.value else ""
        print(f"  threads={threads:<6d} {t * 1e3:8.5f} ms{tag}")
    if args.tuning_dir:
        tuning_store.get_store().flush()
        print(f"winner persisted to {args.tuning_dir}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses.asdict(rec), f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
