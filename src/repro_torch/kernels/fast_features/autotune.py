"""Block-size autotuning for the fast_features kernel.

The knob is ``threads``, the block one document runs on (128, 256 or
512; ``csrc/fast_features.cu`` instantiates each): the Hopper
counterpart of the JAX kernel's ``block_l`` (128/256/512 lanes of a row
compared a step). The sweep times every candidate at a packed
(width, max_len) shape through the shared ``autotune_common`` harness
and persists the winner when a tuning store is configured. Because
``pack_routing_batch`` quantizes widths to powers of two, a fleet sees
only O(log) distinct shapes — the first worker to meet one sweeps, the
rest (and every warm restart) read the store. Every candidate gives the
default launch's outputs bit for bit.

CLI (on a card): ``python -m repro_torch.kernels.fast_features.autotune
[--width W] [--max-len L] [--tuning-dir DIR] [--json OUT]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.kernels import autotune_common, tuning_store
from repro_torch.kernels.autotune_common import TuneRecord  # re-export

KERNEL_NAME = "fast_features"
DEFAULT_THREADS = 256
DEFAULT_CANDIDATES = (128, 256, 512)
SWEEP_DOCS = 256                       # the main path's batch of documents
SWEEP_VOCAB = 10000                    # the corpus vocabulary

__all__ = ["TuneRecord", "autotune_fast_features", "tuned_threads",
           "ensure_tuned", "clear_cache", "DEFAULT_THREADS",
           "DEFAULT_CANDIDATES", "KERNEL_NAME"]


def tuned_threads(width: int, max_len: int, device=None) -> int:
    """The cached/stored winner for this packed shape, or the default."""
    return autotune_common.tuned_value(
        KERNEL_NAME, (width, max_len), DEFAULT_THREADS, device=device)


def clear_cache() -> None:
    autotune_common.clear_cache()


def _make_run(width: int, max_len: int, device, seed: int):
    """``make(threads)`` -> one launch over a synthetic batch on the card
    (built at the first ``make``): every stream runs the full width, the
    worst case."""
    ins: list = []

    def make(threads: int):
        import torch

        from repro_torch.kernels.fast_features import ops

        if not ins:
            dev = torch.device("cuda" if device is None else device)
            rng = np.random.RandomState(seed)

            def t(a):
                return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

            tok = t(rng.randint(0, SWEEP_VOCAB, (SWEEP_DOCS, width)))
            scalars = (t(np.full(SWEEP_DOCS, width)),
                       t(rng.randint(0, width + 1, SWEEP_DOCS)),
                       t(np.full(SWEEP_DOCS, 4)),
                       t(np.zeros(SWEEP_DOCS)))
            fast = torch.empty((SWEEP_DOCS, 8), dtype=torch.float32,
                               device=dev)
            toks = mask = None
            if max_len:
                toks = torch.empty((SWEEP_DOCS, max_len), dtype=torch.int32,
                                   device=dev)
                mask = torch.empty((SWEEP_DOCS, max_len),
                                   dtype=torch.float32, device=dev)
            err = torch.zeros(1, dtype=torch.int32, device=dev)
            ins.extend([tok, *scalars, fast, toks, mask, err])

        def run():
            ops._launch(*ins, max_len=max_len, ws=2, scramble=3, mangled=4,
                        latex_lo=8010, ident_lo=8510, vocab_size=SWEEP_VOCAB,
                        bos=1, threads=threads)
        return run
    return make


def _clamp_candidates(candidates) -> tuple[int, ...]:
    bad = sorted(set(int(c) for c in candidates) - set(DEFAULT_CANDIDATES))
    if bad:
        raise ValueError(f"fast_features: threads {bad} not built; the "
                         f"kernel has {DEFAULT_CANDIDATES}")
    return tuple(sorted({int(c) for c in candidates}))


def autotune_fast_features(width: int, max_len: int = 0, *,
                           candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                           repeats: int = 2, device=None,
                           seed: int = 0) -> TuneRecord:
    """Time every ``threads`` candidate at (width, max_len) on the card,
    cache (and, with a tuning store configured, persist) the winner."""
    return autotune_common.sweep(
        KERNEL_NAME, (width, max_len), "threads",
        _clamp_candidates(candidates),
        _make_run(width, max_len, device, seed),
        repeats=repeats, device=device)


def ensure_tuned(width: int, max_len: int = 0, *,
                 candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
                 repeats: int = 1, device=None, seed: int = 0) -> int:
    """Dispatch-time hook: the tuned winner, sweeping-and-persisting on
    a miss only when a tuning store is configured (else the default;
    on a CPU ``device`` always the default)."""
    return autotune_common.ensure_tuned(
        KERNEL_NAME, (width, max_len), "threads",
        _clamp_candidates(candidates),
        _make_run(width, max_len, device, seed),
        DEFAULT_THREADS, repeats=repeats, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fast_features block-size autotune sweep (on a card)")
    ap.add_argument("--width", type=int, default=4096,
                    help="packed stream width (power of two)")
    ap.add_argument("--max-len", type=int, default=512,
                    help="encoder token window (0: features only)")
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
    rec = autotune_fast_features(args.width, args.max_len,
                                 candidates=cands, repeats=args.repeats)
    print(f"fast_features autotune @ (width={args.width}, "
          f"max_len={args.max_len}) [{rec.backend} device]")
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
