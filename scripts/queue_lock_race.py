"""Show the hazard behind fault 3i: a process that exits while its
``multiprocessing.Queue`` feeder thread holds the queue's write lock
leaves that lock taken, and every other process writing to the queue
stops.

    python scripts/queue_lock_race.py [--trials 20] [--flush]

Each trial starts two spawned writers on one queue: a "crasher" whose
heartbeat thread puts 2 kB messages without pause and which calls
``os._exit`` after a random 0.05-0.3 s, and a "survivor" that puts 400
numbered messages 5 ms apart. The parent reads for up to 6 s and counts
the trials in which the survivor's last message never arrived. With
``--flush`` the crasher first stops its heartbeat thread and lets the
feeder write out what it holds (``close`` and ``join_thread``), as the
port's worker does before an injected crash
(``repro_torch/launch/worker_main._crash_exit``). Imports nothing of
the repository.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import random
import threading
import time


def crasher(q, seed: int, flush: bool) -> None:
    random.seed(seed)
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            q.put(b"h" * 2000)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    time.sleep(random.uniform(0.05, 0.3))
    if flush:
        stop.set()
        t.join()
        q.close()
        q.join_thread()
    os._exit(3)


def survivor(q) -> None:
    for i in range(400):
        q.put(("alive", i))
        time.sleep(0.005)


def trial(ctx, seed: int, flush: bool) -> bool:
    """True when the survivor's last message arrived."""
    q = ctx.Queue()
    a = ctx.Process(target=crasher, args=(q, seed, flush))
    b = ctx.Process(target=survivor, args=(q,))
    a.start()
    b.start()
    last, t0 = -1, time.time()
    while time.time() - t0 < 6.0 and last < 399:
        try:
            m = q.get(timeout=0.5)
        except queue.Empty:
            continue
        if isinstance(m, tuple):
            last = m[1]
    for p in (a, b):
        p.kill()
        p.join(timeout=5.0)
    q.cancel_join_thread()
    return last == 399


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--flush", action="store_true",
                    help="let the crasher's feeder finish before it exits")
    args = ap.parse_args(argv)
    ctx = mp.get_context("spawn")
    cut = sum(not trial(ctx, s, args.flush) for s in range(args.trials))
    print(f"trials {args.trials}, flush {args.flush}: the survivor was "
          f"cut off in {cut}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
