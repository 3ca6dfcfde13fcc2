"""Input pipeline: sharded, prefetched, deterministically resumable.

Design (maps the paper's node-local ZIP-aggregation I/O strategy onto the
TPU input path):
- batches are produced *statelessly* from (seed, step, shard) so restart
  resumes exactly where the checkpoint left off — no loader state to save
  beyond the step counter;
- a double-buffered background thread overlaps host batch synthesis /
  decode with device compute (the host-side analogue of compute/comm
  overlap);
- documents are length-bucketed and packed so jitted steps see a single
  static shape per bucket.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def stateless_rng(seed: int, step: int, shard: int = 0) -> np.random.RandomState:
    # splitmix-style mixing of (seed, step, shard) into a 32-bit stream key
    x = (seed * 0x9E3779B1 + step * 0x85EBCA77 + shard * 0xC2B2AE3D) \
        & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    return np.random.RandomState(x or 1)


class BatchSource:
    """Stateless batch factory: fn(step, rng) -> pytree of np arrays."""

    def __init__(self, fn: Callable[[int, np.random.RandomState], dict],
                 seed: int = 0, shard: int = 0, start_step: int = 0):
        self.fn = fn
        self.seed = seed
        self.shard = shard
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.fn(self.step, stateless_rng(self.seed, self.step,
                                             self.shard))
        self.step += 1
        return b


def batches_for_indices(docs, batch_size: int, indices) -> list[dict]:
    """Materialized work-queue items for the given *global* batch
    indices: each item carries its global ``batch_key`` so any node (or
    any round of an adaptive campaign) reproduces the batch's stateless
    rng stream no matter where or when it runs."""
    return [{"batch_key": int(g),
             "docs": docs[g * batch_size:(g + 1) * batch_size]}
            for g in indices]


class Prefetcher:
    """Double-buffered background prefetch (depth-``depth`` queue).

    Exceptions raised in the worker thread (source or transform) are
    re-raised on the consumer's next ``__next__`` — never swallowed,
    never a hang. After exhaustion (or ``close``) every further
    ``__next__`` raises StopIteration. ``close`` is idempotent and safe
    to call concurrently with a blocked worker."""

    def __init__(self, source, depth: int = 2, transform=None):
        self.source = iter(source)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.transform = transform or (lambda x: x)
        self._done = object()
        self._error: BaseException | None = None
        self._finished = False
        self._closed = False
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self.q.put(self.transform(item))
        except StopIteration:
            pass
        except BaseException as e:       # propagate to the consumer
            self._error = e
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self.q.get()
        if item is self._done:
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def _drain(self):
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._finished = True
        self._stop.set()
        # unblock a worker stuck on a full queue, then let it exit; the
        # worker may refill the queue once more before seeing the stop
        # flag, so drain until it is gone (bounded — daemon thread)
        for _ in range(200):
            if not self.thread.is_alive():
                break
            self._drain()
            self.thread.join(timeout=0.01)
        self._drain()


# ---------------------------------------------------------------------------
# Length bucketing / packing (document streams)
# ---------------------------------------------------------------------------


def bucket_by_length(lengths: np.ndarray,
                     boundaries: list[int]) -> np.ndarray:
    """Assign each doc to the smallest bucket whose boundary fits it."""
    return np.digitize(lengths, boundaries)


def pack_documents(docs: list[np.ndarray], seq_len: int,
                   pad_id: int = 0, eos_id: int = 1) -> np.ndarray:
    """Greedy first-fit packing of token sequences into (n, seq_len) rows
    separated by EOS — pad-free training the way trillion-token pipelines
    do it (the paper's motivating workload)."""
    rows: list[list[int]] = []
    space: list[int] = []
    for d in docs:
        d = list(np.asarray(d).ravel()[:seq_len - 1]) + [eos_id]
        placed = False
        for i in range(len(rows)):
            if space[i] >= len(d):
                rows[i].extend(d)
                space[i] -= len(d)
                placed = True
                break
        if not placed:
            rows.append(list(d))
            space.append(seq_len - len(d))
    out = np.full((len(rows), seq_len), pad_id, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def lm_stream(vocab: int, batch: int, seq_len: int, seed: int = 0,
              shard: int = 0, start_step: int = 0) -> BatchSource:
    """Synthetic LM token stream (Zipf-ish)."""

    def fn(step, rng):
        toks = (rng.zipf(1.3, size=(batch, seq_len + 1)) + 9)
        toks = np.minimum(toks, vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return BatchSource(fn, seed, shard, start_step)
