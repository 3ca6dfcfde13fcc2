"""Pluggable parser-backend runtime (§5, App. C).

Every parser the engine can dispatch to is a ``ParserBackend``: a bundle
of capability/cost metadata (device placement, preferred batch shape,
warm-start cost) plus the two operations the hot path needs —
``parse_batch`` and ``cost_batch``. The engine, campaign executor, and
scheduler dispatch through the registry instead of name-string
branching, so heterogeneous fleets (cheap CPU heuristics next to
expensive GPU models, the paper's core resource-scaling axis) and
user-defined backends plug in without touching the core.

The default registry wraps every ``parsers.ParserSpec`` in a
``ChannelBackend`` (the simulated corruption-channel fleet). A custom
backend only needs an ``info`` attribute and the two methods; register
it with ``register_backend`` and reference it by name from
``EngineConfig.cheap`` / ``EngineConfig.expensive``.

``ResultStore`` is the campaign result-store interface: batch-granular
records keyed by (config fingerprint, batch_key, doc ids). Because
every batch is parsed with a stateless rng stream derived from its
batch key, replaying a stored batch is bit-identical to re-parsing it —
a warm campaign reproduces the cold record set exactly while skipping
the parse work. Two implementations: ``ResultCache`` (in-process,
thread-safe dict) and ``DiskResultStore`` (content-addressed on-disk
records with LRU byte-budget eviction, so campaigns replay across
process restarts — ``serve.py --cache-dir``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import hashlib
import json
import os
import pickle
import threading
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import obs
from repro_torch.core.parsers import MEAN_PAGES, PARSER_SPECS, ParserSpec
from repro_torch.data.synthetic import CorpusConfig, Document, corrupt_documents


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """Capability/cost metadata the runtime schedules against."""

    name: str
    device: str                      # "cpu" | "gpu"
    pdf_per_sec_node: float          # single-node steady-state throughput
    warm_start_s: float = 0.0        # model-load time (15 s for ViT, §5.2)
    batch_docs: int = 256            # preferred dispatch batch (B_p analogue)
    io_bytes_per_doc: float = 2e6
    scale_cap_nodes: int = 10 ** 9   # e.g. Marker fails to scale past 10


@runtime_checkable
class ParserBackend(Protocol):
    """What the engine needs from a parser: metadata + batched parse/cost."""

    info: BackendInfo

    def parse_batch(self, docs: list[Document], cfg: CorpusConfig,
                    rng: np.random.RandomState, *, image_degraded=False,
                    text_degraded=False) -> list[list[np.ndarray]]: ...

    def cost_batch(self, docs: list[Document]) -> np.ndarray: ...


class ChannelBackend:
    """Default backend: a ``ParserSpec``'s corruption channel (the
    simulated parser fleet calibrated against Table 1 / Fig. 5)."""

    def __init__(self, spec: ParserSpec):
        self.spec = spec
        self.info = BackendInfo(
            name=spec.name,
            device="gpu" if spec.uses_gpu else "cpu",
            pdf_per_sec_node=spec.pdf_per_sec_node,
            warm_start_s=spec.warmup_s,
            batch_docs=10 if spec.uses_gpu else 256,   # page-batched B_p
            io_bytes_per_doc=spec.io_bytes_per_doc,
            scale_cap_nodes=spec.scale_cap_nodes)

    def parse_batch(self, docs, cfg, rng, *, image_degraded=False,
                    text_degraded=False):
        return corrupt_documents(docs, self.spec.channel, cfg, rng,
                                 image_degraded=image_degraded,
                                 text_degraded=text_degraded)

    def cost_batch(self, docs):
        pages = np.fromiter((d.n_pages for d in docs), np.float64,
                            count=len(docs))
        return pages / MEAN_PAGES / self.spec.pdf_per_sec_node


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


_REGISTRY: dict[str, ParserBackend] = {}


def register_backend(backend: ParserBackend,
                     overwrite: bool = False) -> ParserBackend:
    name = backend.info.name
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = backend
    return backend


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> ParserBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown parser backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


for _spec in PARSER_SPECS.values():
    register_backend(ChannelBackend(_spec))


# ---------------------------------------------------------------------------
# Campaign result stores
# ---------------------------------------------------------------------------


@runtime_checkable
class ResultStore(Protocol):
    """Batch-granular result store the engine replays campaigns from.

    Keys are (engine fingerprint, batch_key, doc ids); values are the
    emitted ``ParseRecord`` lists. Batch parsing is stateless in the
    batch key, so a replay is exactly the records a re-parse would
    produce. Implementations must be thread-safe: the executor's
    prefetch workers look batches up concurrently with the consumer
    storing results."""

    hits: int
    misses: int

    def lookup(self, key): ...

    def store(self, key, records) -> None: ...

    def flush(self) -> None: ...

    def __len__(self) -> int: ...


class ResultCache:
    """In-process ``ResultStore``: a thread-safe dict (no persistence,
    no eviction — the warm-campaign fast path within one process)."""

    def __init__(self):
        self._store: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key):
        """Records for ``key`` or None; counts a hit or a miss."""
        with self._lock:
            recs = self._store.get(key)
            if recs is None:
                self.misses += 1
                obs.metrics().count("store.misses")
            else:
                self.hits += 1
                obs.metrics().count("store.hits")
            return recs

    def store(self, key, records) -> None:
        with self._lock:
            self._store[key] = list(records)
        obs.metrics().count("store.puts")

    def flush(self) -> None:
        """Nothing buffered in-process."""

    def __len__(self) -> int:
        return len(self._store)


class DiskResultStore:
    """Content-addressed on-disk ``ResultStore``.

    Each batch's records are pickled to ``<sha256(key)>.pkl`` under
    ``cache_dir``; a sidecar index carries a logical access clock per
    entry, so LRU eviction order is a pure function of the operation
    sequence (never of filesystem mtimes) and survives process
    restarts. ``max_bytes`` bounds the total record bytes: after every
    store, least-recently-used entries are evicted until the store fits
    (the just-written entry is always retained, so a single oversized
    batch cannot wedge the store). The budget and the LRU order are
    **fleet-wide**: eviction folds the on-disk snapshot + WAL under the
    exclusive flock before choosing victims, so N processes sharing one
    dir enforce one shared ``max_bytes``, not N local ones.

    The index is a compacted snapshot (``index.json``) plus a
    write-ahead log (``index.wal``): every store / hit-bump / eviction
    appends one JSON line to the WAL — O(1) however large the store
    grows, where rewriting the full snapshot per op would scale the
    index cost with the campaign (millions of batches). Opening the
    store replays the WAL on top of the snapshot (undecodable lines —
    a torn append from a killed process — are skipped); compaction —
    rewrite the snapshot atomically, truncate the WAL — runs on
    ``flush()``, whenever eviction shrinks the entry set, and
    automatically every ``COMPACT_EVERY`` WAL ops so recovery stays
    bounded.

    **Multi-process safety** (the worker runtime shares one store dir
    across N worker processes, core/workers): WAL appends are single
    ``O_APPEND`` writes of one full line (atomic on a local
    filesystem) taken under a *shared* ``flock``; compaction takes the
    *exclusive* ``flock`` and folds the **on-disk** state — snapshot
    plus the full WAL, which includes every other process's appends —
    into the new snapshot before truncating the WAL. Two processes
    over one dir therefore never drop each other's WAL tail: an op
    another process appended between our last replay and our
    compaction is folded in, not truncated away. (Every mutation
    appends its WAL line before any compaction can run, so the disk
    state is always a superset of any process's in-memory index.)

    Because keys embed the engine's content fingerprint (router weights
    included) and batch parsing is stateless in the batch key, a warm
    campaign in a *new process* replays the cold record set
    byte-identically (``serve.py --cache-dir``)."""

    INDEX_NAME = "index.json"
    WAL_NAME = "index.wal"
    LOCK_NAME = ".index.lock"
    COMPACT_EVERY = 4096            # WAL ops between automatic compactions

    def __init__(self, cache_dir: str, max_bytes: int | None = None):
        self.dir = str(cache_dir)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        os.makedirs(self.dir, exist_ok=True)
        self._index_path = os.path.join(self.dir, self.INDEX_NAME)
        self._wal_path = os.path.join(self.dir, self.WAL_NAME)
        self._lock_path = os.path.join(self.dir, self.LOCK_NAME)
        # persistent handles: one lock fd (flock'd per op) and one
        # O_APPEND WAL fd — compaction truncates the WAL *in place*
        # (same inode), so appends through this fd stay valid across
        # any process's compactions and the per-op cost stays one
        # flock + one write instead of two open/close round-trips
        self._lock_fd = os.open(self._lock_path,
                                os.O_CREAT | os.O_RDWR, 0o644)
        self._wal_fd = os.open(self._wal_path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                               0o644)
        self._load_index()

    def close(self) -> None:
        """Release the persistent index/lock fds (safe to call twice;
        also runs at GC). The store is unusable afterwards."""
        for attr in ("_wal_fd", "_lock_fd"):
            fd = getattr(self, attr, None)
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, attr, None)

    def __del__(self):
        self.close()

    # -- index ---------------------------------------------------------------

    @contextlib.contextmanager
    def _flock(self, exclusive: bool):
        """Cross-process advisory lock on the index: shared for WAL
        appends and recovery reads, exclusive for compaction (which
        rewrites the snapshot and truncates the WAL). Intra-process
        callers are already serialized by ``self._lock``, so holding
        one lock fd per store instance is safe."""
        fcntl.flock(self._lock_fd,
                    fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)

    def _disk_sig(self):
        """Cheap change-detector for the on-disk index: the snapshot's
        (inode, size) — a compaction atomically replaces it, changing
        the inode — plus the WAL size through our O_APPEND fd.
        ``_append_wal`` advances the expected WAL size for our own
        appends, so the signature only diverges when *another* process
        publishes ops; divergence makes the next budget check fold the
        full on-disk state (a coincidental match merely defers the fold
        to whichever process does observe the divergence)."""
        try:
            st = os.stat(self._index_path)
            idx = (st.st_ino, st.st_size)
        except FileNotFoundError:
            idx = None
        return idx, os.fstat(self._wal_fd).st_size

    def _in_sync(self) -> bool:
        return self._synced_sig is not None \
            and self._disk_sig() == self._synced_sig

    def _mark_synced(self) -> None:
        self._synced_sig = self._disk_sig()

    def _read_disk_state(self) -> tuple[int, dict, int]:
        """(seq, entries, wal_ops) folded from the on-disk snapshot +
        WAL — the union of every process's published ops. ``put``
        entries whose record file is gone are skipped; undecodable WAL
        lines (torn appends from a killed process) are skipped, not
        treated as end-of-log, so one crash cannot hide other
        processes' later appends."""
        entries: dict[str, list[int]] = {}   # digest -> [seq, bytes]
        try:
            with open(self._index_path) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            data = {}
        seq = int(data.get("seq", 0))
        for digest, (s, nbytes) in data.get("entries", {}).items():
            if os.path.exists(self._record_path(digest)):
                entries[digest] = [int(s), int(nbytes)]
        wal_ops = 0
        try:
            f = open(self._wal_path)
        except FileNotFoundError:
            return seq, entries, 0
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except json.JSONDecodeError:
                    continue
                kind, digest = op.get("op"), op.get("d")
                s = int(op.get("s", seq))
                seq = max(seq, s)
                if kind == "put":
                    if os.path.exists(self._record_path(digest)):
                        entries[digest] = [s, int(op["b"])]
                elif kind == "hit":
                    if digest in entries:
                        entries[digest][0] = s
                elif kind == "del":
                    entries.pop(digest, None)
                wal_ops += 1
        return seq, entries, wal_ops

    def _load_index(self) -> None:
        with self._flock(exclusive=False):
            # sig first: an append racing in after the stat makes the
            # signature read stale (forcing a refold), never fresh
            sig = self._disk_sig()
            self._seq, self._entries, self._wal_ops = \
                self._read_disk_state()
        self._synced_sig = sig

    def _append_wal(self, op: dict) -> None:
        # one full line per op in a single O_APPEND write: atomic on a
        # local fs, so concurrent processes never interleave mid-line.
        # The shared flock fences against a concurrent compaction
        # truncating the WAL between our write and its fold-in.
        line = (json.dumps(op) + "\n").encode()
        with self._flock(exclusive=False):
            os.write(self._wal_fd, line)
        self._wal_ops += 1
        if self._synced_sig is not None:
            idx, wal = self._synced_sig
            self._synced_sig = (idx, wal + len(line))

    def _save_index(self) -> None:
        """Compaction: fold the **on-disk** snapshot + WAL (every
        process's published ops, not just ours) into a fresh snapshot,
        truncate the WAL, and adopt the merged view as our in-memory
        index. Runs under the exclusive flock so no other process can
        append between the fold and the truncate."""
        with self._flock(exclusive=True):
            seq, entries, _ = self._read_disk_state()
            self._seq = max(self._seq, seq)
            self._entries = entries
            tmp = self._index_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"seq": self._seq, "entries": self._entries}, f)
            os.replace(tmp, self._index_path)
            open(self._wal_path, "w").close()
            self._mark_synced()
        self._wal_ops = 0

    def _record_path(self, digest: str) -> str:
        return os.path.join(self.dir, digest + ".pkl")

    @staticmethod
    def _digest(key) -> str:
        # repr of the key tuple (config fingerprint, batch_key, doc ids)
        # is stable across processes: ints, floats (shortest round-trip
        # repr), strings, bools, tuples only
        return hashlib.sha256(repr(key).encode()).hexdigest()

    # -- ResultStore protocol ------------------------------------------------

    def lookup(self, key):
        """Records for ``key`` or None; counts a hit or a miss and bumps
        the entry's LRU clock on hit (one appended WAL line — the
        snapshot is never rewritten per lookup)."""
        digest = self._digest(key)
        with self._lock:
            ent = self._entries.get(digest)
            if ent is None:
                self.misses += 1
                obs.metrics().count("store.misses")
                return None
            try:
                with open(self._record_path(digest), "rb") as f:
                    blob = f.read()
            except FileNotFoundError:       # evicted behind our back
                del self._entries[digest]
                self._append_wal({"op": "del", "d": digest})
                self.misses += 1
                obs.metrics().count("store.misses")
                return None
            self._seq += 1
            ent[0] = self._seq
            self.hits += 1
            obs.metrics().count("store.hits")
            self._append_wal({"op": "hit", "d": digest, "s": self._seq})
            if self._wal_ops >= self.COMPACT_EVERY:
                self._save_index()
            return pickle.loads(blob)

    def store(self, key, records) -> None:
        digest = self._digest(key)
        blob = pickle.dumps(list(records), protocol=4)
        with self._lock:
            # tmp + rename: a concurrent reader in another worker
            # process sees the old complete record or the new complete
            # record, never a torn pickle (records are deterministic in
            # the key, so either version is the same payload)
            path = self._record_path(digest)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
            self._seq += 1
            self._entries[digest] = [self._seq, len(blob)]
            self._append_wal({"op": "put", "d": digest, "s": self._seq,
                              "b": len(blob)})
            obs.metrics().count("store.puts")
            if not self._evict(keep=digest) \
                    and self._wal_ops >= self.COMPACT_EVERY:
                self._save_index()

    def _evict(self, keep: str | None = None) -> bool:
        """Drop least-recently-used entries until under ``max_bytes``.
        Deterministic: order follows the logical clock, never mtimes.
        ``keep`` (the just-written digest) is never chosen as victim.

        The byte total and the LRU victim choice are **fleet-wide**:
        the local in-memory view alone would let N workers sharing one
        dir overshoot ``max_bytes`` by ~N× and evict against a stale
        clock. When the local view may be stale (another process
        published ops since our last sync — ``_disk_sig`` diverged) or
        is over budget, fold the on-disk snapshot + WAL under the
        exclusive flock (``_read_disk_state``), choose victims from
        the merged view, and compact inline: the folded-and-evicted
        view *is* the new snapshot, so no ``del`` WAL lines and no
        separate compaction pass are needed. Evicted ``.pkl`` files
        another process still indexes surface there as the
        evicted-behind-our-back miss path in ``lookup``."""
        if self.max_bytes is None:
            return False
        if self._in_sync() and \
                sum(b for _, b in self._entries.values()) <= self.max_bytes:
            return False                 # sole recent writer, under budget
        with self._flock(exclusive=True):
            seq, entries, wal_ops = self._read_disk_state()
            self._seq = max(self._seq, seq)
            self._entries = entries
            total = sum(b for _, b in entries.values())
            if total <= self.max_bytes:
                # stale signature only: adopt the merged view as-is
                self._wal_ops = wal_ops
                self._mark_synced()
                return False
            evicted = False
            while total > self.max_bytes:
                victims = [d for d in entries if d != keep]
                if not victims:
                    break
                victim = min(victims, key=lambda d: entries[d][0])
                total -= entries[victim][1]
                del entries[victim]
                evicted = True
                obs.metrics().count("store.evictions")
                try:
                    os.remove(self._record_path(victim))
                except FileNotFoundError:
                    pass
            tmp = self._index_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"seq": self._seq, "entries": self._entries}, f)
            os.replace(tmp, self._index_path)
            open(self._wal_path, "w").close()
            self._wal_ops = 0
            self._mark_synced()
        return evicted

    def flush(self) -> None:
        """Compact: fold outstanding WAL ops into the snapshot."""
        with self._lock:
            if self._wal_ops:
                self._save_index()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        """Fleet-wide record bytes: when another process has published
        ops since our last sync, fold the on-disk snapshot + WAL first
        (shared flock), so the total a caller checks against
        ``max_bytes`` is the same total eviction enforces — not a
        per-process undercount."""
        with self._lock:
            if not self._in_sync():
                self._load_index()
            return sum(b for _, b in self._entries.values())
