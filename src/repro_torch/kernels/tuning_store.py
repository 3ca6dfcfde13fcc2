"""Disk-backed, fleet-shared kernel tuning store.

Autotune sweeps (``kernels/autotune_common``) are expensive relative to
the kernels they tune — a candidate grid at a production shape costs
seconds, the tuned call costs microseconds — and before this store every
winner lived in a per-process dict that died with its worker. The store
makes the tuned block tables a persistent, fleet-wide asset: N worker
processes share one ``--tuning-dir``, the first process to sweep a
(kernel, shape, backend, device) key publishes the winner, and every
later process — including a whole warm fleet restart — reads it back
instead of re-sweeping.

On-disk layout mirrors ``backends.DiskResultStore``'s index idiom (the
proven multi-process WAL protocol, not a new one):

* every ``put`` appends **one full JSON line** to ``tuning.wal`` via a
  single ``O_APPEND`` write (atomic on a local filesystem) under a
  *shared* ``flock`` — concurrent sweepers never interleave mid-line,
  and the shared lock fences against a concurrent compaction truncating
  the WAL between the write and its fold-in;
* compaction (``flush()`` / every ``COMPACT_EVERY`` ops) takes the
  *exclusive* ``flock`` and folds the **on-disk** snapshot
  (``tuning.json``) plus the full WAL — every other process's appends
  included — into a fresh snapshot (tmp + ``os.replace``) before
  truncating the WAL, so two processes never drop each other's tail;
* undecodable WAL lines (a torn append from a killed process) are
  skipped, not treated as end-of-log;
* reads detect staleness via the snapshot's (inode, size) + the WAL
  size (``_disk_sig``) and refold when another process has published,
  so "one process sweeps while another reads" converges without any
  coordination beyond the flock.

Records are plain JSON dicts keyed by a ``kernel|shape|backend|mode``
string (see ``autotune_common.store_key``). Last write wins — winners
are deterministic enough in practice that either is fine, and timing
jitter between two sweeps of the same shape is not worth arbitrating.

``configure(dir)`` installs a process-global store (what
``serve.py --tuning-dir`` and ``WorkerSpec.tuning_dir`` call); the
autotune caches consult it transparently via ``get_store()``.
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import os
import threading


class TuningStore:
    """One tuning-table directory, shareable across processes."""

    SNAP_NAME = "tuning.json"
    WAL_NAME = "tuning.wal"
    LOCK_NAME = ".tuning.lock"
    COMPACT_EVERY = 64              # WAL ops between automatic compactions

    def __init__(self, tuning_dir: str):
        self.dir = str(tuning_dir)
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        os.makedirs(self.dir, exist_ok=True)
        self._snap_path = os.path.join(self.dir, self.SNAP_NAME)
        self._wal_path = os.path.join(self.dir, self.WAL_NAME)
        self._lock_path = os.path.join(self.dir, self.LOCK_NAME)
        # persistent handles, as in DiskResultStore: one lock fd
        # (flock'd per op) and one O_APPEND WAL fd — compaction
        # truncates the WAL in place (same inode), so appends through
        # this fd stay valid across any process's compactions
        self._lock_fd = os.open(self._lock_path,
                                os.O_CREAT | os.O_RDWR, 0o644)
        self._wal_fd = os.open(self._wal_path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                               0o644)
        self._load()

    def close(self) -> None:
        """Release the persistent fds (safe to call twice; runs at GC).
        The store is unusable afterwards."""
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

    # -- disk protocol -------------------------------------------------------

    @contextlib.contextmanager
    def _flock(self, exclusive: bool):
        fcntl.flock(self._lock_fd,
                    fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)

    def _disk_sig(self):
        """(snapshot (inode, size), WAL size): diverges from the synced
        signature exactly when another process has published — our own
        appends advance the expected WAL size in ``_append_wal``."""
        try:
            st = os.stat(self._snap_path)
            snap = (st.st_ino, st.st_size)
        except FileNotFoundError:
            snap = None
        return snap, os.fstat(self._wal_fd).st_size

    def _in_sync(self) -> bool:
        return self._synced_sig is not None \
            and self._disk_sig() == self._synced_sig

    def _mark_synced(self) -> None:
        self._synced_sig = self._disk_sig()

    def _read_disk_state(self) -> tuple[dict, int]:
        """(records, wal_ops) folded from the on-disk snapshot + WAL —
        the union of every process's published winners. Torn WAL lines
        are skipped, not treated as end-of-log."""
        try:
            with open(self._snap_path) as f:
                records = dict(json.load(f))
        except (FileNotFoundError, json.JSONDecodeError):
            records = {}
        wal_ops = 0
        try:
            f = open(self._wal_path)
        except FileNotFoundError:
            return records, 0
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except json.JSONDecodeError:
                    continue
                key = op.get("k")
                if key is not None:
                    records[str(key)] = op.get("v")
                wal_ops += 1
        return records, wal_ops

    def _load(self) -> None:
        with self._flock(exclusive=False):
            # sig first: an append racing in after the stat makes the
            # signature read stale (forcing a refold), never fresh
            sig = self._disk_sig()
            self._records, self._wal_ops = self._read_disk_state()
        self._synced_sig = sig

    def _compact(self) -> None:
        """Fold the on-disk snapshot + WAL (every process's appends)
        into a fresh snapshot, truncate the WAL, adopt the merged view.
        Exclusive flock: no other process can append between the fold
        and the truncate."""
        with self._flock(exclusive=True):
            records, _ = self._read_disk_state()
            self._records = records
            tmp = self._snap_path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._records, f, sort_keys=True)
            os.replace(tmp, self._snap_path)
            open(self._wal_path, "w").close()
            self._mark_synced()
        self._wal_ops = 0

    # -- store API -----------------------------------------------------------

    def get(self, key: str) -> dict | None:
        """The stored record for ``key`` or None; counts a hit or a
        miss. A stale local view (another process published since our
        last sync) is refolded first, so a reader sees a concurrent
        sweeper's winners without reopening the store."""
        with self._mu:
            if not self._in_sync():
                self._load()
            rec = self._records.get(str(key))
            if rec is None:
                self.misses += 1
            else:
                self.hits += 1
            return rec

    def put(self, key: str, record: dict) -> None:
        """Publish a winner: one appended WAL line, fleet-visible
        immediately (readers refold on their next stale ``get``)."""
        line = (json.dumps({"k": str(key), "v": record}) + "\n").encode()
        with self._mu:
            with self._flock(exclusive=False):
                os.write(self._wal_fd, line)
            self._records[str(key)] = record
            self._wal_ops += 1
            if self._synced_sig is not None:
                snap, wal = self._synced_sig
                self._synced_sig = (snap, wal + len(line))
            if self._wal_ops >= self.COMPACT_EVERY:
                self._compact()

    def flush(self) -> None:
        """Compact outstanding WAL ops into the snapshot."""
        with self._mu:
            if self._wal_ops:
                self._compact()

    def keys(self) -> tuple[str, ...]:
        with self._mu:
            if not self._in_sync():
                self._load()
            return tuple(sorted(self._records))

    def __len__(self) -> int:
        with self._mu:
            if not self._in_sync():
                self._load()
            return len(self._records)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ---------------------------------------------------------------------------
# Process-global store (what serve.py / worker_main configure)
# ---------------------------------------------------------------------------


_STORE: TuningStore | None = None


def configure(tuning_dir: str | None) -> TuningStore | None:
    """Install (or, with None, remove) the process-global tuning store.
    Reconfiguring the same directory reopens it — a fresh handle with a
    cold in-memory view, which is what a restarted worker does."""
    global _STORE
    if _STORE is not None:
        _STORE.flush()
        _STORE.close()
        _STORE = None
    if tuning_dir is not None:
        _STORE = TuningStore(tuning_dir)
    return _STORE


def get_store() -> TuningStore | None:
    return _STORE


def reset() -> None:
    """Drop the global store without flushing (test isolation)."""
    global _STORE
    if _STORE is not None:
        _STORE.close()
    _STORE = None
