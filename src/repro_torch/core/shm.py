"""Zero-copy shared-memory transport for the process worker runtime.

Batch payloads — ingest documents, forwarded ``PreparedBatch``/plan
pairs, and result records — are numpy-array-heavy: pickling them through
the multiprocessing queues copies every page twice (dumps + pipe).
This module moves the bulk bytes through
``multiprocessing.shared_memory`` segments instead, leaving the
``PrepareTask``/``CompleteTask``/``BatchDone`` dataclasses as
control-plane messages only: a message carries a small ``ShmRef``
(arena name, slot, generation, array descriptors, and the packed
non-array structure) while the array bytes live in a fixed-layout slot.

Layout and safety:

- ``ShmArena``: one segment, ``n_slots`` fixed-size slots. Each slot is
  ``[u64 generation][u32 state][u32 pad][payload]``. The generation tag
  makes re-issue/dedup safe: every write bumps it, and a reader verifies
  it before *and* after copying out, so a straggler handed a slot that
  was reclaimed and reused (its task already completed elsewhere) gets a
  clean ``ShmStale`` instead of silently scoring the wrong batch.
- Task payloads live in one coordinator-owned arena; slots are reclaimed
  only when their task completes (first completion wins), so every
  outstanding attempt of a live task reads valid bytes.
- Results travel through one small per-worker response arena. The worker
  allocates ``STATE_FREE`` slots and flips them ``STATE_FULL`` after
  writing; the coordinator flips them back after copy-out — one writer
  per transition, no locks.
- The *coordinator* creates and unlinks every segment (workers only
  attach), so ``ProcessWorkerPool.close()`` — and the crash-recovery
  path, immediately at worker death — removes every ``/dev/shm`` entry
  even when a worker died mid-batch via ``os._exit``. Attachers never
  touch the (process-tree-shared) resource tracker: until 3.13 an
  attach also registers the name, but the tracker's cache is a set, so
  the duplicate is harmless and the creator's ``unlink()`` unregisters
  exactly once (see ``_attach``).
- Every path degrades to the inline pickled payload: ``/dev/shm``
  unavailable or too small for the arenas (one warning; the creator
  reserves a segment's pages at creation, so a small ``/dev/shm`` is
  refused there instead of failing with SIGBUS at a later write), a
  payload larger than the slot, or slot exhaustion all return ``None``
  from the encode side and the caller ships the object in the control
  message as before. Fallbacks trade speed, never correctness; the
  pool counts every payload by its carrier.

The codec is exact: dtype/shape/bytes of every array survive, scalars
and strings ride in the (pickled) header structure, so decode(encode(x))
is byte-identical — the invariant the record-parity tests assert. It
packs numpy only and refuses a torch tensor: a card tensor put on a
multiprocessing queue would travel as a CUDA IPC handle, tying the
sender's memory to the receiver and opening a CUDA context there, so
every payload is moved to the host before it leaves a worker
(``launch/worker_main._run_task``).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import warnings
from multiprocessing import shared_memory

import numpy as np
import torch

from repro_torch.core import obs

STATE_FREE = 0
STATE_FULL = 1

_HDR = 16                      # u64 generation, u32 state, u32 pad
_GEN = struct.Struct("<Q")
_STATE = struct.Struct("<I")


class ShmStale(RuntimeError):
    """The slot's generation no longer matches the ref: the task was
    completed elsewhere and the slot reclaimed. The reader's attempt is
    a loser of the first-completion race — report and drop."""


class ShmUnavailable(RuntimeError):
    """Shared memory could not be created (e.g. no usable /dev/shm)."""


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment. Until 3.13 this also registers
    with the (process-tree-shared) resource tracker; that's a set, so
    the duplicate is harmless, and the creator's ``unlink()``
    unregisters exactly once — attachers must NOT unregister themselves
    or they would strip the creator's registration."""
    return shared_memory.SharedMemory(name=name)


# ---------------------------------------------------------------------------
# Codec: python structure -> (header tree, array bytes)
# ---------------------------------------------------------------------------


def _dataclass_registry() -> dict:
    """Payload dataclasses by name (lazy: core imports stay acyclic —
    engine/scheduler never import this module)."""
    from repro_torch.core.engine import ParseRecord, PreparedBatch
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.data.synthetic import Document

    return {"Document": Document, "ParseRecord": ParseRecord,
            "PreparedBatch": PreparedBatch, "BatchPlan": BatchPlan}


_BY_NAME: dict | None = None
_BY_CLS: dict | None = None


def _registry():
    global _BY_NAME, _BY_CLS
    if _BY_NAME is None:
        _BY_NAME = _dataclass_registry()
        _BY_CLS = {cls: name for name, cls in _BY_NAME.items()}
    return _BY_NAME, _BY_CLS


def _pack(obj, arrays: list) -> tuple:
    """Strip numpy arrays out of ``obj`` into ``arrays``; the returned
    tagged tree carries everything else (and array indices)."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return ("x", obj)
    if isinstance(obj, np.ndarray):
        arrays.append(np.ascontiguousarray(obj))
        return ("np", len(arrays) - 1)
    if isinstance(obj, np.generic):            # numpy scalar, dtype-exact
        return ("ns", obj.dtype.str, obj.tobytes())
    if isinstance(obj, np.random.RandomState):
        return ("rs", _pack(obj.get_state(legacy=True), arrays))
    if isinstance(obj, list):
        return ("li", [_pack(v, arrays) for v in obj])
    if isinstance(obj, tuple):
        return ("tu", [_pack(v, arrays) for v in obj])
    if isinstance(obj, dict):
        return ("di", [(_pack(k, arrays), _pack(v, arrays))
                       for k, v in obj.items()])
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"shm codec cannot pack a torch.Tensor (device "
            f"{obj.device}, dtype {obj.dtype}): payloads cross a process "
            f"boundary as host numpy only — move it with "
            f"t.cpu().numpy() where the payload is built")
    _, by_cls = _registry()
    name = by_cls.get(type(obj))
    if name is not None:
        return ("dc", name,
                [_pack(getattr(obj, f.name), arrays)
                 for f in dataclasses.fields(obj)])
    raise TypeError(f"shm codec cannot pack {type(obj).__name__}; "
                    f"register the dataclass or keep it control-plane")


def _unpack(node: tuple, arrays: list):
    tag = node[0]
    if tag == "x":
        return node[1]
    if tag == "np":
        return arrays[node[1]]
    if tag == "ns":
        return np.frombuffer(node[2], dtype=np.dtype(node[1]))[0]
    if tag == "rs":
        rs = np.random.RandomState()
        rs.set_state(_unpack(node[1], arrays))
        return rs
    if tag == "li":
        return [_unpack(v, arrays) for v in node[1]]
    if tag == "tu":
        return tuple(_unpack(v, arrays) for v in node[1])
    if tag == "di":
        return {_unpack(k, arrays): _unpack(v, arrays)
                for k, v in node[1]}
    if tag == "dc":
        by_name, _ = _registry()
        cls = by_name[node[1]]
        return cls(*[_unpack(v, arrays) for v in node[2]])
    raise TypeError(f"shm codec: unknown tag {tag!r}")


@dataclasses.dataclass
class ShmRef:
    """Control-plane pointer to one packed payload: everything a peer
    needs to attach the named arena (geometry included) and reconstruct
    the object from its slot."""

    arena: str
    slot: int
    generation: int
    nbytes: int
    n_slots: int                   # arena geometry, for attachers
    slot_bytes: int
    header: object                 # packed non-array tree
    descs: tuple                   # ((dtype_str, shape, offset), ...)


def pack_payload(obj):
    """-> (header tree, [contiguous arrays], descs, total payload bytes).

    ``descs`` assigns each array an offset in a contiguous slot layout."""
    arrays: list[np.ndarray] = []
    tree = _pack(obj, arrays)
    descs, off = [], 0
    for a in arrays:
        descs.append((a.dtype.str, a.shape, off))
        off += a.nbytes
    return tree, arrays, tuple(descs), off


def unpack_payload(header, descs, buf) -> object:
    arrays = []
    for dtype_str, shape, off in descs:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(buf, dtype=dt, count=n,
                            offset=off).reshape(shape).copy()
        arrays.append(arr)
    return _unpack(header, arrays)


# ---------------------------------------------------------------------------
# Arena: one segment, fixed generation-tagged slots
# ---------------------------------------------------------------------------


class ShmArena:
    """``n_slots`` fixed-size generation-tagged slots in one shared
    segment. The creator owns the name (and must ``unlink``); attachers
    only map it. All slot-state transitions are single-writer (see
    module docstring), so plain loads/stores suffice."""

    def __init__(self, name: str, n_slots: int, slot_bytes: int, *,
                 create: bool):
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self._stride = _HDR + slot_bytes
        self.created = create
        try:
            if create:
                self._seg = shared_memory.SharedMemory(
                    name=name, create=True, size=n_slots * self._stride)
                self._reserve()
                self._seg.buf[:] = b"\0" * len(self._seg.buf)
            else:
                self._seg = _attach(name)
        except OSError as e:
            raise ShmUnavailable(
                f"cannot {'create' if create else 'attach'} shared-memory "
                f"arena {name!r}: {e}") from e
        self.name = self._seg.name.lstrip("/")

    def _reserve(self) -> None:
        """Allocate the new segment's pages now. A segment is created
        sparse, and a ``/dev/shm`` smaller than it would fail only at the
        first write past its room — with SIGBUS, killing the
        coordinator. Reserving up front turns that into ``OSError``
        (ENOSPC), which the caller answers with the inline fallback."""
        fd = getattr(self._seg, "_fd", -1)
        if fd < 0 or not hasattr(os, "posix_fallocate"):
            return
        try:
            os.posix_fallocate(fd, 0, len(self._seg.buf))
        except OSError:
            self._seg.close()
            self._seg.unlink()
            raise

    # -- slot header ---------------------------------------------------------

    def _off(self, slot: int) -> int:
        return slot * self._stride

    def generation(self, slot: int) -> int:
        return _GEN.unpack_from(self._seg.buf, self._off(slot))[0]

    def set_generation(self, slot: int, gen: int) -> None:
        _GEN.pack_into(self._seg.buf, self._off(slot), gen)

    def state(self, slot: int) -> int:
        return _STATE.unpack_from(self._seg.buf, self._off(slot) + 8)[0]

    def set_state(self, slot: int, state: int) -> None:
        _STATE.pack_into(self._seg.buf, self._off(slot) + 8, state)

    # -- payload -------------------------------------------------------------

    def write(self, slot: int, gen: int, arrays, descs) -> None:
        base = self._off(slot) + _HDR
        buf = self._seg.buf
        for a, (_dt, _shape, off) in zip(arrays, descs):
            if a.nbytes:
                buf[base + off:base + off + a.nbytes] = \
                    memoryview(a.reshape(-1)).cast("B")
        self.set_generation(slot, gen)

    def read(self, ref: ShmRef) -> object:
        """Copy out and decode, verifying the generation tag before and
        after the copy (a concurrent reclaim+rewrite can't go unseen)."""
        if self.generation(ref.slot) != ref.generation:
            raise ShmStale(f"slot {ref.slot} of {self.name} is at "
                           f"generation {self.generation(ref.slot)}, "
                           f"ref wants {ref.generation} (task already "
                           f"completed elsewhere)")
        base = self._off(ref.slot) + _HDR
        raw = bytes(self._seg.buf[base:base + ref.nbytes])
        if self.generation(ref.slot) != ref.generation:
            raise ShmStale(f"slot {ref.slot} of {self.name} was "
                           f"reclaimed during read")
        return unpack_payload(ref.header, ref.descs, raw)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        try:
            self._seg.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        try:
            self._seg.unlink()
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------


def _arena_names(base: str, n_workers: int) -> tuple[str, list[str]]:
    return f"{base}-t", [f"{base}-r{w}" for w in range(n_workers)]


class CoordinatorShmTransport:
    """The coordinator's half: owns (creates, reclaims, unlinks) the
    task arena and every per-worker response arena.

    Arenas are sized lazily from the first packed payload (slot capacity
    2x the first task payload; response slots 4x, since a forwarded
    ``PreparedBatch`` carries the docs plus their extracted/parsed
    pages), so idle pools cost nothing and typical campaigns never hit
    the inline fallback."""

    MIN_SLOT = 1 << 20

    def __init__(self, base: str, n_workers: int, n_task_slots: int,
                 n_resp_slots: int):
        self.base = base
        self.n_workers = n_workers
        self.n_task_slots = n_task_slots
        self.n_resp_slots = n_resp_slots
        self._task: ShmArena | None = None
        self._resp: list[ShmArena] = []
        self._free: list[int] = []
        self._gen = 0
        self._disabled = False
        self.fallbacks = 0             # payloads shipped inline instead

    # -- setup ---------------------------------------------------------------

    def _ensure_arenas(self, first_payload_bytes: int) -> bool:
        if self._task is not None:
            return True
        if self._disabled:
            return False
        task_name, resp_names = _arena_names(self.base, self.n_workers)
        slot = max(2 * first_payload_bytes, self.MIN_SLOT)
        resp_slot = max(4 * first_payload_bytes, self.MIN_SLOT)
        made: list[ShmArena] = []
        try:
            self._task = ShmArena(task_name, self.n_task_slots, slot,
                                  create=True)
            made.append(self._task)
            for name in resp_names:
                a = ShmArena(name, self.n_resp_slots, resp_slot,
                             create=True)
                made.append(a)
                self._resp.append(a)
        except ShmUnavailable as e:
            for a in made:
                a.close()
                a.unlink()
            self._task = None
            self._resp = []
            self._disabled = True
            warnings.warn(
                f"shared-memory transport unavailable ({e}); falling "
                f"back to pickled batch payloads", RuntimeWarning,
                stacklevel=3)
            return False
        self._free = list(range(self.n_task_slots))
        return True

    # -- task payloads (coordinator -> worker) -------------------------------

    def _fallback(self) -> None:
        self.fallbacks += 1
        obs.metrics().count("shm.fallbacks")

    def encode_task(self, obj) -> ShmRef | None:
        """Pack ``obj`` into a free task slot; None means ship inline
        (transport disabled, payload too big, or slots exhausted)."""
        if self._disabled:
            return None
        try:
            header, arrays, descs, nbytes = pack_payload(obj)
        except TypeError:
            self._fallback()
            return None
        if not self._ensure_arenas(nbytes):
            self._fallback()
            return None
        if nbytes > self._task.slot_bytes or not self._free:
            self._fallback()
            return None
        slot = self._free.pop()
        self._gen += 1
        self._task.write(slot, self._gen, arrays, descs)
        return ShmRef(self._task.name, slot, self._gen, nbytes,
                      self._task.n_slots, self._task.slot_bytes, header,
                      descs)

    def free_task(self, ref: ShmRef | None) -> None:
        """Reclaim a completed task's slot. Bumping the generation here
        (not just at reuse) turns any straggler read of a freed slot
        into an immediate clean ``ShmStale``."""
        if ref is None or self._task is None:
            return
        self._gen += 1
        self._task.set_generation(ref.slot, self._gen)
        self._free.append(ref.slot)

    # -- result payloads (worker -> coordinator) -----------------------------

    def take_result(self, ref: ShmRef) -> object:
        """Decode a worker's response payload and free its slot."""
        arena = self._resp_by_name(ref.arena)
        try:
            return arena.read(ref)
        finally:
            arena.set_state(ref.slot, STATE_FREE)

    def release_result(self, ref: ShmRef) -> None:
        """Free a response slot without decoding (dropped duplicate)."""
        arena = self._resp_by_name(ref.arena)
        arena.set_state(ref.slot, STATE_FREE)

    def _resp_by_name(self, name: str) -> ShmArena:
        for a in self._resp:
            if a.name == name:
                return a
        raise KeyError(f"unknown response arena {name!r}")

    # -- lifecycle -----------------------------------------------------------

    def unlink_worker(self, worker_id: int) -> None:
        """Crash-recovery path: a dead worker's response arena loses its
        /dev/shm name immediately (no orphan while the pool keeps
        running); the coordinator's mapping stays valid for results the
        worker queued before dying."""
        if worker_id < len(self._resp):
            self._resp[worker_id].unlink()

    def close(self) -> None:
        """Unlink every segment this transport created."""
        for a in ([self._task] if self._task is not None else []) \
                + self._resp:
            a.close()
            a.unlink()
        self._task = None
        self._resp = []
        self._disabled = True


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


class WorkerShmTransport:
    """A worker's half: attaches the coordinator-owned arenas on first
    use (task-arena geometry rides in every ``ShmRef``; the response
    arena's is derived from its mapped size), reads task payloads, and
    writes result payloads into its own response arena's free slots."""

    def __init__(self, base: str, worker_id: int, n_workers: int,
                 n_resp_slots: int):
        self.base = base
        self.worker_id = worker_id
        _task_name, resp_names = _arena_names(base, n_workers)
        self._resp_name = resp_names[worker_id]
        self._n_resp_slots = n_resp_slots
        self._task: ShmArena | None = None
        self._resp: ShmArena | None = None
        self._resp_gen = 0
        self.fallbacks = 0

    def _fallback(self) -> None:
        self.fallbacks += 1
        obs.metrics().count("shm.fallbacks")

    def read_task(self, ref: ShmRef) -> object:
        if self._task is None:
            self._task = ShmArena(ref.arena, ref.n_slots, ref.slot_bytes,
                                  create=False)
        return self._task.read(ref)

    def encode_result(self, obj) -> ShmRef | None:
        """Pack ``obj`` into a free slot of this worker's response
        arena; None means ship inline."""
        try:
            if self._resp is None:
                probe = _attach(self._resp_name)
                stride = len(probe.buf) // self._n_resp_slots
                probe.close()
                self._resp = ShmArena(self._resp_name,
                                      self._n_resp_slots, stride - _HDR,
                                      create=False)
            header, arrays, descs, nbytes = pack_payload(obj)
        except (ShmUnavailable, TypeError, OSError, FileNotFoundError):
            self._fallback()
            return None
        arena = self._resp
        if nbytes > arena.slot_bytes:
            self._fallback()
            return None
        slot = next((s for s in range(arena.n_slots)
                     if arena.state(s) == STATE_FREE), None)
        if slot is None:
            self._fallback()
            return None
        self._resp_gen += 1
        arena.write(slot, self._resp_gen, arrays, descs)
        arena.set_state(slot, STATE_FULL)
        return ShmRef(arena.name, slot, self._resp_gen, nbytes,
                      arena.n_slots, arena.slot_bytes, header, descs)

    def close(self) -> None:
        for a in (self._task, self._resp):
            if a is not None:
                a.close()
        self._task = self._resp = None
