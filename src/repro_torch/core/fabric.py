"""Cross-machine campaign fabric: a socket transport behind the pool.

The third ``WorkerPool`` runtime (``ExecutorConfig.runtime="fabric"``).
``FabricWorkerPool`` keeps the entire coordinator brain of
``ProcessWorkerPool`` — the in-flight window, the heartbeat-deadline
liveness police, pool-aware re-issue through
``scheduler.reissue_candidates``, and the first-completion-wins dedup
gate — and swaps only the transport: instead of multiprocessing queues
into spawned children, a ``FabricCoordinator`` (the selector hub below)
listens on ``ExecutorConfig.coordinator`` (``HOST:PORT``, port 0 =
auto-bind) and standalone worker processes — on this machine or any
other — dial in over TCP (``serve.py --connect HOST:PORT``, or the
loopback spawner in ``launch/fabric_worker``).

Wire format: every message is one length-prefixed frame — an 8-byte
big-endian length followed by the pickled message dataclass
(``PrepareTask`` / ``CompleteTask`` / ``BatchDone`` / ``Heartbeat``
from core/workers, plus the membership frames below). Payloads always
ride inline: shared-memory arenas cannot cross machines, so the fabric
pool runs with ``_shm = None`` and the inherited send/receive paths
fall back to pickled payloads automatically. Those payloads hold host
numpy only (``launch/worker_main._run_task`` moves a forwarded prep's
routing tensors off the card), so no frame carries a tensor and the
coordinator never unpickles one onto a card.

Devices: a loopback worker builds its engine on the spec's torch device
(``WorkerSpec.device``, the campaign's); a standalone worker
(``serve --connect HOST:PORT --device ...``) runs on its own
``--device`` instead. The fingerprint leaves the device out, so both
join one fleet.

Membership is elastic:

- **join** — a dialing worker presents a ``Hello``; with a fingerprint
  (``specs.spec_fingerprint``) it must match the coordinator's spec or
  the worker is rejected with an actionable error naming the differing
  field; with ``fingerprint=None`` (the trusting default for workers
  the coordinator itself launched) the coordinator ships its own
  portable ``WorkerSpec`` in the ``Admit`` reply, and the worker
  verifies the coordinator-stamped fingerprint after deserializing.
  Every admission emits a ``join`` span and bumps ``fabric.joins``.
- **leave** — a connection EOF/reset (crash or detach) emits a
  ``leave`` span, and the inherited liveness police sees the dead
  connection handle and re-issues the worker's in-flight and queued
  batches to live peers.
- The adaptive controller queries ``live_ingest_nodes()`` at every
  round boundary and re-shards over the live fleet.

Determinism is unchanged and is the point: batch rng streams are keyed
by the global batch index and the dedup gate keeps first completions
only, so a campaign with workers joining, crashing, and being rejected
mid-run reproduces the single-node record set byte-identically.

All socket I/O runs on one daemon hub thread (non-blocking sockets
under a ``selectors`` loop). The hub never mutates pool state: inbound
worker messages and membership events are enqueued on the pool's
result queue and processed single-threaded by the inherited drain
loop, exactly like multiprocessing queue messages.
"""
from __future__ import annotations

import dataclasses
import pickle
import queue as queue_lib
import selectors
import socket
import struct
import threading
import time
from collections import deque

from repro_torch.core import obs
from repro_torch.core import specs as spec_lib
from repro_torch.core.workers import (BatchDone, Heartbeat,
                                      ProcessWorkerPool, _prebuild_kernels,
                                      reap)

_LEN = struct.Struct("!Q")
#: refuse absurd frames instead of allocating unbounded buffers from a
#: corrupt or hostile length prefix
MAX_FRAME_BYTES = 1 << 31

#: an intentionally-wrong fingerprint for exercising the admission
#: rejection path (the elastic_join_leave scenario's rejected worker)
MISMATCHED_FINGERPRINT = {
    "router": "0000000000000000",
    "engine_config": "0000000000000000",
    "backends": "0000000000000000",
}


def parse_addr(addr: str) -> tuple[str, int]:
    """``HOST:PORT`` -> (host, port); port 0 means auto-bind."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"fabric address must be HOST:PORT, got {addr!r}")
    return host, int(port)


def encode_frame(obj) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental decoder for one stream: feed raw bytes, yield every
    complete frame's unpickled message."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes):
        self._buf += data
        while True:
            if len(self._buf) < _LEN.size:
                return
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                raise ValueError(f"fabric frame of {n} bytes exceeds the "
                                 f"{MAX_FRAME_BYTES}-byte cap")
            if len(self._buf) < _LEN.size + n:
                return
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            yield pickle.loads(payload)


# ---------------------------------------------------------------------------
# Membership frames
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Hello:
    """A dialing worker's first frame. ``fingerprint`` is the worker's
    ``specs.spec_fingerprint`` when it was built from a local spec, or
    None to request the coordinator's spec (shipped in ``Admit``)."""

    fingerprint: dict | None = None
    host: str = ""
    pid: int = 0


@dataclasses.dataclass
class Admit:
    """Admission reply: the worker's assigned node id and the portable
    ``WorkerSpec`` to build (coordinator-stamped fingerprint included,
    verified worker-side after deserialization)."""

    node_id: int
    spec: object


@dataclasses.dataclass
class Reject:
    """Admission refusal with an actionable reason (the fingerprint
    field that differed, or a full fleet)."""

    reason: str


@dataclasses.dataclass
class Shutdown:
    """Coordinator-initiated teardown (the fabric's queue sentinel — an
    explicit frame, since a bare None is indistinguishable from EOF)."""


@dataclasses.dataclass(frozen=True)
class FabricElastic:
    """Deterministic elastic-membership schedule for tests and the
    scenario lab (production fleets leave this None and grow by simply
    dialing more workers in).

    ``join_after``: ``((node, n), ...)`` — node's worker is launched
    only once the coordinator has completed n batches (a mid-campaign
    join; until then the slot idles and its shards land on peers).
    ``reject``: number of extra loopback workers launched with an
    intentionally mismatched fingerprint — each must be rejected at
    admission (they are never part of the fleet)."""

    join_after: tuple = ()
    reject: int = 0


class _ConnEvent:
    """Hub-to-pool membership event, delivered on the result queue so
    all pool mutation stays on the drain thread."""

    __slots__ = ("kind", "conn", "msg")

    def __init__(self, kind: str, conn: "_Conn", msg=None):
        self.kind = kind                 # "hello" | "leave"
        self.conn = conn
        self.msg = msg


# ---------------------------------------------------------------------------
# Connection + selector hub (the FabricCoordinator's I/O plane)
# ---------------------------------------------------------------------------


class _Conn:
    """One worker connection: inbound frame decoder, outbound byte
    buffer (pumped by the hub on writability), and byte counters."""

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.decoder = FrameDecoder()
        self.out = bytearray()
        self.alive = True
        self.node: int | None = None     # assigned at admission
        self.close_after_flush = False   # rejected dialer: hang up
        self.bytes_tx = 0
        self.bytes_rx = 0


class FabricCoordinator:
    """The fabric's socket hub: accepts dialing workers, reads frames,
    pumps outbound buffers — all on one daemon thread over non-blocking
    sockets. Inbound messages and membership events are handed to the
    pool through its result queue; outbound sends are enqueued from the
    pool thread via ``send`` and flushed by the selector loop."""

    def __init__(self, host: str, port: int, events: queue_lib.Queue):
        self.events = events
        self.sel = selectors.DefaultSelector()
        self.listener = socket.create_server((host, port))
        self.listener.setblocking(False)
        self.addr: tuple[str, int] = self.listener.getsockname()[:2]
        # self-pipe: wakes the selector when another thread enqueues an
        # outbound frame or asks for shutdown
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.conns: list[_Conn] = []
        self._lock = threading.Lock()
        self._pending: list[tuple[_Conn, bytes | None]] = []
        self._closing = False
        self.sel.register(self.listener, selectors.EVENT_READ,
                          ("accept", None))
        self.sel.register(self._wake_r, selectors.EVENT_READ,
                          ("wake", None))
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="adaparse-fabric-hub")
        self.thread.start()

    # -- pool-thread API -----------------------------------------------------

    def send(self, conn: _Conn, obj) -> None:
        """Enqueue one frame for ``conn`` (thread-safe; the hub thread
        does the actual socket write)."""
        self._enqueue(conn, encode_frame(obj))

    def hangup(self, conn: _Conn) -> None:
        """Close ``conn`` once its outbound buffer has flushed (the
        rejected-admission goodbye)."""
        self._enqueue(conn, None)

    def bytes_totals(self) -> tuple[int, int]:
        return (sum(c.bytes_tx for c in self.conns),
                sum(c.bytes_rx for c in self.conns))

    def close(self, linger_s: float = 1.0) -> None:
        """Stop the hub: give queued outbound frames (the Shutdown
        goodbyes) a bounded window to flush, then tear down."""
        deadline = time.time() + linger_s
        while time.time() < deadline:
            with self._lock:
                pending = bool(self._pending)
            if not pending and not any(c.out for c in self.conns
                                       if c.alive):
                break
            time.sleep(0.01)
        self._closing = True
        self._wake()
        self.thread.join(timeout=2.0)
        for c in self.conns:
            c.alive = False
            try:
                c.sock.close()
            except OSError:
                pass
        for s in (self.listener, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        self.sel.close()

    def _enqueue(self, conn: _Conn, data: bytes | None) -> None:
        with self._lock:
            self._pending.append((conn, data))
        self._wake()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (OSError, BlockingIOError):
            pass                         # a pending wake already queued

    # -- hub thread ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._closing:
            for key, mask in self.sel.select(timeout=0.1):
                kind, conn = key.data
                if kind == "accept":
                    self._accept()
                elif kind == "wake":
                    self._drain_wake()
                else:
                    if mask & selectors.EVENT_READ:
                        self._read(conn)
                    if mask & selectors.EVENT_WRITE and conn.alive:
                        self._write(conn)

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self.conns.append(conn)
            self.sel.register(sock, selectors.EVENT_READ, ("conn", conn))

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass
        with self._lock:
            items, self._pending = self._pending, []
        for conn, data in items:
            if not conn.alive:
                continue
            if data is None:
                conn.close_after_flush = True
            else:
                conn.out += data
            self._want_write(conn)

    def _want_write(self, conn: _Conn) -> None:
        try:
            self.sel.modify(conn.sock,
                            selectors.EVENT_READ | selectors.EVENT_WRITE,
                            ("conn", conn))
        except (KeyError, ValueError, OSError):
            pass                         # already dropped

    def _read(self, conn: _Conn) -> None:
        while conn.alive:
            try:
                data = conn.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(conn)
                return
            if not data:
                self._drop(conn)
                return
            conn.bytes_rx += len(data)
            try:
                for msg in conn.decoder.feed(data):
                    if isinstance(msg, Hello):
                        self.events.put(_ConnEvent("hello", conn, msg))
                    else:
                        self.events.put(msg)
            except Exception:
                # corrupt frame (version skew, truncated pickle): the
                # connection is unusable — treat as a leave
                self._drop(conn)
                return

    def _write(self, conn: _Conn) -> None:
        try:
            while conn.out:
                sent = conn.sock.send(conn.out)
                conn.bytes_tx += sent
                del conn.out[:sent]
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        # buffer flushed
        if conn.close_after_flush:
            self._drop(conn)
            return
        try:
            self.sel.modify(conn.sock, selectors.EVENT_READ,
                            ("conn", conn))
        except (KeyError, ValueError, OSError):
            pass

    def _drop(self, conn: _Conn) -> None:
        if not conn.alive:
            return
        conn.alive = False
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self.events.put(_ConnEvent("leave", conn))


# ---------------------------------------------------------------------------
# Queue/process adapters (what the inherited pool machinery touches)
# ---------------------------------------------------------------------------


class _ConnSender:
    """Task-queue-shaped sender: ``put`` frames the message onto the
    connection's outbound buffer (the fabric's ``task_qs[w]``)."""

    def __init__(self, hub: FabricCoordinator, conn: _Conn):
        self.hub = hub
        self.conn = conn

    def put(self, msg) -> None:
        self.hub.send(self.conn, Shutdown() if msg is None else msg)

    put_nowait = put

    def qsize(self) -> int:
        return 0


class _NullSender:
    """Placeholder sender for a slot no worker has claimed yet; the
    dispatch loop never targets it (the slot is quiet), so a put here
    would be a bug."""

    def put(self, msg) -> None:
        if msg is not None:
            raise RuntimeError("task dispatched to an unclaimed fabric "
                               "slot (pool bug: the slot is quiet)")

    put_nowait = put


class _ConnHandle:
    """Process-shaped liveness handle: the connection is the process —
    EOF/reset reads as a crash to the inherited liveness police."""

    def __init__(self, conn: _Conn):
        self.conn = conn

    def is_alive(self) -> bool:
        return self.conn.alive


class _PendingHandle:
    """A reserved slot awaiting its worker (a deferred joiner or an
    external dialer): alive — the police must not declare a never-
    joined slot crashed — but held quiet until admission completes."""

    def is_alive(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# FabricWorkerPool
# ---------------------------------------------------------------------------


class FabricWorkerPool(ProcessWorkerPool):
    """``ProcessWorkerPool`` with the transport swapped for the fabric:
    the coordinator hub above accepts TCP workers and feeds their
    messages into a plain ``queue.Queue`` result queue, per-worker
    ``task_qs`` frame onto the sockets, and ``procs`` are connection
    liveness handles — so the inherited drain loop, in-flight window,
    dedup gate, liveness police, and ``scheduler.reissue_candidates``
    re-routing run unchanged over a fleet of remote processes."""

    #: heartbeat ``sent_mono`` stamps come from other machines'
    #: CLOCK_MONOTONIC — not comparable with the coordinator's; the
    #: queue-delay diagnostic stays same-host-only (core/workers)
    _mono_comparable = False

    def __init__(self, ecfg, xcfg, router, corpus_cfg, n_nodes: int,
                 ingest_nodes: list[int], reparse_nodes: list[int],
                 pools: list[str] | None, *,
                 alpha_of: dict[int, float] | None = None, cache=None,
                 probe_cfg=None, image_degraded=False,
                 text_degraded=False, backend_specs: tuple = (),
                 device=None):
        self._hub: FabricCoordinator | None = None
        self._local_procs: list = []
        self._validate_xcfg(xcfg)
        cache_dir, cache_max = self._cache_cfg(cache)
        self._init_state(ecfg, xcfg, n_nodes, ingest_nodes,
                         reparse_nodes, pools, alpha_of,
                         has_cache=cache_dir is not None, device=device)
        self._shm = None                 # payloads always ride inline
        router = spec_lib.portable_router(router)
        fault = getattr(xcfg, "fault_injection", None)
        self._specs = [
            self._worker_spec(
                i, router=router, corpus_cfg=corpus_cfg,
                cache_dir=cache_dir, cache_max=cache_max,
                probe_cfg=probe_cfg, image_degraded=image_degraded,
                text_degraded=text_degraded,
                backend_specs=tuple(backend_specs), fault=fault,
                shm_base=None, resp_slots=0)
            for i in range(n_nodes)]
        # one fingerprint for the fleet (worker-invariant fields only);
        # stamped on every shipped spec so the worker side can verify
        # nothing drifted in transit, and compared against any
        # fingerprint a dialing worker presents
        self._expected_fp = spec_lib.spec_fingerprint(self._specs[0])
        self._specs = [dataclasses.replace(s, fingerprint=self._expected_fp)
                       for s in self._specs]

        elastic = getattr(xcfg, "fabric", None)
        self._deferred: dict[int, int] = (
            dict(elastic.join_after) if elastic is not None else {})
        bad = set(self._deferred) - set(range(n_nodes))
        if bad:
            raise ValueError(f"fabric.join_after names unknown nodes "
                             f"{sorted(bad)} (fleet has {n_nodes})")
        self._joins = 0
        self._leaves = 0
        self._rejected = 0
        # slots the elastic schedule has launched a joiner for, with its
        # process, until the joiner's ready heartbeat arrives
        self._joining: dict[int, object] = {}
        # a fleet with a join schedule rebalances queued work over its
        # live members at every dispatch (_rebalance). A fleet without
        # one dispatches as the reference's FabricWorkerPool does, each
        # node its own shard: rebalancing there fails no test either,
        # but it moves batches between workers, and the fault
        # injections are keyed to a worker's n-th task (crash_after,
        # mute_after), so they would fire on other batches than the
        # reference's run of the same spec. The port diverges from the
        # reference's dispatch only where the joiner needs it.
        self._rebalances = bool(self._deferred)
        self._left: set[int] = set()
        self._tx_flushed = 0
        self._rx_flushed = 0

        host, port = parse_addr(
            getattr(xcfg, "coordinator", None) or "127.0.0.1:0")
        self.result_q: queue_lib.Queue = queue_lib.Queue()
        self._hub = FabricCoordinator(host, port, self.result_q)
        self.addr = self._hub.addr

        # every slot starts unclaimed: a placeholder liveness handle, a
        # null sender, and quiet status (no work lands until admission)
        self.procs = [_PendingHandle() for _ in range(n_nodes)]
        self.task_qs = [_NullSender() for _ in range(n_nodes)]
        self._beat = [time.time()] * n_nodes
        self._quiet = set(range(n_nodes))
        self._unassigned: deque[int] = deque(
            i for i in range(n_nodes) if i not in self._deferred)

        try:
            if getattr(xcfg, "fabric_spawn", True):
                from repro_torch.launch.fabric_worker import spawn_loopback

                _prebuild_kernels(self.device)
                for _ in range(len(self._unassigned)):
                    self._local_procs.append(spawn_loopback(self.addr))
                for _ in range(int(getattr(elastic, "reject", 0) or 0)
                               if elastic is not None else 0):
                    self._local_procs.append(spawn_loopback(
                        self.addr, fingerprint=MISMATCHED_FINGERPRINT))
            self._await_ready()
        except BaseException:
            self.close()
            raise

    # -- startup -------------------------------------------------------------

    def _await_ready(self) -> None:
        """Block until every initially-launched slot is admitted and
        has sent its ready heartbeat (deferred joiners excepted — they
        arrive mid-campaign)."""
        want = set(range(self.n_nodes)) - set(self._deferred)
        ready: set[int] = set()
        deadline = time.time() + self.xcfg.worker_start_timeout_s
        while len(ready & want) < len(want):
            timeout = deadline - time.time()
            if timeout <= 0:
                missing = sorted(want - ready)
                raise RuntimeError(
                    f"fabric workers {missing} not ready within "
                    f"{self.xcfg.worker_start_timeout_s}s "
                    f"(worker_start_timeout_s)")
            try:
                msg = self.result_q.get(timeout=min(timeout, 0.2))
            except queue_lib.Empty:
                continue
            if isinstance(msg, BatchDone) and msg.error is not None:
                raise RuntimeError(f"fabric worker {msg.worker} failed "
                                   f"to start:\n{msg.error}")
            self._handle(msg)
            if isinstance(msg, Heartbeat):
                ready.add(msg.worker)

    # -- membership ----------------------------------------------------------

    def _handle(self, msg) -> None:
        if isinstance(msg, _ConnEvent):
            if msg.kind == "hello":
                self._admit(msg.conn, msg.msg)
            else:
                self._on_leave(msg.conn)
            return
        joiner_ready = (isinstance(msg, Heartbeat)
                        and msg.worker in self._joining
                        and msg.worker in self._quiet
                        and msg.worker not in self._unassigned)
        super()._handle(msg)
        if joiner_ready and msg.worker not in self._quiet:
            # the admitted joiner's ready heartbeat: from here the
            # dispatch loop may hand it work
            del self._joining[msg.worker]
            rec = obs.recorder()
            if rec.enabled:
                rec.span("join_ready", msg.worker, time.time(), 0.0,
                         node=msg.worker,
                         detail=f"joiner node {msg.worker} ready after "
                                f"{self._batches_done} batches")
        if isinstance(msg, BatchDone):
            self._maybe_spawn_joiners()

    def _admission_error(self, hello: Hello) -> str | None:
        """The admission decision, pure: None admits, a string rejects
        with that actionable reason."""
        if hello.fingerprint is not None:
            mismatch = spec_lib.describe_mismatch(self._expected_fp,
                                                  hello.fingerprint)
            if mismatch:
                return mismatch
        if not self._unassigned:
            return (f"fleet full: all {self.n_nodes} fabric slots are "
                    f"claimed and no join is scheduled — grow "
                    f"ExecutorConfig.n_nodes to admit more workers")
        return None

    def _admit(self, conn: _Conn, hello: Hello) -> None:
        who = f"{hello.host or conn.addr[0]}:{hello.pid}"
        reason = self._admission_error(hello)
        if reason is not None:
            self._rejected += 1
            obs.metrics().count("fabric.rejected")
            rec = obs.recorder()
            if rec.enabled:
                rec.span("admission_rejected", who, time.time(), 0.0,
                         detail=reason)
            self._hub.send(conn, Reject(reason))
            self._hub.hangup(conn)
            return
        w = self._unassigned.popleft()
        conn.node = w
        self.procs[w] = _ConnHandle(conn)
        self.task_qs[w] = _ConnSender(self._hub, conn)
        self._beat[w] = time.time()
        self._joins += 1
        obs.metrics().count("fabric.joins")
        rec = obs.recorder()
        if rec.enabled:
            rec.span("join", w, time.time(), 0.0, node=w,
                     detail=f"admitted {who} as node {w}")
        self._hub.send(conn, Admit(w, self._specs[w]))
        # the slot stays quiet until the worker's ready heartbeat
        # arrives (engine build time); work routed meanwhile lands on
        # peers exactly like a wedged node's would

    def _on_leave(self, conn: _Conn) -> None:
        w = conn.node
        if w is None or w in self._left:
            return
        self._left.add(w)
        self._leaves += 1
        obs.metrics().count("fabric.leaves")
        rec = obs.recorder()
        if rec.enabled:
            rec.span("leave", w, time.time(), 0.0, node=w,
                     abandoned=True,
                     detail=f"connection to node {w} closed "
                            f"(crash or detach)")
        # the inherited police sees the dead handle on its next tick
        # and re-issues the node's in-flight batches to live peers

    def _maybe_spawn_joiners(self) -> None:
        """FabricElastic.join_after: launch a deferred slot's worker
        once enough batches have completed (checked after every
        BatchDone — ``_batches_done`` only moves there)."""
        if not self._deferred:
            return
        due = [w for w, n in self._deferred.items()
               if self._batches_done >= n]
        for w in due:
            del self._deferred[w]
            self._unassigned.append(w)
            if getattr(self.xcfg, "fabric_spawn", True):
                from repro_torch.launch.fabric_worker import spawn_loopback

                proc = spawn_loopback(self.addr)
                self._local_procs.append(proc)
                self._joining[w] = proc
            rec = obs.recorder()
            if rec.enabled:
                rec.span("join_spawn", w, time.time(), 0.0, node=w,
                         detail=f"joiner for node {w} launched after "
                                f"{self._batches_done} batches")

    def _top_up(self, pending: dict[int, deque]) -> None:
        """``ProcessWorkerPool._top_up``, elastic: while a joiner the
        schedule has launched is not ready yet and queued work remains,
        wait for it (``_await_joiners``); after the base top-up, a fleet
        with a join schedule rebalances the queued batches over its live
        members (``_rebalance``)."""
        if self._joining and pending:
            self._await_joiners()
        super()._top_up(pending)
        if self._rebalances and pending:
            self._rebalance(pending)

    def _rebalance(self, pending: dict[int, deque]) -> None:
        """Work stealing over the live fleet: in node order, each live
        ingest node with an empty queue and room in its in-flight window
        takes the tail batches of the longest queue (ties to the lower
        node id) until its window is full, and the base top-up sends
        them. A round's shards are cut over the members live at its
        boundary; a joiner admitted later, or a member whose shard ran
        dry, takes queued work this way instead of only by re-issue.
        Batch keys are global, so who runs a batch never changes its
        records."""
        donors = [n for n in pending if pending[n]]
        moved = False
        for w in self.live_ingest_nodes():
            room = self._window - self._effective_load(w)
            if w in pending or room <= 0:
                continue
            while room > 0:
                donor = max((n for n in donors if pending[n]),
                            key=lambda n: (len(pending[n]), -n),
                            default=None)
                if donor is None:
                    break
                batch = pending[donor].pop()
                pending.setdefault(w, deque()).appendleft(batch)
                room -= 1
                moved = True
                rec = obs.recorder()
                if rec.enabled:
                    rec.span("reroute", batch["batch_key"], time.time(),
                             0.0, node=w,
                             detail=f"taken from node {donor}'s queue")
        if moved:
            super()._top_up(pending)

    def _await_joiners(self) -> None:
        """Wait for the joiners the elastic schedule has launched until
        each has been admitted and sent its ready heartbeat (bounded by
        ``worker_start_timeout_s``), handling every message meanwhile as
        the drain loop would. A worker's start (a fresh interpreter,
        torch, on a card its CUDA context) can outlast what is left of a
        short campaign; waiting before the next dispatch of queued work
        makes the join happen while there is work for it. Records do
        not depend on placement, so the wait changes who computes a
        batch, never a record."""
        deadline = time.time() + self.xcfg.worker_start_timeout_s
        while True:
            for w, proc in list(self._joining.items()):
                if w in self._dead or w in self._left or (
                        w not in self._unassigned and w not in self._quiet):
                    del self._joining[w]         # ready, or already gone
                elif w in self._unassigned and not proc.is_alive():
                    raise RuntimeError(
                        f"fabric joiner for node {w} exited (code "
                        f"{proc.exitcode}) before it was admitted")
            if not self._joining:
                return
            timeout = deadline - time.time()
            if timeout <= 0:
                raise RuntimeError(
                    f"fabric joiners {sorted(self._joining)} not ready "
                    f"within {self.xcfg.worker_start_timeout_s}s "
                    f"(worker_start_timeout_s)")
            try:
                msg = self.result_q.get(timeout=min(timeout, 0.2))
            except queue_lib.Empty:
                continue
            if (isinstance(msg, BatchDone) and msg.error is not None
                    and msg.task_id == -1 and msg.worker in self._joining):
                raise RuntimeError(f"fabric worker {msg.worker} failed "
                                   f"to start:\n{msg.error}")
            self._handle(msg)

    def live_ingest_nodes(self) -> list[int]:
        """The ingest nodes a round boundary may shard over right now:
        admitted, connected, and not quiet (a slot awaiting its joiner
        or a wedged straggler sheds its shards to peers)."""
        return [i for i in self.ingest_nodes
                if i not in self._dead and i not in self._quiet
                and self.procs[i].is_alive()]

    # -- counters ------------------------------------------------------------

    def _flush_net_counters(self) -> None:
        """Fold the hub's connection byte counters into the coordinator
        registry as fleet-wide fabric.* counters (delta since the last
        flush — counters are monotone)."""
        if self._hub is None:
            return
        tx, rx = self._hub.bytes_totals()
        if tx > self._tx_flushed:
            obs.metrics().count("fabric.bytes_tx", tx - self._tx_flushed)
            self._tx_flushed = tx
        if rx > self._rx_flushed:
            obs.metrics().count("fabric.bytes_rx", rx - self._rx_flushed)
            self._rx_flushed = rx

    def _police(self) -> None:
        self._flush_net_counters()
        super()._police()

    def finalize(self, n_docs: int, cache, hits0: int, miss0: int) -> dict:
        self._flush_net_counters()
        return super().finalize(n_docs, cache, hits0, miss0)

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        for q in getattr(self, "task_qs", []):
            try:
                q.put_nowait(None)       # framed Shutdown to live conns
            except Exception:
                pass
        self._flush_net_counters()
        if self._hub is not None:
            self._hub.close()
            self._hub = None
        reap(self._local_procs)
        self._local_procs = []
