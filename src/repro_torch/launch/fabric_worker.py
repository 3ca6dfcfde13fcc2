"""Standalone fabric worker: dial a coordinator, get admitted, serve
batches (core/fabric — the cross-machine side of
``ExecutorConfig.runtime="fabric"``).

The worker opens one TCP connection to the coordinator
(``serve.py --connect HOST:PORT``), sends a ``Hello`` — with its spec
fingerprint when it was built from a local spec, or ``None`` to
request the coordinator's — and waits for ``Admit`` (assigned node id
+ the portable ``WorkerSpec``, whose coordinator-stamped fingerprint
``worker_main._build_engine`` verifies after deserialization) or
``Reject`` (an actionable mismatch message; the process exits
non-zero).

After admission the loop mirrors ``worker_main.worker_loop`` over the
socket instead of multiprocessing queues: the same
``PrepareTask``/``CompleteTask`` handling through
``worker_main._run_task``, a heartbeat daemon thread on the spec's
interval, the same deterministic fault hooks (``FaultInjection``:
hard ``os._exit`` crash, mute/flap windows), and a framed ``Shutdown``
(or EOF) to leave. Payloads always ride inline — no shared memory
across machines — and hold host numpy only.

Devices: a standalone worker (``serve --connect HOST:PORT``) runs on
its own ``--device`` (cuda unless "cpu"), not on the device the
coordinator's spec names; a loopback worker takes the spec's device. A
worker asked for cuda on a host without a card sends its traceback to
the coordinator and exits; it never runs on the CPU instead.

``spawn_loopback`` launches this worker as a local spawn-context
process dialing ``127.0.0.1`` — how the fabric pool provisions its own
fleet in tests, CI, and single-host campaigns (several loopback workers
share one card, each with its own CUDA context).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import socket
import sys
import threading
import time
import traceback

_CONNECT_RETRIES = 20
_CONNECT_RETRY_S = 0.25


def _dial(host: str, port: int) -> socket.socket:
    """Connect with a short retry loop (a loopback worker can outrace
    the coordinator's listener by a scheduler tick)."""
    last: Exception | None = None
    for _ in range(_CONNECT_RETRIES):
        try:
            sock = socket.create_connection((host, port), timeout=30.0)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            return sock
        except OSError as e:
            last = e
            time.sleep(_CONNECT_RETRY_S)
    raise ConnectionError(f"cannot reach fabric coordinator at "
                          f"{host}:{port}: {last}")


def _send(sock: socket.socket, lock: threading.Lock, obj) -> None:
    from repro_torch.core.fabric import encode_frame

    data = encode_frame(obj)
    with lock:
        sock.sendall(data)


def _frames(sock: socket.socket):
    """Yield every framed message from the blocking socket; returns on
    EOF."""
    from repro_torch.core.fabric import FrameDecoder

    dec = FrameDecoder()
    while True:
        try:
            data = sock.recv(1 << 16)
        except OSError:
            return
        if not data:
            return
        yield from dec.feed(data)


def run_worker(addr: tuple[str, int], *, fingerprint: dict | None = None,
               spec=None, device=None) -> None:
    """Dial ``addr``, join the fleet, serve batches until Shutdown/EOF.

    ``fingerprint`` (or one computed from a locally supplied ``spec``)
    is presented at admission; with both None the coordinator's spec is
    trusted and shipped back in the Admit reply. ``device`` (a
    standalone worker's ``--device``) replaces the spec's device; None
    keeps it (a loopback worker)."""
    from repro_torch.core import obs
    from repro_torch.core.fabric import Admit, Hello, Reject, Shutdown
    from repro_torch.core.workers import BatchDone, Heartbeat
    from repro_torch.launch.worker_main import (_build_engine,
                                                _device_gauges, _run_task)

    if spec is not None and fingerprint is None:
        from repro_torch.core.specs import spec_fingerprint
        fingerprint = spec_fingerprint(spec)

    host, port = addr
    sock = _dial(host, port)
    lock = threading.Lock()
    _send(sock, lock, Hello(fingerprint=fingerprint,
                            host=socket.gethostname(), pid=os.getpid()))
    frames = _frames(sock)
    sock.settimeout(60.0)                # bounded admission wait
    reply = next(frames, None)
    if isinstance(reply, Reject):
        raise SystemExit(f"fabric admission rejected: {reply.reason}")
    if not isinstance(reply, Admit):
        raise SystemExit(f"fabric coordinator hung up before admission "
                         f"(got {reply!r})")
    sock.settimeout(None)
    wid = reply.node_id
    if spec is None:
        spec = reply.spec
    if device is not None:
        spec = dataclasses.replace(spec, device=str(device))
    current: list[int | None] = [None]
    muted = [False]
    stop = threading.Event()
    rec = obs.configure(enabled=getattr(spec, "obs_enabled", False),
                        cap=getattr(spec, "obs_span_cap", 8192),
                        node=wid)
    try:
        # _build_engine verifies the coordinator-stamped fingerprint
        # against a recomputation from the deserialized spec
        eng, cache = _build_engine(spec)
    except BaseException:
        try:
            _send(sock, lock, BatchDone(task_id=-1, worker=wid,
                                        batch_key=-1,
                                        error=traceback.format_exc()))
        except OSError:
            pass
        return

    def _heartbeat() -> Heartbeat:
        # queue_depth stays -1: tasks are consumed straight off the
        # socket, so there is no reportable local backlog. sent_mono is
        # the same-host diagnostic only — the fabric coordinator
        # ignores it (per-machine monotonic epochs are not comparable).
        if rec.enabled:
            _device_gauges(wid, eng.device)
        return Heartbeat(
            wid, time.time(), current[0],
            sent_mono=time.monotonic(), queue_depth=-1,
            spans=rec.drain(128) if rec.enabled else None,
            metrics=obs.metrics().snapshot() if rec.enabled else None)

    def beat():
        while not stop.wait(spec.heartbeat_interval_s):
            if not muted[0]:
                try:
                    _send(sock, lock, _heartbeat())
                except OSError:
                    return

    beat_t = threading.Thread(target=beat, daemon=True)
    beat_t.start()
    _send(sock, lock, _heartbeat())                 # ready signal

    fault = spec.fault
    crash_after = dict(fault.crash_after) if fault else {}
    mute_after = dict(fault.mute_after) if fault else {}
    unmute_after = dict(getattr(fault, "unmute_after", ()) or ()) \
        if fault else {}
    n_done = 0
    for task in frames:
        if isinstance(task, Shutdown):
            break
        if wid in crash_after and n_done >= crash_after[wid]:
            # injected crash: hard exit with the batch in flight — the
            # coordinator sees the dead connection and re-issues
            os._exit(3)
        current[0] = task.task_id
        try:
            done = _run_task(eng, wid, task)
        except BaseException:
            done = BatchDone(task.task_id, wid, task.batch_key,
                             error=traceback.format_exc())
        done.attempt = getattr(task, "attempt", 0)
        if done.error is None:
            obs.metrics().observe("worker.task_wall_s", done.wall_s)
        if rec.enabled:
            obs.metrics().gauge(f"obs.dropped.n{wid}", rec.dropped)
            _device_gauges(wid, eng.device)
            done.spans = rec.drain(512)
            done.metrics = obs.metrics().snapshot()
        if muted[0] and fault is not None and fault.mute_slowdown_s > 0:
            time.sleep(fault.mute_slowdown_s)
        try:
            _send(sock, lock, done)
        except OSError:
            break
        current[0] = None
        n_done += 1
        if wid in mute_after and n_done >= mute_after[wid]:
            muted[0] = not (wid in unmute_after
                            and n_done >= unmute_after[wid])
    stop.set()
    # join the beat thread before the interpreter finalizes (see
    # worker_main.worker_loop: a live daemon thread there aborts the
    # process once torch has run)
    beat_t.join(timeout=10.0)
    if cache is not None:
        cache.flush()
    try:
        sock.close()
    except OSError:
        pass


def _loopback_main(host: str, port: int,
                   fingerprint: dict | None) -> None:
    try:
        run_worker((host, port), fingerprint=fingerprint)
    except SystemExit as e:
        # rejection is expected for the mismatched-fingerprint workers:
        # surface the actionable reason and exit non-zero
        if e.code and not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
            raise SystemExit(4)
        raise


def spawn_loopback(addr: tuple[str, int], *,
                   fingerprint: dict | None = None) -> mp.process.BaseProcess:
    """Launch one fabric worker as a local spawn-context process
    dialing ``addr`` (a fresh interpreter, like the process runtime's
    children — no inherited torch or CUDA state)."""
    host, port = addr
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_loopback_main, args=(host, port, fingerprint),
                    daemon=True, name="adaparse-fabric-worker")
    p.start()
    return p
