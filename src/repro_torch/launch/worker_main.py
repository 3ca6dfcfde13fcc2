"""Worker-process entrypoint for the campaign worker runtime
(core/workers.ProcessWorkerPool).

Each worker is one spawned OS process (``multiprocessing`` spawn
context — a fresh interpreter, no inherited torch/CUDA state: fork
after CUDA initialisation is undefined, and the coordinator may hold a
context). It rebuilds its engine from the serialized ``WorkerSpec`` on
the spec's torch device (``repro_torch/device.py``: cuda unless "cpu";
without a card a cuda worker fails its start with its traceback, never
running on the CPU instead): re-registers any custom backends from the
spec's ``(module, attr)`` factory pairs, rebuilds the router's encoder
from the shipped numpy on that device
(``core/specs.materialize_router``), opens its own handle on the shared
``DiskResultStore`` directory (the store's WAL appends are
multi-process safe), configures the fleet-shared kernel tuning store
when the spec names one (``kernels/tuning_store``: a launch-knob winner
any worker or an earlier fleet published is a lookup here, and a miss
this worker sweeps on the card is published for the rest), and builds
an ``AdaParseEngine`` whose
content-addressed cache tag matches every other worker's — the
property that lets N processes share one result store and still
replay byte-identically. Several workers share one card, each with its
own CUDA context; each loads the kernel library the coordinator built.

Protocol (core/workers dataclasses over the two queues; the worker's
``WorkerSpec`` is the first item on its task queue):

- ``PrepareTask``  -> prepare + route; complete locally and reply
  ``BatchDone(records, telemetry)``, or — when the task forwards and
  expensive work was routed — reply ``BatchDone(prep, plan)`` for the
  coordinator to forward to the re-parse pool.
- ``CompleteTask`` -> expensive re-parse of a forwarded batch; reply
  ``BatchDone(records, telemetry)``.
- ``Heartbeat``    -> sent on a fixed interval from a daemon thread
  (and once at startup, the ready signal). The coordinator treats a
  missed deadline as a wedged worker and re-issues its in-flight work.
- ``None``         -> shutdown sentinel; flush the store and exit. A
  worker whose coordinator process has died takes that as the sentinel
  too (``_next_item``): it never blocks for ever on its task queue, so
  it never outlives its coordinator holding a CUDA context.

With the shm transport (``WorkerSpec.shm_base`` set) the bulk payloads
ride in ``core/shm`` arena slots instead of the queues: inbound tasks
carry a generation-tagged ``ShmRef`` the worker reads (a stale ref —
the task completed elsewhere and its slot was reclaimed — becomes an
error reply the coordinator drops at the dedup gate), and outbound
records / forwarded preps are written into the worker's own response
arena, falling back to inline payloads under slot pressure.

Every payload that leaves a worker holds host numpy only: a forwarded
prep's routing tensors (the llm variant's first-page tokens and mask,
on the card) are moved to the host in ``_run_task`` before the reply,
on both transports, so no CUDA IPC handle or card tensor ever reaches
the coordinator.

With tracing on (``WorkerSpec.obs_enabled``) the metrics snapshot the
worker piggybacks on its replies and heartbeats also carries, as
gauges, the launch count of every hand-written kernel in this process
(``kernel.launches.<name>.n<worker>``), its autotune sweeps
(``autotune.sweeps.n<worker>``, ``autotune_common.sweeps_run()``) and
the keys of its tuning store (``autotune.store_keys.n<worker>``, -1
without one) and, on a card, its peak allocated bytes
(``worker.peak_bytes.n<worker>``): the launches and sweeps happen in
the worker, so only the worker can count them.

A worker-side exception never wedges the pool: the traceback travels
back as ``BatchDone.error``. ``wall_s`` on every reply is the real
measured stage duration — the process runtime's replacement for the
simulated clocks, and the signal the adaptive controller's throughput
EWMA consumes.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import threading
import time
import traceback


def _build_engine(spec):
    from repro_torch import device as device_lib
    from repro_torch.core import backends as B
    from repro_torch.core import specs as spec_lib
    from repro_torch.core.engine import AdaParseEngine
    from repro_torch.core.quality import QualityProbe

    dev = device_lib.resolve(spec.device)

    for mod_name, attr in spec.backend_specs:
        factory = getattr(importlib.import_module(mod_name), attr)
        B.register_backend(factory(), overwrite=True)
    router = spec_lib.materialize_router(spec.router, dev)
    if getattr(spec, "fingerprint", None) is not None:
        # the coordinator stamped a content fingerprint on the spec
        # before shipping it; recompute from what actually arrived —
        # the router's from the encoder rebuilt on this device — and
        # refuse to run on drift (a worker built from a diverged spec
        # would silently break byte-identical record parity)
        mismatch = spec_lib.describe_mismatch(
            spec.fingerprint, spec_lib.spec_fingerprint(
                dataclasses.replace(spec, router=router)))
        if mismatch:
            raise RuntimeError(f"worker {spec.worker_id} spec drifted "
                               f"in transit: {mismatch}")
    if getattr(spec, "tuning_dir", None) is not None:
        # one flock-shared tuning store per fleet: a knob swept by any
        # worker (or a previous fleet) is a lookup for the rest
        from repro_torch.kernels import tuning_store
        tuning_store.configure(spec.tuning_dir)
    cache = (B.DiskResultStore(spec.cache_dir,
                               max_bytes=spec.cache_max_bytes)
             if spec.cache_dir is not None else None)
    probe = (QualityProbe(spec.probe_cfg, device=dev)
             if spec.probe_cfg is not None else None)
    ecfg = (spec.ecfg if spec.alpha is None
            else dataclasses.replace(spec.ecfg, alpha=spec.alpha))
    return AdaParseEngine(ecfg, router, spec.corpus_cfg,
                          image_degraded=spec.image_degraded,
                          text_degraded=spec.text_degraded,
                          cache=cache, probe=probe, device=dev), cache


def _host_prep(prep):
    """``prep`` with its routing tensors moved to the host as numpy,
    for a reply that forwards it to another process."""
    import torch

    rh = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in prep.route_host.items()}
    return dataclasses.replace(prep, route_host=rh)


def _device_gauges(wid: int, dev) -> None:
    """Publish this process's kernel launch counts, autotune sweeps and
    tuning-store keys, and its peak card memory, as gauges of the
    metrics snapshot the worker ships."""
    from repro_torch.core import obs
    from repro_torch.kernels import autotune_common, cuda_lib, tuning_store

    reg = obs.metrics()
    for name, n in cuda_lib.launch_counts().items():
        reg.gauge(f"kernel.launches.{name}.n{wid}", n)
    reg.gauge(f"autotune.sweeps.n{wid}", autotune_common.sweeps_run())
    store = tuning_store.get_store()
    reg.gauge(f"autotune.store_keys.n{wid}",
              len(store) if store is not None else -1)
    if dev.type == "cuda":
        import torch

        reg.gauge(f"worker.peak_bytes.n{wid}",
                  torch.cuda.max_memory_allocated(dev))


def _run_task(eng, wid, task):
    from repro_torch.core.workers import BatchDone, CompleteTask

    t0 = time.perf_counter()
    eng.set_alpha(task.alpha)        # no-op when unchanged
    if isinstance(task, CompleteTask):
        recs = eng.complete_batch(task.prep, task.plan, node_id=wid,
                                  ingest_engine=eng)
        key = eng._cache_key(task.prep.docs, task.batch_key)
        if key is not None:
            eng.cache.store(key, recs)
        return BatchDone(task.task_id, wid, task.batch_key, records=recs,
                         telemetry=eng.telemetry[-1],
                         wall_s=time.perf_counter() - t0)
    key, prep, cached = eng.prepare_or_lookup(
        task.docs, batch_key=task.batch_key, use_cache=task.use_cache)
    if cached is not None:
        eng._account_cache_hit(cached, task.batch_key)
        return BatchDone(task.task_id, wid, task.batch_key, records=cached,
                         telemetry=eng.telemetry[-1], cached=True,
                         wall_s=time.perf_counter() - t0)
    plan = eng.route_batch(prep)
    if task.forward and plan.expensive_idx.size:
        return BatchDone(task.task_id, wid, task.batch_key,
                         prep=_host_prep(prep), plan=plan,
                         wall_s=time.perf_counter() - t0)
    recs = eng.complete_batch(prep, plan, node_id=wid)
    if key is not None:
        eng.cache.store(key, recs)
    return BatchDone(task.task_id, wid, task.batch_key, records=recs,
                     telemetry=eng.telemetry[-1],
                     wall_s=time.perf_counter() - t0)


def _decode_payload(shm_t, task) -> None:
    """Resolve a task's shm payload in place (no-op for inline
    payloads). Raises ``ShmStale`` when the slot was reclaimed — the
    task already completed elsewhere."""
    from repro_torch.core.workers import CompleteTask

    if getattr(task, "payload", None) is None:
        return
    obj = shm_t.read_task(task.payload)
    if isinstance(task, CompleteTask):
        task.prep, task.plan = obj
    else:
        task.docs = obj
    task.payload = None


def _encode_reply(shm_t, done) -> None:
    """Move a successful reply's bulk (records, or the forwarded
    (prep, plan)) into the worker's response arena; under slot pressure
    the reply just stays inline."""
    if done.error is not None:
        return
    if done.records is not None:
        ref = shm_t.encode_result(done.records)
        if ref is not None:
            done.records, done.payload, done.payload_kind = \
                None, ref, "records"
    elif done.prep is not None:
        ref = shm_t.encode_result((done.prep, done.plan))
        if ref is not None:
            done.prep = done.plan = None
            done.payload, done.payload_kind = ref, "prep"


#: seconds between checks that the coordinator is still alive
_PARENT_POLL_S = 1.0


def _next_item(task_q):
    """The next item on the task queue, or None (the shutdown sentinel)
    once the coordinator process has died: the wait polls, so an
    orphaned worker exits instead of blocking for ever."""
    import multiprocessing
    import queue

    parent = multiprocessing.parent_process()
    while True:
        try:
            return task_q.get(timeout=_PARENT_POLL_S)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                return None


def worker_loop(task_q, result_q) -> None:
    """Process main: take the ``WorkerSpec`` (the first item on the task
    queue), build the engine, heartbeat, serve tasks until the shutdown
    sentinel."""
    from repro_torch.core import obs
    from repro_torch.core.workers import BatchDone, Heartbeat

    spec = _next_item(task_q)
    if spec is None:
        return
    wid = spec.worker_id
    current: list[int | None] = [None]
    muted = [False]
    stop = threading.Event()
    # the per-process observability plane: a noop recorder unless the
    # coordinator asked for tracing (WorkerSpec.obs_enabled); configure
    # before the engine build so warmup instrumentation lands in it
    rec = obs.configure(enabled=getattr(spec, "obs_enabled", False),
                        cap=getattr(spec, "obs_span_cap", 8192),
                        node=wid)
    try:
        eng, cache = _build_engine(spec)
        shm_t = None
        if spec.shm_base is not None:
            from repro_torch.core.shm import WorkerShmTransport
            shm_t = WorkerShmTransport(spec.shm_base, wid, spec.n_workers,
                                       spec.shm_resp_slots)
    except BaseException:
        result_q.put(BatchDone(task_id=-1, worker=wid, batch_key=-1,
                               error=traceback.format_exc()))
        return

    def _queue_depth() -> int:
        try:
            return task_q.qsize()
        except (NotImplementedError, OSError):
            return -1                   # platform can't report depth

    def _heartbeat() -> Heartbeat:
        """Liveness + load context: queue depth and a monotonic send
        stamp let the coordinator tell backlog from wedge, and the
        beacon piggybacks a bounded span-ring drain when tracing is
        on (deque ops are GIL-atomic — no lock against the task
        loop)."""
        depth = _queue_depth()
        obs.metrics().gauge(f"worker.queue_depth.n{wid}", depth)
        if rec.enabled:
            _device_gauges(wid, eng.device)
        return Heartbeat(
            wid, time.time(), current[0],
            sent_mono=time.monotonic(), queue_depth=depth,
            spans=rec.drain(128) if rec.enabled else None,
            metrics=obs.metrics().snapshot() if rec.enabled else None)

    def beat():
        while not stop.wait(spec.heartbeat_interval_s):
            if not muted[0]:
                result_q.put(_heartbeat())

    beat_t = threading.Thread(target=beat, daemon=True)
    beat_t.start()
    result_q.put(_heartbeat())                      # ready signal

    fault = spec.fault
    crash_after = dict(fault.crash_after) if fault else {}
    mute_after = dict(fault.mute_after) if fault else {}
    unmute_after = dict(getattr(fault, "unmute_after", ()) or ()) \
        if fault else {}
    n_done = 0
    while True:
        task = _next_item(task_q)
        if task is None:
            break
        if wid in crash_after and n_done >= crash_after[wid]:
            # injected crash: hard exit with the batch in flight (no
            # reply, no more heartbeats — the coordinator's liveness
            # check must recover it)
            os._exit(3)
        current[0] = task.task_id
        try:
            if shm_t is not None:
                _decode_payload(shm_t, task)
            done = _run_task(eng, wid, task)
            if shm_t is not None:
                _encode_reply(shm_t, done)
        except BaseException:
            done = BatchDone(task.task_id, wid, task.batch_key,
                             error=traceback.format_exc())
        done.attempt = getattr(task, "attempt", 0)
        if done.error is None:
            obs.metrics().observe("worker.task_wall_s", done.wall_s)
        if rec.enabled:
            # piggyback the observability plane on the reply: a bounded
            # ring drain plus the cumulative metrics snapshot (the
            # coordinator keeps the latest per worker and folds)
            obs.metrics().gauge(f"obs.dropped.n{wid}", rec.dropped)
            _device_gauges(wid, eng.device)
            done.spans = rec.drain(512)
            done.metrics = obs.metrics().snapshot()
        if muted[0] and fault is not None and fault.mute_slowdown_s > 0:
            time.sleep(fault.mute_slowdown_s)
        result_q.put(done)
        current[0] = None
        n_done += 1
        if wid in mute_after and n_done >= mute_after[wid]:
            # wedged-looking straggler; with unmute_after the mute
            # window is [mute_after, unmute_after) — a flap
            muted[0] = not (wid in unmute_after
                            and n_done >= unmute_after[wid])
    stop.set()
    # join the beat thread before the interpreter finalizes: a daemon
    # thread still alive then is ended by pthread_exit, and once the
    # encoder has run torch's C++ runtime turns that unwind into an
    # abort (the worker exits with SIGABRT after its last reply)
    beat_t.join(timeout=10.0)
    if shm_t is not None:
        shm_t.close()
    if cache is not None:
        cache.flush()
