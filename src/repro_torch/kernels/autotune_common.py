"""Shared launch-knob autotune harness for the port's CUDA kernels.

Every kernel autotuner is the same loop — time a candidate grid at a
shape, pick the argmin, cache the winner so dispatch picks it up
transparently — so the loop lives here once and ``budget_route`` /
``ngram_score`` / ``fast_features`` supply only their run closures and
candidate grids. Each knob changes how a kernel is launched on Hopper
(threads a block, rows a block of a grid), never what it computes: the
candidates give the default launch's outputs bit for bit.

Winners are cached in two layers:

* an in-process dict keyed by (kernel, shape, backend, device mode);
* the optional persistent ``tuning_store`` (``serve.py --tuning-dir``),
  the same key serialized to ``v1|kernel|shape|backend|mode`` — the
  fleet-wide layer that makes a warm restart sweep-free.

``backend`` is the card's name (``torch.cuda.get_device_name``) and the
mode is always ``device``: a winner timed on one kind of card is never
read on another. ``lookup`` consults memory then store; ``record``
publishes to both. ``ensure_tuned`` is the dispatch-time hook: return
the tuned value if any layer has it, otherwise sweep-and-publish **only
when a persistent store is configured** (an unconfigured process
launches the default rather than paying a surprise sweep on the hot
path). ``sweeps_run()`` counts sweeps process-wide so tests and the
smoke run can assert the warm-restart contract: zero re-sweeps.

Where this differs from the JAX package's harness
(``repro.kernels.autotune_common``): there, a CPU host sweeps the Pallas
kernels in interpret mode. Here a CPU tensor runs the kernel's plain
PyTorch version, which has no launch knob, so on the CPU ``ensure_tuned``
and ``tuned_value`` return the default without a sweep and ``lookup``
finds nothing. A sweep is timed on the card (``device_ms``: CUDA events
around back-to-back launches) and raises without one, as the
reference's device sweep raises off a TPU.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.kernels import tuning_store

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One sweep's outcome: the winning parameter value at a shape."""

    kernel: str                        # "budget_route" | "ngram_score" | ...
    shape: tuple[int, ...]             # kernel-specific shape tuple
    backend: str                       # the card's name at sweep time
    device: bool                       # always True: timed on the card
    param: str                         # e.g. "threads"
    value: int                         # the winner
    timings_s: tuple[tuple[int, float], ...]   # (candidate, best-of-reps)


_CACHE: dict[tuple, TuneRecord] = {}
_SWEEPS = 0
_BACKENDS: dict[int, str] = {}
# a dispatch-time miss sweeps once even when prefetch threads meet the
# same shape together
_SWEEP_LOCK = threading.Lock()


def _cuda(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def backend_name(device=None) -> str:
    """The name of the card behind a CUDA ``device``; raises without a
    card."""
    dev = _cuda(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"autotune device sweep needs a CUDA card (device {dev}, "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}); "
            f"the plain version a CPU tensor runs has no launch knob")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name = _BACKENDS.get(idx)
    if name is None:
        name = _BACKENDS[idx] = torch.cuda.get_device_name(idx)
    return name


def cache_key(kernel: str, shape, backend: str, device: bool = True) -> tuple:
    return (str(kernel), tuple(int(s) for s in shape), str(backend),
            bool(device))


def store_key(kernel: str, shape, backend: str, device: bool = True) -> str:
    shape_s = "x".join(str(int(s)) for s in shape)
    mode = "device" if device else "interpret"
    return f"v{SCHEMA_VERSION}|{kernel}|{shape_s}|{backend}|{mode}"


def clear_cache() -> None:
    """Drop every kernel's in-memory winners (not the persistent store)
    and zero the sweep counter."""
    global _SWEEPS
    _CACHE.clear()
    _SWEEPS = 0


def sweeps_run() -> int:
    """Process-wide count of timed sweeps since the last clear_cache()."""
    return _SWEEPS


def _record_to_dict(rec: TuneRecord) -> dict:
    d = dataclasses.asdict(rec)
    d["shape"] = list(rec.shape)
    d["timings_s"] = [[c, t] for c, t in rec.timings_s]
    return d


def _record_from_dict(d: dict) -> TuneRecord:
    return TuneRecord(
        kernel=str(d["kernel"]), shape=tuple(int(s) for s in d["shape"]),
        backend=str(d["backend"]), device=bool(d["device"]),
        param=str(d["param"]), value=int(d["value"]),
        timings_s=tuple((int(c), float(t)) for c, t in d["timings_s"]))


def lookup(kernel: str, shape, device=None) -> TuneRecord | None:
    """The cached winner for (kernel, shape, this card): memory first,
    then the persistent store (a store hit is promoted into the
    in-memory cache). None on a CPU ``device``: the plain version is
    never tuned."""
    if _cuda(device).type != "cuda":
        return None
    backend = backend_name(device)
    key = cache_key(kernel, shape, backend)
    rec = _CACHE.get(key)
    if rec is not None:
        return rec
    store = tuning_store.get_store()
    if store is not None:
        raw = store.get(store_key(kernel, shape, backend))
        if raw is not None:
            try:
                rec = _record_from_dict(raw)
            except (KeyError, TypeError, ValueError):
                return None             # foreign/corrupt record: re-sweep
            _CACHE[key] = rec
            return rec
    return None


def record(rec: TuneRecord) -> TuneRecord:
    """Publish a winner to the in-memory cache and, when configured,
    the persistent store."""
    _CACHE[cache_key(rec.kernel, rec.shape, rec.backend, rec.device)] = rec
    store = tuning_store.get_store()
    if store is not None:
        store.put(store_key(rec.kernel, rec.shape, rec.backend, rec.device),
                  _record_to_dict(rec))
    return rec


def tuned_value(kernel: str, shape, default: int, device=None) -> int:
    """The tuned winner for this shape, or ``default`` (no sweep)."""
    rec = lookup(kernel, shape, device=device)
    return rec.value if rec is not None else int(default)


def device_ms(launch, reps: int = 100, warmup: int = 5) -> float:
    """Device ms per launch over ``reps`` back-to-back launches: CUDA
    events around the run, elapsed time over the count, after a warm-up.
    The run is queued behind a sleep kernel, so the card finds every
    launch queued and runs them without waiting for the host; the sleep
    is lengthened until the host has queued the whole run before the
    first event fires (else a small kernel would read the host's
    launch rate)."""
    for _ in range(warmup):
        launch()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(8):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            launch()
        b.record()
        queued_ahead = not a.query()
        b.synchronize()
        if queued_ahead:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("the host could not queue the launches ahead of "
                       "the card")


def _time_candidate(run, device) -> float:
    """Seconds a launch of ``run`` takes on the card of ``device``."""
    with torch.cuda.device(_cuda(device)):
        return device_ms(run) / 1e3


def sweep(kernel: str, shape, param: str,
          candidates: tuple[int, ...], make_run, *,
          repeats: int = 2, device=None) -> TuneRecord:
    """Time every candidate on the card (best of ``repeats`` readings of
    ``device_ms``, each after its own warm-up), record and return the
    winner. ``make_run(candidate)`` returns a zero-arg closure that
    launches the kernel once without synchronising; candidates must
    already be deduped/clamped by the caller (each kernel's clamp rule
    differs). Raises without a card."""
    global _SWEEPS
    backend = backend_name(device)
    _SWEEPS += 1
    timings: list[tuple[int, float]] = []
    for cand in candidates:
        run = make_run(int(cand))
        best = min(_time_candidate(run, device)
                   for _ in range(max(1, repeats)))
        timings.append((int(cand), best))
    winner = min(timings, key=lambda t: t[1])[0]
    return record(TuneRecord(
        kernel=str(kernel), shape=tuple(int(s) for s in shape),
        backend=backend, device=True, param=str(param),
        value=int(winner), timings_s=tuple(timings)))


def ensure_tuned(kernel: str, shape, param: str,
                 candidates: tuple[int, ...], make_run, default: int, *,
                 repeats: int = 1, device=None) -> int:
    """Dispatch-time tuning hook: cached winner if any layer has one;
    otherwise sweep-and-publish when a persistent store is configured
    (the sweep amortizes across the fleet), else just the default. On a
    CPU ``device``: the default, never a sweep."""
    if _cuda(device).type != "cuda":
        return int(default)
    rec = lookup(kernel, shape, device=device)
    if rec is not None:
        return rec.value
    if tuning_store.get_store() is None:
        return int(default)
    with _SWEEP_LOCK:
        rec = lookup(kernel, shape, device=device)
        if rec is not None:
            return rec.value
        return sweep(kernel, shape, param, candidates, make_run,
                     repeats=repeats, device=device).value
