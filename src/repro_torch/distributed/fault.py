"""Fault tolerance & elasticity scaffolding (single-host simulation of the
multi-host control plane; the seams are the real production interfaces).
A copy of ``repro.distributed.fault`` (pure Python and numpy);
``launch/train.py`` records its step times in a ``StragglerDetector``.

- HeartbeatMonitor: worker liveness with deadline-based failure marking.
- StragglerDetector: per-step duration tracking; flags workers slower than
  ``factor``x the rolling median (mitigation: the engine re-issues their
  batches; the training driver drops to the backup schedule).
- ElasticPlan: given a failed/new node set, choose the largest valid mesh
  (divisible data axis) and map old->new checkpoint shardings — in the
  JAX package restore handles the actual resharding; the port restores
  onto one device (``checkpoint.restore(..., device=)``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    durations: deque


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 60.0):
        self.deadline = deadline_s
        self.workers: dict[int, WorkerState] = {}

    def beat(self, worker: int, now: float | None = None):
        now = time.monotonic() if now is None else now
        st = self.workers.setdefault(worker, WorkerState(now, deque(maxlen=32)))
        st.last_beat = now

    def dead_workers(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [w for w, st in self.workers.items()
                if now - st.last_beat > self.deadline]


class StragglerDetector:
    def __init__(self, factor: float = 2.0, window: int = 32):
        self.factor = factor
        self.durations: dict[int, deque] = {}
        self.window = window

    def record(self, worker: int, duration_s: float):
        self.durations.setdefault(
            worker, deque(maxlen=self.window)).append(duration_s)

    def median_all(self) -> float:
        import numpy as np
        alld = [d for ds in self.durations.values() for d in ds]
        return float(np.median(alld)) if alld else 0.0

    def stragglers(self) -> list[int]:
        import numpy as np
        med = self.median_all()
        if med <= 0:
            return []
        out = []
        for w, ds in self.durations.items():
            if len(ds) >= 4 and float(np.median(ds)) > self.factor * med:
                out.append(w)
        return out


@dataclasses.dataclass
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def valid(self) -> bool:
        return all(s > 0 for s in self.new_shape)


def plan_rescale(axes: tuple[str, ...], old_shape: tuple[int, ...],
                 available_chips: int, model_axis: str = "model"
                 ) -> ElasticPlan:
    """Keep the model axis fixed (TP degree is architectural); shrink/grow
    the data (and pod) axes to the largest size the chips allow."""
    model_idx = axes.index(model_axis) if model_axis in axes else None
    model = old_shape[model_idx] if model_idx is not None else 1
    other = available_chips // model
    new = list(old_shape)
    if "pod" in axes:
        pod_idx = axes.index("pod")
        data_idx = axes.index("data")
        # prefer whole pods; fall back to shrinking data
        pods = max(other // old_shape[data_idx], 1) \
            if other >= old_shape[data_idx] else 1
        new[pod_idx] = pods
        new[data_idx] = other // pods
    else:
        data_idx = axes.index("data")
        new[data_idx] = other
    return ElasticPlan(tuple(old_shape), tuple(new), axes)
