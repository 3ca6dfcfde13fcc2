"""The port's copy of ``repro.distributed.fault`` against the reference
on the same sequences of beats, step durations and chip counts."""
import numpy as np
import pytest

from repro.distributed import fault as JF
from repro_torch.distributed import fault as TF


def test_heartbeat_monitor_matches_reference():
    rng = np.random.RandomState(0)
    j, t = JF.HeartbeatMonitor(5.0), TF.HeartbeatMonitor(5.0)
    now = 0.0
    for _ in range(200):
        now += float(rng.exponential(1.0))
        w = int(rng.randint(6))
        j.beat(w, now)
        t.beat(w, now)
        probe = now + float(rng.uniform(0, 8))
        assert t.dead_workers(probe) == j.dead_workers(probe)


def test_straggler_detector_matches_reference():
    rng = np.random.RandomState(1)
    j, t = JF.StragglerDetector(2.0, 8), TF.StragglerDetector(2.0, 8)
    assert t.stragglers() == j.stragglers() == []
    for i in range(300):
        w = int(rng.randint(5))
        d = float(rng.exponential(1.0)) * (4.0 if w == 3 and i > 100 else 1)
        j.record(w, d)
        t.record(w, d)
        assert t.median_all() == j.median_all()
        assert t.stragglers() == j.stragglers()
    assert 3 in t.stragglers()


@pytest.mark.parametrize("axes,old", [
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)),
    (("data",), (8,)),
])
@pytest.mark.parametrize("chips", [1, 7, 64, 255, 256, 512, 1024])
def test_plan_rescale_matches_reference(axes, old, chips):
    j = JF.plan_rescale(axes, old, chips)
    t = TF.plan_rescale(axes, old, chips)
    assert (t.old_shape, t.new_shape, t.axes, t.valid) == \
        (j.old_shape, j.new_shape, j.axes, j.valid)
