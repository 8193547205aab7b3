"""The port's step-time collector and device probe
(``distributedmnist_tpu_torch/obsv/timing.py``) against the reference's
(``distributedmnist_tpu/obsv/timing.py``), on the same inputs:
``compute_stats``, and ``StepTimeCollector``'s ``matrix``,
``per_replica_stats``, ``per_step_stats``, ``host_step_stats``,
``rolling_cdf`` and ``report`` (keys and values), all exact — both run
the same numpy on the same arrays. ``ReplicaDeviceProbe`` on the CPU
times noted work around its dispatch, for this process's replicas only.
Its CUDA-event path runs in ``chip_smoke.py``'s ``dist`` phase."""

import time

import numpy as np
import pytest
import torch

from distributedmnist_tpu.obsv import timing as ref_timing
from distributedmnist_tpu_torch.core.mesh import Topology
from distributedmnist_tpu_torch.obsv import timing

N = 8


def _feed(collectors, steps: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        row = rng.lognormal(3.0, 0.5, N).astype(np.float32)
        host = float(rng.uniform(0.001, 0.05))
        for c in collectors:
            c.add(row.copy(), host)


@pytest.mark.parametrize("samples", [[], [3.0], list(range(17)),
                                     np.random.default_rng(1).normal(
                                         size=100).tolist()])
def test_compute_stats_matches(samples):
    got = timing.compute_stats(np.asarray(samples)).to_dict()
    want = ref_timing.compute_stats(np.asarray(samples)).to_dict()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))


@pytest.mark.parametrize("steps,window", [(0, None), (3, 4), (12, 4),
                                          (30, None)])
def test_collector_matches_reference(steps, window):
    port, ref = timing.StepTimeCollector(N), ref_timing.StepTimeCollector(N)
    if window is not None:
        port.enable_rolling_cdf(window)
        ref.enable_rolling_cdf(window)
    _feed([port, ref], steps, seed=steps)
    np.testing.assert_array_equal(port.matrix(), ref.matrix())
    assert [s.to_dict() for s in port.per_replica_stats()] == \
        [s.to_dict() for s in ref.per_replica_stats()]
    for name in ("per_step_stats", "host_step_stats"):
        np.testing.assert_array_equal(
            list(getattr(port, name)().to_dict().values()),
            list(getattr(ref, name)().to_dict().values()))
    assert port.rolling_cdf() == ref.rolling_cdf()
    for c in (port, ref):
        c.add_snapshot_stall_ms(12.5)
    got, want = port.report(), ref.report()
    assert got.keys() == want.keys()
    assert str(got) == str(want)  # nan == nan where a series is empty


def test_collector_capacity_and_window():
    c = timing.StepTimeCollector(N, capacity=5)
    _feed([c], 9, seed=0)
    assert c.matrix().shape == (5, N) and c.report()["num_steps"] == 5
    with pytest.raises(ValueError, match="window_steps"):
        c.enable_rolling_cdf(0)


def test_device_probe_times_noted_work_on_the_cpu():
    """Process 1 of 2, 8 replicas: replicas 4-7 are its own. Work noted
    for replica 5 is timed from its dispatch; work for replica 1 (another
    process's) is ignored; a second measure starts from nothing."""
    topo = Topology(num_replicas=N, process_index=1, process_count=2)
    probe = timing.ReplicaDeviceProbe(topo, torch.device("cpu"))
    assert (probe.first, probe.count) == (4, 4)
    np.testing.assert_array_equal(probe.measure_skew_ms(), np.zeros(4))
    at = time.perf_counter()
    time.sleep(0.02)
    probe.note(5, torch.zeros(1), at)
    probe.note(1, torch.zeros(1), at)
    skew = probe.measure_skew_ms()
    assert skew.dtype == np.float32 and skew.shape == (4,)
    assert skew[1] >= 20.0 and (skew[[0, 2, 3]] == 0).all(), skew
    np.testing.assert_array_equal(probe.measure_skew_ms(), np.zeros(4))
