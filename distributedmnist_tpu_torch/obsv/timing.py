"""Step-time CDF collection and per-replica device timing (≙
``distributedmnist_tpu/obsv/timing.py``).

The reference's workers gossip their step times over RPC; its port to
one SPMD program gathers them as an ``[n]`` vector per step, and so does
this one: every process holds the modeled ``[n]`` times of each step
(``metrics["step_times_ms"]``, a host numpy array here, computed alike
on every process from the summed measured vector). The collector keeps
them with the host's own step time and reports per-replica and
barrier (slowest replica) percentiles, and — when the adaptive
discipline controller is armed — the rolling-window CDF it decides on.

:class:`ReplicaDeviceProbe` measures each local replica's device-side
drain on CUDA events, for ``sync.measure_device_skew``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

PERCENTILES = (50.0, 80.0, 90.0, 95.0, 99.0, 100.0)


@dataclasses.dataclass
class CdfStats:
    count: int
    mean: float
    stdev: float
    percentiles: dict[str, float]

    def to_dict(self) -> dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "stdev": self.stdev,
                **{f"p{p:g}": v for p, v in zip(PERCENTILES,
                                                 self.percentiles.values())}}


def compute_stats(samples: np.ndarray) -> CdfStats:
    samples = np.asarray(samples, np.float64).ravel()
    if samples.size == 0:
        return CdfStats(0, float("nan"), float("nan"),
                        {f"p{p:g}": float("nan") for p in PERCENTILES})
    pcts = np.percentile(samples, PERCENTILES)
    return CdfStats(
        count=int(samples.size),
        mean=float(samples.mean()),
        stdev=float(samples.std()),
        percentiles={f"p{p:g}": float(v) for p, v in zip(PERCENTILES, pcts)},
    )


class StepTimeCollector:
    """Per-step ``[n_replicas]`` time vectors (host arrays), the host's
    step time, and each save's stall, up to ``capacity`` steps."""

    def __init__(self, num_replicas: int, capacity: int = 100_000):
        self.num_replicas = num_replicas
        self.capacity = capacity
        self._rows: list[np.ndarray] = []
        self._host_steps: list[float] = []  # host-measured seconds per step
        self._snapshot_stalls: list[float] = []  # ms per save
        # rolling-CDF window, set only when the adaptive discipline
        # controller is armed: the report then carries the per-replica
        # p50/p90/p99 over the last window, the gauges it decides on
        self._rolling_window: int | None = None

    def add(self, per_replica_times, host_step_seconds: float | None = None
            ) -> None:
        if len(self._rows) < self.capacity:
            self._rows.append(np.asarray(per_replica_times))
        if (host_step_seconds is not None
                and len(self._host_steps) < self.capacity):
            self._host_steps.append(host_step_seconds)

    def matrix(self) -> np.ndarray:
        """``[steps, n_replicas]`` modeled step times (ms)."""
        if not self._rows:
            return np.zeros((0, self.num_replicas))
        return np.stack(self._rows)

    def per_replica_stats(self) -> list[CdfStats]:
        m = self.matrix()
        return ([compute_stats(m[:, i]) for i in range(m.shape[1])]
                if m.size else [])

    def per_step_stats(self) -> CdfStats:
        """Distribution over each step's slowest replica (the barrier
        time of a full-sync step)."""
        m = self.matrix()
        return compute_stats(m.max(axis=1) if m.size else np.empty(0))

    def host_step_stats(self) -> CdfStats:
        return compute_stats(np.asarray(self._host_steps))

    def add_snapshot_stall_ms(self, ms: float) -> None:
        """One checkpoint save's stall of the step loop."""
        if len(self._snapshot_stalls) < self.capacity:
            self._snapshot_stalls.append(float(ms))

    def snapshot_stall_stats(self) -> CdfStats:
        return compute_stats(np.asarray(self._snapshot_stalls, np.float64))

    def enable_rolling_cdf(self, window_steps: int) -> None:
        """Arm the rolling-window gauges (the Trainer sets this iff
        ``sync.adaptive``)."""
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self._rolling_window = int(window_steps)

    def rolling_cdf(self) -> dict[str, Any] | None:
        """Per-replica p50/p90/p99 (and the pooled tail ratio) over the
        last window of rows — None until the window is armed and full,
        so callers never decide on a half-filled CDF."""
        w = self._rolling_window
        if w is None or len(self._rows) < w:
            return None
        tail = self.matrix()[-w:]
        pcts = np.percentile(tail, (50.0, 90.0, 99.0), axis=0)  # [3, n]
        pooled = np.percentile(tail, (50.0, 90.0, 99.0))
        p50 = float(pooled[0])
        # the fastest replica's median is the cohort pace: the pooled
        # p50 drifts to the midpoint once about half the replicas
        # straggle, so the controller's tail ratio divides by this
        fast_p50 = float(pcts[0].min())
        return {
            "window_steps": w,
            "per_replica": [
                {"p50": float(pcts[0, i]), "p90": float(pcts[1, i]),
                 "p99": float(pcts[2, i])}
                for i in range(tail.shape[1])],
            "p50_ms": p50,
            "p90_ms": float(pooled[1]),
            "p99_ms": float(pooled[2]),
            "fast_p50_ms": fast_p50,
            "tail_ratio": (float(pooled[2]) / fast_p50
                           if fast_p50 > 0 else 0.0),
        }

    def report(self) -> dict[str, Any]:
        """The reference's ``timing`` summary keys."""
        out = {
            "num_steps": len(self._rows),
            "per_replica": [s.to_dict() for s in self.per_replica_stats()],
            "barrier": self.per_step_stats().to_dict(),
            "host_wall": self.host_step_stats().to_dict(),
        }
        if self._rolling_window is not None:
            rolling = self.rolling_cdf()
            if rolling is not None:
                out["rolling_cdf"] = rolling
        if self._snapshot_stalls:
            out["snapshot_stall_ms"] = self.snapshot_stall_stats().to_dict()
        return out


class ReplicaDeviceProbe:
    """Per-replica device-side drain times of work dispatched outside the
    train step (≙ the reference's ``ReplicaDeviceProbe``).

    The reference probes one device per local replica with a token op,
    min-subtracted across devices, and times each noted output from its
    own dispatch. A process of the port holds all its local replicas on
    one device, so every local replica's queue is the same queue and the
    token part is zero: what remains is the noted work. :meth:`note`
    records a ``torch.cuda.Event`` on the device's current stream after
    the noted work; :meth:`measure_skew_ms` polls each event's
    ``query()`` and returns each noted replica's dispatch-to-done time
    (0 for the others). That time also covers whatever the stream still
    had queued ahead of the noted work (the step's own drain): an upper
    bound on the replica's excess that keeps its order, which is what
    the quorum ranks on. On the CPU the noted work ran synchronously
    when it was dispatched, so it is timed around the dispatch."""

    def __init__(self, topo, device: torch.device) -> None:
        self.first = topo.first_replica
        self.count = topo.local_replica_count
        self.device = device
        self._noted: list[list] = [[] for _ in range(self.count)]

    def note(self, replica: int, out, dispatched_at: float | None = None
             ) -> None:
        """Register a just-dispatched computation (its output ``out``,
        dispatched at ``dispatched_at`` on the ``time.perf_counter``
        clock, default now) as part of global ``replica``'s device queue
        for the next :meth:`measure_skew_ms`; no-op for a replica of
        another process."""
        i = replica - self.first
        if not 0 <= i < self.count:
            return
        now = time.perf_counter()
        at = now if dispatched_at is None else dispatched_at
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._noted[i].append((out, ev, at, None))
        else:
            self._noted[i].append((out, None, at, now))

    def measure_skew_ms(self) -> np.ndarray:
        """``[local replicas]`` float32 ms: each replica's slowest noted
        work, dispatch to done (waits for it); 0 where nothing was
        noted."""
        noted, self._noted = self._noted, [[] for _ in range(self.count)]
        skew = np.zeros(self.count, np.float64)
        waiting = []
        for i, items in enumerate(noted):
            for _, ev, at, done in items:
                if ev is None:
                    skew[i] = max(skew[i], (done - at) * 1e3)
                else:
                    waiting.append((i, ev, at))
        while waiting:
            now = time.perf_counter()
            still = []
            for i, ev, at in waiting:
                if ev.query():
                    skew[i] = max(skew[i], (now - at) * 1e3)
                else:
                    still.append((i, ev, at))
            waiting = still
            if waiting:
                time.sleep(0.0002)
        return skew.astype(np.float32)
