"""Contribution-mask policies (≙ ``distributedmnist_tpu/parallel/
policies.py``): does replica r's gradient enter this step's masked
mean?

Each replica gets a modeled step time — a host-measured base plus a
synthetic straggler draw from its ``replica_key(root, "straggler",
step, r)`` — and the disciplines select on it: the k fastest (quorum,
ranked by lexicographic (time, replica id), so exactly k win even on
ties), or those within a deadline (timeout; interval mode's staleness
bound). The draws are the reference's on the same keys
(:mod:`..core.prng`), so the flags are too.

Every function takes and returns float32 tensors over the ``[n]``
replicas, on whatever device they live (the train step keeps them on
the host: n numbers, known before any gradient is computed).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from ..core.config import SyncConfig


def _f32(x: float) -> float:
    return float(np.float32(x))


def sample_step_time_ms(cfg: SyncConfig, root_key, step: int,
                        measured_ms: torch.Tensor) -> torch.Tensor:
    """Modeled step times ``[n]`` for replicas ``0..n-1``: the measured
    base plus the straggler profile's draw (lognormal, spike, or — for
    "none" — a sub-microsecond jitter that only breaks ranking ties)."""
    n = measured_ms.shape[0]
    dev = measured_ms.device
    keys = prng.replica_keys(root_key, "straggler", step, n)
    base = measured_ms.float()
    mean = _f32(cfg.straggler_mean_ms)
    if cfg.straggler_profile == "lognormal":
        z = prng.normal(keys, (), dev)
        sigma = _f32(cfg.straggler_sigma)
        t = mean * torch.exp(sigma * z - _f32(0.5 * cfg.straggler_sigma ** 2))
        return base + t
    if cfg.straggler_profile == "spike":
        spike = prng.bernoulli(keys, cfg.straggler_spike_prob, (), dev)
        t = mean * torch.where(spike, torch.tensor(
            _f32(cfg.straggler_spike_scale), device=dev),
            torch.tensor(1.0, device=dev))
        return base + t
    if cfg.straggler_profile == "none":
        return base + prng.uniform(keys, (), 0.0, 1e-3, dev)
    raise ValueError(f"unknown straggler_profile {cfg.straggler_profile!r}")


def rank_by_time(time_ms: torch.Tensor) -> torch.Tensor:
    """Each replica's rank (0 = fastest) under lexicographic (time,
    replica id) order — an exact permutation."""
    n = time_ms.shape[0]
    ids = torch.arange(n, device=time_ms.device)
    t_me, t_other = time_ms[:, None], time_ms[None, :]
    earlier = (t_other < t_me) | ((t_other == t_me)
                                  & (ids[None, :] < ids[:, None]))
    return earlier.to(torch.int32).sum(1)


def quorum_flag(time_ms: torch.Tensor, k) -> torch.Tensor:
    """1 for the k fastest replicas (k may be an integer-valued float or
    a tensor; it is rounded, never truncated)."""
    k_i = torch.round(torch.as_tensor(k, dtype=torch.float32)).to(torch.int32)
    return (rank_by_time(time_ms) < k_i.to(time_ms.device)).float()


def timeout_flag(time_ms: torch.Tensor, timeout_ms) -> torch.Tensor:
    """1 for replicas at or under the deadline (``t <= timeout``)."""
    dl = torch.as_tensor(timeout_ms, dtype=torch.float32).to(time_ms.device)
    return (time_ms <= dl).float()


def resolve_aggregate_k(cfg: SyncConfig, num_replicas: int) -> int:
    """-1 → all replicas."""
    k = cfg.num_replicas_to_aggregate
    if k == -1:
        return num_replicas
    if not (1 <= k <= num_replicas):
        raise ValueError(f"num_replicas_to_aggregate={k} outside "
                         f"[1, {num_replicas}]")
    return k
