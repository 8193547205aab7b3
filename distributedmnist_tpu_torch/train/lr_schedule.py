"""Learning-rate schedules (≙ ``distributedmnist_tpu/train/
lr_schedule.py``): ``applied updates -> lr``, each computed in float32
as the reference's is, so the rate a step applies is the same float.

Decay is keyed to the number of *applied updates* (the reference's
global_step), and the staircase decay runs over

    decay_steps = (num_examples / batch_size) * num_epochs_per_decay / k

with ``k`` the aggregation quorum.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F32 = np.float32


def decay_steps_for(num_examples: int, batch_size: int,
                    num_epochs_per_decay: float, aggregate_k: int) -> int:
    num_batches_per_epoch = num_examples / batch_size
    return max(1, int(num_batches_per_epoch * num_epochs_per_decay
                      / aggregate_k))


def exponential_decay(initial_lr: float, decay_steps: int,
                      decay_factor: float, staircase: bool = True) -> Schedule:
    """≙ tf.train.exponential_decay."""
    def schedule(updates_applied: int) -> float:
        p = _F32(updates_applied) / _F32(decay_steps)
        if staircase:
            p = np.floor(p)
        return float(_F32(initial_lr) * np.power(_F32(decay_factor), p))
    return schedule


def constant(lr: float) -> Schedule:
    def schedule(updates_applied: int) -> float:
        del updates_applied
        return float(_F32(lr))
    return schedule


def warmup_polynomial_decay(base_lr: float, warmup_steps: int,
                            total_steps: int, end_lr: float = 0.0,
                            power: float = 2.0) -> Schedule:
    """Linear warmup to ``base_lr`` over ``warmup_steps`` applied
    updates, then polynomial decay to ``end_lr`` at ``total_steps``
    (held there after)."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be > 0, got {total_steps}")
    if warmup_steps >= total_steps:
        raise ValueError(f"warmup_steps ({warmup_steps}) must be < "
                         f"total_steps ({total_steps})")

    def schedule(updates_applied: int) -> float:
        t = _F32(updates_applied)
        base = _F32(base_lr)
        if t < warmup_steps:
            # warmup ramps 1/w, 2/w, … so update 0 never applies a zero lr
            return float(base * (t + _F32(1.0)) / _F32(max(warmup_steps, 1)))
        frac = np.clip((t - _F32(warmup_steps))
                       / _F32(max(total_steps - warmup_steps, 1)),
                       _F32(0.0), _F32(1.0))
        return float((base - _F32(end_lr))
                     * np.power(_F32(1.0) - frac, _F32(power))
                     + _F32(end_lr))
    return schedule
