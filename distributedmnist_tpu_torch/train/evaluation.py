"""Full-split evaluation (≙ ``distributedmnist_tpu/train/evaluation.py``
``run_full_eval``), on one device.

Batches are fixed-shape and weight-padded (pad rows carry weight 0), in
the reference's order; the sums come back to the host once per batch.
The reference's dispatch-ahead prefetch thread and its multi-host
striping are not ported: batches go to the device inline, through
pinned memory.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ..data.datasets import ArrayDataset
from ..data.pipeline import eval_batches, to_device


def run_full_eval(eval_fn: Callable, params: Any, data: ArrayDataset,
                  batch_size: int = 0, *,
                  device: torch.device) -> dict[str, float]:
    """Evaluate ``params`` on the whole split: accuracy / loss /
    num_examples / seconds. ``batch_size`` 0 picks the reference's
    default, ``min(4096, num_examples)``. For a causal LM the weight sum
    ``eval_fn`` returns is a token count — the normalizer of loss and
    accuracy — while ``num_examples`` counts sequences."""
    bs = batch_size or max(1, min(4096, data.num_examples))
    t0 = time.time()
    correct = loss_sum = weight = 0.0
    num_examples = 0.0
    for batch in eval_batches(data, bs):
        num_examples += float(batch["weight"].sum())
        c, l, w = eval_fn(params, to_device(batch, device))
        correct += float(c)
        loss_sum += float(l)
        weight += float(w)
    return {
        "accuracy": correct / max(weight, 1.0),
        "loss": loss_sum / max(weight, 1.0),
        "num_examples": int(num_examples),
        "seconds": time.time() - t0,
    }
