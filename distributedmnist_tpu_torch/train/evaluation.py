"""Full-split evaluation (≙ ``distributedmnist_tpu/train/evaluation.py``
``run_full_eval``), on this process's device.

Batches are fixed-shape and weight-padded (pad rows carry weight 0), in
the reference's order; the sums come back to the host once per batch.
With several processes each evaluates its stripe of the split
(``eval_batches(..., host_id, num_hosts)``, the reference's striping)
and the correct, loss and weight sums and the example count are summed
over the processes, so every example counts once and every process
returns the same result. The reference's dispatch-ahead prefetch thread
is not ported: batches go to the device inline, through pinned memory.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ..core.mesh import Topology
from ..data.datasets import ArrayDataset
from ..data.pipeline import eval_batches, to_device


def run_full_eval(eval_fn: Callable, params: Any, data: ArrayDataset,
                  batch_size: int = 0, *, device: torch.device,
                  topo: Topology | None = None) -> dict[str, float]:
    """Evaluate ``params`` on the whole split: accuracy / loss /
    num_examples / seconds. ``batch_size`` 0 picks the reference's
    default, ``min(4096, num_examples)``. For a causal LM the weight sum
    ``eval_fn`` returns is a token count — the normalizer of loss and
    accuracy — while ``num_examples`` counts sequences. ``topo`` (one
    process when None) stripes the split over its processes."""
    hosts, host = ((topo.process_count, topo.process_index) if topo
                   else (1, 0))
    bs = batch_size or max(1, min(4096, data.num_examples))
    t0 = time.time()
    correct = loss_sum = weight = 0.0
    num_examples = 0.0
    for batch in eval_batches(data, bs, host_id=host, num_hosts=hosts):
        num_examples += float(batch["weight"].sum())
        c, l, w = eval_fn(params, to_device(batch, device))
        correct += float(c)
        loss_sum += float(l)
        weight += float(w)
    if topo is not None and topo.distributed:
        sums = topo.sum_processes(torch.tensor(
            [correct, loss_sum, weight, num_examples], dtype=torch.float64))
        correct, loss_sum, weight, num_examples = sums.tolist()
    return {
        "accuracy": correct / max(weight, 1.0),
        "loss": loss_sum / max(weight, 1.0),
        "num_examples": int(num_examples),
        "seconds": time.time() - t0,
    }
