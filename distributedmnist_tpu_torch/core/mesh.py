"""The replica topology (≙ ``distributedmnist_tpu/core/mesh.py``
``Topology`` and ``make_topology``), for data parallelism.

The reference lays its replicas over a device mesh and runs one SPMD
program across them. The port runs ``n`` *simulated* replicas on its
one device (``cuda:0``, or the CPU in tests): the analogue of the
reference's forced ``n``-device CPU mesh. Each replica still takes its
own block of the global batch, its own dropout and straggler keys, and
its own gradient; only the cross-replica operations below combine
them.

Those operations are the only place replicas meet, and both take a
leading replica axis of the replicas this process holds:
:meth:`Topology.sum_replicas` (the masked mean's one all-reduce) and
:meth:`Topology.gather_scalars` (per-replica scalars into ``[n]``). A
``torch.distributed`` path (one process per GPU, NCCL) implements the
same two methods over its process group; it is not written yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    """``num_replicas`` data-parallel replicas, all held by this process
    on the device its state lives on."""

    num_replicas: int

    def split_batch(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, ...]`` → ``[n, B/n, ...]``: replica r takes rows
        ``[r·B/n, (r+1)·B/n)``, the reference's ``P(replica)`` block."""
        if x.shape[0] % self.num_replicas:
            raise ValueError(f"global batch {x.shape[0]} not divisible by "
                             f"{self.num_replicas} replicas")
        return x.view(self.num_replicas, -1, *x.shape[1:])

    def sum_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over replicas of a ``[local replicas, ...]`` tensor (≙ the
        reference's ``lax.psum`` over the replica axis)."""
        return x.sum(0)

    def gather_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """``[local replicas]`` per-replica scalars → ``[n]`` in replica
        order (≙ ``_gather_replicated``)."""
        return x


def make_topology(cfg: MeshConfig) -> Topology:
    """``mesh.num_replicas`` replicas, or ``mesh.simulate_devices`` when
    ``num_replicas`` is -1 (the reference's "every device" on its forced
    CPU mesh), else one. Model, sequence, pipeline and expert
    parallelism are not ported."""
    for name in ("model_parallelism", "seq_parallelism",
                 "pipeline_parallelism", "expert_parallelism"):
        if getattr(cfg, name) != 1:
            raise NotImplementedError(f"mesh.{name} > 1 is not ported yet")
    n = cfg.num_replicas
    if n == -1:
        n = cfg.simulate_devices if cfg.simulate_devices > 0 else 1
    if n < 1:
        raise ValueError(f"mesh.num_replicas must be -1 or >= 1, got {n}")
    return Topology(num_replicas=n)
