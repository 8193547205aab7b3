"""Masked-mean cross-replica reduction (≙ ``distributedmnist_tpu/ops/
masked_psum.py``) — the aggregation every sync discipline shares.

Each replica contributes ``grad · flag / max(Σflag, 1)``; one sum over
replicas of those scaled contributions is the masked mean. The port
flattens every gradient leaf of a replica into one bucket row, so the
sum is a single reduction over ``[replicas, P]``
(:meth:`..core.mesh.Topology.sum_replicas`). When no replica
contributes, every scale is 0 and the mean is exact zeros.
"""

from __future__ import annotations

import torch

from ..core.mesh import Topology


def contribution_scale(flags: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``(scale [n], num_contributors)`` in float32 from the ``[n]``
    flags: ``scale = flag / max(Σflag, 1)``."""
    flags = flags.float()
    num = flags.sum()
    return flags / torch.clamp(num, min=1.0), num


def flatten_replicas(leaves: list[torch.Tensor]) -> torch.Tensor:
    """One float32 bucket ``[n, P]`` of the replicas' gradient leaves
    (each ``[n, ...]``): replica r's leaves, flattened, are row r."""
    n = leaves[0].shape[0]
    return torch.cat([g.reshape(n, -1).float() for g in leaves], dim=1)


def unflatten_like(flat: torch.Tensor,
                   leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of ``flat`` shaped like ``leaves``."""
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def masked_mean(buckets: torch.Tensor, scale, topo: Topology
                ) -> torch.Tensor:
    """The masked mean ``[P]`` of per-replica gradient buckets
    ``[replicas, P]``: each row is scaled in place by its replica's
    share (``scale``, host numbers: nothing is copied to the device),
    then one sum over replicas."""
    for r, s in enumerate(scale):
        buckets[r].mul_(float(s))
    return topo.sum_replicas(buckets)
