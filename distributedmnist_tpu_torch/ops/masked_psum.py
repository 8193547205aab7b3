"""Masked-mean cross-replica reduction (≙ ``distributedmnist_tpu/ops/
masked_psum.py``) — the aggregation every sync discipline shares.

Each replica contributes ``grad · flag / max(Σflag, 1)``; one sum over
replicas of those scaled contributions is the masked mean. The port
flattens every gradient leaf of a replica into one bucket row, so the
sum is a single reduction over ``[local replicas, P]``
(:meth:`..core.mesh.Topology.sum_replicas`: the local sum, then one
all-reduce across processes). Trailing columns may carry per-replica
statistics (the loss and accuracy) that ride the same reduction
unscaled. When no replica contributes, every scale is 0 and the mean is
exact zeros.
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


def flatten_replicas(leaves: list[torch.Tensor],
                     stats: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """One float32 bucket ``[L, P (+ len(stats))]`` of the replicas'
    gradient leaves (each ``[L, ...]``): replica j's leaves, flattened,
    are row j, followed by its entry of each ``[L]`` tensor in
    ``stats``."""
    n = (leaves or stats)[0].shape[0]
    return torch.cat([g.reshape(n, -1).float() for g in leaves]
                     + [s.reshape(n, 1).float() for s in stats], dim=1)


def unflatten_like(flat: torch.Tensor,
                   leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of ``flat`` shaped like ``leaves``."""
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def masked_mean(buckets: torch.Tensor, scale, topo: Topology,
                width: int | None = None) -> torch.Tensor:
    """The masked mean of this process's per-replica buckets ``[L, W]``
    over all ``n`` replicas: each local row's first ``width`` columns
    (all of them when None) are scaled in place by the replica's entry
    of the ``[n]`` float32 ``scale`` (``scale[first_replica + j]``), then
    one sum over replicas. The columns past ``width`` are summed as they
    are. The train step passes ``scale`` as a tensor on the buckets'
    device, so a CUDA graph of it reads each step's scale."""
    cols = buckets if width is None else buckets[:, :width]
    cols.mul_(local_scale(scale, topo, cols))
    return topo.sum_replicas(buckets)


def local_scale(scale, topo: Topology, rows: torch.Tensor) -> torch.Tensor:
    """This process's replicas' entries of the ``[n]`` ``scale``, shaped
    to broadcast over ``rows`` ``[L, ...]`` (one float32 multiply an
    element, as scaling each row by its own number is)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=rows.device)
    first = topo.first_replica
    s = s[first:first + topo.local_replica_count]
    return s.view(-1, *([1] * (rows.dim() - 1)))
