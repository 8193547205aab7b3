"""Ulysses sequence parallelism: an all-to-all head scatter (≙
``distributedmnist_tpu/ops/ulysses_attention.py
ulysses_self_attention``).

One all-to-all trades the sequence split for a head split, each process
runs exact attention over the WHOLE sequence for its heads, and the
inverse all-to-all restores the sequence split. The port runs it in the
model's ``bshd`` layout, ``[b, s/n, h, d] ↔ [b, s, h/n, d]``, so the
flash kernel (``ops/flash_attention.py``: K1-lse, K2 and K3 under
autograd, K1 alone in eval) reads the gathered tensors with no
transpose. The heads must divide over the group.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..core.mesh import CommStats
from .collectives import all_to_all


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, group, *,
                           causal: bool = True, scale: float | None = None,
                           attention_fn: Callable,
                           stats: CommStats | None = None) -> torch.Tensor:
    """Exact attention over a sequence split in blocks over ``group``.

    q, k, v: this process's block, ``[batch, seq_local, heads,
    head_dim]``; ``heads`` divisible by the group's size.
    ``attention_fn`` is the full-sequence ``bshd`` attention run on each
    head subset (``flash_attention_bshd`` or its plain version);
    ``stats`` counts the all-to-alls (:mod:`.collectives`). Returns
    ``[batch, seq_local, heads, head_dim]`` for this block."""
    n = 1 if group is None else dist.get_world_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"heads={h} not divisible by the seq group's size "
                         f"{n} (use ring attention instead)")

    def gather_seq(x):  # [b, s/n, h, d] → [b, s, h/n, d]
        return all_to_all(x, 2, 1, group, stats)

    o = attention_fn(gather_seq(q), gather_seq(k), gather_seq(v),
                     causal=causal, scale=scale)
    # [b, s, h/n, d] → [b, s/n, h, d]
    return all_to_all(o, 1, 2, group, stats)
