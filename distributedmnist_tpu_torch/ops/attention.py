"""Plain causal attention (≙ ``distributedmnist_tpu/ops/ring_attention.py
local_self_attention``).

The single-device dense path: the ``[s, s]`` score matrix in float32,
a finite ``-1e30`` causal mask (its ``exp`` underflows to exactly 0.0,
so a masked row never makes a NaN), softmax in float32, and the output
cast back to the query's dtype. It is the model's
``attention_impl="dense"`` path and the oracle the flash kernel is held
against (``ops/flash_attention.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite mask value: keeps softmax algebra NaN-free


def padded_head_dim(d: int, compiled: tuple[int, ...]) -> int:
    """The smallest compiled head_dim that holds ``d`` (≙ the reference
    kernels padding head_dim to the lane tile,
    ``pallas_attention.py _prep``); raises when none does."""
    for size in compiled:
        if d <= size:
            return size
    raise ValueError(f"head_dim {d} is larger than the largest compiled "
                     f"size {max(compiled)}")


def pad_head_dim(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x`` zero-padded along its last (head_dim) axis to ``size`` — a
    copy, as the reference's pad is. Zero columns add nothing to q·kᵀ,
    and give zero columns in p·v, δ and every gradient, so the first
    ``d`` columns of a padded call are the unpadded call's."""
    d = x.shape[-1]
    return x if d == size else F.pad(x, (0, size - d))


def local_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Exact attention over ``[batch, heads, seq, head_dim]``; returns
    the query-shaped output in the query's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[2]
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
