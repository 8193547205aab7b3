"""Ring attention — sequence parallelism over a process group (≙
``distributedmnist_tpu/ops/ring_attention.py ring_self_attention``).

Each process holds one block of the sequence's queries, keys and values;
the K/V blocks travel round the ring (:func:`..ops.collectives.ppermute`)
while an online softmax in float32 builds exact attention for the local
queries, so memory stays O(S_local) a process besides one block's
scores. The causal mask is taken in *global* positions. The gradient is
autograd's through the loop (each ``ppermute``'s backward sends the
cotangent the other way round), as the reference's is JAX's AD. It is
plain torch: the reference's ring is no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .attention import NEG_INF
from ..core.mesh import CommStats
from .collectives import ppermute


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group, *, causal: bool = True,
                        scale: float | None = None,
                        stats: CommStats | None = None) -> torch.Tensor:
    """Exact attention over a sequence split in blocks over ``group``.

    q, k, v: this process's blocks, ``[batch, heads, seq_local,
    head_dim]``; rank ``r`` of ``group`` holds positions ``[r·seq_local,
    (r+1)·seq_local)``. Returns this block's output, ``[batch, heads,
    seq_local, head_dim]`` in q's dtype. ``stats`` counts the
    exchanges (:mod:`.collectives`)."""
    n = 1 if group is None else dist.get_world_size(group)
    me = 0 if group is None else dist.get_rank(group)
    b, h, s_loc, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    q32 = q.float()
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    qpos = me * s_loc + torch.arange(s_loc, device=q.device)[:, None]
    k_cur, v_cur = k, v
    for r in range(n):
        # k_cur / v_cur came from rank (me - r) mod n
        src = (me - r) % n
        scores = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float()) * scale
        if causal:
            kpos = src * s_loc + torch.arange(s_loc, device=q.device)[None, :]
            scores = scores.masked_fill(qpos < kpos, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   v_cur.float())
        m = m_new
        if r < n - 1:
            # the reference rotates after the last step too (its
            # fori_loop carries k/v); that block would go unread here
            k_cur = ppermute(k_cur, 1, group, stats)
            v_cur = ppermute(v_cur, 1, group, stats)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
