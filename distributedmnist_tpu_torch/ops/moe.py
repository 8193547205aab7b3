"""Mixture-of-experts FFN with expert parallelism (≙
``distributedmnist_tpu/ops/moe.py``).

Switch top-1 and GShard top-k routing in the dispatch/combine einsum
form: static shapes throughout, so every expert runs one batched GEMM
pair over its capacity slots whatever the routing. The reference
computes these products outside any Pallas kernel, and so does the
port (``torch.einsum`` and ``torch.bmm``).

Token groups: every sequence row splits into a fixed number of
contiguous chunks, and routing capacity and the load-balance loss are
computed per chunk. Groups nest inside rows, so with an explicit
``num_groups`` the routing depends only on the config and the row, not
on the expert ranks or the sequence split: an expert-parallel run
equals the dense one, drops included.

Two rules the reference gets from JAX and the port keeps by hand:
every one-hot is a comparison with ``torch.arange`` (``jax.nn.one_hot``
gives an all-zero row for an index past the end, which is how a token
past capacity loses its slot; ``F.one_hot`` would raise, and this form
also runs under ``torch.func.vmap``), and an argmax takes the first of
tied maxima, as ``jnp.argmax`` does.

Expert parallelism over ``expert_group`` (G ranks, E/G experts each):
rank ``r`` routes its contiguous ``1/G`` slice of every row, two
all-to-alls (:func:`..ops.collectives.all_to_all`) carry only the
dispatched slots ``[n_g, E/G, G·cap, d]`` to the expert owners and
back, and
:func:`..ops.collectives.scatter_sum` reassembles the replicated
``[b, s, d]`` output in one sum over ``reduce_group`` — the expert
ranks, or the expert×model ranks when each expert's FFN is also split
by tensor parallelism (``model_group``).

Gradients follow the reference's ``shard_map`` transposes: the input
and the router enter the expert ranks through *f*
(:func:`..ops.collectives.copy_to_group`: their gradient is summed
over the expert group, as JAX's transpose of replication sums it);
under tensor parallelism the expert input and the combine weights
enter the model-parallel products through *f* over the model group
(each rank's product is partial there); the aux loss averages over the
expert group with an identity backward and over ``stats_group`` (the
seq group under SP) with a summed one, so that a loss adding
``aux / n_seq`` on every seq block and summing the blocks' gradients
gets the gradient of the mean.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import (all_reduce_sum, all_to_all, copy_to_group,
                          reduce_from_group, scatter_sum)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``[...]`` integer indices → ``[..., n]`` float32, an all-zero row
    where the index is ``n`` or more."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """The first index of the maximum along the last dim."""
    n = x.shape[-1]
    at = torch.arange(n, device=x.device)
    top = x.max(dim=-1, keepdim=True).values
    return torch.where(x == top, at, n).min(dim=-1).values


def _route(xg: torch.Tensor, router_w: torch.Tensor, e: int, cap: int,
           top_k: int):
    """Route token groups ``[n_g, t, d]`` → dispatch and combine
    ``[n_g, t, e, cap]`` (float32) and the load statistics ``frac`` and
    ``mprob`` ``[n_g, e]`` (≙ the reference's ``_route``, one group a
    row of the leading dim).

    ``top_k == 1``: Switch routing, the combine weight the raw top
    gate. ``top_k >= 2``: GShard, each round dispatching the next-best
    expert at queue positions after every earlier round's claims (kept
    or dropped), the gates renormalised over the chosen set."""
    logits = (xg @ router_w.to(xg.dtype)).float()      # [n_g, t, e]
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    counts = probs.new_zeros(probs.shape[0], 1, e)     # claims so far
    disps, gates = [], []
    for _ in range(top_k):
        oh = _one_hot(_first_argmax(remaining), e)      # [n_g, t, e]
        gates.append((remaining * oh).sum(-1))          # [n_g, t]
        # this round's arrival order plus earlier rounds' claims
        pos = (((oh.cumsum(dim=1) - 1.0) * oh).sum(-1)
               + (oh * counts).sum(-1)).long()
        slot = _one_hot(pos, cap)                       # 0 if pos >= cap
        disps.append(oh[..., None] * slot[..., None, :])
        counts = counts + oh.sum(dim=1, keepdim=True)
        remaining = remaining * (1.0 - oh)
    if top_k == 1:
        dispatch = disps[0]
        combine = disps[0] * gates[0][..., None, None]
    else:
        dispatch = sum(disps)
        denom = sum(gates) + 1e-9
        combine = sum((g / denom)[..., None, None] * dk
                      for g, dk in zip(gates, disps))
    # load statistics: first-choice fractions (the Switch/GShard aux)
    frac = _one_hot(_first_argmax(probs), e).mean(dim=1)
    return dispatch, combine, frac, probs.mean(dim=1)


def _expert_ffn(expert_in: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[e_local, c, d]`` through each local expert's two-layer FFN:
    one batched GEMM a layer."""
    h = F.relu(torch.bmm(expert_in, w1.to(dtype)))
    return torch.bmm(h, w2.to(dtype))


def _group_count(s: int, num_experts: int, num_groups: int, g_ep: int,
                n_seq_shards: int, capacity_factor: float,
                router_top_k: int) -> tuple[int, int]:
    """The token groups a local row of ``s`` tokens splits into and each
    group's capacity, with the reference's checks and messages."""
    e = num_experts
    if not 1 <= router_top_k <= e:
        raise ValueError(f"moe_router_top_k={router_top_k} must be in "
                         f"[1, num_experts={e}]")
    if num_groups:
        if num_groups % n_seq_shards:
            raise ValueError(
                f"moe_num_groups={num_groups} must divide by the "
                f"sequence sharding ({n_seq_shards} shards) so group "
                "boundaries align with shard boundaries")
        gh = num_groups // n_seq_shards           # groups per local row
    else:
        gh = g_ep                                 # auto: one per EP rank
    if gh % g_ep:
        raise ValueError(
            f"per-shard group count {gh} (moe_num_groups="
            f"{num_groups or 'auto'}) must divide by the expert-parallel "
            f"rank count {g_ep}")
    if s % gh:
        raise ValueError(
            f"local sequence length {s} must divide into {gh} token "
            f"groups (moe_num_groups={num_groups or 'auto'})")
    gs = s // gh
    return gh, max(1, math.ceil(capacity_factor * router_top_k * gs / e))


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, *, num_experts: int,
            capacity_factor: float = 1.25, router_top_k: int = 1,
            num_groups: int = 0, expert_group=None, model_group=None,
            reduce_group=None, stats_group=None,
            stats=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN over fixed per-row token groups (≙ the
    reference's ``moe_ffn``).

    * ``x`` ``[batch, seq, d]``: the activations, the same on every
      rank of ``expert_group`` and ``model_group`` (under sequence
      parallelism this rank's block of the sequence);
    * ``router_w`` ``[d, E]`` (whole); ``w1`` ``[E_local, d, ff_local]``
      and ``w2`` ``[E_local, ff_local, d]``: this rank's experts
      (``E_local = E / G``) and, with ``model_group``, its Megatron
      slice of each expert's hidden dim;
    * ``capacity_factor``: a group's capacity is ``ceil(cf · top_k ·
      group_size / E)``; a token past it loses that round's slot;
    * ``num_groups``: groups a *global* row splits into (0: one a
      local row, or one an expert rank — mesh-dependent); under
      ``stats_group`` (the seq group) it counts across the blocks;
    * ``reduce_group``: the expert×model group (the expert group
      without tensor parallelism), the output's one sum;
    * ``stats``: a :class:`..core.mesh.CommStats` the collectives count
      in.

    Returns ``(out [batch, seq, d], aux)``: ``aux`` (float32) is the
    mean over token groups of the Switch loss ``E·Σ_e frac_e ·
    mprob_e``, averaged over the expert group and ``stats_group`` — the
    mean over all of this layer's groups, the same on every rank."""
    b, s, d = x.shape
    e = num_experts
    dtype = x.dtype
    g_ep = 1 if expert_group is None else dist.get_world_size(expert_group)
    if g_ep > 1 and reduce_group is None:
        if model_group is not None:
            raise ValueError("expert and tensor parallelism together need "
                             "the expert×model reduce_group")
        reduce_group = expert_group
    n_seq = 1 if stats_group is None else dist.get_world_size(stats_group)
    if w1.shape[0] * g_ep != e:
        raise ValueError(f"{w1.shape[0]} local experts × {g_ep} expert "
                         f"ranks != num_experts={e}")
    gh, cap = _group_count(s, e, num_groups, g_ep, n_seq, capacity_factor,
                          router_top_k)
    gs = s // gh
    if expert_group is None:
        xg = x.reshape(b * gh, gs, d)
    else:
        me = dist.get_rank(expert_group)
        s_r = s // g_ep                   # this rank's contiguous slice
        x = copy_to_group(x, expert_group, stats)
        router_w = copy_to_group(router_w, expert_group, stats)
        xg = x[:, me * s_r:(me + 1) * s_r].reshape(b * (gh // g_ep), gs, d)
    n_g = xg.shape[0]
    dispatch, combine, frac, mprob = _route(xg, router_w, e, cap,
                                            router_top_k)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(dtype), xg)
    # [n_g, E, cap, d] → each owner's [n_g, E_local, G·cap, d]: every
    # rank's slots for its experts, in rank order
    expert_in = all_to_all(expert_in, 1, 2, expert_group, stats)
    e_local, c = expert_in.shape[1], expert_in.shape[2]
    ei = expert_in.transpose(0, 1).reshape(e_local, n_g * c, d)
    eo = _expert_ffn(copy_to_group(ei, model_group, stats), w1, w2, dtype)
    # the inverse: the slots home, experts back in global order
    expert_out = all_to_all(eo.reshape(e_local, n_g, c, d).transpose(0, 1),
                            2, 1, expert_group, stats)
    comb = copy_to_group(combine.to(dtype), model_group, stats)
    out = torch.einsum("gtec,gecd->gtd", comb, expert_out)
    if expert_group is None:
        out = reduce_from_group(out.reshape(b, s, d), model_group, stats)
    else:
        out = scatter_sum(out.reshape(b, s // g_ep, d), 1, me, g_ep,
                          reduce_group, stats)
    # per-group Switch loss, averaged over every group of the layer: the
    # mean over this call's groups, then over the expert ranks (disjoint
    # group slices of equal size) and the sequence blocks
    aux = (e * (frac * mprob).sum(-1)).mean()
    if expert_group is not None:
        aux = reduce_from_group(aux, expert_group, stats) / g_ep
    if stats_group is not None:
        aux = all_reduce_sum(aux, stats_group, stats) / n_seq
    return out, aux.float()
