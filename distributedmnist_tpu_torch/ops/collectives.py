"""Differentiable collectives over a ``torch.distributed`` sub-group —
the operations the reference's tensor and sequence parallelism get from
JAX's AD of ``lax.psum``, ``lax.ppermute``, ``lax.all_to_all`` and the
replicated→varying cast (``core/mesh.py`` makes the groups):

* :func:`copy_to_group` — identity forward, all-reduce backward:
  Megatron's *f*, where a replicated activation enters a
  column-parallel product (each rank's gradient of it is partial);
* :func:`reduce_from_group` — all-reduce forward, identity backward:
  Megatron's *g*, after a row-parallel product (reference
  ``models/transformer.py:237-239,266-269``);
* :func:`ppermute` — rank ``i`` sends to ``(i + shift) % n``; its
  backward is the reverse permutation;
* :func:`all_to_all` — the tiled all-to-all (``lax.all_to_all(...,
  tiled=True)``): ``split_dim`` cut into ``n`` blocks, block ``k`` to
  rank ``k``, the received blocks concatenated along ``concat_dim`` in
  rank order; its backward is the inverse all-to-all (the expert
  layer's two, reference ``ops/moe.py:217,225``, are ``(1, 2)`` and
  ``(2, 1)``);
* :func:`scatter_sum` — this rank's block written into zeros at its
  rank's offset, summed over the group: the reference's scatter+psum
  reassembly of a replicated activation (``ops/moe.py:232-237``); its
  backward is this rank's block of the gradient, as the transpose of a
  ``psum`` to a replicated value is the identity;
* :func:`all_reduce_sum` — ``psum`` whose gradient is summed over the
  group too: a replicated statistic that enters every rank's partial
  of a loss the caller sums over the group (the MoE aux loss over the
  seq group, reference ``parallel/api.py:1036-1040``);
* :func:`stage_exchange` — one pipeline tick's point-to-point sends and
  receives with the previous and next rank of the stage group (≙ the
  reference's lockstep ``lax.ppermute`` pair of ``ops/pipeline.py``),
  posted together and waited on together; not differentiable (the
  pipeline engine carries cotangents itself).

``group`` None means no group (an axis of size 1): every operation is
then the identity. Each collective is one call of the group's backend,
which must run it; nothing falls back to another algorithm. One path is
explicit: gloo carries point-to-point sends and all-to-alls of host
tensors only, so for a CUDA tensor on a gloo group :func:`ppermute`,
:func:`all_to_all` and :func:`stage_exchange` stage the data through
host buffers (a copy to the
host, the exchange, a copy back). All-reduces of CUDA tensors run
through gloo as they are (gloo copies them through the host itself;
each is counted in ``stats.staged_all_reduces``). Given a
:class:`..core.mesh.CommStats` (``stats``; a ``Topology`` owns one),
each call adds its host seconds
to ``stats.blocked_s`` and each staged exchange one to
``stats.staged`` (:func:`stage_exchange`: one a staged tensor sent or
received, under ``"p2p"``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.mesh import CommStats


def _timed(stats: CommStats | None, fn, *args, **kw):
    return fn(*args, **kw) if stats is None else stats.timed(fn, *args,
                                                             **kw)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(group, x: torch.Tensor, stats: CommStats | None,
            kind: str) -> bool:
    """Whether an exchange of ``x`` on ``group`` goes through the host
    (gloo exchanges host tensors only), counted in ``stats``."""
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged and stats is not None:
        stats.staged[kind] += 1
    return staged


def _all_reduce(x: torch.Tensor, group, stats) -> torch.Tensor:
    x = x.contiguous()
    if (stats is not None and x.device.type == "cuda"
            and dist.get_backend(group) == "gloo"):
        stats.staged_all_reduces += 1
    _timed(stats, dist.all_reduce, x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.group, ctx.stats = group, stats
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group, ctx.stats), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stats):
        return _all_reduce(x.clone(), group, stats)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_group(x: torch.Tensor, group,
                  stats: CommStats | None = None) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is; the gradient summed over
    ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group, stats)


def reduce_from_group(x: torch.Tensor, group,
                      stats: CommStats | None = None) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``group``; the gradient as it
    is."""
    return x if group is None else _ReduceFromGroup.apply(x, group, stats)


def _ppermute(x: torch.Tensor, shift: int, group, stats) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    staged = _staged(group, x, stats, "ppermute")
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]

    def exchange():
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _timed(stats, exchange)
    return recv.to(x.device) if staged else recv


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group, stats):
        ctx.shift, ctx.group, ctx.stats = shift, group, stats
        return _ppermute(x, shift, group, stats)

    @staticmethod
    def backward(ctx, g):
        return (_ppermute(g, -ctx.shift, ctx.group, ctx.stats), None, None,
                None)


def ppermute(x: torch.Tensor, shift: int, group,
             stats: CommStats | None = None) -> torch.Tensor:
    """Rank ``i`` of ``group`` sends ``x`` to rank ``(i + shift) % n``
    and returns what rank ``(i - shift) % n`` sent (≙ ``lax.ppermute``
    with the pairs ``(i, (i + shift) % n)``). Differentiable: the
    gradient goes back along the reverse permutation."""
    if _size(group) == 1 or shift % _size(group) == 0:
        return x
    if x.requires_grad:
        return _Ppermute.apply(x, shift, group, stats)
    return _ppermute(x, shift, group, stats)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group, stats) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} "
                         "ranks")
    # block k of split_dim to rank k: blocks stacked on a new dim 0
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    staged = _staged(group, x, stats, "all_to_all")
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    _timed(stats, dist.all_to_all_single, recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    # the received blocks, in rank order, along concat_dim
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, stats):
        ctx.dims, ctx.group, ctx.stats = (split_dim, concat_dim), group, stats
        return _all_to_all(x, split_dim, concat_dim, group, stats)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group, ctx.stats),
                None, None, None, None)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group, stats: CommStats | None = None) -> torch.Tensor:
    """The tiled all-to-all over ``group`` (≙ ``lax.all_to_all(x, axis,
    split_axis=split_dim, concat_axis=concat_dim, tiled=True)``):
    ``x.shape[split_dim]`` shrinks ``n``-fold and
    ``x.shape[concat_dim]`` grows ``n``-fold. Differentiable: the
    gradient takes the inverse all-to-all."""
    if _size(group) == 1:
        return x
    if x.requires_grad:
        return _AllToAll.apply(x, split_dim, concat_dim, group, stats)
    return _all_to_all(x, split_dim, concat_dim, group, stats)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, n, group, stats):
        ctx.dim, ctx.index, ctx.w = dim, index, x.shape[dim]
        pad = [0, 0] * (x.dim() - 1 - dim)
        pad += [index * x.shape[dim], (n - 1 - index) * x.shape[dim]]
        return _all_reduce(torch.nn.functional.pad(x, pad), group, stats)

    @staticmethod
    def backward(ctx, g):
        w = ctx.w
        return (g.narrow(ctx.dim, ctx.index * w, w), None, None, None,
                None, None)


def scatter_sum(x: torch.Tensor, dim: int, index: int, n: int, group,
                stats: CommStats | None = None) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim``: ``x`` written into zeros
    ``n`` times its width at offset ``index·width``, summed over
    ``group`` (≙ ``lax.psum(lax.dynamic_update_slice_in_dim(zeros, x,
    index·w, dim), axes)``). Each rank passes its own block, so the sum
    is every block in place, the same on every rank. Differentiable:
    the gradient is block ``index`` of the output's gradient. Without a
    group (``n`` must be 1) ``x`` as it is."""
    if group is None:
        return x
    return _ScatterSum.apply(x, dim, index, n, group, stats)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.group, ctx.stats = group, stats
        return _all_reduce(x.clone(), group, stats)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group, ctx.stats), None, None


def all_reduce_sum(x: torch.Tensor, group,
                   stats: CommStats | None = None) -> torch.Tensor:
    """``x`` summed over ``group``, and its gradient summed over it too
    (a value every rank holds whole, entering partials of a loss that
    is summed over the group; ``x`` as it is without a group)."""
    return x if group is None else _AllReduceSum.apply(x, group, stats)


def stage_exchange(sends: list, recvs: list, group,
                   stats: CommStats | None = None) -> list:
    """One tick's transfers over the stage ``group``: ``sends`` is a
    list of ``(tensor, shift, tag)`` — the tensor goes to group rank
    ``(me + shift) % n`` — and ``recvs`` of ``(like, shift, tag)`` — a
    tensor shaped like ``like`` comes from group rank ``(me - shift) %
    n``. Every send and receive is posted at once
    (``dist.batch_isend_irecv``) and all are waited on, so a ring that
    wraps cannot deadlock on a blocking send; a message matches the
    receive of the same pair and tag (one a pair, direction and tag a
    call). Returns the received tensors, in ``recvs``' order, on
    ``like``'s device. A CUDA tensor on a gloo group goes through host
    memory, one count a tensor in ``stats.staged["p2p"]``."""
    if not sends and not recvs:
        return []
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    def peer(shift):
        return dist.get_global_rank(group, (me + shift) % n)
    ops, out, back = [], [], []
    for x, shift, tag in sends:
        buf = (x.cpu() if _staged(group, x, stats, "p2p") else x)
        ops.append(dist.P2POp(dist.isend, buf.contiguous(), peer(shift),
                              group, tag))
    for like, shift, tag in recvs:
        staged = _staged(group, like, stats, "p2p")
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer(-shift), group, tag))
        out.append(buf)
        back.append(like.device if staged else None)

    def exchange():
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _timed(stats, exchange)
    return [b if d is None else b.to(d) for b, d in zip(out, back)]
