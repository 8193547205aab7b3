"""Pipeline parallelism over a stage group (≙ ``distributedmnist_tpu/ops/
pipeline.py``): the static schedules and the engine that runs one
stage's row of them.

The reference runs its pipeline as one SPMD scan on every device of the
stage axis: each tick every device takes one branch of a ``lax.switch``
(idle, forward, forward + loss seed, backward) and two lockstep
``ppermute``s shift activations forward and cotangents back, bubbles
included; GPipe's backward is the AD transpose of its forward scan.
The port keeps the reference's tables and their semantics and runs
each rank's own row of them over point-to-point transfers with its
stage neighbours (:func:`..ops.collectives.stage_exchange`): an idle
tick computes nothing, and a tick moves only what the table says
arrives. What matches the reference is the result — outputs, losses,
metrics, every gradient, and a mixture-of-experts aux summed over real
(never bubble) works.

* :func:`make_1f1b_schedule` is the reference's greedy interleaved-1F1B
  list scheduler, copied so that its tables are bitwise the reference's
  for every ``(S, v, M, forward_only)``: global chunk ``c`` lives on
  stage ``c % S`` in local slot ``c // S``, so a microbatch rides the
  ring ``v`` times and the chunk after ``j·S + S−1`` is ``(j+1)·S`` on
  stage 0 — the last stage sends forward to stage 0 and stage 0 sends
  cotangents back to the last stage.
* :func:`make_gpipe_schedule` writes GPipe (all forwards, then all
  backwards, the last microbatch's first) in the same table form.
* :func:`run_schedule` is the engine. Each tick a stage does at most
  one chunk-work of its row: a forward (its output sent to the next
  stage, readable there at the next tick), a forward of the last chunk
  that seeds the loss (the head differentiated with respect to its
  params and the chunk output), or a backward that sends the chunk
  input's cotangent back (stage 0 banks chunk 0's). Under 1F1B a
  forward runs without autograd and the backward recomputes the chunk
  from its saved input (the reference's ``jax.vjp`` at tick time);
  under GPipe the forward keeps its graph for the backward, as the
  reference's AD of its scan keeps residuals. Every tick's sends and
  receives are posted together and waited on together.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import CommStats
from .collectives import stage_exchange

# the two directions of a tick's transfers (gloo matches by tag; NCCL
# by order, and a pair exchanges at most one message a direction a tick)
FWD_TAG, BWD_TAG = 0, 1


@functools.lru_cache(maxsize=None)
def make_1f1b_schedule(num_stages: int, num_chunks: int,
                       num_microbatches: int,
                       forward_only: bool = False) -> "Mapping":
    """Build the static interleaved-1F1B tables (greedy list scheduler,
    backward-priority — the 1F1B rule — with forwards preferring the
    deepest ready chunk to keep chains moving).

    Single-slot model: per tick a device does ONE chunk-work. A chunk's
    output transfers to the next device on the tick it is produced and
    is usable from the next tick; per-(slot, microbatch) buffers mean
    arrivals never clobber.

    Returns numpy int32 tables, each [T, S] (indexed [tick, device]):
      kind        0 idle · 1 forward · 2 forward of the LAST global
                  chunk (seeds the loss cotangent) · 3 backward
      slot, mb    the local chunk slot / microbatch of this tick's work
      bank        1 when this tick's backward is global chunk 0 on
                  device 0: its input-cotangent is banked, not sent
      frecv_slot, frecv_mb   where the activation arriving THIS tick
                  (sent by device d-1 this tick, readable next tick)
                  lands in the X buffer; -1 = nothing arrives
      brecv_slot, brecv_mb   same for cotangents from device d+1
    plus "ticks" (T) and "idle_slots" (S·T − 2·M·S·v).

    ``forward_only=True`` builds the inference/eval schedule for the
    same chunk placement: no backward works, kind 2 marks the LAST
    global chunk (its output is banked), idle_slots counts S·T − M·S·v.
    """
    S, v, M = num_stages, num_chunks, num_microbatches
    C = S * v
    f_done: dict = {}
    b_done: dict = {}
    f_arr = {(m, 0): 0 for m in range(M)}
    b_arr: dict = {}
    rows = []
    t = 0
    while (len(f_done) < M * C if forward_only else len(b_done) < M * C):
        if t > 8 * (M * C + S):
            raise RuntimeError("1f1b scheduler stalled (bug)")
        act = {}
        for d in range(S):
            bready = []
            fready = []
            for m in range(M):
                for j in range(v):
                    c = j * S + d
                    if (m, c) not in f_done:
                        if f_arr.get((m, c), 10**9) <= t:
                            fready.append((-c, m))
                        continue
                    if forward_only:
                        continue
                    if (m, c) in b_done or f_done[(m, c)] > t - 1:
                        continue
                    if c == C - 1 or b_arr.get((m, c), 10**9) <= t:
                        bready.append((m, -c))
            if bready:  # backward first — the 1F1B rule
                m, negc = min(bready)
                act[d] = (3, m, -negc)
            elif fready:  # deepest ready chunk first, then earliest mb
                negc, m = min(fready)
                act[d] = (1, m, -negc)
        for d, (kind, m, c) in act.items():
            if kind == 1:
                f_done[(m, c)] = t
                if c < C - 1:
                    f_arr[(m, c + 1)] = t + 1
                else:
                    act[d] = (2, m, c)  # last chunk: seed, nothing sent
            else:
                b_done[(m, c)] = t
                if c > 0:
                    b_arr[(m, c - 1)] = t + 1
        rows.append(act)
        t += 1
    assert len(f_done) == M * C
    assert forward_only or len(b_done) == M * C
    return _tables(rows, S, forward_only, M * C)


@functools.lru_cache(maxsize=None)
def make_gpipe_schedule(num_stages: int, num_microbatches: int,
                        forward_only: bool = False) -> "Mapping":
    """GPipe's order in :func:`make_1f1b_schedule`'s table form (one
    chunk a stage): stage ``d`` forwards microbatch ``t − d`` at tick
    ``t`` (the last stage's forwards seed the loss), then, from tick ``M
    + S − 1``, the backwards run the other way, the last microbatch
    first — the order of the reference's AD transpose of its
    ``pipeline_apply`` scan."""
    S, M = num_stages, num_microbatches
    T_f = M + S - 1
    rows = [{d: (2 if d == S - 1 else 1, t - d, d)
             for d in range(S) if 0 <= t - d < M} for t in range(T_f)]
    if not forward_only:
        rows += [{d: (3, M - 1 - (u - (S - 1 - d)), d) for d in range(S)
                  if 0 <= u - (S - 1 - d) < M} for u in range(T_f)]
    return _tables(rows, S, forward_only, M * S)


def _tables(rows: list, S: int, forward_only: bool,
            works: int) -> "Mapping":
    """The frozen ``[T, S]`` tables of ``rows`` (one ``{device: (kind,
    mb, global chunk)}`` a tick)."""
    T = len(rows)
    tables = {k: np.zeros((T, S), np.int32)
              for k in ("kind", "slot", "mb", "bank")}
    for k in ("frecv_slot", "frecv_mb", "brecv_slot", "brecv_mb"):
        tables[k] = np.full((T, S), -1, np.int32)
    for t, act in enumerate(rows):
        for d, (kind, m, c) in act.items():
            tables["kind"][t, d] = kind
            tables["slot"][t, d] = c // S
            tables["mb"][t, d] = m
            if kind == 3 and c == 0:
                tables["bank"][t, d] = 1
            if kind == 1:  # c < C-1 by construction: receiver gets it
                rd = (d + 1) % S
                tables["frecv_slot"][t, rd] = (c + 1) // S
                tables["frecv_mb"][t, rd] = m
            if kind == 3 and c > 0:
                rd = (d - 1) % S
                tables["brecv_slot"][t, rd] = (c - 1) // S
                tables["brecv_mb"][t, rd] = m
    tables["ticks"] = T
    tables["idle_slots"] = S * T - (1 if forward_only else 2) * works
    # the lru_cache hands the SAME object to every caller: freeze it so
    # a mutating caller cannot silently poison later schedule lookups
    for a in tables.values():
        if isinstance(a, np.ndarray):
            a.flags.writeable = False
    return types.MappingProxyType(tables)


# the stage groups whose point-to-point channel every rank has opened
# together (an NCCL group's first batched point-to-point call must be
# entered by all its ranks; later ticks involve only some)
_warmed: dict[int, Any] = {}


def _warm_up(group, device: torch.device, stats: CommStats | None) -> None:
    """One ring exchange of a one-element tensor on ``group``, entered by
    every rank of it, the first time the group carries a pipeline."""
    if id(group) in _warmed:
        return
    x = torch.zeros(1, device=device)
    stage_exchange([(x, 1, FWD_TAG)], [(x, 1, FWD_TAG)], group, stats)
    _warmed[id(group)] = group


@dataclasses.dataclass
class PipelineResult:
    """What one stage holds after :func:`run_schedule`: the losses and
    metrics a microbatch (the last stage's; zeros elsewhere), the
    banked input cotangents (stage 0's; None elsewhere), each slot's
    float32 parameter gradients summed over microbatches, the head's
    (the last stage's; zeros elsewhere), this stage's summed chunk aux
    (forward works only), and under ``forward_only`` the last chunk's
    outputs (the last stage's; None elsewhere)."""

    losses: torch.Tensor | None = None
    metrics: torch.Tensor | None = None
    dinputs: list | None = None
    dslots: list | None = None
    dhead: list | None = None
    aux_sum: torch.Tensor | None = None
    outputs: list | None = None


def run_schedule(tables: Mapping, *, group, inputs: list | None,
                 like: torch.Tensor, chunk_fn: Callable,
                 num_chunks: int, num_microbatches: int,
                 slot_params: list | None = None,
                 head_fn: Callable | None = None,
                 head_params: list | None = None,
                 recompute: bool = True, aux_cotangent: float = 0.0,
                 forward_only: bool = False,
                 stats: CommStats | None = None) -> PipelineResult:
    """Run this rank's row of ``tables`` over the stage ``group``.

    ``chunk_fn(slot, x) -> (y, aux)`` applies local slot ``slot``
    (global chunk ``slot·S + stage``) to an activation of ``like``'s
    shape and dtype; ``aux`` is a 0-d float32 auxiliary loss (the MoE
    load-balance sum of the chunk's layers) or None. ``inputs``: stage
    0's ``M`` microbatch activations (None elsewhere). ``slot_params[j]``
    are the leaf tensors ``chunk_fn(j, ·)`` reads (each requiring grad);
    ``head_fn(head_params, y, mb) -> (loss, metric)`` is the loss head
    of the last chunk. The aux enters the loss linearly with weight
    ``aux_cotangent``, so each backward seeds the chunk's aux output
    with that constant. ``recompute``: the backward reruns the chunk
    forward from its saved input (1F1B); else the forward keeps its
    graph (GPipe). ``forward_only``: forwards alone, the last chunk's
    outputs banked."""
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    v, M = num_chunks, num_microbatches
    kind_t, slot_t, mb_t, bank_t = (tables[k][:, me] for k in
                                    ("kind", "slot", "mb", "bank"))
    frs_t, frm_t, brs_t, brm_t = (tables[k][:, me] for k in
                                  ("frecv_slot", "frecv_mb", "brecv_slot",
                                   "brecv_mb"))
    device = like.device
    _warm_up(group, device, stats)
    X = [[None] * M for _ in range(v)]
    Gin = [[None] * M for _ in range(v)]
    if me == 0:
        X[0] = list(inputs)
    saved: dict = {}
    res = PipelineResult(aux_sum=torch.zeros((), dtype=torch.float32,
                                             device=device))
    if forward_only:
        res.outputs = [None] * M
    else:
        res.losses = torch.zeros(M, dtype=torch.float32, device=device)
        res.metrics = torch.zeros(M, dtype=torch.float32, device=device)
        res.dinputs = [None] * M if me == 0 else None
        res.dslots = [[torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in ps]
                      for ps in slot_params]
        res.dhead = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in head_params]

    def add_aux(aux):
        if aux is not None:
            res.aux_sum += aux.detach().float()

    for t in range(int(tables["ticks"])):
        kind, j, m = int(kind_t[t]), int(slot_t[t]), int(mb_t[t])
        sends = []
        if kind in (1, 2):
            x = X[j][m]
            if forward_only or recompute:
                X[j][m] = None if forward_only else x
                with torch.no_grad():
                    y, aux = chunk_fn(j, x)
            else:
                with torch.enable_grad():
                    xl = x.detach().requires_grad_(True)
                    y, aux = chunk_fn(j, xl)
                saved[(j, m)] = (xl, y, aux)
                X[j][m] = None
            add_aux(aux)
            if kind == 1:
                sends.append((y.detach(), 1, FWD_TAG))
            elif forward_only:
                res.outputs[m] = y
            else:
                # the seed: the head differentiated with respect to its
                # params and this chunk output
                with torch.enable_grad():
                    yl = y.detach().requires_grad_(True)
                    loss, metric = head_fn(head_params, yl, m)
                    dy, *dh = torch.autograd.grad(loss, [yl, *head_params])
                Gin[j][m] = dy.to(like.dtype)
                for acc, g in zip(res.dhead, dh):
                    acc += g.float()
                res.losses[m] = loss.detach().float()
                res.metrics[m] = metric.detach().float()
        elif kind == 3:
            g = Gin[j][m]
            Gin[j][m] = None
            if recompute:
                with torch.enable_grad():
                    xl = X[j][m].detach().requires_grad_(True)
                    y, aux = chunk_fn(j, xl)
                X[j][m] = None
            else:
                xl, y, aux = saved.pop((j, m))
            outs, cts = [y], [g]
            if aux is not None and aux.requires_grad:
                outs.append(aux)
                cts.append(torch.full_like(aux, aux_cotangent))
            dx, *dp = torch.autograd.grad(outs, [xl, *slot_params[j]], cts,
                                          allow_unused=True)
            for acc, d in zip(res.dslots[j], dp):
                if d is not None:
                    acc += d.float()
            if int(bank_t[t]):
                res.dinputs[m] = dx.to(like.dtype)
            else:
                sends.append((dx.to(like.dtype), -1, BWD_TAG))
        recvs, where = [], []
        if frs_t[t] >= 0:
            recvs.append((like, 1, FWD_TAG))
            where.append((X, int(frs_t[t]), int(frm_t[t])))
        if brs_t[t] >= 0:
            recvs.append((like, -1, BWD_TAG))
            where.append((Gin, int(brs_t[t]), int(brm_t[t])))
        for (buf, jj, mm), got in zip(where, stage_exchange(
                sends, recvs, group, stats)):
            buf[jj][mm] = got
    return res
