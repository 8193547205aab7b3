"""The train and eval steps (≙ ``distributedmnist_tpu/parallel/api.py``)
for ``n`` data-parallel replicas in every ``sync.mode``, and the state
they update: its init, its ZeRO-1 layout and its mesh-portable restore.

The reference's step is one SPMD program over a replica mesh: each
replica differentiates its local loss (with its own dropout key),
drop-connect masks its gradient, a step-time model and the sync
discipline decide which replicas contribute, a masked-mean psum
aggregates them, and every replica applies the same update. The port
runs the same step for the ``L`` replicas of each process, ``n`` over
all processes (:mod:`..core.mesh`):

* each local replica's forward and backward runs on its row block of
  the process's batch with its own dropout mask (keyed by its global
  index) — all local replicas at once, as one ``torch.func.vmap`` of
  ``grad`` (the flash attention's vmap rule folds the replicas into one
  kernel launch), or one at a time through plain autograd where the
  model cannot be vmapped (the transformer under ``model.remat``:
  ``torch.utils.checkpoint`` does not run under ``torch.func``) — and
  its gradient leaves, loss and accuracy are flattened into one bucket
  row;
* with ``train.grad_accum_steps = a`` the process's batch holds ``a``
  consecutive global batches (``data/pipeline.py GradAccumFeed``); each
  replica splits its row block into ``a`` consecutive microbatches
  (microbatch ``i`` draws its dropout from step ``step·a + i``), sums
  their float32 gradients, losses and accuracies and divides by ``a``:
  one optimizer application a step;
* with ``precision.master_weights`` the params are float32 masters and
  the forward sees their ``precision.param_dtype`` cast; without it a
  low-precision ``param_dtype`` is the storage dtype itself. Either way
  the update runs in float32 (``train/optim.py``);
* the modeled step times and the flags of all ``n`` replicas depend
  only on keys, the step and the measured ``[n]`` base, which every
  process holds alike, so each host computes the same ones while its
  device runs the backward: ``applied`` is a host number and the step
  never waits on the device for it;
* each bucket row's gradient is scaled by ``flag / max(Σflag, 1)`` and
  one sum over replicas — the local sum, then one all-reduce across
  processes — gives the masked mean and the loss and accuracy sums
  (:mod:`..ops.masked_psum`): one collective a step;
* stateless sgd applies ``lr·applied`` (a no-op at 0, as the
  reference's); an optimizer with slots skips the update when nothing
  was applied — the reference's ``where(applied, new, old)``;
* interval mode accumulates the masked means into ``window_acc`` and
  applies their average when the modeled wall clock crosses the window
  (``_interval_apply``).

ZeRO-1 (``parallel.shard_weight_update``, arXiv:2004.13336) replaces
the all-reduce and the replicated update for the leaves the plan shards
(:mod:`.partition_rules`): per communication bucket the scaled
gradients of its leaves, each padded to ``[n, chunk]``, are concatenated
along columns and reduce-scattered (:meth:`..core.mesh.Topology.
reduce_scatter_replicas`), so a process receives only its replicas'
chunks of the mean; the optimizer updates those chunks and their slots,
which live as flat ``[L·chunk]`` tensors; an all-gather per bucket
brings the params back whole — or, under ``parallel.resident_sharded``,
the params stay chunks too and the next forward gathers them
(:func:`logical_params`). Leaves below the shard floor, and the loss
and accuracy, take one all-reduce as before. On one process every
chunk is local: the reduce-scatter is the local sum, in the same order
as the replicated path's, the updates run on views of the leaves, and
the result is bitwise the replicated update's under every optimizer.
Across processes the trust-ratio norms complete over the processes
(one all-reduce of a 0-d sum of squares) and the collectives sum in
their own order: close to the one-process run, not bitwise.

The ``[3]`` discipline vector ``(k, timeout_ms, interval_ms)`` and the
``[n]`` measured base times are step inputs, read every call, so either
can change between steps with no rebuild. Metrics keep the reference's
keys and shapes.

The step (:class:`TrainStep`) is a host part and a device body. The
host part makes every per-step number (the flags and contribution
scale, lr, LAMB's bias corrections, the interval clock, every
replica's dropout and drop-connect keys) and the device body reads them
from static buffers, in stages, so that on the card the body can be
captured as CUDA graphs (``Trainer.precompile``, :mod:`.graphs`) and
replayed every step; eager calls run the same stages over the same
buffers.

Tensor, sequence and expert parallelism (``mesh.model_parallelism =
m``, ``mesh.seq_parallelism = s``, ``mesh.expert_parallelism = e``; ≙
the SP, TP and EP parts of the reference's ``build_train_step``): each
replica spans ``m·s·e`` processes (:mod:`..core.mesh`). The state holds
this rank's model and expert shard of every leaf the model's partition
rules split (:func:`tp_shard`; the replicated leaves whole), and the
step loops the local replicas (``vmap`` cannot carry process-group
collectives): each runs the model's ``sharded_apply_factory`` on its
block of the sequence with its global positions, takes the
sequence-parallel partial loss (the targets shifted one *global*
position, the next block's first column through a ``ppermute``,
normalised by ``b·(S−1)``; a mixture-of-experts model adds
``aux_weight · aux / s``, its aux already the full-token value on every
block), and sums its loss, accuracy and every gradient over the seq
group. Sharded leaves keep their shard's gradient; the replicated ones
(attention, router, norms, embeddings) come out identical on every
model and expert rank. The masked mean and every sync mode then run
over the replica group as above, and LARS/LAMB complete each split
leaf's sum of squares over the groups it is split over.

Pipeline parallelism (``mesh.pipeline_parallelism = S``; ≙ the PP
branches of the reference's ``build_train_step`` and
``build_eval_step``) adds the stage axis: the params are the stacked
layout (``blocks`` one dict of leaves stacked on a layer dim; under
``1f1b`` in the chunk-interleaved order), each stage holding its rows
of every block leaf (:func:`tp_shard` over the stage group too), and
each local replica's gradients come from the model's pipelined step
body (``pp_grads_factory`` for GPipe, ``pp_1f1b_grads_factory``; ≙
``compute_grads``): the engine of ``ops/pipeline.py`` over the stage
group, TP, SP and EP inside each stage, the leaves every stage holds
whole (``embed``, ``pos``, ``final_norm``) summed over the stage group
— what JAX's transpose of replication gives — and under SP the partial
loss summed over the seq group as above. Eval pipelines at the largest
microbatch count up to ``mesh.pipeline_microbatches`` that divides the
rows (the reference's ``m_eval``).

ZeRO-1 composes with all of them (≙ the reference's ``_zero1_update``
under ``shard_map``): the plan reads the rule engine's specs, so a leaf
split over the model, expert or stage axis is a fallback leaf — it
keeps its shard, takes the masked-mean all-reduce over the replica
group and its full update, its trust-ratio norms completed over the
groups it is split over — and every other leaf shards over the replica
group alone: its reduce-scatter, its norms and its all-gather run over
the ``P_r`` processes of one ``(model, seq, stage, expert)``
coordinate. The seq group's gradient sum (SP) and the stage group's sum
of the whole leaves (PP) come first, inside the ``grads`` stage.

Checkpoints hold the logical layout whatever the live one
(:func:`canonical_save_state`; under TP the shards gathered first,
:func:`gather_state`); :func:`restore_for_topology` reads one saved
under any replica, process or model-parallel count, refuses another
optimizer's state, repacks for this run's plan, shards and storage
dtype and journals a world change.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from ..core import prng
from ..core.config import ConfigError, ExperimentConfig
from ..core.device import cudnn_policy
from ..core.log import get_logger
from ..core.mesh import Topology, make_topology
from ..models.registry import Model, torch_dtype
from ..ops import masked_psum
from ..ops.collectives import ppermute
from ..ops.drop_connect import leaf_keys, mask_leaves
from ..train import optim as optim_lib
from . import policies
from .partition_rules import (LeafShardPlan, RuleAxes, Zero1Plan,
                              comm_bucket_assignment, make_zero1_plan,
                              map_leaves, match_partition_rules,
                              shard_leaf, spec_leaves, split_dim,
                              tree_leaves, tree_path_names,
                              zero1_init_state, zero1_logical, zero1_pack,
                              zero1_unpack)

logger = get_logger("parallel")

Schedule = Callable[[int], float]

# the discipline vector's slots (≙ the reference's DISC_* indices)
DISC_K = 0
DISC_TIMEOUT_MS = 1
DISC_INTERVAL_MS = 2

_F32 = np.float32


def make_discipline_vector(k: float, timeout_ms: float,
                           interval_ms: float) -> torch.Tensor:
    """The ``[3]`` float32 step input ``(k, timeout_ms, interval_ms)``
    (host tensor)."""
    return torch.tensor([float(k), float(timeout_ms), float(interval_ms)],
                        dtype=torch.float32)


def tree_map(fn: Callable, tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`
    order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


@dataclasses.dataclass
class TrainState:
    """Training state, with the reference's field names (so a
    checkpoint's state dict is the reference's).

    ``params`` and ``momentum`` are trees of tensors on the device, the
    same for every replica. ``momentum`` holds the optimizer's slots:
    None (stateless sgd), one params-shaped float32 tree (momentum,
    LARS) or ``{"m": tree, "v": tree}`` (LAMB). Under a ZeRO-1 plan a
    sharded leaf's slots are flat ``[L·chunk]`` tensors holding this
    process's replicas' chunks (``[pad]`` with one process), and under
    ``resident_sharded`` its params too; ``params`` are stored in
    :func:`resolved_param_dtype`. ``step`` counts loop iterations and
    ``updates_applied`` applied updates (the reference's global_step;
    they differ when a step is masked out or an interval window has
    not fired). Interval mode keeps its float32 window accumulator
    (``window_acc``, a params-shaped tree, None in the other modes), the
    rounds in it, the modeled wall clock and the next firing time; the
    clock fields are Python floats holding float32 values."""

    params: Any
    momentum: Any
    step: int
    updates_applied: int
    root_key: np.ndarray
    window_acc: Any = None
    window_rounds: float = 0.0
    wall_ms: float = 0.0
    next_apply_ms: float = 1000.0


def _check_config(cfg: ExperimentConfig) -> None:
    """Raise for a config the step cannot run: an accumulation count
    below 1, an unknown storage dtype."""
    if cfg.train.grad_accum_steps < 1:
        raise ValueError(f"train.grad_accum_steps must be >= 1, got "
                         f"{cfg.train.grad_accum_steps}")
    resolved_param_dtype(cfg)


def resolved_param_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """The dtype ``TrainState.params`` is stored in: float32 masters
    under ``precision.master_weights``, else ``precision.param_dtype``.
    An unknown or non-floating dtype is a ConfigError naming the key."""
    name = cfg.precision.param_dtype
    try:
        dt = torch_dtype(name)
    except ValueError as e:
        raise ConfigError(f"precision.param_dtype={name!r} is not a "
                          f"recognized dtype ({e}); use e.g. 'float32' or "
                          "'bfloat16'") from e
    return torch.float32 if cfg.precision.master_weights else dt


def build_params(model: Model, cfg: ExperimentConfig, topo: Topology | None,
                 device) -> Any:
    """The model's params from ``model.init_seed`` in the layout the mesh
    trains (≙ the reference's ``_build_params``): with a stage axis the
    stacked layout (``pp_transform``; under ``1f1b`` the chunk-interleaved
    one); on the ``meta`` device, the shapes alone."""
    params = model.init_params(cfg.model.init_seed, device)
    S = 1 if topo is None else topo.pipeline_parallelism
    if S > 1:
        if model.pp_transform is None:
            raise ValueError(f"mesh has pipeline stages but model "
                             f"{model.name!r} has no pp_transform")
        if cfg.mesh.pipeline_schedule == "1f1b":
            if model.pp_transform_chunked is None:
                raise ValueError(
                    f"pipeline_schedule='1f1b' but model {model.name!r} "
                    "has no pp_transform_chunked")
            return model.pp_transform_chunked(params, S,
                                              cfg.mesh.pipeline_chunks)
        return model.pp_transform(params)
    return params


def zero1_plan_for(model: Model, cfg: ExperimentConfig, topo: Topology,
                   params: Any = None) -> Zero1Plan | None:
    """The ZeRO-1 plan when ``parallel.shard_weight_update`` is set and
    applies, else None. It does not apply to one replica (nothing is
    redundant) nor in interval mode (the window accumulates the whole
    mean). ``params`` (logical shapes, stacked under a stage axis)
    default to the model's on the ``meta`` device; the specs are the
    rule engine's for ``topo`` (:func:`tp_specs`), so a leaf split over
    the model, expert or stage axis stays a fallback leaf (≙ the
    reference's ``zero1_plan_for`` over ``params_partition_specs``)."""
    par = cfg.parallel
    par.validate()
    if not par.shard_weight_update:
        return None
    if topo.num_replicas <= 1 or cfg.sync.mode == "interval":
        return None
    if params is None:
        params = build_params(model, cfg, topo, torch.device("meta"))
    return make_zero1_plan(params, tp_specs(model, topo, params),
                           topo.num_replicas,
                           min_leaf_size=par.shard_min_leaf_size,
                           comm_buckets=par.comm_buckets,
                           params_sharded=par.resident_sharded)


def _local_span(lp: LeafShardPlan, topo: Topology | None,
                n: int) -> tuple[int, int]:
    first, count = ((0, n) if topo is None
                    else (topo.first_replica, topo.local_replica_count))
    return first * lp.chunk, (first + count) * lp.chunk


def _local_flat(x: torch.Tensor, lp: LeafShardPlan, lo: int,
                hi: int) -> torch.Tensor:
    """Elements ``[lo, hi)`` of ``x``'s flat zero-padded layout, as a
    fresh tensor."""
    flat = x.reshape(-1)
    if hi <= lp.size:
        return flat[lo:hi].clone()
    out = flat.new_zeros(hi - lo)
    if lo < lp.size:
        out[:lp.size - lo] = flat[lo:]
    return out


def init_train_state(model: Model, cfg: ExperimentConfig,
                     device: torch.device,
                     topo: Topology | None = None) -> TrainState:
    """Fresh params from ``model.init_seed`` (the CNN and ResNet-20: the
    reference's key; the transformer: a torch generator, other numbers
    than the reference's) in the storage dtype, zero float32 slots — in
    the ZeRO-1 layout of ``topo`` when a plan applies, with the params
    packed too under ``resident_sharded`` — and interval mode's zero
    window."""
    opt = optim_lib.make_optimizer(cfg.optim)
    params = build_params(model, cfg, topo, device)
    store_dt = resolved_param_dtype(cfg)
    if store_dt != torch.float32:
        # no master copy: cast once, updated in this dtype from now on
        params = tree_map(lambda p: p.to(store_dt) if p.is_floating_point() else p,
                          params)
    # the plan reads the logical shapes, before any shard is cut
    plan = (zero1_plan_for(model, cfg, topo, params)
            if topo is not None else None)
    if topo is not None:
        # every model, stage and expert rank draws the full params, then
        # keeps its shard (the plan's replicated leaves stay whole)
        params = tp_shard(params, model, topo)

    def one_slot_tree():
        if plan is not None:
            return zero1_init_state(params, plan, optim_lib.slot_dtype,
                                    topo.local_replica_count)
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=optim_lib.slot_dtype(p.dtype), device=p.device),
            params)

    momentum = optim_lib.init_slots(opt, one_slot_tree)
    window = None
    if cfg.sync.mode == "interval":
        # float32 always: the window sums float32 masked means
        window = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    if plan is not None and plan.params_sharded:
        params = map_leaves(lambda p, lp: (_local_flat(p, lp, *_local_span(
            lp, topo, plan.n)) if lp.sharded else p), params,
            plan.leaf_plans)
    return TrainState(
        params=params, momentum=momentum, step=0, updates_applied=0,
        root_key=prng.root_key(cfg.train.seed), window_acc=window,
        next_apply_ms=float(_F32(cfg.sync.interval_ms)))


def world_signature(topo: Topology) -> dict:
    """The world a checkpoint is saved under (≙ the reference's
    ``world_signature``: the process count, and only axes > 1 in the
    mesh record)."""
    n = int(topo.num_replicas)
    sizes = (n, topo.model_parallelism, topo.seq_parallelism,
             topo.expert_parallelism, topo.pipeline_parallelism)
    return {"num_replicas": n, "process_count": int(topo.world_size),
            "mesh": {name: int(k) for name, k in zip(topo.axis_names, sizes)
                     if k > 1}}


# -- tensor-, pipeline- and expert-parallel shards ---------------------------

def _shard_axes(topo: Topology) -> list:
    """``(axis name, this rank's index, size, group)`` of each active
    axis that splits leaves: model, then expert, then stage."""
    out = []
    if topo.model_parallelism > 1:
        out.append((topo.axis_names[1], topo.model_index,
                    topo.model_parallelism, topo.model_group))
    if topo.expert_parallelism > 1:
        out.append((topo.axis_names[3], topo.expert_index,
                    topo.expert_parallelism, topo.expert_group))
    if topo.pipeline_parallelism > 1:
        out.append((topo.axis_names[4], topo.stage_index,
                    topo.pipeline_parallelism, topo.stage_group))
    return out


def _splits_leaves(topo: Topology) -> bool:
    """Whether some leaf is split over this topology's processes (a
    model, expert or stage axis > 1)."""
    return (topo.model_parallelism * topo.expert_parallelism
            * topo.pipeline_parallelism) > 1


def tp_specs(model: Model, topo: Topology, params: Any) -> Any | None:
    """The spec a leaf of ``params`` (full or shard shapes) under the
    model's partition rules with the model, expert and stage axes bound,
    or None without tensor, expert or pipeline parallelism. A model with
    no table or no sharded apply is refused, and one without experts on
    an expert axis, with the reference's messages."""
    m, e = topo.model_parallelism, topo.expert_parallelism
    S = topo.pipeline_parallelism
    if not _splits_leaves(topo):
        return None
    if e > 1 and not any(n.endswith("router")
                         for n in tree_path_names(params)):
        raise ValueError(f"mesh has expert_parallelism={e} but model "
                         f"{model.name!r} has no experts to shard")
    if model.partition_rules is None or model.sharded_apply_factory is None:
        raise ValueError(
            f"mesh has model_parallelism={m} but model "
            f"{model.name!r} has no tensor-parallel parameter specs")
    rules = model.partition_rules(RuleAxes(
        model=topo.axis_names[1] if m > 1 else None,
        expert=topo.axis_names[3] if e > 1 else None,
        stage=topo.axis_names[4] if S > 1 else None))
    return match_partition_rules(rules, params)


def tp_shard(tree: Any, model: Model, topo: Topology) -> Any:
    """This rank's model, expert and stage shard of a full params-shaped
    tree of tensors (a copy of each split leaf, so the full one can go);
    ``tree`` as it is without tensor, expert or pipeline parallelism."""
    specs = tp_specs(model, topo, tree) if tree is not None else None
    if specs is None:
        return tree
    axes = _shard_axes(topo)

    def shard(x, spec):
        if all(split_dim(spec, a) is None for a, *_ in axes):
            return x
        for axis, i, size, _ in axes:
            x = shard_leaf(x, spec, axis, i, size)
        return x.clone()
    return map_leaves(shard, tree, specs)


def tp_gather(tree: Any, model: Model, topo: Topology) -> Any:
    """The full tree on every rank of the model, expert and stage groups
    from each rank's shard (one all-gather a split leaf and axis; every
    rank must call it); ``tree`` as it is without tensor, expert or
    pipeline parallelism."""
    specs = tp_specs(model, topo, tree) if tree is not None else None
    if specs is None:
        return tree
    axes = _shard_axes(topo)

    def gather(x, spec):
        for axis, _, size, group in axes:
            d = split_dim(spec, axis)
            if d is not None:
                blocks = [torch.empty_like(x) for _ in range(size)]
                topo.all_gather(blocks, x.contiguous(), group)
                x = torch.cat(blocks, dim=d)
        return x
    return map_leaves(gather, tree, specs)


def gather_state(state: TrainState, model: Model,
                 topo: Topology) -> TrainState:
    """``state`` with its params, slots and window gathered whole from
    the model, expert and stage groups' shards (every rank of the groups
    must call it; ``state`` itself without tensor, expert or pipeline
    parallelism)."""
    if not _splits_leaves(topo):
        return state
    full = lambda tree: tp_gather(tree, model, topo)  # noqa: E731
    return dataclasses.replace(
        state, params=full(state.params),
        momentum=optim_lib.map_slots(full, state.momentum),
        window_acc=full(state.window_acc))


# -- the live layout and the canonical one ----------------------------------

def logical_params(params: Any, plan: Zero1Plan | None,
                   topo: Topology) -> Any:
    """The logical-shape params of the live ones: ``params`` as they are
    without a resident plan; else each sharded leaf's ``[pad]`` as a view
    of its first ``size`` elements (one process), or gathered from every
    process's chunks, one all-gather a communication bucket (≙
    ``_gather_resident_params``; every process must call it)."""
    if plan is None or not plan.params_sharded:
        return params
    leaves, lps = tree_leaves(params), plan.leaves()
    out = list(leaves)
    L = topo.local_replica_count
    if L == plan.n:
        for i, lp in enumerate(lps):
            if lp.sharded:
                out[i] = leaves[i][:lp.size].view(lp.shape)
        return tree_unflatten(params, out)
    for bucket in comm_bucket_assignment(plan):
        full = topo.all_gather_replicas(torch.cat(
            [leaves[i].view(L, lps[i].chunk) for i in bucket], dim=1))
        off = 0
        for i in bucket:
            lp = lps[i]
            out[i] = full[:, off:off + lp.chunk].reshape(-1)[
                :lp.size].view(lp.shape)
            off += lp.chunk
    return tree_unflatten(params, out)


def canonical_save_state(state: TrainState,
                         plan: Zero1Plan | None) -> TrainState:
    """The state as a single-file checkpoint stores it: slots (and
    resident params) in their logical shapes whatever the live layout,
    so the artifact and its digests are the same across
    ``shard_weight_update``, ``comm_buckets`` and ``resident_sharded``
    (views, no copies). Needs every chunk on this process: across
    processes the per-host layout saves the live chunks instead."""
    if plan is None:
        return state
    unpack = lambda tree: zero1_unpack(tree, plan)  # noqa: E731
    return dataclasses.replace(
        state, momentum=optim_lib.map_slots(unpack, state.momentum),
        params=unpack(state.params) if plan.params_sharded else state.params)


def pack_restored_state(saved: dict, plan: Zero1Plan | None,
                        topo: Topology | None = None) -> dict:
    """Inverse of :func:`canonical_save_state` on a restored state dict
    (numpy leaves, the reference layout): every slot and param leaf in
    its logical shape (a per-host checkpoint's are flat, padded for the
    saver's replica count), then the slots — and, for a resident plan,
    the params — of every sharded leaf packed for this plan and cut to
    this process's chunks."""
    if plan is None:
        return saved
    from ..models.convert import list_form

    def local(tree):
        packed = zero1_pack(zero1_logical(list_form(tree), plan), plan)
        return map_leaves(lambda a, lp: (a[slice(*_local_span(lp, topo, plan.n))]
                                   if lp.sharded else a),
                    packed, plan.leaf_plans)

    out = dict(saved)
    if out.get("momentum") is not None:
        out["momentum"] = optim_lib.map_slots(local, out["momentum"])
    out["params"] = (local(out["params"]) if plan.params_sharded
                     else zero1_logical(list_form(out["params"]), plan))
    return out


def restore_for_topology(model: Model, cfg: ExperimentConfig,
                         topo: Topology, train_dir, template_state: TrainState,
                         step: int | None = None,
                         on_event: Callable[[dict], None] | None = None,
                         device: torch.device | None = None,
                         check_optimizer: bool = True,
                         ) -> tuple[TrainState, dict, int] | None:
    """Mesh-portable restore (≙ the reference's): read a checkpoint saved
    under any replica, process or model-parallel count — single file or
    per-host shards — and rebuild the live state for THIS run on the
    template's device: the ZeRO-1 plan is derived from this run's
    replica count, the slots (and resident params) repacked for it, the
    params cast to this run's storage dtype, and under tensor
    or expert parallelism every params-shaped tree cut to this rank's
    shard. A checkpoint whose saved optimizer names
    another state kind raises ``OptimizerStateMismatchError`` before
    anything is grafted; a world change is reported through
    ``on_event`` as ``cross_world_restore`` naming both worlds. A
    per-host checkpoint's flat leaves come back in their logical shapes
    first, so it also restores onto a run without ZeRO-1 (a plan over
    one replica, which shards nothing, does that). ``device`` (default:
    the template's) is where the state is built; a consumer of the
    params alone (a serving replica) passes ``check_optimizer=False``
    and skips the optimizer probe, a second read of the artifact. None
    when nothing is loadable."""
    from ..models.convert import state_from_reference
    from ..train import checkpoint as ckpt
    try:
        extra_got = (ckpt.read_checkpoint_extra(train_dir, step)
                     if check_optimizer else None)
    except (OSError, ValueError, KeyError):
        # an unreadable newest artifact: restore_state owns the fallback
        # (older steps carry the same optimizer config)
        extra_got = None
    if extra_got is not None:
        saved_extra, probe_step = extra_got
        saved_optim = ((saved_extra or {}).get("config") or {}).get("optim")
        saved_kind = optim_lib.saved_opt_state_kind(saved_optim)
        want_kind = optim_lib.opt_state_kind(cfg.optim)
        if saved_kind is not None and saved_kind != want_kind:
            raise ckpt.OptimizerStateMismatchError(
                f"checkpoint step={probe_step} in {train_dir} holds "
                f"{saved_kind!r} optimizer state (saved optim config "
                f"{saved_optim!r}) but this run's optim.name="
                f"{cfg.optim.name!r} needs {want_kind!r} state; refusing "
                "to graft mismatched opt-state trees — restore under the "
                "saving optimizer, or start the new optimizer fresh "
                "(train.resume=false / a fresh train_dir)",
                saved_kind=saved_kind, requested_kind=want_kind)
    restored = ckpt.restore_state(train_dir, step=step, on_event=on_event)
    if restored is None:
        return None
    saved, extra, got_step = restored
    shapes = build_params(model, cfg, topo, torch.device("meta"))
    plan = (zero1_plan_for(model, cfg, topo, shapes)
            or make_zero1_plan(shapes, None, 1))
    if device is None:
        device = tree_leaves(template_state.params)[0].device
    state = state_from_reference(pack_restored_state(saved, plan, topo),
                                 device=device)
    store_dt = resolved_param_dtype(cfg)
    state.params = tree_map(
        lambda p: p.to(store_dt) if p.is_floating_point() and p.dtype != store_dt
        else p, state.params)
    # the checkpoint holds whole leaves: keep this rank's shards
    shard = lambda tree: tp_shard(tree, model, topo)  # noqa: E731
    state.params = shard(state.params)
    state.momentum = optim_lib.map_slots(shard, state.momentum)
    state.window_acc = shard(state.window_acc)
    saved_world = (extra or {}).get("world")
    current = world_signature(topo)
    if isinstance(saved_world, dict) and saved_world != current:
        logger.info("cross-world restore: checkpoint step=%d saved under "
                    "world %s resharded onto %s", got_step, saved_world,
                    current)
        if on_event is not None:
            on_event({"layer": "checkpoint",
                      "action": "cross_world_restore", "step": got_step,
                      "saved_world": saved_world, "new_world": current})
    return state, extra, got_step


# -- the steps -------------------------------------------------------------

def _f32_sum(values) -> _F32:
    """Left-to-right float32 sum (the order of an all-reduce over
    replicas 0..n-1)."""
    acc = _F32(0.0)
    for v in values:
        acc = _F32(acc + _F32(v))
    return acc


def _padded_rows(g: torch.Tensor, lp: LeafShardPlan) -> torch.Tensor:
    """``[L, ...]`` replica gradients → ``[L, n, chunk]``, each replica's
    leaf flattened and zero-padded to ``pad``."""
    rows = g.reshape(g.shape[0], -1)
    if lp.pad != lp.size:
        rows = F.pad(rows, (0, lp.pad - lp.size))
    return rows.view(g.shape[0], -1, lp.chunk)


# the number of pinned staging buffers a train step cycles through: the
# host may run this many steps ahead of the card before it waits
_STAGING_RING = 4


@dataclasses.dataclass
class HostStep:
    """One step's numbers that need no device, made by the host before
    any of the step's device work: the modeled times and flags, the
    contribution scale and contributor count, the schedule's ``lr``,
    ``applied``, the update stage that runs (None: none), the values
    the input buffer gets (the update's ``lr``, LAMB's corrections, the
    interval window's divisor) and interval mode's new clock ``(rounds,
    wall_ms, next_apply_ms)``."""

    t_ms: torch.Tensor
    flags: torch.Tensor
    scale: torch.Tensor
    num: torch.Tensor
    lr: float
    applied: int
    update: str | None
    lr_update: float
    corrections: tuple[float, float]
    rounds: float
    window: tuple[float, float, float] | None


class _Binding:
    """The device body's static buffers for one state: the state's
    tensors (updated in place), a batch buffer, the per-step input buffer
    (float64 ``[W]`` on the device: every number and key word of a step
    is exact in float64) with its pinned staging ring, the named stages
    and, once captured, their graphs."""

    def __init__(self, state: TrainState, batch: dict, width: int,
                 slot_trees: Callable[[Any], list]):
        self.state = state
        self.params = state.params
        self.leaves = tree_leaves(state.params)
        self.slots = [tree_leaves(t) for t in slot_trees(state.momentum)]
        self.window = (tree_leaves(state.window_acc)
                       if state.window_acc is not None else None)
        self.held = _state_tensors(state)
        device = self.leaves[0].device
        self.device = device
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.inputs = torch.zeros(width, dtype=torch.float64, device=device)
        cuda = device.type == "cuda"
        self.staging = [torch.zeros(width, dtype=torch.float64,
                                    pin_memory=cuda)
                        for _ in range(_STAGING_RING if cuda else 1)]
        self.staged = [None] * len(self.staging)  # each one's copy event
        self.turn = 0
        self.stages: dict[str, Callable[[], Any]] = {}
        self.replay = None  # a GraphReplay once captured

    def holds(self, state: TrainState, batch: dict) -> bool:
        """Whether ``state`` is this binding's, tensor for tensor, and
        ``batch`` fits its buffer."""
        now = _state_tensors(state)
        return (state is self.state and state.params is self.params
                and batch.keys() == self.batch.keys()
                and all(tuple(v.shape) == tuple(self.batch[k].shape)
                        for k, v in batch.items())
                and len(now) == len(self.held)
                and all(a is b for a, b in zip(now, self.held)))

    def stage(self, fill: Callable[[np.ndarray], None], batch: dict) -> None:
        """Fill the next staging buffer on the host (waiting first for the
        copy that last read it), copy it into the input buffer with one
        host-to-device copy, and the batch into the batch buffer."""
        i = self.turn
        self.turn = (i + 1) % len(self.staging)
        if self.staged[i] is not None:
            self.staged[i].synchronize()
        buf = self.staging[i]
        fill(buf.numpy())
        self.inputs.copy_(buf, non_blocking=True)
        if self.device.type == "cuda":
            ev = self.staged[i] = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        for k, v in batch.items():
            self.batch[k].copy_(v, non_blocking=True)

    def run(self, name: str) -> Any:
        if self.replay is not None:
            return self.replay.replay(name)
        return self.stages[name]()


class TrainStep:
    """The train step (≙ the reference's ``build_train_step``), split in
    two. A host part makes every per-step number that needs no device —
    modeled times, flags, contribution scale, lr, the update count's
    LAMB corrections, the PRNG keys of every replica's dropout and
    drop-connect, the interval clock — and fills one pinned staging
    buffer. A device body reads all of them from static buffers (one
    host-to-device copy a step into the input buffer, the batch copied
    into the batch buffer) and updates the state's tensors in place, in
    stages: ``grads`` (every local replica's forward and backward,
    drop-connect, the masked mean), then the update stage the host
    picked — ``apply``, or interval mode's ``join`` / ``join_fire``, or
    ZeRO-1's ``zero1`` / ``zero1_reduce`` — or none (an optimizer with
    slots when nothing was applied).

    A call runs the stages eagerly, or, for the state :meth:`prepare`
    bound and captured, replays their CUDA graphs: the same bodies over
    the same buffers either way, so a replay is bitwise an eager step
    and the CPU's eager run exercises exactly what the card records.
    The bound state's tensors must stay the ones captured (restore into
    them in place, :func:`load_state_into`)."""

    def __init__(self, model: Model, cfg: ExperimentConfig,
                 schedule: Schedule, topo: Topology | None = None, *,
                 cudnn_deterministic: bool = True):
        _check_config(cfg)
        topo = topo or make_topology(cfg.mesh)
        self.model, self.cfg, self.schedule, self.topo = (model, cfg,
                                                          schedule, topo)
        self.cudnn_deterministic = cudnn_deterministic
        self.n, self.L, self.first = (topo.num_replicas,
                                      topo.local_replica_count,
                                      topo.first_replica)
        # one bucket and one sum over replicas whenever there is more
        # than one replica or a process group to reduce over
        self.bucketed = self.n > 1 or topo.distributed
        sync = self.sync = cfg.sync
        sync.validate(num_replicas=self.n)
        self.mode = sync.mode
        if self.mode not in ("sync", "quorum", "timeout", "interval", "cdf"):
            raise ValueError(f"unknown sync mode {self.mode!r}")
        k = policies.resolve_aggregate_k(sync, self.n)
        self.accum = int(cfg.train.grad_accum_steps)
        self.param_dtype = torch_dtype(cfg.precision.param_dtype)
        self.fwd_cast = (cfg.precision.master_weights
                         and self.param_dtype != torch.float32)
        self.plan = plan = zero1_plan_for(model, cfg, topo)
        if cfg.parallel.shard_weight_update and plan is None:
            logger.warning(
                "parallel.shard_weight_update=true is a no-op here (%s); "
                "running the replicated update",
                "replica axis is 1" if self.n <= 1 else
                f"sync.mode={self.mode!r} keeps the full windowed "
                "accumulator")
        if model.loss is None or model.accuracy is None:
            raise ValueError(f"model {model.name!r} has no loss/accuracy")
        self.sharded_apply = self.pp_grads = None
        if topo.pipeline_parallelism > 1:
            self.pp_grads = self._pipeline_grads(model, cfg, topo)
        elif topo.sharded:
            self.sharded_apply = self._sharded_apply(model, topo)
        self.opt = optim_lib.make_optimizer(cfg.optim)
        self.default_disc = make_discipline_vector(k, sync.timeout_ms,
                                                   sync.interval_ms)
        self.tf32 = False if model.compute_dtype == torch.float32 else None
        self.zeros_ms = torch.zeros(self.n, dtype=torch.float32)
        if plan is not None:
            self.lps = plan.leaves()
            sharded = [i for i, lp in enumerate(self.lps) if lp.sharded]
            self.fallback = [i for i, lp in enumerate(self.lps)
                             if not lp.sharded]
            # the update's reduce-scatters: one a leaf (monolithic) or one
            # a layer-ordered bucket; the same addends either way
            self.scatter_groups = (comm_bucket_assignment(plan)
                                   if plan.comm_buckets > 1
                                   else [[i] for i in sharded])
        # the input buffer's layout: scale [n], the update's lr, LAMB's
        # two corrections, the interval divisor, then the dropout keys
        # [accum, L, 2] and the drop-connect keys [L, leaves, 2]
        shapes = build_params(model, cfg, topo, torch.device("meta"))
        n_leaves = len(tree_leaves(shapes))
        self.n_leaves = n_leaves
        # each leaf's sum of squares completes over the groups the leaf
        # is split over (LARS/LAMB trust ratios)
        specs = tp_specs(model, topo, shapes)
        self.norm_reduce = [
            self._norm_reduce(spec) for spec in
            (spec_leaves(specs) if specs is not None else [()] * n_leaves)]
        self.at_keys = self.n + 4
        self.dropout_words = (self.accum * self.L * 2
                              if model.dropout_masks is not None else 0)
        self.at_dc = self.at_keys + self.dropout_words
        self.dc_words = self.L * n_leaves * 2 if sync.drop_connect else 0
        self.width = self.at_dc + self.dc_words
        self._prepared: _Binding | None = None
        self._scratch: _Binding | None = None

    def _norm_reduce(self, spec) -> Callable:
        """How a leaf's sum of squares completes: over the model, expert
        or expert×model group, as the leaf is split, then over the stage
        group for a stacked block leaf (its norm is the whole stacked
        leaf's, as the reference's is)."""
        topo = self.topo
        split = [split_dim(spec, a) is not None
                 for a in (topo.axis_names[1], topo.axis_names[3])]
        groups = [g for g in ({(True, False): topo.model_group,
                               (False, True): topo.expert_group,
                               (True, True): topo.expert_model_group}.get(
                                   tuple(split)),
                              topo.stage_group if split_dim(
                                  spec, topo.axis_names[4]) is not None
                              else None) if g is not None]

        def reduce(x):
            for g in groups:
                x = topo.sum_group(x, g)
            return x
        return reduce

    @staticmethod
    def _sharded_apply(model: Model, topo: Topology) -> Callable:
        """The model's tensor-/sequence-/expert-parallel apply over this
        process's groups; refuses a model without one, and one with
        dropout (the sharded loss threads no dropout key), with the
        reference's messages."""
        m, s = topo.model_parallelism, topo.seq_parallelism
        e = topo.expert_parallelism
        if model.sharded_apply_factory is None:
            raise ValueError(
                f"mesh has seq_parallelism={s} / model_parallelism={m} / "
                f"expert_parallelism={e} but model {model.name!r} supports "
                "none of them (no sharded_apply_factory)")
        if model.dropout_masks is not None:
            raise ValueError(
                f"model {model.name!r} uses dropout, but the sharded "
                "(SP/TP/PP) loss paths do not thread a dropout key; set "
                "model.dropout_rate=0 or run it data-parallel only")
        # the collectives' seconds are waits, counted in topo.comm
        return model.sharded_apply_factory(
            topo.seq_group, topo.model_group, topo.comm,
            topo.expert_group, topo.expert_model_group)

    @staticmethod
    def _pipeline_grads(model: Model, cfg: ExperimentConfig,
                        topo: Topology) -> Callable:
        """The model's pipelined step body over this process's groups
        (≙ the reference's PP branch of ``build_train_step``), with its
        refusals and messages: an unknown schedule, a model without a
        pipeline apply or 1F1B support, dropout."""
        S, mesh = topo.pipeline_parallelism, cfg.mesh
        if mesh.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule "
                             f"{mesh.pipeline_schedule!r}")
        if model.pp_apply_factory is None:
            raise ValueError(f"mesh has pipeline_parallelism={S} but "
                             f"model {model.name!r} has no pipeline apply")
        one_f = mesh.pipeline_schedule == "1f1b"
        if one_f and model.pp_1f1b_grads_factory is None:
            raise ValueError(f"model {model.name!r} has no 1f1b "
                             "pipeline support")
        if model.dropout_masks is not None:
            raise ValueError(
                f"model {model.name!r} uses dropout, but the sharded "
                "(SP/TP/PP) loss paths do not thread a dropout key; set "
                "model.dropout_rate=0 or run it data-parallel only")
        groups = (topo.seq_group, topo.model_group, topo.comm,
                  topo.expert_group, topo.expert_model_group)
        if one_f:
            return model.pp_1f1b_grads_factory(
                topo.stage_group, mesh.pipeline_microbatches,
                mesh.pipeline_chunks, *groups)
        return model.pp_grads_factory(topo.stage_group,
                                      mesh.pipeline_microbatches, *groups)

    # -- the host part ---------------------------------------------------

    def flags_for(self, t_ms: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
        n, mode = self.n, self.mode
        if mode in ("sync", "cdf"):
            return torch.ones(n, dtype=torch.float32)
        if mode == "quorum":
            return policies.quorum_flag(t_ms, disc[DISC_K])
        if mode == "timeout":
            return policies.timeout_flag(t_ms, disc[DISC_TIMEOUT_MS])
        # interval: stale if slower than a whole window
        return policies.timeout_flag(t_ms, disc[DISC_INTERVAL_MS])

    def host_part(self, state: TrainState, measured_ms=None,
                  discipline=None) -> HostStep:
        """This step's host numbers for ``state``, which it does not
        change (:meth:`commit` does)."""
        n = self.n
        disc = (self.default_disc if discipline is None
                else torch.as_tensor(discipline, dtype=torch.float32).cpu())
        meas = (self.zeros_ms if measured_ms is None
                else torch.as_tensor(measured_ms, dtype=torch.float32).cpu())
        if meas.shape != (n,):
            raise ValueError(f"measured_ms must be [{n}], got "
                             f"{tuple(meas.shape)}")
        t_ms = policies.sample_step_time_ms(self.sync, state.root_key,
                                            state.step, meas)
        flags = self.flags_for(t_ms, disc)
        scale, num = masked_psum.contribution_scale(flags)
        lr = self.schedule(state.updates_applied)
        stateless = self.opt.num_slots == 0
        applied = int(float(num) > 0)
        rounds, window = 0.0, None
        if self.mode == "interval":
            # ≙ _interval_apply: join the window, advance the modeled
            # wall clock by the mean replica pace, and on crossing the
            # window apply the window's average and re-arm from now
            r = _F32(_F32(state.window_rounds) + _F32(1.0))
            wall = _F32(_F32(state.wall_ms)
                        + _F32(_f32_sum(t_ms.numpy()) / _F32(n)))
            fire = bool(wall >= _F32(state.next_apply_ms))
            applied, rounds = int(fire), float(r)
            update, lr_update = ("join_fire" if fire else "join"), lr
            window = ((0.0, float(wall), float(_F32(
                wall + _F32(disc[DISC_INTERVAL_MS].item()))))
                      if fire else
                      (float(r), float(wall), state.next_apply_ms))
        elif stateless:
            # lr·0 is exact, so scaling the lr by the applied flag IS
            # the no-op
            update = "zero1" if self.plan is not None else "apply"
            lr_update = float(_F32(lr) * _F32(applied))
        elif applied:
            update, lr_update = ("zero1" if self.plan is not None
                                 else "apply"), lr
        else:
            # moment slots decay even on zero gradients: a true no-op
            # keeps params and slots as they were (ZeRO-1 still reduces
            # the loss and accuracy)
            update = "zero1_reduce" if self.plan is not None else None
            lr_update = lr
        corrections = (self.opt.corrections(float(state.updates_applied + 1))
                       if self.opt.corrections is not None else (1.0, 1.0))
        return HostStep(t_ms=t_ms, flags=flags, scale=scale, num=num, lr=lr,
                        applied=applied, update=update, lr_update=lr_update,
                        corrections=corrections, rounds=rounds,
                        window=window)

    def fill_inputs(self, state: TrainState, hs: HostStep,
                    out: np.ndarray) -> None:
        """Write ``hs`` and the step's keys into a staging buffer."""
        n, L, first = self.n, self.L, self.first
        out[:n] = hs.scale.numpy()
        out[n] = hs.lr_update
        out[n + 1], out[n + 2] = hs.corrections
        out[n + 3] = hs.rounds
        if self.dropout_words:
            out[self.at_keys:self.at_dc] = np.stack([
                prng.replica_keys(state.root_key, "dropout",
                                  state.step * self.accum + idx,
                                  self.n)[first:first + L]
                for idx in range(self.accum)]).reshape(-1)
        if self.dc_words:
            keys = prng.replica_keys(state.root_key, "drop_connect",
                                     state.step, n)
            out[self.at_dc:] = np.stack([
                leaf_keys(keys[first + j], self.n_leaves)
                for j in range(L)]).reshape(-1)

    @staticmethod
    def commit(state: TrainState, hs: HostStep) -> None:
        """Advance ``state``'s host counters past the step."""
        state.updates_applied += hs.applied
        state.step += 1
        if hs.window is not None:
            state.window_rounds, state.wall_ms, state.next_apply_ms = (
                hs.window)

    # -- the device body -------------------------------------------------

    def _scale(self, b: _Binding) -> torch.Tensor:
        return b.inputs[:self.n].float()

    def _lr(self, b: _Binding):
        n = self.n
        return (b.inputs[n].float(),
                (b.inputs[n + 1].float(), b.inputs[n + 2].float()))

    def _forward_params(self, b: _Binding) -> Any:
        """The params the forward sees: logical (gathered under a
        resident plan), cast to ``param_dtype`` over float32 masters."""
        params = logical_params(b.params, self.plan, self.topo)
        if self.fwd_cast:
            params = tree_map(lambda p: p.to(self.param_dtype)
                              if p.is_floating_point() else p, params)
        return params

    def _replica_grads(self, params: Any, xs: torch.Tensor, ys: torch.Tensor,
                       keys: torch.Tensor | None):
        """Forward and backward of every local replica on its rows
        ``xs[j]``, each with its own dropout mask (from ``keys[j]``, replica
        ``first + j``'s key): ``(losses, accs, grads)``, the per-replica
        losses and accuracies ``[L]`` and the float32 gradient leaves,
        each ``[L, ...]`` (a row a replica). Several replicas run as one
        ``torch.func.vmap`` of ``grad`` over the replica axis when the
        model allows it (the transformer's 8-replica step: 81.9–83.4 ms
        against 102.2–110.8 ms looped on an H100 80GB HBM3 at 700 W,
        PERF.md §6); else, and for a lone local replica, each runs
        autograd directly and writes its row."""
        model, L = self.model, self.L
        if self.sharded_apply is not None or self.pp_grads is not None:
            return self._sharded_grads(params, xs, ys)
        keep = None
        if keys is not None:
            keep = model.dropout_masks(keys if L > 1 else keys[0],
                                       xs.shape[1], xs.device)
        if L == 1 or not model.vmap_replicas:
            leaves = tree_leaves(params)
            losses, accs, grads = [], [], None
            for p in leaves:
                p.requires_grad_(True)
            try:
                for j in range(L):
                    loss, logits = self._local_loss(
                        params, xs[j], ys[j],
                        keep if L == 1 or keep is None else keep[j])
                    g = [gi.float() for gi in
                         torch.autograd.grad(loss, leaves)]
                    if L == 1:
                        grads = [gi[None] for gi in g]
                    else:
                        if grads is None:
                            grads = [gi.new_empty((L, *gi.shape))
                                     for gi in g]
                        for row, gi in zip(grads, g):
                            row[j] = gi
                    losses.append(loss.detach())
                    accs.append(model.accuracy(logits.detach(), ys[j]))
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            return torch.stack(losses), torch.stack(accs), grads

        def replica_loss(params, x, y, k):
            loss, logits = self._local_loss(params, x, y, k)
            return loss, (loss, model.accuracy(logits, y))

        grads, (losses, accs) = vmap(
            grad(replica_loss, has_aux=True),
            in_dims=(None, 0, 0, None if keep is None else 0))(
                params, xs, ys, keep)
        return losses, accs, [g.float() for g in tree_leaves(grads)]

    def _local_loss(self, params: Any, x: torch.Tensor, y: torch.Tensor,
                    keep) -> tuple[torch.Tensor, torch.Tensor]:
        """One replica's ``(loss, logits)`` on its rows (≙ the
        reference's ``local_loss``): with an aux loss (MoE) the loss
        adds ``aux_weight · aux``."""
        model = self.model
        if model.has_aux:
            logits, aux = model.apply(params, x, train=True,
                                      dropout_keep=keep, return_aux=True)
            return model.loss(logits, y) + model.aux_weight * aux, logits
        logits = model.apply(params, x, train=True, dropout_keep=keep)
        return model.loss(logits, y), logits

    def _sharded_grads(self, params: Any, xs: torch.Tensor,
                       ys: torch.Tensor):
        """:meth:`_replica_grads` under tensor/sequence/pipeline
        parallelism (≙ the reference's ``make_sp_loss`` and the seq-axis
        psums): each local replica in turn runs the sharded apply on its
        sequence block ``[b, S/s]`` with its global positions; its
        targets are the tokens shifted one global position (the next
        block's first column through a ``ppermute``), its partial loss
        and accuracy normalised by the replica's ``b·(S−1)`` predicted
        tokens, plus ``aux_weight · aux / s`` for an MoE model (the aux
        is the full-token value on every block, so the seq sum counts it
        once) — or, under pipeline parallelism, the model's pipelined
        step body gives the same partials and gradients; then the loss,
        the accuracy and every float32 gradient summed over the seq
        group in one all-reduce. Sharded leaves keep their shard's
        gradient."""
        from ..models.transformer import sp_partial_token_loss
        topo, L = self.topo, self.L
        s = topo.seq_parallelism
        leaves = tree_leaves(params)
        losses, accs, grads = [], [], None
        pp = self.pp_grads is not None
        for p in leaves:
            p.requires_grad_(not pp)
        try:
            for j in range(L):
                tokens, labels = topo.seq_block(xs[j]), topo.seq_block(ys[j])
                b, s_loc = tokens.shape
                positions = topo.seq_positions(s_loc, tokens.device)
                if pp:
                    loss, acc, g = self.pp_grads(params, tokens, labels,
                                                 positions)
                else:
                    aux = 0.0
                    if self.model.has_aux:
                        logits, aux = self.sharded_apply(
                            params, tokens, positions, return_aux=True)
                    else:
                        logits = self.sharded_apply(params, tokens,
                                                    positions)
                    # block j takes block j+1's first target column
                    nxt = ppermute(labels[:, :1].contiguous(), -1,
                                   topo.seq_group, topo.comm)
                    tgt = torch.cat([labels[:, 1:], nxt], dim=1)
                    s_global = s_loc * s
                    loss, acc = sp_partial_token_loss(
                        logits, tgt, positions, s_global,
                        b * (s_global - 1))
                    loss = loss + self.model.aux_weight * aux / s
                    g = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    flat = torch.cat([gi.float().reshape(-1) for gi in g]
                                     + [loss.detach().reshape(1).float(),
                                        acc.reshape(1).float()])
                    topo.sum_seq(flat)
                if grads is None:
                    grads = [gi.new_empty((L, *gi.shape), dtype=torch.float32)
                             for gi in g]
                at = 0
                for row, gi in zip(grads, g):
                    row[j] = flat[at:at + gi.numel()].view(gi.shape)
                    at += gi.numel()
                losses.append(flat[at])
                accs.append(flat[at + 1])
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return torch.stack(losses), torch.stack(accs), grads

    def _dropout_keys(self, b: _Binding) -> torch.Tensor | None:
        if not self.dropout_words:
            return None
        return b.inputs[self.at_keys:self.at_dc].long().view(
            self.accum, self.L, 2)

    def grads_body(self, b: _Binding):
        """The ``grads`` stage: :meth:`_replica_grads` over the step's
        ``accum`` microbatches (each replica's row block split into
        ``accum`` consecutive microbatches, float32 sums over them divided
        by ``accum``), drop-connect, then — without a ZeRO-1 plan — the
        masked mean: each replica scaled by its share, one sum over
        replicas (a lone replica's scaled gradient is the mean). Returns
        ``(mean leaves, loss, accuracy)``, or under a plan the per-replica
        ``(grads, losses, accs)``."""
        topo, L, accum = self.topo, self.L, self.accum
        params = self._forward_params(b)
        xs = topo.split_batch(b.batch["image"])
        ys = topo.split_batch(b.batch["label"])
        keys = self._dropout_keys(b)
        if accum == 1:
            losses, accs, grads = self._replica_grads(
                params, xs, ys, None if keys is None else keys[0])
        else:
            xs = xs.view(L, accum, -1, *xs.shape[2:])
            ys = ys.view(L, accum, -1, *ys.shape[2:])
            losses = accs = grads = None
            for idx in range(accum):
                l, a, g = self._replica_grads(
                    params, xs[:, idx], ys[:, idx],
                    None if keys is None else keys[idx])
                if grads is None:
                    losses, accs, grads = l.float(), a.float(), g
                else:
                    losses, accs = losses + l, accs + a
                    for s, gi in zip(grads, g):
                        s.add_(gi)
            for s in grads:
                s.div_(accum)
            losses, accs = losses / accum, accs / accum
        with torch.no_grad():
            if self.dc_words:
                self._drop_connect(b, grads)
            if self.plan is not None:
                return grads, losses, accs
            scale = self._scale(b)
            if self.bucketed:
                # the loss and accuracy ride the gradients' reduction
                bucket = masked_psum.flatten_replicas(grads, (losses, accs))
                width = bucket.shape[1] - 2
                total = masked_psum.masked_mean(bucket, scale, topo, width)
                mean = masked_psum.unflatten_like(total[:width], b.leaves)
                return (mean, total[width] / self.n,
                        total[width + 1] / self.n)
            # one replica: its scaled gradient is the mean (at scale 1
            # the multiply is exact)
            return ([g[0].mul_(scale[0]) for g in grads], losses[0],
                    accs[0])

    def _drop_connect(self, b: _Binding, grads: list) -> None:
        """Mask each local replica's gradient leaves in place with leaf
        keys of ``replica_key(root, "drop_connect", step, first + j)``."""
        keys = b.inputs[self.at_dc:].long().view(self.L, self.n_leaves, 2)
        for j in range(self.L):
            for g, m in zip(grads, mask_leaves(
                    [g[j] for g in grads], keys[j],
                    self.sync.drop_connect_probability)):
                g[j] = m

    def _apply(self, b: _Binding, grads: list) -> None:
        lr, corrections = self._lr(b)
        for i, (p, g) in enumerate(zip(b.leaves, grads)):
            self.opt.update_leaf(p, g, tuple(s[i] for s in b.slots), lr,
                                 corrections, self.norm_reduce[i],
                                 p.dim() > 1)

    def apply_body(self, b: _Binding, mean: list) -> None:
        """The ``apply`` stage: the optimizer's update of every leaf."""
        with torch.no_grad():
            self._apply(b, mean)

    def join_body(self, b: _Binding, mean: list, fire: bool) -> None:
        """Interval mode's ``join`` stage (add the mean into the window)
        and ``join_fire`` (then apply the window's average and empty
        it)."""
        with torch.no_grad():
            for a, g in zip(b.window, mean):
                a.add_(g)
            if fire:
                rounds = b.inputs[self.n + 3].float()
                self._apply(b, [a / rounds for a in b.window])
                for a in b.window:
                    a.zero_()

    def zero1_body(self, b: _Binding, grads: list, losses: torch.Tensor,
                   accs: torch.Tensor, apply: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """≙ ``_zero1_update`` (the ``zero1`` stage; ``zero1_reduce``
        with ``apply`` False): the fallback leaves and the loss and
        accuracy through the masked-mean all-reduce, the sharded leaves
        through one reduce-scatter a group, their chunks and slots
        updated in place, the params made whole again by one all-gather
        a bucket (none on one process, none under a resident plan).
        Returns the mean loss and accuracy."""
        topo, plan, lps, L, n = self.topo, self.plan, self.lps, self.L, self.n
        all_local, resident = L == plan.n, plan.params_sharded
        opt, fallback = self.opt, self.fallback
        with torch.no_grad():
            scale = self._scale(b)
            bucket = masked_psum.flatten_replicas(
                [grads[i] for i in fallback], (losses, accs))
            width = bucket.shape[1] - 2
            total = masked_psum.masked_mean(bucket, scale, topo, width)
            mean = dict(zip(fallback, masked_psum.unflatten_like(
                total[:width], [grads[i][0] for i in fallback])))
            for group in self.scatter_groups:
                rows = torch.cat([_padded_rows(grads[i], lps[i])
                                  for i in group], dim=2)
                rows.mul_(masked_psum.local_scale(scale, topo, rows))
                out = topo.reduce_scatter_replicas(rows)
                off = 0
                for i in group:
                    mean[i] = out[:, off:off + lps[i].chunk].reshape(-1)
                    off += lps[i].chunk
            if apply:
                lr, corrections = self._lr(b)
                leaves, slots = b.leaves, b.slots
                # a sharded leaf's chunks complete its norms over the
                # replica group (its spec is replicated on every other
                # axis); a fallback leaf's over the groups that split it
                reduce = ((lambda x: x) if all_local
                          else topo.sum_processes)
                updated = {}
                for i, (p, lp) in enumerate(zip(leaves, lps)):
                    sl = tuple(s[i] for s in slots)
                    adapt = len(lp.shape) > 1
                    if not lp.sharded:
                        opt.update_leaf(p, mean[i], sl, lr, corrections,
                                        self.norm_reduce[i], adapt)
                    elif all_local:
                        # every chunk is here: update the logical
                        # elements in place (the padding stays zero)
                        pv = p[:lp.size] if resident else p.view(-1)
                        opt.update_leaf(pv, mean[i][:lp.size],
                                        tuple(s[:lp.size] for s in sl), lr,
                                        corrections, reduce, adapt)
                    else:
                        pl = p if resident else _local_flat(
                            p, lp, *_local_span(lp, topo, n))
                        opt.update_leaf(pl, mean[i], sl, lr, corrections,
                                        reduce, adapt)
                        updated[i] = pl
                if updated and not resident:
                    # the all-gather leg: each bucket's updated chunks
                    # reassemble its leaves whole on every process
                    for group in self.scatter_groups:
                        full = topo.all_gather_replicas(torch.cat(
                            [updated[i].view(L, lps[i].chunk)
                             for i in group], dim=1))
                        off = 0
                        for i in group:
                            lp = lps[i]
                            leaves[i].copy_(full[:, off:off + lp.chunk]
                                            .reshape(-1)[:lp.size]
                                            .view(lp.shape))
                            off += lp.chunk
            return total[width] / n, total[width + 1] / n

    # -- bindings, capture and the call ------------------------------------

    def _bind(self, state: TrainState, batch: dict) -> _Binding:
        b = _Binding(state, batch, self.width,
                     lambda m: optim_lib.slot_trees(self.opt, m))
        if self.mode == "interval" and b.window is None:
            raise ValueError("interval mode needs the state's window_acc")
        held = {}

        def grads():
            out = held["grads"] = self.grads_body(b)
            return out

        b.stages["grads"] = grads
        if self.plan is not None:
            b.stages["zero1"] = lambda: self.zero1_body(
                b, *held["grads"], apply=True)
            b.stages["zero1_reduce"] = lambda: self.zero1_body(
                b, *held["grads"], apply=False)
        elif self.mode == "interval":
            b.stages["join"] = lambda: self.join_body(b, held["grads"][0],
                                                      False)
            b.stages["join_fire"] = lambda: self.join_body(
                b, held["grads"][0], True)
        else:
            b.stages["apply"] = lambda: self.apply_body(b, held["grads"][0])
        return b

    def eager_reason(self) -> str | None:
        """Why this step is not captured on the card, or None: a ZeRO-1
        plan, a process group, ``model.remat``."""
        if self.plan is not None:
            return ("zero1: the sharded update's collectives and views "
                    "run eagerly")
        if self.topo.distributed:
            return ("processes: the step's all-reduce runs through a "
                    "process group, eagerly")
        if self.cfg.model.remat:
            return ("model.remat: torch.utils.checkpoint's recompute runs "
                    "eagerly")
        return None

    def prepare(self, state: TrainState, batch: dict,
                cache_dir=None) -> dict:
        """Bind the device body to ``state`` (the Trainer's, which later
        calls pass back) and ``batch``'s shapes, and on the card capture
        its stages as CUDA graphs (:func:`.graphs.aot_compile`; the
        warm-up leaves ``state`` as it was). Returns the capture's info
        (``source`` ``"eager"`` with a ``reason`` where nothing is
        captured: off the card, and :meth:`eager_reason`); a failed
        capture raises and leaves the step eager."""
        from .graphs import aot_compile
        self._prepared = None
        b = self._bind(state, batch)
        with cudnn_policy(self.cudnn_deterministic, self.tf32):
            b.stage(lambda out: self.fill_inputs(
                state, self.host_part(state), out), batch)

            def snapshot():
                saved = [(t, t.clone()) for t in _state_tensors(state)]

                def restore():
                    for t, c in saved:
                        t.copy_(c)
                return restore

            replay, info = aot_compile(
                b.stages, b.device, eager_reason=self.eager_reason(),
                snapshot=snapshot, cache_dir=cache_dir)
        b.replay = replay
        self._prepared = b
        return info

    @property
    def captured(self) -> bool:
        """Whether the prepared state's stages replay CUDA graphs."""
        return self._prepared is not None and self._prepared.replay is not None

    def _binding_for(self, state: TrainState, batch: dict) -> _Binding:
        p = self._prepared
        if p is not None and p.state is state:
            if not p.holds(state, batch):
                raise RuntimeError(
                    "the prepared state's tensors or the batch shapes "
                    "changed after prepare(): restore into the tensors in "
                    "place (load_state_into), or prepare again")
            return p
        s = self._scratch
        if s is None or not s.holds(state, batch):
            s = self._scratch = self._bind(state, batch)
        return s

    def stage(self, state: TrainState, batch: dict, hs: HostStep) -> None:
        """Fill the prepared state's buffers for one step: ``hs`` and the
        step's keys (one host-to-device copy) and ``batch``."""
        b = self._binding_for(state, batch)
        b.stage(lambda out: self.fill_inputs(state, hs, out), batch)

    def replay(self, update: str | None) -> tuple[torch.Tensor, torch.Tensor]:
        """Run the prepared state's stages on what its buffers hold — the
        ``grads`` stage, then ``update`` (None: none) — replaying their
        graphs where captured, calling the bodies with no arguments
        otherwise; nothing of the host's state is read. Returns this
        step's loss and accuracy (copies: a replay overwrites its
        outputs)."""
        return self._run(self._prepared, update)

    def _run(self, b: _Binding, update: str | None):
        out = b.run("grads")
        upd = b.run(update) if update is not None else None
        loss, acc = upd if self.plan is not None else out[1:]
        return loss.clone(), acc.clone()

    def __call__(self, state: TrainState, batch: dict, measured_ms=None,
                 discipline=None) -> tuple[TrainState, dict]:
        """``step_fn(state, batch, measured_ms=None, discipline=None) ->
        (state, metrics)``; see :func:`build_train_step`."""
        b = self._binding_for(state, batch)
        with cudnn_policy(self.cudnn_deterministic, self.tf32):
            hs = self.host_part(state, measured_ms, discipline)
            b.stage(lambda out: self.fill_inputs(state, hs, out), batch)
            loss, acc = self._run(b, hs.update)
        self.commit(state, hs)
        return state, {"loss": loss, "train_acc": acc, "lr": hs.lr,
                       "num_contributors": float(hs.num),
                       "updates_applied": state.updates_applied,
                       "step_times_ms": hs.t_ms.numpy(),
                       "flags": hs.flags.numpy(), "applied": hs.applied}


def _state_tensors(state: TrainState) -> list:
    """Every tensor of ``state`` a step updates: params, slots, window."""
    return (tree_leaves(state.params) + tree_leaves(state.momentum)
            + tree_leaves(state.window_acc))


def load_state_into(dst: TrainState, src: TrainState) -> None:
    """Copy ``src``'s tensors into ``dst``'s in place (a captured step
    keeps updating ``dst``'s) and take its host fields."""
    a, b = _state_tensors(dst), _state_tensors(src)
    if len(a) != len(b) or any(x.shape != y.shape or x.dtype != y.dtype
                               for x, y in zip(a, b)):
        raise ValueError("restored state does not match the live state's "
                         "tensors")
    with torch.no_grad():
        for x, y in zip(a, b):
            x.copy_(y)
    for f in ("step", "updates_applied", "window_rounds", "wall_ms",
              "next_apply_ms"):
        setattr(dst, f, getattr(src, f))
    dst.root_key = np.array(src.root_key)


def build_train_step(model: Model, cfg: ExperimentConfig, schedule: Schedule,
                     topo: Topology | None = None, *,
                     cudnn_deterministic: bool = True) -> TrainStep:
    """``step_fn(state, batch, measured_ms=None, discipline=None) ->
    (state, metrics)`` (a :class:`TrainStep`). ``batch = {"image",
    "label"}`` is this process's batch on the state's device (the global
    batch with one process; ``grad_accum_steps`` of them concatenated
    under accumulation); local replica j takes rows ``[j·B/L,
    (j+1)·B/L)`` of it. ``measured_ms`` is the ``[n]`` host-measured
    base of the modeled step times (zeros when None); ``discipline`` the
    ``[3]`` vector of :func:`make_discipline_vector` (the config's values
    when None). The state must be in the layout :func:`init_train_state`
    gives for ``topo``; it is updated IN PLACE (params, slots, window)
    and returned. Each call runs under :func:`..core.device.cudnn_policy`:
    cuDNN's deterministic algorithms unless ``cudnn_deterministic`` is
    False, and no TF32 rounding when the model computes in float32.

    Metrics carry the reference's keys: ``loss`` and ``train_acc`` (the
    mean over all replicas) are 0-d device tensors — reading them waits
    for the step; ``lr``, ``num_contributors``, ``updates_applied`` and
    ``applied`` are host numbers; ``step_times_ms`` (the modeled times)
    and ``flags`` are ``[n]`` float32 numpy arrays."""
    return TrainStep(model, cfg, schedule, topo,
                     cudnn_deterministic=cudnn_deterministic)


def build_eval_step(model: Model, cfg: ExperimentConfig,
                    topo: Topology | None = None, *,
                    cudnn_deterministic: bool = True) -> Callable:
    """``eval_fn(params, batch) -> (correct_sum, loss_sum, weight_sum)``
    over ``batch = {"image", "label", "weight"}`` (padded rows carry
    weight 0); no autograd, so attention runs the forward kernel K1.
    ``params`` are logical-shape (:func:`logical_params`), or under
    tensor, expert or pipeline parallelism (``topo`` with
    ``model_parallelism``, ``expert_parallelism`` or
    ``pipeline_parallelism > 1``) this rank's shard, run through the
    model's sharded apply over the whole sequence (eval batches are not
    split along it; ≙ the reference's ``build_eval_step``) — under a
    stage axis its pipelined forward, at the largest microbatch count up
    to ``mesh.pipeline_microbatches`` that divides the batch's rows (the
    reference's ``m_eval``), the logits on every stage. cuDNN runs
    under the train step's policy."""
    if model.eval_metrics is None:
        raise ValueError(f"model {model.name!r} has no eval_metrics")
    tf32 = False if model.compute_dtype == torch.float32 else None
    apply = model.apply
    if topo is not None and topo.pipeline_parallelism > 1:
        S, mesh = topo.pipeline_parallelism, cfg.mesh
        if model.pp_apply_factory is None:
            raise ValueError(f"mesh has pipeline_parallelism={S} but "
                             f"model {model.name!r} has no pipeline apply")
        one_f = mesh.pipeline_schedule == "1f1b"
        if one_f and model.pp_1f1b_apply_factory is None:
            raise ValueError(f"model {model.name!r} has no 1f1b "
                             "pipeline support")
        cap = max(1, mesh.pipeline_microbatches)
        groups = (topo.model_group, topo.comm, topo.expert_group,
                  topo.expert_model_group)
        applies: dict = {}

        def apply(params, images):
            b = images.shape[0]
            m_eval = max(m for m in range(1, cap + 1) if b % m == 0)
            if m_eval not in applies:
                applies[m_eval] = (
                    model.pp_1f1b_apply_factory(
                        topo.stage_group, m_eval, mesh.pipeline_chunks,
                        *groups) if one_f else
                    model.pp_apply_factory(topo.stage_group, m_eval,
                                           *groups))
            return applies[m_eval](params, images)
    elif topo is not None and (topo.model_parallelism > 1
                               or topo.expert_parallelism > 1):
        if model.sharded_apply_factory is None:
            raise ValueError(
                f"mesh has model_parallelism={topo.model_parallelism} / "
                f"expert_parallelism={topo.expert_parallelism} but model "
                f"{model.name!r} is not tensor-/expert-parallel capable")
        tp_apply = model.sharded_apply_factory(
            None, topo.model_group, topo.comm, topo.expert_group,
            topo.expert_model_group)

        def apply(params, images):
            return tp_apply(params, images, None)

    @torch.no_grad()
    def eval_fn(params, batch):
        with cudnn_policy(cudnn_deterministic, tf32):
            logits = apply(params, batch["image"])
            return model.eval_metrics(logits, batch["label"],
                                      batch["weight"])

    return eval_fn
