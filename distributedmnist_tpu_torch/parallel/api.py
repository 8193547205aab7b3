"""The train and eval steps (≙ ``distributedmnist_tpu/parallel/api.py``)
for ``n`` data-parallel replicas in every ``sync.mode``.

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
  ``grad`` — and its gradient leaves, loss and accuracy are flattened
  into one bucket row;
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

The ``[3]`` discipline vector ``(k, timeout_ms, interval_ms)`` and the
``[n]`` measured base times are step inputs, read every call, so either
can change between steps with no rebuild. Metrics keep the reference's
keys and shapes.

Not ported yet (each raises): gradient accumulation, low-precision
params, ZeRO-1, remat, and the tensor/sequence/pipeline/expert
parallel applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, vmap

from ..core import prng
from ..core.config import ExperimentConfig
from ..core.device import cudnn_policy
from ..core.log import get_logger
from ..core.mesh import Topology, make_topology
from ..models.registry import Model
from ..ops import masked_psum
from ..ops.drop_connect import drop_connect_grads
from ..train import optim as optim_lib
from . import policies

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


def tree_leaves(tree: Any) -> list:
    """Leaves of a nest of dicts and lists in ``jax.tree.leaves`` order
    (dict keys sorted, list order); ``None`` has none. Per-leaf draws
    (drop-connect's ``split(key, n_leaves)``) follow this order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@dataclasses.dataclass
class TrainState:
    """Training state, with the reference's field names (so a
    checkpoint's state dict is the reference's).

    ``params`` and ``momentum`` are trees of tensors on the device
    (``momentum`` is None for stateless sgd), the same for every
    replica; ``step`` counts loop iterations and ``updates_applied``
    applied updates (the reference's global_step; they differ when a
    step is masked out or an interval window has not fired). Interval
    mode keeps its float32 window accumulator (``window_acc``, a
    params-shaped tree, None in the other modes), the rounds in it, the
    modeled wall clock and the next firing time; the clock fields are
    Python floats holding float32 values."""

    params: Any
    momentum: Any
    step: int
    updates_applied: int
    root_key: np.ndarray
    window_acc: Any = None
    window_rounds: float = 0.0
    wall_ms: float = 0.0
    next_apply_ms: float = 1000.0


def _check_ported(cfg: ExperimentConfig) -> None:
    """Raise for what the port does not run."""
    for name in ("model_parallelism", "seq_parallelism",
                 "pipeline_parallelism", "expert_parallelism"):
        if getattr(cfg.mesh, name) != 1:
            raise NotImplementedError(f"mesh.{name} > 1 is not ported yet")
    if cfg.train.grad_accum_steps != 1:
        raise NotImplementedError("train.grad_accum_steps > 1 is not "
                                  "ported yet")
    if cfg.precision.param_dtype != "float32":
        raise NotImplementedError(
            f"precision.param_dtype={cfg.precision.param_dtype!r} is not "
            "ported yet (params are float32)")
    if cfg.model.remat:
        raise NotImplementedError("model.remat is not ported yet")


def init_train_state(model: Model, cfg: ExperimentConfig,
                     device: torch.device) -> TrainState:
    """Fresh float32 params from ``model.init_seed`` (the CNN: the
    reference's key; the transformer: a torch generator, other numbers
    than the reference's), zero slots, and interval mode's zero
    window."""
    opt = optim_lib.make_optimizer(cfg.optim)
    params = model.init_params(cfg.model.init_seed, device)
    zeros = lambda: tree_map(torch.zeros_like, params)
    return TrainState(
        params=params, momentum=zeros() if opt.num_slots else None,
        step=0, updates_applied=0, root_key=prng.root_key(cfg.train.seed),
        window_acc=zeros() if cfg.sync.mode == "interval" else None,
        next_apply_ms=float(_F32(cfg.sync.interval_ms)))


def world_signature(topo: Topology) -> dict:
    """The world a checkpoint is saved under (≙ the reference's
    ``world_signature``: only axes > 1 enter the mesh record)."""
    n = int(topo.num_replicas)
    return {"num_replicas": n, "process_count": int(topo.process_count),
            "mesh": {"replica": n} if n > 1 else {}}


# -- the steps -------------------------------------------------------------

def _f32_sum(values) -> _F32:
    """Left-to-right float32 sum (the order of an all-reduce over
    replicas 0..n-1)."""
    acc = _F32(0.0)
    for v in values:
        acc = _F32(acc + _F32(v))
    return acc


def build_train_step(model: Model, cfg: ExperimentConfig, schedule: Schedule,
                     topo: Topology | None = None, *,
                     cudnn_deterministic: bool = True
                     ) -> Callable[..., tuple[TrainState, dict]]:
    """``step_fn(state, batch, measured_ms=None, discipline=None) ->
    (state, metrics)``. ``batch = {"image", "label"}`` is this process's
    batch on the state's device (the global batch with one process);
    local replica j takes rows ``[j·B/n, (j+1)·B/n)`` of it.
    ``measured_ms`` is the ``[n]`` host-measured base of
    the modeled step times (zeros when None); ``discipline`` the ``[3]``
    vector of :func:`make_discipline_vector` (the config's values when
    None). The state is updated IN PLACE (params, slots, window) and
    returned. Each call runs under :func:`..core.device.cudnn_policy`:
    cuDNN's deterministic algorithms unless ``cudnn_deterministic`` is
    False, and no TF32 rounding when the model computes in float32.

    Metrics carry the reference's keys: ``loss`` and ``train_acc`` (the
    mean over all replicas) are 0-d device tensors — reading them waits for
    the step; ``lr``, ``num_contributors``, ``updates_applied`` and
    ``applied`` are host numbers; ``step_times_ms`` (the modeled times)
    and ``flags`` are ``[n]`` float32 numpy arrays."""
    _check_ported(cfg)
    topo = topo or make_topology(cfg.mesh)
    n, L, first = (topo.num_replicas, topo.local_replica_count,
                   topo.first_replica)
    # one bucket and one sum over replicas whenever there is more than
    # one replica or a process group to reduce over
    bucketed = n > 1 or topo.distributed
    sync = cfg.sync
    sync.validate(num_replicas=n)
    mode = sync.mode
    if mode not in ("sync", "quorum", "timeout", "interval", "cdf"):
        raise ValueError(f"unknown sync mode {mode!r}")
    k = policies.resolve_aggregate_k(sync, n)
    if cfg.parallel.shard_weight_update:
        logger.warning("parallel.shard_weight_update=true is a no-op here "
                       "(ZeRO-1 is not ported); running the replicated "
                       "update")
    if model.loss is None or model.accuracy is None:
        raise ValueError(f"model {model.name!r} has no loss/accuracy")
    if L > 1 and not model.vmap_replicas:
        raise NotImplementedError(
            f"{n} replicas of model {model.name!r} are not ported yet (its "
            "apply cannot be vmapped over replicas)")
    opt = optim_lib.make_optimizer(cfg.optim)
    default_disc = make_discipline_vector(k, sync.timeout_ms,
                                          sync.interval_ms)
    tf32 = False if model.compute_dtype == torch.float32 else None
    zeros_ms = torch.zeros(n, dtype=torch.float32)

    def flags_for(t_ms: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
        if mode in ("sync", "cdf"):
            return torch.ones(n, dtype=torch.float32)
        if mode == "quorum":
            return policies.quorum_flag(t_ms, disc[DISC_K])
        if mode == "timeout":
            return policies.timeout_flag(t_ms, disc[DISC_TIMEOUT_MS])
        # interval: stale if slower than a whole window
        return policies.timeout_flag(t_ms, disc[DISC_INTERVAL_MS])

    def replica_grads(state: TrainState, batch: dict, leaves: list):
        """Forward and backward of every local replica, each on its row
        block with its own dropout mask (replica ``first + j`` draws
        ``replica_keys(...)[first + j]``): ``(losses, accs, grads)``,
        the per-replica losses and accuracies ``[L]`` and the gradient
        leaves, each ``[L, ...]`` (a row a replica). Several replicas run
        as one ``torch.func.vmap`` of ``grad`` over the replica axis
        (3.2× the speed of a loop over replicas at 8 × 128 CNN rows on
        an H100, PERF.md); a lone local replica runs autograd directly,
        as the flash-attention ``autograd.Function`` needs."""
        xs, ys = topo.split_batch(batch["image"]), topo.split_batch(
            batch["label"])
        keep = None
        if model.dropout_masks is not None:
            keys = prng.replica_keys(state.root_key, "dropout", state.step,
                                     n)[first:first + L]
            keep = model.dropout_masks(keys if L > 1 else keys[0],
                                       xs.shape[1], xs.device)
        if L == 1:
            for p in leaves:
                p.requires_grad_(True)
            try:
                logits = model.apply(state.params, xs[0], train=True,
                                     dropout_keep=keep)
                loss = model.loss(logits, ys[0])
                grads = [g.float()[None] for g in
                         torch.autograd.grad(loss, leaves)]
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            return (loss.detach()[None],
                    model.accuracy(logits.detach(), ys[0])[None], grads)

        def replica_loss(params, x, y, k):
            logits = model.apply(params, x, train=True, dropout_keep=k)
            loss = model.loss(logits, y)
            return loss, (loss, model.accuracy(logits, y))

        grads, (losses, accs) = vmap(
            grad(replica_loss, has_aux=True),
            in_dims=(None, 0, 0, None if keep is None else 0))(
                state.params, xs, ys, keep)
        return losses, accs, [g.float() for g in tree_leaves(grads)]

    def drop_connect(state: TrainState, grads: list) -> None:
        """Mask each local replica's gradient leaves in place with its
        ``replica_key(root, "drop_connect", step, first + j)``."""
        keys = prng.replica_keys(state.root_key, "drop_connect", state.step,
                                 n)
        for j in range(L):
            for g, m in zip(grads, drop_connect_grads(
                    [g[j] for g in grads], keys[first + j],
                    sync.drop_connect_probability)):
                g[j] = m

    def apply_update(state: TrainState, leaves: list, grads: list,
                     lr: float) -> None:
        t = float(state.updates_applied + 1)
        slots = (tree_leaves(state.momentum) if opt.num_slots
                 else [None] * len(leaves))
        for p, g, b in zip(leaves, grads, slots):
            opt.update_leaf(p, g, () if b is None else (b,), lr, t,
                            lambda x: x, p.dim() > 1)

    def interval_apply(state: TrainState, leaves: list, mean: list,
                       t_ms: np.ndarray, interval_ms: _F32,
                       lr: float) -> int:
        """≙ ``_interval_apply``: join the window, advance the modeled
        wall clock by the mean replica pace, and on crossing the window
        apply the window's average and re-arm relative to now."""
        acc = tree_leaves(state.window_acc)
        for a, g in zip(acc, mean):
            a.add_(g)
        rounds = _F32(_F32(state.window_rounds) + _F32(1.0))
        wall = _F32(_F32(state.wall_ms) + _F32(_f32_sum(t_ms) / _F32(n)))
        fire = bool(wall >= _F32(state.next_apply_ms))
        if fire:
            apply_update(state, leaves, [a / rounds for a in acc], lr)
            for a in acc:
                a.zero_()
            state.next_apply_ms = float(_F32(wall + interval_ms))
            rounds = _F32(0.0)
        state.window_rounds = float(rounds)
        state.wall_ms = float(wall)
        return int(fire)

    def step_fn(state: TrainState, batch: dict,
                measured_ms=None, discipline=None
                ) -> tuple[TrainState, dict]:
        with cudnn_policy(cudnn_deterministic, tf32):
            return step(state, batch, measured_ms, discipline)

    def step(state: TrainState, batch: dict, measured_ms, discipline
             ) -> tuple[TrainState, dict]:
        disc = (default_disc if discipline is None
                else torch.as_tensor(discipline, dtype=torch.float32).cpu())
        meas = (zeros_ms if measured_ms is None
                else torch.as_tensor(measured_ms, dtype=torch.float32).cpu())
        if meas.shape != (n,):
            raise ValueError(f"measured_ms must be [{n}], got "
                             f"{tuple(meas.shape)}")
        # -- per-replica gradients (queued on the device first) ---------
        leaves = tree_leaves(state.params)
        losses, accs, grads = replica_grads(state, batch, leaves)
        with torch.no_grad():
            if sync.drop_connect:
                drop_connect(state, grads)
            if bucketed:
                # the loss and accuracy ride the gradients' reduction
                bucket = masked_psum.flatten_replicas(grads, (losses, accs))
        # -- modeled times and flags, on the host while the device runs
        # the backward (they need no gradient) --------------------------
        t_ms = policies.sample_step_time_ms(sync, state.root_key,
                                            state.step, meas)
        flags = flags_for(t_ms, disc)
        scale, num = masked_psum.contribution_scale(flags)
        # -- the masked mean: each replica scaled by its share, one sum
        # over replicas (a lone replica's scaled gradient is the sum, and
        # at scale 1 the gradient itself, with no copy) ------------------
        lr = schedule(state.updates_applied)
        with torch.no_grad():
            if bucketed:
                width = bucket.shape[1] - 2
                total = masked_psum.masked_mean(bucket, scale.numpy(), topo,
                                                width)
                mean = masked_psum.unflatten_like(total[:width], leaves)
                loss, train_acc = total[width] / n, total[width + 1] / n
            else:
                s = float(scale[0])
                mean = [g[0] if s == 1.0 else g[0] * s for g in grads]
                loss, train_acc = losses[0], accs[0]
            if mode == "interval":
                applied = interval_apply(
                    state, leaves, mean, t_ms.numpy(),
                    _F32(disc[DISC_INTERVAL_MS].item()), lr)
            else:
                applied = int(float(num) > 0)
                if opt.num_slots == 0:
                    # stateless sgd: lr·0 is exact, so scaling the lr
                    # by the applied flag IS the no-op
                    apply_update(state, leaves, mean,
                                 float(_F32(lr) * _F32(applied)))
                elif applied:
                    # moment slots decay even on zero gradients: a true
                    # no-op keeps params and slots as they were
                    apply_update(state, leaves, mean, lr)
        state.updates_applied += applied
        state.step += 1
        metrics = {
            "loss": loss, "train_acc": train_acc, "lr": lr,
            "num_contributors": float(num),
            "updates_applied": state.updates_applied,
            "step_times_ms": t_ms.numpy(),
            "flags": flags.numpy(),
            "applied": applied,
        }
        return state, metrics

    return step_fn


def build_eval_step(model: Model, cfg: ExperimentConfig, *,
                    cudnn_deterministic: bool = True) -> Callable:
    """``eval_fn(params, batch) -> (correct_sum, loss_sum, weight_sum)``
    over ``batch = {"image", "label", "weight"}`` (padded rows carry
    weight 0); no autograd, so attention runs the forward kernel K1.
    cuDNN runs under the train step's policy."""
    del cfg
    if model.eval_metrics is None:
        raise ValueError(f"model {model.name!r} has no eval_metrics")
    tf32 = False if model.compute_dtype == torch.float32 else None

    @torch.no_grad()
    def eval_fn(params, batch):
        with cudnn_policy(cudnn_deterministic, tf32):
            logits = model.apply(params, batch["image"])
            return model.eval_metrics(logits, batch["label"],
                                      batch["weight"])

    return eval_fn
