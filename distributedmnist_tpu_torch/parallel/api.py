"""The train and eval steps (≙ ``distributedmnist_tpu/parallel/api.py``)
for one device in ``sync`` mode.

The reference's step is one SPMD program over a replica mesh: each
replica differentiates its local loss, a masked-mean psum aggregates
what the sync discipline admits, and every replica applies the same
update. On one device with ``sync.mode="sync"`` the mask is 1, the
mean over one replica is that replica's gradient, and the step reduces
to: forward and backward under autograd (the attention through the
flash kernels' ``torch.autograd.Function``), then the optimizer's
per-leaf float32 update. The metrics keep the reference's keys.

Not ported yet (each raises): the quorum/timeout/interval/cdf modes,
more than one replica, drop-connect, gradient accumulation, low-
precision params, ZeRO-1 and the tensor/sequence/pipeline/expert
parallel applies.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core.config import ExperimentConfig
from ..core.log import get_logger
from ..models.registry import Model
from ..train import optim as optim_lib

logger = get_logger("parallel")

Schedule = Callable[[int], float]


def tree_leaves(tree: Any) -> list:
    """Leaves of a nest of dicts and lists, in a fixed order (dict
    insertion order, list order); ``None`` has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
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


def root_key(seed: int) -> np.ndarray:
    """The raw ``uint32[2]`` key ``jax.random.PRNGKey(seed)`` builds
    (threefry: high word, low word of the seed) — kept so a checkpoint
    carries the reference's ``root_key`` leaf. Nothing in the sync step
    draws from it."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class TrainState:
    """Training state, with the reference's field names (so a
    checkpoint's state dict is the reference's).

    ``params`` and ``momentum`` are trees of tensors on the device
    (``momentum`` is None for stateless sgd); ``step`` counts loop
    iterations and ``updates_applied`` applied updates (equal in sync
    mode). The interval-mode fields keep the values the reference
    stores outside interval mode."""

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
    """Raise for what the single-device sync port does not run."""
    sync, mesh = cfg.sync, cfg.mesh
    if sync.mode != "sync":
        raise NotImplementedError(f"sync.mode={sync.mode!r} is not ported "
                                  "yet (the port runs 'sync')")
    if mesh.num_replicas not in (-1, 1):
        raise NotImplementedError(
            f"mesh.num_replicas={mesh.num_replicas}: more than one replica "
            "is not ported yet (the port trains on one device)")
    for name in ("model_parallelism", "seq_parallelism",
                 "pipeline_parallelism", "expert_parallelism"):
        if getattr(mesh, name) != 1:
            raise NotImplementedError(f"mesh.{name} > 1 is not ported yet")
    if sync.drop_connect:
        raise NotImplementedError("sync.drop_connect is not ported yet")
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
    """Fresh float32 params from ``model.init_seed`` (a torch generator:
    other numbers than the reference's JAX key) and zero slots."""
    opt = optim_lib.make_optimizer(cfg.optim)
    gen = torch.Generator(device=device).manual_seed(cfg.model.init_seed)
    params = model.init(gen)
    momentum = (tree_map(torch.zeros_like, params) if opt.num_slots
                else None)
    return TrainState(params=params, momentum=momentum, step=0,
                      updates_applied=0, root_key=root_key(cfg.train.seed),
                      next_apply_ms=float(np.float32(cfg.sync.interval_ms)))


def world_signature() -> dict:
    """The world a checkpoint is saved under (≙ the reference's
    ``world_signature`` of a one-replica, one-process mesh)."""
    return {"num_replicas": 1, "process_count": 1, "mesh": {}}


# -- the steps -------------------------------------------------------------

def build_train_step(model: Model, cfg: ExperimentConfig,
                     schedule: Schedule
                     ) -> Callable[[TrainState, dict],
                                   tuple[TrainState, dict]]:
    """``step_fn(state, batch) -> (state, metrics)`` for one device in
    sync mode. ``batch = {"image": tokens [B, S], "label": [B, S]}`` on
    the state's device. The state is updated IN PLACE (params and
    slots) and returned.

    Metrics carry the reference's keys. ``loss`` and ``train_acc`` are
    0-d device tensors (reading them waits for the step);
    ``step_times_ms`` is this step's measured host time — the reference
    reports a modeled time there, whose sub-µs tie-break jitter only
    quorum ranking uses; ``flags`` is the one replica's 1."""
    _check_ported(cfg)
    if cfg.parallel.shard_weight_update:
        logger.warning("parallel.shard_weight_update=true is a no-op here "
                       "(replica axis is 1); running the replicated update")
    if model.loss is None or model.accuracy is None:
        raise ValueError(f"model {model.name!r} has no loss/accuracy")
    opt = optim_lib.make_optimizer(cfg.optim)

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        t0 = time.perf_counter()
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            logits = model.apply(state.params, batch["image"], train=True)
            loss = model.loss(logits, batch["label"])
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        lr = schedule(state.updates_applied)
        with torch.no_grad():
            train_acc = model.accuracy(logits.detach(), batch["label"])
            slots = (tree_leaves(state.momentum) if opt.num_slots
                     else [None] * len(leaves))
            for p, g, b in zip(leaves, grads, slots):
                opt.update_leaf(p, g, () if b is None else (b,), lr)
        state.step += 1
        state.updates_applied += 1
        metrics = {
            "loss": loss.detach(), "train_acc": train_acc, "lr": lr,
            "num_contributors": 1.0,
            "updates_applied": state.updates_applied,
            "step_times_ms": [(time.perf_counter() - t0) * 1e3],
            "flags": [1.0], "applied": 1,
        }
        return state, metrics

    return step_fn


def build_eval_step(model: Model, cfg: ExperimentConfig) -> Callable:
    """``eval_fn(params, batch) -> (correct_sum, loss_sum, weight_sum)``
    over ``batch = {"image", "label", "weight"}`` (padded rows carry
    weight 0); no autograd, so attention runs the forward kernel K1."""
    del cfg
    if model.eval_metrics is None:
        raise ValueError(f"model {model.name!r} has no eval_metrics")

    @torch.no_grad()
    def eval_fn(params, batch):
        logits = model.apply(params, batch["image"])
        return model.eval_metrics(logits, batch["label"], batch["weight"])

    return eval_fn
