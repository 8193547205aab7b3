"""Shared drivers of the data-parallel step for the port's parity tests:
the reference's step on the conftest's 8-device mesh and the port's on
8 simulated replicas, both fed the same numpy batches of the MNIST CNN
at 12x12 (its layers and widths; 12x12 keeps fc1 at 576 inputs) in
float32 with dropout off, plus the two-process gloo children's launcher
(``test_torch_distributed``'s) for the port's runs over processes."""

import copy

import jax
import numpy as np
import torch

from conftest import base_config
from distributedmnist_tpu.data.datasets import make_synthetic
from distributedmnist_tpu.data.pipeline import BatchIterator
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models.convert import params_to_reference
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule

N = 8
SIZE = 12
BATCH = 64
TRAIN = 512
LR = 0.05


def cfg_dict(**over) -> dict:
    """The CNN at 12x12, float32, dropout off, 8 replicas, constant lr;
    ``over`` merges into the sections."""
    d = {"data": {"dataset": "synthetic", "batch_size": BATCH,
                  "synthetic_train_size": TRAIN, "synthetic_test_size": 64,
                  "use_native_pipeline": False},
         "model": {"compute_dtype": "float32", "image_size": SIZE,
                   "dropout_rate": 0.0},
         "mesh": {"num_replicas": N},
         "optim": {"initial_learning_rate": LR,
                   "learning_rate_decay_factor": 1.0},
         "train": {"max_steps": 4, "log_every_steps": 1,
                   "save_interval_steps": 0, "save_results_period": 0}}
    d = copy.deepcopy(d)
    for sec, vals in over.items():
        if isinstance(vals, dict):
            d[sec] = {**d.get(sec, {}), **vals}
        else:
            d[sec] = vals
    return d


def batches(steps: int, batch: int = BATCH, seed: int = 0) -> list[dict]:
    data = make_synthetic(num_train=TRAIN, num_test=64, image_size=SIZE)
    it = BatchIterator(data.train, batch, seed=seed)
    return [next(it) for _ in range(steps)]


def port_steps(d: dict, feed: list[dict], topo=None):
    """The port's step over ``feed`` from a fresh state: (state,
    metrics, step_fn)."""
    cfg = ExperimentConfig.from_dict(d)
    model = get_model(cfg.model)
    topo = topo or make_topology(cfg.mesh)
    state = api.init_train_state(model, cfg, torch.device("cpu"), topo)
    step_fn = api.build_train_step(
        model, cfg, lr_schedule.constant(cfg.optim.initial_learning_rate),
        topo)
    hist = []
    for b in feed:
        state, m = step_fn(state, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in b.items()})
        hist.append(m)
    return state, hist, step_fn


def ref_steps(topo8, d: dict, feed: list[dict]):
    """The reference's step over ``feed`` on the 8-device mesh: (state
    on the host, metrics, the config)."""
    d = {k: v for k, v in d.items() if k != "mesh"}
    cfg = base_config(**copy.deepcopy(d))
    model = ref_get_model(cfg.model)
    state = topo8.device_put_state(
        ref_api.init_train_state(model, cfg, topo8),
        ref_api.state_partition_specs(model, cfg, topo8))
    step_fn = ref_api.build_train_step(
        model, cfg, topo8, ref_constant(cfg.optim.initial_learning_rate))
    hist = []
    for b in feed:
        state, m = step_fn(state, topo8.device_put_batch(b))
        hist.append(jax.device_get(m))
    return jax.device_get(state), hist, cfg


def leaves_np(tree) -> list[np.ndarray]:
    """A port tree's leaves as numpy (``jax.tree.leaves`` order; none
    for None)."""
    if tree is None:
        return []
    return [np.asarray(x) for x in api.tree_leaves(params_to_reference(tree))]


def canonical(state, plan):
    """The port state's (params, slots) in logical shapes as numpy."""
    c = api.canonical_save_state(state, plan)
    return leaves_np(c.params), leaves_np(c.momentum)


def within_norm(got, want, tol: float) -> float:
    """Each leaf of ``got`` within ``tol`` of its ``want`` leaf's norm;
    returns the largest ratio."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        r = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert r <= tol, (r, tol)
        worst = max(worst, r)
    return worst
