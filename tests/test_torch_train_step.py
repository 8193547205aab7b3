"""Port parity: the train step (``distributedmnist_tpu_torch/parallel/
api.py build_train_step``), its loss, accuracy, optimizers and
schedules against the reference's, on the CPU in float32.

The reference runs its sync-mode SPMD step on a one-replica mesh, its
flash attention through the Pallas kernels in interpret mode; the port
runs eagerly with the attention's plain versions. Both start from the
same params (the reference's init, converted) and eat the same numpy
batches. Tolerances: loss rtol 1e-5; params atol 2e-6 / rtol 1e-5 —
float32 summation-order differences between the blocked online softmax
and the dense one, carried through three small updates.
"""

import jax
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core import config as ref_config
from distributedmnist_tpu.core.mesh import make_topology
from distributedmnist_tpu.models import transformer as ref_tf
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train import lr_schedule as ref_lr
from distributedmnist_tpu_torch.core import config as port_config
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.convert import (params_to_reference,
                                                       state_from_reference,
                                                       state_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule, optim

from _torch_threads import one_torch_thread  # noqa: F401

RUN = {"model": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                 "num_heads": 2, "num_layers": 2, "vocab_size": 16,
                 "compute_dtype": "float32", "attention_impl": "flash"},
       "data": {"dataset": "synthetic_lm", "batch_size": 8},
       "mesh": {"num_replicas": 1},
       "optim": {"initial_learning_rate": 0.05,
                 "learning_rate_decay_factor": 1.0}}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 16, (n, 8, 16)).astype(np.int32)
    return [{"image": t, "label": t.copy()} for t in toks]


def test_loss_and_accuracy_match_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 9, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 9)).astype(np.int32)
    labels[0, 1:] = logits[0, :-1].argmax(-1)  # one row predicted right
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(transformer.loss_fn(lt, yt).item(),
                               float(ref_tf.loss_fn(logits, labels)),
                               rtol=1e-6)
    assert transformer.accuracy(lt, yt).item() == pytest.approx(
        float(ref_tf.accuracy(logits, labels)), abs=1e-7)


@pytest.mark.parametrize("optim_over,steps", [
    ({}, 1), ({}, 3), ({"momentum": 0.9}, 3),
    ({"name": "momentum", "momentum": 0.5}, 1)])
def test_train_step_matches_reference(optim_over, steps):
    run = dict(RUN, optim=dict(RUN["optim"], **optim_over))
    rcfg = ref_config.ExperimentConfig.from_dict(run)
    pcfg = port_config.ExperimentConfig.from_dict(run)
    topo = make_topology(rcfg.mesh)
    assert topo.num_replicas == 1
    rmodel = ref_get_model(rcfg.model)
    sched = ref_lr.constant(0.05)
    rstep = ref_api.build_train_step(rmodel, rcfg, topo, sched)
    rstate = topo.device_put_state(
        ref_api.init_train_state(rmodel, rcfg, topo),
        ref_api.state_partition_specs(rmodel, rcfg, topo))
    pstate = state_from_reference(jax.device_get(rstate), device="cpu")
    pstep = api.build_train_step(get_model(pcfg.model), pcfg,
                                 lr_schedule.constant(0.05))
    for b in _batches(steps):
        rstate, rm = rstep(rstate, topo.device_put_batch(b))
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert set(pm) == set(rm)
        np.testing.assert_allclose(pm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-5)
        assert pm["train_acc"].item() == pytest.approx(
            float(rm["train_acc"]), abs=1e-6)
        assert pm["lr"] == float(rm["lr"])
        assert pm["updates_applied"] == int(rm["updates_applied"])
        assert pm["flags"] == [1.0] and pm["applied"] == int(rm["applied"])
    want = jax.device_get(rstate)
    got = state_to_reference(pstate)
    assert got["step"] == int(want.step) == steps
    assert got["updates_applied"] == int(want.updates_applied)
    np.testing.assert_array_equal(got["root_key"], np.asarray(want.root_key))
    trees = [("params", want.params)]
    if want.momentum is not None:
        trees.append(("momentum", want.momentum))
    else:
        assert got["momentum"] is None
    for name, tree in trees:
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got[name])):
            assert np.asarray(a).dtype == b.dtype == np.float32
            np.testing.assert_allclose(b, np.asarray(a), atol=2e-6,
                                       rtol=1e-5)


def test_eval_step_matches_reference_sums():
    rcfg = ref_config.ExperimentConfig.from_dict(RUN)
    pcfg = port_config.ExperimentConfig.from_dict(RUN)
    topo = make_topology(rcfg.mesh)
    rmodel = ref_get_model(rcfg.model)
    params = rmodel.init(jax.random.PRNGKey(3))
    b = dict(_batches(1, seed=4)[0], weight=np.array([1.0] * 6 + [0.0] * 2,
                                                     np.float32))
    want = ref_api.build_eval_step(rmodel, rcfg, topo)(
        topo.device_put_state(params, jax.sharding.PartitionSpec()),
        topo.device_put_batch(b))
    pstate = state_from_reference({"params": jax.device_get(params)},
                                  device="cpu")
    got = api.build_eval_step(get_model(pcfg.model), pcfg)(
        pstate.params, {k: torch.from_numpy(v) for k, v in b.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    assert params_to_reference(pstate.params)["embed"].shape == (16, 32)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)),
    ("exponential_decay", (0.1, 7, 0.9, True)),
    ("exponential_decay", (0.1, 7, 0.9, False)),
    ("warmup_polynomial_decay", (0.2, 5, 40, 0.01, 2.0))])
def test_schedules_match_reference(name, args):
    port, ref = getattr(lr_schedule, name)(*args), getattr(ref_lr, name)(*args)
    for t in range(0, 60, 3):
        # float32 arithmetic on both sides; pow may differ by one ulp
        np.testing.assert_allclose(port(t), float(ref(np.int32(t))),
                                   rtol=2e-7)
    assert lr_schedule.decay_steps_for(1000, 64, 2.0, 3) == \
        ref_lr.decay_steps_for(1000, 64, 2.0, 3)


def test_unported_optimizers_and_modes_raise():
    """LARS and LAMB, accumulation, low-precision params and remat build
    now; an unknown optimizer is the reference's ConfigError; tensor
    parallelism on one process is a ConfigError that says to launch the
    processes under torchrun, and pipeline parallelism still raises "not
    ported yet"."""
    for name, slots in (("lars", 1), ("lamb", 2)):
        opt = optim.make_optimizer(port_config.OptimConfig(name=name))
        assert (opt.kind, opt.num_slots) == (name, slots)
    with pytest.raises(port_config.ConfigError, match="unknown optimizer"):
        optim.make_optimizer(port_config.OptimConfig(name="adamw"))
    model = get_model(port_config.ExperimentConfig.from_dict(RUN).model)
    for over in ({"train": {"grad_accum_steps": 2}},
                 {"precision": {"param_dtype": "bfloat16"}},
                 {"optim": {"name": "lamb"}},
                 {"model": {**RUN["model"], "remat": True}}):
        cfg = port_config.ExperimentConfig.from_dict(dict(RUN, **over))
        api.build_train_step(model, cfg, lr_schedule.constant(0.1))
    cfg = port_config.ExperimentConfig.from_dict(
        dict(RUN, mesh={"model_parallelism": 2}))
    with pytest.raises(port_config.ConfigError, match="torchrun"):
        api.build_train_step(model, cfg, lr_schedule.constant(0.1))
    cfg = port_config.ExperimentConfig.from_dict(
        dict(RUN, mesh={"pipeline_parallelism": 2}))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        api.build_train_step(model, cfg, lr_schedule.constant(0.1))
