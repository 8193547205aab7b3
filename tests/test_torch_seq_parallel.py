"""Sequence parallelism (``mesh.seq_parallelism``) in the port's train
step against the reference's (≙ ``tests/test_seq_parallel_train.py``):
ring or Ulysses attention, the cross-block token-shift loss and the
seq-group gradient sum must give the update the reference's step gives
on the conftest's 8-device mesh, from the same converted params and
numpy batch. The port runs in one launch of 8 gloo processes
(``_torch_mp``); the refusals need no process group.

Tolerances are the reference test's: the loss at ``rtol 2e-5, atol
2e-5``, each param at ``rtol 2e-4, atol 2e-5``.
"""

import copy
import dataclasses
import os

import jax
import numpy as np
import pytest

from conftest import base_config
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import Topology
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule

from _torch_mp import run_world
from _torch_tp_cases import LR, cfg_dict

CASES = [("ring", 2, 4), ("ulysses", 2, 4), ("ring", 1, 8)]


def _ref_cfg(d: dict):
    d = {k: v for k, v in d.items() if k not in ("mesh", "optim")}
    return base_config(**copy.deepcopy(d)).override(
        {"optim.initial_learning_rate": LR,
         "optim.learning_rate_decay_factor": 1.0})


def _tokens(d: dict) -> dict:
    b, s = d["data"]["batch_size"], d["model"]["seq_len"]
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (b, s), 0,
                                         d["model"]["vocab_size"]), np.int32)
    return {"image": toks, "label": toks.copy()}


def _ref_sp_update(d: dict, n: int, s: int):
    cfg = _ref_cfg(d)
    topo = ref_topology(RefMesh(num_replicas=n, seq_parallelism=s))
    model = ref_get_model(cfg.model)
    state = topo.device_put_replicated(ref_api.init_train_state(model, cfg))
    step_fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    state, m = step_fn(state, topo.device_put_batch(_tokens(d),
                                                    seq_sharded=True))
    return float(m["loss"]), jax.device_get(state.params)


def _sp_cfg(attn: str, n: int, s: int, **over) -> dict:
    return cfg_dict(n, 1, s, sp_attention=attn, **over)


@pytest.fixture(scope="module")
def sp8(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp8")
    jobs = []
    for attn, n, s in CASES:
        d = _sp_cfg(attn, n, s)
        cfg = _ref_cfg(d)
        params = jax.tree.map(np.asarray, jax.device_get(
            ref_get_model(cfg.model).init(
                jax.random.PRNGKey(cfg.model.init_seed))))
        jobs.append((f"{attn}{n}{s}", {"case": "step", "cfg": d,
                                       "params": params,
                                       "batches": [_tokens(d)]}))
    jobs.append(("trainer", {"case": "sp_trainer", "cfg": _sp_cfg(
        "ring", 2, 4,
        sync={"mode": "quorum", "num_replicas_to_aggregate": 1,
              "straggler_profile": "lognormal"},
        data={"use_native_pipeline": True},
        train={"max_steps": 20, "train_dir": str(root / "run_sp"),
               "log_every_steps": 10})}))
    return run_world(root / "run", 8, jobs, timeout_s=300)


@pytest.mark.parametrize("attn,n,s", CASES)
def test_sp_step_matches_the_reference(sp8, attn, n, s):
    want_loss, want_params = _ref_sp_update(_sp_cfg(attn, n, s), n, s)
    for out in (r[f"{attn}{n}{s}"] for r in sp8):
        assert "error" not in out, out
        np.testing.assert_allclose(out["losses"][0], want_loss, rtol=2e-5,
                                   atol=2e-5)
        for a, b in zip(jax.tree.leaves(out["params"]),
                        jax.tree.leaves(want_params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                       atol=2e-5)


def test_trainer_end_to_end_seq_parallel(sp8):
    """The Trainer at (replica 2, seq 4) with the native pipeline on:
    runs, learns, and the quorum still applies on the replica axis with
    the same flags on every rank."""
    outs = [r["trainer"] for r in sp8]
    for out in outs:
        assert out["final_step"] == 20
        assert out["last"]["num_contributors"] == 1.0
        # the loss drops from about ln(vocab) = 3.6
        assert out["last"]["loss"] < 3.4
        assert out["eval"]["num_examples"] == 256
        assert out["flags"] == outs[0]["flags"]
        # the reference's C++ loader order wherever it would run it (C15)
        assert out["impl"] == ("native" if (os.cpu_count() or 1) >= 2
                               else "numpy")


def _fake_topo(n=2, m=1, s=4, **groups) -> Topology:
    """A topology of a replica over ``m·s`` processes, never reduced over:
    the refusals below raise before any collective runs."""
    return Topology(num_replicas=n, model_parallelism=m, seq_parallelism=s,
                    **groups)


def _build(d: dict, model=None, topo=None):
    cfg = ExperimentConfig.from_dict(d)
    model = model or get_model(cfg.model)
    return api.build_train_step(model, cfg, lr_schedule.constant(LR),
                                topo or _fake_topo())


@pytest.mark.parametrize("name", ["mnist_cnn", "resnet20"])
def test_sp_requires_a_capable_model(name):
    """The CNN and ResNet-20 have no sequence- or tensor-parallel apply:
    the reference's message (``parallel/api.py:893-900``)."""
    d = _sp_cfg("ring", 2, 4)
    d["model"] = {"name": name, "compute_dtype": "float32",
                  "dropout_rate": 0.0}
    d["data"] = {"dataset": "synthetic", "batch_size": 8}
    with pytest.raises(ValueError, match="seq_parallelism"):
        _build(d)
    with pytest.raises(ValueError, match="model_parallelism=2"):
        _build(dict(d, mesh={"num_replicas": 2, "model_parallelism": 2}),
               topo=_fake_topo(m=2, s=1))


def test_sharded_paths_refuse_dropout_models():
    d = _sp_cfg("ring", 2, 4)
    model = dataclasses.replace(get_model(ExperimentConfig.from_dict(
        d).model), dropout_masks=lambda *a: None)
    with pytest.raises(ValueError, match="dropout"):
        _build(d, model=model)


def test_save_attn_refuses_ring_attention():
    d = _sp_cfg("ring", 2, 4, attention_impl="flash",
                model={"remat": True, "remat_policy": "save_attn"})
    with pytest.raises(ValueError, match="remat_policy='full'"):
        _build(d, topo=_fake_topo(seq_group=object()))
