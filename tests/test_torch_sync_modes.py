"""The port's N-replica train step against the reference's, step by step,
in all five ``sync.mode``s (``parallel/api.py build_train_step``).

Eight replicas, a global batch of 64 synthetic 12x12 images, the MNIST
CNN (its layers and widths; 12x12 keeps fc1 at 576 inputs) in float32
with dropout on. The reference runs on the forced 8-device CPU
mesh (``topo8``); the port simulates the 8 replicas on the CPU and
reads the same batches. Before every step the port takes the
reference's state of the step before (params, slots, interval window
and clock, counters, converted), and after it must hold the
reference's next state: ``flags`` and ``applied`` exact (the port draws
the reference's straggler times from the same keys),
``num_contributors``, ``updates_applied``, ``lr`` and the window's
rounds and clock exact, the loss and every param and slot within
float32 ``rtol 1e-5`` (elementwise, with an ``atol`` of 1e-6 of the
leaf's largest value for entries near zero). Each step starts from the
reference's state because two float32 runs that differ by summation
order alone drift apart over steps: a max-pool window whose top two
values lie closer than float32 resolves (a gap of 3.6e-8 was found in
one of these steps) routes its gradient to the other element on one
side, and the next steps amplify it (one-step errors are below 6e-7 of
each leaf's norm, ten free steps reach 6e-3). A step where the two
float32 forwards take a different ReLU or max-pool branch somewhere
(:func:`_forwards_branch_differently`) is held to 1e-3 of each leaf's
norm instead, and at most 3 of a case's 10 steps may be.

The cases: ``sync`` (sgd); ``quorum`` k=4 over lognormal times
(momentum) with its discipline vector swapped to k=2 mid-run and a
staircase lr decaying every ``decay_steps ÷ k`` updates; ``timeout``
(momentum) whose deadline is swapped to 0 for one step, masking every
replica, where params and slots must stay bitwise; ``interval`` (sgd,
two or more window fires); ``cdf`` with drop-connect (sgd). The
reference's trajectories are built once per module.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.data.datasets import make_synthetic
from distributedmnist_tpu.data.pipeline import BatchIterator
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train import lr_schedule as ref_lr
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models.convert import (params_from_reference,
                                                       params_to_reference,
                                                       state_from_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule
from distributedmnist_tpu_torch.train.loop import make_schedule

from _torch_threads import one_torch_thread  # noqa: F401

STEPS = 10
N = 8
BATCH = 64
TRAIN = 1024
SIZE = 12
LOGNORMAL = {"straggler_profile": "lognormal", "straggler_mean_ms": 50.0}
MOMENTUM = {"name": "momentum", "momentum": 0.9}

# name -> (config overrides, {step: (k, timeout_ms, interval_ms)} swaps)
CASES = {
    "sync": ({"sync": {"mode": "sync"}}, {}),
    "quorum": ({"sync": {"mode": "quorum", "num_replicas_to_aggregate": 4,
                         **LOGNORMAL},
                "optim": {**MOMENTUM, "learning_rate_decay_factor": 0.5,
                          "num_epochs_per_decay": 0.5}},
               {5: (2.0, 0.0, 1000.0)}),
    "timeout": ({"sync": {"mode": "timeout", "timeout_ms": 60.0,
                          **LOGNORMAL},
                 "optim": MOMENTUM},
                {3: (8.0, 0.0, 1000.0), 4: (8.0, 60.0, 1000.0)}),
    "interval": ({"sync": {"mode": "interval", "interval_ms": 120.0,
                           **LOGNORMAL}}, {}),
    "cdf": ({"sync": {"mode": "cdf", "drop_connect": True}}, {}),
}


def _cfg_dict(over):
    d = {"data": {"dataset": "synthetic", "batch_size": BATCH,
                  "synthetic_train_size": TRAIN, "synthetic_test_size": 256,
                  "use_native_pipeline": False},
         "model": {"compute_dtype": "float32", "image_size": SIZE},
         "mesh": {"num_replicas": N},
         "optim": {"initial_learning_rate": 0.01,
                   "learning_rate_decay_factor": 1.0}}
    for sec, vals in over.items():
        d[sec] = {**d.get(sec, {}), **vals}
    return d


def _batches():
    data = make_synthetic(num_train=TRAIN, num_test=256, image_size=SIZE)
    it = BatchIterator(data.train, BATCH, seed=0)
    return [next(it) for _ in range(STEPS)]


def _schedules(rcfg, pcfg):
    k = 4 if rcfg.sync.mode == "quorum" else N
    o = rcfg.optim
    if o.learning_rate_decay_factor == 1.0:
        return (ref_lr.constant(o.initial_learning_rate),
                lr_schedule.constant(o.initial_learning_rate))
    steps = ref_lr.decay_steps_for(TRAIN, BATCH, o.num_epochs_per_decay, k)
    return (ref_lr.exponential_decay(o.initial_learning_rate, steps,
                                     o.learning_rate_decay_factor),
            pcfg and make_schedule(pcfg, TRAIN, BATCH, k))


def _ref_run(topo8, name):
    over, swaps = CASES[name]
    rcfg = RefConfig.from_dict(_cfg_dict(over))
    model = ref_get_model(rcfg.model)
    specs = ref_api.state_partition_specs(model, rcfg, topo8)
    state = topo8.device_put_state(
        ref_api.init_train_state(model, rcfg, topo8), specs)
    init = jax.device_get(state)
    sched, _ = _schedules(rcfg, None)
    step_fn = ref_api.build_train_step(model, rcfg, topo8, sched)
    disc = None
    traj = []
    for i, b in enumerate(_batches()):
        if i in swaps:
            disc = ref_api.make_discipline_vector(*swaps[i])
        state, m = step_fn(state, topo8.device_put_batch(b), None, disc)
        traj.append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                     "flags": np.asarray(m["flags"]),
                     "num_contributors": float(m["num_contributors"]),
                     "applied": int(m["applied"]),
                     "updates_applied": int(m["updates_applied"]),
                     "state": jax.device_get(state)})
    return init, traj


@pytest.fixture(scope="module")
def reference_runs(topo8):
    return {name: _ref_run(topo8, name) for name in CASES}


def _leaves(tree):
    return jax.tree.leaves(tree)


def _windows_argmax(r: np.ndarray) -> np.ndarray:
    """Argmax of each 2x2/2 window of an NHWC activation (even sizes)."""
    b, h, w, c = r.shape
    win = r.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
    return win.reshape(b, h // 2, w // 2, c, 4).argmax(-1)


def _forwards_branch_differently(params, images) -> bool:
    """Whether the two float32 forwards take a different branch
    somewhere: a ReLU whose input one side rounds above zero and the
    other not, or a live max-pool window routed to different elements
    (a window whose top two values lie closer than float32 rounding
    resolves)."""
    from distributedmnist_tpu.models import cnn as ref_cnn
    pp = params_from_reference(params, device="cpu")
    xt = torch.from_numpy(images).permute(0, 3, 1, 2)
    xr = np.asarray(images)
    for name in ("conv1", "conv2"):
        yt = (F.conv2d(xt, pp[name]["w"].permute(3, 2, 0, 1), padding=2)
              + pp[name]["b"][None, :, None, None]).permute(0, 2, 3, 1)
        yr = np.asarray(ref_cnn._conv2d_same(xr, params[name]["w"])
                        + params[name]["b"])
        rt, rr = np.maximum(yt.numpy(), 0.0), np.maximum(yr, 0.0)
        b, h, w, c = rr.shape
        live = rr.reshape(b, h // 2, 2, w // 2, 2, c).max((2, 4)) > 0
        if ((rt > 0) != (rr > 0)).any() or (
                _windows_argmax(rt) != _windows_argmax(rr))[live].any():
            return True
        xt = F.max_pool2d(torch.from_numpy(rt).permute(0, 3, 1, 2), 2, 2)
        xr = np.asarray(ref_cnn._maxpool2(rr))
    ht = (xt.permute(0, 2, 3, 1).reshape(xt.shape[0], -1) @ pp["fc1"]["w"]
          + pp["fc1"]["b"]).numpy()
    hr = np.asarray(xr.reshape(xr.shape[0], -1) @ params["fc1"]["w"]
                    + params["fc1"]["b"])
    return bool(((ht > 0) != (hr > 0)).any())


def _close(got, want, tie: bool, what: str):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if tie:
        assert (np.linalg.norm(got - want)
                <= 1e-3 * np.linalg.norm(want) + 1e-12), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_port_step_matches_reference(reference_runs, name):
    over, swaps = CASES[name]
    init, traj = reference_runs[name]
    pcfg = ExperimentConfig.from_dict(_cfg_dict(over))
    rcfg = RefConfig.from_dict(_cfg_dict(over))
    _, sched = _schedules(rcfg, pcfg)
    model = get_model(pcfg.model)
    step_fn = api.build_train_step(model, pcfg, sched,
                                   make_topology(pcfg.mesh))
    disc = None
    fires = masked_steps = ties = 0
    prev = init
    for i, (b, want) in enumerate(zip(_batches(), traj)):
        if i in swaps:
            disc = api.make_discipline_vector(*swaps[i])
        state = state_from_reference(prev, device="cpu")
        tie = _forwards_branch_differently(prev.params, b["image"])
        ties += tie
        before = [p.clone() for p in api.tree_leaves(state.params)]
        slots_before = [p.clone() for p in api.tree_leaves(state.momentum)]
        state, m = step_fn(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, None, disc)
        prev = want["state"]
        np.testing.assert_array_equal(m["flags"], want["flags"],
                                      err_msg=f"{name} step {i}")
        assert m["applied"] == want["applied"], (name, i)
        assert m["updates_applied"] == want["updates_applied"], (name, i)
        assert m["num_contributors"] == want["num_contributors"], (name, i)
        assert m["lr"] == want["lr"], (name, i)
        assert state.step == int(prev.step) == i + 1
        for f in ("window_rounds", "wall_ms", "next_apply_ms"):
            assert state.__dict__[f] == float(getattr(prev, f)), (name, i, f)
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
        for tree, ref_tree in ((state.params, prev.params),
                               (state.momentum, prev.momentum),
                               (state.window_acc, prev.window_acc)):
            got = (None if tree is None else params_to_reference(tree))
            for g, w in zip(_leaves(got), _leaves(ref_tree)):
                _close(g, w, tie, f"{name} step {i}")
        if m["applied"] == 0 and name != "interval":
            masked_steps += 1
            # an all-masked step is a true no-op: params and slots bitwise
            for a, c in zip(api.tree_leaves(state.params), before):
                assert torch.equal(a, c)
            for a, c in zip(api.tree_leaves(state.momentum), slots_before):
                assert torch.equal(a, c)
        fires += m["applied"]
    assert ties <= 3, f"{ties} of {STEPS} steps held to the near-tie bound"
    if name == "timeout":
        assert masked_steps >= 1
    if name == "interval":
        assert fires >= 2 and traj[-1]["updates_applied"] < STEPS
    if name == "quorum":
        flags = np.stack([t["flags"] for t in traj])
        assert (flags.sum(1)[:5] == 4).all() and (flags.sum(1)[5:] == 2).all()
        assert len({t["lr"] for t in traj}) > 1  # the staircase stepped


def test_discipline_swap_changes_flags_with_no_rebuild():
    """The same step function reads a new ``[3]`` vector every call."""
    pcfg = ExperimentConfig.from_dict(_cfg_dict(CASES["quorum"][0]))
    model = get_model(pcfg.model)
    step_fn = api.build_train_step(model, pcfg, lr_schedule.constant(0.01),
                                   make_topology(pcfg.mesh))
    state = api.init_train_state(model, pcfg, torch.device("cpu"))
    b = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    sums = []
    for k in (4, 1, 7):
        state, m = step_fn(state, b, None,
                           api.make_discipline_vector(k, 0.0, 1000.0))
        sums.append(int(m["flags"].sum()))
    assert sums == [4, 1, 7]
