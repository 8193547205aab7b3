"""The port's trust-ratio optimizers (``train/optim.py``: LARS and
LAMB, their slot-tree plumbing and their config checks) against the
reference's ``train/optim.py``.

* Leaf updates on float32 numpy inputs, ``adapt`` true and false, ``t``
  1 and 7, against the reference's ``update_leaf`` under ``jax.jit``:
  not bitwise — XLA's CPU backend contracts ``a·b + c`` into fused
  multiply-adds (``b1·m + (1-b1)·g`` and the like) where the port rounds
  the product first, and sums the norms in its own order — so each
  element of the new param and slots is held within 2.5e-7 of the
  leaf's largest magnitude (about two float32 ulps of it; measured at
  most 9e-8). LAMB's bias corrections ``1 - b**t`` are bitwise XLA's for
  every ``t`` up to 2000 (torch's scalar ``pow``; numpy's float32
  ``power`` differs by an ulp at about a fifth of them).
* ``validate``, ``opt_state_kind`` and ``saved_opt_state_kind`` give the
  reference's answers and errors on the same configs.
* Steps of the CNN at 8 replicas (12x12, float32, dropout off) against
  the reference's replicated step on the 8-device mesh, elementwise
  within ``rtol 1e-5, atol 1e-6``: LARS over 2 steps (params and slots),
  LAMB over 1 — its slots everywhere, its params wherever the summed
  gradient is zero or at least 10·eps (all but 1,825 of the 352,650
  elements). Below that LAMB's ``m̂/(sqrt(v̂)+eps)`` is sign-like, and
  the float-epsilon difference between the two replica sums moves whole
  update elements (3 of conv2's 51,200, by up to 2.0e-6, where
  ``|g| < 2e-6``) — the reason the reference's own
  ``tests/test_optim.py::test_trust_ratio_zero1_matches_replicated[lamb]``
  fails its 2-step tolerance with this JAX. Every LAMB param leaf is
  also held within 1e-5 of its norm (measured at most 1.9e-6). LAMB's
  2-step gap is printed, not gated.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ConfigError as RefConfigError
from distributedmnist_tpu.core.config import OptimConfig as RefOptimConfig
from distributedmnist_tpu.train import optim as ref_optim
from distributedmnist_tpu_torch.core.config import ConfigError, OptimConfig
from distributedmnist_tpu_torch.train import optim

from _torch_dp import cfg_dict, batches, leaves_np, port_steps, ref_steps
from _torch_threads import one_torch_thread  # noqa: F401

HYPER = {"lars": {"beta1": 0.9, "trust_coefficient": 0.001,
                  "weight_decay": 0.01},
         "lamb": {"beta1": 0.9, "beta2": 0.99, "eps": 1e-6,
                  "weight_decay": 0.01}}


def _leaf_inputs(name: str, shape, seed: int):
    rng = np.random.default_rng(seed)
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    slots = [rng.standard_normal(shape).astype(np.float32) * 0.1]
    if name == "lamb":
        slots.append(np.abs(rng.standard_normal(shape)).astype(np.float32)
                     * 0.01)
    return p, g, slots


def _close_to_scale(got, want, what: str):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 2.5e-7 * np.abs(want).max(), what


@pytest.mark.parametrize("t", [1.0, 7.0])
@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_leaf_update_matches_reference(name, adapt, t):
    ref = ref_optim.make_optimizer(RefOptimConfig(name=name, **HYPER[name]))
    port = optim.make_optimizer(OptimConfig(name=name, **HYPER[name]))
    assert (port.kind, port.num_slots) == (ref.kind, ref.num_slots)
    lr = float(np.float32(0.1))
    for shape in ((64, 33), (3, 3, 16, 32), (37,)):
        p, g, slots = _leaf_inputs(name, shape, seed=len(shape))
        want_p, want_s = jax.jit(lambda p, g, s, t: ref.update_leaf(
            p, g, s, jnp.float32(lr), t, lambda x: x, adapt))(
                p, g, tuple(slots), jnp.float32(t))
        tp = torch.from_numpy(p.copy())
        ts = tuple(torch.from_numpy(s.copy()) for s in slots)
        out = port.update_leaf(tp, torch.from_numpy(g), ts, lr, t,
                               lambda x: x, adapt)
        assert all(a is b for a, b in zip(out, ts))  # updated in place
        _close_to_scale(tp.numpy(), want_p, f"{name} param {shape}")
        for a, b in zip(ts, want_s):
            _close_to_scale(a.numpy(), b, f"{name} slot {shape}")


def test_lamb_bias_corrections_are_xla_bitwise():
    pow_xla = jax.jit(lambda b, t: jnp.power(b, t))
    ts = np.arange(1, 2001, dtype=np.float32)
    for b in (0.9, 0.99, 0.999):
        want = np.float32(1.0) - np.asarray(pow_xla(jnp.float32(b),
                                                    jnp.asarray(ts)))
        bt = torch.tensor(np.float32(b))
        got = np.array([np.float32(1.0) - np.float32(
            torch.pow(bt, torch.tensor(t)).item()) for t in ts], np.float32)
        np.testing.assert_array_equal(got, want)


def test_trust_ratio_is_one_on_zero_leaves():
    """A fresh all-zero leaf (or a zero gradient) must still move: the
    trust ratio falls back to 1, as the reference's."""
    for name in ("lars", "lamb"):
        port = optim.make_optimizer(OptimConfig(name=name, **HYPER[name]))
        p = torch.zeros(4, 3)
        g = torch.ones(4, 3)
        slots = tuple(torch.zeros(4, 3) for _ in range(port.num_slots))
        port.update_leaf(p, g, slots, 0.5, 1.0, lambda x: x, True)
        assert torch.isfinite(p).all() and (p != 0).all(), name


CONFIGS = [
    {"name": "sgd"}, {"name": "sgd", "momentum": 0.9},
    {"name": "momentum", "momentum": 0.9}, {"name": "momentum"},
    {"name": "lars"}, {"name": "lamb"}, {"name": "lars", "momentum": 0.9},
    {"name": "lamb", "momentum": 0.5}, {"name": "adamw"},
    {"name": "lamb", "schedule": "cosine"},
    {"name": "lars", "schedule": "polynomial"},
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: json.dumps(kw))
def test_validate_and_state_kinds_match_reference(kw):
    try:
        want = ref_optim.opt_state_kind(RefOptimConfig(**kw))
    except RefConfigError as e:
        with pytest.raises(ConfigError) as got:
            optim.opt_state_kind(OptimConfig(**kw))
        assert str(got.value) == str(e)
        return
    optim.validate(OptimConfig(**kw))
    assert optim.opt_state_kind(OptimConfig(**kw)) == want
    saved = {**OptimConfig().__dict__, **kw}
    assert optim.saved_opt_state_kind(saved) == \
        ref_optim.saved_opt_state_kind(saved)
    for junk in (None, {}, {"momentum": 0.1}, {"name": "x", "extra": 1}):
        assert optim.saved_opt_state_kind(junk) == \
            ref_optim.saved_opt_state_kind(junk)


def test_slot_trees_layout():
    lamb = optim.make_optimizer(OptimConfig(name="lamb"))
    state = optim.init_slots(lamb, lambda: {"w": torch.zeros(2)})
    assert set(state) == {"m", "v"} and optim.is_slot_dict(state)
    assert optim.slot_trees(lamb, state) == [state["m"], state["v"]]
    assert optim.map_slots(lambda t: 1, state) == {"m": 1, "v": 1}
    lars = optim.make_optimizer(OptimConfig(name="lars"))
    one = optim.init_slots(lars, lambda: {"w": torch.zeros(2)})
    assert not optim.is_slot_dict(one) and optim.map_slots(len, one) == 1
    assert optim.slot_dtype(torch.bfloat16) == torch.float32


@pytest.fixture(scope="module")
def feed():
    return batches(2)


@pytest.mark.parametrize("name,steps", [("lars", 2), ("lamb", 1)])
def test_cnn_steps_match_reference(topo8, feed, name, steps):
    d = cfg_dict(optim={"name": name, "weight_decay": 1e-3})
    ref, ref_hist, _ = ref_steps(topo8, d, feed[:steps])
    st, hist, _ = port_steps(d, feed[:steps])
    params = list(zip(leaves_np(st.params), jax.tree.leaves(ref.params)))
    slots = list(zip(leaves_np(st.momentum), jax.tree.leaves(ref.momentum)))
    for a, b in slots:
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    exempt = 0
    for (a, b), m in zip(params, jax.tree.leaves(
            ref.momentum["m"] if name == "lamb" else ref.params)):
        b = np.asarray(b)
        live = np.ones(b.shape, bool)
        if name == "lamb":
            # u = g/(|g| + eps) is sign-like where the summed gradient
            # g = m/(1 - b1) is within a few eps of zero: the two sums'
            # reassociation moves those elements by up to lr·ratio·|Δu|
            g = np.abs(np.asarray(m)) / 0.1
            live = (g == 0) | (g >= 10 * HYPER["lamb"]["eps"])
            exempt += int((~live).sum())
            assert (np.linalg.norm(a.astype(np.float64) - b)
                    <= 1e-5 * np.linalg.norm(b))
        np.testing.assert_allclose(a[live], b[live], rtol=1e-5, atol=1e-6)
    if name == "lamb":
        print(json.dumps({"lamb_elements_in_sign_regime": exempt}))
    for m, w in zip(hist, ref_hist):
        np.testing.assert_allclose(float(m["loss"]), float(w["loss"]),
                                   rtol=1e-5)
    if name == "lamb":
        ref2, _, _ = ref_steps(topo8, d, feed)
        st2, _, _ = port_steps(d, feed)
        gap = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
            leaves_np(st2.params), jax.tree.leaves(ref2.params)))
        print(json.dumps({"lamb_two_step_max_abs_param_gap": gap}))
