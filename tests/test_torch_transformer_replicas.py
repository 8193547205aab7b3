"""Port parity: the transformer's data-parallel step over 8 replicas in
one process (``distributedmnist_tpu_torch/parallel/api.py`` with the
flash attention's vmap rule, ``ops/flash_attention.py``), against the
reference's SPMD step on the conftest's 8-device CPU mesh.

Both run the reference's ``test_transformer_quorum_mode`` configuration
(``tests/test_transformer_train.py``: seq 64, d 64, 4 heads, 2 layers,
vocab 32, float32, global batch 32, quorum k = 5 over lognormal
stragglers, lr 0.05) for 10 steps, from the reference's init converted
leaf for leaf and on the same seeded numpy tokens; the reference's flash
attention runs its Pallas kernels in interpret mode, the port's the
plain versions. Tolerances, as ``test_torch_train_step.py``'s: loss
rtol 1e-5; params atol 2e-6 / rtol 1e-5 — float32 summation-order
differences between the blocked online softmax and the dense one. The
flags, ``num_contributors`` and the counters are equal.

The params are compared after every step. Over 10 steps a ReLU
pre-activation can land within float32 rounding of zero (with dense
attention at step 6: 2e-9, on values of order 1), where the two
packages' summation orders put it on different sides of the kink; the
gradients then differ by that unit's contribution (the params by ~3e-6
at lr 0.05) and the runs drift apart from there. A step may leave the
atol/rtol band only when such a pre-activation (below
``KINK``) was in its forward; from then on each leaf stays within
``DRIFT`` of its norm, which a wrong gradient (of order 1) would not.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models.convert import (state_from_reference,
                                                       state_to_reference)
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.ops import flash_attention as fa
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule

from _torch_threads import one_torch_thread  # noqa: F401

N, BATCH, SEQ, VOCAB, STEPS, LR = 8, 32, 64, 32, 10, 0.05
# |pre-activation| below which float32 summation order decides the
# side of a ReLU (values of order 1, an ulp 6e-8), and the per-leaf
# norm gap allowed after such a step
KINK, DRIFT = 1e-7, 1e-3


def lm_dict(attention: str, **model) -> dict:
    """The reference's ``lm_config`` in quorum mode (its
    ``test_transformer_quorum_mode``), as a config dict."""
    return {"data": {"dataset": "synthetic_lm", "batch_size": BATCH,
                     "synthetic_train_size": 512, "synthetic_test_size": 128,
                     "use_native_pipeline": False},
            "model": {"name": "transformer", "seq_len": SEQ, "model_dim": 64,
                      "num_heads": 4, "num_layers": 2, "vocab_size": VOCAB,
                      "compute_dtype": "float32", "attention_impl": attention,
                      **model},
            "optim": {"initial_learning_rate": LR,
                      "learning_rate_decay_factor": 1.0},
            "sync": {"mode": "quorum", "num_replicas_to_aggregate": 5,
                     "straggler_profile": "lognormal"},
            "train": {"max_steps": STEPS, "log_every_steps": 5,
                      "save_interval_steps": 0, "save_results_period": 0}}


def token_batches(steps: int, seed: int = 0) -> list[dict]:
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, (steps, BATCH, SEQ)).astype(np.int32)
    return [{"image": t, "label": t.copy()} for t in toks]


def ref_run(topo8, d: dict, feed: list[dict]):
    """The reference's step over ``feed`` from its init: (the initial
    state, the state after each step, on the host; the metrics)."""
    cfg = base_config(**{k: dict(v) for k, v in d.items()})
    model = ref_get_model(cfg.model)
    state = topo8.device_put_state(
        ref_api.init_train_state(model, cfg, topo8),
        ref_api.state_partition_specs(model, cfg, topo8))
    init = jax.device_get(state)
    step_fn = ref_api.build_train_step(model, cfg, topo8, ref_constant(LR))
    states, hist = [], []
    for b in feed:
        state, m = step_fn(state, topo8.device_put_batch(b))
        states.append(jax.device_get(state))
        hist.append(jax.device_get(m))
    return init, states, hist


def port_run(d: dict, init, feed: list[dict], model_fn=None):
    """The port's step at 8 replicas over ``feed`` from the reference's
    initial state: (the state after each step as reference-layout
    numpy, the metrics, the smallest |FFN pre-activation| of each
    step's forward, the final state)."""
    cfg = ExperimentConfig.from_dict({**d, "mesh": {"num_replicas": N}})
    model = get_model(cfg.model)
    if model_fn is not None:
        model = model_fn(model)
    state = state_from_reference(init, device="cpu")
    step_fn = api.build_train_step(model, cfg, lr_schedule.constant(LR))
    states, hist, kinks = [], [], []
    for b in feed:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        kinks.append(ffn_preact_min(state.params, batch["image"],
                                    cfg.model.num_heads))
        state, m = step_fn(state, batch)
        got = state_to_reference(state)  # views of the live tensors
        states.append(dict(got, params=jax.tree.map(np.array,
                                                    got["params"])))
        hist.append(m)
    return states, hist, kinks, state


def ffn_preact_min(params, tokens: torch.Tensor, num_heads: int) -> float:
    """The smallest |ln2(x)·w1| over every layer and token of the
    forward (dense attention: the same values to float32 rounding)."""
    p = transformer.cast_params(params, torch.float32)
    x = transformer._embed(p, tokens, None)
    low = float("inf")
    with torch.no_grad():
        for blk in p["blocks"]:
            x = transformer._attn_sublayer(
                x, blk, num_heads=num_heads,
                attn=transformer.local_self_attention)
            h = transformer._rms_norm(x, blk["ln2"]) @ blk["w1"]
            low = min(low, h.abs().min().item())
            x = transformer._ffn_sublayer(x, blk)
    return low


def assert_matches_reference(got_states, got_hist, kinks, want_states,
                             want_hist):
    """Flags, counters and losses every step; the params every step at
    atol 2e-6 / rtol 1e-5 until a step with a ReLU pre-activation below
    ``KINK`` leaves that band, each leaf within ``DRIFT`` of its norm
    after that. Returns the first step out of the band (None)."""
    drifted = None
    for t, (pm, rm, got, want) in enumerate(zip(got_hist, want_hist,
                                                got_states, want_states)):
        np.testing.assert_allclose(pm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(pm["flags"], np.asarray(rm["flags"]))
        assert pm["num_contributors"] == float(rm["num_contributors"])
        assert pm["updates_applied"] == int(rm["updates_applied"])
        assert pm["applied"] == int(rm["applied"])
        assert got["step"] == int(want.step) == t + 1
        assert got["updates_applied"] == int(want.updates_applied)
        pairs = [(np.asarray(a), b) for a, b in zip(
            jax.tree.leaves(want.params), jax.tree.leaves(got["params"]))]
        in_band = all(np.allclose(b, a, atol=2e-6, rtol=1e-5)
                      for a, b in pairs)
        if drifted is None and not in_band:
            assert kinks[t] < KINK, (
                f"step {t + 1} left the band with no ReLU pre-activation "
                f"near zero (smallest {kinks[t]})")
            drifted = t + 1
        if drifted is not None:
            for a, b in pairs:
                gap = np.linalg.norm(b - a) / np.linalg.norm(a)
                assert gap <= DRIFT, (t + 1, gap)
    return drifted


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_quorum_8_replicas_match_reference(topo8, attention):
    """The reference's quorum run at 8 replicas: 5 contributors a step,
    the same flags, counters and params as the reference's."""
    d = lm_dict(attention)
    feed = token_batches(STEPS)
    init, want, want_hist = ref_run(topo8, d, feed)
    got, got_hist, kinks, _ = port_run(d, init, feed)
    assert all(m["num_contributors"] == 5.0 for m in got_hist)
    assert_matches_reference(got, got_hist, kinks, want, want_hist)


def test_vmapped_step_matches_loop_over_replicas(topo8):
    """The vmapped step (one flash launch for every replica, through the
    Functions' vmap rules) against the same step with the replicas run
    one at a time through plain autograd: the same per-replica
    arithmetic, so losses and params agree to float32 rounding (rtol
    1e-6, atol 1e-7; a batched matmul may sum in another order)."""
    d = lm_dict("flash")
    feed = token_batches(3, seed=2)
    init, _, _ = ref_run(topo8, d, feed[:0])
    calls = []
    vmap_rule = fa.FlashAttention.vmap

    def counting(*a):
        calls.append(1)
        return vmap_rule(*a)

    fa.FlashAttention.vmap = staticmethod(counting)
    try:
        _, vm_hist, _, vm = port_run(d, init, feed)
    finally:
        fa.FlashAttention.vmap = staticmethod(vmap_rule)
    assert len(calls) == 2 * len(feed)  # one folded call a layer a step
    _, loop_hist, _, loop = port_run(
        d, init, feed,
        lambda m: dataclasses.replace(m, vmap_replicas=False))
    for a, b in zip(vm_hist, loop_hist):
        np.testing.assert_allclose(a["loss"].item(), b["loss"].item(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(a["flags"], b["flags"])
    for a, b in zip(api.tree_leaves(vm.params), api.tree_leaves(loop.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_vmap_rule_gives_per_replica_gradients():
    """``torch.func.vmap(grad(...))`` through ``flash_attention_bshd``:
    every replica's gradient equals its own ``grad`` alone, bitwise (the
    fold runs the same plain arithmetic on the CPU), and the backward
    goes through ``FlashAttentionBackward``'s rule once."""
    rng = np.random.default_rng(0)
    L, b, s, h, hd = 3, 2, 9, 2, 8
    w = torch.from_numpy(rng.standard_normal((h * hd, 3 * h * hd))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((L, b, s, h * hd))
                         .astype(np.float32))

    def loss(w, x):
        qkv = (x @ w).view(b, s, 3, h * hd)
        q, k, v = (qkv[:, :, i].view(b, s, h, hd) for i in range(3))
        o = fa.flash_attention_bshd(q, k, v)
        return (o * o).sum()

    calls = []
    rule = fa.FlashAttentionBackward.vmap

    def counting(*a):
        calls.append(1)
        return rule(*a)

    fa.FlashAttentionBackward.vmap = staticmethod(counting)
    try:
        got = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(w, x)
    finally:
        fa.FlashAttentionBackward.vmap = staticmethod(rule)
    assert len(calls) == 1
    want = torch.stack([torch.func.grad(loss)(w, x[j]) for j in range(L)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
