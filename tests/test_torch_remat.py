"""Port parity: activation rematerialisation (``model.remat``,
``distributedmnist_tpu_torch/models/transformer.py apply``) at 8
replicas, against the reference's two remat tests
(``tests/test_transformer_train.py:55 test_remat_matches_dense_exactly``
and ``:94 test_remat_save_attn_matches_full``) and against their own
results.

The configuration is the reference tests' (seq 16, d 32, 4 heads, 2
layers, vocab 37, float32, global batch 8, sync, lr 0.1, one step on
``jax.random.randint(PRNGKey(3))`` tokens), the port at 8 simulated
replicas from the reference's init converted. Remat recomputes, it does
not change the arithmetic: the port's arms agree at the reference's own
rtol 1e-6 / atol 1e-7. Each port arm against the reference's: loss rtol
1e-5, params atol 2e-6 / rtol 1e-5 (``test_torch_train_step.py``'s
float32 summation-order band).

With remat on, the replicas run one at a time through plain autograd
(``torch.utils.checkpoint`` does not run under ``torch.func``); the
flash forward runs twice a layer under ``full`` and once under
``save_attn``.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.convert import (state_from_reference,
                                                       state_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.ops import flash_attention as fa
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule

from _torch_threads import one_torch_thread  # noqa: F401

N, LAYERS = 8, 2


def remat_dict(attention: str, **model) -> dict:
    return {"data": {"dataset": "synthetic_lm", "batch_size": 8},
            "model": {"name": "transformer", "compute_dtype": "float32",
                      "seq_len": 16, "model_dim": 32, "num_heads": 4,
                      "num_layers": LAYERS, "vocab_size": 37,
                      "attention_impl": attention, **model},
            "sync": {"mode": "sync", "straggler_profile": "none"}}


def tokens() -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (8, 16), 0,
                                       37))


def ref_step(topo8, d: dict, toks: np.ndarray):
    """The reference's one step (its remat tests' body): (init state,
    loss, params leaves)."""
    cfg = base_config(**{k: dict(v) for k, v in d.items()})
    cfg = cfg.override({"mesh.num_replicas": N})
    model = ref_get_model(cfg.model)
    state = topo8.device_put_replicated(ref_api.init_train_state(model, cfg))
    init = jax.device_get(state)
    step_fn = ref_api.build_train_step(model, cfg, topo8, ref_constant(0.1))
    state, m = step_fn(state, topo8.device_put_batch({"image": toks,
                                                      "label": toks}))
    return init, float(m["loss"]), [np.asarray(x) for x in jax.tree.leaves(
        jax.device_get(state.params))]


def port_step(d: dict, init, toks: np.ndarray):
    """The port's one step at 8 replicas from ``init``: (loss, params
    leaves in the reference's order, flash forwards run)."""
    cfg = ExperimentConfig.from_dict({**d, "mesh": {"num_replicas": N}})
    model = get_model(cfg.model)
    state = state_from_reference(init, device="cpu")
    step_fn = api.build_train_step(model, cfg, lr_schedule.constant(0.1))
    forwards = []
    fwd = fa.flash_attention_fwd_lse

    def counting(*a, **k):
        forwards.append(a[0].shape[0])
        return fwd(*a, **k)

    fa.flash_attention_fwd_lse = counting
    try:
        t = torch.from_numpy(toks)
        state, m = step_fn(state, {"image": t, "label": t})
    finally:
        fa.flash_attention_fwd_lse = fwd
    leaves = [np.array(x) for x in jax.tree.leaves(
        state_to_reference(state)["params"])]
    return m["loss"].item(), leaves, forwards


def assert_close(a, b, rtol_loss, **tol):
    np.testing.assert_allclose(a[0], b[0], rtol=rtol_loss)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_allclose(x, y, **tol)


REF_TOL = dict(rtol_loss=1e-5, atol=2e-6, rtol=1e-5)
SAME_TOL = dict(rtol_loss=1e-6, atol=1e-7, rtol=1e-6)


def test_remat_matches_dense_exactly(topo8):
    """≙ the reference's ``:55``: dense attention, remat off against
    ``full`` — the port's two arms at the reference's tolerance, and
    each against the reference's arm."""
    toks = tokens()
    port, ref = {}, {}
    for remat in (False, True):
        d = remat_dict("dense", remat=remat)
        init, *ref[remat] = ref_step(topo8, d, toks)
        port[remat] = port_step(d, init, toks)[:2]
        assert_close(port[remat], ref[remat], **REF_TOL)
    assert_close(ref[False], ref[True], **SAME_TOL)
    assert_close(port[False], port[True], **SAME_TOL)


def test_remat_save_attn_matches_full(topo8):
    """≙ the reference's ``:94``: flash attention, ``full`` against
    ``save_attn``; the flash forward runs twice a layer a replica under
    ``full`` (the checkpoint reruns the block), once under ``save_attn``,
    and once a layer for all replicas together without remat (the
    vmap rule's fold)."""
    toks = tokens()
    port, ref, forwards = {}, {}, {}
    for policy in ("full", "save_attn", None):
        d = remat_dict("flash", remat=policy is not None,
                       remat_policy=policy or "full")
        init, *ref[policy] = ref_step(topo8, d, toks)
        *port[policy], forwards[policy] = port_step(d, init, toks)
        assert_close(port[policy], ref[policy], **REF_TOL)
    assert_close(ref["full"], ref["save_attn"], **SAME_TOL)
    assert_close(port["full"], port["save_attn"], **SAME_TOL)
    assert_close(port["full"], port[None], **SAME_TOL)
    assert forwards["full"] == [1] * (2 * N * LAYERS)
    assert forwards["save_attn"] == [1] * (N * LAYERS)
    assert forwards[None] == [N] * LAYERS


def test_save_attn_refuses_dense_and_unknown_policy():
    """The reference's refusals: ``save_attn`` needs flash attention (a
    ValueError naming it, at build), an unknown policy is a ValueError
    at the forward."""
    with pytest.raises(ValueError, match="requires attention_impl='flash'"):
        get_model(ExperimentConfig.from_dict(remat_dict(
            "dense", remat=True, remat_policy="save_attn")).model)
    params = transformer.init(torch.Generator().manual_seed(0),
                              vocab_size=37, model_dim=32, num_heads=4,
                              num_layers=1, max_seq_len=16)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        transformer.apply(params, torch.zeros(1, 16, dtype=torch.long),
                          compute_dtype=torch.float32, remat=True,
                          remat_policy="some")
