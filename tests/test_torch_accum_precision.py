"""Gradient accumulation and the precision knobs of the port's train
step (``parallel/api.py``, ``data/pipeline.py GradAccumFeed``,
``train/loop.py``) against the reference's and a straight-line
reference, on the CPU.

The reference's accumulation cannot run with this JAX: its microbatch
``scan`` carries values whose varying manual axes differ
(``tests/test_optim.py::test_grad_accum_matches_large_batch`` and
``::test_grad_accum_quorum_masking_semantics`` fail while tracing). So
the port's accumulation is held to what that reference test asserts —
``accum = 2`` at batch 64 against ``accum = 1`` at 128: loss ``rtol
5e-5``, params ``rtol 1e-4, atol 1e-5`` — on the port over 4 steps and
against the reference's ``accum = 1`` run over one step, the params
there within 1e-3 of each leaf's norm (free float32 steps of the two
packages drift apart by summation order and max-pool ties,
``tests/test_torch_sync_modes.py``: 9e-4 of the loss by step 4 here),
and to a straight-line loop: every
(replica, microbatch) pair's gradient by plain autograd with its own
dropout mask (key ``replica_key(root, "dropout", step·accum + i, r)``),
averaged in float64 and applied as one sgd step (``rtol 1e-5``, ``atol``
1e-6 of the leaf's largest entry). Under quorum the contributors and
flags of an accumulation step are the ``accum = 1`` step's (the
step-time draws key off the step and replica, not the microbatch), and
the cursor advances ``accum`` batches a step.

Precision: float32 masters over a bf16 forward reproduce float32 params
under bf16 compute (the reference's
``test_master_weights_matches_f32_baseline`` config and tolerances:
loss and params ``rtol 1e-6``) and stay float32, and one step's
update is within 3e-2 of the reference's (both bf16 forwards); bf16
storage without masters keeps bf16 params and float32 slots, the params
within one bf16 ulp of the reference's after a step, the slots within
1e-3 of each leaf's norm (bf16 weights make exact max-pool ties, which
the two packages route to different elements). The transformer's
single-replica autograd path takes LAMB over bf16-viewed masters with
accumulation.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.data.datasets import make_synthetic as ref_synth
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.data.datasets import make_synthetic
from distributedmnist_tpu_torch.models import cnn
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel.api import tree_leaves
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_dp import batches, cfg_dict, leaves_np, port_steps, ref_steps
from _torch_threads import one_torch_thread  # noqa: F401


def _accum_cfg(accum: int, bs: int, train_dir: str) -> dict:
    """``tests/test_optim.py``'s accumulation config (base_config, dropout
    off, 4 steps), 8 replicas."""
    return {"data": {"dataset": "synthetic", "batch_size": bs,
                     "synthetic_train_size": 1024, "synthetic_test_size": 256,
                     "use_native_pipeline": False},
            "model": {"compute_dtype": "float32", "dropout_rate": 0.0},
            "mesh": {"num_replicas": 8},
            "train": {"max_steps": 4, "grad_accum_steps": accum,
                      "train_dir": train_dir, "log_every_steps": 2,
                      "save_interval_steps": 0, "save_results_period": 0}}


@pytest.fixture(scope="module")
def accum_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum")
    data = make_synthetic(num_train=1024, num_test=64)
    runs = {}
    for name, (accum, bs) in {"full": (1, 128), "accum": (2, 64)}.items():
        t = Trainer(ExperimentConfig.from_dict(
            _accum_cfg(accum, bs, str(tmp / name))), data, device="cpu")
        runs[name] = (t, t.run())
    # one step each against the reference: free float32 steps drift apart
    # (summation order, max-pool ties: tests/test_torch_sync_modes.py)
    t = Trainer(ExperimentConfig.from_dict(
        _accum_cfg(2, 64, str(tmp / "accum1"))), data, device="cpu")
    runs["accum_1step"] = (t, t.run(max_steps=1))
    d = _accum_cfg(1, 128, str(tmp / "ref"))
    d["train"]["max_steps"] = 1
    ref = RefTrainer(base_config(**{k: v for k, v in d.items()
                                    if k != "mesh"}),
                     datasets=ref_synth(num_train=1024, num_test=64))
    runs["ref"] = (ref, ref.run())
    return runs


def test_accum_matches_large_batch_on_the_port(accum_runs):
    (t1, s1), (t2, s2) = accum_runs["full"], accum_runs["accum"]
    assert t1.effective_batch == t2.effective_batch == 128
    np.testing.assert_allclose(s2["last_metrics"]["loss"],
                               s1["last_metrics"]["loss"], rtol=5e-5,
                               atol=5e-5)
    for a, b in zip(leaves_np(t2.state.params), leaves_np(t1.state.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # the cursor counts global batches: accum advances the same coordinate
    assert t2.train_iter.state()["batches"] == 8
    assert (t2.train_iter.state()["batches"] * 64
            == t1.train_iter.state()["batches"] * 128)


def test_accum_matches_reference_large_batch(accum_runs):
    """One step: the loss at ``rtol 5e-5``; the params within 1e-3 of
    each leaf's norm — the synthetic images clip at ±0.5, so the
    max-pool windows of saturated regions hold exact ties that XLA and
    torch route to different elements (test_torch_sync_modes.py's
    branch tolerance)."""
    (t2, s2), (ref, sr) = accum_runs["accum_1step"], accum_runs["ref"]
    np.testing.assert_allclose(s2["last_metrics"]["loss"],
                               sr["last_metrics"]["loss"], rtol=5e-5,
                               atol=5e-5)
    for a, b in zip(leaves_np(t2.state.params),
                    jax.tree.leaves(jax.device_get(ref.state.params))):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)


def test_accum_matches_straight_line_reference():
    """One accumulation step with dropout on (8 replicas × 2 microbatches
    of 4 rows) against a loop over (replica, microbatch): plain autograd
    on each, masks from the documented keys, float64 mean, one sgd
    update."""
    d = cfg_dict(model={"dropout_rate": 0.5},
                 train={"grad_accum_steps": 2})
    feed = batches(1)
    st, hist, _ = port_steps(d, feed)
    cfg = ExperimentConfig.from_dict(d)
    model = get_model(cfg.model)
    params = model.init_params(cfg.model.init_seed, torch.device("cpu"))
    leaves = tree_leaves(params)
    root = prng.root_key(cfg.train.seed)
    x, y = (torch.from_numpy(feed[0][k]) for k in ("image", "label"))
    n, accum = 8, 2
    rows = x.shape[0] // n // accum
    total = [np.zeros(p.shape) for p in leaves]
    losses = []
    for r in range(n):
        for i in range(accum):
            sl = slice((r * accum + i) * rows, (r * accum + i + 1) * rows)
            keep = cnn.dropout_mask(
                prng.replica_key(root, "dropout", 0 * accum + i, r),
                (rows, cnn.HIDDEN), 0.5)
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(model.apply(params, x[sl], train=True,
                                          dropout_keep=keep), y[sl])
            grads = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
            losses.append(loss.item())
            for t, g in zip(total, grads):
                t += g.double().numpy()
    lr = cfg.optim.initial_learning_rate
    for got, p, t in zip(leaves_np(st.params), leaves, total):
        want = p.double().numpy() - lr * t / (n * accum)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(float(hist[0]["loss"]), np.mean(losses),
                               rtol=1e-6)


def test_quorum_contributors_under_accumulation():
    sync = {"mode": "quorum", "num_replicas_to_aggregate": 5,
            "straggler_profile": "lognormal"}
    feed = batches(3, batch=64)
    _, h1, _ = port_steps(cfg_dict(sync=sync, data={"batch_size": 32}),
                          [{k: v[:32] for k, v in b.items()} for b in feed])
    _, h2, _ = port_steps(cfg_dict(sync=sync, data={"batch_size": 32},
                                   train={"grad_accum_steps": 2}), feed)
    for a, b in zip(h1, h2):
        assert a["num_contributors"] == b["num_contributors"] == 5.0
        np.testing.assert_array_equal(a["flags"], b["flags"])
        assert b["flags"].sum() == 5.0


def test_cursor_advances_accum_batches(tmp_path):
    d = _accum_cfg(3, 32, str(tmp_path))
    d["train"]["max_steps"] = 2
    t = Trainer(ExperimentConfig.from_dict(d), device="cpu")
    t.run()
    assert t.train_iter.state()["batches"] == 6
    assert t.effective_batch == 96
    d["train"]["max_steps"] = 3  # a resume re-derives its grouping
    t2 = Trainer(ExperimentConfig.from_dict(d), device="cpu")
    assert t2.train_iter.state()["batches"] == 6 and t2.state.step == 2


# -- precision ---------------------------------------------------------------

PREC_OVER = {"model": {"compute_dtype": "bfloat16", "dropout_rate": 0.0}}


@pytest.fixture(scope="module")
def prec_feed():
    return batches(4)


def test_master_weights_match_float32_params(prec_feed):
    st_b, h_b, _ = port_steps(cfg_dict(**PREC_OVER), prec_feed)
    st_m, h_m, _ = port_steps(cfg_dict(
        precision={"param_dtype": "bfloat16", "master_weights": True},
        **PREC_OVER), prec_feed)
    for leaf in tree_leaves(st_m.params):
        assert leaf.dtype == torch.float32
    for mb, mm in zip(h_b, h_m):
        np.testing.assert_allclose(float(mm["loss"]), float(mb["loss"]),
                                   rtol=1e-6, atol=1e-6)
    for a, b in zip(leaves_np(st_m.params), leaves_np(st_b.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_master_weights_against_reference(topo8, prec_feed):
    """One step of the same run on the reference, bf16 compute on both
    sides: the loss within bf16 rounding (1e-2) and each leaf's update
    (new float32 master − init) within 3e-2 of the reference's update's
    norm, about 8 bf16 ulps — two bf16 forwards and backwards that round
    in other orders (measured 1.5e-2, on fc2's bias)."""
    d = cfg_dict(precision={"param_dtype": "bfloat16",
                            "master_weights": True}, **PREC_OVER)
    ref, ref_hist, _ = ref_steps(topo8, d, prec_feed[:1])
    st, hist, _ = port_steps(d, prec_feed[:1])
    cfg = ExperimentConfig.from_dict(d)
    init = leaves_np(get_model(cfg.model).init_params(
        cfg.model.init_seed, torch.device("cpu")))
    np.testing.assert_allclose(float(hist[0]["loss"]),
                               float(ref_hist[0]["loss"]), rtol=1e-2)
    for a, b, p0 in zip(leaves_np(st.params), jax.tree.leaves(ref.params),
                        init):
        assert a.dtype == np.asarray(b).dtype == np.float32
        du, dw = a - p0, np.asarray(b, np.float64) - p0
        assert np.linalg.norm(du - dw) <= 3e-2 * np.linalg.norm(dw)


def test_bf16_storage_without_masters(topo8, prec_feed):
    d = cfg_dict(optim={"name": "momentum", "momentum": 0.9},
                 precision={"param_dtype": "bfloat16"})
    st, hist, _ = port_steps(d, prec_feed[:1])
    assert {x.dtype for x in tree_leaves(st.params)} == {torch.bfloat16}
    assert {x.dtype for x in tree_leaves(st.momentum)} == {torch.float32}
    assert np.isfinite(float(hist[0]["loss"]))
    ref, _, _ = ref_steps(topo8, d, prec_feed[:1])
    for a, b in zip(leaves_np(st.params), jax.tree.leaves(ref.params)):
        b = np.asarray(b).astype(np.float32)
        # one bf16 ulp (2^-7 of the value): the float32 updates round
        # to the same bf16 value but where they straddle a tie
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-30).all()
    # the slots (the first step's gradients) within 1e-3 of each leaf's
    # norm: with bf16 weights the max-pool windows hold exact ties, which
    # XLA and torch route to different elements
    for a, b in zip(leaves_np(st.momentum), jax.tree.leaves(ref.momentum)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)


def test_transformer_lamb_over_bf16_masters_with_accumulation(tmp_path):
    d = {"model": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                   "num_heads": 2, "num_layers": 1, "vocab_size": 16,
                   "compute_dtype": "float32"},
         "data": {"dataset": "synthetic_lm", "batch_size": 4,
                  "synthetic_train_size": 32, "synthetic_test_size": 8},
         "mesh": {"num_replicas": 1},
         "optim": {"name": "lamb", "initial_learning_rate": 0.01,
                   "learning_rate_decay_factor": 1.0},
         "precision": {"param_dtype": "bfloat16", "master_weights": True},
         "train": {"max_steps": 3, "grad_accum_steps": 2,
                   "train_dir": str(tmp_path), "log_every_steps": 1,
                   "save_interval_steps": 0, "save_results_period": 0}}
    t = Trainer(ExperimentConfig.from_dict(copy.deepcopy(d)), device="cpu")
    losses = []
    t.run(step_callback=lambda s, r: losses.append(r["loss"]))
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert {x.dtype for x in tree_leaves(t.state.params)} == {torch.float32}
    assert set(t.state.momentum) == {"m", "v"}
    # 3 steps of 2 batches: the cursor of whichever order the host takes
    # (the native loader's counts epochs of 8 batches and rows, C15)
    cur = t.train_iter.state()
    consumed = (cur["batches"] if cur["impl"] == "numpy"
                else cur["epoch"] * 8 + cur["pos"] // 4)
    assert t.effective_batch == 8 and consumed == 6
    print(json.dumps({"transformer_lamb_losses": losses}))
