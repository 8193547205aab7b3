"""The port's Trainer and ``launch train`` (``distributedmnist_tpu_torch/
train/loop.py``, ``launch/__main__.py``) on the CPU, and its
checkpoints against the reference Trainer's.

* The transformer trains through the Trainer at
  ``tests/test_transformer_train.py``'s ``lm_config``: next-token loss
  falls by more than 0.5 in 40 steps and test loss ends under 3.0.
* Checkpoints cross both ways: the port resumes a reference run at its
  saved step and data cursor (equal params digests), continues it to
  within float32 tolerance of the reference's own uninterrupted run,
  and the reference resumes the port's checkpoint (equal digests).
* ``train_log.jsonl`` and ``recovery_journal.jsonl`` records pass the
  reference's ``obsv/schema.py``.
* ``launch train`` prints the reference's summary line; without
  ``--device`` it wants ``cuda:0`` and raises on a machine without one.
* The MNIST CNN over 8 simulated replicas: ``launch train --config
  configs/quorum_k4_of_8.json mesh.simulate_devices=8
  data.dataset=synthetic`` takes 40 steps with 4 contributors each
  (every step applied, loss falling); a CNN run's interval-mode
  checkpoint (window, clock, 8-replica world) restores in the
  reference's Trainer bitwise on params and window, and the reference's
  restores in the port's; ``configs/basic.json`` (synthetic, float32)
  reaches ``tests/test_train_smoke.py``'s band at its step count: the
  loss falls over 40 steps, as the reference's does.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.obsv.schema import validate_event
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.launch.__main__ import main
from distributedmnist_tpu_torch.models.convert import params_to_reference
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

# tests/test_transformer_train.py lm_config, one replica
LM = {"data": {"dataset": "synthetic_lm", "batch_size": 32,
               "synthetic_train_size": 512, "synthetic_test_size": 128,
               "use_native_pipeline": False},
      "model": {"name": "transformer", "seq_len": 64, "model_dim": 64,
                "num_heads": 4, "num_layers": 2, "vocab_size": 32,
                "compute_dtype": "float32"},
      "optim": {"initial_learning_rate": 0.05,
                "learning_rate_decay_factor": 1.0},
      "mesh": {"num_replicas": 1}}
# a smaller run for the cross-package checks (the reference's Pallas
# kernels are interpreted on the CPU)
SMALL = {"data": {"dataset": "synthetic_lm", "batch_size": 8,
                  "synthetic_train_size": 40, "synthetic_test_size": 16,
                  "use_native_pipeline": False},
         "model": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                   "num_heads": 2, "num_layers": 1, "vocab_size": 16,
                   "compute_dtype": "float32"},
         "optim": {"initial_learning_rate": 0.05,
                   "learning_rate_decay_factor": 1.0, "momentum": 0.9},
         "mesh": {"num_replicas": 1}}


def _cfg(base, train_dir, cls=ExperimentConfig, **train):
    t = {"max_steps": 40, "log_every_steps": 10, "train_dir": str(train_dir),
         "save_interval_steps": 0, "save_results_period": 0,
         "summary_every_steps": 0}
    return cls.from_dict(dict(base, train=dict(t, **train)))


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_schema(path):
    recs = _records(path)
    assert recs
    for r in recs:
        assert validate_event(r, source=path.name) == [], r
    return recs


def test_transformer_trains_through_trainer(tmp_path):
    t = Trainer(_cfg(LM, tmp_path), device="cpu")
    losses = []
    s = t.run(step_callback=lambda step, rec: losses.append(rec["loss"]))
    assert s["final_step"] == 40 and s["updates_applied"] == 40
    assert len(losses) == 40
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
    ev = t.evaluate("test")
    assert ev["loss"] < 3.0 and 0.0 < ev["accuracy"] <= 1.0
    assert ev["num_examples"] == 128
    recs = _assert_schema(tmp_path / "train_log.jsonl")
    assert [r["event"] for r in recs] == (["compile"] + ["step"] * 40
                                          + ["save", "eval"])
    assert s["params_digest"] == ckpt.checkpoint_params_digest(tmp_path)[0]


def test_checkpoints_cross_both_ways(tmp_path):
    ref_dir, port_dir, straight = (tmp_path / n for n in ("r", "p", "s"))
    # the reference trains 2 steps and saves (params, momentum, cursor)
    RefTrainer(_cfg(SMALL, ref_dir, RefConfig, max_steps=2)).run()
    digest, step = ref_ckpt.checkpoint_params_digest(ref_dir)
    assert ckpt.checkpoint_params_digest(ref_dir) == (digest, step)
    # the port resumes it at step 2 and runs to 4
    for f in ref_dir.glob("ckpt-*"):
        (port_dir / f.name).parent.mkdir(exist_ok=True)
        (port_dir / f.name).write_bytes(f.read_bytes())
    (port_dir / "checkpoint.json").write_bytes(
        (ref_dir / "checkpoint.json").read_bytes())
    pt = Trainer(_cfg(SMALL, port_dir, max_steps=4, keep_checkpoints=2),
                 device="cpu")
    assert pt.state.step == 2 and pt.state.updates_applied == 2
    assert ckpt.params_digest(params_to_reference(pt.state.params)) == digest
    assert pt.train_iter.state()["batches"] == 2
    s = pt.run()
    assert s["final_step"] == 4
    # ... within float32 of the reference's own uninterrupted 4 steps
    rt = RefTrainer(_cfg(SMALL, straight, RefConfig, max_steps=4))
    rt.run()
    for a, b in zip(jax.tree.leaves(jax.device_get(rt.state.params)),
                    jax.tree.leaves(params_to_reference(pt.state.params))):
        np.testing.assert_allclose(b, np.asarray(a), atol=2e-6, rtol=1e-5)
    # the reference resumes the port's checkpoint at step 4
    back = RefTrainer(_cfg(SMALL, port_dir, RefConfig, max_steps=4))
    assert int(back.state.step) == 4
    assert ref_ckpt.state_params_digest(back.state) == s["params_digest"] \
        == ref_ckpt.checkpoint_params_digest(port_dir)[0]
    extra, _ = ref_ckpt.read_checkpoint_extra(port_dir)
    assert extra["world"] == {"num_replicas": 1, "process_count": 1,
                              "mesh": {}}
    assert extra["data_iter"]["batches"] == 4
    # keep_checkpoints=2: steps 2 and 4 stay (the final save rewrote 4)
    assert ckpt.loadable_steps(port_dir) == [2, 4]


def test_save_cadence_gc_and_resume_continue(tmp_path):
    cfg = _cfg(SMALL, tmp_path, max_steps=6, save_interval_steps=2,
               keep_checkpoints=2, log_every_steps=4,
               save_results_period=3)
    s = Trainer(cfg, device="cpu").run()
    assert ckpt.loadable_steps(tmp_path) == [4, 6]
    assert not (tmp_path / "ckpt-00000002.msgpack.sha256").exists()
    assert np.load(tmp_path / "time_acc.npy").shape == (6, 4)
    again = Trainer(_cfg(SMALL, tmp_path, max_steps=8), device="cpu")
    assert again.state.step == 6
    s2 = again.run()
    assert s2["final_step"] == 8 and s2["updates_applied"] == 8
    steps = [r["step"] for r in _assert_schema(tmp_path / "train_log.jsonl")
             if r["event"] == "step"]
    assert steps == list(range(1, 9))  # a resume appends to the series
    assert s["params_digest"] != s2["params_digest"]


def test_nan_guard_rolls_back_to_the_last_finite_checkpoint(tmp_path):
    t = Trainer(_cfg(SMALL, tmp_path, max_steps=8, save_interval_steps=2,
                     log_every_steps=2), device="cpu")
    step_fn, poisoned = t.step_fn, []

    def poisoning_step(state, batch):
        if state.step == 4 and not poisoned:  # one transient corruption
            poisoned.append(True)
            state.params["embed"].fill_(float("nan"))
        return step_fn(state, batch)

    t.step_fn = poisoning_step
    s = t.run()
    assert s["nan_rollbacks"] == 1 and s["final_step"] == 8
    recs = _assert_schema(tmp_path / "recovery_journal.jsonl")
    assert [r["action"] for r in recs] == ["nonfinite_loss_detected",
                                           "nan_rollback"]
    assert recs[1]["from_step"] == 5 and recs[1]["to_step"] == 4
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(
        params_to_reference(t.state.params)))


def test_sigterm_flushes_a_resumable_checkpoint(tmp_path):
    t = Trainer(_cfg(SMALL, tmp_path, max_steps=50, log_every_steps=1),
                device="cpu")
    s = t.run(step_callback=lambda step, rec: step == 3 and os.kill(
        os.getpid(), signal.SIGTERM))
    assert s["preempted"] == "SIGTERM" and s["final_step"] == 3
    assert ckpt.latest_checkpoint_step(tmp_path) == 3
    recs = _assert_schema(tmp_path / "recovery_journal.jsonl")
    assert recs[-1]["action"] == "preempt_flush"


def test_launch_train_prints_summary_and_wants_cuda(tmp_path, capsys):
    args = ["train", "--config", "configs/synthetic_lm_transformer.json",
            "train.max_steps=3", f"train.train_dir={tmp_path}",
            "model.num_layers=1", "data.synthetic_train_size=256",
            "data.synthetic_test_size=64"]
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        main(args + ["--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["summary"]["final_step"] == 3
        assert line["test"]["num_examples"] == 64
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    finally:
        os.chdir(cwd)


def test_unported_loop_knobs_raise(tmp_path):
    """The profiler windows build a Trainer now (each knob; both set is
    refused when the run starts, tests/test_torch_profiler.py);
    accumulation builds (its effective batch counts every
    microbatch)."""
    for knob in ({"profile_steps": [1, 3]}, {"trace_every_steps": 5}):
        t = Trainer(_cfg(SMALL, tmp_path, **knob), device="cpu")
        assert isinstance(t, Trainer)
    t = Trainer(_cfg(SMALL, tmp_path, grad_accum_steps=2), device="cpu")
    assert t.effective_batch == 2 * SMALL["data"]["batch_size"]
    # train.durability is ported: a known policy builds, an unknown one
    # is the reference's ConfigError
    from distributedmnist_tpu_torch.core.config import ConfigError
    from distributedmnist_tpu_torch.train import storage
    try:
        Trainer(_cfg(SMALL, tmp_path, durability="full"), device="cpu")
        assert storage.durability() == "full"
        with pytest.raises(ConfigError, match="valid policies"):
            Trainer(_cfg(SMALL, tmp_path, durability="paranoid"),
                    device="cpu")
    finally:
        storage.set_durability("none")


# tests/conftest.py base_config for the CNN, as the reference's smoke
# tests run it (8 replicas on the forced CPU mesh)
CNN = {"data": {"dataset": "synthetic", "batch_size": 64,
                "synthetic_train_size": 1024, "synthetic_test_size": 256,
                "use_native_pipeline": False},
       "model": {"compute_dtype": "float32"}}


def test_cnn_quorum_run_through_launch(tmp_path, capsys):
    main(["train", "--config", "configs/quorum_k4_of_8.json",
          "mesh.simulate_devices=8", "data.dataset=synthetic",
          "data.synthetic_train_size=2048", "data.synthetic_test_size=256",
          "train.max_steps=40", f"train.train_dir={tmp_path}",
          "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["summary"]["final_step"] == 40
    assert line["summary"]["updates_applied"] == 40
    recs = _assert_schema(tmp_path / "train_log.jsonl")
    steps = [r for r in recs if r["event"] == "step"]
    assert len(steps) == 40
    assert all(r["num_contributors"] == 4.0 and sum(r["flags"]) == 4
               and len(r["flags"]) == 8 for r in steps)
    first, last = (np.mean([r["loss"] for r in steps[i:i + 10]])
                   for i in (0, 30))
    assert last < first, (first, last)
    _, extra, _ = ckpt.restore_state(tmp_path)
    assert extra["world"] == {"num_replicas": 8, "process_count": 1,
                              "mesh": {"replica": 8}}


def test_cnn_checkpoints_cross_both_ways(tmp_path, topo8):
    over = {"sync": {"mode": "interval", "interval_ms": 120.0,
                     "straggler_profile": "lognormal",
                     "straggler_mean_ms": 50.0},
            "optim": {"momentum": 0.9}}
    base = {**CNN, **over}
    port_dir, ref_dir = tmp_path / "p", tmp_path / "r"
    pt = Trainer(_cfg(base, port_dir, max_steps=5), device="cpu")
    assert pt.topo.num_replicas == 1
    base8 = {**base, "mesh": {"num_replicas": 8}}
    pt = Trainer(_cfg(base8, port_dir, max_steps=5), device="cpu")
    pt.run()
    assert pt.state.window_acc is not None and pt.state.wall_ms > 0
    # the reference resumes the port's run: params, slots, window, clock
    rt = RefTrainer(_cfg(base8, port_dir, RefConfig, max_steps=5), topo8)
    assert int(rt.state.step) == 5
    for got, want in ((rt.state.params, pt.state.params),
                      (rt.state.momentum, pt.state.momentum),
                      (rt.state.window_acc, pt.state.window_acc)):
        for a, b in zip(jax.tree.leaves(jax.device_get(got)),
                        jax.tree.leaves(params_to_reference(want))):
            np.testing.assert_array_equal(np.asarray(a), b)
    for f in ("window_rounds", "wall_ms", "next_apply_ms"):
        assert float(getattr(rt.state, f)) == getattr(pt.state, f)
    # the port resumes the reference's run
    RefTrainer(_cfg(base8, ref_dir, RefConfig, max_steps=3), topo8).run()
    digest, step = ref_ckpt.checkpoint_params_digest(ref_dir)
    back = Trainer(_cfg(base8, ref_dir, max_steps=3), device="cpu")
    assert back.state.step == step == 3
    assert ckpt.params_digest(params_to_reference(back.state.params)) \
        == digest


def test_cnn_basic_config_trains_like_the_reference_smoke(tmp_path):
    """``configs/basic.json`` on synthetic data in float32, at
    ``test_sync_training_reduces_loss``'s 40 steps and 10-step log."""
    t = Trainer(_cfg(json.loads(open("configs/basic.json").read())
                     | {"data": CNN["data"], "model": CNN["model"]},
                     tmp_path, max_steps=40, log_every_steps=10),
                device="cpu")
    losses = []
    s = t.run(step_callback=lambda step, rec: losses.append(rec["loss"]))
    assert s["final_step"] == 40 and s["updates_applied"] == 40
    assert losses[-1] < losses[0]
    ev = t.evaluate("test")
    assert ev["num_examples"] == 256 and 0.0 < ev["accuracy"] <= 1.0


def test_noop_knobs_log_one_line_each(tmp_path, caplog):
    """Knobs the port accepts and does not run log one line each at
    Trainer build: a default config asks for device prefetch and
    ``compile.aot_executable_cache``; ``trust_cache_cross_process`` only
    when set, and nothing is logged for a knob turned off.
    ``compile.precompile`` runs (the train step is bound, and captured
    on the card) and logs no such line."""
    import logging
    port_logger = logging.getLogger("distributedmnist_tpu_torch")
    port_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=port_logger.name):
            Trainer(_cfg(SMALL, tmp_path), device="cpu")
        lines = [r.getMessage() for r in caplog.records
                 if "is a no-op in the port" in r.getMessage()]
        assert sorted(m.split()[0] for m in lines) == [
            "compile.aot_executable_cache", "data.device_prefetch"], lines
        caplog.clear()
        off = dict(SMALL, data=dict(SMALL["data"], device_prefetch=False),
                   compile={"precompile": False,
                            "aot_executable_cache": False,
                            "trust_cache_cross_process": True})
        with caplog.at_level(logging.INFO, logger=port_logger.name):
            Trainer(_cfg(off, tmp_path), device="cpu")
        lines = [r.getMessage() for r in caplog.records
                 if "is a no-op in the port" in r.getMessage()]
        assert [m.split()[0] for m in lines] == [
            "compile.trust_cache_cross_process"], lines
    finally:
        port_logger.removeHandler(caplog.handler)
