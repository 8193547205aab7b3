"""CUDA-graph replay against eager steps on the card
(``distributedmnist_tpu_torch/parallel/api.py TrainStep.prepare``,
``parallel/graphs.py``, ``servesvc/decode.py DecodeStep``).

Every test here needs an NVIDIA GPU and skips with a reason without one.
The module imports torch and numpy only — no JAX — so it runs where the
reference is not installed:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda \\
        --noconftest -p no:cacheprovider

* Each captured configuration — the CNN (sync sgd; 8 replicas in quorum
  under momentum with dropout and drop-connect; interval; timeout under
  LARS with accumulation 2), ResNet-20 under LAMB over bf16 masters,
  the transformer through the flash kernels on one replica and on 4
  (the vmap fold), and through dense attention in cdf mode — runs
  ``STEPS`` steps twice from the same start on the same batches: once
  replayed from the graphs ``prepare`` captured, once eagerly. Params,
  slots, losses and counters are bitwise equal (the same kernels on the
  same inputs; cuDNN's deterministic algorithms; no kernel of the port
  reduces with atomics), and the losses move from step to step (the
  graphs read each step's buffers).
* The decode replica under ``pin`` with a swap mid-generation, one
  replica capturing each version's decode step and one running it
  eagerly: every streamed line equal, each version captured.
"""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.core.config import (DecodeConfig,
                                                    ExperimentConfig,
                                                    ServeConfig)
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.parallel.policies import resolve_aggregate_k
from distributedmnist_tpu_torch.servesvc import DecodeReplica
from distributedmnist_tpu_torch.train.loop import Trainer, make_schedule

pytestmark = pytest.mark.cuda

STEPS = 4
CNN = {"data": {"dataset": "synthetic", "batch_size": 64,
                "synthetic_train_size": 256, "synthetic_test_size": 64,
                "use_native_pipeline": False},
       "model": {"compute_dtype": "bfloat16"},
       "optim": {"initial_learning_rate": 0.01,
                 "learning_rate_decay_factor": 1.0}}
LOGNORMAL = {"straggler_profile": "lognormal", "straggler_mean_ms": 50.0}
LM = {"name": "transformer", "seq_len": 64, "model_dim": 128,
      "num_heads": 2, "num_layers": 2, "vocab_size": 64,
      "compute_dtype": "bfloat16", "attention_impl": "flash"}
LM_DATA = {"dataset": "synthetic_lm", "batch_size": 8,
           "synthetic_train_size": 64, "synthetic_test_size": 16,
           "use_native_pipeline": False}
CASES = {
    "cnn_sync_sgd": {**CNN, "mesh": {"num_replicas": 1}},
    "cnn_quorum_momentum": {
        **CNN, "mesh": {"num_replicas": 8},
        "model": {"compute_dtype": "bfloat16", "dropout_rate": 0.5},
        "optim": {"name": "momentum", "momentum": 0.9,
                  "initial_learning_rate": 0.01,
                  "learning_rate_decay_factor": 0.5,
                  "num_epochs_per_decay": 0.5},
        "sync": {"mode": "quorum", "num_replicas_to_aggregate": 5,
                 "drop_connect": True, **LOGNORMAL}},
    "cnn_interval": {**CNN, "mesh": {"num_replicas": 8},
                     "sync": {"mode": "interval", "interval_ms": 120.0,
                              **LOGNORMAL}},
    "cnn_timeout_lars_accum": {
        **CNN, "mesh": {"num_replicas": 8},
        "optim": {"name": "lars", "initial_learning_rate": 0.01,
                  "learning_rate_decay_factor": 1.0},
        "sync": {"mode": "timeout", "timeout_ms": 60.0, **LOGNORMAL},
        "train": {"grad_accum_steps": 2}},
    "resnet_lamb_bf16_masters": {
        "data": {"dataset": "synthetic", "batch_size": 32,
                 "synthetic_train_size": 128, "synthetic_test_size": 32,
                 "use_native_pipeline": False},
        "model": {"name": "resnet20", "image_size": 32, "num_channels": 3,
                  "compute_dtype": "bfloat16"},
        "optim": {"name": "lamb", "initial_learning_rate": 0.01,
                  "learning_rate_decay_factor": 1.0},
        "precision": {"param_dtype": "bfloat16", "master_weights": True},
        "mesh": {"num_replicas": 1}},
    "transformer_flash_one": {"data": LM_DATA, "model": LM,
                              "mesh": {"num_replicas": 1}},
    "transformer_flash_replicas": {
        "data": LM_DATA, "model": LM, "mesh": {"num_replicas": 4},
        "sync": {"mode": "quorum", "num_replicas_to_aggregate": 3,
                 **LOGNORMAL}},
    "transformer_dense_cdf": {
        "data": LM_DATA, "model": {**LM, "attention_impl": "dense"},
        "mesh": {"num_replicas": 2}, "sync": {"mode": "cdf"}},
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on "
                    "the card")
    return torch.device("cuda")


def _run(cfg, dev, feed, capture: bool):
    model = get_model(cfg.model)
    topo = make_topology(cfg.mesh)
    sched = make_schedule(cfg, cfg.data.synthetic_train_size,
                          cfg.data.batch_size * cfg.train.grad_accum_steps,
                          resolve_aggregate_k(cfg.sync, topo.num_replicas))
    step_fn = api.build_train_step(model, cfg, sched, topo)
    state = api.init_train_state(model, cfg, dev, topo)
    if capture:
        info = step_fn.prepare(state, feed[0])
        assert info["source"] == "cuda_graph", info
        assert step_fn.captured and info["graphs"] >= 2
    losses = []
    for b in feed:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    if capture:
        assert step_fn._prepared.replay.replays >= STEPS
    return losses, [t.clone() for t in api._state_tensors(state)], state


@pytest.mark.parametrize("name", list(CASES))
def test_replay_is_bitwise_the_eager_step(dev, name):
    cfg = ExperimentConfig.from_dict(CASES[name])
    t = Trainer(cfg, device=dev)  # its datasets and feed
    feed = []
    for _ in range(STEPS):
        b = next(t.train_iter)
        feed.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in b.items()})
    got_l, got_t, got_s = _run(cfg, dev, feed, capture=True)
    want_l, want_t, want_s = _run(cfg, dev, feed, capture=False)
    assert got_l == want_l
    assert len(set(got_l)) > 1  # every replay read its own step
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
    assert (got_s.step, got_s.updates_applied, got_s.wall_ms) == (
        want_s.step, want_s.updates_applied, want_s.wall_ms)


# -- decode ------------------------------------------------------------------

DEC_MODEL = {"name": "transformer", "seq_len": 64, "model_dim": 64,
             "num_heads": 4, "num_layers": 2, "vocab_size": 32,
             "compute_dtype": "bfloat16", "attention_impl": "flash"}
DECODE = {"decode_slots": 3, "block_size": 8, "num_blocks": 32,
          "max_prompt_len": 16, "max_new_tokens": 10,
          "attention_kernel": "paged", "swap_policy": "pin"}
REQUESTS = {"a": {"prompt": [1, 2, 3], "max_tokens": 8},
            "b": {"prompt": [5, 6, 7, 8, 9], "max_tokens": 8,
                  "temperature": 0.8},
            "c": {"prompt": [4, 5], "max_tokens": 4, "temperature": 0.8}}


class _Conn:
    def __init__(self):
        self.lines = []

    def settimeout(self, t):
        pass

    def gettimeout(self):
        return None

    def sendall(self, b):
        self.lines += [json.loads(x) for x in b.decode().splitlines()]

    def close(self):
        pass


def _publish(src: Path, dst: Path, step: int) -> None:
    name = f"ckpt-{step:08d}.msgpack"
    dst.mkdir(parents=True, exist_ok=True)
    for sfx in ("", ".sha256"):
        shutil.copy2(src / (name + sfx), dst / (name + sfx))
    tmp = dst / "checkpoint.json.tmp"
    tmp.write_text(json.dumps({"latest_step": step, "latest_path": name,
                               "written_at": time.time()}))
    tmp.replace(dst / "checkpoint.json")


def _drive(rep, src, dst):
    def admit(rid):
        conn = _Conn()
        rep._queue.put_nowait(rep._build_item(
            {"id": rid, "deadline_ms": 600000, **REQUESTS[rid]}, conn))
        return conn
    rep._load_initial()
    conns = {r: admit(r) for r in ("a", "b")}
    rep._admit_new()
    rep._step_active()
    rep._step_active()
    _publish(src, dst, 4)
    got = rep.follower.poll(rep._read_weights)
    assert got is not None and got[0] == "swap"
    rep._staged = got[1:]
    rep._maybe_swap()
    conns["c"] = admit("c")
    rep._admit_new()
    while any(s is not None for s in rep._slots):
        rep._step_active()
    return {r: c.lines for r, c in conns.items()}


def test_decode_replay_over_a_pin_swap_is_the_eager_decode(dev, tmp_path):
    train_dir = tmp_path / "train"
    cfg = ExperimentConfig.from_dict({
        "model": DEC_MODEL, "decode": DECODE, "data": LM_DATA,
        "mesh": {"num_replicas": 1},
        "train": {"max_steps": 4, "save_interval_steps": 2,
                  "keep_checkpoints": 2, "train_dir": str(train_dir),
                  "save_results_period": 0, "summary_every_steps": 0}})
    Trainer(cfg, device="cpu").run()
    out = {}
    for capture in (True, False):
        dst = tmp_path / f"serve{int(capture)}"
        _publish(train_dir, dst / "publish", 2)
        run_cfg = cfg.override({"compile.precompile": capture})
        rep = DecodeReplica(dst / "publish", serve_dir=dst / "serve",
                            scfg=ServeConfig(poll_secs=0.05),
                            dcfg=DecodeConfig(**DECODE), cfg=run_cfg,
                            device=dev)
        out[capture] = (_drive(rep, train_dir, dst / "publish"), rep)
    (lines, rep), (want, eager) = out[True], out[False]
    assert lines == want
    assert [r[-1]["status"] for r in lines.values()] == ["ok"] * 3
    assert [i["source"] for i in rep.decode_compiles] == ["cuda_graph"] * 2
    assert [i["source"] for i in eager.decode_compiles] == ["eager"] * 2
    assert rep.version_steps > rep.decode_iterations  # two live at once
    assert not rep._versions

