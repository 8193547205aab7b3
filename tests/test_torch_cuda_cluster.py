"""A supervised two-worker run of the port's ``launch train`` on the card
(``distributedmnist_tpu_torch/launch/``): worker 1 is killed at step 10
and a parked standby, its step already captured as CUDA graphs, is
promoted into its train_dir; it restores a checkpoint of step 5 or
later into the captured tensors, both workers end bitwise equal to an
unfaulted run, and the promoted process journals its ``compile`` record
(``cuda_graph`` on ``cuda:0``) in the adopted directory.

Needs an NVIDIA GPU and skips with a reason without one. The module
imports torch and the port only — no JAX — so it runs where the
reference is not installed:

    python -m pytest tests/test_torch_cuda_cluster.py -m cuda \\
        --noconftest -p no:cacheprovider
"""

import json
import threading
import time

import pytest
import torch

from distributedmnist_tpu_torch.launch.chaos import ChaosConfig
from distributedmnist_tpu_torch.launch.cluster import (LocalClusterConfig,
                                                       LocalProcessCluster)
from distributedmnist_tpu_torch.launch.exec import (CommandExecutor,
                                                    FaultPlan, RetryPolicy)
from distributedmnist_tpu_torch.launch.supervisor import (ClusterSupervisor,
                                                          SupervisorConfig)
from distributedmnist_tpu_torch.obsv.report import load_jsonl
from distributedmnist_tpu_torch.train.checkpoint import (
    checkpoint_params_digest)

pytestmark = pytest.mark.cuda

STEPS = 40
ZERO1 = "parallel.shard_weight_update=true parallel.comm_buckets=2 "
# the chaos train payload (the MNIST CNN, 2 simulated replicas, momentum,
# float32) without its ZeRO-1 update, which runs eagerly: this step is
# captured; paced so the poll sees step 10
CHAOS_PAYLOAD = (ChaosConfig(until_step=STEPS, save_interval_steps=5)
                 .resolved_train_command())
PAYLOAD = CHAOS_PAYLOAD.replace(ZERO1, "") + " train.step_pace_ms=150"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the workers run the port on the "
                    "card")


def _cluster(root, name, workers, plan=None):
    cfg = LocalClusterConfig(name=name, num_workers=workers,
                             workdir=str(root), train_command=PAYLOAD)
    return LocalProcessCluster(cfg, CommandExecutor(
        journal=cfg.root / "command_journal.jsonl",
        retry=RetryPolicy(max_attempts=1), fault_plan=plan))


def _wait_done(c, timeout_s=240.0):
    deadline = time.monotonic() + timeout_s
    while any(w["alive"] for w in c.status()["workers"]):
        assert time.monotonic() < deadline, "workers still running"
        time.sleep(0.5)


def test_kill_and_standby_promotion_end_bitwise_equal(card, tmp_path):
    assert ZERO1 in CHAOS_PAYLOAD and "shard_weight_update" not in PAYLOAD
    whole = _cluster(tmp_path, "whole", 1)
    whole.create()
    whole.run_train()
    _wait_done(whole)
    want = checkpoint_params_digest(whole.cfg.worker_dir(0))
    assert [r["source"] for r in load_jsonl(
        whole.cfg.worker_dir(0) / "train_log.jsonl", "compile")] == [
            "cuda_graph"]

    c = _cluster(tmp_path, "faulted", 2, FaultPlan(kill_worker_at_step={1: 10}))
    c.create()
    c.ensure_standbys(1)
    deadline = time.monotonic() + 240.0
    while not any(sb["ready"] for sb in c.status().get("standbys", [])):
        assert time.monotonic() < deadline, "the standby never parked"
        time.sleep(0.3)
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=1, restart_backoff_s=0.1,
        standby_workers=1))
    c.run_train()
    done = {}
    th = threading.Thread(target=lambda: done.update(
        got=sup.supervise_until_step(STEPS, poll_secs=0.3,
                                     timeout_secs=240.0)), daemon=True)
    th.start()
    th.join(timeout=260.0)
    try:
        assert "got" in done
        restart = next(e for e in sup.events if e["action"] == "restart")
        assert restart["worker"] == 1 and restart["via"] == "standby"
        _wait_done(c)
    finally:
        c.kill_all()
    for k in (0, 1):
        assert checkpoint_params_digest(c.cfg.worker_dir(k)) == want, k
    log = load_jsonl(c.cfg.worker_dir(1) / "train_log.jsonl")
    at = [i for i, r in enumerate(log) if r.get("event") == "compile"]
    assert len(at) == 2, log  # the first incarnation's, and the promoted
    # standby's, journaled in the adopted directory
    assert all(log[i]["device"] == "cuda:0"
               and log[i]["source"] == "cuda_graph" for i in at)
    # the standby's first step follows the checkpoint it restored
    first = next(r["step"] for r in log[at[1] + 1:]
                 if r.get("event") == "step")
    assert first - 1 >= 5, log[at[1]:at[1] + 3]
    steps = [r["step"] for r in log if r.get("event") == "step"]
    assert steps[-1] == STEPS and steps.count(STEPS) == 1
    act = json.loads((c.cfg.root / "standby0" / "activate.json").read_text())
    assert act == {"train_dir": str(c.cfg.worker_dir(1)), "worker": 1}
