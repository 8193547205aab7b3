"""The port's local process cluster on the card
(``distributedmnist_tpu_torch/launch/``):

* a supervised two-worker run of ``launch train``: worker 1 is killed
  at step 10 and a parked standby, its step already captured as CUDA
  graphs, is promoted into its train_dir; it restores a checkpoint of
  step 5 or later into the captured tensors, both workers end bitwise
  equal to an unfaulted run, and the promoted process journals its
  ``compile`` record (``cuda_graph`` on ``cuda:0``) in the adopted
  directory;
* the serving chaos trial (``payload="serving"``) with classification
  replicas on the int8 and bf16 tiers: a replica kill and a corrupt
  publish under live load (``tests/test_servesvc.py:761``'s trial);
* the decode serving chaos trial of ``tests/test_decode.py:637`` (kills
  mid-generation and a torn checkpoint) over the flash publisher of
  ``chip_smoke.py``'s serving_chaos phase (d 2048, 2 layers, paged
  decode), every replica incarnation's decode step captured on
  ``cuda:0`` and its K1 and K5 launches counted.

Needs an NVIDIA GPU and skips with a reason without one. The module
imports torch and the port only — no JAX — so it runs where the
reference is not installed; run it from the repository's root (the
decode trial imports ``chip_smoke``):

    python -m pytest tests/test_torch_cuda_cluster.py -m cuda \\
        --noconftest -p no:cacheprovider
"""

import json
import threading
import time

import pytest
import torch

from distributedmnist_tpu_torch.launch.chaos import ChaosConfig, run_campaign
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


def _replica_launch_records(root, replicas=(1, 2)):
    return {k: load_jsonl(root / f"worker{k}" / "kernel_launches.jsonl")
            for k in replicas}


def test_serving_trial_replica_kill_and_corrupt_publish_quant_tiers(
        card, tmp_path):
    cfg = ChaosConfig(name="servetrial", workdir=str(tmp_path),
                      payload="serving", trials=1, seed=0,
                      until_step=60, save_interval_steps=10,
                      serve_replicas=2, serve_precision_tiers=("int8", "bf16"),
                      shrink=False, trial_timeout_s=420.0)
    summary = run_campaign(cfg)
    assert summary["trials"] == 1
    assert summary["all_green"], summary
    inv = summary["invariants"]
    for name in ("serve_outcomes", "serve_digest", "serve_monotone",
                 "determinism"):
        assert inv[name]["pass"] == 1, (name, inv)
    sv = summary["serving"]
    assert sv["issued"] > 0 and sv["dropped"] == 0, sv
    fired = summary["faults"]["per_trial"][0]
    assert not [f for f in fired["unfired"]
                if f["kind"] in ("kill", "corrupt")], fired
    assert {"int8", "bf16"} <= set(sv["swaps_by_tier"]), sv
    trial = cfg.root / "trial000"
    for k, procs in _replica_launch_records(trial).items():
        assert procs and all(p["device"] == "cuda:0" for p in procs), k


def test_decode_trial_kill_mid_generation_and_torn_checkpoint_flash(
        card, tmp_path):
    import chip_smoke as cs
    from distributedmnist_tpu_torch.ops import _build
    _build.build()  # the libraries the campaign's cache is seeded from
    cfg = ChaosConfig(
        name="decodetrial", workdir=str(tmp_path), payload="serving",
        serve_decode=True, trials=1, seed=0, until_step=60,
        save_interval_steps=10, serve_replicas=2,
        request_deadline_s=10.0, serve_fault_window=(3, 20),
        shrink=False, trial_timeout_s=420.0)
    summary = cs._flash_serving_campaign(cfg).run()
    assert summary["all_green"], summary
    assert summary["faults"]["fired"] > 0, summary["faults"]
    assert summary["faults"]["never_fired"] == 0, summary["faults"]
    sv = summary["serving"]
    assert sv["issued"] > 0 and sv["dropped"] == 0, sv
    assert sv["tokens_streamed"] > 0 and sv["ttft_p99_ms"] is not None
    inv = summary["invariants"]
    assert inv["decode_swap"]["fail"] == 0
    assert inv["decode_swap"]["pass"] + inv["decode_swap"]["skipped"] == 1
    assert inv["determinism"]["pass"] == 1, inv
    trial = cfg.root / "trial000"
    boots = {k: load_jsonl(trial / f"worker{k}" / "train_log.jsonl",
                           "compile") for k in (1, 2)}
    for k, recs in boots.items():
        assert recs and all(r["device"] == "cuda:0"
                            and r["source"] == "cuda_graph"
                            for r in recs), (k, recs)
    # a killed replica was respawned (and its records above are among
    # those checked)
    assert summary["mttr"]["episodes"] >= 1, summary["mttr"]
    procs = [p for ps in _replica_launch_records(trial).values() for p in ps]
    assert procs and all(p["device"] == "cuda:0" for p in procs)
    assert sum(p["launches"]["K1"] for p in procs) > 0, procs
    assert sum(p["launches"]["K5"] for p in procs) > 0, procs
