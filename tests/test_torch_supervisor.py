"""The port's self-healing supervisor (``distributedmnist_tpu_torch/
launch/supervisor.py``) held to the reference's: restarts within a
budget with resume from checkpoints, degraded quorum, stall detection,
warm-standby promotion with MTTR, elastic shrink and grow — over real
worker processes running the reference tests' resuming shell payload —
and the worker side of the standby protocol on the port's own trainer:
a parked, precompiled ``Trainer`` adopts a dead worker's train_dir and
finishes its run bitwise equal to an unfaulted one, in process and as
a promoted ``launch train --device cpu`` standby."""

import json
import threading
import time

import pytest

from distributedmnist_tpu.launch import supervisor as ref_supervisor
from distributedmnist_tpu.obsv import journal as ref_journal
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.launch import supervisor as pt_supervisor
from distributedmnist_tpu_torch.launch.cluster import ClusterError
from distributedmnist_tpu_torch.launch.exec import FaultPlan
from distributedmnist_tpu_torch.launch.supervisor import (ClusterSupervisor,
                                                          SupervisorConfig)
from distributedmnist_tpu_torch.obsv import journal as pt_journal
from distributedmnist_tpu_torch.obsv.journal import (load_reconfigure_events,
                                                     load_recovery_events,
                                                     summarize_recovery)
from distributedmnist_tpu_torch.train.checkpoint import (
    checkpoint_params_digest)
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_cluster import (RESUMING_LOOP, STANDBY_LOOP, boots,
                            make_cluster)


def _cluster(tmp_path, **kw):
    kw.setdefault("train_command", RESUMING_LOOP)
    return make_cluster(tmp_path, name="sup", **kw)


# ---------------------------------------------------------------------------
# recovery over shell-payload workers
# ---------------------------------------------------------------------------

def test_restart_killed_worker_resumes_from_checkpoint(tmp_path):
    c = _cluster(tmp_path, fault_plan=FaultPlan(kill_worker_at_step={1: 7}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=2, max_restarts_per_worker=2, restart_backoff_s=0.1))
    got = sup.run_until_step(45, poll_secs=0.2, timeout_secs=120.0)
    assert got["step"] >= 45
    assert got["recovery"]["restarts_by_worker"] == {1: 1}
    assert "below_quorum_abort" not in got["recovery"]["by_action"]
    s = summarize_recovery(c.exec.journal_path)
    chain = [a for a in s["by_worker"][1]
             if a in ("detect", "restart", "resume")]
    assert chain == ["detect", "restart", "resume"]
    # the reference's reader tells the same story from the port's journal
    assert ref_journal.summarize_recovery(c.exec.journal_path) == s
    b = boots(c, 1)
    assert len(b) == 2 and b[0] == 0 and b[1] > 0 and b[1] % 5 == 0, b
    c.delete()


def test_degraded_quorum_and_below_quorum_abort(tmp_path):
    c = _cluster(tmp_path / "a",
                 fault_plan=FaultPlan(kill_worker_at_step={0: 3}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=0))
    got = sup.run_until_step(20, poll_secs=0.2, timeout_secs=60.0)
    assert got["step"] >= 20  # reached through worker 1's log
    assert got["recovery"]["by_action"].get("restart_budget_exhausted") == 1
    c.delete()
    c = _cluster(tmp_path / "b",
                 fault_plan=FaultPlan(kill_worker_at_step={1: 2}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=2, max_restarts_per_worker=0))
    with pytest.raises(ClusterError, match="< quorum 2"):
        sup.run_until_step(50, poll_secs=0.2, timeout_secs=120.0)
    assert any(r["action"] == "below_quorum_abort"
               for r in load_recovery_events(c.exec.journal_path))
    assert not load_reconfigure_events(c.exec.journal_path)
    time.sleep(0.2)
    assert not any(w["alive"] for w in c.status()["workers"])
    c.delete()


def test_hung_worker_detected_by_stall_and_restarted(tmp_path):
    c = _cluster(tmp_path, fault_plan=FaultPlan(hang_worker_at_step={1: 3}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=2, restart_backoff_s=0.1,
        stall_timeout_s=1.0))
    got = sup.run_until_step(70, poll_secs=0.2, timeout_secs=120.0)
    assert got["step"] >= 70
    hung = [r for r in load_recovery_events(c.exec.journal_path)
            if r["action"] == "detect" and r.get("kind") == "hung"]
    assert hung and hung[0]["worker"] == 1
    assert summarize_recovery(c.exec.journal_path)["resume_steps"].get(
        1, -1) >= 0
    c.delete()


def test_standby_promotion_resumes_worker_with_mttr(tmp_path):
    c = _cluster(tmp_path, fault_plan=FaultPlan(kill_worker_at_step={1: 7}),
                 standby_command=STANDBY_LOOP)
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=2, restart_backoff_s=0.1,
        standby_workers=1))
    got = sup.run_until_step(60, poll_secs=0.2, timeout_secs=120.0)
    assert got["step"] >= 60
    restart = next(e for e in sup.events if e["action"] == "restart")
    assert restart["via"] == "standby"
    resume = next(e for e in sup.events if e["action"] == "resume")
    assert resume["mttr_s"] > 0
    assert resume["detected_at"] <= resume["respawned_at"]
    mttr = got["recovery"]["mttr"]
    assert mttr["episodes"] == 1 and mttr["p50_s"] == mttr["max_s"] > 0
    b = boots(c, 1)
    assert len(b) == 2 and b[1] > 0 and b[1] % 5 == 0, b
    state = json.loads(c.state_path.read_text())
    assert [sb["standby"] for sb in state["standbys"]] == [1]  # back-filled
    c.delete()


def test_no_ready_standby_falls_back_to_cold_restart(tmp_path):
    c = _cluster(tmp_path, fault_plan=FaultPlan(kill_worker_at_step={1: 7}),
                 standby_command="sleep 600")
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=2, restart_backoff_s=0.1,
        standby_workers=1))
    got = sup.run_until_step(45, poll_secs=0.2, timeout_secs=120.0)
    restart = next(e for e in sup.events if e["action"] == "restart")
    assert got["step"] >= 45 and restart["via"] == "respawn"
    c.delete()


def test_elastic_shrink_below_quorum_reconfigures_and_finishes(tmp_path):
    c = _cluster(tmp_path, num_workers=3,
                 fault_plan=FaultPlan(kill_worker_at_step={2: 7}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=3, max_restarts_per_worker=0, elastic=True, min_workers=2,
        reconfigure_drain_s=5.0))
    got = sup.run_until_step(40, poll_secs=0.2, timeout_secs=120.0)
    assert got["step"] >= 40
    tr = got["recovery"]["reconfigure"]["transitions"][0]
    assert (tr["old_world"], tr["new_world"]) == (3, 2)
    assert tr["trigger"] == "below_quorum" and tr["effective_quorum"] == 2
    assert tr["reconfigure_s"] > 0
    recs = load_reconfigure_events(c.exec.journal_path)
    assert [r["action"] for r in recs] == ["begin", "reshape",
                                           "relaunched", "resume"]
    assert ref_journal.summarize_reconfigures(c.exec.journal_path) == \
        pt_journal.summarize_reconfigures(c.exec.journal_path)
    for k in (0, 1):
        b = boots(c, k)
        assert len(b) == 2 and b[1] > 0 and b[1] % 5 == 0, b
    c.delete()


def test_reconfigure_grow_promotes_standby_and_seeds_checkpoint(tmp_path):
    c = _cluster(tmp_path, standby_command=STANDBY_LOOP)
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(quorum=1,
                                                standby_workers=1))
    c.run_train()
    c.ensure_standbys(1)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        prog = c.worker_progress()
        if (prog and min(prog.values()) >= 6
                and any(s["ready"] for s in c.status().get("standbys", []))):
            break
        time.sleep(0.2)
    rec = sup.reconfigure(3, trigger="manual")
    assert (rec["old_world"], rec["new_world"]) == (2, 3)
    assert rec["grown"] == {"2": 0}
    try:
        got = sup.supervise_until_step(40, poll_secs=0.2,
                                       timeout_secs=120.0)
    finally:
        c.kill_all()
    assert got["step"] >= 40
    tr = got["recovery"]["reconfigure"]["transitions"][0]
    assert tr["via"]["2"] == "standby"
    b = boots(c, 2)
    assert b[0] > 0 and b[0] % 5 == 0, b
    c.delete()


def test_grow_seeds_only_newest_checkpoint(tmp_path):
    c = _cluster(tmp_path, num_workers=1)
    c.create()
    src = c.cfg.worker_dir(0)
    for s in (5, 10):
        (src / f"ckpt-{s:08d}.msgpack").write_bytes(b"x" * 8)
        (src / f"ckpt-{s:08d}.msgpack.sha256").write_text("y")
    (src / "checkpoint.json").write_text(json.dumps(
        {"latest_step": 10, "latest_path": "ckpt-00000010.msgpack"}))
    rec = c.reconfigure(2)
    assert rec["grown"] == {"1": 0}
    seeded = sorted(p.name for p in c.cfg.worker_dir(1).glob("ckpt*"))
    assert seeded == ["ckpt-00000010.msgpack",
                      "ckpt-00000010.msgpack.sha256"]
    c.delete()


def test_wait_drained_covers_whole_process_group(tmp_path):
    slow_flush = (
        "python3 -c \""
        "import signal, sys, time\n"
        "def h(*a):\n"
        "    time.sleep(1.5)\n"
        "    open('flushed', 'w').write('1')\n"
        "    sys.exit(75)\n"
        "signal.signal(signal.SIGTERM, h)\n"
        "open('ready', 'w').write('1')\n"
        "[time.sleep(0.1) for _ in range(600)]\"")
    c = _cluster(tmp_path, num_workers=1, train_command=slow_flush)
    c.create()
    c.run_train()
    deadline = time.monotonic() + 10.0
    while (not (c.cfg.worker_dir(0) / "ready").exists()
           and time.monotonic() < deadline):
        time.sleep(0.1)
    t0 = time.monotonic()
    c.stop_all()
    assert c.wait_drained(10.0, poll_secs=0.2)
    assert (c.cfg.worker_dir(0) / "flushed").exists()
    assert time.monotonic() - t0 >= 1.0
    c.delete()


# ---------------------------------------------------------------------------
# tick-level policy against the reference (scripted backends)
# ---------------------------------------------------------------------------

class _ScriptedBackend:
    def __init__(self, script):
        self.script = script  # [(step, {worker: alive}, {worker: step})]
        self.tick = 0
        self.restarted = []

    def _frame(self):
        return self.script[min(self.tick, len(self.script) - 1)]

    def poll(self):
        step, alive, prog = self._frame()
        self.tick += 1
        return {"step": step,
                "workers": [{"worker": k, "alive": a}
                            for k, a in alive.items()],
                "worker_progress": dict(prog)}

    def worker_progress(self):
        return dict(self._frame()[2])

    def restart_worker(self, k):
        self.restarted.append(k)

    def kill_all(self, worker="all"):
        pass


_SCRIPTS = {
    "resume_on_target_tick": [(5, {0: True, 1: False}, {0: 5, 1: 4}),
                              (10, {0: True, 1: True}, {0: 10, 1: 6})],
    "still_booting_at_target": [(5, {0: True, 1: False}, {0: 5, 1: 4}),
                                (10, {0: True, 1: True}, {0: 10, 1: 4})],
    "two_deaths": [(3, {0: True, 1: False}, {0: 3, 1: 2}),
                   (6, {0: True, 1: True}, {0: 6, 1: 3}),
                   (8, {0: False, 1: True}, {0: 7, 1: 5}),
                   (10, {0: True, 1: True}, {0: 8, 1: 10})],
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_scripted_episodes_match_the_reference(name):
    def drive(mod):
        backend = _ScriptedBackend(_SCRIPTS[name])
        sup = mod.ClusterSupervisor(backend, mod.SupervisorConfig(
            quorum=1, max_restarts_per_worker=2, restart_backoff_s=0.0))
        got = sup.supervise_until_step(10, poll_secs=0.01,
                                       timeout_secs=10.0)
        return (backend.restarted, sorted(sup.open_episodes),
                [(e["action"], e.get("worker"), e.get("step"))
                 for e in sup.events], got["recovery"]["mttr"]["episodes"],
                got["recovery"]["mttr"]["unrecovered"])

    assert drive(pt_supervisor) == drive(ref_supervisor)


def test_close_episode_and_mttr_summaries_match_the_reference():
    backend = _ScriptedBackend(_SCRIPTS["still_booting_at_target"])
    sup = ClusterSupervisor(backend, SupervisorConfig(
        quorum=1, max_restarts_per_worker=2, restart_backoff_s=0.0))
    sup.supervise_until_step(10, poll_secs=0.01, timeout_secs=10.0)
    assert sup.open_episodes == {1}
    sup.close_episode(1, step=7)
    sup.close_episode(1, step=8)  # idempotent
    assert sum(e["action"] == "resume" for e in sup.events) == 1
    assert sup.summary()["mttr"]["episodes"] == 1
    events = []
    for k, m in ((0, 2.0), (1, 4.0), (1, 10.0)):
        events.append({"action": "detect", "worker": k, "time": 100.0})
        events.append({"action": "resume", "worker": k, "time": 100.0 + m,
                       "mttr_s": m, "resume_after_respawn_s": m / 2})
    for recs in (events,
                 [{"action": "detect", "worker": 0, "time": 50.0},
                  {"action": "resume", "worker": 0, "time": 53.5}],
                 [{"action": "detect", "worker": 1, "time": 10.0},
                  {"action": "episode_superseded", "worker": 1,
                   "by": "reconfigure", "time": 12.0}], []):
        assert pt_journal.summarize_mttr(recs) == \
            ref_journal.summarize_mttr(recs)


@pytest.mark.parametrize("quorum, world", [(3, 2), (3, 5), (3, 1), (1, 4)])
def test_quorum_rescale_is_the_reference(quorum, world):
    assert SupervisorConfig(quorum=quorum).rescaled_quorum(world) == \
        ref_supervisor.SupervisorConfig(quorum=quorum).rescaled_quorum(world)


def test_supervisor_config_file_and_cli_dry_run(tmp_path, capsys):
    from distributedmnist_tpu_torch.launch.cluster import main
    p = tmp_path / "s.json"
    p.write_text(json.dumps({"quorum": 2, "standby_workers": 1}))
    got = SupervisorConfig.from_file(p)
    want = ref_supervisor.SupervisorConfig.from_file(p)
    assert json.dumps(got.__dict__, sort_keys=True) == \
        json.dumps(want.__dict__, sort_keys=True)
    cfgp = tmp_path / "c.json"
    cfgp.write_text(json.dumps({"workdir": str(tmp_path / "w")}))
    main(["supervise", "--config", str(cfgp), "--until-step", "5",
          "--quorum", "2", "--dry-run"])
    assert '"dry_run": true' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the worker side of the standby protocol on the port's trainer
# ---------------------------------------------------------------------------

def _cnn_cfg(train_dir, max_steps):
    return ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic", "batch_size": 32,
                 "synthetic_train_size": 256, "synthetic_test_size": 64,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32", "image_size": 12},
        "mesh": {"num_replicas": 2},
        "optim": {"momentum": 0.9},
        "train": {"max_steps": max_steps, "log_every_steps": 1,
                  "save_interval_steps": 5, "save_results_period": 0,
                  "async_checkpoint": False, "train_dir": str(train_dir)}})


def _log(train_dir):
    return [json.loads(line) for line in
            (train_dir / "train_log.jsonl").read_text().splitlines()]


def test_adopt_train_dir_resumes_into_the_precompiled_trainer(tmp_path):
    """The unfaulted run, and a run cut at step 5 whose train_dir a
    parked (precompiled) trainer adopts: the adopted run resumes at 5,
    journals its compile record again in the adopted dir, and ends
    bitwise equal; the standby's own dir holds no log."""
    whole = tmp_path / "whole"
    Trainer(_cnn_cfg(whole, 10), device="cpu").run()
    dead = tmp_path / "dead"
    Trainer(_cnn_cfg(dead, 5), device="cpu").run()
    standby = Trainer(_cnn_cfg(tmp_path / "standby", 10), device="cpu")
    standby.precompile()
    standby.adopt_train_dir(dead)
    assert standby.state.step == 5
    standby.run()
    assert checkpoint_params_digest(dead) == checkpoint_params_digest(whole)
    recs = _log(dead)
    assert [r["step"] for r in recs if r.get("event", "step") == "step"] \
        == list(range(1, 11))
    compiles = [i for i, r in enumerate(recs) if r.get("event") == "compile"]
    assert len(compiles) == 2
    assert recs[compiles[1] + 1]["step"] == 6  # re-journaled before step 6
    assert not (tmp_path / "standby" / "train_log.jsonl").exists()


def test_launch_train_standby_is_promoted_on_a_kill(tmp_path):
    """A real ``launch train --device cpu`` standby: it parks after its
    precompile, is promoted when worker 1 is killed at step 6, resumes
    from worker 1's step-5 checkpoint and ends on the unfaulted digest."""
    cmd = ("python -m distributedmnist_tpu_torch.launch train "
           "train.train_dir=. data.dataset=synthetic data.batch_size=32 "
           "data.synthetic_train_size=256 data.synthetic_test_size=64 "
           "data.use_native_pipeline=false model.compute_dtype=float32 "
           "model.image_size=12 mesh.num_replicas=2 optim.momentum=0.9 "
           "train.max_steps=16 train.log_every_steps=1 "
           "train.save_interval_steps=5 train.async_checkpoint=false "
           "train.save_results_period=0 train.step_pace_ms=150")
    c = make_cluster(tmp_path, name="sb", train_command=cmd, device="cpu",
                     fault_plan=FaultPlan(kill_worker_at_step={1: 6}))
    c.create()
    sup = ClusterSupervisor(c, SupervisorConfig(
        quorum=1, max_restarts_per_worker=1, restart_backoff_s=0.1,
        standby_workers=1))
    c.ensure_standbys(1)
    # generous deadlines: on a host whose cores are shared, a boot alone
    # has taken 100 s
    deadline = time.monotonic() + 300.0
    while not any(sb["ready"] for sb in c.status().get("standbys", [])):
        assert time.monotonic() < deadline, "the standby never parked"
        time.sleep(0.3)
    c.run_train()
    done = {}

    def drive():
        done["got"] = sup.supervise_until_step(16, poll_secs=0.3,
                                               timeout_secs=600.0)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    th.join(timeout=620.0)
    try:
        assert "got" in done
        restart = next(e for e in sup.events if e["action"] == "restart")
        assert restart["via"] == "standby" and restart["worker"] == 1
        # the promoted process finishes worker 1's run
        deadline = time.monotonic() + 300.0
        w1 = c.cfg.worker_dir(1)
        while time.monotonic() < deadline:
            steps = [r["step"] for r in _log(w1)
                     if r.get("event", "step") == "step"]
            if steps and steps[-1] == 16 and not any(
                    w["alive"] for w in c.status()["workers"]):
                break
            time.sleep(0.5)
    finally:
        c.kill_all()
    recs = _log(w1)
    assert sum(r.get("event") == "compile" for r in recs) == 2
    assert checkpoint_params_digest(w1) == \
        checkpoint_params_digest(c.cfg.worker_dir(0))
    sb = c.cfg.root / "standby0"
    assert (sb / "activate.json.ready").exists()
    assert json.loads((sb / "activate.json").read_text())["train_dir"] == \
        str(w1)
    c.delete()
