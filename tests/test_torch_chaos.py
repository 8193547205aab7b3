"""The port's chaos campaign (``distributedmnist_tpu_torch/launch/
chaos.py``) and the cluster half of its invariants held to the
reference's: the four schedule generators give the reference's
schedules bitwise; ``check_run`` gives the reference's verdicts on
clean and doctored artifact sets (the reference's ``test_chaos.py`` and
``test_elastic.py`` cases) in both directions; a shell-payload campaign
through each package's ``cluster chaos`` CLI ends with the same
verdicts, each package's checker passing the other's trial
directories; and (``slow``) the train payload's kill+corrupt trial
with real ``launch train --device cpu`` workers ends bitwise equal to
the fault-free reference."""

import contextlib
import io
import json
import shutil

import pytest

from distributedmnist_tpu.launch import chaos as ref_chaos
from distributedmnist_tpu.launch import cluster as ref_cluster
from distributedmnist_tpu.obsv import invariants as ref_inv
from distributedmnist_tpu.obsv import journal as ref_journal
from distributedmnist_tpu_torch.launch import chaos as pt_chaos
from distributedmnist_tpu_torch.launch import cluster as pt_cluster
from distributedmnist_tpu_torch.launch.chaos import (ChaosCampaign,
                                                     ChaosConfig, ChaosFault,
                                                     ChaosSchedule,
                                                     count_fired_faults,
                                                     generate_schedule)
from distributedmnist_tpu_torch.launch.cluster import ClusterError
from distributedmnist_tpu_torch.launch.exec import FaultPlan
from distributedmnist_tpu_torch.obsv import invariants as pt_inv
from distributedmnist_tpu_torch.obsv import journal as pt_journal

SEEDS = range(20)


# ---------------------------------------------------------------------------
# the four generators, bitwise
# ---------------------------------------------------------------------------

def _both(fn_name, *args, **kw):
    got = getattr(pt_chaos, fn_name)(*args, **kw)
    want = getattr(ref_chaos, fn_name)(*args, **kw)
    return got, want


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_schedule_is_the_reference(seed):
    for trial in range(4):
        for nw in range(1, 5):
            for kw in ({}, {"max_faults": 5, "min_faults": 2,
                            "stall_ms_range": (2000.0, 8000.0)},
                       {"resize_worlds": (1, nw + 1), "resize_prob": 1.0}):
                got, want = _both("generate_schedule", seed, trial, nw,
                                  (6, 20), **kw)
                assert got.to_json_dict() == want.to_json_dict()
                assert got.describe() == want.describe()
                assert got.to_fault_plan().to_json_dict() == \
                    want.to_fault_plan().to_json_dict()


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_disk_schedule_is_the_reference(seed):
    for trial in range(4):
        for nw in range(1, 5):
            got, want = _both("generate_disk_schedule", seed, trial, nw,
                              (6, 20), 5)
            assert got.to_json_dict() == want.to_json_dict()
            assert got.to_fault_plan().to_json_dict() == \
                want.to_fault_plan().to_json_dict()


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_serving_schedule_is_the_reference(seed):
    for trial in range(1, 5):
        for nw in range(1, 5):
            got, want = _both("generate_serving_schedule", seed, trial,
                              list(range(1, nw + 1)), (5, 40), (6, 20))
            assert got.to_json_dict() == want.to_json_dict()


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_network_schedule_is_the_reference(seed):
    for trial in range(4):
        for nw in range(1, 5):
            got, want = _both("generate_network_schedule", seed, trial,
                              list(range(1, nw + 1)))
            assert got.to_json_dict() == want.to_json_dict()
            assert got.describe() == want.describe()
            assert got.to_fault_plan().to_json_dict() == \
                want.to_fault_plan().to_json_dict()


@pytest.mark.parametrize("kw", [
    {}, {"payload": "shell"}, {"disk": True, "save_interval_steps": 5},
    {"resize_prob": 1.0, "standby_workers": 1}, {"until_step": 100},
    {"stall_timeout_s": 7.0},
])
def test_config_resolution_is_the_reference(kw):
    got, want = ChaosConfig(**kw), ref_chaos.ChaosConfig(**kw)
    assert got.step_window() == want.step_window()
    assert got.resolved_poll_secs() == want.resolved_poll_secs()
    assert got.resolved_stall_ms_range() == want.resolved_stall_ms_range()
    assert got.resolved_resize_worlds() == want.resolved_resize_worlds()
    for boot in (None, 0.0, 1.5, 9.0, 60.0):
        assert got.resolved_stall_timeout_s(boot) == \
            want.resolved_stall_timeout_s(boot)
    assert got.resolved_train_command() == \
        want.resolved_train_command().replace(
            "distributedmnist_tpu.launch", "distributedmnist_tpu_torch.launch")


@pytest.mark.parametrize("kw", [{"payload": "serving"},
                                {"serve_decode": True},
                                {"network": True},
                                {"broker": True, "payload": "train"}])
def test_unported_modes_raise_naming_slice_9(kw):
    """The switches slice 8 refused (naming slice 9, then ``broker``
    naming slice 10): each is now taken or refused as the reference's
    ``ChaosConfig`` takes or refuses it, with its message (``broker``
    on the train payload: refused, it trades training slots for
    serving replicas)."""
    try:
        want = ref_chaos.ChaosConfig(**kw)
    except ref_cluster.ClusterError as e:
        with pytest.raises(ClusterError) as got:
            ChaosConfig(**kw)
        assert str(got.value) == str(e)
        return
    got = ChaosConfig(**kw)
    assert got.trial_num_workers() == want.trial_num_workers()
    assert got.resolved_train_command(9.0) == want.resolved_train_command(
        9.0).replace("distributedmnist_tpu.launch",
                     "distributedmnist_tpu_torch.launch")
    assert got.resolved_worker_commands() == {
        k: c.replace("distributedmnist_tpu.launch",
                     "distributedmnist_tpu_torch.launch")
        for k, c in want.resolved_worker_commands().items()}


def test_count_fired_faults_is_the_reference(tmp_path):
    trial = tmp_path / "t"
    (trial / "worker0").mkdir(parents=True)
    (trial / "command_journal.jsonl").write_text("".join(
        json.dumps(r) + "\n" for r in (
            {"event": "fault", "action": "kill_worker", "worker": 0},
            {"event": "command", "verb": "poll", "injected_delay_ms": 7.0},
            {"event": "reconfigure", "action": "begin",
             "trigger": "fault_plan"})))
    (trial / "worker0" / "storage_faults.jsonl").write_text(json.dumps(
        {"event": "fault", "action": "disk_enospc", "worker": 0}) + "\n")
    faults = (ChaosFault("kill", worker=0, step=8),
              ChaosFault("kill", worker=1, step=1000),
              ChaosFault("resize", step=9, world=1),
              ChaosFault("delay", verb="poll", ms=7.0),
              ChaosFault("disk_enospc_after_bytes", worker=0, step=6,
                         disk=(("bytes", 1),)),
              ChaosFault("disk_eio", worker=1, step=6))
    got = count_fired_faults(trial, ChaosSchedule(1, 0, faults))
    want = ref_chaos.count_fired_faults(
        trial, ref_chaos.ChaosSchedule(1, 0, tuple(
            ref_chaos.ChaosFault(**f.__dict__) for f in faults)))
    assert got == want and got["fired"] == 4


# ---------------------------------------------------------------------------
# check_run on clean and doctored artifacts, against the reference
# ---------------------------------------------------------------------------

def _clean(root, steps=10):
    w0 = root / "worker0"
    w0.mkdir(parents=True)
    with open(w0 / "train_log.jsonl", "w") as fh:
        for s in range(1, steps + 1):
            fh.write(json.dumps({"step": s, "loss": 1.0}) + "\n")
    with open(root / "command_journal.jsonl", "w") as fh:
        for action in ("detect", "restart_scheduled", "restart", "resume"):
            fh.write(json.dumps({"event": "recovery", "action": action,
                                 "worker": 0}) + "\n")
    return {"outcome": "completed", "step": steps, "target": steps,
            "supervisor": {"quorum": 1, "max_restarts_per_worker": 2}}


def _dup_step(root, outcome):
    log = root / "worker0" / "train_log.jsonl"
    lines = log.read_text().splitlines()
    lines.insert(6, lines[5])
    lines.insert(9, lines[8])
    log.write_text("\n".join(lines) + "\n")


def _no_detect(root, outcome):
    jpath = root / "command_journal.jsonl"
    recs = [json.loads(line) for line in jpath.read_text().splitlines()]
    jpath.write_text("".join(json.dumps(r) + "\n" for r in recs
                             if r["action"] != "detect"))


def _fallback_uncaused(root, outcome):
    (root / "worker0" / "recovery_journal.jsonl").write_text(json.dumps(
        {"event": "recovery", "layer": "checkpoint",
         "action": "fallback_restore", "step": 4}) + "\n")


def _torn_digest(root, outcome):
    w0 = root / "worker0"
    (w0 / "ckpt-00000005.msgpack").write_bytes(b"torn bytes")
    (w0 / "ckpt-00000005.msgpack.sha256").write_text("0" * 64)


def _torn_digest_journaled(root, outcome):
    _torn_digest(root, outcome)
    with open(root / "command_journal.jsonl", "a") as fh:
        fh.write(json.dumps({"event": "fault",
                             "action": "corrupt_latest_checkpoint",
                             "worker": 0,
                             "target": "ckpt-00000005.msgpack"}) + "\n")


def _illegal_terminal(root, outcome):
    outcome.update(outcome="aborted", error="weird crash")


def _legal_abort(root, outcome):
    outcome.update(outcome="aborted", error="below quorum")
    with open(root / "command_journal.jsonl", "a") as fh:
        fh.write(json.dumps({"event": "recovery",
                             "action": "below_quorum_abort",
                             "workers_alive": 0, "quorum": 1}) + "\n")


def _pointer_gone(root, outcome):
    (root / "worker0" / "checkpoint.json").write_text(json.dumps(
        {"latest_step": 9, "latest_path": "ckpt-gone.msgpack"}))


def _world_unlicensed(root, outcome):
    outcome.update(num_workers=2, final_world=1)
    (root / "state.json").write_text(json.dumps(
        {"phase": "running", "workers": [
            {"worker": 0, "pid": None, "logdir": str(root / "worker0")}]}))


def _world_licensed(root, outcome):
    _world_unlicensed(root, outcome)
    with open(root / "command_journal.jsonl", "a") as fh:
        for rec in (
                {"event": "reconfigure", "layer": "supervisor",
                 "action": "begin", "old_world": 2, "new_world": 1,
                 "trigger": "below_quorum"},
                {"event": "reconfigure", "layer": "cluster",
                 "action": "reshape", "old_world": 2, "new_world": 1,
                 "workers": [0], "dropped": [1], "grown": {}},
                {"event": "reconfigure", "layer": "supervisor",
                 "action": "relaunched", "old_world": 2, "new_world": 1,
                 "workers": [0], "via": {"0": "respawn"}}):
            fh.write(json.dumps(rec) + "\n")


def _world_lying(root, outcome):
    _world_unlicensed(root, outcome)
    with open(root / "command_journal.jsonl", "a") as fh:
        fh.write(json.dumps({"event": "reconfigure", "layer": "cluster",
                             "action": "reshape", "old_world": 2,
                             "new_world": 1, "workers": [0, 1],
                             "grown": {}}) + "\n")


def _storage_skip_unlicensed(root, outcome):
    with open(root / "worker0" / "recovery_journal.jsonl", "w") as fh:
        fh.write(json.dumps({"event": "recovery", "layer": "checkpoint",
                             "action": "save_failed", "step": 5,
                             "error": "OSError: no space"}) + "\n")


_DOCTORED = {"clean": None, "dup_step": _dup_step,
             "no_detect": _no_detect,
             "fallback_uncaused": _fallback_uncaused,
             "torn_digest": _torn_digest,
             "torn_digest_journaled": _torn_digest_journaled,
             "illegal_terminal": _illegal_terminal,
             "legal_abort": _legal_abort, "pointer_gone": _pointer_gone,
             "world_unlicensed": _world_unlicensed,
             "world_licensed": _world_licensed,
             "world_lying": _world_lying,
             "storage_skip_unlicensed": _storage_skip_unlicensed}


@pytest.mark.parametrize("case", sorted(_DOCTORED))
def test_check_run_verdicts_are_the_reference(case, tmp_path):
    outcome = _clean(tmp_path)
    if _DOCTORED[case] is not None:
        _DOCTORED[case](tmp_path, outcome)
    got = pt_inv.check_run(tmp_path, outcome=dict(outcome))
    want = ref_inv.check_run(tmp_path, outcome=dict(outcome))
    assert got == want
    assert (got["violations"] == []) == (case in (
        "clean", "torn_digest_journaled", "legal_abort", "world_licensed"))


def test_shrink_faults_and_synthetic_campaign_shrink(tmp_path):
    culprit = ChaosFault("kill", worker=1, step=7)
    extras = (ChaosFault("stall", worker=0, step=6, ms=500.0),
              ChaosFault("hang", worker=0, step=9),
              ChaosFault("delay", verb="poll", ms=20.0))
    faults = extras[:1] + (culprit,) + extras[1:]
    got = pt_inv.shrink_faults(faults, lambda fs: culprit in fs)
    assert got == ref_inv.shrink_faults(faults, lambda fs: culprit in fs)
    assert got[0] == (culprit,)

    class SyntheticCampaign(ChaosCampaign):
        """Artifacts fabricated in place of a run: any plan with a kill
        stops short of its target."""

        def _run_trial(self, rel, plan, seed, num_workers,
                       measured_boot_s=None):
            root = self.cfg.root / rel
            root.mkdir(parents=True, exist_ok=True)
            (root / "command_journal.jsonl").write_text("")
            buggy = bool(plan.kill_worker_at_step)
            outcome = {"name": rel, "seed": seed, "target": 20,
                       "num_workers": num_workers, "outcome": "completed",
                       "step": 12 if buggy else 20,
                       "supervisor": {"quorum": 1,
                                      "max_restarts_per_worker": 2},
                       "fault_plan": plan.to_json_dict(),
                       "duration_s": 0.0, "reference_dir": None}
            (root / "outcome.json").write_text(json.dumps(outcome))
            return outcome

    cfg = ChaosConfig(name="synth", trials=1, seed=0, until_step=20,
                      workdir=str(tmp_path), payload="shell", shrink=True,
                      shrink_max_probes=8)
    summary = SyntheticCampaign(cfg).run()
    assert summary["all_green"] is False
    assert summary["failing_trials"][0]["invariants"] == ["terminal_state"]
    repro = FaultPlan.from_file(summary["reproducers"][0])
    assert repro.kill_worker_at_step and \
        not repro.corrupt_latest_checkpoint_at_step


# ---------------------------------------------------------------------------
# a real shell-payload campaign through each package's CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """One shell campaign through each CLI (the port's with
    ``--device cpu``, which a shell payload ignores)."""
    root = tmp_path_factory.mktemp("campaigns")
    out = {}
    for name, main, extra in (("port", pt_cluster.main, ("--device", "cpu")),
                              ("ref", ref_cluster.main, ())):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ccfg = {"workdir": str(root / name), "num_workers": 2,
                    "trial_timeout_s": 90.0, "drain_timeout_s": 30.0}
            main(["chaos", "--trials", "2", "--seed", "0", "--until-step",
                  "20", "--payload", "shell", "--no-shrink",
                  "--chaos-config", json.dumps(ccfg), *extra])
        out[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                     root / name / "chaos")
    return out


def test_port_shell_campaign_is_all_green(campaigns):
    summary, root = campaigns["port"]
    assert summary["all_green"] is True, summary
    assert summary["outcomes"] == {"completed": 2}
    assert summary["invariants"]["determinism"]["skipped"] == 2
    for inv in ("terminal_state", "metrics_log", "causality",
                "checkpoint_integrity"):
        assert summary["invariants"][inv]["pass"] == 2
    again = pt_journal.summarize_chaos(root / "chaos_report.jsonl")
    assert again["all_green"] and again["outcomes"] == {"completed": 2}


def test_shell_campaign_verdicts_and_counts_are_the_reference(campaigns):
    got, _ = campaigns["port"]
    want, _ = campaigns["ref"]
    for key in ("trials", "seed", "outcomes", "invariants", "all_green",
                "failing_trials", "reconfigures"):
        assert got[key] == want[key], key
    assert got["faults"]["scheduled"] == want["faults"]["scheduled"]
    assert [t["scheduled"] for t in got["faults"]["per_trial"]] == \
        [t["scheduled"] for t in want["faults"]["per_trial"]]


@pytest.mark.parametrize("trial", ["trial000", "trial001"])
def test_each_checker_passes_the_other_packages_trials(campaigns, trial):
    for checker, src in ((ref_inv, "port"), (pt_inv, "ref")):
        _, root = campaigns[src]
        outcome = json.loads((root / trial / "outcome.json").read_text())
        got = checker.check_run(root / trial, outcome=outcome,
                                reference_dir=root / "reference" / "worker0")
        assert got["violations"] == [], (src, got["violations"])


def test_summarize_chaos_reads_both_reports_alike(campaigns):
    for _, root in campaigns.values():
        report = root / "chaos_report.jsonl"
        got = pt_journal.summarize_chaos(report)
        want = ref_journal.summarize_chaos(report)
        assert got == want


# ---------------------------------------------------------------------------
# the train payload on real port workers
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_train_campaign_kill_corrupt_trial_bitwise_deterministic(tmp_path):
    """Seed 0 / trial 0 is the corrupt+kill pair on worker 1. The
    reference's payload, paced 150 ms a step so the 1 s poll sees the
    trigger step (pacing leaves the numerics alone), runs on the port's
    ``launch train --device cpu`` workers; the recovered trial ends on
    the fault-free reference's digest."""
    from distributedmnist_tpu_torch.train.checkpoint import (
        checkpoint_params_digest)
    base = ChaosConfig(until_step=40, save_interval_steps=5)
    cfg = ChaosConfig(name="e2e", trials=1, seed=0, until_step=40,
                      workdir=str(tmp_path), payload="train",
                      save_interval_steps=5, shrink=False, device="cpu",
                      train_command=(base.resolved_train_command()
                                     + " train.step_pace_ms=150"),
                      trial_timeout_s=600.0, drain_timeout_s=300.0)
    sched = generate_schedule(0, 0, 2, cfg.step_window(),
                              max_faults=cfg.max_faults,
                              stall_ms_range=cfg.resolved_stall_ms_range())
    kinds = {f.kind for f in sched.faults}
    assert "corrupt" in kinds and "kill" in kinds
    summary = ChaosCampaign(cfg).run()
    assert summary["all_green"] is True, summary
    assert summary["invariants"]["determinism"]["pass"] == 1
    assert summary["faults"]["never_fired"] == 0, summary["faults"]
    ref = checkpoint_params_digest(cfg.root / "reference" / "worker0")
    for w in (0, 1):
        got = checkpoint_params_digest(cfg.root / "trial000" / f"worker{w}")
        assert got == ref, (w, got, ref)
    journal = cfg.root / "trial000" / "command_journal.jsonl"
    spawns = [json.loads(line) for line in journal.read_text().splitlines()
              if '"spawn"' in line]
    assert len(spawns) >= 3  # two workers and the restart
    assert all("distributedmnist_tpu_torch.launch train" in s["command"]
               and s["command"].endswith("--device cpu") for s in spawns)
    # the reference's checker agrees on the port's trial
    outcome = json.loads((cfg.root / "trial000" / "outcome.json").read_text())
    assert ref_inv.check_run(
        cfg.root / "trial000", outcome=outcome,
        reference_dir=cfg.root / "reference" / "worker0")["violations"] == []
    shutil.rmtree(cfg.root / "compile_cache", ignore_errors=True)
