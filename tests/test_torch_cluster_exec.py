"""The port's command executor and local process cluster
(``distributedmnist_tpu_torch/launch/exec.py`` and ``cluster.py``) held
to the reference's (``distributedmnist_tpu/launch/``): the pure parts
(FaultPlan, RetryPolicy, parse_poll_output, the journal summary) give
the reference's answers on the same inputs, and every verb runs as a
real subprocess over the cheap shell payload, as the reference's
``test_cluster_exec.py`` and ``test_fault_injection.py`` drive it. The
payload templates name the port's package, ``--device cpu`` reaches
the workers, and ``compile_cache=false`` gives every spawn an empty
kernel directory."""

import json
import random
import time
from pathlib import Path

import pytest

from distributedmnist_tpu.launch import cluster as ref_cluster
from distributedmnist_tpu.launch import exec as ref_exec
from distributedmnist_tpu.obsv import journal as ref_journal
from distributedmnist_tpu_torch.launch import cluster as pt_cluster
from distributedmnist_tpu_torch.launch import exec as pt_exec
from distributedmnist_tpu_torch.launch.cluster import (ClusterError,
                                                       LocalClusterConfig,
                                                       LocalProcessCluster,
                                                       make_backend,
                                                       parse_poll_output,
                                                       run_until_step,
                                                       wait_until_step)
from distributedmnist_tpu_torch.launch.exec import (CommandExecutor,
                                                    ExecError, FaultPlan,
                                                    RetryPolicy)
from distributedmnist_tpu_torch.obsv.journal import (load_journal,
                                                     summarize_journal)

from _torch_cluster import STEP_LOOP, make_cluster

_FULL_PLAN = {
    "fail_first": {"create": 2, "poll": 1},
    "delay_ms": {"poll": 5.0, "status": 12.5},
    "kill_worker_at_step": {"1": 7, "0": 11},
    "hang_worker_at_step": {"2": 9},
    "corrupt_latest_checkpoint_at_step": {"1": 7},
    "stall_worker_for_ms_at_step": {"0": [6, 2500.0]},
    "resize_world_at_step": [12, 1],
    "net_faults": {"1": [{"kind": "reset", "after_bytes": 500}]},
    "disk_faults": {"0": [{"kind": "enospc_after_bytes", "at_step": 6,
                           "bytes": 17, "match": ".msgpack", "times": 3}]},
}


# ---------------------------------------------------------------------------
# the pure parts against the reference
# ---------------------------------------------------------------------------

def test_fault_plan_every_key_roundtrips_as_the_reference(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(_FULL_PLAN))
    got = pt_exec.FaultPlan.from_file(p)
    want = ref_exec.FaultPlan.from_file(p)
    assert got.to_json_dict() == want.to_json_dict()
    assert got.kill_worker_at_step == {1: 7, 0: 11}  # JSON str keys → int
    assert got.stall_worker_for_ms_at_step == want.stall_worker_for_ms_at_step
    assert got.disk_faults == want.disk_faults
    assert got.resize_world_at_step == want.resize_world_at_step == (12, 1)
    for verb in ("create", "poll", "status", "other"):
        for attempt in (1, 2, 3):
            assert got.should_fail(verb, attempt) == \
                want.should_fail(verb, attempt)
        assert got.command_delay_s(verb) == want.command_delay_s(verb)
    p.write_text(json.dumps({"kill_wroker": {}}))
    with pytest.raises(ExecError, match="kill_wroker"):
        pt_exec.FaultPlan.from_file(p)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_retry_backoff_schedule_is_the_reference(seed):
    kw = dict(max_attempts=6, backoff_s=0.05, multiplier=2.0,
              max_backoff_s=0.5, jitter_frac=0.25, seed=seed)
    got, want = pt_exec.RetryPolicy(**kw), ref_exec.RetryPolicy(**kw)
    r1, r2 = random.Random(seed), random.Random(seed)
    assert [got.delay_s(f, r1) for f in range(1, 7)] == \
        [want.delay_s(f, r2) for f in range(1, 7)]


@pytest.mark.parametrize("text", [
    None, "", '{"step": 8, "loss"', '{"step": 12, "loss": 0.5}\n',
    '{"step": 11, "loss": 0.7}\n{"step": 12, "loss": 0.5}\n{"step": 13, "lo',
    'garbage\n{"step": 9,',
    '{"step": 4}\n{"event": "compile", "time": 1.0}\n',
])
def test_parse_poll_output_is_the_reference(text):
    assert pt_cluster.parse_poll_output(text) == \
        ref_cluster.parse_poll_output(text)


# ---------------------------------------------------------------------------
# CommandExecutor over real subprocesses
# ---------------------------------------------------------------------------

def test_run_real_command_journals_result(tmp_path):
    journal = tmp_path / "journal.jsonl"
    with CommandExecutor(journal=journal) as ex:
        res = ex.run(["sh", "-c", "echo out; echo err >&2"], verb="probe")
    assert res.ok and res.returncode == 0 and res.attempts == 1
    assert res.stdout == "out\n" and res.stderr == "err\n"
    (rec,) = load_journal(journal)
    assert rec["verb"] == "probe" and rec["rc"] == 0
    assert rec["stdout_tail"] == "out\n" and rec["stderr_tail"] == "err\n"
    assert rec["duration_ms"] > 0 and rec["will_retry"] is False


def test_nonzero_rc_timeout_and_missing_binary(tmp_path):
    ex = CommandExecutor(retry=RetryPolicy(max_attempts=1), timeout_s=0.2)
    res = ex.run(["sh", "-c", "echo boom >&2; exit 3"], check=False)
    assert not res.ok and res.returncode == 3
    with pytest.raises(ExecError, match=r"rc=3"):
        ex.run(["sh", "-c", "exit 3"])
    t0 = time.monotonic()
    res = ex.run(["sh", "-c", "sleep 30"], check=False)
    assert time.monotonic() - t0 < 10 and res.timed_out and not res.ok
    journal = tmp_path / "journal.jsonl"
    ex = CommandExecutor(journal=journal, retry=RetryPolicy(max_attempts=5))
    with pytest.raises(ExecError, match="not found"):
        ex.run(["dmt-no-such-binary-for-test"])
    recs = load_journal(journal)
    assert len(recs) == 1 and recs[0]["error"] == "binary not found"


def test_retry_backoff_recovers_transient_failure(tmp_path):
    journal = tmp_path / "journal.jsonl"
    delays: list[float] = []
    ex = CommandExecutor(
        journal=journal,
        retry=RetryPolicy(max_attempts=3, backoff_s=0.05, multiplier=2.0,
                          jitter_frac=0.25, seed=0),
        fault_plan=FaultPlan(fail_first={"flaky": 2}),
        sleep=delays.append)
    res = ex.run(["echo", "recovered"], verb="flaky")
    assert res.ok and res.attempts == 3 and res.stdout == "recovered\n"
    assert len(delays) == 2
    assert 0.05 * 0.75 <= delays[0] <= 0.05 * 1.25
    assert 0.10 * 0.75 <= delays[1] <= 0.10 * 1.25
    recs = load_journal(journal)
    assert [r["will_retry"] for r in recs] == [True, True, False]
    s = summarize_journal(journal)
    assert s["retries"] == 2 and s["failures"] == 0 and s["injected"] == 2
    # the reference's reader gives the same summary of the port's journal
    assert ref_journal.summarize_journal(journal) == s
    ex = CommandExecutor(
        journal=journal,
        retry=RetryPolicy(max_attempts=2, backoff_s=0.0, jitter_frac=0.0),
        fault_plan=FaultPlan(fail_first={"never": 99}))
    with pytest.raises(ExecError, match=r"after 2 attempt"):
        ex.run(["echo", "never"], verb="never")


def test_fault_delay_and_dry_run(tmp_path):
    slept: list[float] = []
    ex = CommandExecutor(fault_plan=FaultPlan(delay_ms={"probe": 40.0}),
                         sleep=slept.append)
    ex.run(["true"], verb="probe")
    ex.run(["true"], verb="other")
    assert slept == [0.04]
    journal = tmp_path / "journal.jsonl"
    ex = CommandExecutor(journal=journal, dry_run=True)
    assert ex.run(["definitely-not-a-binary", "--flag"]) is None
    assert ex.recorded == [["definitely-not-a-binary", "--flag"]]
    assert summarize_journal(journal)["dry_run"] == 1


# ---------------------------------------------------------------------------
# LocalProcessCluster verbs
# ---------------------------------------------------------------------------

def test_create_exec_poll_download_delete(tmp_path):
    c = LocalProcessCluster(LocalClusterConfig(
        name="t", workdir=str(tmp_path / "cl"), num_workers=2))
    c.create()
    state = json.loads(c.state_path.read_text())
    assert state["phase"] == "created"
    got = c.status()
    assert got["state"] == "CREATED" and got["idle"] is True
    c.exec_all("echo payload-$DMT_WORKER_INDEX > touched.txt")
    for k in range(2):
        assert (c.cfg.worker_dir(k) / "touched.txt").read_text().strip() \
            == f"payload-{k}"
    assert c.poll() == {"step": -1, "record": None}
    (c.cfg.worker_dir(0) / "train_log.jsonl").write_text(
        json.dumps({"step": 3}) + "\n" + json.dumps({"step": 7}) + "\n")
    assert c.poll()["step"] == 7
    c.download(tmp_path / "dl")
    assert (tmp_path / "dl" / "worker0" / "train_log.jsonl").exists()
    c.delete()
    assert c.status()["state"] == "DELETED"
    s = summarize_journal(c.exec.journal_path)
    assert s["failures"] == 0 and "create" in s["by_verb"]
    assert ref_journal.summarize_journal(c.exec.journal_path) == s


def test_make_backend_and_config_file(tmp_path):
    ex = CommandExecutor(dry_run=True)
    assert isinstance(make_backend("local", None, ex), LocalProcessCluster)
    with pytest.raises(ClusterError, match="launch pod"):
        make_backend("gcloud", None, ex)
    with pytest.raises(ClusterError, match="unknown backend"):
        make_backend("k8s", None, ex)
    p = tmp_path / "cluster.json"
    p.write_text(json.dumps({"name": "x", "num_workers": 3,
                             "device": "cpu"}))
    cfg = LocalClusterConfig.from_file(p)
    assert (cfg.name, cfg.num_workers, cfg.device) == ("x", 3, "cpu")
    p.write_text(json.dumps({"num_wrokers": 3}))
    with pytest.raises(ClusterError, match="num_wrokers"):
        LocalClusterConfig.from_file(p)
    # the repo's committed cluster files load through the same parsers
    root = Path(__file__).resolve().parents[1] / "configs" / "cluster"
    assert LocalClusterConfig.from_file(root / "local_2w.json").num_workers \
        == 2
    plan = FaultPlan.from_file(root / "fault_kill_worker1_at_step10.json")
    assert plan.kill_worker_at_step == {1: 10}


def test_cluster_cli_dry_run_through_the_launch_verb(tmp_path, capsys):
    from distributedmnist_tpu_torch.launch.__main__ import main
    cfgp = tmp_path / "c.json"
    cfgp.write_text(json.dumps({"workdir": str(tmp_path / "w")}))
    main(["cluster", "create", "--backend", "local",
          "--config", str(cfgp), "--dry-run"])
    cmds = json.loads(capsys.readouterr().out)
    assert any(c.startswith("sh -c") and "mkdir -p" in c for c in cmds)
    main(["cluster", "run", "--config", str(cfgp), "--dry-run",
          "--device", "cpu"])
    cmds = json.loads(capsys.readouterr().out)
    spawned = [c for c in cmds if "launch train" in c]
    assert len(spawned) == 2
    assert all("distributedmnist_tpu_torch.launch train" in c
               and c.endswith("--device cpu'") for c in spawned)


def _chaos_cli(main, chaos_module, argv, monkeypatch):
    """The ChaosConfig a ``cluster chaos`` command line builds (its
    campaign not run), or the ClusterError it raises."""
    built = []
    monkeypatch.setattr(chaos_module, "run_campaign",
                        lambda cfg: built.append(cfg) or {})
    try:
        main(argv)
    except (ClusterError, ref_cluster.ClusterError) as e:
        return e
    return built[0]


@pytest.mark.parametrize("argv, want", [
    (["status", "--backend", "gcloud"], "launch pod"),
    # the case's id from when it refused naming slice 10, kept
    pytest.param(["broker", "--until-step", "5"], "requires --serve-command",
                 id="argv1-slice 10"),
    (["chaos", "--payload", "serving"], "the reference's"),
    (["chaos", "--network"], "the reference's"),
    (["chaos", "--serve-decode"], "the reference's"),
])
def test_unported_cluster_surfaces_refuse_at_once(argv, want, tmp_path,
                                                  monkeypatch, capsys):
    """What the port does not have refuses at once, naming it (the
    gcloud backend); ``broker`` without ``--serve-command`` stops at the
    reference's parse-time error, word for word (it once refused naming
    slice 10); the serving chaos flags are taken or refused as the
    reference's CLI takes or refuses them, with its message. None of
    them runs anything."""
    from distributedmnist_tpu.launch import chaos as ref_chaos
    from distributedmnist_tpu_torch.launch import chaos as pt_chaos
    t0 = time.monotonic()
    if argv[0] == "broker":
        said = []
        for main in (pt_cluster.main, ref_cluster.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
            said.append(capsys.readouterr().err.strip().splitlines()[-1]
                        .split(" error: ", 1)[1])
        assert said[0] == said[1] and want in said[0]
    elif argv[0] != "chaos":
        with pytest.raises(ClusterError, match=want):
            pt_cluster.main(argv)
    else:
        argv = argv + ["--chaos-config",
                       json.dumps({"workdir": str(tmp_path)})]
        got = _chaos_cli(pt_cluster.main, pt_chaos, argv, monkeypatch)
        ref = _chaos_cli(ref_cluster.main, ref_chaos, argv, monkeypatch)
        assert type(got) is ClusterError or not isinstance(got, Exception)
        if isinstance(ref, Exception):
            assert str(got) == str(ref)
        else:
            fields = {k: v for k, v in vars(got).items() if k != "device"}
            assert fields == vars(ref)
    assert time.monotonic() - t0 < 5
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# payload templates, the device and the kernel build cache
# ---------------------------------------------------------------------------

def test_payload_templates_name_the_port_and_take_the_device():
    from distributedmnist_tpu_torch.launch.chaos import ChaosConfig
    ref_default = ref_cluster.LocalClusterConfig().train_command
    cfg = LocalClusterConfig()
    # the reference's payload, on the port's package
    assert cfg.train_command == ref_default.replace(
        "distributedmnist_tpu.launch", "distributedmnist_tpu_torch.launch")
    for cmd in (cfg.command_for(0), cfg.resolved_standby_command(),
                ChaosConfig().resolved_train_command()):
        assert "python -m distributedmnist_tpu_torch.launch train" in cmd
        assert "--device" not in cmd
    cpu = LocalClusterConfig(device="cpu",
                             worker_commands={"1": STEP_LOOP})
    assert cpu.command_for(0).endswith(" --device cpu")
    assert cpu.resolved_standby_command().endswith(" --device cpu")
    assert cpu.command_for(1) == STEP_LOOP  # not a port verb: unchanged
    named = LocalClusterConfig(
        device="cpu", train_command=cfg.train_command + " --device cuda:0")
    assert named.command_for(0).endswith("--device cuda:0")


def test_device_cpu_reaches_every_spawned_worker(tmp_path):
    """``launch devices`` as the payload: without ``--device cpu`` it
    wants a CUDA device and fails here; with the cluster's device each
    worker, a restarted one too, lists the CPU."""
    c = make_cluster(tmp_path, train_command=(
        "python -m distributedmnist_tpu_torch.launch devices"),
        device="cpu")
    c.create()
    c.run_train()
    deadline = time.monotonic() + 60
    while any(w["alive"] for w in c.status()["workers"]):
        assert time.monotonic() < deadline
        time.sleep(0.2)
    c.restart_worker(1)
    while any(w["alive"] for w in c.status()["workers"]):
        assert time.monotonic() < deadline
        time.sleep(0.2)
    for k in range(2):
        out = (c.cfg.worker_dir(k) / "train_stdout.log").read_text()
        assert out.count('"platform": "cpu"') == (2 if k == 1 else 1), out
    spawns = [json.loads(line) for line in
              c.exec.journal_path.read_text().splitlines()
              if '"spawn"' in line]
    assert len(spawns) == 3
    assert all(s["command"].endswith("--device cpu") for s in spawns)
    c.delete()


_CACHE_PROBE = ('echo "$DMT_COMPILE_CACHE_DIR" >> cache.txt; '
                'ls -A "$DMT_COMPILE_CACHE_DIR" | wc -l >> cache.txt')


def test_compile_cache_shared_or_fresh_and_empty_per_spawn(tmp_path):
    def probe(compile_cache):
        c = make_cluster(tmp_path / str(compile_cache),
                         train_command=_CACHE_PROBE,
                         compile_cache=compile_cache)
        c.create()
        c.run_train()
        time.sleep(0.5)
        c.restart_worker(0)
        time.sleep(0.5)
        lines = {k: (c.cfg.worker_dir(k) / "cache.txt").read_text().split()
                 for k in range(2)}
        c.delete()
        return c, lines

    c, lines = probe(True)
    shared = str(c.cfg.root / "compile_cache")
    assert lines == {0: [shared, "0", shared, "0"], 1: [shared, "0"]}
    c, lines = probe(False)
    dirs = [lines[0][0], lines[0][2], lines[1][0]]
    assert len(set(dirs)) == 3  # one directory per process
    assert all(Path(d).parent == c.cfg.root / "cold_compile" for d in dirs)
    assert lines[0][1] == lines[0][3] == lines[1][1] == "0"  # each empty


# ---------------------------------------------------------------------------
# injected faults over real worker processes
# ---------------------------------------------------------------------------

def _alive(cluster) -> dict[int, bool]:
    return {w["worker"]: w["alive"] for w in cluster.status()["workers"]}


def test_transient_create_failure_recovered_by_retry(tmp_path):
    c = make_cluster(tmp_path, fault_plan=FaultPlan(fail_first={"create": 2}),
                     retry=RetryPolicy(max_attempts=3, backoff_s=0.01,
                                       jitter_frac=0.0))
    c.create()
    assert c.cfg.worker_dir(0).is_dir() and c.cfg.worker_dir(1).is_dir()
    recs = [r for r in load_journal(c.exec.journal_path)
            if r["verb"] == "create"]
    assert [r["injected"] for r in recs] == [True, True, False]
    c.delete()


def test_midrun_worker_kill_surfaces_in_status(tmp_path):
    c = make_cluster(tmp_path, fault_plan=FaultPlan(kill_worker_at_step={1: 3}))
    c.create()
    c.run_train()
    try:
        got = wait_until_step(c, target=6, poll_secs=0.1, timeout_secs=60.0)
        assert got["step"] >= 6
        time.sleep(0.2)
        alive = _alive(c)
        assert alive[0] is True and alive[1] is False
        raw = [json.loads(line) for line in
               c.exec.journal_path.read_text().splitlines()]
        faults = [r for r in raw if r.get("event") == "fault"]
        assert faults and faults[0]["action"] == "kill_worker"
        assert faults[0]["worker"] == 1 and faults[0]["at_step"] >= 3
    finally:
        c.kill_all()
    time.sleep(0.2)
    assert not any(_alive(c).values())
    c.delete()


def test_poll_timeout_tears_down_and_dead_cluster_fails_fast(tmp_path):
    stall = ('echo "{\\"step\\": 1, \\"loss\\": 1.0}" >> train_log.jsonl; '
             'sleep 60')
    c = make_cluster(tmp_path / "a", train_command=stall)
    c.create()
    with pytest.raises(ClusterError, match=r"step 100.*last seen: 1"):
        run_until_step(c, target=100, poll_secs=0.1, timeout_secs=1.0)
    time.sleep(0.2)
    assert not any(_alive(c).values())
    raw = [json.loads(line) for line in
           c.exec.journal_path.read_text().splitlines()]
    assert sum(r.get("event") == "spawn" for r in raw) == 2
    c.delete()
    c = make_cluster(tmp_path / "b", train_command="true")
    c.create()
    c.run_train()
    time.sleep(0.3)
    t0 = time.monotonic()
    with pytest.raises(ClusterError, match="no live workers"):
        wait_until_step(c, target=5, poll_secs=0.1, timeout_secs=300.0)
    assert time.monotonic() - t0 < 30
    c.delete()


def test_command_class_delay_straggles_the_poll(tmp_path):
    c = make_cluster(tmp_path, fault_plan=FaultPlan(delay_ms={"poll": 120.0}))
    c.create()
    (c.cfg.worker_dir(0) / "train_log.jsonl").write_text('{"step": 9}\n')
    t0 = time.monotonic()
    got = c.poll()
    assert got["step"] == 9 and time.monotonic() - t0 >= 0.12
    recs = [r for r in load_journal(c.exec.journal_path)
            if r["verb"] == "poll"]
    assert recs[0]["injected_delay_ms"] == 120.0
    c.delete()


def test_corrupt_fault_truncates_the_pointer_target(tmp_path):
    c = make_cluster(tmp_path, train_command="sleep 30", num_workers=1,
                     fault_plan=FaultPlan(
                         corrupt_latest_checkpoint_at_step={0: 2}))
    c.create()
    w0 = c.cfg.worker_dir(0)
    (w0 / "ckpt-00000002.msgpack").write_bytes(b"x" * 100)
    (w0 / "checkpoint.json").write_text(json.dumps(
        {"latest_step": 2, "latest_path": "ckpt-00000002.msgpack"}))
    (w0 / "train_log.jsonl").write_text('{"step": 2}\n')
    c.run_train()
    c.poll()
    assert (w0 / "ckpt-00000002.msgpack").stat().st_size == 50
    raw = [json.loads(line) for line in
           c.exec.journal_path.read_text().splitlines()]
    f = next(r for r in raw if r.get("event") == "fault")
    assert f["action"] == "corrupt_latest_checkpoint"
    assert f["target"] == "ckpt-00000002.msgpack" and f["truncated_to"] == 50
    c.delete()
