"""Tensor-parallel serving groups in the port (``distributedmnist_tpu_torch/
servesvc/tp_group.py``, the ``ServingReplica``/``DecodeReplica`` TP
branch, ``launch serve --tp-ranks``) on the CPU, held against the
reference's ``tests/test_tp_serving.py`` and its TP replicas:

* **lifecycle** — every case of the reference's test against the port's
  supervisor (stub rank processes): die-as-a-unit and restart, the spent
  budget, rank 0's socket reset through the chaos proxy, argv rewriting
  with the rendezvous environment (a fresh port each attempt), the
  ``serve_group`` invariant on a unit restart and on a half-dead group,
  its skip without ``group_log.jsonl``; the port's journal also passes
  the reference's invariant, and a restarted supervisor numbers its
  attempts on;
* **digest** — ``rank_shard_digest`` equals the reference's hex digest
  for the reference's ``LM_MODEL`` params converted through
  ``models/convert.py``, at ranks 0-1 of 2 and 0-3 of 4, and with no
  specs;
* **the group's forward** — two gloo processes restore a reference
  checkpoint onto the serving topology; the TP forward, prefill and a
  paged decode step (dense and flash attention, the kernels' plain
  versions) give logits within 1e-5 of the largest of the reference's
  on the same params, each rank caching its ``h / 2`` heads;
* **the group serving** — ``launch serve --tp-ranks 2 --device cpu``
  (one-shot and ``--decode``) answers as the reference's replicas at
  ``tp_ranks=2`` on the simulated mesh do: equal predictions, greedy
  tokens equal over 3 prompts × 4 tokens, followers' ``shard_verify``
  digests equal to the reference's; a publish is installed by every
  rank at one boundary; a SIGKILL of rank 1 mid-traffic brings
  ``group_down``, a restart, and serving again, every request reaching
  a terminal outcome;
* **refusals** — a CNN at ``tp_ranks=2`` in both packages, heads that
  do not divide, a quantized tier, a replica without its group.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from _torch_mp import REPO, run_world
from _torch_threads import one_torch_thread  # noqa: F401

LM_MODEL = {"name": "transformer", "seq_len": 64, "model_dim": 64,
            "num_heads": 4, "num_layers": 2, "vocab_size": 32,
            "compute_dtype": "float32", "attention_impl": "dense"}
PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11])
NEW_TOKENS = 4


def _stub_spawn(rank, attempt):
    return subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])


def _group_records(serve_dir) -> list[dict]:
    p = Path(serve_dir) / "group_log.jsonl"
    return [json.loads(l) for l in p.read_text().splitlines() if l.strip()]


def _actions(recs):
    return [r["action"] for r in recs]


def _records(path) -> list[dict]:
    p = Path(path)
    if not p.exists():
        return []
    return [json.loads(l) for l in p.read_text().splitlines() if l.strip()]


def _wait(pred, timeout_s: float, what: str) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout_s:.0f} s waiting for "
                         f"{what}")


# ---------------------------------------------------------------------------
# supervisor lifecycle (≙ tests/test_tp_serving.py)
# ---------------------------------------------------------------------------

def test_group_die_as_a_unit_and_restart(tmp_path):
    from distributedmnist_tpu.obsv.invariants import \
        check_serve_group as ref_check
    from distributedmnist_tpu_torch.obsv.invariants import check_serve_group
    from distributedmnist_tpu_torch.servesvc.tp_group import ServeGroup

    g = ServeGroup(tmp_path / "worker1", 2, _stub_spawn, max_restarts=2,
                   poll_secs=0.01)
    g.start()
    first = dict(g.procs)
    assert all(p.poll() is None for p in first.values())
    roster = json.loads((tmp_path / "worker1" / "group.json").read_text())
    assert roster["ranks"] == 2 and roster["attempt"] == 0
    assert set(roster["pids"]) == {"0", "1"}

    first[1].kill()                      # murder one rank
    first[1].wait()
    assert g.step()                      # detect → teardown → restart
    assert first[0].poll() is not None   # the survivor was killed too
    assert g.attempt == 1
    assert all(p.poll() is None for p in g.procs.values())
    acts = _actions(_group_records(tmp_path / "worker1"))
    i_exit = acts.index("rank_exit")
    assert acts[:2] == ["group_start", "rank_spawn"]
    assert acts[i_exit:i_exit + 2] == ["rank_exit", "group_down"]
    assert "group_restart" in acts[i_exit:]
    assert acts.count("group_start") == 2

    g.stop()
    assert all(p.poll() is not None for p in g.procs.values())
    assert _actions(_group_records(tmp_path / "worker1"))[-1] == "group_stop"
    # the port's journal replays clean through both packages' invariant
    for check in (check_serve_group, ref_check):
        violations, applicable = check(tmp_path)
        assert applicable and not violations


def test_group_restart_budget_exhausted(tmp_path):
    from distributedmnist_tpu_torch.servesvc.tp_group import ServeGroup

    g = ServeGroup(tmp_path / "g", 2, _stub_spawn, max_restarts=0,
                   poll_secs=0.01)
    g.start()
    g.procs[0].kill()
    g.procs[0].wait()
    assert not g.step()                  # budget 0: over, no respawn
    acts = _actions(_group_records(tmp_path / "g"))
    assert acts[-3:] == ["rank_exit", "group_down", "group_stop"]
    assert "group_restart" not in acts
    assert all(p.poll() is not None for p in g.procs.values())


def test_restarted_supervisor_numbers_attempts_on(tmp_path):
    """A worker killed with its group and started again (a chaos kill of
    the supervisor) continues the journal: its first attempt follows the
    last one's, so the ``serve_group`` replay stays clean, and its
    restart budget is its own."""
    from distributedmnist_tpu_torch.obsv.invariants import check_serve_group
    from distributedmnist_tpu_torch.servesvc.tp_group import ServeGroup

    d = tmp_path / "worker1"
    g = ServeGroup(d, 2, _stub_spawn, max_restarts=1, poll_secs=0.01)
    g.start()
    g._kill_all()                        # the supervisor dies with them
    again = ServeGroup(d, 2, _stub_spawn, max_restarts=1, poll_secs=0.01)
    assert again.attempt == 1
    again.start()
    again.procs[1].kill()
    again.procs[1].wait()
    assert again.step() and again.attempt == 2
    again.stop()
    assert [r["attempt"] for r in _group_records(d)
            if r["action"] == "group_start"] == [0, 1, 2]
    violations, applicable = check_serve_group(tmp_path)
    assert applicable and not violations


def test_group_restart_on_rank0_socket_reset_via_proxy(tmp_path):
    """A rank whose WIRE dies (a chaos-proxy reset mid-stream, not a
    signal) exits like any other crash: the supervisor journals the
    whole die-as-a-unit chain."""
    import socket

    from distributedmnist_tpu_torch.launch.netchaos import ChaosProxy
    from distributedmnist_tpu_torch.servesvc.tp_group import ServeGroup

    lsock = socket.create_server(("127.0.0.1", 0))
    lsock.settimeout(0.2)
    up_port = lsock.getsockname()[1]
    stop = threading.Event()

    def streamer():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except TimeoutError:
                continue
            with conn:
                try:
                    while not stop.is_set():
                        conn.sendall(b"x" * 16)
                        time.sleep(0.01)
                except OSError:
                    pass

    t = threading.Thread(target=streamer, daemon=True)
    t.start()
    proxy = ChaosProxy(("127.0.0.1", up_port),
                       [{"kind": "reset", "after_bytes": 64}], worker=0)
    proxy_port = proxy.start()
    reader = ("import socket, sys\n"
              f"s = socket.create_connection(('127.0.0.1', {proxy_port}),"
              " timeout=10)\n"
              "s.settimeout(10)\n"
              "try:\n"
              "    while True:\n"
              "        if not s.recv(4096):\n"
              "            sys.exit(1)\n"
              "except OSError:\n"
              "    sys.exit(1)\n")

    def spawn(rank, attempt):
        if rank == 0:
            return subprocess.Popen([sys.executable, "-c", reader])
        return _stub_spawn(rank, attempt)

    g = ServeGroup(tmp_path / "g", 2, spawn, max_restarts=2,
                   poll_secs=0.01)
    try:
        g.start()
        deadline = time.time() + 10.0
        while g.attempt == 0 and time.time() < deadline:
            g.step()
            time.sleep(0.02)
        assert g.attempt == 1, "proxy reset never took rank 0 down"
        assert all(p.poll() is None for p in g.procs.values())
        recs = _group_records(tmp_path / "g")
        acts = _actions(recs)
        i_exit = acts.index("rank_exit")
        assert acts[i_exit:i_exit + 2] == ["rank_exit", "group_down"]
        assert "group_restart" in acts[i_exit:]
        assert recs[i_exit]["rank"] == 0
    finally:
        g.stop()
        proxy.stop()
        stop.set()
        t.join(timeout=5)
        lsock.close()


def test_default_spawn_fn_rewrites_rank_argv(tmp_path, monkeypatch):
    """The supervisor re-invokes the SAME serve command per rank with
    only the serve dir and rank rewritten (stale ``--tp-rank*`` flags
    stripped, the two-token form too), each rank's environment holding
    the group's rendezvous on a port fresh for each attempt."""
    from distributedmnist_tpu_torch.servesvc import tp_group

    captured = []

    class FakePopen:
        pid = 4242

        def __init__(self, cmd, **kw):
            captured.append((cmd, kw))

    monkeypatch.setattr(tp_group.subprocess, "Popen", FakePopen)
    monkeypatch.setenv("DMT_STANDBY_ACTIVATION", "/tmp/act")
    base = ["serve", "--train-dir", "/pub", "--serve-dir", "old",
            "--tp-ranks", "2", "--decode", "--port", "0", "--tp-rank=1"]
    spawn = tp_group.default_spawn_fn(base, tmp_path / "w1", 2)
    for attempt in (0, 1):
        spawn(0, attempt)
        spawn(1, attempt)
    for i, (cmd, kw) in enumerate(captured):
        rank = i % 2
        assert cmd[1:3] == ["-m", "distributedmnist_tpu_torch.launch"]
        args = cmd[cmd.index("serve"):]
        assert args.count("--serve-dir") == 1 and "old" not in args
        assert args.count("--tp-rank") == 1
        assert args[args.index("--tp-rank") + 1] == str(rank)
        assert args[args.index("--tp-ranks") + 1] == "2"
        assert "--decode" in args and "--train-dir" in args
        env = kw["env"]
        assert (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"]) == (
            str(rank), str(rank), "2")
        assert env["MASTER_ADDR"] == "127.0.0.1"
        assert "DMT_STANDBY_ACTIVATION" not in env
    assert (captured[0][0][captured[0][0].index("--serve-dir") + 1]
            == str(tmp_path / "w1"))
    assert (captured[1][0][captured[1][0].index("--serve-dir") + 1]
            == str(tmp_path / "w1" / "rank1"))
    ports = [kw["env"]["MASTER_PORT"] for _, kw in captured]
    # one port a group attempt, shared by its ranks, fresh the next time
    assert ports[0] == ports[1] and ports[2] == ports[3]
    assert ports[0] != ports[2]


def _write_group_log(d: Path, actions: list[dict]) -> None:
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "group_log.jsonl", "w") as f:
        for a in actions:
            f.write(json.dumps({"event": "serve", "time": time.time(),
                                **a}) + "\n")


def test_serve_group_invariant_passes_on_unit_restart(tmp_path):
    from distributedmnist_tpu_torch.obsv.invariants import check_serve_group

    _write_group_log(tmp_path / "worker1", [
        {"action": "group_start", "ranks": 2, "attempt": 0},
        {"action": "rank_spawn", "rank": 0, "pid": 1},
        {"action": "rank_spawn", "rank": 1, "pid": 2},
        {"action": "rank_exit", "rank": 1, "pid": 2, "rc": -9},
        {"action": "group_down", "reason": "rank 1 exited (rc=-9)",
         "ranks": 2, "rank": 1},
        {"action": "group_restart", "attempt": 1, "backoff_s": 0.25},
        {"action": "group_start", "ranks": 2, "attempt": 1},
        {"action": "group_stop", "ranks": 2},
    ])
    violations, applicable = check_serve_group(tmp_path)
    assert applicable and not violations


def test_serve_group_invariant_catches_half_dead_group(tmp_path):
    from distributedmnist_tpu_torch.obsv.invariants import check_serve_group

    _write_group_log(tmp_path / "worker1", [
        {"action": "group_start", "ranks": 2, "attempt": 0},
        {"action": "rank_exit", "rank": 1, "pid": 2, "rc": -9},
        {"action": "group_start", "ranks": 2, "attempt": 1},
    ])
    violations, applicable = check_serve_group(tmp_path)
    assert applicable
    assert any("no group_down" in v.detail for v in violations)

    _write_group_log(tmp_path / "worker2", [
        {"action": "group_start", "ranks": 2, "attempt": 0},
        {"action": "rank_exit", "rank": 0, "pid": 1, "rc": 1},
    ])
    violations, _ = check_serve_group(tmp_path)
    assert any(v.worker == 2 for v in violations)


def test_check_run_skips_serve_group_without_group_log(tmp_path):
    from distributedmnist_tpu_torch.obsv.invariants import check_run

    (tmp_path / "worker0").mkdir()
    res = check_run(tmp_path, outcome={})
    assert res["verdicts"]["serve_group"] == "skipped"


# ---------------------------------------------------------------------------
# shard digests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_params():
    """The reference's ``LM_MODEL`` params (numpy) and its TP specs."""
    import jax

    from distributedmnist_tpu.core.config import ModelConfig
    from distributedmnist_tpu.models.registry import get_model

    model = get_model(ModelConfig(**LM_MODEL))
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    return params, model.tp_param_specs("model")


@pytest.mark.parametrize("rank,ranks,with_specs",
                         [(0, 2, True), (1, 2, True), (0, 4, True),
                          (1, 4, True), (2, 4, True), (3, 4, True),
                          (1, 2, False)])
def test_rank_shard_digest_is_the_references(lm_params, rank, ranks,
                                             with_specs):
    from distributedmnist_tpu.servesvc.tp_group import \
        rank_shard_digest as ref_digest
    from distributedmnist_tpu_torch.core.config import ModelConfig
    from distributedmnist_tpu_torch.models.convert import \
        params_from_reference
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        RuleAxes, match_partition_rules)
    from distributedmnist_tpu_torch.servesvc.tp_group import (
        held_shard_digest, rank_shard_digest)

    params, ref_specs = lm_params
    ours = params_from_reference(params, device="cpu")
    model = get_model(ModelConfig(**LM_MODEL))
    specs = match_partition_rules(
        model.partition_rules(RuleAxes(model="model")), ours)
    want = ref_digest(params, ref_specs if with_specs else None, rank,
                      ranks)
    got = rank_shard_digest(ours, specs if with_specs else None, rank,
                            ranks)
    assert got == want
    # the same digest from numpy leaves, and (with specs) from the shard
    # a rank holds after the group's split
    assert rank_shard_digest(params, specs if with_specs else None, rank,
                             ranks) == want
    if with_specs:
        from distributedmnist_tpu_torch.parallel.partition_rules import \
            map_leaves, shard_leaf
        shard = map_leaves(
            lambda x, spec: shard_leaf(x, spec, "model", rank, ranks),
            ours, specs)
        assert held_shard_digest(shard) == want
        assert want != ref_digest(params, ref_specs, (rank + 1) % ranks,
                                  ranks)


# ---------------------------------------------------------------------------
# the reference's published checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Steps 10 and 20 of one reference training run of ``LM_MODEL``."""
    from distributedmnist_tpu.core.config import ExperimentConfig
    from distributedmnist_tpu.train.loop import Trainer

    staging = tmp_path_factory.mktemp("tp_staging")
    cfg = ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic_lm", "batch_size": 32,
                 "synthetic_train_size": 256, "synthetic_test_size": 64,
                 "use_native_pipeline": False},
        "model": dict(LM_MODEL),
        "train": {"max_steps": 20, "log_every_steps": 10,
                  "train_dir": str(staging), "save_interval_steps": 10,
                  "save_results_period": 0, "async_checkpoint": False},
    })
    Trainer(cfg).run()
    return staging


def publish_step(staging: Path, dst: Path, step: int) -> None:
    dst.mkdir(parents=True, exist_ok=True)
    name = f"ckpt-{step:08d}.msgpack"
    for sfx in ("", ".sha256"):
        shutil.copy2(staging / (name + sfx), dst / (name + sfx))
    tmp = dst / "checkpoint.json.tmp"
    tmp.write_text(json.dumps({"latest_step": step, "latest_path": name,
                               "written_at": time.time()}))
    tmp.replace(dst / "checkpoint.json")


def _list_form(tree):
    """A saved state dict's params with its index-keyed dicts as lists
    (the form the reference's functions take)."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [_list_form(tree[str(i)]) for i in range(len(tree))]
        return {k: _list_form(v) for k, v in tree.items()}
    return tree


def _ref_params(staging: Path, step: int):
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    tree, _, got = ckpt.restore_params(staging, step=step)
    assert got == step
    return _list_form(tree)


def test_tp_forward_logits_match_the_reference(staged, tmp_path):
    """Two gloo ranks restore step 20 onto the serving topology: the
    group's one-shot, prefill and paged decode-step logits are the
    reference's on the same params within 1e-5 of the largest logit,
    with dense attention and with flash (its plain version here); each
    rank holds and caches its two of the four heads."""
    import jax.numpy as jnp

    from distributedmnist_tpu.core.config import ModelConfig
    from distributedmnist_tpu.models.registry import get_model
    from distributedmnist_tpu.servesvc.tp_group import rank_shard_digest

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32, (2, 16)).astype(np.int64)
    prompt = rng.integers(0, 32, (1, 7)).astype(np.int64)
    nxt = 5
    jobs = [(impl, {"case": "tp_serving_forward", "train_dir": str(staged),
                    "step": 20, "tokens": tokens, "prompt": prompt,
                    "next": nxt, "attention_impl": impl})
            for impl in ("dense", "flash")]
    out = run_world(tmp_path / "world", 2, jobs,
                    cases="_torch_tp_serving_cases")
    params = _ref_params(staged, 20)
    ref = get_model(ModelConfig(**LM_MODEL))
    want = np.asarray(ref.apply(params, jnp.asarray(tokens, jnp.int32)))
    want_prefill, want_k, _ = (np.asarray(a) for a in ref.decode_prefill(
        params, jnp.asarray(prompt, jnp.int32)))
    full = np.concatenate([prompt, [[nxt]]], axis=1)
    want_decode = np.asarray(ref.apply(params, jnp.asarray(
        full, jnp.int32)))[:, -1]
    specs = ref.tp_param_specs("model")
    for impl, _ in jobs:
        for rank, res in enumerate(r[impl] for r in out):
            assert res["step"] == 20 and res["heads_cached"] == 2
            for got, w in ((res["logits"], want),
                           (res["prefill"], want_prefill),
                           (res["decode"], want_decode)):
                assert got.shape == w.shape
                assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()
            k = want_k[:, :, :, 2 * rank:2 * rank + 2]
            assert np.abs(res["k"] - k).max() <= 1e-5 * np.abs(k).max()
            assert res["digest"] == rank_shard_digest(params, specs, rank,
                                                      2)


# ---------------------------------------------------------------------------
# `launch serve --tp-ranks 2` against the reference's TP replicas
# ---------------------------------------------------------------------------

def _supervisor(pub: Path, serve_dir: Path, *extra: str) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    serve_dir.mkdir(parents=True, exist_ok=True)
    log = open(serve_dir.parent / f"{serve_dir.name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "distributedmnist_tpu_torch.launch", "serve",
         "--train-dir", str(pub), "--serve-dir", str(serve_dir),
         "--port", "0", "--poll-secs", "0.1", "--device", "cpu",
         "--tp-ranks", "2", *extra],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)


def _endpoint(serve_dir: Path):
    try:
        ep = json.loads((serve_dir / "serve.json").read_text())
    except (OSError, ValueError):
        return None
    return ep["host"], int(ep["port"])


@pytest.fixture(scope="module")
def groups(staged, tmp_path_factory):
    """Step 10 published; a port decode group (``worker1``) and one-shot
    group (``worker2``) of 2 gloo ranks following it, and the
    reference's decode and one-shot replicas at ``tp_ranks=2`` on the
    simulated mesh following the same dir."""
    from distributedmnist_tpu.core.config import (DecodeConfig,
                                                  ServeConfig)
    from distributedmnist_tpu.servesvc.decode import DecodeReplica
    from distributedmnist_tpu.servesvc.server import ServingReplica

    root = tmp_path_factory.mktemp("tp_groups")
    pub = root / "pub"
    publish_step(staged, pub, 10)
    decode_flags = ("--decode", "--decode-slots", "2", "--max-new-tokens",
                    str(NEW_TOKENS), "--max-prompt-len", "16")
    sups = {1: _supervisor(pub, root / "trial" / "worker1", *decode_flags),
            2: _supervisor(pub, root / "trial" / "worker2")}
    ref_dec = DecodeReplica(
        pub, serve_dir=root / "ref_decode",
        scfg=ServeConfig(poll_secs=0.1, tp_ranks=2),
        dcfg=DecodeConfig(decode_slots=2, block_size=16, num_blocks=32,
                          max_prompt_len=16, max_new_tokens=NEW_TOKENS))
    ref_one = ServingReplica(pub, serve_dir=root / "ref_one",
                             scfg=ServeConfig(poll_secs=0.1, tp_ranks=2))
    ref_dec.start()
    ref_one.start()
    try:
        for k in (1, 2):
            _wait(lambda: _endpoint(root / "trial" / f"worker{k}")
                  is not None or sups[k].poll() is not None, 120,
                  f"worker{k}'s serve.json")
            assert sups[k].poll() is None, (
                root / "trial" / f"worker{k}.log").read_text()[-3000:]
        yield {"root": root, "pub": pub, "trial": root / "trial",
               "sups": sups, "ref_decode": ref_dec, "ref_one": ref_one}
    finally:
        for p in sups.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in sups.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        ref_dec.stop()
        ref_one.stop()


def _client(*eps):
    from distributedmnist_tpu_torch.servesvc import ServeClient
    return ServeClient(list(eps), deadline_s=60.0, max_attempts=4)


def _generate(ep, tag: str, prompts=PROMPTS):
    c = _client(ep)
    outs = [c.generate(p, request_id=f"{tag}{i}", max_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    assert all(o["status"] == "ok" for o in outs), outs
    return outs


def test_group_decodes_and_predicts_as_the_reference(groups):
    """Greedy tokens over 3 prompts × 4 new tokens equal the reference's
    TP decode replica's; one-shot predictions equal its TP classification
    replica's, probabilities within 1e-5; the followers installed the
    published step and journaled its shard digest, the reference's for
    rank 1."""
    from distributedmnist_tpu.servesvc.client import ServeClient as RefClient
    from distributedmnist_tpu.servesvc.tp_group import rank_shard_digest
    from distributedmnist_tpu_torch.servesvc.loadgen import make_input_fn

    trial = groups["trial"]
    got = _generate(_endpoint(trial / "worker1"), "parity")
    rc = RefClient([("127.0.0.1", groups["ref_decode"].bound_port)],
                   deadline_s=60.0)
    want = [rc.generate(p, max_tokens=NEW_TOKENS) for p in PROMPTS]
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert all(len(o["tokens"]) == NEW_TOKENS and o["model_step"] == 10
               for o in got)

    toks = make_input_fn([LM_MODEL["seq_len"]], "int32", vocab=32)
    c = _client(_endpoint(trial / "worker2"))
    rc1 = RefClient([("127.0.0.1", groups["ref_one"].bound_port)],
                    deadline_s=60.0)
    for i in range(3):
        a, b = c.request(toks(i), request_id=i), rc1.request(toks(i))
        assert a["status"] == b["status"] == "ok"
        assert a["prediction"] == b["prediction"]
        assert np.abs(np.array(a["probs"]) - b["probs"]).max() <= 1e-5

    from distributedmnist_tpu.core.config import ModelConfig
    from distributedmnist_tpu.models.registry import get_model
    specs = get_model(ModelConfig(**LM_MODEL)).tp_param_specs("model")
    want_digest = rank_shard_digest(_ref_params(groups["pub"], 10), specs,
                                    1, 2)
    for k in (1, 2):
        recs = [r for r in _records(trial / f"worker{k}" / "rank1"
                                    / "serve_log.jsonl")
                if r["action"] == "shard_verify"]
        assert [(r["rank"], r["step"], r["digest"]) for r in recs] == [
            (1, 10, want_digest)]
        beats = _records(trial / f"worker{k}" / "rank1" / "train_log.jsonl")
        assert any(b.get("tp_rank") == 1 and b["step"] == 1 for b in beats
                   if b["event"] == "heartbeat")


def test_group_hot_swaps_in_lockstep(groups, staged):
    """A publish while serving: every rank installs it at one boundary
    (the followers' ``shard_verify`` before rank 0's ``weight_swap``),
    and no answer after the flip names the old step; the tokens are the
    reference's on the new step."""
    trial, pub = groups["trial"], groups["pub"]
    ep = _endpoint(trial / "worker1")
    _generate(ep, "before")
    publish_step(staged, pub, 20)

    def swapped(k):
        return any(r["action"] == "weight_swap" and r["step"] == 20
                   for r in _records(trial / f"worker{k}"
                                     / "serve_log.jsonl"))
    _wait(lambda: swapped(1) and swapped(2), 60, "both groups' swap")
    _wait(lambda: groups["ref_decode"].model_step == 20, 60,
          "the reference's swap")
    got = _generate(ep, "after")
    assert all(o["model_step"] == 20 for o in got)
    from distributedmnist_tpu.servesvc.client import ServeClient as RefClient
    rc = RefClient([("127.0.0.1", groups["ref_decode"].bound_port)],
                   deadline_s=60.0)
    assert [o["tokens"] for o in got] == [
        rc.generate(p, max_tokens=NEW_TOKENS)["tokens"] for p in PROMPTS]
    recs = _records(trial / "worker1" / "serve_log.jsonl")
    i_swap = next(i for i, r in enumerate(recs)
                  if r["action"] == "weight_swap" and r["step"] == 20)
    after = [r for r in recs[i_swap:] if r["action"] in ("decode_finish",
                                                         "respond")]
    assert after and all(r["model_step"] == 20 for r in after)
    verify = [r for r in _records(trial / "worker1" / "rank1"
                                  / "serve_log.jsonl")
              if r["action"] == "shard_verify" and r["step"] == 20]
    assert len(verify) == 1 and verify[0]["time"] <= recs[i_swap]["time"]


def test_rank_kill_restarts_the_group_and_serving_resumes(groups):
    """SIGKILL of rank 1 while requests stream: the supervisor journals
    ``rank_exit`` → ``group_down`` → ``group_restart`` → ``group_start``,
    the restarted group serves again, and every request of the failover
    client reached a terminal outcome; the journal replays clean through
    the port's and the reference's ``serve_group`` invariant."""
    from distributedmnist_tpu.obsv.invariants import \
        check_serve_group as ref_check
    from distributedmnist_tpu_torch.obsv.invariants import check_serve_group
    from distributedmnist_tpu_torch.servesvc import ServeClient

    trial = groups["trial"]
    d = trial / "worker1"
    roster = json.loads((d / "group.json").read_text())
    client = ServeClient(lambda: [ep for ep in [_endpoint(d)] if ep],
                         deadline_s=90.0, max_attempts=40, backoff_s=0.25)
    outs: list = []
    stop = threading.Event()

    def load():
        i = 0
        while not stop.is_set() or len(outs) < 3:
            outs.append(client.generate(PROMPTS[i % 3],
                                        request_id=f"k{i}",
                                        max_tokens=NEW_TOKENS))
            i += 1

    t = threading.Thread(target=load, daemon=True)
    t.start()
    _wait(lambda: len(outs) >= 2, 60, "traffic before the kill")
    os.kill(int(roster["pids"]["1"]), signal.SIGKILL)
    _wait(lambda: "group_restart" in _actions(_group_records(d)), 60,
          "the unit restart")
    _wait(lambda: _endpoint(d) is not None, 120, "the restarted endpoint")
    n = len(outs)
    _wait(lambda: len(outs) >= n + 2, 120, "serving after the restart")
    stop.set()
    t.join(timeout=120)
    assert not t.is_alive()
    assert all(o["status"] == "ok" for o in outs), [
        o for o in outs if o["status"] != "ok"]
    acts = _actions(_group_records(d))
    i_exit = acts.index("rank_exit")
    assert acts[i_exit:i_exit + 3] == ["rank_exit", "group_down",
                                       "group_restart"]
    assert acts.count("group_start") == 2
    assert _group_records(d)[i_exit]["rank"] == 1
    for check in (check_serve_group, ref_check):
        violations, applicable = check(trial)
        assert applicable and not violations


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_cnn_tp_replica_refused_in_both_packages(tmp_path):
    from distributedmnist_tpu.core.config import \
        ExperimentConfig as RefConfig
    from distributedmnist_tpu.core.config import \
        ServeConfig as RefServeConfig
    from distributedmnist_tpu.core.config import ConfigError as RefError
    from distributedmnist_tpu.servesvc.server import \
        ServingReplica as RefReplica
    from distributedmnist_tpu_torch.core.config import (ConfigError,
                                                        ExperimentConfig,
                                                        ServeConfig)
    from distributedmnist_tpu_torch.servesvc import ServingReplica

    run = {"data": {"dataset": "synthetic", "batch_size": 8}}
    with pytest.raises(RefError, match="tp_ranks"):
        RefReplica(tmp_path / "nope", serve_dir=tmp_path / "a",
                   scfg=RefServeConfig(tp_ranks=2),
                   cfg=RefConfig.from_dict(run))
    with pytest.raises(ConfigError, match="tp_ranks"):
        ServingReplica(tmp_path / "nope", serve_dir=tmp_path / "b",
                       scfg=ServeConfig(tp_ranks=2),
                       cfg=ExperimentConfig.from_dict(run), device="cpu")


@pytest.mark.parametrize("case", ["heads", "tier", "no_group"])
def test_tp_replica_refusals(tmp_path, case):
    """Heads that do not divide over the ranks, a quantized tier, and a
    replica asked for a group it is not in are ConfigErrors naming
    ``tp_ranks``."""
    from distributedmnist_tpu_torch.core.config import (ConfigError,
                                                        ExperimentConfig,
                                                        ServeConfig)
    from distributedmnist_tpu_torch.servesvc import ServingReplica

    model = dict(LM_MODEL, num_heads=3, model_dim=48) if case == "heads" \
        else LM_MODEL
    scfg = ServeConfig(tp_ranks=2,
                       precision_tier="int8" if case == "tier" else "fp32")
    with pytest.raises(ConfigError, match="tp_ranks"):
        ServingReplica(tmp_path / "nope", serve_dir=tmp_path / "s",
                       scfg=scfg,
                       cfg=ExperimentConfig.from_dict({"model": model}),
                       device="cpu")
