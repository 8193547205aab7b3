"""The port's failover client and load generator (``distributedmnist_
tpu_torch/servesvc/client.py``, ``loadgen.py``) against the reference's,
and ``launch serve`` / ``launch serve-load`` end to end on the CPU:

* ``summarize_outcomes`` and ``summarize_window`` equal the reference's
  on the same outcome lists; ``make_input_fn`` / ``make_prompt_fn`` make
  the reference's requests; ``read_latest_window`` and ``load_outcomes``
  read a journal as the reference's do;
* for a scripted set of dead and live endpoints, the order the client
  tries them in, its quarantine and its attempt books equal the
  reference client's with the same seed;
* ``launch serve`` (a CNN checkpoint, ``--device cpu``) and ``launch
  serve-load`` as processes: a publish during the load is swapped in
  with no dropped request, and SIGTERM drains the replica.
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

from distributedmnist_tpu.servesvc import client as ref_client
from distributedmnist_tpu.servesvc import loadgen as ref_loadgen
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.servesvc import client, loadgen
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _outcomes(seed: int, n: int, decode: bool) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        status = rng.choice(["ok", "ok", "ok", "rejected", "error"])
        rec = {"event": "load", "action": "outcome", "id": i,
               "time": 100.0 + float(rng.random() * 10),
               "status": str(status),
               "reason": (None if status == "ok" else str(rng.choice(
                   ["overloaded", "deadline_exceeded", "unavailable"]))),
               "model_step": int(rng.choice([10, 20])),
               "tier": [None, "fp32", "int8"][i % 3],
               "attempts": int(rng.integers(1, 4)),
               "retried": bool(rng.random() < 0.3),
               "endpoint": "127.0.0.1:1",
               "latency_ms": round(float(rng.random() * 50), 3)}
        if decode:
            rec.update(ttft_ms=round(float(rng.random() * 9), 3),
                       itl_ms=round(float(rng.random() * 3), 3),
                       tokens=int(rng.integers(1, 20)))
        out.append(rec)
    return out


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("n", [0, 1, 57])
def test_summaries_equal_the_references(n, decode):
    outs = _outcomes(n, n, decode)
    assert loadgen.summarize_outcomes(outs, n + 2, 3.5) == \
        ref_loadgen.summarize_outcomes(outs, n + 2, 3.5)
    for window in (1.0, 4.0, 20.0):
        assert loadgen.summarize_window(outs, n, 110.0, window) == \
            ref_loadgen.summarize_window(outs, n, 110.0, window)


def test_request_makers_equal_the_references():
    for shape, dtype in (((28, 28, 1), "float32"), ((16,), "int32")):
        got = loadgen.make_input_fn(shape, dtype, vocab=32)
        want = ref_loadgen.make_input_fn(shape, dtype, vocab=32)
        assert all(got(i) == want(i) for i in range(5))
    got = loadgen.make_prompt_fn(32, 16, 3)
    want = ref_loadgen.make_prompt_fn(32, 16, 3)
    assert all(got(i) == want(i) for i in range(20))


def test_journal_readers_equal_the_references(tmp_path):
    path = tmp_path / "loadgen.jsonl"
    recs = ([{"event": "load", "action": "issue", "id": i, "time": 1.0}
             for i in range(3)] + _outcomes(3, 3, False)
            + [{"event": "load", "action": "window", "time": 9.0,
                "issued": 3}])
    path.write_text("".join(json.dumps(r) + "\n" for r in recs)
                    + '{"event": "load", "act')  # a torn tail
    assert loadgen.load_outcomes(path) == ref_loadgen.load_outcomes(path)
    assert loadgen.read_latest_window(path) == \
        ref_loadgen.read_latest_window(path) == recs[-1]
    assert loadgen.read_latest_window(tmp_path / "none") is None


def test_quarantine_order_equals_the_references(monkeypatch):
    """Endpoints 1 and 3 refuse; the same seed gives the same endpoint
    per attempt, the same benches and the same attempt books."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    dead = {("h", 1), ("h", 3)}
    eps = [("h", 1), ("h", 2), ("h", 3), ("h", 4)]

    def run(mod):
        tried = []

        def one_attempt(self, payload, host, port, timeout_s):
            tried.append(port)
            if (host, port) in dead:
                raise ConnectionRefusedError("refused")
            return {"status": "ok", "id": json.loads(payload)["id"]}

        monkeypatch.setattr(mod.ServeClient, "_one_attempt", one_attempt)
        c = mod.ServeClient(eps, deadline_s=30.0, max_attempts=4,
                            quarantine_s=30.0, seed=5)
        books = []
        for i in range(6):
            out = c.request([0.0], request_id=i)
            books.append((out["status"], out["attempts"], out["retried"],
                          out["endpoint"], c.quarantined()))
        return tried, books

    got, want = run(client), run(ref_client)
    assert got == want
    assert got[1][-1][4] == [("h", 1), ("h", 3)]


def test_discover_endpoints_equals_the_references(tmp_path):
    for w, body in ((0, {"host": "127.0.0.1", "port": 5}), (1, "torn"),
                    (2, {"host": "127.0.0.1", "port": 7})):
        d = tmp_path / f"worker{w}"
        d.mkdir()
        (d / "serve.json").write_text(body if isinstance(body, str)
                                      else json.dumps(body))
    assert client.discover_endpoints(tmp_path) == \
        ref_client.discover_endpoints(tmp_path) == [
            {"worker": 0, "host": "127.0.0.1", "port": 5},
            {"worker": 2, "host": "127.0.0.1", "port": 7}]


def test_run_load_journals_every_request(tmp_path):
    """Against a stand-in client: every issue has one outcome, window
    snapshots land, and the summary is the reference's of the same
    outcome records."""
    class Fake:
        def request(self, inputs, request_id=None, deadline_s=None):
            time.sleep(0.002)
            return {"status": "ok" if request_id % 5 else "rejected",
                    "reason": None if request_id % 5 else "bad_request",
                    "model_step": 10, "tier": "int8", "attempts": 1,
                    "latency_ms": 2.0}

    path = tmp_path / "lg.jsonl"
    summary = loadgen.run_load(Fake(), 40, 4, lambda i: [i],
                               journal_path=path, window_s=0.02)
    issues, outcomes = loadgen.load_outcomes(path)
    assert len(issues) == len(outcomes) == 40
    assert sorted(r["id"] for r in outcomes) == list(range(40))
    want = ref_loadgen.summarize_outcomes(outcomes, 40,
                                          summary["duration_s"])
    # the rate divides by the unrounded duration
    rate = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k != "throughput_rps"}
    assert rate(summary) == rate(want)
    assert summary["dropped"] == 0 and summary["rejected"] == 8
    assert loadgen.read_latest_window(path) is not None


def _publish(staging: Path, serve_dir: Path, step: int) -> None:
    name = f"ckpt-{step:08d}.msgpack"
    serve_dir.mkdir(parents=True, exist_ok=True)
    for sfx in ("", ".sha256"):
        shutil.copy2(staging / (name + sfx), serve_dir / (name + sfx))
    tmp = serve_dir / "checkpoint.json.tmp"
    tmp.write_text(json.dumps({"latest_step": step, "latest_path": name,
                               "written_at": time.time()}))
    tmp.replace(serve_dir / "checkpoint.json")


def test_launch_serve_and_serve_load_on_the_cpu(tmp_path):
    staging = tmp_path / "staging"
    Trainer(ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic", "batch_size": 64,
                 "synthetic_train_size": 512, "synthetic_test_size": 64,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32"}, "mesh": {"num_replicas": 1},
        "train": {"max_steps": 20, "log_every_steps": 10,
                  "save_interval_steps": 10, "save_results_period": 0,
                  "summary_every_steps": 0, "keep_checkpoints": 0,
                  "train_dir": str(staging)}}), device="cpu").run()
    pub, serve_dir, out = tmp_path / "pub", tmp_path / "serve", \
        tmp_path / "loadgen.jsonl"
    _publish(staging, pub, 10)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    launch = [sys.executable, "-m", "distributedmnist_tpu_torch.launch"]
    server = subprocess.Popen(
        launch + ["serve", "--train-dir", str(pub), "--serve-dir",
                  str(serve_dir), "--device", "cpu", "--port", "0",
                  "--poll-secs", "0.05"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not (serve_dir / "serve.json").exists():
            assert server.poll() is None, server.stderr.read()[-3000:]
            assert time.time() < deadline, "the replica never came up"
            time.sleep(0.1)
        port = json.loads((serve_dir / "serve.json").read_text())["port"]

        def publish_mid_load():
            while (not out.exists()
                   or out.read_text().count('"outcome"') < 100):
                time.sleep(0.01)
            _publish(staging, pub, 20)

        t = threading.Thread(target=publish_mid_load, daemon=True)
        t.start()
        load = subprocess.run(
            launch + ["serve-load", "--endpoints", f"127.0.0.1:{port}",
                      "--requests", "600", "--concurrency", "3",
                      "--out", str(out)], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=300)
        t.join(timeout=10)
        assert load.returncode == 0, load.stderr[-3000:]
        summary = json.loads(load.stdout.strip().splitlines()[-1])
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            raise
    assert server.returncode == 0
    assert summary["issued"] == summary["terminal"] == 600
    assert summary["dropped"] == 0 and summary["responses"] == 600
    assert summary["model_steps_served"] == [10, 20]
    assert summary["tiers_served"] == ["fp32"]
    recs = [json.loads(line) for line in
            (serve_dir / "serve_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["action"] == "weight_swap"] == \
        [10, 20]
    assert recs[-1]["action"] == "serve_stop"
