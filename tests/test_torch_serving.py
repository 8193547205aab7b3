"""The port's classification serving replica (``distributedmnist_tpu_torch/
servesvc/server.py ServingReplica``, ``device="cpu"``) on the CPU,
mirroring the reference's ``tests/test_servesvc.py`` cases and held
against the reference's replica:

* a port replica and a reference replica on one published checkpoint
  answer the same requests with probabilities within 1e-5 (float32
  compute), the CNN's and the transformer's one-shot next-token
  distribution;
* hot-swap mid-traffic with no drop, a torn publish skipped, typed
  ``overloaded`` / ``deadline_exceeded`` / ``shutting_down`` rejects,
  the dedup cache and its bound, slowloris and half-open peers aborted;
  the client's failover and endpoint quarantine;
* the int8 tier preferred and reported, a torn or absent sidecar
  falling back to fp32 once a publish without wedging the follower;
* the replica's ``serve_log.jsonl`` and a load generator's journal,
  with a publish during the load, pass the reference's replay
  invariants (``obsv/invariants.py check_serving``: ``serve_outcomes``,
  ``serve_digest``, ``serve_monotone``) and its event schema.
"""

import json
import shutil
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distributedmnist_tpu_torch.core.config import (ExperimentConfig,
                                                    ServeConfig)
from distributedmnist_tpu_torch.servesvc import ServeClient, ServingReplica
from distributedmnist_tpu_torch.servesvc.loadgen import (make_input_fn,
                                                         run_load)
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

RUN = {"data": {"dataset": "synthetic", "batch_size": 64,
                "synthetic_train_size": 1024, "synthetic_test_size": 128,
                "use_native_pipeline": False},
       "model": {"compute_dtype": "float32"}, "mesh": {"num_replicas": 1},
       "quant": {"publish_tiers": "int8", "calibration_examples": 32,
                 "parity_epsilon": 1.0},
       "train": {"max_steps": 30, "log_every_steps": 10,
                 "save_interval_steps": 10, "save_results_period": 0,
                 "summary_every_steps": 0, "keep_checkpoints": 0}}


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A staging dir holding steps 10/20/30 of one port training run,
    each with an int8 sidecar — each test publishes them into its own
    dir at its own cadence."""
    staging = tmp_path_factory.mktemp("staging")
    cfg = ExperimentConfig.from_dict(
        {**RUN, "train": {**RUN["train"], "train_dir": str(staging)}})
    Trainer(cfg, device="cpu").run()
    assert ckpt.loadable_steps(staging) == [10, 20, 30]
    return {"staging": staging, "cfg": cfg}


def publish_step(staging: Path, serve_dir: Path, step: int,
                 truncate: bool = False, sidecar: bool = True,
                 tear_sidecar: bool = False) -> None:
    """Copy one staged step (artifact, its sidecar and the quant sidecar)
    into ``serve_dir`` and point ``checkpoint.json`` at it; ``truncate``
    / ``tear_sidecar`` tear the copied bytes (digests kept intact)."""
    serve_dir.mkdir(parents=True, exist_ok=True)
    names = [f"ckpt-{step:08d}.msgpack"]
    if sidecar:
        names.append(f"ckpt-{step:08d}.quant.msgpack")
    for name in names:
        for sfx in ("", ".sha256"):
            shutil.copy2(staging / (name + sfx), serve_dir / (name + sfx))
    torn = ([names[0]] if truncate else []) + (
        [names[-1]] if tear_sidecar else [])
    for name in torn:
        data = (serve_dir / name).read_bytes()
        (serve_dir / name).write_bytes(data[:max(1, len(data) // 2)])
    tmp = serve_dir / "checkpoint.json.tmp"
    tmp.write_text(json.dumps({"latest_step": step,
                               "latest_path": names[0],
                               "written_at": time.time()}))
    tmp.replace(serve_dir / "checkpoint.json")


def make_replica(published, tmp_path, first_step=10, **serve_kw):
    serve_src = tmp_path / "publish"
    publish_step(published["staging"], serve_src, first_step)
    rep = ServingReplica(serve_src, serve_dir=tmp_path / "replica",
                         scfg=ServeConfig(poll_secs=0.05, **serve_kw),
                         cfg=published["cfg"], device="cpu")
    return rep, serve_src


def raw_request(port: int, payload: dict, timeout=10.0) -> dict:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as conn:
        conn.settimeout(timeout)
        conn.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while b"\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def serve_records(rep) -> list[dict]:
    return [json.loads(line) for line in
            (rep.serve_dir / "serve_log.jsonl").read_text().splitlines()
            if line.strip()]


make_input = make_input_fn((28, 28, 1), "float32")


def _dead_port() -> int:
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    port = dead.getsockname()[1]
    dead.close()
    return port


# -- against the reference's replica -----------------------------------------

def test_port_and_reference_replicas_answer_alike(published, tmp_path):
    from distributedmnist_tpu.core.config import (
        ExperimentConfig as RefConfig, ServeConfig as RefServeConfig)
    from distributedmnist_tpu.servesvc.server import \
        ServingReplica as RefReplica
    rep, serve_src = make_replica(published, tmp_path, first_step=30)
    ref = RefReplica(serve_src, serve_dir=tmp_path / "ref",
                     scfg=RefServeConfig(poll_secs=0.05),
                     cfg=RefConfig.from_dict(published["cfg"].to_dict()))
    rep.start()
    ref.start()
    try:
        for i in range(6):
            payload = {"id": i, "inputs": make_input(i)}
            got = raw_request(rep.bound_port, payload)
            want = raw_request(ref.bound_port, payload)
            assert got["status"] == want["status"] == "ok"
            assert got["model_step"] == want["model_step"] == 30
            assert got["model_digest"] == want["model_digest"]
            assert got["prediction"] == want["prediction"]
            assert np.abs(np.array(got["probs"])
                          - np.array(want["probs"])).max() <= 1e-5
        meta, ref_meta = (raw_request(r.bound_port, {"meta": True})
                          for r in (rep, ref))
        assert {k: v for k, v in meta.items() if k != "device"} == ref_meta
    finally:
        rep.stop()
        ref.stop()


def test_transformer_one_shot_predict_matches_the_reference(tmp_path):
    """The classification replica serves a causal LM too: its answer is
    the next-token distribution at the last position (``lm_predictions``;
    the flash kernel's plain version on the CPU)."""
    import jax
    from distributedmnist_tpu.core.config import \
        ExperimentConfig as RefConfig
    from distributedmnist_tpu.models.registry import \
        get_model as ref_get_model
    from distributedmnist_tpu.parallel.api import init_train_state
    from distributedmnist_tpu.train.checkpoint import save_checkpoint
    run = {"model": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                     "num_heads": 4, "num_layers": 2, "vocab_size": 32,
                     "compute_dtype": "float32", "attention_impl": "flash"}}
    ref_cfg = RefConfig.from_dict(run)
    model = ref_get_model(ref_cfg.model)
    state = init_train_state(model, ref_cfg)
    save_checkpoint(tmp_path / "pub", state, 5,
                    extra={"config": ref_cfg.to_dict()})
    rep = ServingReplica(tmp_path / "pub", serve_dir=tmp_path / "s",
                         device="cpu")
    rep.start()
    try:
        client = ServeClient([("127.0.0.1", rep.bound_port)],
                             deadline_s=30.0)
        meta = client.meta()
        assert meta["input_shape"] == [16] and meta["input_dtype"] == "int32"
        toks = make_input_fn([16], "int32", vocab=32)
        for i in range(3):
            out = client.request(toks(i), request_id=i)
            assert out["status"] == "ok" and len(out["probs"]) == 32
            logits = model.apply(state.params, np.asarray([toks(i)],
                                                          np.int32))
            want = np.asarray(jax.nn.softmax(logits[:, -1], axis=-1))[0]
            assert np.abs(np.array(out["probs"]) - want).max() <= 1e-5
    finally:
        rep.stop()


# -- the replica end to end (≙ tests/test_servesvc.py) ------------------------

def test_serve_responds_and_hot_swaps(published, tmp_path):
    rep, serve_src = make_replica(published, tmp_path)
    rep.start()
    try:
        out = raw_request(rep.bound_port, {"id": 1, "inputs": make_input(1)})
        assert out["status"] == "ok" and out["model_step"] == 10
        assert len(out["probs"]) == 10 and out["tier"] == "fp32"
        publish_step(published["staging"], serve_src, 20)
        deadline = time.time() + 30
        got_step, i = 10, 2
        while got_step < 20 and time.time() < deadline:
            out = raw_request(rep.bound_port,
                              {"id": i, "inputs": make_input(i)})
            assert out["status"] == "ok"  # zero drops across the swap
            got_step = out["model_step"]
            i += 1
        assert got_step == 20
        swaps = [r for r in serve_records(rep)
                 if r.get("action") == "weight_swap"]
        assert [s["step"] for s in swaps] == [10, 20]
        assert all(s.get("digest") for s in swaps)
        assert all(isinstance(s.get("swap_ms"), float) for s in swaps)
    finally:
        rep.stop()
    recs = serve_records(rep)
    admits = sum(1 for r in recs if r.get("action") == "admit")
    responds = sum(1 for r in recs if r.get("action") == "respond")
    rejects = sum(1 for r in recs if r.get("action") == "reject"
                  and r.get("admitted"))
    assert admits == responds + rejects and admits >= 2


def test_serve_skips_corrupt_publish(published, tmp_path):
    rep, serve_src = make_replica(published, tmp_path)
    rep.start()
    try:
        publish_step(published["staging"], serve_src, 20, truncate=True)
        time.sleep(0.5)  # several polls at the torn artifact
        out = raw_request(rep.bound_port, {"id": 1, "inputs": make_input(1)})
        assert out["status"] == "ok" and out["model_step"] == 10
        publish_step(published["staging"], serve_src, 30)
        deadline = time.time() + 30
        while rep.model_step < 30 and time.time() < deadline:
            time.sleep(0.05)
        assert rep.model_step == 30  # skipped 20 entirely
        recs = serve_records(rep)
        assert [r["step"] for r in recs
                if r.get("action") == "weight_swap"] == [10, 30]
        assert any(r.get("action") == "follow_corrupt_checkpoint_fallback"
                   for r in recs), recs
    finally:
        rep.stop()


def test_serve_admission_and_deadline(published, tmp_path):
    rep, _ = make_replica(published, tmp_path, queue_depth=1, max_batch=1)
    slow = threading.Event()
    real_predict = rep._tier_predict_fns["fp32"]

    def slow_predict(params, x):
        if slow.is_set():
            time.sleep(0.4)
        return real_predict(params, x)

    rep._tier_predict_fns["fp32"] = slow_predict
    rep.start()
    try:
        inputs = make_input(0)
        assert raw_request(rep.bound_port,
                           {"id": 0, "inputs": inputs})["status"] == "ok"
        slow.set()
        results: list[dict] = []

        def fire(i):
            results.append(raw_request(rep.bound_port,
                                       {"id": i, "inputs": inputs}))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(1, 9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        statuses: dict = {}
        for r in results:
            key = (r["status"], r.get("reason"))
            statuses[key] = statuses.get(key, 0) + 1
        assert statuses.get(("rejected", "overloaded"), 0) >= 1, statuses
        assert statuses.get(("ok", None), 0) >= 1, statuses
        assert len(results) == 8
        occupier = threading.Thread(target=fire, args=(98,))
        occupier.start()
        time.sleep(0.1)  # the occupier is inside the slow predict
        out = raw_request(rep.bound_port, {"id": 99, "inputs": inputs,
                                           "deadline_ms": 1})
        occupier.join(timeout=30)
        assert out == {"id": 99, "status": "rejected",
                       "reason": "deadline_exceeded",
                       "model_step": out["model_step"]}
    finally:
        rep.stop()


def test_serve_graceful_stop_sheds_typed(published, tmp_path):
    rep, _ = make_replica(published, tmp_path, max_batch=1)
    hold = threading.Event()
    real_predict = rep._tier_predict_fns["fp32"]

    def gated(params, x):
        hold.wait(timeout=5)
        return real_predict(params, x)

    rep._tier_predict_fns["fp32"] = gated
    rep.start()
    try:
        inputs = make_input(0)
        results: list[dict] = []
        threads = [threading.Thread(
            target=lambda i=i: results.append(
                raw_request(rep.bound_port, {"id": i, "inputs": inputs})))
            for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)  # admitted while the batcher is gated
        rep.request_stop()
        hold.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        rep.stop()
    assert len(results) == 4
    assert all(r["status"] in ("ok", "rejected") for r in results)
    assert all(r["reason"] == "shutting_down" for r in results
               if r["status"] == "rejected")
    recs = serve_records(rep)
    admits = sum(1 for r in recs if r.get("action") == "admit")
    terminals = sum(1 for r in recs if r.get("action") == "respond"
                    or (r.get("action") == "reject" and r.get("admitted")))
    assert admits == terminals


@pytest.mark.parametrize("bad", [{"inputs": [[0.0]]}, {"inputs": "x"},
                                 {"no_inputs": 1}])
def test_bad_requests_get_typed_bad_request(published, tmp_path, bad):
    rep, _ = make_replica(published, tmp_path)
    rep.start()
    try:
        out = raw_request(rep.bound_port, {"id": "b", **bad})
        assert out["status"] == "rejected" and out["reason"] == "bad_request"
    finally:
        rep.stop()


def test_client_fails_over_and_deadline(published, tmp_path):
    rep, _ = make_replica(published, tmp_path)
    rep.start()
    try:
        dead_port = _dead_port()
        client = ServeClient([("127.0.0.1", dead_port),
                              ("127.0.0.1", rep.bound_port)],
                             deadline_s=10.0, max_attempts=4)
        outs = [client.request(make_input(i), request_id=i)
                for i in range(3)]
        assert all(o["status"] == "ok" for o in outs), outs
        nothing = ServeClient([("127.0.0.1", dead_port)],
                              deadline_s=1.0, max_attempts=3)
        out = nothing.request(make_input(0), request_id=0)
        assert out["status"] == "error"
        assert out["reason"] in ("unavailable", "deadline_exceeded")
    finally:
        rep.stop()


def test_dedup_replay_answers_from_cache(published, tmp_path):
    rep, _ = make_replica(published, tmp_path)
    rep.start()
    try:
        payload = {"id": "r-7", "inputs": make_input(7)}
        first = raw_request(rep.bound_port, payload)
        replay = raw_request(rep.bound_port, payload)
        assert first["status"] == "ok" and replay == first
        assert rep.dedup_hits == 1
        acts = [(r["action"], r.get("id")) for r in serve_records(rep)
                if r.get("id") == "r-7"]
        assert acts.count(("respond", "r-7")) == 1
        assert acts.count(("admit", "r-7")) == 1
        assert ("dedup_hit", "r-7") in acts[acts.index(("respond",
                                                        "r-7")):]
    finally:
        rep.stop()


def test_dedup_cache_bound_evicts_oldest(published, tmp_path):
    rep, _ = make_replica(published, tmp_path, dedup_cache_size=2)
    rep.start()
    try:
        for i in range(3):  # id 0 evicted when id 2 lands
            raw_request(rep.bound_port, {"id": i, "inputs": make_input(i)})
        out = raw_request(rep.bound_port, {"id": 0, "inputs": make_input(0)})
        assert out["status"] == "ok" and rep.dedup_hits == 0
        assert sum(1 for r in serve_records(rep)
                   if r.get("action") == "respond" and r.get("id") == 0) == 2
    finally:
        rep.stop()


def test_slowloris_aborted_while_siblings_served(published, tmp_path):
    rep, _ = make_replica(published, tmp_path, conn_read_timeout_s=0.5)
    rep.start()
    try:
        slow = socket.create_connection(("127.0.0.1", rep.bound_port),
                                        timeout=10.0)
        slow.sendall(b'{"id": 99, "inp')   # never finishes the line
        half_open = socket.create_connection(
            ("127.0.0.1", rep.bound_port), timeout=10.0)
        out = raw_request(rep.bound_port, {"id": 1, "inputs": make_input(1)})
        assert out["status"] == "ok"
        deadline = time.time() + 10.0
        reasons: set = set()
        while len(reasons) < 2 and time.time() < deadline:
            reasons = {r.get("reason") for r in serve_records(rep)
                       if r.get("action") == "conn_abort"}
            time.sleep(0.05)
        assert reasons == {"read_deadline", "half_open"}
        slow.settimeout(2.0)
        assert slow.recv(4096) == b""
        slow.close()
        half_open.close()
        recs = serve_records(rep)
        assert (sum(1 for r in recs if r.get("action") == "admit")
                == sum(1 for r in recs if r.get("action") == "respond"))
    finally:
        rep.stop()


def test_client_quarantines_dead_endpoint(published, tmp_path):
    rep, _ = make_replica(published, tmp_path)
    rep.start()
    try:
        dead_port = _dead_port()
        client = ServeClient([("127.0.0.1", dead_port),
                              ("127.0.0.1", rep.bound_port)],
                             deadline_s=10.0, max_attempts=4,
                             quarantine_s=30.0, seed=3)
        out = client.request(make_input(0), request_id=0)
        assert out["status"] == "ok"
        if out["attempts"] > 1:
            assert out["retried"] is True
        assert client.quarantined() == [("127.0.0.1", dead_port)]
        for i in range(1, 4):
            out = client.request(make_input(i), request_id=i)
            assert out["status"] == "ok" and out["attempts"] == 1
            assert out["retried"] is False
    finally:
        rep.stop()


# -- quantized tiers ----------------------------------------------------------

def test_int8_tier_preferred_and_meta_reports_it(published, tmp_path):
    rep, serve_src = make_replica(published, tmp_path,
                                  precision_tier="int8")
    rep.start()
    try:
        out = raw_request(rep.bound_port, {"id": 1, "inputs": make_input(1)})
        assert out["status"] == "ok" and out["model_step"] == 10
        assert out["tier"] == "int8"
        meta = raw_request(rep.bound_port, {"meta": True})
        assert meta["precision_tier"] == meta["active_tier"] == "int8"
        src = ckpt.read_quant_sidecar(serve_src, 10)["meta"][
            "source_params_digest"]
        assert meta["tier_source_digest"] == src
        assert meta["model_digest"] == ckpt.quant_sidecar_digest(serve_src,
                                                                 10)
        # the int8 weights stay int8 on the device
        assert rep._params["fc1"]["w"]["q"].dtype.is_floating_point is False
    finally:
        rep.stop()
    swaps = [r for r in serve_records(rep)
             if r.get("action") == "weight_swap"]
    assert [(s["step"], s["tier"], s["source_artifact"]) for s in swaps] \
        == [(10, "int8", "ckpt-00000010.quant.msgpack")]
    assert swaps[0]["source_digest"] == src


def test_torn_sidecar_falls_back_to_fp32_without_wedge(published, tmp_path):
    serve_src = tmp_path / "publish"
    publish_step(published["staging"], serve_src, 10, tear_sidecar=True)
    rep = ServingReplica(serve_src, serve_dir=tmp_path / "replica",
                         scfg=ServeConfig(poll_secs=0.05,
                                          precision_tier="int8"),
                         cfg=published["cfg"], device="cpu")
    rep.start()
    try:
        out = raw_request(rep.bound_port, {"id": 1, "inputs": make_input(1)})
        assert out["status"] == "ok" and out["model_step"] == 10
        assert out["tier"] == "fp32"  # the fallback, never torn bytes
        time.sleep(0.4)
        fallbacks = [r for r in serve_records(rep) if r.get("action")
                     == "follow_quant_sidecar_fallback"]
        assert len(fallbacks) == 1 and fallbacks[0]["step"] == 10
        assert "CheckpointCorruptError" in fallbacks[0]["reason"]
        publish_step(published["staging"], serve_src, 20, sidecar=False)
        deadline = time.time() + 30
        while rep.model_step < 20 and time.time() < deadline:
            time.sleep(0.05)
        assert rep.model_step == 20 and rep.model_tier == "fp32"
        publish_step(published["staging"], serve_src, 30)
        while rep.model_step < 30 and time.time() < deadline:
            time.sleep(0.05)
        assert rep.model_step == 30 and rep.model_tier == "int8"
    finally:
        rep.stop()
    recs = serve_records(rep)
    assert [(r["step"], r["tier"]) for r in recs
            if r.get("action") == "weight_swap"] == \
        [(10, "fp32"), (20, "fp32"), (30, "int8")]
    assert [r["reason"].split(":")[0] for r in recs
            if r.get("action") == "follow_quant_sidecar_fallback"] == \
        ["CheckpointCorruptError", "sidecar_absent"]


# -- the reference's replay invariants on the port's journals -----------------

def test_journals_pass_the_reference_invariants(published, tmp_path):
    """A closed-loop load of 60 requests at concurrency 3, with step 20
    published a third of the way in and a torn step 30 after it: no
    drop, both steps served, and the reference's ``check_serving``
    finds no violation in the trial dir (loadgen journal, the
    injector's record of the tear, the replica's journal)."""
    from distributedmnist_tpu.obsv.invariants import check_serving
    from distributedmnist_tpu.obsv.schema import validate_event
    trial = tmp_path / "trial"
    serve_src = tmp_path / "publish"
    publish_step(published["staging"], serve_src, 10)
    # worker1/serve_log.jsonl: the trial layout the checker reads
    rep = ServingReplica(serve_src, serve_dir=trial / "worker1",
                         scfg=ServeConfig(poll_secs=0.05),
                         cfg=published["cfg"], device="cpu")
    rep.start()
    tear = []
    try:
        client = ServeClient([("127.0.0.1", rep.bound_port)],
                             deadline_s=30.0)
        stop = threading.Event()

        def publisher():
            while rep._terminals < 20 and not stop.is_set():
                time.sleep(0.01)
            publish_step(published["staging"], serve_src, 20)
            while rep.model_step < 20 and not stop.is_set():
                time.sleep(0.01)
            publish_step(published["staging"], serve_src, 30,
                         truncate=True)
            tear.append({"event": "fault",
                         "action": "corrupt_latest_checkpoint",
                         "worker": 0, "target": "ckpt-00000030.msgpack",
                         "ts": time.time()})

        t = threading.Thread(target=publisher)
        t.start()
        summary = run_load(client, 60, 3, make_input,
                           journal_path=trial / "loadgen.jsonl")
        stop.set()
        t.join(timeout=30)
        time.sleep(0.3)  # the follower meets the torn step 30
    finally:
        rep.stop()
    assert summary["dropped"] == 0 and summary["responses"] == 60
    assert summary["model_steps_served"] == [10, 20]
    (trial / "command_journal.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in tear))
    violations, applicable, workers, decode = check_serving(
        trial, {"serve_workers": [1]}, tear)
    assert applicable and workers == {1} and not decode
    assert violations == []
    recs = serve_records(rep)
    assert any(r["action"] == "follow_corrupt_checkpoint_fallback"
               for r in recs)
    beats = [json.loads(line) for line in
             (rep.serve_dir / "train_log.jsonl").read_text().splitlines()]
    for rec in recs + beats:
        assert validate_event(rec) == [], rec
