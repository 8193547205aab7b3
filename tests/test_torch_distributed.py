"""The port's multi-process data-parallel path (``core/mesh.py``
``initialize_distributed``, ``parallel/api.py``, ``train/loop.py``,
``train/evaluation.py``) on the CPU: two real worker processes with
``torchrun``'s environment join a gloo process group and train the MNIST
CNN through the port's ``Trainer``, 8 replicas split 4 and 4 (≙
``tests/test_multihost.py``, whose reference side is slow-marked).

The children import only the port. The reference side runs here, in the
pytest process, on the conftest's 8-device mesh; the port's one-process
8-replica run ("simulated") runs here too.

Parity argument (the reference's own, ``test_multihost.py:13-20``):
process p's replicas take row blocks of *its* shard of the data, while
the simulated run's replica r takes block r of the global batch, so
rows land on other replicas. With full-batch steps and dropout 0 the
multiset of rows in a step is the same, and the replica-mean of means is
the global mean: losses and params agree to float32 reassociation. The
flags depend only on keys, the step and the measured base, so they are
bitwise the reference's. Where the rows a replica holds matter — a
quorum drops some replicas' rows; dropout and drop-connect masks are
keyed by global replica index — cases (c) and (g) hold the two-process
run against the simulated step fed the same row layout (the two
processes' batches, concatenated).

Tolerances: the topology sums bitwise with one replica a process, else
``rtol 1e-6, atol 1e-6`` (float32 reassociation of 8 terms); against
the simulated run the loss within ``rtol 1e-5`` and each param leaf
within ``1e-4`` of its norm; against the reference, on the first step
(four free float32 steps drift from it as the one-process port run
does), the loss within ``rtol 1e-5`` and the params at ``tests/test_torch_sync_modes.py``'s
per-leaf tolerance (``rtol 1e-5``, ``atol`` 1e-6 of the leaf's largest
entry, or 1e-3 of its norm where the two float32 forwards branch
differently); eval loss ``rtol 1e-6`` and accuracy exact.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import Topology
from distributedmnist_tpu_torch.data.pipeline import BatchIterator
from distributedmnist_tpu_torch.models.convert import params_to_reference
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_sync_modes import _close, _forwards_branch_differently

REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 90

_CHILD = r"""
import json, os, signal, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from distributedmnist_tpu_torch.core.mesh import (
    initialize_distributed, make_topology, shutdown_distributed)
assert initialize_distributed("gloo", "cpu", timeout_s=60)
rank = int(os.environ["RANK"])
out = os.environ["DMT_OUT"]
try:
    if os.environ.get("DMT_MODE") == "ops":
        from distributedmnist_tpu_torch.core.config import MeshConfig
        res = {}
        for n in (2, 8):
            topo = make_topology(MeshConfig(num_replicas=n))
            x = np.load(f"{out}/x{n}.npy")
            f, L = topo.first_replica, topo.local_replica_count
            rows = torch.from_numpy(x[f:f + L])
            res[n] = {"sum": topo.sum_replicas(rows).numpy(),
                      "gather": topo.gather_scalars(rows[:, 0]).numpy(),
                      "first": f, "local": L}
        np.save(f"{out}/ops{rank}.npy", res, allow_pickle=True)
    else:
        from distributedmnist_tpu_torch.core.config import ExperimentConfig
        from distributedmnist_tpu_torch.models.convert import params_to_reference
        from distributedmnist_tpu_torch.parallel.api import tree_leaves
        from distributedmnist_tpu_torch.train.checkpoint import params_digest
        from distributedmnist_tpu_torch.train.loop import Trainer
        cfg = ExperimentConfig.from_dict(json.loads(os.environ["DMT_CFG"]))
        t = Trainer(cfg, device="cpu")
        sleep_s = float(os.environ.get("DMT_SLEEP_MS", "0")) / 1e3
        if sleep_s:
            # a real slowdown of this process's host loop: every batch
            # fetch stalls, as slow ingest would
            base = t.train_iter
            def slow():
                while True:
                    time.sleep(sleep_s)
                    yield next(base)
            t.train_iter = slow()
        start = t._start_step
        recs = []

        term_at = os.environ.get(f"DMT_TERM_AT_{rank}")

        def at_flush(s, r):
            params = params_to_reference(t.state.params)
            recs.append({"step": s, "flags": r["flags"], "loss": r["loss"],
                         "digest": params_digest(params)})
            if os.environ.get("DMT_SAVE_STEPS"):
                np.savez(f"{out}/params{rank}_step{s}.npz",
                         *tree_leaves(params))
            if term_at and s == int(term_at):
                os.kill(os.getpid(), signal.SIGTERM)

        summary = t.run(step_callback=at_flush)
        ev = t.evaluate()
        leaves = tree_leaves(params_to_reference(t.state.params))
        np.savez(f"{out}/params{rank}.npz", *leaves)
        json.dump({"start_step": start, "final_step": t.state.step,
                   "preempted": summary["preempted"],
                   "records": recs, "eval": ev,
                   "times": t.collector.matrix().tolist(),
                   "process_count": t.topo.process_count,
                   "first_replica": t.topo.first_replica,
                   "is_writer": t.is_writer},
                  open(f"{out}/result{rank}.json", "w"))
finally:
    shutdown_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out: Path, cfg: dict | None = None, mode: str = "train",
           sleep_ms=(0.0, 0.0), save_steps: bool = False,
           term_at: dict | None = None, argv: list | None = None) -> list:
    """Start two children in one gloo group (torchrun's environment, a
    free port), their output to ``out/rank*.log``: the test's child, or
    ``python argv`` when given. With ``save_steps`` each writes its
    params after every flushed step; ``term_at`` {rank: step} sends that
    rank a SIGTERM once the step is flushed."""
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   DMT_OUT=str(out), DMT_MODE=mode,
                   DMT_SLEEP_MS=str(sleep_ms[rank]),
                   DMT_SAVE_STEPS="1" if save_steps else "",
                   DMT_CFG=json.dumps(cfg or {}),
                   **{f"DMT_TERM_AT_{r}": str(s)
                      for r, s in (term_at or {}).items()})
        with open(out / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *(argv or ["-c", _CHILD])], env=env,
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(out: Path, procs: list, mode: str = "train") -> list:
    """Both children must exit 0 within the timeout; a failed sibling is
    killed. Returns each rank's result."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:  # a failed sibling must not outlive the test
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    errs = [f"rank {r} rc {p.returncode}:\n"
            f"{(out / f'rank{r}.log').read_text()[-3000:]}"
            for r, p in enumerate(procs) if p.returncode != 0]
    assert not errs, "\n".join(errs)
    if mode == "ops":
        return [np.load(out / f"ops{r}.npy", allow_pickle=True).item()
                for r in range(2)]
    if mode == "cli":
        return [(out / f"rank{r}.log").read_text() for r in range(2)]
    return [json.loads((out / f"result{r}.json").read_text())
            for r in range(2)]


def _launch(out: Path, cfg: dict | None = None, mode: str = "train",
            **kw) -> list:
    return _wait(out, _start(out, cfg, mode, **kw), mode)


def _leaves(path: Path) -> list[np.ndarray]:
    z = np.load(path)
    return [z[f"arr_{i}"] for i in range(len(z.files))]


def _cfg_dict(train_dir, **sync) -> dict:
    """``tests/test_multihost.py``'s ``_cfg_dict``: full-batch steps,
    dropout off."""
    return {
        "data": {"dataset": "synthetic", "batch_size": 128,
                 "synthetic_train_size": 128, "synthetic_test_size": 96,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32", "dropout_rate": 0.0},
        "optim": {"learning_rate_decay_factor": 1.0},
        "sync": {"mode": "sync", "straggler_profile": "none", **sync},
        "eval": {"eval_batch_size": 32},
        "mesh": {"num_replicas": 8},
        "train": {"max_steps": 4, "log_every_steps": 2,
                  "save_interval_steps": 0, "save_results_period": 0,
                  "train_dir": str(train_dir)},
    }


def _simulated(d: dict):
    """The port's one-process run of the same config: (trainer,
    records, eval)."""
    t = Trainer(ExperimentConfig.from_dict(d), device="cpu")
    recs = []
    t.run(step_callback=lambda s, r: recs.append(r))
    return t, recs, t.evaluate()


def _reference(d: dict):
    """The reference's single-process run on the 8-device mesh:
    (records, params leaves after each flushed step, the initial params,
    the train images)."""
    d = {k: v for k, v in d.items() if k != "mesh"}
    t = RefTrainer(base_config(**d))
    init = jax.device_get(t.state.params)
    recs, params = [], []

    def at_flush(s, r):
        recs.append(r)
        params.append([np.asarray(x) for x in
                       jax.tree.leaves(jax.device_get(t.state.params))])

    t.run(step_callback=at_flush)
    return recs, params, init, t.datasets.train.images


def _simulated_on_process_rows(d: dict, train_dir: Path):
    """The port's one-process step over the config's steps, fed the two
    processes' batches concatenated: replica 4p + j then takes the rows
    process p's replica j took, so the masked mean drops and keeps the
    same rows as the two-process run. Returns (state, last metrics)."""
    cfg = ExperimentConfig.from_dict(dict(d, train=dict(
        d["train"], train_dir=str(train_dir))))
    t = Trainer(cfg, device="cpu")
    its = [BatchIterator(t.datasets.train, cfg.data.batch_size,
                         seed=cfg.train.seed,
                         host_id=p, num_hosts=2) for p in range(2)]
    state = t.state
    for _ in range(cfg.train.max_steps):
        parts = [next(it) for it in its]
        batch = {k: torch.from_numpy(np.concatenate([b[k] for b in parts]))
                 for k in ("image", "label")}
        state, m = t.step_fn(state, batch)
    return state, m


def _within_norm(got, want, tol=1e-4):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), (
            np.linalg.norm(g - w) / np.linalg.norm(w))


# -- (a) the topology's two cross-replica operations --------------------------

def test_topology_ops_match_simulated(tmp_path):
    rng = np.random.default_rng(0)
    xs = {n: rng.normal(size=(n, 37)).astype(np.float32) for n in (2, 8)}
    tmp_path.mkdir(exist_ok=True)
    for n, x in xs.items():
        np.save(tmp_path / f"x{n}.npy", x)
    r0, r1 = _launch(tmp_path, mode="ops")
    for n, x in xs.items():
        sim = Topology(num_replicas=n)
        want_sum = sim.sum_replicas(torch.from_numpy(x)).numpy()
        want_gather = sim.gather_scalars(torch.from_numpy(x[:, 0])).numpy()
        assert (r0[n]["first"], r1[n]["first"]) == (0, n // 2)
        assert r0[n]["local"] == r1[n]["local"] == n // 2
        for r in (r0, r1):
            # the one-hot sum: bitwise the rows, in replica order
            np.testing.assert_array_equal(r[n]["gather"], want_gather)
            if n == 2:  # one replica a process: x0 + x1 either way
                np.testing.assert_array_equal(r[n]["sum"], want_sum)
            else:
                np.testing.assert_allclose(r[n]["sum"], want_sum,
                                           rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r0[n]["sum"], r1[n]["sum"])


# -- (b) and (f): sync steps and striped eval over two processes --------------

def _sync_cfg(train_dir) -> dict:
    d = _cfg_dict(train_dir)
    d["train"]["log_every_steps"] = 1
    return d


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync")
    ranks = _launch(tmp / "two", _sync_cfg(tmp / "two_train"),
                    save_steps=True)
    sim = _simulated(_sync_cfg(tmp / "sim_train"))
    ref = _reference(_sync_cfg(tmp / "ref_train"))
    return tmp, ranks, sim, ref


def test_sync_steps_match_simulated_and_reference(sync_runs):
    """Four free float32 steps drift from the reference as the port's
    one-process run does (``tests/test_torch_sync_modes.py`` holds that
    run to the reference step by step, from the reference's state); so
    the two-process run is held to the simulated run at every step, and
    to the reference on its first step, from the shared init, as
    ``test_torch_sync_modes`` holds a step: ``rtol 1e-5``, or 1e-3 of
    each leaf's norm where the two float32 forwards take a different
    ReLU or max-pool branch."""
    tmp, (r0, r1), (t, sim_recs, _), ref = sync_runs
    ref_recs, ref_params, ref_init, images = ref
    for r in (r0, r1):
        assert r["process_count"] == 2 and r["final_step"] == 4
    assert (r0["first_replica"], r1["first_replica"]) == (0, 4)
    # every flush: the same flags, loss and params on both ranks
    assert r0["records"] == r1["records"]
    assert [x["step"] for x in r0["records"]] == [1, 2, 3, 4]
    two = tmp / "two"
    for s in (1, 2, 3, 4):
        for a, b in zip(_leaves(two / f"params0_step{s}.npz"),
                        _leaves(two / f"params1_step{s}.npz")):
            np.testing.assert_array_equal(a, b)
    # against the port's one-process 8-replica run
    for got, want in zip(r0["records"], sim_recs):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _within_norm(_leaves(two / "params0.npz"),
                 api.tree_leaves(params_to_reference(t.state.params)))
    # against the reference's single-process run
    assert [x["flags"] for x in r0["records"]] == [
        list(map(int, x["flags"])) for x in ref_recs]
    np.testing.assert_allclose(r0["records"][0]["loss"],
                               ref_recs[0]["loss"], rtol=1e-5)
    tie = _forwards_branch_differently(ref_init, images)
    for g, w in zip(_leaves(two / "params0_step1.npz"), ref_params[0]):
        _close(g, w, tie, "step 1")


def test_striped_eval_matches_simulated(sync_runs):
    _, (r0, r1), (_, _, sim_ev), _ = sync_runs
    assert r0["eval"]["num_examples"] == r1["eval"]["num_examples"] == 96
    assert sim_ev["num_examples"] == 96
    for r in (r0, r1):
        assert r["eval"]["accuracy"] == sim_ev["accuracy"]
        np.testing.assert_allclose(r["eval"]["loss"], sim_ev["loss"],
                                   rtol=1e-6)
    assert r0["eval"]["loss"] == r1["eval"]["loss"]


# -- (c) quorum over seeded lognormal times -----------------------------------

def test_quorum_flags_equal_on_both_ranks_and_the_reference(tmp_path):
    d = _cfg_dict(tmp_path / "q", mode="quorum", num_replicas_to_aggregate=6,
                  straggler_profile="lognormal")
    d["train"]["max_steps"] = 3
    r0, r1 = _launch(tmp_path / "two", d)
    assert r0["records"] == r1["records"]
    np.testing.assert_array_equal(r0["times"], r1["times"])
    ref_recs = _reference(dict(d, train=dict(
        d["train"], train_dir=str(tmp_path / "r"))))[0]
    flags = [x["flags"] for x in r0["records"]]
    assert flags == [list(map(int, x["flags"])) for x in ref_recs]
    assert all(sum(f) == 6 for f in flags)
    # each rank scales its own replicas by their global entries of the
    # masked-mean scale: the same rows kept as the simulated run's
    state, m = _simulated_on_process_rows(d, tmp_path / "sim")
    np.testing.assert_allclose(r0["records"][-1]["loss"], float(m["loss"]),
                               rtol=1e-5)
    _within_norm(_leaves(tmp_path / "two" / "params0.npz"),
                 api.tree_leaves(params_to_reference(state.params)))


# -- (d) a slow process loses quorum by measured time -------------------------

def test_slow_rank_loses_quorum_by_measured_time(tmp_path):
    """Rank 1's host loop sleeps 250 ms a batch: with
    ``straggler_profile "none"`` each process's measured host time fills
    its replicas' rows, and in the steady state the k=4 quorum is rank
    0's replicas (≙ the reference's 6 steps, final flags). Step 2 ranks
    on step 1's time, which the first call's one-time costs dominate on
    the CPU (2.0-2.9 s against 0.1-0.4 s a step after it; the reference
    compiles ahead of its first step), so the flags are held from step 3
    on."""
    d = _cfg_dict(tmp_path / "s", mode="quorum", num_replicas_to_aggregate=4)
    d["train"]["max_steps"] = 6
    r0, r1 = _launch(tmp_path / "two", d, sleep_ms=(0.0, 250.0))
    assert r0["records"] == r1["records"]
    for rec in r0["records"][2:]:
        assert rec["flags"] == [1, 1, 1, 1, 0, 0, 0, 0], rec
    times = np.asarray(r0["times"])
    np.testing.assert_array_equal(times, np.asarray(r1["times"]))
    # the measured rows: rank 1's replicas carry its sleep
    gap = times[2:, 4:].min(1) - times[2:, :4].max(1)
    assert (gap > 0).all() and np.median(gap) > 100, times


# -- (e) save, kill, resume ---------------------------------------------------

def test_save_kill_resume_equals_uninterrupted(tmp_path):
    shared = tmp_path / "shared"
    d4 = _cfg_dict(shared)
    d8 = _cfg_dict(tmp_path / "whole")
    d8["train"]["max_steps"] = 8
    # the uninterrupted run goes alongside the first phase
    whole = _start(tmp_path / "whole_out", d8)
    a0, a1 = _launch(tmp_path / "p1", d4)
    assert a0["final_step"] == a1["final_step"] == 4
    assert ckpt.latest_checkpoint_step(shared) == 4
    b0, b1 = _launch(tmp_path / "p2", dict(d4, train=dict(d4["train"],
                                                         max_steps=8)))
    assert b0["start_step"] == b1["start_step"] == 4
    assert b0["final_step"] == b1["final_step"] == 8
    w0, _ = _wait(tmp_path / "whole_out", whole)
    assert b0["records"][-1]["digest"] == b1["records"][-1]["digest"] == \
        w0["records"][-1]["digest"]
    # rank 0 alone writes: each step and each save journaled once
    log = [json.loads(x) for x in
           (shared / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if r["event"] == "step"] == \
        list(range(1, 9))
    assert [r["at_step"] for r in log if r["event"] == "save"] == [4, 8]
    assert (a0["is_writer"], a1["is_writer"]) == (True, False)


# -- (g) dropout keyed by global replica index --------------------------------

def test_dropout_masks_use_global_replica_indices(tmp_path):
    """Dropout and drop-connect on: every replica's masks are keyed by
    its global index, so the two-process run equals the simulated run
    on the same rows (a rank keying by local index would reuse replicas
    0-3's masks on replicas 4-7)."""
    d = _cfg_dict(tmp_path / "g", drop_connect=True)
    d["model"]["dropout_rate"] = 0.5
    d["data"]["synthetic_train_size"] = 256
    d["train"]["max_steps"] = 2
    r0, r1 = _launch(tmp_path / "two", d)
    assert r0["records"] == r1["records"]
    state, m = _simulated_on_process_rows(d, tmp_path / "sim")
    np.testing.assert_allclose(r0["records"][-1]["loss"], float(m["loss"]),
                               rtol=1e-5)
    _within_norm(_leaves(tmp_path / "two" / "params0.npz"),
                 api.tree_leaves(params_to_reference(state.params)))


def test_local_replicas_draw_their_global_keys():
    """Process 1 of 2 with 8 replicas: its replica j draws
    ``replica_keys(root, "dropout", step, 8)[4 + j]``."""
    d = _cfg_dict("unused")
    d["model"]["dropout_rate"] = 0.5
    d["data"]["synthetic_train_size"] = 256
    cfg = ExperimentConfig.from_dict(d)
    model = get_model(cfg.model)
    seen = []
    model = dataclasses.replace(model, dropout_masks=lambda keys, rows, dev: (
        seen.append(np.asarray(keys)) or get_model(cfg.model).dropout_masks(
            keys, rows, dev)))
    topo = Topology(num_replicas=8, process_index=1, process_count=2)
    step_fn = api.build_train_step(model, cfg, lambda _: 0.01, topo)
    state = api.init_train_state(model, cfg, torch.device("cpu"))
    gen = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(
                 gen.random((64, 28, 28, 1), dtype=np.float32)),
             "label": torch.from_numpy(gen.integers(0, 10, 64))}
    step_fn(state, batch)
    want = prng.replica_keys(state.root_key, "dropout", 0, 8)[4:]
    np.testing.assert_array_equal(seen[0], want)


# -- every rank stops after the same step -------------------------------------

def test_sigterm_to_one_rank_stops_both_after_the_same_step(tmp_path):
    """Rank 1 alone gets SIGTERM once step 3 is flushed: its request
    rides the next step's host exchange, so both ranks stop after step 3
    (neither waits in a collective the other never joins) and rank 0
    flushes the checkpoint."""
    d = _cfg_dict(tmp_path / "t")
    d["train"].update(max_steps=8, log_every_steps=1)
    r0, r1 = _launch(tmp_path / "two", d, term_at={1: 3})
    for r in (r0, r1):
        assert r["final_step"] == 3 and r["preempted"] == "SIGTERM", r
    assert r0["records"] == r1["records"]
    assert ckpt.latest_checkpoint_step(tmp_path / "t") == 3
    recovery = [json.loads(x) for x in (tmp_path / "t" /
                "recovery_journal.jsonl").read_text().splitlines()]
    assert recovery[-1]["action"] == "preempt_flush"


# -- the CLI under torchrun's environment -------------------------------------

def test_launch_train_over_two_gloo_processes(tmp_path):
    """``launch train --device cpu --dist-backend gloo`` in two processes:
    each joins the group, trains its 4 of the 8 replicas, evaluates its
    stripe, prints the reference's last line, and leaves the group."""
    logs = _wait(tmp_path / "cli", _start(tmp_path / "cli", argv=[
        "-m", "distributedmnist_tpu_torch.launch", "train",
        "--config", "configs/quorum_k4_of_8.json", "mesh.num_replicas=8",
        "data.dataset=synthetic", "data.batch_size=64",
        "data.synthetic_train_size=256", "data.synthetic_test_size=96",
        "train.max_steps=3", f"train.train_dir={tmp_path / 'run'}",
        "--device", "cpu", "--dist-backend", "gloo"]), mode="cli")
    lines = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    for line in lines:
        assert line["summary"]["final_step"] == 3
        assert line["summary"]["last_metrics"]["num_contributors"] == 4.0
        assert line["test"]["num_examples"] == 96
    assert lines[0]["summary"]["params_digest"] == \
        lines[1]["summary"]["params_digest"]
    assert lines[0]["test"] == {**lines[1]["test"],
                                "seconds": lines[0]["test"]["seconds"]}
