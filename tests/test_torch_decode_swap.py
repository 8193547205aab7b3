"""Mid-generation weight swaps of the port's decode replica
(``distributedmnist_tpu_torch/servesvc/decode.py``, ``device="cpu"``)
against the reference's, both loops driven by hand with the swap staged
at the same iteration:

* requests ``a`` (greedy) and ``b`` (sampled, temperature 0.8) start on
  step 10; after two decode iterations step 20 is published, polled,
  staged and swapped in; then ``c`` (sampled) is admitted and every
  sequence runs to its end;
* under ``pin`` ``a`` and ``b`` finish on step 10 while ``c`` runs on
  step 20 beside them (two live versions, each one step an iteration,
  the other's slots masked by the null table and length 0); under
  ``restart`` ``a`` and ``b`` are re-prefilled on step 20 (a
  ``seq_restart`` each, a ``restart`` stream line, the sampling key
  moved on by 1000);
* every streamed line and terminal, and the journal's records (times
  left out), equal the reference's under both policies, every decode
  step's logits of the live slots are the reference's within 1e-4 (a
  masked slot's write landing anywhere but the null block would move a
  live sequence's cached K/V), and the reference's ``check_serving``
  ``decode_swap`` invariant passes on the port's journal;
* the follower thread hot-follows a publish on a started replica (the
  swap at a loop boundary, sequences streaming across it).
"""

import dataclasses
import json
import shutil
import time

import jax
import numpy as np
import pytest

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel.api import init_train_state
from distributedmnist_tpu.train.checkpoint import save_checkpoint
from distributedmnist_tpu_torch.core.config import (DecodeConfig,
                                                    ExperimentConfig,
                                                    ServeConfig)
from distributedmnist_tpu_torch.servesvc import DecodeReplica, ServeClient

from _torch_threads import one_torch_thread  # noqa: F401

MODEL = {"name": "transformer", "seq_len": 64, "model_dim": 64,
         "num_heads": 4, "num_layers": 2, "vocab_size": 32,
         "compute_dtype": "float32", "attention_impl": "dense"}
DECODE = {"decode_slots": 3, "block_size": 8, "num_blocks": 32,
          "max_prompt_len": 16, "max_new_tokens": 10}
REQUESTS = {"a": {"prompt": [1, 2, 3], "max_tokens": 8},
            "b": {"prompt": [5, 6, 7, 8, 9], "max_tokens": 8,
                  "temperature": 0.8},
            "c": {"prompt": [4, 5], "max_tokens": 4, "temperature": 0.8}}
# journal fields that are times (or derived from the clock)
CLOCK = ("time", "ts", "ttft_ms", "latency_ms", "swap_ms", "deadline_ms")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Steps 10 and 20 of a small LM: the reference's init, and the same
    params moved by seeded noise."""
    d = tmp_path_factory.mktemp("lm")
    cfg = RefConfig.from_dict({"model": MODEL})
    state = init_train_state(ref_get_model(cfg.model), cfg)
    save_checkpoint(d, state, 10, extra={"config": cfg.to_dict()})
    rng = np.random.default_rng(7)
    moved = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), jax.device_get(state.params))
    save_checkpoint(d, state.replace(params=moved), 20,
                    extra={"config": cfg.to_dict()})
    return d


def publish_step(staging, serve_dir, step):
    name = f"ckpt-{step:08d}.msgpack"
    serve_dir.mkdir(parents=True, exist_ok=True)
    for sfx in ("", ".sha256"):
        shutil.copy2(staging / (name + sfx), serve_dir / (name + sfx))
    tmp = serve_dir / "checkpoint.json.tmp"
    tmp.write_text(json.dumps({"latest_step": step, "latest_path": name,
                               "written_at": time.time()}))
    tmp.replace(serve_dir / "checkpoint.json")


class StubConn:
    """Direct-drive connection double: collects every streamed line."""

    def __init__(self):
        self.lines: list[dict] = []

    def settimeout(self, t):
        pass

    def gettimeout(self):
        return None

    def sendall(self, b):
        for line in b.decode().splitlines():
            self.lines.append(json.loads(line))

    def close(self):
        pass


def _admit(rep, rid):
    conn = StubConn()
    seq = rep._build_item({"id": rid, "deadline_ms": 600000,
                           **REQUESTS[rid]}, conn)
    assert seq is not None
    rep._journal({"action": "admit", "id": rid, "deadline_ms": 600000.0})
    rep._queue.put_nowait(seq)
    return conn


def _drive(rep, serve_src, staging):
    """The one schedule both replicas run."""
    rep._load_initial()
    assert rep.model_step == 10
    conns = {rid: _admit(rep, rid) for rid in ("a", "b")}
    rep._admit_new()
    rep._step_active()
    rep._step_active()
    publish_step(staging, serve_src, 20)
    got = rep.follower.poll(rep._read_weights)
    assert got is not None and got[0] == "swap"
    rep._staged = got[1:]
    rep._maybe_swap()
    assert rep.model_step == 20
    conns["c"] = _admit(rep, "c")
    rep._admit_new()
    while any(s is not None for s in rep._slots):
        rep._step_active()
    return conns


def _records(serve_dir):
    recs = [json.loads(line) for line in
            (serve_dir / "serve_log.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in CLOCK} for r in recs]


def _run_both(staged, tmp_path, policy):
    from distributedmnist_tpu.core.config import (
        DecodeConfig as RefDecodeConfig, ServeConfig as RefServeConfig)
    from distributedmnist_tpu.servesvc.decode import \
        DecodeReplica as RefDecodeReplica
    out = {}
    for side in ("ref", "port"):
        src = tmp_path / side / "publish"
        publish_step(staged, src, 10)
        if side == "ref":
            rep = RefDecodeReplica(
                src, serve_dir=tmp_path / side / "serve",
                scfg=RefServeConfig(poll_secs=0.05),
                dcfg=RefDecodeConfig(**DECODE, swap_policy=policy),
                cfg=RefConfig.from_dict({"model": MODEL}))
        else:
            rep = DecodeReplica(
                src, serve_dir=tmp_path / side / "serve",
                scfg=ServeConfig(poll_secs=0.05),
                dcfg=DecodeConfig(**DECODE, swap_policy=policy,
                                  attention_kernel="paged"),
                cfg=ExperimentConfig.from_dict(
                    {"model": {**MODEL, "attention_impl": "flash"}}),
                device="cpu")
        logits = _record_decode_logits(rep, side)
        conns = _drive(rep, src, staged)
        out[side] = (rep, {k: c.lines for k, c in conns.items()},
                     _records(rep.serve_dir), logits)
    return out


def _record_decode_logits(rep, side):
    """Keep each decode step's logits of its live slots (length > 0)."""
    logits = []
    if side == "ref":
        real = rep._decode_jit

        def step(*args):
            out = real(*args)
            logits.append(np.asarray(out[0])[np.asarray(args[6]) > 0])
            return out
        rep._decode_jit = step
    else:
        real_step = rep.model.decode_step

        def port_step(*args, **kw):
            out = real_step(*args, **kw)
            logits.append(out[0][args[6] > 0].numpy())
            return out
        rep.model = dataclasses.replace(rep.model, decode_step=port_step)
    return logits


def _decode_swap_violations(serve_dir, trial):
    from distributedmnist_tpu.obsv.invariants import check_serving
    (trial / "worker1").mkdir(parents=True)
    shutil.copy2(serve_dir / "serve_log.jsonl",
                 trial / "worker1" / "serve_log.jsonl")
    violations, applicable, _, decode = check_serving(
        trial, {"serve_workers": [1]}, [])
    assert applicable and decode
    return [v.to_dict() for v in violations]


@pytest.mark.parametrize("policy", ["pin", "restart"])
def test_swap_policy_matches_the_reference(staged, tmp_path, policy):
    both = _run_both(staged, tmp_path, policy)
    (ref, ref_lines, ref_recs, ref_logits), (rep, lines, recs, logits) = \
        both["ref"], both["port"]
    assert lines == ref_lines
    assert recs == ref_recs
    assert len(logits) == len(ref_logits) == rep.version_steps
    for got, want in zip(logits, ref_logits):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
    final = {rid: ls[-1] for rid, ls in lines.items()}
    assert all(f["status"] == "ok" for f in final.values())
    assert [len(final[r]["tokens"]) for r in "abc"] == [8, 8, 4]
    sw = next(r for r in recs if r["action"] == "weight_swap"
              and not r.get("initial"))
    restarts = [r for r in recs if r["action"] == "seq_restart"]
    if policy == "pin":
        assert (sw["sequences_pinned"], sw["sequences_restarted"]) == (2, 0)
        assert [final[r]["model_step"] for r in "abc"] == [10, 10, 20]
        assert not restarts and not rep._versions  # the old one released
        assert rep.version_steps > rep.decode_iterations  # two live at once
    else:
        assert (sw["sequences_pinned"], sw["sequences_restarted"]) == (0, 2)
        assert [final[r]["model_step"] for r in "abc"] == [20, 20, 20]
        assert [(r["id"], r["from_step"], r["to_step"]) for r in restarts] \
            == [("a", 10, 20), ("b", 10, 20)]
        assert all(r["tokens_discarded"] == 3 for r in restarts)
        assert {"id": "a", "stream": "restart", "model_step": 20} \
            in lines["a"]
        assert rep.restarts == 2 and rep.prefills == 3
        assert rep.version_steps == rep.decode_iterations
    assert _decode_swap_violations(rep.serve_dir, tmp_path / "trial") == []


def test_follower_thread_swaps_a_started_replica(staged, tmp_path):
    src = tmp_path / "publish"
    publish_step(staged, src, 10)
    rep = DecodeReplica(
        src, serve_dir=tmp_path / "serve", scfg=ServeConfig(poll_secs=0.05),
        dcfg=DecodeConfig(**DECODE, swap_policy="restart"),
        cfg=ExperimentConfig.from_dict({"model": MODEL}), device="cpu")
    rep.start()
    try:
        client = ServeClient([("127.0.0.1", rep.bound_port)],
                             deadline_s=60.0)
        before = client.generate([1, 2, 3], request_id="x", max_tokens=4)
        publish_step(staged, src, 20)
        deadline = time.time() + 30
        while rep.model_step < 20 and time.time() < deadline:
            time.sleep(0.05)
        after = client.generate([1, 2, 3], request_id="y", max_tokens=4)
    finally:
        rep.stop()
    assert before["status"] == after["status"] == "ok"
    assert (before["model_step"], after["model_step"]) == (10, 20)
    swaps = [r for r in _records(rep.serve_dir)
             if r["action"] == "weight_swap"]
    assert [(s["step"], s["from_step"]) for s in swaps] == [(10, -1),
                                                            (20, 10)]
