"""Port end to end: the port's ``DecodeReplica(device="cpu")`` serves a
checkpoint the REFERENCE trainer layer wrote, over a real socket.

* 3 concurrent greedy requests stream exactly the tokens the
  reference's own greedy decode of the same params produces (the
  reference's full-context forward, argmax per step).
* 3 sampled requests (temperature 0.8) stream the tokens the
  reference's sampler draws: request i is the i-th admitted, so its
  sample seed is i, and token t draws ``categorical`` with
  ``fold_in(PRNGKey(i), t)`` in both packages.
* Every ``serve_log.jsonl`` / heartbeat record passes the reference
  ``obsv/schema.py validate_event``, with exactly one terminal per
  request id.
* Bad prompts get a typed ``bad_request``.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedmnist_tpu.core.config import ExperimentConfig
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.models.registry import sample_token as ref_sample
from distributedmnist_tpu.obsv.schema import validate_event
from distributedmnist_tpu.parallel.api import init_train_state
from distributedmnist_tpu.train.checkpoint import save_checkpoint
from distributedmnist_tpu_torch.launch.__main__ import build_replica
from distributedmnist_tpu_torch.servesvc import DecodeReplica, ServeClient

RUN = {"model": {"name": "transformer", "seq_len": 64, "model_dim": 64,
                 "num_heads": 4, "num_layers": 2, "vocab_size": 32,
                 "compute_dtype": "float32", "attention_impl": "flash"},
       "decode": {"decode_slots": 2, "block_size": 8, "num_blocks": 32,
                  "max_prompt_len": 16, "max_new_tokens": 8,
                  "attention_kernel": "paged"}}
PROMPTS = {"a": [3, 7, 1], "b": [5, 2, 9, 14, 30, 0, 8, 8, 1, 2, 3],
           "c": [31]}
N_NEW = 6
TEMPERATURE = 0.8


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    train_dir = tmp_path_factory.mktemp("train")
    cfg = ExperimentConfig.from_dict(RUN)
    state = init_train_state(ref_get_model(cfg.model), cfg)
    save_checkpoint(train_dir, state, 4, extra={"config": cfg.to_dict()})
    # the reference's greedy decode: full-context argmax per step, one
    # compiled shape (causal, so right-padding changes no earlier logit)
    dense = ref_get_model(ExperimentConfig.from_dict(
        {"model": {**RUN["model"], "attention_impl": "dense"}}).model)
    apply = jax.jit(dense.apply)
    want, sampled = {}, {}
    for i, (rid, prompt) in enumerate(PROMPTS.items()):
        for temperature, out in ((0.0, want), (TEMPERATURE, sampled)):
            seq = list(prompt)
            for t in range(N_NEW):
                padded = np.zeros((1, 32), np.int32)
                padded[0, :len(seq)] = seq
                row = apply(state.params, jnp.asarray(padded))[0,
                                                               len(seq) - 1]
                if temperature > 0:
                    key = jax.random.fold_in(jax.random.PRNGKey(i), t)
                    seq.append(int(ref_sample(row, key,
                                              temperature=temperature)))
                else:
                    seq.append(int(np.argmax(np.asarray(row))))
            out[rid] = seq[len(prompt):]
    return train_dir, want, sampled


@pytest.fixture
def replica(published, tmp_path):
    train_dir = published[0]
    rep = build_replica(["serve", "--decode", "--train-dir",
                                str(train_dir), "--serve-dir",
                                str(tmp_path / "serve"), "--device", "cpu"])
    rep.start()
    yield rep
    rep.stop()


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_replica_streams_reference_greedy_tokens(published, replica):
    want = published[1]
    assert isinstance(replica, DecodeReplica)
    client = ServeClient([("127.0.0.1", replica.bound_port)],
                         deadline_s=60.0)
    meta = client.meta()
    assert meta["decode"] and meta["model_step"] == 4
    out, streamed = {}, {rid: [] for rid in PROMPTS}

    def go(rid):
        out[rid] = client.generate(
            PROMPTS[rid], request_id=rid, max_tokens=N_NEW,
            on_token=lambda rec: streamed[rid].append(rec["token"]))

    threads = [threading.Thread(target=go, args=(rid,)) for rid in PROMPTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for rid in PROMPTS:
        assert out[rid]["status"] == "ok", out[rid]
        assert out[rid]["finish_reason"] == "max_tokens"
        assert out[rid]["tokens"] == want[rid] == streamed[rid]
    # two slots, three requests: one waited for a refill (the prefill
    # count is final once its first token streamed; the finish count
    # is bumped after the terminal is sent, so it may still lag here)
    assert replica.prefills == 3


def test_replica_streams_reference_sampled_tokens(published, replica):
    """Admitted one after another (sample seeds 0, 1, 2), at
    temperature 0.8."""
    sampled = published[2]
    client = ServeClient([("127.0.0.1", replica.bound_port)],
                         deadline_s=60.0)
    for rid, prompt in PROMPTS.items():
        out = client.generate(prompt, request_id=rid, max_tokens=N_NEW,
                              temperature=TEMPERATURE)
        assert out["status"] == "ok", out
        assert out["tokens"] == sampled[rid], rid
    assert sampled != published[1]  # the draws are not the greedy path


@pytest.mark.parametrize("prompt", [[], list(range(17)), [32], [-1],
                                    "abc", [[1, 2]]])
def test_bad_prompts_get_typed_bad_request(replica, prompt):
    client = ServeClient([("127.0.0.1", replica.bound_port)],
                         deadline_s=10.0)
    out = client.generate(prompt, request_id="bad")
    assert out["status"] == "rejected" and out["reason"] == "bad_request"


def test_journal_records_pass_reference_schema(published, replica):
    client = ServeClient([("127.0.0.1", replica.bound_port)],
                         deadline_s=60.0)
    for rid, prompt in PROMPTS.items():
        assert client.generate(prompt, request_id=rid,
                               max_tokens=3)["status"] == "ok"
    assert client.generate([99], request_id="oov")["status"] == "rejected"
    assert client.generate([1], request_id="long",
                           max_tokens=9)["status"] == "rejected"
    serve_dir = replica.serve_dir
    replica.stop()  # flushes serve_stop; the fixture's second stop is a no-op
    recs = _records(serve_dir / "serve_log.jsonl")
    beats = _records(serve_dir / "train_log.jsonl")
    for rec in recs + beats:
        assert validate_event(rec) == [], rec
    actions = [r["action"] for r in recs]
    for needed in ("weight_swap", "serve_start", "decode_start", "admit",
                   "prefill", "decode_finish", "reject", "serve_stop"):
        assert needed in actions
    terminals = {}
    for r in recs:
        if r["action"] in ("decode_finish", "reject"):
            terminals[r["id"]] = terminals.get(r["id"], 0) + 1
    assert terminals == {"a": 1, "b": 1, "c": 1, "oov": 1, "long": 1}
    admitted = {r["id"] for r in recs if r["action"] == "admit"}
    assert admitted == {"a", "b", "c"}
    assert beats[-1]["step"] == 5
    endpoint = json.loads((serve_dir / "serve.json").read_text())
    assert endpoint["port"] == replica.bound_port
