"""Tensor parallelism (Megatron; ``mesh.model_parallelism``) in the
port against the reference under ``shard_map`` on the conftest's
8-device mesh (≙ ``tests/test_tensor_parallel.py``): the port runs in
gloo worker processes on the CPU (``_torch_mp``), one launch a world
size, from the reference's params (converted) on the same numpy
batches.

* The TP forward at (replica 1, model 4, seq 1) against the reference's
  sharded forward.
* One train step at (1, 4, 1), (2, 2, 1) and (2, 2, 2): the loss at the
  reference's ``LOSS_TOL`` and the params gathered whole at
  ``assert_update_parity``; the replicated leaves' gradients (embed,
  pos, the norms) bitwise the same on every model rank; LAMB at
  (2, 2, 1) over two steps (the trust ratios complete each split
  leaf's sum of squares over the model group).
* Eval sums at (2, 2, 1) through ``run_full_eval`` against the
  reference's eval step; the indivisible-heads refusal ("divisible").
* A checkpoint's state bytes under TP equal a one-process run's save of
  the same params.
* The Trainer at (2, 2, 2) under quorum with lognormal stragglers: the
  flags equal on every rank, save and resume, a one-process checkpoint
  restored into the shards, and the TP checkpoint restored at model
  parallelism 1 (``cross_world_restore`` journaled both ways).
* Timeout, interval and cdf at (2, 2, 1) against the reference; quorum
  over measured host times with the same flags on every rank.
* ``launch eval --single_device`` on the TP checkpoint.
* ``launch train`` over two gloo processes at model parallelism 2.
* In process: the rule engine's specs against the reference engine's,
  ``shard_params`` / ``gather_params`` round trips, ZeRO-1 × TP refused,
  a wall-clock save cadence under TP refused.
"""

import copy
import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from conftest import LOSS_TOL, assert_update_parity, base_config
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models.convert import params_to_reference
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_mp import run_world
from _torch_tp_cases import LR, cfg_dict

MESHES = [(1, 4, 1), (2, 2, 1), (2, 2, 2)]
REPLICATED = ("blocks/0/ln1/scale", "blocks/0/ln2/scale", "embed",
              "final_norm/scale", "pos")


def _ref_cfg(d: dict):
    d = {k: v for k, v in d.items() if k not in ("mesh", "optim")}
    return base_config(**copy.deepcopy(d)).override(
        {"optim.initial_learning_rate": LR,
         "optim.learning_rate_decay_factor": 1.0})


def _ref_params(d: dict):
    cfg = _ref_cfg(d)
    params = ref_get_model(cfg.model).init(
        jax.random.PRNGKey(cfg.model.init_seed))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _tokens(d: dict, key: int = 0) -> dict:
    b, s = d["data"]["batch_size"], d["model"]["seq_len"]
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(key), (b, s), 0,
                                         d["model"]["vocab_size"]),
                      np.int32)
    return {"image": toks, "label": toks.copy()}


def _ref_steps(d: dict, batches: list):
    """The reference's sharded step on the 8-device mesh: (losses, the
    params after, gathered)."""
    cfg = _ref_cfg(d)
    mesh = d["mesh"]
    topo = ref_topology(RefMesh(num_replicas=mesh["num_replicas"],
                                model_parallelism=mesh["model_parallelism"],
                                seq_parallelism=mesh["seq_parallelism"]))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg), specs)
    step_fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    losses = []
    for b in batches:
        state, m = step_fn(state, topo.device_put_batch(b, seq_sharded=True))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


def _mesh_cfg(mesh, **over) -> dict:
    n, m, s = mesh
    return cfg_dict(n, m, s, **over)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    """The world-4 launch: the forward, the steps at (1, 4, 1) and
    (2, 2, 1), LAMB, the eval sums, the heads refusal, a step-0 save."""
    root = tmp_path_factory.mktemp("tp4")
    d141 = _mesh_cfg((1, 4, 1))
    params = _ref_params(d141)
    jobs = [("fwd", {"case": "forward", "cfg": d141, "params": params,
                     "tokens": _tokens(d141)["image"]})]
    for mesh in MESHES[:2]:
        d = _mesh_cfg(mesh)
        jobs.append((f"step{mesh}", {"case": "step", "cfg": d,
                                     "params": params, "grads": True,
                                     "batches": [_tokens(d)]}))
    dl = _mesh_cfg((2, 2, 1), optim={"name": "lamb"})
    jobs.append(("lamb", {"case": "step", "cfg": dl, "params": params,
                          "batches": [_tokens(dl, 0), _tokens(dl, 1)]}))
    de = _mesh_cfg((2, 2, 1))
    jobs.append(("eval", {"case": "evaluate", "cfg": de, "params": params,
                          "tokens": _tokens(de, 3)["image"],
                          "batch_size": 4}))
    dh = _mesh_cfg((1, 4, 1), heads=2)
    jobs.append(("heads", {"case": "step", "cfg": dh,
                           "params": _ref_params(dh),
                           "batches": [_tokens(dh)]}))
    ds = _mesh_cfg((1, 4, 1), train={"max_steps": 0,
                                     "train_dir": str(root / "tp_save")})
    jobs.append(("save", {"case": "save_initial", "cfg": ds}))
    for mode in MODES:
        dm = _mode_cfg(mode)
        jobs.append((f"mode_{mode}", {"case": "step", "cfg": dm,
                                      "params": params,
                                      "batches": [_tokens(dm, 0),
                                                  _tokens(dm, 1)]}))
    dq = _mesh_cfg((2, 2, 1), sync={"mode": "quorum",
                                    "num_replicas_to_aggregate": 1,
                                    "straggler_profile": "none"},
                   train={"max_steps": 4, "log_every_steps": 1,
                          "train_dir": str(root / "measured")})
    jobs.append(("measured", {"case": "sp_trainer", "cfg": dq}))
    jobs.append(("layout", {"case": "world_env",
                            "cfg": _mesh_cfg((1, 2, 2))}))
    return run_world(root / "run", 4, jobs), params, root


# the other sync modes at (2, 2, 1), two steps each, lognormal stragglers
# (the flags drawn from the same keys on both sides; timeout masks some)
MODES = ("timeout", "interval", "cdf")


def _mode_cfg(mode: str) -> dict:
    return _mesh_cfg((2, 2, 1), sync={"mode": mode,
                                      "straggler_profile": "lognormal"})


def _by_rank(res, name):
    return [r[name] for r in res]


def test_rank_layout_is_replica_model_seq(tp4):
    """At (1, 2, 2) rank ``(p·m + i)·s + j`` holds model shard ``i`` and
    sequence block ``j`` (the reference's axis order): the model groups
    are ranks {0, 2} and {1, 3}, the seq groups {0, 1} and {2, 3}."""
    res, _, _ = tp4
    for rank, r in enumerate(_by_rank(res, "layout")):
        assert r["rank"] == rank
        assert r["coords"] == (0, rank // 2, rank % 2)
        assert r["members"] == {"replica_group": [rank],
                                "model_group": [rank % 2, rank % 2 + 2],
                                "seq_group": [rank // 2 * 2,
                                              rank // 2 * 2 + 1]}
        assert (r["n"], r["local"], r["first"]) == (1, 1, 0)


def test_tp_forward_matches_the_reference(tp4):
    res, params, _ = tp4
    d = _mesh_cfg((1, 4, 1))
    toks = _tokens(d)["image"]
    cfg = _ref_cfg(d)
    model = ref_get_model(cfg.model)
    topo = ref_topology(RefMesh(num_replicas=1, model_parallelism=4))
    specs = ref_transformer.param_partition_specs(2, topo.model_axis)
    tp_apply = model.sharded_apply_factory(None, topo.model_axis)
    fn = jax.jit(jax.shard_map(lambda p, t: tp_apply(p, t, None),
                               mesh=topo.mesh, in_specs=(specs, P()),
                               out_specs=P()))
    want = np.asarray(fn(topo.device_put_state(params, specs), toks))
    for r in _by_rank(res, "fwd"):
        np.testing.assert_allclose(r["logits"], want, rtol=2e-5, atol=2e-5)


def _check_step(outs, want_loss, want_params):
    for out in outs:
        assert "error" not in out, out
        np.testing.assert_allclose(out["losses"][0], want_loss, **LOSS_TOL)
        assert_update_parity(out["params"], want_params)


def _check_replicated_grads(outs):
    """Every model rank of one (replica-process, seq block) holds the
    same replicated-leaf gradients, bit for bit."""
    groups: dict = {}
    for out in outs:
        p, _, j = out["coords"]
        groups.setdefault((p, j), []).append(out["replicated_grads"])
    for grads in groups.values():
        assert sorted(grads[0]) == sorted(REPLICATED + (
            "blocks/1/ln1/scale", "blocks/1/ln2/scale"))
        for other in grads[1:]:
            for name, g in grads[0].items():
                np.testing.assert_array_equal(other[name], g)


@pytest.mark.parametrize("mesh", MESHES[:2], ids=str)
def test_tp_step_matches_the_reference(tp4, mesh):
    res, _, _ = tp4
    d = _mesh_cfg(mesh)
    losses, want = _ref_steps(d, [_tokens(d)])
    outs = _by_rank(res, f"step{mesh}")
    _check_step(outs, losses[0], want)
    _check_replicated_grads(outs)


def test_lamb_at_tp2_matches_the_reference(tp4):
    res, _, _ = tp4
    losses, want = _ref_steps_lamb(_mesh_cfg((2, 2, 1),
                                             optim={"name": "lamb"}))
    for out in _by_rank(res, "lamb"):
        assert "error" not in out, out
        np.testing.assert_allclose(out["losses"], losses, **LOSS_TOL)
        assert_update_parity(out["params"], want)


def _ref_steps_lamb(d: dict):
    cfg = _ref_cfg(d).override({"optim.name": "lamb"})
    topo = ref_topology(RefMesh(num_replicas=2, model_parallelism=2))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg), specs)
    step_fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    losses = []
    for key in (0, 1):
        state, m = step_fn(state, topo.device_put_batch(_tokens(d, key),
                                                        seq_sharded=True))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


@pytest.mark.parametrize("mode", MODES)
def test_tp_sync_modes_match_the_reference(tp4, mode):
    """Timeout, interval and cdf at (2, 2, 1): the masked mean and the
    interval window over the replica group, the window's leaves model-
    sharded like the params."""
    res, _, _ = tp4
    d = _mode_cfg(mode)
    cfg = _ref_cfg(d).override({"sync.mode": mode,
                                "sync.straggler_profile": "lognormal"})
    topo = ref_topology(RefMesh(num_replicas=2, model_parallelism=2))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg), specs)
    step_fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    losses, flags = [], []
    for key in (0, 1):
        state, m = step_fn(state, topo.device_put_batch(_tokens(d, key),
                                                        seq_sharded=True))
        losses.append(float(m["loss"]))
        flags.append(np.asarray(m["flags"]).tolist())
    want = jax.device_get(state.params)
    for out in _by_rank(res, f"mode_{mode}"):
        assert "error" not in out, out
        assert out["flags"] == flags
        np.testing.assert_allclose(out["losses"], losses, **LOSS_TOL)
        assert_update_parity(out["params"], want)


def test_measured_quorum_flags_agree_on_every_rank(tp4):
    """Quorum k = 1 over measured host times at (2, 2, 1): each replica's
    row is its leader's time, so every rank draws the same flags."""
    res, _, _ = tp4
    outs = _by_rank(res, "measured")
    for out in outs:
        assert out["final_step"] == 4
        assert out["flags"] == outs[0]["flags"]
        assert all(sum(f) == 1 for f in out["flags"])


def test_tp_eval_sums_match_the_reference(tp4):
    res, params, _ = tp4
    d = _mesh_cfg((2, 2, 1))
    toks = _tokens(d, 3)["image"]
    cfg = _ref_cfg(d)
    topo = ref_topology(RefMesh(num_replicas=2, model_parallelism=2))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg), specs)
    correct, loss_sum, wsum = ref_api.build_eval_step(model, cfg, topo)(
        state.params, {"image": toks, "label": toks,
                       "weight": np.ones(toks.shape[0], np.float32)})
    for out in _by_rank(res, "eval"):
        assert out["num_examples"] == toks.shape[0]
        np.testing.assert_allclose(out["accuracy"],
                                   float(correct) / float(wsum), rtol=1e-5)
        np.testing.assert_allclose(out["loss"], float(loss_sum) / float(wsum),
                                   rtol=1e-4)


def test_tp_refuses_indivisible_heads(tp4):
    res, _, _ = tp4
    for out in _by_rank(res, "heads"):
        assert "divisible" in out["error"]


def test_tp_checkpoint_bytes_equal_a_one_process_save(tp4, tmp_path):
    """Rank 0 of a (1, 4, 1) run saves whole leaves: its state section
    is byte for byte a one-process run's save of the same (initial)
    params."""
    res, _, root = tp4
    assert [r["save"]["is_writer"] for r in res] == [True, False, False,
                                                     False]
    d = _mesh_cfg((1, 1, 1), train={"max_steps": 0,
                                    "train_dir": str(tmp_path / "one")})
    Trainer(ExperimentConfig.from_dict(d), device="cpu").run()
    payloads = [ckpt._read_payload(ckpt._ckpt_path(path, 0))
                for path in (root / "tp_save", tmp_path / "one")]
    tp_bytes, one_bytes = (ckpt.msgpack_serialize(p["state"])
                           for p in payloads)
    assert tp_bytes == one_bytes
    worlds = [json.loads(p["extra"])["world"] for p in payloads]
    assert worlds == [{"num_replicas": 1, "process_count": 4,
                       "mesh": {"model": 4}},
                      {"num_replicas": 1, "process_count": 1, "mesh": {}}]


# -- the Trainer on the 3-D mesh ----------------------------------------------

def _trainer_cfg(train_dir) -> dict:
    return _mesh_cfg((2, 2, 2), sync={"mode": "quorum",
                                      "num_replicas_to_aggregate": 1,
                                      "straggler_profile": "lognormal"},
                     train={"max_steps": 12, "train_dir": str(train_dir),
                            "log_every_steps": 6, "save_interval_secs": 0,
                            "save_interval_steps": 6})


@pytest.fixture(scope="module")
def tp8(tmp_path_factory):
    """The world-8 launch: one step at (2, 2, 2) and the Trainer; before
    it, a one-process run's checkpoint for the Trainer to restore."""
    root = tmp_path_factory.mktemp("tp8")
    one = copy.deepcopy(_trainer_cfg(root / "one"))
    one["mesh"] = {"num_replicas": 2}
    one["train"]["max_steps"] = 2
    Trainer(ExperimentConfig.from_dict(one), device="cpu").run()
    d = _mesh_cfg((2, 2, 2))
    params = _ref_params(d)
    jobs = [("step", {"case": "step", "cfg": d, "params": params,
                      "grads": True, "batches": [_tokens(d)]}),
            ("trainer", {"case": "trainer",
                         "cfg": _trainer_cfg(root / "tp"),
                         "resume_steps": 14,
                         "restore_dir": str(root / "one")})]
    return run_world(root / "run", 8, jobs, timeout_s=300), root


def test_tp_sp_step_at_2_2_2_matches_the_reference(tp8):
    res, _ = tp8
    d = _mesh_cfg((2, 2, 2))
    losses, want = _ref_steps(d, [_tokens(d)])
    outs = _by_rank(res, "step")
    _check_step(outs, losses[0], want)
    _check_replicated_grads(outs)


def test_trainer_on_the_3d_mesh(tp8):
    res, _ = tp8
    outs = _by_rank(res, "trainer")
    for out in outs:
        assert out["final_step"] == 12
        assert out["last"]["num_contributors"] == 1.0
        assert np.isfinite(out["eval"]["loss"])
        assert out["resumed_start"] == 12 and out["resumed_final"] == 14
        assert out["flags"] == outs[0]["flags"]
        assert out["digest"] == outs[0]["digest"]
        assert out["eval"] == {**outs[0]["eval"],
                               "seconds": out["eval"]["seconds"]}
    assert {o["coords"] for o in outs} == {(p, i, j) for p in range(2)
                                           for i in range(2)
                                           for j in range(2)}
    _check_replicated_grads(outs)
    with open(_trainer_log(tp8)) as f:
        compile_recs = [json.loads(x) for x in f
                        if '"event": "compile"' in x]
    assert compile_recs[0]["source"] == "eager"
    assert compile_recs[0]["reason"].startswith("processes")


def _trainer_log(tp8):
    return tp8[1] / "tp" / "train_log.jsonl"


def _journal(train_dir) -> list:
    path = train_dir / "recovery_journal.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_one_process_checkpoint_restores_into_the_shards(tp8):
    res, root = tp8
    saved, _, step = ckpt.restore_state(root / "one")
    for out in _by_rank(res, "trainer"):
        assert out["restored_step"] == step == 2
        for a, b in zip(jax.tree.leaves(out["restored_params"]),
                        jax.tree.leaves(saved["params"])):
            np.testing.assert_array_equal(a, np.asarray(b))
    ev = [r for r in _journal(root / "one")
          if r.get("action") == "cross_world_restore"]
    assert ev[-1]["saved_world"]["mesh"] == {"replica": 2}
    assert ev[-1]["new_world"] == {"num_replicas": 2, "process_count": 8,
                                   "mesh": {"replica": 2, "model": 2,
                                            "seq": 2}}


def test_tp_checkpoint_restores_at_model_parallelism_1(tp8, tmp_path):
    import shutil
    res, root = tp8
    shutil.copytree(root / "tp", tmp_path / "tp")
    d = _trainer_cfg(tmp_path / "tp")
    d["mesh"] = {"num_replicas": 2}
    d["train"].update(resume=True, max_steps=14)
    t = Trainer(ExperimentConfig.from_dict(d), device="cpu")
    assert t._start_step == 14
    saved, _, _ = ckpt.restore_state(tmp_path / "tp")
    for a, b in zip(jax.tree.leaves(params_to_reference(t.state.params)),
                    jax.tree.leaves(saved["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    digest = ckpt.params_digest(params_to_reference(t.logical_params(),
                                                    keep_bfloat16=True))
    assert digest == _by_rank(res, "trainer")[0]["resumed_digest"]
    ev = [r for r in _journal(tmp_path / "tp")
          if r.get("action") == "cross_world_restore"]
    assert ev[-1]["saved_world"]["mesh"] == {"replica": 2, "model": 2,
                                             "seq": 2}
    assert ev[-1]["new_world"]["mesh"] == {"replica": 2}
    # launch eval --single_device on the TP run's checkpoint: the
    # one-process Trainer's eval of the same params
    from distributedmnist_tpu_torch.evalsvc.evaluator import Evaluator
    got = Evaluator(tmp_path / "tp", single_device=True,
                    device="cpu").evaluate_checkpoint()
    want = t.evaluate("test")
    assert got["step"] == 14 and got["num_examples"] == want["num_examples"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["precision_at_1"] == want["accuracy"]


# -- the CLI ------------------------------------------------------------------

def test_launch_train_at_model_parallelism_2(tmp_path):
    """``launch train --device cpu --dist-backend gloo`` in two processes
    at ``mesh.model_parallelism=2``: each trains its shard, evaluates,
    and prints the reference's last line with the same digest."""
    logs = run_world(tmp_path / "cli", 2, [], argv=[
        "-m", "distributedmnist_tpu_torch.launch", "train",
        "--config", "configs/synthetic_lm_transformer.json",
        "mesh.num_replicas=1", "mesh.model_parallelism=2",
        "model.model_dim=32", "model.seq_len=32", "model.vocab_size=37",
        "model.compute_dtype=float32", "data.batch_size=8",
        "data.synthetic_train_size=64", "data.synthetic_test_size=16",
        "train.max_steps=3", f"train.train_dir={tmp_path / 'run'}",
        "--device", "cpu", "--dist-backend", "gloo"])
    lines = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    for line in lines:
        assert line["summary"]["final_step"] == 3
        assert np.isfinite(line["summary"]["last_metrics"]["loss"])
        assert line["test"]["num_examples"] == 16
    assert lines[0]["summary"]["params_digest"] == \
        lines[1]["summary"]["params_digest"]
    assert ckpt.latest_checkpoint_step(tmp_path / "run") == 3


# -- the rule engine, the shard conversion and the refusals ------------------

@pytest.mark.parametrize("model_axis", [None, "model"])
def test_partition_rules_match_the_reference(model_axis):
    """The transformer's table through the port's engine gives the
    reference engine's spec for every leaf (a spec tuple against a
    ``PartitionSpec``), with and without the model axis bound."""
    from distributedmnist_tpu.models.registry import \
        transformer_partition_rules as ref_rules
    from distributedmnist_tpu.parallel.partition_rules import (
        RuleAxes as RefAxes, match_partition_rules as ref_match)
    from distributedmnist_tpu_torch.models.registry import \
        transformer_partition_rules
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        RuleAxes, match_partition_rules, spec_leaves)
    params = _ref_params(_mesh_cfg((1, 1, 1)))
    want = jax.tree.leaves(
        ref_match(ref_rules(0)(RefAxes(model=model_axis)), params),
        is_leaf=lambda x: isinstance(x, P))
    got = spec_leaves(match_partition_rules(
        transformer_partition_rules(0)(RuleAxes(model=model_axis)), params))
    assert got == [tuple(w) for w in want]


def test_unmatched_leaf_is_loud_and_scalars_never_split():
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        UnmatchedLeafError, match_partition_rules)
    tree = {"w": np.zeros((4, 4)), "b": np.zeros(1)}
    assert match_partition_rules([(r"^w$", (None, "model"))], tree) == {
        "w": (None, "model"), "b": ()}
    with pytest.raises(UnmatchedLeafError, match="'w'"):
        match_partition_rules([(r"^v$", ())], tree)


@pytest.mark.parametrize("m", [2, 4])
def test_shard_and_gather_params_round_trip(m):
    """``shard_params`` cuts the reference's full tree along the rule's
    dim (``wqkv`` on its last, ``wo`` and ``w2`` on their first, ``w1``
    on its last; the rest whole) and ``gather_params`` puts it back."""
    from distributedmnist_tpu_torch.models.convert import (gather_params,
                                                           shard_params)
    from distributedmnist_tpu_torch.models.registry import \
        transformer_partition_rules
    from distributedmnist_tpu_torch.parallel.partition_rules import RuleAxes
    params = _ref_params(_mesh_cfg((1, 1, 1)))
    rules = transformer_partition_rules(0)(RuleAxes(model="model"))
    shards = [shard_params(params, rules, r, m) for r in range(m)]
    blk, d = params["blocks"][0], 32
    for r, sh in enumerate(shards):
        b = sh["blocks"][0]
        w = d // m
        np.testing.assert_array_equal(
            b["wqkv"], blk["wqkv"][:, :, r * w:(r + 1) * w])
        np.testing.assert_array_equal(b["wo"], blk["wo"][r * w:(r + 1) * w])
        np.testing.assert_array_equal(
            b["w1"], blk["w1"][:, r * 4 * w:(r + 1) * 4 * w])
        np.testing.assert_array_equal(
            b["w2"], blk["w2"][r * 4 * w:(r + 1) * 4 * w])
        assert b["ln1"]["scale"].shape == (d,) and sh["embed"].shape == (
            37, d)
    back = gather_params(shards, rules)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_zero1_under_tensor_parallelism_is_refused():
    """ZeRO-1 over tensor- or sequence-parallel replicas is not ported:
    a ConfigError naming the ROADMAP item, before any process group."""
    from distributedmnist_tpu_torch.core.config import ConfigError
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    d = _mesh_cfg((2, 2, 1), parallel={"shard_weight_update": True})
    cfg = ExperimentConfig.from_dict(d)
    with pytest.raises(ConfigError, match="item 8d"):
        api.build_train_step(get_model(cfg.model), cfg,
                             lr_schedule.constant(LR))


def test_time_based_saves_under_tensor_parallelism_are_refused(tmp_path):
    """A save gathers the model shards, a collective every rank of the
    model group must enter at one step; each rank's clock would time a
    wall-clock cadence apart, so it is refused before any process
    group."""
    d = _mesh_cfg((1, 2, 1), train={"save_interval_secs": 5.0,
                                    "train_dir": str(tmp_path)})
    with pytest.raises(ValueError, match="save_interval_steps"):
        Trainer(ExperimentConfig.from_dict(d), device="cpu")
