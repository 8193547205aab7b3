"""Pipeline parallelism (``mesh.pipeline_parallelism``) in the port against
the reference (≙ ``tests/test_pipeline_parallel.py`` and the PP cases of
``tests/test_moe.py``): the port runs in gloo worker processes on the
CPU (``_torch_mp``, cases in ``_torch_pp_cases``), one launch each of 2,
4 and 8 processes, from the reference's params (converted, stacked by
the port's ``stack_block_params`` / ``stack_block_params_chunked``) and
numpy batches made from a seed.

* One float32 train step at every mesh the reference tests — GPipe
  ``(n, S, m, M)`` = (1,4,1,4), (2,4,1,2), (1,2,1,1), (2,2,2,2), (1,2,4,2);
  GPipe × SP (ring) (2,2,2,2), (1,2,4,2); PP × EP and PP × SP × EP
  (``test_moe.py:233-330``); 1F1B (1,2,2,4,4), (2,2,2,2,4), (1,4,1,4,4),
  × TP, × SP (Ulysses) and the four 1F1B × EP rows
  (``test_moe.py:500-507``); both schedules under
  ``train.grad_accum_steps=2`` — against the reference's dense one-device
  update, compared in the stacked layout at the reference's tolerances
  (``LOSS_TOL``, ``assert_update_parity``).
* The eval step of a GPipe and a 1F1B mesh against the reference's
  dense eval sums, at every eval microbatch count.
* The Trainer at DP × PP (quorum, saves, eval, resume) and at DP × 1F1B
  × TP (saves, eval, resume); a resume across schedules refused with the
  reference's message; the refusals inside a group (ring under 1F1B,
  ``save_attn``, indivisible microbatches or layers, an expert axis
  without experts).
* A PP checkpoint both ways: the reference's chunk-interleaved save
  resumed by the port's Trainer, and the port's save restored by the
  reference's ``restore_checkpoint`` into its stacked template.
* The rank layout ``(P_r, m, s, S, e)`` and its groups.
* ``launch train`` over two gloo processes at
  ``mesh.pipeline_parallelism=2`` under 1F1B, then ``launch eval`` with
  the training mesh over two processes on its checkpoint.
* ZeRO-1 (``_torch_zero1_mp``) at DP 2 × PP 2 (GPipe) and DP 2 × PP 2 ×
  TP 2 (1F1B, 2 chunks), monolithic and bucketed with resident params:
  two momentum steps against the reference's ZeRO-1 step and the
  port's replicated one, in the stacked layout; the plan shards only
  ``embed``, ``pos`` and ``final_norm``, the stacked block leaves keep
  the stage axis.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import LOSS_TOL, assert_update_parity, base_config
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu_torch.train import checkpoint as ckpt

from _torch_mp import run_world
from _torch_tp_cases import LR
from _torch_zero1_mp import check_zero1, ref_mesh, with_knob, zero1_jobs

# (n, S, m, s, e, M, schedule, chunks, layers, moe, sp_attention)
GPIPE = [(1, 4, 1, 1, 1, 4), (2, 4, 1, 1, 1, 2), (1, 2, 1, 1, 1, 1),
         (2, 2, 2, 1, 1, 2), (1, 2, 4, 1, 1, 2)]
GPIPE_SP = [(2, 2, 1, 2, 1, 2), (1, 2, 1, 4, 1, 2)]
GPIPE_EP = [(1, 2, 1, 1, 2, 2), (1, 2, 1, 1, 2, 4), (2, 2, 1, 1, 1, 2),
            (1, 2, 2, 1, 2, 2), (1, 2, 1, 2, 2, 2)]
ONE_F = [(1, 2, 1, 1, 1, 4, 2), (2, 2, 1, 1, 1, 2, 2), (1, 4, 1, 1, 1, 4, 1),
         (2, 2, 2, 1, 1, 2, 2), (1, 2, 4, 1, 1, 4, 2),
         (2, 2, 1, 2, 1, 2, 2), (1, 2, 1, 4, 1, 4, 2)]
ONE_F_EP = [(1, 2, 1, 1, 2, 2, 2), (2, 2, 1, 1, 2, 2, 2),
            (1, 2, 2, 1, 2, 2, 2), (1, 2, 1, 2, 2, 2, 2)]


def _mesh(n, S, m, s, e, M, schedule="gpipe", chunks=1) -> dict:
    return {"num_replicas": n, "pipeline_parallelism": S,
            "model_parallelism": m, "seq_parallelism": s,
            "expert_parallelism": e, "pipeline_microbatches": M,
            "pipeline_schedule": schedule, "pipeline_chunks": chunks}


def _cfg(mesh: dict, moe: bool = False, layers: int = 4,
         sp_attention: str = "ring") -> dict:
    """The reference tests' tiny transformers: the dense one of
    ``test_pipeline_parallel.py _cfg`` (seq 16, d 32, 4 heads, vocab 37,
    batch 8 a replica) or the MoE one of ``test_moe.py _cfg`` (d 16, 2
    heads, vocab 31, 4 experts at capacity factor 4 in 4 groups a row,
    batch 4 a replica); float32, dense attention, sync."""
    n = mesh["num_replicas"]
    model = {"name": "transformer", "compute_dtype": "float32",
             "seq_len": 16, "model_dim": 32, "num_heads": 4,
             "num_layers": layers, "vocab_size": 37,
             "attention_impl": "dense", "sp_attention": sp_attention}
    if moe:
        model.update(model_dim=16, num_heads=2, vocab_size=31,
                     num_experts=4, expert_capacity_factor=4.0,
                     moe_num_groups=4)
    return {"data": {"dataset": "synthetic_lm",
                     "batch_size": (4 if moe else 8) * n,
                     "synthetic_train_size": 256, "synthetic_test_size": 32,
                     "use_native_pipeline": False},
            "model": model,
            "sync": {"mode": "sync", "straggler_profile": "none"},
            "mesh": mesh,
            "optim": {"initial_learning_rate": LR,
                      "learning_rate_decay_factor": 1.0},
            "train": {"max_steps": 10, "log_every_steps": 5,
                      "save_interval_steps": 0, "save_results_period": 0}}


def _ref_cfg(d: dict):
    d = {k: v for k, v in d.items() if k != "optim"}
    return base_config(**copy.deepcopy(d))


def _ref_params(d: dict):
    cfg = _ref_cfg({k: v for k, v in d.items() if k != "mesh"})
    params = ref_get_model(cfg.model).init(
        jax.random.PRNGKey(cfg.model.init_seed))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _tokens(d: dict, seed: int = 0) -> dict:
    """A step's tokens: ``grad_accum_steps`` global batches."""
    b = d["data"]["batch_size"] * d["train"].get("grad_accum_steps", 1)
    s = d["model"]["seq_len"]
    toks = np.random.default_rng(seed).integers(
        0, d["model"]["vocab_size"], (b, s)).astype(np.int32)
    return {"image": toks, "label": toks.copy()}


def _dense_update(d: dict, batch: dict):
    """The reference's dense one-device update (≙ ``_dense_update`` /
    ``_dense_moe_update``): the loss (+ aux_weight·aux), one SGD step."""
    cfg = _ref_cfg({k: v for k, v in d.items() if k != "mesh"})
    mc = cfg.model
    params = _ref_params(d)

    def loss_fn(p):
        if mc.num_experts:
            logits, aux = ref_transformer.apply(
                p, batch["image"], num_heads=mc.num_heads,
                compute_dtype=jnp.float32, num_experts=mc.num_experts,
                capacity_factor=mc.expert_capacity_factor,
                moe_num_groups=mc.moe_num_groups,
                moe_router_top_k=mc.moe_router_top_k, return_aux=True)
            return (ref_transformer.loss_fn(logits, batch["label"])
                    + mc.moe_aux_weight * aux)
        logits = ref_transformer.apply(p, batch["image"],
                                       num_heads=mc.num_heads,
                                       compute_dtype=jnp.float32)
        return ref_transformer.loss_fn(logits, batch["label"])

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree.map(lambda p, g: p - LR * g, params, grads)


def _ref_stacked(params, mesh: dict):
    if mesh["pipeline_schedule"] == "1f1b":
        return ref_transformer.stack_block_params_chunked(
            params, mesh["pipeline_parallelism"], mesh["pipeline_chunks"])
    return ref_transformer.stack_block_params(params)


def _cases() -> dict:
    """Every step case: name → (its config, the world it runs in)."""
    out = {}

    def add(name, d):
        mesh = d["mesh"]
        span = (mesh["pipeline_parallelism"] * mesh["model_parallelism"]
                * mesh["seq_parallelism"] * mesh["expert_parallelism"])
        # two replicas run on two replica-processes where the world is
        # 4 or less, else on one (looped)
        n = mesh["num_replicas"]
        world = span * n if span * n <= 4 else span
        out[name] = (d, world)

    for c in GPIPE:
        add(f"gpipe{c}", _cfg(_mesh(*c)))
    for c in GPIPE_SP:
        add(f"gpipe_sp{c}", _cfg(_mesh(*c)))
    for c in GPIPE_EP:
        add(f"gpipe_ep{c}", _cfg(_mesh(*c), moe=True, layers=2))
    for *c, v in ONE_F:
        add(f"1f1b{tuple(c) + (v,)}",
            _cfg(_mesh(*c, "1f1b", v), sp_attention="ulysses"))
    for *c, v in ONE_F_EP:
        add(f"1f1b_ep{tuple(c) + (v,)}",
            _cfg(_mesh(*c, "1f1b", v), moe=True, sp_attention="ulysses"))
    # accumulation: two global batches a step, each replica's rows in
    # two microbatches through the pipeline (the mean is the dense
    # update's over all rows)
    for name, mesh in (("accum_gpipe", _mesh(2, 2, 1, 1, 1, 2)),
                       ("accum_1f1b", _mesh(2, 2, 1, 1, 1, 2, "1f1b", 2))):
        d = _cfg(mesh)
        d["train"]["grad_accum_steps"] = 2
        add(name, d)
    return out


CASES = _cases()


def _trainer_cfg(train_dir, mesh: dict, steps: int, every: int,
                 **sync) -> dict:
    d = _cfg(mesh)
    d["train"].update(max_steps=steps, train_dir=str(train_dir),
                      log_every_steps=every, save_interval_secs=0,
                      save_interval_steps=every)
    d["sync"].update(sync)
    return d


RT_MESH = _mesh(1, 2, 2, 1, 1, 2, "1f1b", 2)


def _refusal_cfgs() -> dict:
    base = _mesh(1, 2, 1, 2, 1, 2, "1f1b", 2)
    ring = _cfg(base)
    save_attn = _cfg(_mesh(2, 2, 1, 1, 1, 2))
    save_attn["model"].update(remat=True, remat_policy="save_attn",
                              attention_impl="flash")
    save_attn_1f = copy.deepcopy(save_attn)
    save_attn_1f["mesh"].update(pipeline_schedule="1f1b", pipeline_chunks=2)
    micro = _cfg(_mesh(2, 2, 1, 1, 1, 3))
    layers = _cfg(_mesh(2, 2, 1, 1, 1, 2), layers=3)
    experts = _cfg(_mesh(1, 2, 1, 1, 2, 2))
    return {"step_ring_1f1b": ring, "step_save_attn": save_attn,
            "step_save_attn_1f1b": save_attn_1f,
            "micro": micro, "layers": layers, "step_no_experts": experts}


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp2")
    jobs = [(name, {"case": "step", "cfg": d, "params": _ref_params(d),
                    "batch": _tokens(d)})
            for name, (d, world) in CASES.items() if world == 2]
    return run_world(root / "run", 2, jobs, cases="_torch_pp_cases")


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    """The world-4 launch: the 4-process steps, the evals, the layout,
    the Trainers, the refusals and the checkpoint round trips (the
    reference's save made here first)."""
    root = tmp_path_factory.mktemp("pp4")
    jobs = [(name, {"case": "step", "cfg": d, "params": _ref_params(d),
                    "batch": _tokens(d)})
            for name, (d, world) in CASES.items() if world == 4]
    for name, mesh in (("eval_gpipe", _mesh(1, 4, 1, 1, 1, 4)),
                       ("eval_1f1b", _mesh(1, 2, 2, 1, 1, 4, "1f1b", 2))):
        d = _cfg(mesh)
        jobs.append((name, {"case": "evaluate", "cfg": d,
                            "params": _ref_params(d),
                            "tokens": _tokens(d, 3)["image"][:6]}))
    jobs.append(("layout", {"case": "world_env",
                            "cfg": _cfg(_mesh(1, 2, 1, 1, 2, 2),
                                        moe=True)}))
    jobs.append(("trainer_dp_pp", {
        "case": "trainer", "resume_steps": 14,
        "cfg": _trainer_cfg(root / "dp_pp", _mesh(2, 4, 1, 1, 1, 2), 12, 6,
                            mode="quorum", num_replicas_to_aggregate=1,
                            straggler_profile="lognormal")}))
    jobs.append(("trainer_1f1b_tp", {
        "case": "trainer", "resume_steps": 12,
        "cfg": _trainer_cfg(root / "tp_1f1b",
                            _mesh(2, 2, 2, 1, 1, 2, "1f1b", 2), 10, 5),
        "other": {"pipeline_schedule": "gpipe", "pipeline_chunks": 1}}))
    jobs.append(("trainer_cross", {
        "case": "trainer", "resume_steps": 2,
        "cfg": _trainer_cfg(root / "cross", _mesh(2, 2, 1, 1, 1, 2), 2, 2),
        "other": {"pipeline_schedule": "1f1b", "pipeline_chunks": 2}}))
    jobs.append(("refusals", {"case": "refusals",
                              "cfgs": _refusal_cfgs()}))
    # the reference's 1F1B save (its own init, chunk-interleaved)
    d = _trainer_cfg(root / "ref_save", RT_MESH, 4, 2)
    rcfg = _ref_cfg(d)
    topo = ref_topology(RefMesh(**{k: v for k, v in RT_MESH.items()}))
    state = ref_api.init_train_state(ref_get_model(rcfg.model), rcfg, topo)
    state = state.replace(step=jnp.int32(4), updates_applied=jnp.int32(4))
    ref_ckpt.save_checkpoint(root / "ref_save", state, 4,
                             extra={"config": rcfg.to_dict()})
    jobs.append(("restore_ref", {"case": "restore", "cfg": d}))
    ds = _trainer_cfg(root / "port_save", RT_MESH, 0, 2)
    jobs.append(("save_port", {"case": "save_initial", "cfg": ds,
                               "params": _ref_params(ds)}))
    dz = ZERO1["dp2_pp2_gpipe"]
    jobs += zero1_jobs("z1_dp2_pp2_gpipe", dz, _ref_params(dz),
                       _zero1_batches(dz))
    res = run_world(root / "run", 4, jobs, timeout_s=300,
                    cases="_torch_pp_cases")
    return res, root, jax.tree.map(np.asarray, jax.device_get(state.params))


@pytest.fixture(scope="module")
def pp8(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp8")
    jobs = [(name, {"case": "step", "cfg": d, "params": _ref_params(d),
                    "batch": _tokens(d)})
            for name, (d, world) in CASES.items() if world == 8]
    dz = ZERO1["dp2_pp2_tp2_1f1b"]
    jobs += zero1_jobs("z1_dp2_pp2_tp2_1f1b", dz, _ref_params(dz),
                       _zero1_batches(dz))
    return run_world(root / "run", 8, jobs, timeout_s=300,
                     cases="_torch_pp_cases")


def _by_rank(res, name):
    return [r[name] for r in res]


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_the_dense_update(pp2, pp4, pp8, name):
    d, world = CASES[name]
    res = {2: pp2, 4: pp4[0], 8: pp8}[world]
    want_loss, want = _dense_update(d, _tokens(d))
    want = _ref_stacked(want, d["mesh"])
    outs = _by_rank(res, name)
    for out in outs:
        assert "error" not in out, out
        np.testing.assert_allclose(out["loss"], want_loss, **LOSS_TOL)
        assert 0.0 <= out["train_acc"] <= 1.0
        assert out["train_acc"] == outs[0]["train_acc"]
        assert_update_parity(out["params"], want)
        # on the CPU nothing is staged through host memory
        assert out["staged"] == {"ppermute": 0, "all_to_all": 0, "p2p": 0}
    assert len({o["coords"] for o in outs}) == len(outs)


def _ref_eval_sums(d: dict, tokens):
    cfg = _ref_cfg({k: v for k, v in d.items() if k != "mesh"})
    logits = ref_transformer.apply(_ref_params(d), tokens,
                                   num_heads=cfg.model.num_heads,
                                   compute_dtype=jnp.float32)
    lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    tgt = tokens[:, 1:]
    nll = -np.take_along_axis(np.asarray(lp), tgt[..., None], -1)[..., 0]
    correct = np.asarray(jnp.argmax(lp, axis=-1)) == tgt
    return [float(correct.sum()), float(nll.sum()), float(tgt.size)]


@pytest.mark.parametrize("name,mesh", [
    ("eval_gpipe", _mesh(1, 4, 1, 1, 1, 4)),
    ("eval_1f1b", _mesh(1, 2, 2, 1, 1, 4, "1f1b", 2))])
def test_pp_eval_matches_the_dense_eval(pp4, name, mesh):
    """The eval step pipelines 6 rows at ``m_eval`` 3 (the largest count
    up to ``pipeline_microbatches`` 4 that divides them) and every stage
    returns the dense sums."""
    d = _cfg(mesh)
    want = _ref_eval_sums(d, _tokens(d, 3)["image"][:6])
    for out in _by_rank(pp4[0], name):
        np.testing.assert_allclose(out["sums"], want, rtol=2e-5, atol=1e-4)


def test_rank_layout_is_replica_model_seq_stage_expert(pp4):
    """At (n 1, S 2, e 2) rank ``t·2 + k`` holds stage ``t`` and expert
    shard ``k``: the stage groups {0, 2} and {1, 3}, the expert groups
    {0, 1} and {2, 3}."""
    for rank, r in enumerate(_by_rank(pp4[0], "layout")):
        assert r["rank"] == rank
        assert r["coords"] == (0, 0, 0, rank // 2, rank % 2)
        pair = [rank // 2 * 2, rank // 2 * 2 + 1]
        assert r["members"] == {"replica_group": [rank],
                                "model_group": None, "seq_group": None,
                                "stage_group": [rank % 2, rank % 2 + 2],
                                "expert_group": pair,
                                "expert_model_group": pair}


def _check_trainer(outs, steps, resumed):
    assert [o["is_writer"] for o in outs] == [True] + [False] * (
        len(outs) - 1)
    for out in outs:
        assert out["final_step"] == steps
        assert np.isfinite(out["last"]["loss"])
        assert np.isfinite(out["eval"]["loss"])
        assert out["resumed_start"] == steps
        assert out["resumed_final"] == resumed
        assert out["digest"] == outs[0]["digest"]
        assert out["resumed_digest"] == outs[0]["resumed_digest"]
        assert out["eval"] == {**outs[0]["eval"],
                               "seconds": out["eval"]["seconds"]}


def test_trainer_end_to_end_dp_pp(pp4):
    """≙ ``test_trainer_end_to_end_dp_pp``: (replica 2, stage 4) with a
    quorum of one over lognormal stragglers, saves by steps, eval and a
    resume with stacked params."""
    outs = _by_rank(pp4[0], "trainer_dp_pp")
    _check_trainer(outs, 12, 14)
    for out in outs:
        assert out["last"]["num_contributors"] == 1.0


def test_trainer_end_to_end_1f1b_tp(pp4):
    """≙ ``test_trainer_end_to_end_1f1b``: (replica 2, stage 2, model 2)
    under 1F1B with 2 chunks: saves, eval through the chunked ring with
    Megatron shards, resume; the checkpoint holds the chunk-interleaved
    stacked layout, and a GPipe resume of it is refused."""
    res, root, _ = pp4
    outs = _by_rank(res, "trainer_1f1b_tp")
    _check_trainer(outs, 10, 12)
    saved, extra, step = ckpt.restore_state(root / "tp_1f1b")
    assert step == 12
    assert extra["world"] == {"num_replicas": 2, "process_count": 4,
                              "mesh": {"replica": 2, "model": 2,
                                       "stage": 2}}
    assert saved["params"]["blocks"]["wqkv"].shape == (4, 32, 3, 32)
    for out in outs:
        assert "pipeline layout" in out["cross_schedule"]


def test_resume_refuses_cross_schedule_layout(pp4):
    """≙ the reference's test: a GPipe checkpoint does not restore into
    a 1F1B run (the layouts' shapes match, their layer orders do not),
    with the reference's message."""
    for out in _by_rank(pp4[0], "trainer_cross"):
        assert out["cross_schedule"] == (
            "checkpoint was written with pipeline layout (schedule, "
            "chunks)=('gpipe', 1) but this run uses ('1f1b', 2); the "
            "stacked layer orders differ — restoring would silently "
            "permute the model")


def test_refusals_inside_a_group(pp4):
    """The reference's refusals, with its messages, on a process group
    large enough for the mesh."""
    for out in _by_rank(pp4[0], "refusals"):
        assert "requires model.sp_attention='ulysses'" in \
            out["step_ring_1f1b"]
        assert out["step_save_attn"] == (
            "model.remat_policy='save_attn' is not supported under "
            "pipeline parallelism (stage scans use full per-layer remat); "
            "set remat_policy='full'")
        assert "under the 1f1b schedule" in out["step_save_attn_1f1b"]
        assert out["micro"] == ("per-replica batch 8 not divisible by "
                                "pipeline_microbatches 3")
        assert out["layers"] == ("num_layers 3 not divisible by "
                                 "pipeline_parallelism 2")
        assert out["step_no_experts"] == (
            "mesh has expert parallelism but the model has no experts "
            "(model.num_experts == 0)")


def test_reference_pp_checkpoint_resumes_in_the_port(pp4):
    """The reference's 1F1B run saved at (stage 2, model 2): the port's
    Trainer on that mesh resumes it, its params bitwise the reference's
    chunk-interleaved stacked ones."""
    res, _, ref_params = pp4
    for out in _by_rank(res, "restore_ref"):
        assert out["step"] == 4
        for a, b in zip(jax.tree.leaves(out["params"]),
                        jax.tree.leaves(ref_params)):
            np.testing.assert_array_equal(a, b)


def test_port_pp_checkpoint_restores_in_the_reference(pp4):
    """The port's 1F1B save at (stage 2, model 2), restored by the
    reference's ``restore_checkpoint`` into its own stacked template:
    the reference's params, stacked in its chunk order, bit for bit."""
    res, root, _ = pp4
    d = _trainer_cfg(root / "port_save", RT_MESH, 0, 2)
    rcfg = _ref_cfg(d)
    topo = ref_topology(RefMesh(**RT_MESH))
    template = ref_api.init_train_state(ref_get_model(rcfg.model), rcfg,
                                        topo)
    state, _, step = ref_ckpt.restore_checkpoint(root / "port_save",
                                                 template)
    assert step == 0
    want = ref_transformer.stack_block_params_chunked(_ref_params(d), 2, 2)
    got = jax.device_get(state.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launch_train_and_eval_at_pipeline_parallelism_2(tmp_path):
    """``launch train --device cpu --dist-backend gloo`` in two processes
    at ``mesh.pipeline_parallelism=2`` under 1F1B with 2 chunks: each
    trains its stage and prints the reference's last line with the same
    digest; then ``launch eval`` with the training mesh over two
    processes evaluates the run's checkpoint (rank 0 prints the line)
    and ``--single_device`` is refused."""
    run = tmp_path / "run"
    logs = run_world(tmp_path / "cli", 2, [], argv=[
        "-m", "distributedmnist_tpu_torch.launch", "train",
        "--config", "configs/synthetic_lm_transformer.json",
        "mesh.num_replicas=1", "mesh.pipeline_parallelism=2",
        "mesh.pipeline_schedule=1f1b", "mesh.pipeline_chunks=2",
        "mesh.pipeline_microbatches=2", "model.num_layers=4",
        "model.model_dim=32", "model.seq_len=32", "model.vocab_size=37",
        "model.compute_dtype=float32", "data.batch_size=8",
        "data.synthetic_train_size=64", "data.synthetic_test_size=16",
        "train.max_steps=3", f"train.train_dir={run}",
        "--device", "cpu", "--dist-backend", "gloo"])
    lines = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    for line in lines:
        assert line["summary"]["final_step"] == 3
        assert np.isfinite(line["summary"]["last_metrics"]["loss"])
        assert line["test"]["num_examples"] == 16
    assert lines[0]["summary"]["params_digest"] == \
        lines[1]["summary"]["params_digest"]
    assert ckpt.latest_checkpoint_step(run) == 3
    logs = run_world(tmp_path / "eval", 2, [], argv=[
        "-m", "distributedmnist_tpu_torch.launch", "eval",
        "--train_dir", str(run), "--eval_dir", str(tmp_path / "ev"),
        "--run_once", "--device", "cpu"])
    printed = [ln for ln in logs[0].splitlines()
               if ln.startswith("Num examples: 16")]
    assert len(printed) == 1
    assert not [ln for ln in logs[1].splitlines()
                if ln.startswith("Num examples")]
    rec = json.loads((tmp_path / "ev" / "eval_log.jsonl").read_text()
                     .splitlines()[-1])
    assert rec["step"] == 3
    np.testing.assert_allclose(rec["loss"], lines[0]["test"]["loss"],
                               rtol=1e-5)
    from distributedmnist_tpu_torch.evalsvc.evaluator import Evaluator
    with pytest.raises(ValueError, match="pipeline-stacked"):
        Evaluator(run, single_device=True, device="cpu")


# -- ZeRO-1 over pipeline-parallel replicas ----------------------------------

ZERO1 = {"dp2_pp2_gpipe": _cfg(_mesh(2, 2, 1, 1, 1, 2)),
         "dp2_pp2_tp2_1f1b": _cfg(_mesh(2, 2, 2, 1, 1, 2, "1f1b", 2),
                                  sp_attention="ulysses")}


def _zero1_batches(d: dict) -> list:
    return [_tokens(d, 0), _tokens(d, 1)]


@pytest.mark.parametrize("name", list(ZERO1))
def test_zero1_over_pp_matches_the_reference(pp4, pp8, name):
    """Two float32 momentum steps of ZeRO-1 at DP 2 × PP 2 (GPipe, in
    ``pp4``) and DP 2 × PP 2 × TP 2 (1F1B, 2 chunks, in ``pp8``),
    monolithic and bucketed with resident params, against the
    reference's ZeRO-1 step on the same mesh and params and the port's
    replicated step, in the stacked layout: the plan shards ``embed``,
    ``pos`` and ``final_norm`` (summed over the stages before their
    reduce-scatter), the stacked block leaves keep their stage rows."""
    d = ZERO1[name]
    res = pp4[0] if name.endswith("gpipe") else pp8

    def ref_cfg(knob):
        return _ref_cfg(with_knob(d, knob)).override(
            {"optim.name": "momentum", "optim.momentum": 0.9})
    shards = check_zero1(res, f"z1_{name}", ref_cfg, ref_mesh(d),
                         _zero1_batches(d))
    assert shards == {"mono": 3, "resident": 3}
