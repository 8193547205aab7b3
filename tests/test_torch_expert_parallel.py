"""Expert parallelism (``mesh.expert_parallelism``) in the port against
the reference (≙ ``tests/test_moe.py``'s sharded cases): the port runs
in gloo worker processes on the CPU (``_torch_mp``, cases in
``_torch_ep_cases``), one launch of 4 processes and one of 8, from the
reference's params (converted) and numpy batches made from a seed.

* ``moe_ffn`` at EP 4, TP 2 × EP 2 and SP 2 × EP 2 (and SP 2 × TP 2 ×
  EP 2) against the reference's ``shard_map`` of its ``moe_ffn``:
  output, aux and the gradients of ``Σ out·ct + c·aux`` at ``rtol 1e-5,
  atol 1e-6`` (the reference test's own), loose and binding capacity,
  top-1 and top-2.
* The new collectives (``scatter_sum``, ``all_reduce_sum``) and the
  expert layer's two all-to-alls against ``shard_map`` of the
  reference's ``psum``/``all_to_all`` forms, values and gradients.
* One train step at the reference's grid ``(n, e, m, s)`` = (1,4,1,1),
  (2,2,1,1), (1,2,2,1), (2,1,2,1), (1,2,1,2), (1,2,2,2), and top-2 at
  (2,2,1,1), against the reference's dense one-device update at
  ``LOSS_TOL`` and ``assert_update_parity`` (≙ ``test_moe.py:212,455``);
  the replicated leaves' gradients (attention, router, norms,
  embeddings) bitwise equal on every model and expert rank.
* LAMB at (2, 2, 1, 1) over two steps against the reference's
  expert-parallel step (the trust ratios' norms over the expert group).
* The rank layout ``(P_r, m, s, e)`` and its groups.
* The Trainer at (2, 2, 1, 1): saves by steps, resume; its checkpoint's
  state bytes equal a one-process save of the same params; the EP
  checkpoint restored at expert parallelism 1 (``cross_world_restore``
  journaled); ``launch eval --single_device`` on it; ``launch serve
  --decode`` refusing the MoE run with the reference's message.
* In process: the N-replica ``vmap`` step of an MoE model against the
  reference's data-parallel step, the rule engine's expert specs
  against the reference engine's, ``shard_params``/``gather_params``
  over the expert axis, and the refusals (ZeRO-1 × EP, EP on a dense
  model, a wall-clock save cadence, the single-device evaluator's
  ``moe_num_groups``).
* ``launch train`` over two gloo processes at expert parallelism 2.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from conftest import LOSS_TOL, assert_update_parity, base_config
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.ops.moe import moe_ffn as ref_moe_ffn
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models.convert import params_to_reference
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_mp import run_world
from _torch_tp_cases import LR

E, D, FF = 4, 8, 16
# the reference test's own tolerances for a sharded moe_ffn against the
# dense one (test_moe.py:115-118)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_RTOL = 1e-6
# (name, (m, s, e), top_k, capacity factor, num_groups)
LAYERS = [("ep4", (1, 1, 4), 1, 4.0, 4),
          ("ep4_binding", (1, 1, 4), 1, 1.0, 4),
          ("ep4_top2", (1, 1, 4), 2, 2.0, 4),
          ("tp2_ep2", (2, 1, 2), 1, 4.0, 2),
          ("tp2_ep2_top2_binding", (2, 1, 2), 2, 1.0, 2),
          ("sp2_ep2", (1, 2, 2), 1, 1.0, 4),
          ("sp2_ep2_top2", (1, 2, 2), 2, 2.0, 4)]
LAYERS8 = [("tp2_sp2_ep2", (2, 2, 2), 2, 1.0, 4)]
# the reference's grid (test_moe.py:204-211): (n_replicas, e, m, s)
GRID4 = [(1, 4, 1, 1), (2, 2, 1, 1), (1, 2, 2, 1), (2, 1, 2, 1),
         (1, 2, 1, 2)]
GRID8 = [(1, 2, 2, 2)]
# leaves whole on every rank; the attention's too without TP
REPLICATED = ("blocks/0/ln1/scale", "blocks/0/ln2/scale", "blocks/0/router",
              "embed", "final_norm/scale", "pos")
ATTENTION = ("blocks/0/wqkv", "blocks/0/wo")


# -- the MoE layer ------------------------------------------------------------

def _layer_inputs(seed: int, dtype=np.float32) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(2, 8, D)).astype(dtype),
            "ct": rng.normal(size=(2, 8, D)).astype(dtype),
            "router": (rng.normal(size=(D, E)) * 0.5).astype(dtype),
            "w1": (rng.normal(size=(E, D, FF)) * 0.1).astype(dtype),
            "w2": (rng.normal(size=(E, FF, D)) * 0.1).astype(dtype),
            "c": 0.7}


def _layer_job(name, mesh, top_k, cf, groups, seed):
    return (name, {"case": "moe_layer", "mesh": mesh, "top_k": top_k,
                   "cf": cf, "num_groups": groups, "num_experts": E,
                   **_layer_inputs(seed)})


def _ref_layer(payload):
    """The reference's ``moe_ffn`` under ``shard_map`` on the payload's
    mesh: (out, aux, gradients of ``Σ out·ct + c·aux``)."""
    m, s, e = payload["mesh"]
    topo = ref_topology(RefMesh(num_replicas=1, model_parallelism=m,
                                seq_parallelism=s, expert_parallelism=e))
    e_ax = topo.expert_axis if e > 1 else None
    m_ax = topo.model_axis if m > 1 else None
    s_ax = topo.seq_axis if s > 1 else None
    xs = P(None, s_ax) if s_ax else P()

    def fn(x, router, w1, w2):
        return ref_moe_ffn(x, router, w1, w2, num_experts=E,
                           capacity_factor=payload["cf"],
                           router_top_k=payload["top_k"],
                           num_groups=payload["num_groups"],
                           expert_axis=e_ax, tp_axis=m_ax,
                           stats_axes=(s_ax,) if s_ax else ())

    sharded = jax.shard_map(
        fn, mesh=topo.mesh,
        in_specs=(xs, P(), P(e_ax, None, m_ax), P(e_ax, m_ax, None)),
        out_specs=(xs, P()))

    def objective(x, router, w1, w2):
        out, aux = sharded(x, router, w1, w2)
        return jnp.sum(out * payload["ct"]) + payload["c"] * aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2, 3), has_aux=True))(
            payload["x"], payload["router"], payload["w1"], payload["w2"])
    return (np.asarray(out), float(aux),
            dict(zip(("x", "router", "w1", "w2"), map(np.asarray, grads))))


def _assemble(outs, mesh):
    """The ranks' blocks and shards put back whole: the output and ``x``
    gradient along the sequence, the expert weights' gradients along
    experts and the hidden dim, each summed over the sequence blocks
    (every block's partial); the router's summed over the blocks."""
    m, s, e = mesh
    by = {o["coords"]: o for o in outs}
    out = np.concatenate([by[(0, 0, j, 0)]["out"] for j in range(s)], axis=1)
    gx = np.concatenate([by[(0, 0, j, 0)]["grads"]["x"] for j in range(s)],
                        axis=1)
    router = sum(by[(0, 0, j, 0)]["grads"]["router"] for j in range(s))
    w1 = np.concatenate([np.concatenate(
        [sum(by[(0, i, j, k)]["grads"]["w1"] for j in range(s))
         for i in range(m)], axis=2) for k in range(e)], axis=0)
    w2 = np.concatenate([np.concatenate(
        [sum(by[(0, i, j, k)]["grads"]["w2"] for j in range(s))
         for i in range(m)], axis=1) for k in range(e)], axis=0)
    return out, {"x": gx, "router": router, "w1": w1, "w2": w2}


@pytest.fixture(scope="module")
def ep4(tmp_path_factory):
    """The world-4 launch: the MoE layers, the collectives, the grid's
    4-process steps with top-2, the rank layout, the Trainer (after a
    one-process save of the same initial params for the bytes check)."""
    root = tmp_path_factory.mktemp("ep4")
    jobs = [_layer_job(*case, seed=n) for n, case in enumerate(LAYERS)]
    jobs.append(("collectives", {"case": "collective_ops",
                                 **_collective_inputs()}))
    for mesh in GRID4:
        d = _cfg(*mesh)
        jobs.append((f"step{mesh}", {"case": "step", "cfg": d,
                                     "params": _ref_params(d),
                                     "grads": True,
                                     "batches": [_tokens(d)]}))
    d2 = _cfg(2, 2, 1, 1, top_k=2)
    jobs.append(("step_top2", {"case": "step", "cfg": d2,
                               "params": _ref_params(d2),
                               "batches": [_tokens(d2)]}))
    dl = _cfg(2, 2, 1, 1)
    dl["optim"]["name"] = "lamb"
    jobs.append(("lamb", {"case": "step", "cfg": dl,
                          "params": _ref_params(dl),
                          "batches": [_tokens(dl, 0), _tokens(dl, 1)]}))
    jobs.append(("layout", {"case": "world_env",
                            "cfg": _cfg(1, 2, 1, 2)}))
    jobs.append(("trainer", {"case": "trainer",
                             "cfg": _trainer_cfg(root / "ep"),
                             "resume_steps": 6}))
    ds = _trainer_cfg(root / "ep_save")
    ds["train"]["max_steps"] = 0
    jobs.append(("save", {"case": "save_initial", "cfg": ds}))
    return run_world(root / "run", 4, jobs, cases="_torch_ep_cases"), root


@pytest.fixture(scope="module")
def ep8(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep8")
    jobs = [_layer_job(*case, seed=20 + n) for n, case in enumerate(LAYERS8)]
    for mesh in GRID8:
        d = _cfg(*mesh)
        jobs.append((f"step{mesh}", {"case": "step", "cfg": d,
                                     "params": _ref_params(d),
                                     "grads": True,
                                     "batches": [_tokens(d)]}))
    return run_world(root / "run", 8, jobs, timeout_s=300,
                     cases="_torch_ep_cases")


def _by_rank(res, name):
    return [r[name] for r in res]


def _check_layer(outs, payload):
    want_out, want_aux, want_grads = _ref_layer(payload)
    got_out, got_grads = _assemble(outs, payload["mesh"])
    # every model and expert rank of a sequence block holds the same
    # output block and the same x and router gradients
    first = {o["coords"][2]: o for o in outs if o["coords"][1::2] == (0, 0)}
    for o in outs:
        ref = first[o["coords"][2]]
        np.testing.assert_array_equal(o["out"], ref["out"])
        for name in ("x", "router"):
            np.testing.assert_array_equal(o["grads"][name],
                                          ref["grads"][name])
    np.testing.assert_allclose(got_out, want_out, **LAYER_TOL)
    for o in outs:
        np.testing.assert_allclose(o["aux"], want_aux, rtol=AUX_RTOL)
        assert o["aux_dtype"] == "torch.float32"
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name], g, **LAYER_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_moe_layer_matches_the_reference_shard_map(ep4, n):
    res, _ = ep4
    name, *case = LAYERS[n]
    _check_layer(_by_rank(res, name), _layer_job(name, *case, seed=n)[1])


def test_moe_layer_tp_sp_ep_matches_the_reference_shard_map(ep8):
    name, *case = LAYERS8[0]
    _check_layer(_by_rank(ep8, name), _layer_job(name, *case, seed=20)[1])


def test_binding_capacity_drops_tokens_in_the_ep_cases():
    """The ``_binding`` cases drop slots (else they would test nothing
    more than the loose ones): the dense reference on their inputs
    differs from its own output at a capacity every token fits in."""
    for n, (name, _, top_k, cf, groups) in enumerate(LAYERS + LAYERS8):
        if "binding" not in name:
            continue
        p = _layer_inputs(n)
        outs = [np.asarray(ref_moe_ffn(
            p["x"], p["router"], p["w1"], p["w2"], num_experts=E,
            capacity_factor=c, router_top_k=top_k, num_groups=groups)[0])
            for c in (cf, float(E))]
        assert np.abs(outs[0] - outs[1]).max() > 1e-3, name


# -- the collectives ----------------------------------------------------------

def _collective_inputs() -> dict:
    rng = np.random.default_rng(7)
    return {"x": rng.normal(size=(2, 12, 3)).astype(np.float32),
            "ct": rng.normal(size=(2, 12, 3)).astype(np.float32),
            "v": rng.normal(size=(4, 5)).astype(np.float32),
            "c": rng.normal(size=4).astype(np.float32),
            "a": rng.normal(size=(4, 3, 4, 2, 5)).astype(np.float32),
            "ct_a": rng.normal(size=(4, 3, 1, 8, 5)).astype(np.float32)}


def test_collectives_match_shard_map(ep4):
    """``scatter_sum`` ≙ ``psum(dynamic_update_slice(zeros, x, r·w))``
    to a replicated value (its transpose: this rank's block of the
    cotangent); ``all_reduce_sum`` ≙ a ``psum`` whose replicated result
    scales each rank's own term (its transpose: the cotangents summed);
    the expert layer's ``all_to_all`` ``(1, 2)`` and back ``(2, 1)`` ≙
    ``lax.all_to_all(x, axis, 1, 2, tiled=True)``."""
    res, _ = ep4
    p = _collective_inputs()
    topo = ref_topology(RefMesh(num_replicas=1, expert_parallelism=4))
    ax, mesh = topo.expert_axis, topo.mesh

    def scat(x):
        r = jax.lax.axis_index(ax)
        z = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros((2, 12, 3), x.dtype), x, r * 3, axis=1)
        return jax.lax.psum(z, ax)
    f = jax.shard_map(scat, mesh=mesh, in_specs=P(None, ax), out_specs=P())
    want = f(p["x"])
    want_g = jax.grad(lambda x: jnp.sum(f(x) * p["ct"]))(p["x"])

    def red(v, c):
        return jax.lax.psum(v, ax) * c[0]
    g = jax.shard_map(red, mesh=mesh, in_specs=(P(ax), P(ax)),
                      out_specs=P(ax))
    want_red = np.asarray(p["v"]).sum(0)
    want_red_g = jax.grad(lambda v: jnp.sum(g(v, p["c"])))(p["v"])

    def a2a(a):
        return jax.lax.all_to_all(a[0], ax, 1, 2, tiled=True)[None]
    h = jax.shard_map(a2a, mesh=mesh, in_specs=P(ax), out_specs=P(ax))
    want_a = np.asarray(h(p["a"]))
    want_a_g = jax.grad(lambda a: jnp.sum(h(a) * p["ct_a"]))(p["a"])
    for r, o in enumerate(_by_rank(res, "collectives")):
        np.testing.assert_allclose(o["scatter"], np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(o["scatter_grad"],
                                      np.asarray(want_g)[:, 3 * r:3 * r + 3])
        np.testing.assert_allclose(o["reduce"], want_red, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(o["reduce_grad"],
                                   np.asarray(want_red_g)[r], rtol=1e-6)
        np.testing.assert_array_equal(o["dispatch"], want_a[r])
        np.testing.assert_array_equal(o["back"], p["a"][r])
        np.testing.assert_array_equal(o["dispatch_grad"],
                                      np.asarray(want_a_g)[r])


# -- the train step -----------------------------------------------------------

def _cfg(n, e, m, s, top_k=1) -> dict:
    """The reference test's MoE transformer (``test_moe.py _cfg``): seq
    16, d 16, 2 heads, 2 layers, vocab 31, dense attention, float32, 4
    experts at capacity factor 4 in 4 groups a row, batch 4 a replica,
    sync, no stragglers."""
    return {"data": {"dataset": "synthetic_lm", "batch_size": 4 * n,
                     "synthetic_train_size": 256, "synthetic_test_size": 32,
                     "use_native_pipeline": False},
            "model": {"name": "transformer", "compute_dtype": "float32",
                      "seq_len": 16, "model_dim": 16, "num_heads": 2,
                      "num_layers": 2, "vocab_size": 31,
                      "attention_impl": "dense", "num_experts": 4,
                      "expert_capacity_factor": 4.0, "moe_num_groups": 4,
                      "moe_router_top_k": top_k},
            "sync": {"mode": "sync", "straggler_profile": "none"},
            "mesh": {"num_replicas": n, "model_parallelism": m,
                     "seq_parallelism": s, "expert_parallelism": e},
            "optim": {"initial_learning_rate": LR,
                      "learning_rate_decay_factor": 1.0},
            "train": {"max_steps": 10, "log_every_steps": 5,
                      "save_interval_steps": 0, "save_results_period": 0}}


def _ref_cfg(d: dict):
    d = {k: v for k, v in d.items() if k not in ("mesh", "optim")}
    return base_config(**copy.deepcopy(d))


def _ref_params(d: dict):
    cfg = _ref_cfg(d)
    params = ref_get_model(cfg.model).init(
        jax.random.PRNGKey(cfg.model.init_seed))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _tokens(d: dict, seed: int = 0) -> dict:
    b, s = d["data"]["batch_size"], d["model"]["seq_len"]
    toks = np.random.default_rng(seed).integers(
        0, d["model"]["vocab_size"], (b, s)).astype(np.int32)
    return {"image": toks, "label": toks.copy()}


def _dense_update(d: dict, batch: dict):
    """The reference's dense one-device MoE update (≙ ``test_moe.py
    _dense_moe_update``): loss + aux_weight·aux, one SGD step."""
    cfg = _ref_cfg(d)
    params = _ref_params(d)

    def loss_fn(p):
        logits, aux = ref_transformer.apply(
            p, batch["image"], num_heads=cfg.model.num_heads,
            compute_dtype=jnp.float32, num_experts=cfg.model.num_experts,
            capacity_factor=cfg.model.expert_capacity_factor,
            moe_num_groups=cfg.model.moe_num_groups,
            moe_router_top_k=cfg.model.moe_router_top_k, return_aux=True)
        return (ref_transformer.loss_fn(logits, batch["label"])
                + cfg.model.moe_aux_weight * aux)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree.map(lambda p, g: p - LR * g, params, grads)


def _check_step(outs, d, batch):
    want_loss, want = _dense_update(d, batch)
    for out in outs:
        np.testing.assert_allclose(out["losses"][0], want_loss, **LOSS_TOL)
        assert_update_parity(out["params"], want)


def _check_replicated_grads(outs, m):
    """Every model and expert rank of one (replica-process, seq block)
    holds the same replicated-leaf gradients, bit for bit."""
    groups: dict = {}
    for out in outs:
        p, _, j, _ = out["coords"]
        groups.setdefault((p, j), []).append(out["replicated_grads"])
    for grads in groups.values():
        assert set(REPLICATED + (ATTENTION if m == 1 else ())) <= set(
            grads[0])
        for other in grads[1:]:
            for name, g in grads[0].items():
                np.testing.assert_array_equal(other[name], g, err_msg=name)


@pytest.mark.parametrize("mesh", GRID4, ids=str)
def test_ep_step_matches_the_dense_update(ep4, mesh):
    res, _ = ep4
    d = _cfg(*mesh)
    outs = _by_rank(res, f"step{mesh}")
    _check_step(outs, d, _tokens(d))
    _check_replicated_grads(outs, mesh[2])


def test_tp_sp_ep_step_matches_the_dense_update(ep8):
    d = _cfg(*GRID8[0])
    outs = _by_rank(ep8, f"step{GRID8[0]}")
    _check_step(outs, d, _tokens(d))
    _check_replicated_grads(outs, GRID8[0][2])


def test_top2_step_at_dp2_ep2_matches_the_dense_update(ep4):
    res, _ = ep4
    d = _cfg(2, 2, 1, 1, top_k=2)
    _check_step(_by_rank(res, "step_top2"), d, _tokens(d))


def test_lamb_at_dp2_ep2_matches_the_reference(ep4):
    """LAMB over two steps at (2, 2, 1, 1): each expert leaf's sum of
    squares completes over the expert group (the trust ratios), against
    the reference's own expert-parallel step."""
    res, _ = ep4
    d = _cfg(2, 2, 1, 1)
    cfg = _ref_cfg(d).override({"optim.name": "lamb"})
    topo = ref_topology(RefMesh(num_replicas=2, expert_parallelism=2))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg), specs)
    fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    losses = []
    for seed in (0, 1):
        state, m = fn(state, topo.device_put_batch(_tokens(d, seed)))
        losses.append(float(m["loss"]))
    for out in _by_rank(res, "lamb"):
        np.testing.assert_allclose(out["losses"], losses, **LOSS_TOL)
        assert_update_parity(out["params"], jax.device_get(state.params))


def test_rank_layout_is_replica_model_seq_expert(ep4):
    """At (n 1, e 2, m 1, s 2) rank ``j·2 + k`` holds sequence block
    ``j`` and expert shard ``k``: the expert groups are {0, 1} and {2,
    3}, the seq groups {0, 2} and {1, 3}; without tensor parallelism the
    expert×model group is the expert group."""
    res, _ = ep4
    for rank, r in enumerate(_by_rank(res, "layout")):
        assert r["rank"] == rank
        assert r["coords"] == (0, 0, rank // 2, rank % 2)
        pair = [rank // 2 * 2, rank // 2 * 2 + 1]
        assert r["members"] == {"replica_group": [rank],
                                "model_group": None,
                                "seq_group": [rank % 2, rank % 2 + 2],
                                "expert_group": pair,
                                "expert_model_group": pair}


def test_n_replica_vmap_step_matches_the_reference():
    """Two replicas in one process, one ``vmap(grad)`` over them (the
    MoE routing's one-hots are comparisons, so it vmaps), against the
    reference's data-parallel step on two devices."""
    from distributedmnist_tpu_torch.core.mesh import make_topology
    from _torch_ep_cases import step
    for top_k in (1, 2):
        d = _cfg(2, 1, 1, 1, top_k=top_k)
        params = _ref_params(d)
        batch = _tokens(d)
        cfg = ExperimentConfig.from_dict(d)
        assert make_topology(cfg.mesh).local_replica_count == 2
        got = step({"cfg": d, "params": params, "batches": [batch]})
        rcfg = _ref_cfg(d)
        topo = ref_topology(RefMesh(num_replicas=2))
        model = ref_get_model(rcfg.model)
        state = topo.device_put_replicated(
            ref_api.init_train_state(model, rcfg))
        fn = ref_api.build_train_step(model, rcfg, topo, ref_constant(LR))
        state, m = fn(state, topo.device_put_batch(batch))
        np.testing.assert_allclose(got["losses"][0], float(m["loss"]),
                                   **LOSS_TOL)
        assert_update_parity(got["params"], jax.device_get(state.params))


# -- the Trainer, checkpoints and the entry points ----------------------------

def _trainer_cfg(train_dir) -> dict:
    d = _cfg(2, 2, 1, 1)
    d["train"].update(max_steps=4, train_dir=str(train_dir),
                      log_every_steps=2, save_interval_secs=0,
                      save_interval_steps=2)
    return d


def test_trainer_on_an_expert_axis(ep4):
    res, _ = ep4
    outs = _by_rank(res, "trainer")
    assert [o["is_writer"] for o in outs] == [True, False, False, False]
    for out in outs:
        assert out["final_step"] == 4
        assert np.isfinite(out["last"]["loss"])
        assert np.isfinite(out["eval"]["loss"])
        assert out["resumed_start"] == 4 and out["resumed_final"] == 6
        assert out["digest"] == outs[0]["digest"]
        assert out["resumed_digest"] == outs[0]["resumed_digest"]
        assert out["eval"] == {**outs[0]["eval"],
                               "seconds": out["eval"]["seconds"]}
    assert {o["coords"] for o in outs} == {(p, 0, 0, k) for p in range(2)
                                           for k in range(2)}


def test_ep_checkpoint_bytes_equal_a_one_process_save(ep4, tmp_path):
    """Rank 0 of a (2, 2, 1, 1) run saves whole leaves: its state
    section is byte for byte a one-process run's save of the same
    initial params."""
    _, root = ep4
    one = _trainer_cfg(tmp_path / "one")
    one["mesh"] = {"num_replicas": 2}
    one["train"]["max_steps"] = 0
    Trainer(ExperimentConfig.from_dict(one), device="cpu").run()
    payloads = [ckpt._read_payload(ckpt._ckpt_path(path, 0))
                for path in (root / "ep_save", tmp_path / "one")]
    ep_bytes, one_bytes = (ckpt.msgpack_serialize(p["state"])
                           for p in payloads)
    assert ep_bytes == one_bytes
    worlds = [json.loads(p["extra"])["world"] for p in payloads]
    assert worlds == [{"num_replicas": 2, "process_count": 4,
                       "mesh": {"replica": 2, "expert": 2}},
                      {"num_replicas": 2, "process_count": 1,
                       "mesh": {"replica": 2}}]


def test_ep_checkpoint_restores_at_expert_parallelism_1(ep4, tmp_path):
    import shutil
    from distributedmnist_tpu_torch.evalsvc.evaluator import Evaluator
    res, root = ep4
    shutil.copytree(root / "ep", tmp_path / "ep")
    d = _trainer_cfg(tmp_path / "ep")
    d["mesh"] = {"num_replicas": 2}
    d["train"].update(resume=True, max_steps=6)
    t = Trainer(ExperimentConfig.from_dict(d), device="cpu")
    assert t._start_step == 6
    saved, _, _ = ckpt.restore_state(tmp_path / "ep")
    for a, b in zip(jax.tree.leaves(params_to_reference(t.state.params)),
                    jax.tree.leaves(saved["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(_by_rank(res, "trainer")[0]
                                    ["resumed_params"]),
                    jax.tree.leaves(saved["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    ev = [json.loads(x) for x in (tmp_path / "ep" / "recovery_journal.jsonl")
          .read_text().splitlines()]
    ev = [r for r in ev if r.get("action") == "cross_world_restore"]
    assert ev[-1]["saved_world"]["mesh"] == {"replica": 2, "expert": 2}
    assert ev[-1]["new_world"]["mesh"] == {"replica": 2}
    # launch eval --single_device on the EP run's checkpoint: the
    # one-process Trainer's eval of the same params
    got = Evaluator(tmp_path / "ep", single_device=True,
                    device="cpu").evaluate_checkpoint()
    want = t.evaluate("test")
    assert got["step"] == 6 and got["num_examples"] == want["num_examples"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["precision_at_1"] == want["accuracy"]


def test_serve_decode_refuses_the_moe_run(ep4, tmp_path):
    """``launch serve --decode`` on the EP run's checkpoint: the MoE
    transformer exports no decode step, the reference's message."""
    from distributedmnist_tpu_torch.core.config import ConfigError
    from distributedmnist_tpu_torch.launch.__main__ import build_replica
    _, root = ep4
    with pytest.raises(ConfigError) as got:
        build_replica(["serve", "--decode", "--train-dir", str(root / "ep"),
                       "--serve-dir", str(tmp_path / "serve"),
                       "--device", "cpu"])
    assert str(got.value) == (
        "model 'transformer' exports no decode step (decode needs a "
        "dense-FFN causal LM; MoE and classifier families have no "
        "incremental export)")


def test_single_device_eval_refuses_auto_groups_on_an_ep_run(tmp_path):
    from distributedmnist_tpu_torch.evalsvc.evaluator import Evaluator
    d = _cfg(1, 2, 1, 1)
    d["model"]["moe_num_groups"] = 0
    with pytest.raises(ValueError, match="explicit model.moe_num_groups"):
        Evaluator(tmp_path, cfg=ExperimentConfig.from_dict(d),
                  single_device=True, device="cpu")


def test_launch_train_at_expert_parallelism_2(tmp_path):
    """``launch train --device cpu --dist-backend gloo`` in two processes
    at ``mesh.expert_parallelism=2`` on a MoE transformer: each trains
    its experts, evaluates, and prints the reference's last line with
    the same digest."""
    logs = run_world(tmp_path / "cli", 2, [], argv=[
        "-m", "distributedmnist_tpu_torch.launch", "train",
        "--config", "configs/synthetic_lm_transformer.json",
        "mesh.num_replicas=1", "mesh.expert_parallelism=2",
        "model.num_experts=4", "model.moe_num_groups=2",
        "model.moe_router_top_k=2",
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

@pytest.mark.parametrize("axes", [(None, "expert"), ("model", "expert"),
                                  ("model", None)], ids=str)
def test_expert_partition_rules_match_the_reference(axes):
    """The MoE transformer's table through the port's engine gives the
    reference engine's spec for every leaf, with the expert and model
    axes bound as the meshes above bind them."""
    from distributedmnist_tpu.models.registry import \
        transformer_partition_rules as ref_rules
    from distributedmnist_tpu.parallel.partition_rules import (
        RuleAxes as RefAxes, match_partition_rules as ref_match)
    from distributedmnist_tpu_torch.models.registry import \
        transformer_partition_rules
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        RuleAxes, match_partition_rules, spec_leaves)
    model, expert = axes
    params = _ref_params(_cfg(1, 1, 1, 1))
    want = jax.tree.leaves(
        ref_match(ref_rules(4)(RefAxes(model=model, expert=expert)), params),
        is_leaf=lambda x: isinstance(x, P))
    got = spec_leaves(match_partition_rules(
        transformer_partition_rules(4)(RuleAxes(model=model, expert=expert)),
        params))
    assert got == [tuple(w) for w in want]
    assert ("expert" if expert else None, None, model) in got


def test_shard_and_gather_params_over_the_expert_axis():
    """``shard_params`` over the expert axis then the model axis cuts
    each expert leaf to its experts and hidden slice (the router, the
    attention and the norms whole); ``gather_params`` puts it back."""
    from distributedmnist_tpu_torch.models.convert import (gather_params,
                                                           shard_params)
    from distributedmnist_tpu_torch.models.registry import \
        transformer_partition_rules
    from distributedmnist_tpu_torch.parallel.partition_rules import RuleAxes
    params = _ref_params(_cfg(1, 1, 1, 1))
    rules = transformer_partition_rules(4)(RuleAxes(model="model",
                                                    expert="expert"))
    blk = params["blocks"][0]
    shards = {(k, i): shard_params(shard_params(params, rules, k, 2,
                                                axis="expert"),
                                   rules, i, 2)
              for k in range(2) for i in range(2)}
    for (k, i), sh in shards.items():
        b = sh["blocks"][0]
        np.testing.assert_array_equal(
            b["w1"], blk["w1"][2 * k:2 * k + 2, :, 32 * i:32 * i + 32])
        np.testing.assert_array_equal(
            b["w2"], blk["w2"][2 * k:2 * k + 2, 32 * i:32 * i + 32])
        np.testing.assert_array_equal(b["router"], blk["router"])
        np.testing.assert_array_equal(b["wo"], blk["wo"][8 * i:8 * i + 8])
    back = gather_params([gather_params([shards[(k, i)] for i in range(2)],
                                        rules) for k in range(2)],
                         rules, axis="expert")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_zero1_under_expert_parallelism_is_refused():
    from distributedmnist_tpu_torch.core.config import ConfigError
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    d = _cfg(2, 2, 1, 1)
    d["parallel"] = {"shard_weight_update": True}
    cfg = ExperimentConfig.from_dict(d)
    with pytest.raises(ConfigError, match="item 8d"):
        api.build_train_step(get_model(cfg.model), cfg,
                             lr_schedule.constant(LR))


def test_expert_axis_needs_experts_and_torchrun():
    """A dense model on an expert axis is refused with the reference's
    message (also one with an aux loss: what counts is its expert
    leaves), and so is an expert axis on one process (the ConfigError
    naming ``torchrun``), before any process group."""
    from distributedmnist_tpu_torch.core.config import ConfigError
    from distributedmnist_tpu_torch.core.mesh import Topology
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    d = _cfg(1, 2, 1, 1)
    cfg = ExperimentConfig.from_dict(d)
    with pytest.raises(ConfigError, match="torchrun"):
        api.build_train_step(get_model(cfg.model), cfg,
                             lr_schedule.constant(LR))
    d["model"]["num_experts"] = 0
    dense = get_model(ExperimentConfig.from_dict(d).model)
    topo = Topology(num_replicas=1, expert_parallelism=2, distributed=True)
    meta = dense.init_params(0, "meta")
    for model in (dense, dataclasses.replace(dense, has_aux=True)):
        with pytest.raises(ValueError, match="no experts to shard"):
            api.tp_specs(model, topo, meta)


def test_time_based_saves_under_expert_parallelism_are_refused(tmp_path):
    d = _cfg(1, 2, 1, 1)
    d["train"].update(save_interval_secs=5.0, train_dir=str(tmp_path))
    with pytest.raises(ValueError, match="save_interval_steps"):
        Trainer(ExperimentConfig.from_dict(d), device="cpu")
