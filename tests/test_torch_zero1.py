"""The port's ZeRO-1 weight update (``parallel/partition_rules.py``,
``parallel/api.py``, ``core/mesh.py``) against the reference's
(``parallel.shard_weight_update``, ``comm_buckets``,
``resident_sharded``, ``shard_min_leaf_size``).

* The plan and the communication buckets equal the reference's leaf by
  leaf, for the CNN, ResNet-20 and a small transformer; the host-side
  pack and unpack equal the reference's, a foreign world's padding
  included, and refuse a non-zero tail alike.
* On one process the port's ZeRO-1 is bitwise its replicated update —
  monolithic, bucketed and resident — under sgd, momentum, LARS and
  LAMB: the reduce-scatter is the same left-to-right sum over the local
  replicas as the replicated all-reduce, and every chunk is local, so
  the updates see the same elements. (The reference's own resident
  layout is not bitwise against its replicated one here:
  ``tests/test_zero1.py::test_resident_sharded_bitwise_and_param_memory``
  fails by 7.45e-9 on 2 of 32 elements with this JAX.)
* Against the reference's ZeRO-1 run of the same config, two momentum
  steps: each param leaf within 1e-6 of its norm (XLA contracts
  multiply-adds into FMAs and sums in its own order).
* An all-masked step (timeout 0) is a bitwise no-op under all four
  optimizers; interval mode falls back to the replicated update with
  the reference's log line.
* Two gloo processes (8 replicas, 4 each, each process fed its rows of
  the global batch) against the one-process run: momentum (replicated
  and resident params) after 3 steps within 3e-7 of each leaf's norm
  (the collectives sum in another order); LAMB after 1 step within
  1e-5: its update ``m̂/(sqrt(v̂) + eps)`` is sign-like where a summed
  gradient is near ``eps``, so the reassociated sums move whole
  elements (measured 1.0e-6 here, on the CNN's fc1 bias). LAMB's 3-step
  gap is printed, not gated. Each rank holds half of the sharded slots' bytes
  plus the fallback leaves.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributedmnist_tpu.core.config import ModelConfig as RefModelConfig
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import partition_rules as ref_pr
from distributedmnist_tpu_torch.core.config import ModelConfig
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import partition_rules as pr

from _torch_dp import (canonical, cfg_dict, batches, leaves_np, port_steps,
                       ref_steps, within_norm)
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_distributed import _start, _wait

MODELS = {
    "mnist_cnn": {"name": "mnist_cnn"},
    "resnet20": {"name": "resnet20", "image_size": 32, "num_channels": 3},
    "transformer": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                    "num_heads": 2, "num_layers": 2, "vocab_size": 16},
}
MOMENTUM = {"name": "momentum", "momentum": 0.9}
OPTIMS = {"sgd": {"name": "sgd"}, "momentum": MOMENTUM,
          "lars": {"name": "lars", "weight_decay": 1e-3},
          "lamb": {"name": "lamb", "weight_decay": 1e-3}}
KNOBS = {"monolithic": {"shard_weight_update": True},
         "bucketed": {"shard_weight_update": True, "comm_buckets": 3},
         "resident": {"shard_weight_update": True, "comm_buckets": 4,
                      "resident_sharded": True}}
QUORUM = {"mode": "quorum", "num_replicas_to_aggregate": 5,
          "straggler_profile": "lognormal"}


def _plan_rows(leaf_plans, is_ref: bool) -> list:
    lps = (jax.tree.leaves(leaf_plans,
                           is_leaf=lambda x: isinstance(x, ref_pr.LeafShardPlan))
           if is_ref else pr.tree_leaves(leaf_plans))
    return [(lp.sharded, lp.size, lp.pad, lp.chunk, tuple(lp.shape))
            for lp in lps]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("model", list(MODELS))
def test_plan_and_buckets_match_reference(model, n):
    kw = MODELS[model]
    ref_params = jax.eval_shape(lambda: ref_get_model(
        RefModelConfig(**kw)).init(jax.random.PRNGKey(0)))
    port_params = get_model(ModelConfig(**kw)).init_params(
        0, torch.device("meta"))
    specs = jax.tree.map(lambda _: P(), ref_params)
    for buckets in (1, 3, 4):
        for floor in (0, 1000):
            rp = ref_pr.make_zero1_plan(ref_params, specs, "replica", n,
                                        min_leaf_size=floor,
                                        comm_buckets=buckets)
            pp = pr.make_zero1_plan(port_params, None, n,
                                    min_leaf_size=floor,
                                    comm_buckets=buckets)
            assert _plan_rows(pp.leaf_plans, False) == _plan_rows(
                rp.leaf_plans, True), (buckets, floor)
            assert pr.comm_bucket_assignment(pp) == \
                ref_pr.comm_bucket_assignment(rp), (buckets, floor)
            assert pp.any_sharded == rp.any_sharded


def test_pack_unpack_match_reference():
    """Logical → [pad] → logical equals the reference's both ways; a
    leaf packed for another replica count (5) re-pads exactly; a
    non-zero tail and a wrong shape are refused alike."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32)],
            "c": rng.normal(size=(2,)).astype(np.float32)}
    specs = jax.tree.map(lambda _: P(), tree)
    rp = ref_pr.make_zero1_plan(tree, specs, "replica", 4)
    pp = pr.make_zero1_plan(tree, None, 4)
    packed = pr.zero1_pack(tree, pp)
    want = ref_pr.zero1_pack(tree, rp)
    for a, b in zip(jax.tree.leaves(packed), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert packed["a"].shape == (24,) and packed["c"].shape == (2,)
    for a, b in zip(jax.tree.leaves(pr.zero1_unpack(packed, pp)),
                    jax.tree.leaves(ref_pr.zero1_unpack(want, rp))):
        np.testing.assert_array_equal(a, b)
    foreign = ref_pr.zero1_pack(tree, ref_pr.make_zero1_plan(
        tree, specs, "replica", 5))
    assert foreign["a"].shape == (25,)
    for a, b in zip(jax.tree.leaves(pr.zero1_pack(foreign, pp)),
                    jax.tree.leaves(ref_pr.zero1_pack(foreign, rp))):
        np.testing.assert_array_equal(a, b)
    torn = dict(foreign, a=foreign["a"].copy())
    torn["a"][-1] = 1.0
    for pack, plan in ((pr.zero1_pack, pp), (ref_pr.zero1_pack, rp)):
        with pytest.raises(ValueError, match="non-zero data"):
            pack(torn, plan)
        with pytest.raises(ValueError, match="cannot pack"):
            pack(dict(tree, a=np.zeros((4, 4), np.float32)), plan)


@pytest.fixture(scope="module")
def feed():
    return batches(3)


@pytest.mark.parametrize("mode", ["sync", "quorum"])
@pytest.mark.parametrize("optim", list(OPTIMS))
def test_one_process_bitwise_with_replicated(feed, optim, mode):
    sync = {"mode": "sync"} if mode == "sync" else QUORUM
    base = cfg_dict(optim=OPTIMS[optim], sync=sync)
    st_r, hist_r, _ = port_steps(base, feed)
    want_p, want_s = canonical(st_r, None)
    for knob, par in KNOBS.items():
        st, hist, step_fn = port_steps(cfg_dict(optim=OPTIMS[optim],
                                                sync=sync, parallel=par),
                                       feed)
        plan = step_fn.plan
        assert plan is not None and plan.any_sharded, knob
        # the live layout: sharded slots flat [pad]; params too when
        # resident
        lps = plan.leaves()
        slots = api_leaves(st.momentum)
        for i, lp in enumerate(lps * (len(slots) // len(lps))):
            assert tuple(slots[i].shape) == ((lp.pad,) if lp.sharded
                                             else lp.shape), knob
        for x, lp in zip(api_leaves(st.params), lps):
            assert tuple(x.shape) == ((lp.pad,) if lp.sharded
                                      and plan.params_sharded
                                      else lp.shape), knob
        got_p, got_s = canonical(st, plan)
        for a, b in zip(got_p + got_s, want_p + want_s):
            np.testing.assert_array_equal(a, b, err_msg=knob)
        for m, w in zip(hist, hist_r):
            assert float(m["loss"]) == float(w["loss"]), knob
            np.testing.assert_array_equal(m["flags"], w["flags"])


def api_leaves(tree):
    from distributedmnist_tpu_torch.parallel.api import tree_leaves
    return tree_leaves(tree)


def test_matches_reference_zero1_run(topo8, feed):
    """Two momentum steps of the reference's bucketed ZeRO-1 and the
    port's from the same init (the CNN's init is bitwise the
    reference's): params and slots within 1e-6 of each leaf's norm."""
    d = cfg_dict(optim=MOMENTUM, parallel=KNOBS["bucketed"])
    ref, ref_hist, rcfg = ref_steps(topo8, d, feed[:2])
    st, hist, step_fn = port_steps(d, feed[:2])
    got_p, got_s = canonical(st, step_fn.plan)
    from distributedmnist_tpu.parallel.api import (canonical_save_state,
                                                   zero1_plan_for)
    plan = zero1_plan_for(ref_get_model(rcfg.model), rcfg, topo8)
    ref = canonical_save_state(ref, plan)
    within_norm(got_p, jax.tree.leaves(ref.params), 1e-6)
    within_norm(got_s, jax.tree.leaves(ref.momentum), 1e-6)
    for m, w in zip(hist, ref_hist):
        np.testing.assert_allclose(float(m["loss"]), float(w["loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("optim", list(OPTIMS))
def test_all_masked_step_is_bitwise_noop(feed, optim):
    """timeout 0 masks every replica: params and every slot unchanged,
    bit for bit, in the monolithic and the resident layouts."""
    for par in (KNOBS["monolithic"], KNOBS["resident"]):
        d = cfg_dict(optim=OPTIMS[optim], parallel=par,
                     sync={"mode": "timeout", "timeout_ms": 0.0})
        st0, _, _ = port_steps(cfg_dict(optim=OPTIMS[optim], parallel=par,
                                        sync={"mode": "sync"}), feed[:1])
        before = [x.clone() for x in api_leaves((st0.params, st0.momentum))]
        from distributedmnist_tpu_torch.core.config import ExperimentConfig
        from distributedmnist_tpu_torch.parallel import api
        from distributedmnist_tpu_torch.train import lr_schedule
        cfg = ExperimentConfig.from_dict(d)
        step_fn = api.build_train_step(get_model(cfg.model), cfg,
                                       lr_schedule.constant(0.05))
        st, m = step_fn(st0, {k: torch.from_numpy(v)
                              for k, v in feed[1].items()})
        assert m["num_contributors"] == 0.0 and m["applied"] == 0
        assert st.updates_applied == 1
        for a, b in zip(api_leaves((st.params, st.momentum)), before):
            assert torch.equal(a, b)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_interval_falls_back_to_replicated(feed):
    d = cfg_dict(optim=MOMENTUM, parallel=KNOBS["bucketed"],
                 sync={"mode": "interval", "interval_ms": 100.0,
                       "straggler_profile": "lognormal"})
    log = logging.getLogger("distributedmnist_tpu_torch.parallel")
    seen = _Records()
    log.addHandler(seen)
    try:
        st, hist, step_fn = port_steps(d, feed)
    finally:
        log.removeHandler(seen)
    assert step_fn.plan is None
    assert any("shard_weight_update=true is a no-op here" in m
               and "windowed accumulator" in m for m in seen.messages)
    want, _, _ = port_steps(cfg_dict(optim=MOMENTUM, sync=d["sync"]), feed)
    for a, b in zip(leaves_np(st.momentum), leaves_np(want.momentum)):
        np.testing.assert_array_equal(a, b)  # logical shapes, same values


# -- over two gloo processes -------------------------------------------------

_ZCHILD = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from distributedmnist_tpu_torch.core.mesh import (
    initialize_distributed, make_topology, shutdown_distributed)
assert initialize_distributed("gloo", "cpu", timeout_s=60)
rank, out = int(os.environ["RANK"]), os.environ["DMT_OUT"]
try:
    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.models.convert import params_to_reference
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    spec = json.loads(os.environ["DMT_CFG"])
    feed = np.load(f"{out}/feed.npz")
    res = {}
    for name, d in spec.items():
        cfg = ExperimentConfig.from_dict(d)
        model = get_model(cfg.model)
        topo = make_topology(cfg.mesh)
        state = api.init_train_state(model, cfg, torch.device("cpu"), topo)
        step_fn = api.build_train_step(model, cfg, lr_schedule.constant(
            cfg.optim.initial_learning_rate), topo)
        B = feed["image"].shape[1]
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        slot_bytes = sum(x.numel() * x.element_size()
                         for x in api.tree_leaves(state.momentum))
        for s in range(feed["image"].shape[0]):
            state, m = step_fn(state, {
                k: torch.from_numpy(feed[k][s, rows].copy())
                for k in ("image", "label")})
            logical = api.logical_params(state.params, step_fn.plan, topo)
            np.savez(f"{out}/{name}_{rank}_{s}.npz", *[
                np.asarray(x) for x in api.tree_leaves(
                    params_to_reference(logical))])
        res[name] = {"slot_bytes": slot_bytes, "loss": float(m["loss"]),
                     "first": topo.first_replica,
                     "local": topo.local_replica_count}
    json.dump(res, open(f"{out}/result{rank}.json", "w"))
finally:
    shutdown_distributed()
"""

DIST_STEPS = 3
# LAMB after one step over processes, per leaf: its sign-like update
# near |g| ≈ eps turns the collectives' reassociation into whole-element
# moves (measured 1.0e-6 on the CPU, 3.9e-6 on an H100 in chip_smoke)
LAMB_DIST_TOL = 1e-5


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory, feed):
    out = tmp_path_factory.mktemp("zero1_dist")
    np.savez(out / "feed.npz",
             image=np.stack([b["image"] for b in feed[:DIST_STEPS]]),
             label=np.stack([b["label"] for b in feed[:DIST_STEPS]]))
    spec = {name: cfg_dict(optim=OPTIMS[name], parallel=KNOBS["bucketed"])
            for name in ("momentum", "lamb")}
    spec["resident"] = cfg_dict(optim=MOMENTUM, parallel=KNOBS["resident"])
    procs = _start(out, spec, argv=["-c", _ZCHILD])
    ranks = _wait(out, procs)
    return out, spec, ranks


def _dist_leaves(out, name, rank, step):
    z = np.load(out / f"{name}_{rank}_{step}.npz")
    return [z[f"arr_{i}"] for i in range(len(z.files))]


@pytest.mark.parametrize("name", ["momentum", "lamb", "resident"])
def test_two_gloo_processes_match_one_process(two_process_runs, feed, name):
    out, spec, ranks = two_process_runs
    assert [r[name]["first"] for r in ranks] == [0, 4]
    worst = []
    for s in range(DIST_STEPS):
        one, _, step_fn = port_steps(spec[name], feed[:s + 1])
        want = canonical(one, step_fn.plan)[0]
        for rank in range(2):
            got = _dist_leaves(out, name, rank, s)
            if name != "lamb":
                within_norm(got, want, 3e-7)
            elif s == 0:
                # LAMB after one step: u = g/(|g| + eps) moves whole
                # elements where a summed gradient is near eps, and the
                # two runs' sums reassociate (fc1's bias: 1.0e-6 here)
                within_norm(got, want, LAMB_DIST_TOL)
            worst.append(max(
                np.linalg.norm(np.float64(g) - w) / np.linalg.norm(w)
                for g, w in zip(got, want)))
    # LAMB's 1/(sqrt(v)+eps) turns float-epsilon moment differences into
    # whole-element moves while v is near zero: the later steps' gap is
    # reported, not gated
    print(json.dumps({"case": name, "max_leaf_rel_gap_by_step": worst}))
    plan = step_fn.plan
    lps = plan.leaves()
    sharded = sum(lp.pad * 4 for lp in lps if lp.sharded)
    fallback = sum(int(np.prod(lp.shape)) * 4 for lp in lps
                   if not lp.sharded)
    slots = 2 if name == "lamb" else 1
    full = sum(x.numel() * x.element_size()
               for x in api_leaves(one.momentum))
    assert full == slots * (sharded + fallback)
    for r in ranks:
        # half of the sharded slots a rank, the fallback leaves whole
        assert r[name]["slot_bytes"] == slots * (sharded // 2 + fallback)
