"""The port's pipeline pieces against the reference's (≙
``tests/test_pipeline_parallel.py``'s schedule and identity tests, and
the stacked layouts of ``models/transformer.py:431-843``):

* ``make_1f1b_schedule``'s tables bitwise the reference's over its grid
  ``(S, v, M)`` = (2,2,4), (2,2,8), (4,2,8), (4,2,16), (2,3,12), (4,1,8),
  training and ``forward_only``; GPipe's table (every work once, the
  bubble ``2·S·(S−1)``) and the reference's fewer-idle-ticks check on
  the port's tables.
* The engine on elementwise chunks over a 4-process stage group (gloo
  workers, ``_torch_pp_cases.identity``): GPipe's forward against the
  reference's ``pipeline_apply`` under ``shard_map``, the chunked ring's
  against the composition, and GPipe's and 1F1B's gradients against
  ``jax.grad`` of the composition.
* ``stack_block_params`` and ``stack_block_params_chunked`` against the
  reference's, the stacked rule table through the port's engine against
  the reference's ``pp_param_partition_specs`` and its engine, and the
  stacked layouts through ``models/convert.py`` both ways.
* The refusals that need no process group: a pipeline on one process
  (the ConfigError naming ``torchrun``), chunks without ``1f1b``,
  ZeRO-1 over stages, wall-clock saves, the single-device evaluator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.models.registry import \
    transformer_partition_rules as ref_rules
from distributedmnist_tpu.ops import pipeline as ref_pipeline
from distributedmnist_tpu.parallel.partition_rules import (
    RuleAxes as RefAxes, match_partition_rules as ref_match)
from distributedmnist_tpu_torch.core.config import (ConfigError,
                                                    ExperimentConfig,
                                                    MeshConfig)
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.convert import (params_from_reference,
                                                       params_to_reference)
from distributedmnist_tpu_torch.ops import pipeline

from _torch_mp import run_world
from test_torch_pipeline_parallel import _cfg, _mesh, _ref_params

GRID = [(2, 2, 4), (2, 2, 8), (4, 2, 8), (4, 2, 16), (2, 3, 12), (4, 1, 8)]


@pytest.mark.parametrize("forward_only", [False, True])
@pytest.mark.parametrize("S,v,M", GRID, ids=str)
def test_1f1b_tables_are_bitwise_the_reference(S, v, M, forward_only):
    want = ref_pipeline.make_1f1b_schedule(S, v, M, forward_only)
    got = pipeline.make_1f1b_schedule(S, v, M, forward_only)
    assert set(got) == set(want)
    for k, a in want.items():
        b = got[k]
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and b.shape == a.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)
            assert not b.flags.writeable
        else:
            assert type(b) is type(a) and b == a, k
    # the cache hands out one frozen object
    assert pipeline.make_1f1b_schedule(S, v, M, forward_only) is got


def _works(tbl, S):
    f, b = {}, {}
    for t in range(tbl["ticks"]):
        for d in range(S):
            c = int(tbl["slot"][t, d]) * S + d
            key = (int(tbl["mb"][t, d]), c)
            if tbl["kind"][t, d] in (1, 2):
                assert key not in f
                f[key] = t
            elif tbl["kind"][t, d] == 3:
                assert key in f and key not in b  # B after its own F
                b[key] = t
    return f, b


@pytest.mark.parametrize("S,M", [(2, 1), (2, 4), (4, 4), (4, 8)], ids=str)
def test_gpipe_table_runs_every_work_once(S, M):
    """All forwards (the last stage's seed the loss), then all
    backwards, the last microbatch's first; a transfer is readable the
    tick after it is sent; the bubble is GPipe's ``2·S·(S−1)``."""
    tbl = pipeline.make_gpipe_schedule(S, M)
    f, b = _works(tbl, S)
    assert len(f) == len(b) == M * S
    assert max(f.values()) < min(b.values())
    assert tbl["idle_slots"] == 2 * S * (S - 1)
    last = [int(tbl["mb"][t, S - 1]) for t in range(tbl["ticks"])
            if tbl["kind"][t, S - 1] == 3]
    assert last == list(range(M - 1, -1, -1))
    for (m, c), t in f.items():
        if c < S - 1:
            assert f[(m, c + 1)] > t
            assert tbl["frecv_slot"][t, c + 1] == 0
            assert tbl["frecv_mb"][t, c + 1] == m
    for (m, c), t in b.items():
        if c > 0:
            assert b[(m, c - 1)] > t
        assert tbl["bank"][t, c] == (c == 0)
    fo = pipeline.make_gpipe_schedule(S, M, forward_only=True)
    assert fo["ticks"] == M + S - 1 and not (fo["kind"] == 3).any()


def test_1f1b_schedule_valid_and_fewer_idle_ticks():
    """The reference's bubble check on the port's tables: at M ≥ 2S with
    v ≥ 2 chunks, fewer idle chunk-slots than GPipe's 2·S·(S−1)·v, and
    every (microbatch, chunk) forwarded and backwarded once."""
    for S, v, M in GRID[:5]:
        tbl = pipeline.make_1f1b_schedule(S, v, M)
        assert tbl["idle_slots"] < 2 * S * (S - 1) * v
        assert tbl["ticks"] < 2 * (M + S - 1) * v
        f, b = _works(tbl, S)
        assert len(f) == len(b) == M * S * v
    assert pipeline.make_1f1b_schedule(4, 1, 8)["idle_slots"] <= 2 * 4 * 3


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    rng = np.random.default_rng(5)
    payload = {"case": "identity", "chunks": 2,
               "micro": rng.normal(size=(4, 2, 3)).astype(np.float32),
               "ct": rng.normal(size=(4, 2, 3)).astype(np.float32)}
    res = run_world(tmp_path_factory.mktemp("pp_id"), 4,
                    [("identity", payload)], cases="_torch_pp_cases")
    return [r["identity"] for r in res], payload


def test_identity_stages_match_the_reference_pipeline(identity):
    """≙ ``test_pipeline_apply_identity_stages``: the GPipe forward of
    ``x·2 + 1`` stages equals the reference's ``pipeline_apply`` over a
    4-stage axis (and the composition); the chunked ring's 8 chunks the
    8-fold composition."""
    outs, p = identity
    topo = ref_topology(RefMesh(num_replicas=1, pipeline_parallelism=4))

    def fn(mb):
        return ref_pipeline.pipeline_apply(lambda x: x * 2.0 + 1.0, mb,
                                           topo.stage_axis)
    want = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=topo.mesh, in_specs=P(), out_specs=P()))(p["micro"]))
    last = outs[3]
    np.testing.assert_allclose(last["gpipe"], want, rtol=1e-6)
    eight = p["micro"]
    for _ in range(8):
        eight = eight * 2.0 + 1.0
    np.testing.assert_allclose(last["chunked"], eight, rtol=1e-6)
    assert [o["stage"] for o in outs] == [0, 1, 2, 3]
    assert all(o["gpipe"] is None for o in outs[:3])


@pytest.mark.parametrize("name,chunks", [("gpipe_grads", 1),
                                         ("1f1b_grads", 2)])
def test_identity_stage_gradients_match_jax_grad(identity, name, chunks):
    """Both training schedules on chunks ``x·w_c + 1`` with the head
    ``Σ y·ct``: the losses a microbatch on the last stage, each chunk's
    ``w`` gradient on its stage (global chunk ``j·S + d``), the banked
    input cotangents on stage 0 — all ``jax.grad`` of the composition."""
    outs, p = identity
    S, C = 4, 4 * chunks
    ws = jnp.asarray([1.5 + 0.25 * c for c in range(C)])

    def objective(ws, micro):
        y = micro
        for c in range(C):
            y = y * ws[c] + 1.0
        per_mb = jnp.sum(y * p["ct"], axis=(1, 2))
        return jnp.sum(per_mb), per_mb

    (_, per_mb), (gw, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(ws, p["micro"])
    for d, o in enumerate(outs):
        got = o[name]
        for j, g in enumerate(got["w"]):
            np.testing.assert_allclose(g, gw[j * S + d], rtol=1e-5)
        if d == S - 1:
            np.testing.assert_allclose(got["losses"], per_mb, rtol=1e-5)
        else:
            assert got["losses"] == [0.0] * 4
        if d == 0:
            np.testing.assert_allclose(got["dinputs"], gx, rtol=1e-5)
        else:
            assert got["dinputs"] is None
    assert outs[0]["staged"] == {"ppermute": 0, "all_to_all": 0, "p2p": 0}


@pytest.mark.parametrize("S,v", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_stacked_layouts_match_the_reference(S, v):
    """The port's stacking (numpy leaves) equals the reference's, leaf for
    leaf and in order; the stacked tree converts to torch and back
    bitwise."""
    params = _ref_params(_cfg(_mesh(1, 1, 1, 1, 1, 1)))
    if v == 1:
        want = ref_transformer.stack_block_params(params)
        got = transformer.stack_block_params(params)
    else:
        want = ref_transformer.stack_block_params_chunked(params, S, v)
        got = transformer.stack_block_params_chunked(params, S, v)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    torch_tree = params_from_reference(got, device="cpu")
    assert tuple(torch_tree["blocks"]["wqkv"].shape) == (4, 32, 3, 32)
    for a, b in zip(jax.tree.leaves(params_to_reference(torch_tree)),
                    jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_chunked_stacking_refuses_indivisible_layers():
    params = _ref_params(_cfg(_mesh(1, 1, 1, 1, 1, 1), layers=3))
    with pytest.raises(ValueError, match="not divisible by stages×chunks"):
        transformer.stack_block_params_chunked(params, 2, 2)


@pytest.mark.parametrize("num_experts,tp,ep", [
    (0, False, False), (0, True, False), (4, False, False),
    (4, True, False), (4, False, True), (4, True, True)])
def test_stacked_specs_match_the_reference(num_experts, tp, ep):
    """The stacked entries of the port's rule table through its engine
    give, for every leaf, the reference's ``pp_param_partition_specs``
    and the reference engine's spec, with the stage, model and expert
    axes bound."""
    from distributedmnist_tpu_torch.models.registry import \
        transformer_partition_rules
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        RuleAxes, match_partition_rules, spec_leaves)
    m, e = ("model" if tp else None), ("expert" if ep else None)
    d = _cfg(_mesh(1, 1, 1, 1, 1, 1), moe=bool(num_experts))
    stacked = ref_transformer.stack_block_params(_ref_params(d))
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    want = [tuple(s) for s in jax.tree.leaves(
        ref_transformer.pp_param_partition_specs("stage", m, num_experts,
                                                 e), is_leaf=is_spec)]
    engine_want = [tuple(s) for s in jax.tree.leaves(ref_match(
        ref_rules(num_experts)(RefAxes(model=m, expert=e, stage="stage")),
        stacked), is_leaf=is_spec)]
    got = spec_leaves(match_partition_rules(
        transformer_partition_rules(num_experts)(RuleAxes(
            model=m, expert=e, stage="stage")), stacked))
    assert got == want == engine_want


def test_refusals_without_a_group(tmp_path):
    """A pipeline on one process is the ConfigError naming ``torchrun``
    (never a one-process run); chunks without ``1f1b`` the reference's
    ValueError; ZeRO-1 over stages that same ConfigError and nothing
    about ZeRO-1 (it runs under a group); a wall-clock
    save cadence refused (a save gathers the stages); the single-device
    evaluator refuses the stacked layout."""
    from distributedmnist_tpu_torch.core.mesh import make_topology
    from distributedmnist_tpu_torch.evalsvc.evaluator import Evaluator
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    from distributedmnist_tpu_torch.train.loop import Trainer
    with pytest.raises(ConfigError, match="torchrun --nproc_per_node 2"):
        make_topology(MeshConfig(num_replicas=1, pipeline_parallelism=2))
    with pytest.raises(ValueError) as got:
        make_topology(MeshConfig(num_replicas=1, pipeline_parallelism=2,
                                 pipeline_chunks=2))
    assert str(got.value) == ("mesh.pipeline_chunks=2 requires "
                              "pipeline_schedule='1f1b' (got 'gpipe')")
    d = _cfg(_mesh(1, 2, 1, 1, 1, 2))
    d["parallel"] = {"shard_weight_update": True}
    cfg = ExperimentConfig.from_dict(d)
    with pytest.raises(ConfigError, match="torchrun") as got:
        api.build_train_step(get_model(cfg.model), cfg,
                             lr_schedule.constant(0.1))
    assert "shard_weight_update" not in str(got.value)
    d = _cfg(_mesh(1, 2, 1, 1, 1, 2))
    d["train"].update(save_interval_secs=5.0, train_dir=str(tmp_path))
    with pytest.raises(ValueError, match="pipeline_parallelism > 1 gathers"):
        Trainer(ExperimentConfig.from_dict(d), device="cpu")
    with pytest.raises(ValueError, match="pipeline-stacked parameter"):
        Evaluator(tmp_path, cfg=ExperimentConfig.from_dict(d),
                  single_device=True, device="cpu")
