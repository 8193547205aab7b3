"""The port's contribution policies, masked mean and drop-connect
(``parallel/policies.py``, ``ops/masked_psum.py``, ``ops/drop_connect.py``)
against the reference's.

The reference's replica-axis functions run under ``jax.vmap`` with an
axis name (8 replicas), which gives ``lax.all_gather``/``psum`` their
replica semantics on one device. Everything discrete is exact: flags for
k = 1…8, ties broken by replica id, the timeout edge ``t == timeout``,
and the drop-connect masks. The modeled times draw the same bits from
the same keys (``normal``, ``bernoulli`` and ``uniform`` are bitwise);
the arithmetic around them (``mean·exp(σz − σ²/2) + base``) is held to
2 ulp: XLA's own float32 ``exp``, and the multiply-adds it fuses
differently inside a jit than op by op. The masked mean is
held at float32 ``rtol 1e-6`` at all-ones and partial flags, and is
exact zeros when every replica is masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core import prng as ref_prng
from distributedmnist_tpu.core.config import SyncConfig as RefSync
from distributedmnist_tpu.ops.drop_connect import drop_connect_grads as ref_dc
from distributedmnist_tpu.ops.masked_psum import masked_mean_psum
from distributedmnist_tpu.parallel import policies as ref_pol
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.core.config import SyncConfig
from distributedmnist_tpu_torch.core.mesh import Topology
from distributedmnist_tpu_torch.ops import masked_psum
from distributedmnist_tpu_torch.ops.drop_connect import drop_connect_grads
from distributedmnist_tpu_torch.parallel import policies

from _torch_threads import one_torch_thread  # noqa: F401

N = 8


def _ref_flags(fn, times):
    return np.asarray(jax.vmap(fn, axis_name="r")(jnp.asarray(times)))


@pytest.mark.parametrize("k", list(range(1, N + 1)) + [3.6, 4.4])
def test_quorum_flags_match(k):
    rng = np.random.default_rng(int(k * 10))
    for _ in range(10):
        t = rng.lognormal(3.0, 0.5, N).astype(np.float32)
        want = _ref_flags(lambda x: ref_pol.quorum_flag(x, k, "r"), t)
        got = policies.quorum_flag(torch.from_numpy(t), k).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == round(k)


def test_ties_break_by_replica_id():
    t = np.array([5, 3, 5, 3, 5, 1, 5, 3], np.float32)
    np.testing.assert_array_equal(
        policies.rank_by_time(torch.from_numpy(t)).numpy(),
        np.asarray(jax.vmap(lambda x: ref_pol.rank_by_time(x, "r"),
                            axis_name="r")(jnp.asarray(t))))
    np.testing.assert_array_equal(
        policies.rank_by_time(torch.from_numpy(t)).numpy(),
        [4, 1, 5, 2, 6, 0, 7, 3])
    for k in range(1, N + 1):
        got = policies.quorum_flag(torch.from_numpy(t), torch.tensor(k))
        np.testing.assert_array_equal(
            got.numpy(),
            _ref_flags(lambda x: ref_pol.quorum_flag(x, k, "r"), t))


def test_timeout_edge_is_inclusive():
    t = np.array([9.0, 10.0, np.nextafter(np.float32(10), np.float32(11)),
                  0.0], np.float32)
    for dl in (10.0, 0.0, 9.0):
        got = policies.timeout_flag(torch.from_numpy(t), dl).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref_pol.timeout_flag(jnp.asarray(t), dl)))
    np.testing.assert_array_equal(
        policies.timeout_flag(torch.from_numpy(t), 10.0).numpy(),
        [1, 1, 0, 1])


@pytest.mark.parametrize("profile", ["lognormal", "spike", "none"])
def test_step_times_are_the_references(profile):
    over = {"straggler_profile": profile, "straggler_mean_ms": 50.0,
            "straggler_sigma": 0.7, "straggler_spike_prob": 0.3,
            "straggler_spike_scale": 6.0}
    rcfg, pcfg = RefSync(**over), SyncConfig(**over)
    root = jax.random.PRNGKey(11)
    measured = np.linspace(0.0, 3.5, N).astype(np.float32)
    for step in range(6):
        want = np.array([ref_pol.sample_step_time_ms(
            rcfg, root, jnp.int32(step), jnp.int32(r), measured[r])
            for r in range(N)], np.float32)
        got = policies.sample_step_time_ms(
            pcfg, prng.PRNGKey(11), step, torch.from_numpy(measured))
        ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                     - want.view(np.int32))
        assert ulp.max() <= 2, ulp


def test_resolve_aggregate_k():
    for k in (-1, 1, 5, 8):
        assert policies.resolve_aggregate_k(
            SyncConfig(num_replicas_to_aggregate=k), N) == \
            ref_pol.resolve_aggregate_k(RefSync(num_replicas_to_aggregate=k),
                                        N)
    with pytest.raises(ValueError, match="outside"):
        policies.resolve_aggregate_k(SyncConfig(num_replicas_to_aggregate=9),
                                     N)


@pytest.mark.parametrize("flags", [[1] * N, [0, 1, 1, 0, 0, 1, 0, 1],
                                   [0] * N])
def test_masked_mean_matches(flags):
    rng = np.random.default_rng(sum(flags))
    g = rng.normal(size=(N, 37)).astype(np.float32)
    f = np.asarray(flags, np.float32)
    want, num = jax.vmap(lambda x, fl: masked_mean_psum({"g": x}, fl, "r"),
                         axis_name="r")(jnp.asarray(g), jnp.asarray(f))
    scale, got_num = masked_psum.contribution_scale(torch.from_numpy(f))
    got = masked_psum.masked_mean(torch.from_numpy(g), scale,
                                  Topology(num_replicas=N))
    assert float(got_num) == float(num[0]) == sum(flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["g"][0]),
                               rtol=1e-6, atol=1e-7)
    if not any(flags):
        assert torch.count_nonzero(got) == 0


def test_flatten_round_trip():
    """Replica r's leaves are row r of the bucket, in leaf order."""
    leaves = [torch.arange(12.0).view(2, 2, 3), torch.tensor([[7.0], [8.0]])]
    flat = masked_psum.flatten_replicas(leaves)
    assert flat.shape == (2, 7)
    for r in range(2):
        back = masked_psum.unflatten_like(flat[r], [x[r] for x in leaves])
        for a, b in zip(back, leaves):
            assert torch.equal(a, b[r])


def test_drop_connect_masks_are_the_references():
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.normal(size=(5, 7)).astype(np.float32),
                  "b": rng.normal(size=(7,)).astype(np.float32)},
            "a": rng.normal(size=(3,)).astype(np.float32)}
    key = ref_prng.replica_key(jax.random.PRNGKey(2), "drop_connect", 4, 1)
    want = jax.tree.leaves(ref_dc(tree, key, 0.9))  # jax order: sorted keys
    leaves = [torch.from_numpy(x) for x in
              (tree["a"], tree["b"]["b"], tree["b"]["w"])]
    got = drop_connect_grads(leaves, np.asarray(key), 0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
