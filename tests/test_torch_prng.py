"""The port's PRNG (``core/prng.py``) against ``jax.random`` and the
reference's ``core/prng.py``, under the reference's own jax config
(``jax_threefry_partitionable`` on).

Everything is bitwise, over 64 seeds and shapes with odd sizes: keys
(``PRNGKey``, ``fold_in``, ``split``, the stream/step/replica keys),
raw bits, ``uniform`` (also on ``[min, max)`` ranges, where XLA fuses
the scale and shift into one rounding), ``bernoulli``, ``gumbel``,
``categorical``, ``normal`` and ``truncated_normal``. The last four rest
on XLA's own float32 ``log``, ``log1p`` and ``erf_inv``, which the port
writes out; those are also held bitwise on 400k inputs each.

Random bits come from one implementation, the torch int64 threefry
rounds, on the CPU and on the card alike; so these CPU tests hold the
code the card runs, batches of keys (one per replica) included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core import prng as ref_prng
from distributedmnist_tpu_torch.core import prng

from _torch_threads import one_torch_thread  # noqa: F401

SEEDS = list(range(60)) + [66478, 123456789, 2**31 - 1, 2**32 - 1]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 33)]


def test_partitionable_threefry_is_the_reference_config():
    assert jax.config.jax_threefry_partitionable


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_bitwise(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), pk)
    data = (seed * 7 + 3) % 2**31
    np.testing.assert_array_equal(jax.random.fold_in(jk, data),
                                  prng.fold_in(pk, data))
    np.testing.assert_array_equal(jax.random.split(jk, 5),
                                  prng.split(pk, 5))
    for name in ("dropout", "straggler", "drop_connect"):
        np.testing.assert_array_equal(
            ref_prng.stream_key(jk, name), prng.stream_key(pk, name))
        np.testing.assert_array_equal(
            ref_prng.replica_key(jk, name, seed, 3),
            prng.replica_key(pk, name, seed, 3))
    np.testing.assert_array_equal(
        np.stack([ref_prng.replica_key(jk, "dropout", 5, r)
                  for r in range(4)]),
        prng.replica_keys(pk, "dropout", 5, 4))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_are_bitwise(shape):
    for seed in SEEDS:
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, shape)),
            prng.random_bits(pk, shape).numpy().astype(np.uint32))
        for lo, hi in ((0.0, 1.0), (0.0, 1e-3), (-0.7, 2.5)):
            np.testing.assert_array_equal(
                _bits(jax.random.uniform(jk, shape, jnp.float32, lo, hi)),
                _bits(prng.uniform(pk, shape, lo, hi).numpy()))
        for p in (0.5, 0.9, 0.1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(jk, p, shape)),
                prng.bernoulli(pk, p, shape).numpy())


def test_batched_keys_draw_each_keys_bits():
    keys = prng.replica_keys(prng.PRNGKey(3), "dropout", 2, 8)
    got = prng.bernoulli(keys, 0.5, (4, 6))
    for r in range(8):
        np.testing.assert_array_equal(
            got[r].numpy(),
            np.asarray(jax.random.bernoulli(jnp.asarray(keys[r]), 0.5,
                                            (4, 6))))


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_keys_are_bitwise(shape):
    """A batch of replica keys (the per-replica dropout, straggler and
    drop-connect draws) gives, key by key, jax's bits, uniforms and
    normals."""
    for step in range(4):
        keys = prng.replica_keys(prng.PRNGKey(step), "straggler", step, 8)
        bits = prng.random_bits(keys, shape, "cpu")
        u = prng.uniform(keys, shape, 0.0, 1e-3, "cpu")
        z = prng.normal(keys, shape, "cpu")
        assert bits.shape == (8,) + shape
        for r in range(8):
            jk = jnp.asarray(keys[r])
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(jk, shape)),
                bits[r].numpy().astype(np.uint32))
            np.testing.assert_array_equal(
                _bits(jax.random.uniform(jk, shape, jnp.float32, 0.0, 1e-3)),
                _bits(u[r].numpy()))
            np.testing.assert_array_equal(_bits(jax.random.normal(jk, shape)),
                                          _bits(z[r].numpy()))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_normal_truncated_normal_are_bitwise(shape):
    for seed in SEEDS:
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for want, got in (
                (jax.random.gumbel(jk, shape), prng.gumbel(pk, shape)),
                (jax.random.normal(jk, shape), prng.normal(pk, shape)),
                (jax.random.truncated_normal(jk, -2.0, 2.0, shape),
                 prng.truncated_normal(pk, -2.0, 2.0, shape))):
            np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_categorical_draws_are_equal():
    logits = np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32)
    for seed in range(64):
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.categorical(jk, logits * 2.0)),
            prng.categorical(pk, torch.from_numpy(logits * 2.0)).numpy())


@pytest.mark.parametrize("fn", ["log", "log1p", "erf_inv"])
def test_xla_float32_math_is_bitwise(fn):
    rng = np.random.default_rng(1)
    if fn == "log":
        x = np.concatenate([rng.uniform(0, 1, 200000),
                            rng.uniform(0, 100, 100000),
                            10.0 ** rng.uniform(-37, 37, 100000),
                            [0.0, 1.0, np.inf, 1e-40]])
        want, got = jnp.log, prng.xla_log
    elif fn == "log1p":
        x = np.concatenate([rng.uniform(-1, 1, 300000),
                            rng.uniform(-0.5, 0.5, 100000), [0.0, 3.0]])
        want, got = jnp.log1p, prng.xla_log1p
    else:
        x = np.concatenate([rng.uniform(-1, 1, 400000),
                            [-1.0, 0.0, 1.0, 0.9999999, -0.99999994]])
        want, got = jax.lax.erf_inv, prng.erf_inv
    x = x.astype(np.float32)
    np.testing.assert_array_equal(
        _bits(np.asarray(want(x))), _bits(got(torch.from_numpy(x)).numpy()))
