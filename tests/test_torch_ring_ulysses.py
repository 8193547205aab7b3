"""Ring and Ulysses attention in the port (``ops/ring_attention.py``,
``ops/ulysses_attention.py``, over ``ops/collectives.py``) against the
reference's under ``shard_map`` on the conftest's 8-device mesh (≙
``tests/test_ring_attention.py`` and ``tests/test_ulysses_attention.py``),
and against its single-device oracle: forward, causal and not, and the
gradients of ``Σ out²`` through the ring's ``ppermute`` steps and the
all-to-alls. The port runs in one launch of 4 gloo processes whose
world is one seq group (``_torch_mp``); each holds a quarter of the
sequence. Ulysses over flash runs the port's flash Function's plain
versions on the CPU against the reference's Pallas ``flash_attention``
in interpret mode. The transformer with ring attention holds the
port's sequence-parallel apply against the reference's.

Tolerances are the reference tests': ``1e-5`` forward, ``1e-4``
gradients, ``2e-5`` with the flash kernel, ``2e-4`` the transformer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributedmnist_tpu.core.mesh import make_seq_topology
from distributedmnist_tpu.models import transformer as ref_transformer
from distributedmnist_tpu.ops.pallas_attention import flash_attention
from distributedmnist_tpu.ops.ring_attention import (local_self_attention,
                                                     ring_self_attention)
from distributedmnist_tpu.ops.ulysses_attention import ulysses_self_attention

from _torch_mp import run_world
from _torch_tp_cases import cfg_dict

WORLD = 4


def _qkv(key, b=2, h=2, s=32, d=8):
    ks = jax.random.split(jax.random.PRNGKey(key), 3)
    return tuple(np.asarray(jax.random.normal(k, (b, h, s, d), jnp.float32))
                 for k in ks)


def _ref(fn, qkv, causal, inner=None, grads=False):
    """The reference's ring (``inner`` None and ``fn`` ring) or Ulysses
    over the 8-device seq mesh: the output, or the gradients of Σ out²."""
    topo = make_seq_topology(8)
    axis = topo.seq_axis
    spec = P(None, None, axis, None)
    kw = {} if fn is ring_self_attention else {"attention_fn": inner}

    def run(q, k, v):
        return jax.shard_map(lambda q, k, v: fn(q, k, v, axis, causal=causal,
                                                **kw),
                             mesh=topo.mesh, in_specs=(spec,) * 3,
                             out_specs=spec)(q, k, v)
    if not grads:
        return np.asarray(jax.jit(run)(*qkv))
    g = jax.grad(lambda t: jnp.sum(run(*t) ** 2))(tuple(qkv))
    return [np.asarray(x) for x in g]


def _oracle(qkv, causal, grads=False):
    if not grads:
        return np.asarray(local_self_attention(*qkv, causal=causal))
    g = jax.grad(lambda t: jnp.sum(local_self_attention(
        *t, causal=causal) ** 2))(tuple(qkv))
    return [np.asarray(x) for x in g]


JOBS = {
    "ring_causal": (0, {}, "ring", True, False),
    "ring_full": (1, {}, "ring", False, False),
    "ring_grads": (2, {}, "ring", True, True),
    "ulysses_causal": (0, {"h": 8}, "ulysses", True, False),
    "ulysses_full": (0, {"h": 8}, "ulysses", False, False),
    "ulysses_flash": (1, {"h": 8, "s": 64}, "ulysses_flash", True, False),
    "ulysses_grads": (2, {"h": 8}, "ulysses", True, True),
    "ulysses_flash_grads": (2, {"h": 8}, "ulysses_flash", True, True),
    "ulysses_heads": (3, {"h": 6}, "ulysses", True, False),
}


def _inputs(name):
    key, shape, _, _, _ = JOBS[name]
    return _qkv(key, **shape)


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring4")
    jobs = []
    for name, (_, _, impl, causal, grads) in JOBS.items():
        q, k, v = _inputs(name)
        jobs.append((name, {"case": "attention", "q": q, "k": k, "v": v,
                            "impl": impl, "causal": causal, "grads": grads}))
    d = _lm_cfg()
    jobs.append(("lm", {"case": "forward", "cfg": d, "params": _lm_params(),
                        "tokens": _lm_tokens()}))
    return run_world(root / "run", WORLD, jobs)


def _joined(res, name, key="out", index=None):
    """The ranks' blocks of one result joined along the sequence."""
    blocks = sorted(((r[name]["rank"], r[name][key] if index is None
                      else r[name][key][index]) for r in res),
                    key=lambda t: t[0])
    return np.concatenate([b for _, b in blocks], axis=2)


@pytest.mark.parametrize("name,causal", [("ring_causal", True),
                                         ("ring_full", False)])
def test_ring_matches_the_reference_and_the_oracle(ring4, name, causal):
    qkv = _inputs(name)
    got = _joined(ring4, name)
    for want in (_ref(ring_self_attention, qkv, causal),
                 _oracle(qkv, causal)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ring_grads_match(ring4):
    qkv = _inputs("ring_grads")
    for i, want in enumerate(_ref(ring_self_attention, qkv, True,
                                  grads=True)):
        got = _joined(ring4, "ring_grads", "grads", i)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, _oracle(qkv, True, grads=True)[i],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,causal", [("ulysses_causal", True),
                                         ("ulysses_full", False)])
def test_ulysses_matches_the_reference(ring4, name, causal):
    qkv = _inputs(name)
    got = _joined(ring4, name)
    for want in (_ref(ulysses_self_attention, qkv, causal),
                 _oracle(qkv, causal)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ulysses_over_flash_matches_the_pallas_kernel(ring4):
    qkv = _inputs("ulysses_flash")
    got = _joined(ring4, "ulysses_flash")
    want = _ref(ulysses_self_attention, qkv, True, inner=flash_attention)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _oracle(qkv, True), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("name,inner", [("ulysses_grads", None),
                                        ("ulysses_flash_grads",
                                         flash_attention)],
                         ids=["dense", "flash"])
def test_ulysses_grads_match(ring4, name, inner):
    qkv = _inputs(name)
    want = _ref(ulysses_self_attention, qkv, True, inner=inner, grads=True)
    for i, w in enumerate(want):
        np.testing.assert_allclose(_joined(ring4, name, "grads", i), w,
                                   rtol=1e-4, atol=1e-4)


def test_ulysses_head_divisibility_guard(ring4):
    for r in ring4:
        assert "not divisible" in r["ulysses_heads"]["error"]


# -- the transformer with ring attention --------------------------------------

def _lm_cfg() -> dict:
    return cfg_dict(1, 1, WORLD, heads=2, model={
        "model_dim": 16, "num_layers": 2, "vocab_size": 31, "seq_len": 64})


def _lm_params():
    params = ref_transformer.init(jax.random.PRNGKey(0), vocab_size=31,
                                  model_dim=16, num_heads=2, num_layers=2,
                                  max_seq_len=64)
    return jax.tree.map(np.asarray, jax.device_get(params))


def _lm_tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                         31), np.int32)


def test_transformer_with_ring_attention_matches_the_reference(ring4):
    """The port's sequence-parallel apply (ring over 4 blocks) against
    the reference's ring transformer over 8, and its dense forward."""
    params, toks = _lm_params(), _lm_tokens()
    topo = make_seq_topology(8)
    axis = topo.seq_axis

    def fn(params, toks, positions):
        def ring_attn(q, k, v):
            return ring_self_attention(q, k, v, axis, causal=True)
        return ref_transformer.apply(params, toks, num_heads=2,
                                     attention_fn=ring_attn,
                                     positions=positions,
                                     compute_dtype=jnp.float32)

    want = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=topo.mesh, in_specs=(P(), P(None, axis), P(axis)),
        out_specs=P(None, axis, None)))(params, toks, jnp.arange(64)))
    dense = np.asarray(ref_transformer.apply(params, toks, num_heads=2,
                                             compute_dtype=jnp.float32))
    blocks = sorted((r["lm"]["seq_index"], r["lm"]["logits"]) for r in ring4)
    got = np.concatenate([b for _, b in blocks], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
