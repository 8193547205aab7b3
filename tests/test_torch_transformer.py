"""Port parity: the causal-LM transformer's serving exports
(``distributedmnist_tpu_torch/models/transformer.py``, ``registry.py``,
``convert.py``) against the reference, at a small size (d=64, 4 heads
of 16, 2 layers, vocab 32, seq_len 64, float32).

The reference's params (``model.init`` on a JAX key) are carried over
with ``params_from_reference``; the reference runs its Pallas kernels
in interpret mode (flash prefill, paged decode), the port its plain
versions. Tolerance 1e-4 on logits and K/V: float32 throughout, but
the matmul and softmax summation orders differ between XLA-on-CPU and
PyTorch-on-CPU, and the error compounds over two layers and a 32-way
head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ModelConfig as RefModelConfig
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.servesvc.kv_cache import \
    PagedKVCache as RefPagedKVCache
from distributedmnist_tpu_torch.core.config import ModelConfig
from distributedmnist_tpu_torch.models.convert import (
    params_from_reference, params_to_reference)
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.models.registry import (get_model,
                                                       lm_last_logits,
                                                       sample_token)
from distributedmnist_tpu_torch.servesvc.kv_cache import PagedKVCache

LM_MODEL = {"name": "transformer", "seq_len": 64, "model_dim": 64,
            "num_heads": 4, "num_layers": 2, "vocab_size": 32,
            "compute_dtype": "float32", "attention_impl": "flash"}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    ref = ref_get_model(RefModelConfig(**LM_MODEL))
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    port = get_model(ModelConfig(**LM_MODEL))
    return ref, ref_params, port, params_from_reference(tree, device="cpu")


def test_convert_round_trips_the_reference_layout(models):
    _, ref_params, _, params = models
    back = params_to_reference(params)
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the flax state-dict form ({"0": block, ...}) converts the same
    tree = jax.tree.map(np.asarray, ref_params)
    sd = {**tree, "blocks": {str(i): b for i, b in
                             enumerate(tree["blocks"])}}
    again = params_from_reference(sd, device="cpu")
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(params_to_reference(again))):
        np.testing.assert_array_equal(a, b)


def test_apply_matches_reference(models):
    ref, ref_params, port, params = models
    toks = np.random.default_rng(0).integers(0, 32, (2, 20))
    want = np.asarray(ref.apply(ref_params, jnp.asarray(toks, jnp.int32)))
    got = port.apply(params, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_matches_reference_flash_prefill(models):
    ref, ref_params, port, params = models
    toks = np.random.default_rng(1).integers(0, 32, (1, 16))
    lw, kw, vw = ref.decode_prefill(ref_params, jnp.asarray(toks, jnp.int32))
    lg, kg, vg = port.decode_prefill(params, torch.from_numpy(toks))
    assert tuple(kg.shape) == (2, 1, 16, 4, 16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), **TOL)
    np.testing.assert_allclose(kg.numpy(), np.asarray(kw), **TOL)
    np.testing.assert_allclose(vg.numpy(), np.asarray(vw), **TOL)
    np.testing.assert_allclose(lm_last_logits(lg).numpy(),
                               np.asarray(lw)[:, -1], **TOL)


def test_paged_decode_steps_match_reference(models):
    """A slot mix (idle slot 0, two live sequences) through one prefill
    each and 4 paged decode steps on both sides, fed the same tokens:
    live logits within 1e-4 every step; caches agree outside the null
    block 0 (idle-slot garbage is routed there on both sides)."""
    ref, ref_params, port, params = models
    rng = np.random.default_rng(2)
    L, H, HD, bs, slots = 2, 4, 16, 8, 3
    rc = RefPagedKVCache(L, 16, bs, H, HD, max_blocks_per_seq=4,
                         dtype=jnp.float32)
    pc = PagedKVCache(L, 16, bs, H, HD, 4, device="cpu")
    tables = np.zeros((slots, 4), np.int32)
    length = np.zeros(slots, np.int64)
    last = np.zeros(slots, np.int64)
    for slot, plen in ((1, 5), (2, 12)):
        toks = rng.integers(0, 32, (1, 16))
        lw, kw, vw = ref.decode_prefill(ref_params,
                                        jnp.asarray(toks, jnp.int32))
        t = rc.alloc_sequence(plen + 4)
        np.testing.assert_array_equal(t, pc.alloc_sequence(plen + 4))
        rc.write_prompt(t, kw[:, 0], vw[:, 0], plen)
        _, kg, vg = port.decode_prefill(params, torch.from_numpy(toks))
        pc.write_prompt(t, kg[:, 0], vg[:, 0], plen)
        tables[slot], length[slot] = t, plen
        last[slot] = int(np.argmax(np.asarray(lw)[0, plen - 1]))
    ref_step = jax.jit(functools.partial(ref.decode_step, block_size=bs,
                                         attention_kernel="paged"))
    live = length > 0
    for _ in range(4):
        lengths = np.where(live, length + 1, 0).astype(np.int32)
        lw, rc.k, rc.v = ref_step(
            ref_params, jnp.asarray(last, jnp.int32),
            jnp.asarray(length, jnp.int32), rc.k, rc.v,
            jnp.asarray(tables), jnp.asarray(lengths))
        lg, _, _ = port.decode_step(
            params, torch.from_numpy(last), torch.from_numpy(length),
            pc.k, pc.v, torch.from_numpy(tables),
            torch.from_numpy(lengths), block_size=bs,
            attention_kernel="paged")
        lw = np.asarray(lw)
        np.testing.assert_allclose(lg.numpy()[live], lw[live], **TOL)
        last = np.where(live, np.argmax(lw, axis=-1), 0)
        length = np.where(live, length + 1, 0)
    np.testing.assert_allclose(pc.k.numpy()[:, 1:], np.asarray(rc.k)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(pc.v.numpy()[:, 1:], np.asarray(rc.v)[:, 1:],
                               **TOL)


def test_greedy_paged_decode_matches_full_context_argmax(models):
    """Greedy decode through the paged cache (slot 1 of 3) reproduces
    the argmax of the full-context forward token for token — the port's
    own forward and the reference's alike (≙ tests/test_decode.py)."""
    ref, ref_params, port, params = models
    prompt, n_new, bs = [3, 7, 1, 9, 2, 11, 4], 9, 8
    L, H, HD = port.decode_cache_shape
    cache = PagedKVCache(L, 32, bs, H, HD, 16, device="cpu")
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(prompt)] = prompt
    logits, ks, vs = port.decode_prefill(params, torch.from_numpy(toks))
    table = cache.alloc_sequence(len(prompt) + n_new)
    cache.write_prompt(table, ks[:, 0], vs[:, 0], len(prompt))
    gen = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    length = len(prompt)
    tables = torch.zeros(3, 16, dtype=torch.int32)
    tables[1] = torch.from_numpy(table)
    for _ in range(n_new - 1):
        z = lambda: torch.zeros(3, dtype=torch.int64)
        tokens, positions = z(), z()
        tokens[1], positions[1] = gen[-1], length
        lengths = torch.zeros(3, dtype=torch.int32)
        lengths[1] = length + 1
        lg, _, _ = port.decode_step(params, tokens, positions, cache.k,
                                    cache.v, tables, lengths, block_size=bs,
                                    attention_kernel="paged")
        length += 1
        gen.append(int(torch.argmax(lg[1])))
    # the reference's dense attention: the same math as its flash
    # kernel; one compiled shape (causal, so right-padding to 16 leaves
    # every earlier position's logits unchanged)
    ref_dense = ref_get_model(RefModelConfig(**{**LM_MODEL,
                                                "attention_impl": "dense"}))
    ref_apply = jax.jit(ref_dense.apply)
    seq = list(prompt)
    for _ in range(n_new):
        padded = np.zeros((1, 16), np.int64)
        padded[0, :len(seq)] = seq
        full = port.apply(params, torch.from_numpy(padded))[0, len(seq) - 1]
        want = np.asarray(ref_apply(ref_params, jnp.asarray(padded,
                                                            jnp.int32)))
        assert int(torch.argmax(full)) == int(np.argmax(
            want[0, len(seq) - 1]))
        seq.append(int(torch.argmax(full)))
    assert gen == seq[len(prompt):]


def test_decode_step_rejects_unknown_kernel(models):
    _, _, port, params = models
    z = torch.zeros
    with pytest.raises(ValueError, match="attention_kernel"):
        port.decode_step(params, z(1, dtype=torch.int64),
                         z(1, dtype=torch.int64), z(2, 4, 8, 4, 16),
                         z(2, 4, 8, 4, 16), z(1, 2, dtype=torch.int32),
                         z(1, dtype=torch.int32), block_size=8,
                         attention_kernel="flash")


def test_registry_refuses_what_is_not_ported():
    """ResNet-20 is ported (it builds, vmappable, with no
    ``predictions`` as in the reference); a mixture-of-experts
    transformer builds with its aux loss and, as in the reference, no
    decode export; unknown families still raise."""
    resnet = get_model(ModelConfig(name="resnet20", image_size=32,
                                   num_channels=3))
    assert resnet.vmap_replicas and resnet.predictions is None
    assert resnet.input_shape == (32, 32, 3)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model(ModelConfig(name="vit"))
    moe = get_model(ModelConfig(**{**LM_MODEL, "num_experts": 2,
                                   "moe_aux_weight": 0.03}))
    assert moe.has_aux and moe.aux_weight == 0.03
    assert (moe.decode_prefill, moe.decode_step,
            moe.decode_cache_shape) == (None, None, None)
    dense = get_model(ModelConfig(**LM_MODEL))
    assert not dense.has_aux and dense.decode_step is not None


@pytest.mark.parametrize("temperature", [0.7, 1.3])
@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_token_matches_reference(temperature, top_k):
    """The port's sampled tokens are the reference's, key for key (256
    keys over rows of seeded logits)."""
    from distributedmnist_tpu.models.registry import sample_token as ref
    rows = np.random.default_rng(7).normal(size=(256, 40)).astype(
        np.float32) * 3.0
    for i, row in enumerate(rows):
        key = jax.random.fold_in(jax.random.PRNGKey(i // 16), i)
        want = int(ref(jnp.asarray(row), key, temperature=temperature,
                       top_k=top_k))
        got = int(sample_token(torch.from_numpy(row),
                               prng.fold_in(prng.PRNGKey(i // 16), i),
                               temperature=temperature, top_k=top_k))
        assert got == want, i


def test_sample_token():
    logits = torch.from_numpy(
        np.random.default_rng(3).normal(size=(5, 32)).astype(np.float32))
    np.testing.assert_array_equal(sample_token(logits).numpy(),
                                  np.argmax(logits.numpy(), axis=-1))
    g = prng.PRNGKey(0)
    # top_k=1 is greedy at any temperature; a tiny temperature samples
    # the mode
    np.testing.assert_array_equal(
        sample_token(logits, g, temperature=5.0, top_k=1).numpy(),
        np.argmax(logits.numpy(), axis=-1))
    np.testing.assert_array_equal(
        sample_token(logits, g, temperature=1e-6).numpy(),
        np.argmax(logits.numpy(), axis=-1))
    top3 = set(np.argsort(logits[0].numpy())[-3:].tolist())
    for i in range(16):
        assert int(sample_token(logits[0], prng.fold_in(g, i),
                                temperature=2.0, top_k=3)) in top3
    with pytest.raises(ValueError, match="PRNG key"):
        sample_token(logits, temperature=1.0)
