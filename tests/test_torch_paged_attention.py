"""Port parity: paged decode attention (``distributedmnist_tpu_torch/ops/
paged_attention.py``, kernel K5) and the paged KV cache
(``servesvc/kv_cache.py``) against the reference.

On the CPU the port's ``paged_attention`` runs its plain version (the
full-table gather); the reference's runs its Pallas kernel in interpret
mode. The null block is poisoned as in ``tests/test_paged_attention.py``
so an accidental read of a dead table entry shows up as a parity break.
Tolerances: live slots 1e-5 (float32 scores/softmax on both sides, only
the summation order differs); an idle slot (length 0) is EXACTLY zero
in the port, in both the plain version and the kernel (the kernel is
held against the plain version on the card in
``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.ops.pallas_paged_attention import \
    paged_attention as ref_paged
from distributedmnist_tpu_torch.ops.paged_attention import paged_attention
from distributedmnist_tpu_torch.servesvc.kv_cache import (
    NULL_BLOCK, BlockAllocator, PagedKVCache)

TOL = dict(atol=1e-5, rtol=1e-5)


def _slot_mix(seed, heads=4, hd=16, bs=8, width=4, nblocks=16):
    """Fresh (1 token), mid (partial block), full-table and idle slots,
    with the null block poisoned."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((nblocks, bs, heads, hd)).astype(np.float32)
    v = rng.standard_normal((nblocks, bs, heads, hd)).astype(np.float32)
    k[NULL_BLOCK], v[NULL_BLOCK] = 37.0, -53.0
    tables = np.zeros((4, width), np.int32)
    tables[0, 0] = 1
    tables[1, :2] = (2, 3)
    tables[2] = (4, 5, 6, 7)
    lengths = np.asarray([1, 11, 32, 0], np.int32)
    q = rng.standard_normal((4, heads, hd)).astype(np.float32)
    return q, k, v, tables, lengths


def _ref(q, k, v, tables, lengths):
    return np.asarray(ref_paged(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(tables),
                                jnp.asarray(lengths)))


def test_paged_matches_reference_kernel_across_slot_mix():
    q, k, v, tables, lengths = _slot_mix(0)
    want = _ref(q, k, v, tables, lengths)
    before = paged_attention.launches
    got = paged_attention(*map(torch.from_numpy,
                               (q, k, v, tables, lengths))).numpy()
    assert paged_attention.launches == before  # CPU: plain version
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[:3], want[:3], **TOL)
    np.testing.assert_array_equal(got[3], np.zeros_like(got[3]))
    np.testing.assert_array_equal(want[3], np.zeros_like(want[3]))


def test_paged_strided_query_and_explicit_scale():
    """The decode step passes q as a strided view of the qkv product."""
    q, k, v, tables, lengths = _slot_mix(1)
    qkv = np.stack([q, q * 2, q * 3], axis=1)          # [S, 3, h, hd]
    tq = torch.from_numpy(qkv)[:, 0]
    assert not tq.is_contiguous()
    want = _ref(q, k, v, tables, lengths)
    got = paged_attention(tq, *map(torch.from_numpy,
                                   (k, v, tables, lengths)),
                          scale=1.0 / np.sqrt(16)).numpy()
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


def test_paged_parity_survives_block_free_and_reuse():
    """Free a sequence, let the LIFO allocator hand its blocks to a
    shorter successor: stale K/V past the new length stay invisible."""
    rng = np.random.default_rng(1)
    L, heads, hd, bs = 1, 4, 16, 8
    cache = PagedKVCache(L, 8, bs, heads, hd, 4)
    ta = cache.alloc_sequence(16)
    ka = torch.from_numpy(rng.standard_normal((L, 16, heads, hd)).astype(
        np.float32))
    cache.write_prompt(ta, ka, ka * 2, 16)
    cache.free_sequence(ta)
    tb = cache.alloc_sequence(9)
    assert set(tb[:2].tolist()) == set(ta[:2].tolist())  # LIFO reuse
    kb = rng.standard_normal((L, 9, heads, hd)).astype(np.float32)
    vb = rng.standard_normal((L, 9, heads, hd)).astype(np.float32)
    cache.write_prompt(tb, torch.from_numpy(kb), torch.from_numpy(vb), 9)
    q = rng.standard_normal((1, heads, hd)).astype(np.float32)
    tables, lengths = tb[None, :], np.asarray([9], np.int32)

    got = paged_attention(torch.from_numpy(q), cache.k[0], cache.v[0],
                          torch.from_numpy(tables),
                          torch.from_numpy(lengths)).numpy()
    want = _ref(q, cache.k[0].numpy(), cache.v[0].numpy(), tables, lengths)
    np.testing.assert_allclose(got, want, **TOL)
    # and from scratch: a cache holding only B's 9 tokens
    ks, vs = cache.gather_dense(tb, 9)
    np.testing.assert_array_equal(ks[0], kb[0])
    fresh_k = np.zeros((2, bs, heads, hd), np.float32)
    fresh_v = np.zeros_like(fresh_k)
    fresh_k.reshape(-1, heads, hd)[:9], fresh_v.reshape(-1, heads, hd)[:9] = \
        kb[0], vb[0]
    scratch = _ref(q, fresh_k, fresh_v, np.asarray([[0, 1]], np.int32),
                   lengths)
    np.testing.assert_allclose(got, scratch, **TOL)


def test_block_allocator_contract():
    a = BlockAllocator(5)
    got = a.alloc(3)
    assert NULL_BLOCK not in got and a.available == 1
    assert a.alloc(2) is None and a.available == 1   # all-or-nothing
    a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_paged_wrapper_rejects_mismatched_inputs():
    q, k, v, tables, lengths = map(torch.from_numpy, _slot_mix(2))
    with pytest.raises(ValueError, match="do not match"):
        paged_attention(q[:, :2], k, v, tables, lengths)
    with pytest.raises(ValueError, match="slots"):
        paged_attention(q, k, v, tables[:2], lengths)
