"""Head sizes the kernels were not compiled for (``ops/attention.py
padded_head_dim`` / ``pad_head_dim``): on the card the flash and paged
wrappers zero-pad q, k, v (and do, and the pages) along head_dim to the
next compiled size, keep the scale of the true head_dim, and slice the
outputs back. Here the same pad and slice run in front of the plain
versions, which take any size, and must give the unpadded result
(float32, ``atol 1e-6``) at head_dim 8, 16, 96 and 200.
"""

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.ops import flash_attention as fa
from distributedmnist_tpu_torch.ops import paged_attention as pa
from distributedmnist_tpu_torch.ops.attention import (pad_head_dim,
                                                      padded_head_dim)

TOL = dict(atol=1e-6, rtol=0)
SIZES = (8, 16, 96, 200)


def _qkv(d, s=37, b=2, h=3, seed=0):
    g = torch.Generator().manual_seed(seed + d)
    return [torch.randn(b, s, h, d, generator=g) for _ in range(3)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_padded_sizes():
    assert [padded_head_dim(d, (32, 64, 128, 256)) for d in SIZES] == \
        [32, 32, 128, 256]
    assert padded_head_dim(128, (32, 64, 128)) == 128
    with pytest.raises(ValueError, match="larger than"):
        padded_head_dim(200, (32, 64, 128))
    x = torch.ones(2, 5)
    assert pad_head_dim(x, 5) is x
    assert pad_head_dim(x, 8)[:, 5:].abs().sum() == 0


@pytest.mark.parametrize("d", SIZES)
@pytest.mark.parametrize("causal", [True, False])
def test_padded_forward_equals_unpadded(d, causal):
    q, k, v = _qkv(d)
    size = padded_head_dim(d, fa._HEAD_DIMS)
    scale = 1.0 / d ** 0.5
    qp, kp, vp = (pad_head_dim(x, size) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_lse_plain(qp, kp, vp, causal=causal,
                                              scale=scale)
    want_o, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v,
                                                        causal=causal)
    _close(o[..., :d], want_o)
    _close(lse, want_lse)
    assert o[..., d:].abs().max() == 0


@pytest.mark.parametrize("d", SIZES)
def test_padded_backward_equals_unpadded(d):
    q, k, v = _qkv(d, seed=1)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d))
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    # 200 is past the backward's compiled sizes: pad to the forward's
    size = padded_head_dim(d, fa._BWD_HEAD_DIMS if d <= 128
                           else fa._HEAD_DIMS)
    padded = [pad_head_dim(x, size) for x in (q, k, v, o, do)]
    got = fa.flash_attention_bwd_plain(*padded[:4], lse, padded[4],
                                       scale=1.0 / d ** 0.5)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        _close(g[..., :d], w)
        assert g[..., d:].abs().max() == 0


@pytest.mark.parametrize("d", SIZES)
def test_padded_paged_equals_unpadded(d):
    g = torch.Generator().manual_seed(d)
    slots, heads, bs, nblocks = 4, 2, 8, 12
    q = torch.randn(slots, heads, d, generator=g)
    kp = torch.randn(nblocks, bs, heads, d, generator=g)
    vp = torch.randn(nblocks, bs, heads, d, generator=g)
    tables = torch.randint(1, nblocks, (slots, 3), generator=g,
                           dtype=torch.int32)
    lengths = torch.tensor([1, 9, 24, 0], dtype=torch.int32)
    size = padded_head_dim(d, pa._HEAD_DIMS)
    got = pa.paged_attention_dense(
        *(pad_head_dim(x, size) for x in (q, kp, vp)), tables, lengths,
        scale=1.0 / d ** 0.5)
    want = pa.paged_attention_dense(q, kp, vp, tables, lengths)
    _close(got[..., :d], want)
