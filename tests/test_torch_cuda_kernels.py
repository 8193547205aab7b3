"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs (K1, K1-lse, K2, K3 and K4
``ops/flash_attention.py``, K5 ``ops/paged_attention.py``).

Every test here needs an NVIDIA GPU and skips with a reason without
one. The module imports torch and numpy only — no JAX — so it also
runs where the reference is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda \\
        --noconftest -p no:cacheprovider

Tolerances: float32 1e-4 (summation order only); bfloat16 outputs of
K1-K4 atol 3e-2 / rtol 1e-2 (one bf16 ulp where the two versions round
differently); K5 outputs and every lse are float32 computed from the
same inputs, 1e-4.
"""

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.ops import flash_attention as fa
from distributedmnist_tpu_torch.ops.flash_attention import (
    flash_attention_bshd, flash_attention_bshd_plain)
from distributedmnist_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_dense)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", [(1, 128, True), (37, 64, True),
                                        (64, 32, True), (130, 128, True),
                                        (100, 256, True), (77, 64, False)])
def test_flash_kernel_matches_plain(dev, dtype, tol, s, d, causal):
    b, h = 2, 4
    g = torch.Generator(device=dev).manual_seed(s * d)
    qkv = torch.randn(b, s, 3, h * d, generator=g, device=dev).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, s, h, d) for i in range(3))  # strided
    before = flash_attention_bshd.launches
    got = flash_attention_bshd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    _close(got, flash_attention_bshd_plain(q, k, v, causal=causal), tol)


def test_flash_kernel_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 8, 2, 16, device=dev)  # head_dim 16: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bshd(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_bshd(q, q, q)
    q = torch.zeros(1, 8, 32, 2, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last"):
        flash_attention_bshd(q, q, q)


def _paged_inputs(dev, q_dtype, kv_dtype, hd=128, bs=16, heads=4):
    g = torch.Generator(device=dev).manual_seed(hd + bs)
    nblocks, width = 40, 10
    kp = torch.randn(nblocks, bs, heads, hd, generator=g,
                     device=dev).to(kv_dtype)
    vp = torch.randn(nblocks, bs, heads, hd, generator=g,
                     device=dev).to(kv_dtype)
    kp[0], vp[0] = 37.0, -53.0  # poisoned null block
    lengths = [1, bs - 1, bs, bs + 1, 3 * bs + 5, width * bs, 0]
    tables = torch.zeros(len(lengths), width, dtype=torch.int32)
    order = torch.randperm(nblocks - 1,
                           generator=torch.Generator().manual_seed(0)) + 1
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-n // bs)
        tables[i, :nb] = order[used:used + nb].int()
        used += nb
    qkv = torch.randn(len(lengths), 3, heads * hd, generator=g,
                      device=dev).to(q_dtype)
    return (qkv[:, 0].view(len(lengths), heads, hd), kp, vp,
            tables.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                         device=dev))


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("hd,bs", [(128, 16), (64, 8), (32, 48)])
def test_paged_kernel_matches_plain(dev, q_dtype, kv_dtype, hd, bs):
    args = _paged_inputs(dev, q_dtype, kv_dtype, hd=hd, bs=bs)
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert got.dtype == torch.float32
    _close(got, paged_attention_dense(*args), F32)
    idle = args[4] == 0
    assert torch.count_nonzero(got[idle]).item() == 0


def test_paged_kernel_refuses_what_it_cannot_take(dev):
    q, kp, vp, tables, lengths = _paged_inputs(dev, torch.float32,
                                               torch.float32)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="contiguous k/v"):
        paged_attention(q, kp.transpose(0, 1).contiguous().transpose(0, 1),
                        vp, tables, lengths)


def _strided_qkv(dev, dtype, b, s, h, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h * d, generator=g, device=dev).to(dtype)
    return qkv, [qkv[:, :, i].view(b, s, h, d) for i in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", [(1, 128, True), (37, 64, True),
                                        (130, 128, True), (100, 256, True),
                                        (77, 32, False)])
def test_flash_lse_kernel_matches_plain(dev, dtype, tol, s, d, causal):
    _, (q, k, v) = _strided_qkv(dev, dtype, 2, s, 4, d, s + d)
    before = fa.flash_attention_fwd_lse.launches
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_lse.launches == before + 1
    assert lse.shape == (2, 4, s) and lse.dtype == torch.float32
    want_o, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v,
                                                        causal=causal)
    _close(o, want_o, tol)
    _close(lse, want_lse, F32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", [(1, 128, True), (37, 64, True),
                                        (64, 128, True), (65, 128, True),
                                        (200, 128, True), (130, 32, False),
                                        (50, 64, False)])
def test_flash_backward_kernels_match_plain(dev, dtype, tol, s, d, causal):
    """K4 for s <= 64, else K2 + K3, on the same inputs as the plain
    backward (whose lse and o come from the plain forward)."""
    _, (q, k, v) = _strided_qkv(dev, dtype, 2, s, 4, d, 7 * s + d)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v, causal=causal)
    do = torch.randn(o.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(s)
                     ).to(dtype)
    counters = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_fused)
    before = [c.launches for c in counters]
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    grew = [c.launches - b for c, b in zip(counters, before)]
    assert grew == ([0, 0, 1] if fa.backward_route(s) == "fused"
                    else [1, 1, 0])
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for g_, w_, x in zip(got, want, (q, k, v)):
        assert g_.dtype == x.dtype and g_.shape == x.shape
        _close(g_, w_, tol)


@pytest.mark.parametrize("s", [48, 300])
def test_flash_autograd_grads_land_in_strided_qkv(dev, s):
    """Gradients through the Function into the [b, s, 3, d] qkv the
    model slices, against dense autograd of the plain forward."""
    qkv, _ = _strided_qkv(dev, torch.float32, 2, s, 4, 64, s)
    b, h, d = 2, 4, 64
    grads, outs = [], []
    for attn in (flash_attention_bshd, flash_attention_bshd_plain):
        x = qkv.detach().clone().requires_grad_(True)
        q, k, v = (x[:, :, i].view(b, s, h, d) for i in range(3))
        before = fa.flash_attention_fwd_lse.launches
        o = attn(q, k, v)
        if attn is flash_attention_bshd:
            assert fa.flash_attention_fwd_lse.launches == before + 1
        w = torch.linspace(-1, 1, o.numel(), device=dev).view(o.shape)
        (o * w).sum().backward()
        grads.append(x.grad)
        outs.append(o.detach())
    torch.cuda.synchronize()
    _close(outs[0], outs[1], F32)
    _close(grads[0], grads[1], dict(atol=2e-4, rtol=2e-4))


def test_flash_backward_refuses_what_it_cannot_take(dev):
    _, (q, k, v) = _strided_qkv(dev, torch.float32, 1, 8, 2, 256, 0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.FlashAttention.apply(q.detach().requires_grad_(), k, v, True,
                                0.0625)
    _, (q, k, v) = _strided_qkv(dev, torch.float32, 1, 65, 2, 64, 0)
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="fused backward"):
        fa.flash_attention_bwd_fused(q, k, v, o, lse, o)
