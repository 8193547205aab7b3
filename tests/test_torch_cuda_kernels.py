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
differently; the tensor-core kernels also round p and ds to bf16
before their second products, as the TPU kernels do, which moves an
output by well under that); K5 outputs and every lse are float32
computed from the same inputs, 1e-4.

``EDGES`` walks the tensor-core kernels' tile edges: sequence lengths
around the 64-row tiles (and the 128-row forward tile), every head_dim,
causal and not, always through strided ``qkv[:, :, i]`` views;
``FUSED_EDGES`` does the same inside K4's one 64-row tile. K5 is held
at the edges of its cluster splits (``_split_edges``), with a ring that
wraps, 64 slots, every (q, page) dtype pair and head_dim, poisoned dead
positions, and bitwise-equal repeated calls.
"""

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.ops import flash_attention as fa
from distributedmnist_tpu_torch.ops import paged_attention as pa
from distributedmnist_tpu_torch.ops.flash_attention import (
    flash_attention_bshd, flash_attention_bshd_plain)
from distributedmnist_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_dense)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)

pytestmark = pytest.mark.cuda

# (s, head_dim, causal) at the tiles' edges; K2-K4 take head_dim <= 128
EDGES = [(s, d, c) for s in (1, 63, 64, 65, 127, 128, 129, 1000)
         for d in (32, 64, 128, 256) for c in (True, False)]
BWD_EDGES = [e for e in EDGES if e[1] <= 128]
FUSED_EDGES = [(s, d, c) for s in (1, 17, 33, 63, 64) for d in (32, 64, 128)
               for c in (True, False)]


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
                                        (100, 256, True), (77, 64, False)]
                         + EDGES)
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


# K5 splits each slot's table over a cluster of SPLITS blocks, block c
# taking table entries [c * P, (c + 1) * P), P = ceil(width / SPLITS)
SPLITS = 8
PAGE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
HEAD_DIMS = (32, 64, 128, 256)


def _split_edges(bs, width):
    """Lengths at every edge of K5's splits: one position, a block, a
    split (P blocks), all splits, the full table, and an idle slot."""
    p = -(-width // SPLITS)
    edges = [1, bs - 1, bs, bs + 1, p * bs - 1, p * bs, p * bs + 1,
             SPLITS * p * bs, width * bs, 0]
    return sorted({n for n in edges if 0 <= n <= width * bs}, reverse=True)


def _paged_inputs(dev, q_dtype, kv_dtype, hd=128, bs=16, heads=4,
                  width=10, lengths=None, seed=0):
    """Strided q, pages and tables for ``lengths`` (by default the old
    mix of fresh, partial, full-table and idle slots). The null block and
    every position past a slot's length in its last block are poisoned,
    so a read of either breaks the agreement."""
    if lengths is None:
        lengths = [1, bs - 1, bs, bs + 1, 3 * bs + 5, width * bs, 0]
    g = torch.Generator(device=dev).manual_seed(hd + bs + seed)
    nblocks = 1 + sum(-(-n // bs) for n in lengths) + 3
    kp = torch.randn(nblocks, bs, heads, hd, generator=g,
                     device=dev).to(kv_dtype)
    vp = torch.randn(nblocks, bs, heads, hd, generator=g,
                     device=dev).to(kv_dtype)
    kp[0], vp[0] = 37.0, -53.0  # poisoned null block
    tables = torch.zeros(len(lengths), width, dtype=torch.int32)
    order = torch.randperm(nblocks - 1,
                           generator=torch.Generator().manual_seed(seed)) + 1
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-n // bs)
        tables[i, :nb] = order[used:used + nb].int()
        used += nb
        if n % bs:  # the last block's dead tail
            last = int(tables[i, nb - 1])
            kp[last, n % bs:], vp[last, n % bs:] = 37.0, -53.0
    qkv = torch.randn(len(lengths), 3, heads * hd, generator=g,
                      device=dev).to(q_dtype)
    return (qkv[:, 0].view(len(lengths), heads, hd), kp, vp,
            tables.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                         device=dev))


def _paged_check(args):
    """One launch against the plain version; idle slots exactly zero."""
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert got.dtype == torch.float32
    _close(got, paged_attention_dense(*args), F32)
    idle = args[4] == 0
    assert torch.count_nonzero(got[idle]).item() == 0
    return got


@pytest.mark.parametrize("q_dtype,kv_dtype", PAGE_PAIRS)
@pytest.mark.parametrize("hd,bs", [(128, 16), (64, 8), (32, 48), (256, 16)])
def test_paged_kernel_matches_plain(dev, q_dtype, kv_dtype, hd, bs):
    _paged_check(_paged_inputs(dev, q_dtype, kv_dtype, hd=hd, bs=bs))


@pytest.mark.parametrize("q_dtype,kv_dtype", PAGE_PAIRS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("bs,width", [(16, 24), (16, 20), (8, 36), (5, 13)])
def test_paged_kernel_at_split_edges(dev, q_dtype, kv_dtype, hd, bs, width):
    """Lengths at every split edge, for widths that split evenly and
    not, block sizes that fill a shared-memory stage and not."""
    _paged_check(_paged_inputs(dev, q_dtype, kv_dtype, hd=hd, bs=bs,
                               heads=2, width=width,
                               lengths=_split_edges(bs, width)))


@pytest.mark.parametrize("q_dtype,kv_dtype", PAGE_PAIRS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_paged_kernel_wraps_its_ring(dev, q_dtype, kv_dtype, hd):
    """A table of 160 blocks of 16: each block's 20 entries (320
    positions) outrun its ring of at most 8 stages, which wraps."""
    bs, width = 16, 160
    _paged_check(_paged_inputs(dev, q_dtype, kv_dtype, hd=hd, bs=bs,
                               heads=2, width=width,
                               lengths=[width * bs, 1000, 321, 0]))


@pytest.mark.parametrize("q_dtype,kv_dtype", PAGE_PAIRS)
@pytest.mark.parametrize("hd", (64, 128))
def test_paged_kernel_with_64_slots(dev, q_dtype, kv_dtype, hd):
    bs, width = 16, 36
    rng = np.random.default_rng(hd)
    lengths = rng.integers(0, width * bs + 1, 64).tolist()
    lengths[:3] = [0, 1, width * bs]
    _paged_check(_paged_inputs(dev, q_dtype, kv_dtype, hd=hd, bs=bs,
                               width=width, lengths=lengths))


@pytest.mark.parametrize("q_dtype,kv_dtype", PAGE_PAIRS)
def test_paged_kernel_is_deterministic(dev, q_dtype, kv_dtype):
    """10 calls give bitwise-equal outputs: each cluster merges its
    blocks' states in a fixed order, no atomics."""
    args = _paged_inputs(dev, q_dtype, kv_dtype, bs=16, width=36,
                         lengths=[544, 285, 124, 86, 51, 37, 21, 0])
    first = paged_attention(*args)
    for _ in range(9):
        assert torch.equal(paged_attention(*args), first)


def test_paged_kernel_route_and_occupancy(dev):
    """Every supported pair takes the cluster-split kernel; the runtime
    reports its launch at the decode path's shape."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in HEAD_DIMS:
            assert pa.kernel_route(dtype, hd) == "cluster_split"
    with pytest.raises(ValueError, match="no kernel"):
        pa.kernel_route(torch.bfloat16, 96)
    occ = pa.kernel_occupancy(torch.bfloat16, torch.bfloat16, 8, 16, 128,
                              16, 36)
    assert occ["cluster_size"] == SPLITS and occ["threads"] == 128
    # 5 stages of 16 positions (8 KB each) and the block's 5 table entries
    assert occ["smem_bytes"] == 5 * 8192 + 32
    assert occ["clusters_resident"] > 0


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
                                        (77, 32, False)] + EDGES)
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


def _bwd_inputs(dev, dtype, s, d, causal):
    """Strided q, k, v, the plain forward's o and lse, and a cotangent."""
    _, (q, k, v) = _strided_qkv(dev, dtype, 2, s, 4, d, 3 * s + d)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v, causal=causal)
    do = torch.randn(o.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(d)
                     ).to(dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", BWD_EDGES)
def test_flash_dq_kernel_matches_plain(dev, dtype, tol, s, d, causal):
    """K2 alone at every tile edge, against the plain backward's dq."""
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, s, d, causal)
    before = fa.flash_attention_bwd_dq.launches
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dq.launches == before + 1
    assert dq.dtype == dtype and dq.shape == q.shape
    want_dq, _, _ = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal=causal)
    _close(dq, want_dq, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", BWD_EDGES)
def test_flash_dkv_kernel_matches_plain(dev, dtype, tol, s, d, causal):
    """K3 alone at every tile edge, against the plain backward."""
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, s, d, causal)
    before = fa.flash_attention_bwd_dkv.launches
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches == before + 1
    _, want_dk, want_dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       causal=causal)
    _close(dk, want_dk, tol)
    _close(dv, want_dv, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("s,d,causal", FUSED_EDGES)
def test_flash_fused_kernel_matches_plain(dev, dtype, tol, s, d, causal):
    """K4 alone inside its one tile, against the plain backward."""
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, s, d, causal)
    before = fa.flash_attention_bwd_fused.launches
    got = fa.flash_attention_bwd_fused(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_fused.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for g_, w_ in zip(got, want):
        _close(g_, w_, tol)


@pytest.mark.parametrize("kernel,s", [("K2", 1000), ("K3", 1000),
                                      ("K4", 63)])
def test_flash_dkv_kernel_is_deterministic(dev, kernel, s):
    """The same bf16 call of K2, K3 or K4 twice gives bitwise equal
    gradients: each block owns its output tile, no atomics."""
    fn = {"K2": fa.flash_attention_bwd_dq, "K3": fa.flash_attention_bwd_dkv,
          "K4": fa.flash_attention_bwd_fused}[kernel]
    args = _bwd_inputs(dev, torch.bfloat16, s, 128, True)
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if kernel == "K2":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_calls_take_the_tensor_cores(dev):
    """At head_dim 128, every bf16 flash kernel (K1, K1-lse, K2, K3, K4)
    launches its wgmma kernel; float32 calls the CUDA-core kernels."""
    for kernel in ("K1", "K1-lse", "K2", "K3", "K4"):
        assert fa.kernel_route(kernel, torch.bfloat16, 128) == "wgmma"
        assert fa.kernel_route(kernel, torch.float32, 128) == "cuda_cores"
    with pytest.raises(ValueError, match="no kernel"):
        fa.kernel_route("K3", torch.bfloat16, 256)


def test_bf16_kernels_refuse_misaligned_rows(dev):
    """The tensor-core kernels read 16-byte rows; a bf16 view whose rows
    are not 16-byte aligned is refused, not copied."""
    x = torch.zeros(1, 8, 2 * 32 + 4, device=dev, dtype=torch.bfloat16)
    q = x[:, :, 4:].view(1, 8, 2, 32)  # 8-byte offset
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bshd(q, q, q)


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
