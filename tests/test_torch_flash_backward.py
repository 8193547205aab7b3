"""Port parity: the flash-attention autograd binding
(``distributedmnist_tpu_torch/ops/flash_attention.py FlashAttention``,
kernels K1-lse, K2, K3, K4) against the reference's custom VJP
(``distributedmnist_tpu/ops/pallas_attention.py _flash``).

On the CPU the port's Function runs its plain versions (the dense
forward with lse, the explicit FlashAttention-2 backward); the
reference runs its Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` does. The same inputs, made with
numpy from a seed, go through both at the geometries of that file
(multi-block, asymmetric blocks, ragged seq 37, one block) plus a
single-tile one. Tolerance: atol 2e-4 / rtol 2e-3 in float32, the one
that file states for its own backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.ops import pallas_attention as ref_pa
from distributedmnist_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=2e-4, rtol=2e-3)

# (causal, s, d, block_q, block_k) of the reference kernels
GEOMETRIES = [
    (True, 128, 32, 32, 32),     # multi-block both grids
    (False, 96, 16, 96, 64),     # asymmetric blocks, lcm padding
    (True, 37, 24, 16, 16),      # ragged seq + head dim: padded-row lse
    (False, 100, 64, 128, 128),  # seq not a sublane multiple, one block
    (True, 48, 32, 64, 64),      # single tile: the fused backward (K4)
]


def _inputs(s, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed + s + d)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v, and the cotangent w


def _ref_grads(q, k, v, w, causal, bq, bk):
    def f(q, k, v):
        o = ref_pa.flash_attention_bshd(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk, interpret=True)
        return jnp.sum(o * w), o

    (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in g]


def _port_grads(q, k, v, w, causal):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention_bshd(*ts, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal,s,d,bq,bk", GEOMETRIES)
def test_backward_matches_reference_vjp(causal, s, d, bq, bk):
    q, k, v, w = _inputs(s, d)
    want_o, want = _ref_grads(q, k, v, w, causal, bq, bk)
    counters = [fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_fused]
    before = [c.launches for c in counters]
    got_o, got = _port_grads(q, k, v, w, causal)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert [c.launches for c in counters] == before
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("causal,s,d,bq,bk", GEOMETRIES)
def test_lse_matches_reference_lane0(causal, s, d, bq, bk):
    """K1-lse's plain version against lane 0 of the reference's
    lane-broadcast lse ``[b, s_pad, h·128]``."""
    q, k, v, _ = _inputs(s, d)
    b, _, h, _ = q.shape
    scale = 1.0 / d ** 0.5
    _, lse = ref_pa._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, scale, bq, bk, True, save_lse=True)
    lane = ref_pa._LANE
    want = np.asarray(lse)[:, :s, ::lane].transpose(0, 2, 1)  # [b, h, s]
    o, got = fa.flash_attention_fwd_lse(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_backward_route_is_shape_only():
    """K4 exactly when the padded sequence fits one (BLOCK_Q, BLOCK_K)
    pair; the rule reads the shape alone, so CPU and GPU choose alike."""
    fit = min(fa.BLOCK_Q, fa.BLOCK_K)
    assert [fa.backward_route(s) for s in (1, fit - 1, fit, fit + 1, 1024)] \
        == ["fused", "fused", "fused", "split", "split"]
    q = torch.zeros(1, fit + 1, 2, 8)
    with pytest.raises(ValueError, match="fused backward"):
        fa.flash_attention_bwd_fused(q, q, q, q, torch.zeros(1, 2, fit + 1),
                                     q)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_float64(causal):
    """``torch.autograd.gradcheck`` of the Function in float64 (plain
    versions): the analytic FA2 backward against finite differences."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 3)))
               .requires_grad_(True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, causal, 0.7),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_grads_land_in_strided_qkv():
    """dq, dk, dv scattered into the ``[b, s, 3, d]`` qkv the model
    slices, against dense autograd through the plain forward."""
    b, s, h, d = 2, 19, 2, 8
    qkv0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, s, 3, h * d)).astype(np.float32))
    grads = []
    for attn in (fa.flash_attention_bshd, fa.flash_attention_bshd_plain):
        x = qkv0.clone().requires_grad_(True)
        q, k, v = (x[:, :, i].view(b, s, h, d) for i in range(3))
        w = torch.linspace(-1, 1, b * s * h * d).view(b, s, h, d)
        (attn(q, k, v) * w).sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_bf16_backward_close_to_reference():
    """bfloat16 inputs against the float32 reference gradient: the
    inputs and the gradients are rounded to bf16. On the CPU the plain
    versions keep p and ds in float32; on the card the tensor-core K1,
    K2, K3 and K4 round them to bf16 before their second products, like
    the reference's kernels. atol 3e-2 / rtol 1e-2 is about one bf16
    ulp at the gradients' magnitude (up to ~4 here)."""
    q, k, v, w = _inputs(64, 32, seed=9)
    _, want = _ref_grads(q, k, v, w, True, 32, 32)  # float32 reference
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    o = fa.flash_attention_bshd(*ts)
    assert o.dtype == torch.bfloat16
    (o.float() * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), r, atol=3e-2,
                                   rtol=1e-2)
