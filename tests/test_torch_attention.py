"""Port parity: attention (``distributedmnist_tpu_torch/ops/attention.py``
and ``ops/flash_attention.py``, kernel K1) against the reference.

On the CPU the port's ``flash_attention_bshd`` runs its plain version;
the reference's runs its Pallas kernel in interpret mode, as
``tests/test_pallas_attention.py`` runs it. Inputs come from numpy with
a seed and go to both. Tolerances:

* float32: 1e-5 (both compute scores/softmax in float32; only the
  summation order differs — blockwise online softmax vs one pass);
* bfloat16 inputs: atol 2e-2 / rtol 1e-2 — outputs are bfloat16 (one
  ulp is 2^-7 relative), and the reference rounds P to bfloat16 before
  its P.V product where the port keeps float32.

The CUDA kernel itself is held against the plain version on the card
in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.ops.pallas_attention import \
    flash_attention_bshd as ref_flash_bshd
from distributedmnist_tpu.ops.ring_attention import \
    local_self_attention as ref_local
from distributedmnist_tpu_torch.ops.attention import local_self_attention
from distributedmnist_tpu_torch.ops.flash_attention import \
    flash_attention_bshd

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=1e-2)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [13, 40, 64])
def test_flash_bshd_matches_reference_kernel_f32(s):
    q, k, v = _qkv(s, (2, s, 4, 16))
    want = np.asarray(ref_flash_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True))
    before = flash_attention_bshd.launches
    got = flash_attention_bshd(*map(torch.from_numpy, (q, k, v)))
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert flash_attention_bshd.launches == before
    assert got.dtype == torch.float32 and got.shape == (2, s, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("s", [13, 40, 64])
def test_flash_bshd_matches_reference_kernel_bf16(s):
    q, k, v = _qkv(100 + s, (2, s, 4, 16))
    want = ref_flash_bshd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = flash_attention_bshd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_flash_bshd_non_causal_and_strided_inputs():
    """The model hands the kernel ``qkv[:, :, i]`` views: strided
    inputs must give the same answer as contiguous ones."""
    b, s, h, d = 1, 24, 4, 16
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((b, s, 3, h * d)).astype(np.float32)
    q, k, v = (qkv[:, :, i].reshape(b, s, h, d) for i in range(3))
    want = np.asarray(ref_flash_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False))
    t = torch.from_numpy(qkv)
    views = [t[:, :, i].view(b, s, h, d) for i in range(3)]
    assert not views[0].is_contiguous()
    got = flash_attention_bshd(*views, causal=False)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_local_self_attention_matches_reference(causal):
    q, k, v = _qkv(3, (2, 4, 19, 16))   # [b, h, s, d]
    want = np.asarray(ref_local(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    got = local_self_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_flash_wrapper_rejects_what_no_version_takes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention_bshd(q, q, torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention_bshd(q, q, q.double())
    m = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bshd(m, m, m)
