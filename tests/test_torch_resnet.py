"""ResNet-20 (``distributedmnist_tpu_torch/models/resnet.py``, the
``resnet20`` registry entry, ``models/convert.py``) against the
reference's ``models/resnet.py``, on the CPU at the model's full widths
(16/32/64, 3 blocks a stage, 32x32x3, batch 8).

* ``init`` is bitwise the reference's for two seeds, every leaf.
* Float32 logits within ``rtol 1e-5, atol 1e-5`` of the reference's —
  at 32x32 with stride-2 convolutions, where a ``padding=1`` instead of
  XLA's ``"SAME"`` ``(0, 1)`` would differ; the pads themselves equal
  ``lax.padtype_to_pads``'s.
* bf16 logits within 1e-2 of the reference's (the whole output's
  relative error: both round every layer to bf16, in other orders).
* Float32 gradients of the mean cross-entropy within 1e-4 of each
  leaf's norm.
* The param tree converts both ways (lists and the checkpoints'
  index-keyed form) leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.models import cnn as ref_cnn
from distributedmnist_tpu.models import resnet as ref_resnet
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.core.config import ModelConfig
from distributedmnist_tpu_torch.models import cnn, resnet
from distributedmnist_tpu_torch.models.convert import (params_from_reference,
                                                       params_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel.api import tree_leaves
from distributedmnist_tpu_torch.train.checkpoint import to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401

BATCH = 8


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def params():
    ref = jax.device_get(ref_resnet.init(jax.random.PRNGKey(7)))
    return ref, resnet.init(prng.PRNGKey(7))


@pytest.mark.parametrize("seed", [0, 66478])
def test_init_is_bitwise_the_reference(seed):
    want = jax.tree.leaves(ref_resnet.init(jax.random.PRNGKey(seed)))
    got = tree_leaves(resnet.init(prng.PRNGKey(seed)))
    assert len(got) == len(want) == 61
    assert sum(g.numel() for g in got) == 272282
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size,kernel,stride", [
    (32, 3, 1), (32, 3, 2), (16, 3, 2), (32, 1, 2), (15, 3, 2), (7, 1, 1)])
def test_same_pads_match_xla(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert resnet.same_pads(size, kernel, stride) == tuple(want[0])


def test_float32_logits_match_reference(params, inputs):
    ref_p, port_p = params
    x, _ = inputs
    want = np.asarray(ref_resnet.apply(ref_p, x, compute_dtype=jnp.float32))
    got = resnet.apply(port_p, torch.from_numpy(x),
                       compute_dtype=torch.float32).numpy()
    assert got.shape == (BATCH, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the registry's apply is the same function
    model = get_model(ModelConfig(name="resnet20", image_size=32,
                                  num_channels=3, compute_dtype="float32"))
    np.testing.assert_array_equal(
        model.apply(port_p, torch.from_numpy(x), train=True).numpy(), got)


def test_bfloat16_logits_match_reference(params, inputs):
    ref_p, port_p = params
    x, _ = inputs
    want = np.asarray(ref_resnet.apply(ref_p, x))
    got = resnet.apply(port_p, torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_float32_gradients_match_reference(params, inputs):
    ref_p, port_p = params
    x, y = inputs

    def ref_loss(p):
        return ref_cnn.loss_fn(ref_resnet.apply(p, x,
                                                compute_dtype=jnp.float32), y)

    want = jax.tree.leaves(jax.jit(jax.grad(ref_loss))(ref_p))
    leaves = tree_leaves(port_p)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = cnn.loss_fn(resnet.apply(port_p, torch.from_numpy(x),
                                        compute_dtype=torch.float32),
                           torch.from_numpy(y))
        got = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(ref_loss(ref_p)),
                               rtol=1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w)


def test_params_convert_both_ways(params):
    ref_p, port_p = params
    conv = params_from_reference(ref_p, device="cpu")
    assert isinstance(conv["stages"], list) and len(conv["stages"]) == 3
    assert "proj" in conv["stages"][1][0] and "proj" not in conv["stages"][1][1]
    for a, b in zip(tree_leaves(conv), tree_leaves(port_p)):
        assert torch.equal(a, b)
    back = params_to_reference(port_p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_p)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a checkpoint's state-dict form (lists keyed "0", "1", ...) too
    from flax import serialization
    sd = serialization.to_state_dict(ref_p)
    assert set(sd["stages"]) == {"0", "1", "2"}
    for a, b in zip(tree_leaves(params_from_reference(sd, device="cpu")),
                    tree_leaves(port_p)):
        assert torch.equal(a, b)
    assert list(to_state_dict(back)["stages"]["1"]["0"]) == [
        "conv1", "conv2", "norm1", "norm2", "proj"]
