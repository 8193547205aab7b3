"""The port's MNIST CNN (``models/cnn.py``, the ``mnist_cnn`` registry
entry) and image datasets against the reference's.

* ``init`` draws the reference's params bitwise from the same key (the
  port's truncated normal is bitwise, ``tests/test_torch_prng.py``).
* From the same params: logits, loss and every gradient in float32 at
  ``rtol 1e-5`` (``atol`` 1e-6 of the tensor's largest value: the two
  sum convolutions in other orders), with and without dropout — the
  same key draws the same mask. In bfloat16 both round activations and
  products to bf16 at the same points but convolve with other
  accumulation orders: logits agree to 2e-2 (elementwise, of their
  scale), weight gradients to 1e-2 of their norm (5e-3 measured), and
  bias gradients — each a sum of bf16 cotangents over every position,
  with cancellation — to 1e-1 of theirs (5.7e-2 measured on conv1).
* ``predictions``, the eval sums, "SAME" pooling at odd sizes, the idx
  reader on the reference's fixture files, and ``make_synthetic``
  (bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ModelConfig as RefModelConfig
from distributedmnist_tpu.data import datasets as ref_data
from distributedmnist_tpu.data.fixtures import materialize_idx_fixture
from distributedmnist_tpu.models import cnn as ref_cnn
from distributedmnist_tpu.models import registry as ref_registry
from distributedmnist_tpu_torch.core import prng
from distributedmnist_tpu_torch.core.config import DataConfig, ModelConfig
from distributedmnist_tpu_torch.data import datasets
from distributedmnist_tpu_torch.models import cnn
from distributedmnist_tpu_torch.models.convert import (params_from_reference,
                                                       params_to_reference)
from distributedmnist_tpu_torch.models.registry import (
    classification_eval_metrics, get_model)

from _torch_threads import one_torch_thread  # noqa: F401


def _batch(n=12, size=28, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, size, size, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel / 10 * np.abs(want).max())


@pytest.fixture(scope="module")
def ref_params():
    return ref_cnn.init(jax.random.PRNGKey(66478))


def test_init_is_the_reference_init():
    """At 12x12 images (fc1 576 x 512), through both spellings."""
    want = ref_cnn.init(jax.random.PRNGKey(66478), image_size=12)
    got = params_to_reference(cnn.init(prng.PRNGKey(66478), image_size=12))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    model = get_model(ModelConfig(name="mnist_cnn", image_size=12))
    seeded = params_to_reference(model.init_params(66478, "cpu"))
    for g, w in zip(jax.tree.leaves(seeded), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def _both(params, x, y, dtype, train):
    """(logits, loss, grads) from each package."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    key = jax.random.PRNGKey(9)

    def ref_loss(p):
        logits = ref_cnn.apply(p, jnp.asarray(x), train=train,
                               dropout_key=key if train else None,
                               compute_dtype=jdt)
        return ref_cnn.loss_fn(logits, jnp.asarray(y)), logits

    (rl, rlogits), rg = jax.value_and_grad(ref_loss, has_aux=True)(params)
    pp = params_from_reference(jax.device_get(params), device="cpu")
    leaves = [pp[k][n] for k in sorted(pp) for n in sorted(pp[k])]
    for t in leaves:
        t.requires_grad_(True)
    keep = cnn.dropout_mask(prng.PRNGKey(9), (x.shape[0], cnn.HIDDEN), 0.5)
    logits = cnn.apply(pp, torch.from_numpy(x), train=train,
                       dropout_keep=keep if train else None,
                       compute_dtype=tdt)
    loss = cnn.loss_fn(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    return ((logits.detach(), rlogits), (loss.detach(), rl),
            list(zip(grads, jax.tree.leaves(rg))))


@pytest.mark.parametrize("train", [False, True])
def test_float32_logits_loss_grads_match(ref_params, train):
    x, y = _batch()
    (lg, rlg), (l, rl), grads = _both(ref_params, x, y, "float32", train)
    _close(lg, rlg, 1e-5)
    _close(l, rl, 1e-5)
    for g, w in grads:
        _close(g, w, 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_bfloat16_logits_loss_grads_match(ref_params, train):
    x, y = _batch(seed=1)
    (lg, rlg), (l, rl), grads = _both(ref_params, x, y, "bfloat16", train)
    _close(lg.float(), np.asarray(rlg, np.float32), 2e-2)
    _close(l, rl, 2e-2)
    for g, w in grads:  # leaves in sorted order: b, w per layer
        w32 = np.asarray(w, np.float32)
        tol = 1e-1 if w32.ndim == 1 else 1e-2
        assert (np.linalg.norm(g.float().numpy() - w32)
                <= tol * np.linalg.norm(w32))


def test_dropout_masks_are_the_references():
    shape = (8, 512)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, shape))
    np.testing.assert_array_equal(
        cnn.dropout_mask(prng.PRNGKey(4), shape, 0.5).numpy(), want)


def test_predictions_and_eval_sums(ref_params):
    x, y = _batch(n=9, seed=2)
    pp = params_from_reference(jax.device_get(ref_params), device="cpu")
    logits = cnn.apply(pp, torch.from_numpy(x), compute_dtype=torch.float32)
    rlogits = ref_cnn.apply(ref_params, jnp.asarray(x),
                            compute_dtype=jnp.float32)
    _close(cnn.predictions(logits), ref_cnn.predictions(rlogits), 1e-5)
    _close(cnn.accuracy(logits, torch.from_numpy(y)),
           ref_cnn.accuracy(rlogits, jnp.asarray(y)), 1e-6)
    w = np.array([1.0] * 7 + [0.0] * 2, np.float32)
    got = classification_eval_metrics(logits, torch.from_numpy(y),
                                      torch.from_numpy(w))
    want = ref_registry.classification_eval_metrics(
        rlogits, jnp.asarray(y), jnp.asarray(w))
    for g_, w_ in zip(got, want):
        _close(g_, w_, 1e-5)


def test_registry_entry_matches_reference():
    cfg = dict(name="mnist_cnn", image_size=12, compute_dtype="float32",
               dropout_rate=0.25)
    port = get_model(ModelConfig(**cfg))
    ref = ref_registry.get_model(RefModelConfig(**cfg))
    assert port.dropout_masks is not None and port.vmap_replicas
    params = ref.init(jax.random.PRNGKey(1))
    x, y = _batch(n=4, size=12, seed=3)
    want = ref.apply(params, jnp.asarray(x), train=True,
                     dropout_key=jax.random.PRNGKey(2))
    got = port.apply(params_from_reference(jax.device_get(params),
                                           device="cpu"),
                     torch.from_numpy(x), train=True,
                     dropout_keep=port.dropout_masks(prng.PRNGKey(2), 4,
                                                     "cpu"))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype,deterministic",
                         [("float32", True), ("bfloat16", False)])
def test_cudnn_policy_is_scoped_to_each_step(monkeypatch, dtype,
                                             deterministic):
    """Building the model and the steps changes no cuDNN setting; each
    train and eval step runs its convolutions under the step's policy
    (deterministic algorithms as asked; no TF32 in float32) and restores
    the settings after it."""
    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.parallel import api
    from distributedmnist_tpu_torch.train import lr_schedule
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", not deterministic)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    cfg = ExperimentConfig.from_dict(
        {"model": {"name": "mnist_cnn", "image_size": 12,
                   "compute_dtype": dtype},
         "data": {"dataset": "synthetic", "batch_size": 4},
         "mesh": {"num_replicas": 2}, "sync": {"mode": "sync"}})
    model = get_model(cfg.model)
    step = api.build_train_step(model, cfg, lr_schedule.constant(0.1),
                                cudnn_deterministic=deterministic)
    evaluate = api.build_eval_step(model, cfg,
                                   cudnn_deterministic=deterministic)
    assert (cudnn.deterministic, cudnn.allow_tf32) == (not deterministic,
                                                       True)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def probe(*args, **kwargs):
        seen.append((cudnn.deterministic, cudnn.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", probe)
    x, y = _batch(n=4, size=12, seed=5)
    state = api.init_train_state(model, cfg, torch.device("cpu"))
    step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    evaluate(state.params, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(y),
                            "weight": torch.ones(4)})
    want = (deterministic, dtype != "float32")
    assert len(seen) == 4 and all(s == want for s in seen)
    assert (cudnn.deterministic, cudnn.allow_tf32) == (not deterministic,
                                                       True)


def test_odd_sizes_pool_like_same_padding():
    """A 2x2/2 "SAME" pool over an odd size pads one -inf row/column."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    w = (rng.normal(size=(5, 5, 3, 4)) * 0.2).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = ref_cnn._maxpool2(jax.nn.relu(ref_cnn._conv2d_same(x, w) + b))
    got = cnn._conv_relu_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == (2, 4, 4, 5)
    _close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_idx_reader_matches_reference_on_fixture_files(tmp_path):
    root = materialize_idx_fixture(tmp_path / "mnist", num_train=300,
                                   num_test=50)
    got = datasets.load_datasets(DataConfig(dataset="mnist",
                                            data_dir=str(tmp_path)))
    want = ref_data.load_idx_dataset(root)
    for split in ("train", "validation", "test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    path = datasets.write_idx_ubyte(tmp_path / "x-idx1-ubyte.gz",
                                    np.arange(7, dtype=np.uint8))
    np.testing.assert_array_equal(ref_data.read_idx_labels(path),
                                  datasets.read_idx_labels(path))


def test_make_synthetic_is_bitwise():
    got = datasets.make_synthetic(200, 64, image_size=20, num_channels=2,
                                  seed=3)
    want = ref_data.make_synthetic(200, 64, image_size=20, num_channels=2,
                                   seed=3)
    for split in ("train", "validation", "test"):
        np.testing.assert_array_equal(getattr(got, split).images,
                                      getattr(want, split).images)
        np.testing.assert_array_equal(getattr(got, split).labels,
                                      getattr(want, split).labels)
