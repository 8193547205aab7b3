"""Port parity: the data path (``distributedmnist_tpu_torch/data``)
against the reference's (``distributedmnist_tpu/data``).

``synthetic_lm`` tokens, the train stream's batch order across epoch
boundaries and the eval batches are bitwise the reference's; a cursor
saved by either package resumes the same stream in the other.
"""

import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import DataConfig as RefDataConfig
from distributedmnist_tpu.data import datasets as ref_ds
from distributedmnist_tpu.data import pipeline as ref_pipe
from distributedmnist_tpu_torch.core.config import DataConfig
from distributedmnist_tpu_torch.data import datasets, pipeline


def _lm(num_train=70, num_test=20, seq_len=12, vocab=16, seed=3):
    return (datasets.make_synthetic_lm(num_train, num_test, seq_len, vocab,
                                       seed=seed),
            ref_ds.make_synthetic_lm(num_train, num_test, seq_len, vocab,
                                     seed=seed))


def test_synthetic_lm_is_bitwise_the_reference():
    port, ref = _lm()
    for split in ("train", "validation", "test"):
        a, b = getattr(port, split), getattr(ref, split)
        assert a.images.dtype == b.images.dtype == np.int32
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    cfg = {"dataset": "synthetic_lm", "synthetic_train_size": 64,
           "synthetic_test_size": 32}
    got = datasets.load_datasets(DataConfig(**cfg), seq_len=8, vocab_size=5)
    want = ref_ds.load_datasets(RefDataConfig(**cfg), seq_len=8,
                                vocab_size=5)
    np.testing.assert_array_equal(got.test.images, want.test.images)


@pytest.mark.parametrize("batch,shard_mode", [(16, "sharded"),
                                              (24, "independent")])
def test_batch_order_is_bitwise_across_epochs(batch, shard_mode):
    port, ref = _lm()
    a = pipeline.BatchIterator(port.train, batch, seed=11,
                               shard_mode=shard_mode)
    b = ref_pipe.BatchIterator(ref.train, batch, seed=11,
                               shard_mode=shard_mode)
    n = 3 * a.batches_per_epoch + 1   # crosses three epoch boundaries
    for _ in range(n):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["label"], y["label"])
    assert a.epoch == b.epoch == 3
    assert a.state() == b.state()


def test_cursor_resume_continues_the_stream_in_both_packages():
    port, ref = _lm()
    straight = pipeline.BatchIterator(port.train, 16, seed=5)
    want = [next(straight)["image"] for _ in range(9)]
    # the port resumes a reference cursor, the reference a port cursor
    r = ref_pipe.BatchIterator(ref.train, 16, seed=5)
    for _ in range(3):
        next(r)
    p = pipeline.BatchIterator(port.train, 16, seed=5)
    p.restore(r.state())
    got = [next(p)["image"] for _ in range(3)]
    r2 = ref_pipe.BatchIterator(ref.train, 16, seed=5)
    r2.restore(p.state())
    got += [next(r2)["image"] for _ in range(3)]
    for g, w in zip(got, want[3:]):
        np.testing.assert_array_equal(g, w)
    # a cursor from another world reassigns through the batch count
    other = dict(r2.state(), world={"num_hosts": 1, "host_id": 0,
                                    "batch_size": 8}, batches=6)
    p.restore(other)
    np.testing.assert_array_equal(next(p)["image"], want[6])
    with pytest.raises(ValueError, match="pipeline"):
        p.restore({"impl": "native", "epoch": 0, "pos": 0})


def test_eval_batches_are_the_reference_padding():
    port, ref = _lm()
    got = list(pipeline.eval_batches(port.test, 8))
    want = list(ref_pipe.eval_batches(ref.test, 8))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("image", "label", "weight"):
            np.testing.assert_array_equal(g[key], w[key])
    assert got[-1]["weight"].tolist() == [1.0] * 4 + [0.0] * 4


def test_make_train_iterator_and_device_copy():
    port, _ = _lm()
    cfg = DataConfig(dataset="synthetic_lm", batch_size=10)
    it = pipeline.make_train_iterator(port.train, cfg, seed=0)
    # the reference's own choice for this config on this host: its C++
    # loader's order with a spare core, else the numpy order (C15)
    ref_it = ref_pipe.make_train_iterator(
        port.train, RefDataConfig(dataset="synthetic_lm", batch_size=10),
        seed=0)
    want = next(ref_it)
    getattr(ref_it, "close", lambda: None)()
    b = pipeline.to_device(next(it), torch.device("cpu"))
    assert b["image"].dtype == torch.int32 and b["image"].shape == (10, 12)
    np.testing.assert_array_equal(b["image"].numpy(), want["image"])


def test_unported_datasets_raise(tmp_path):
    """No download and no silent synthetic fallback: a dataset whose
    files are missing raises, naming the fixture writer (cifar10 is
    ported now: once its fixture is written, it loads)."""
    cifar = DataConfig(dataset="cifar10", data_dir=str(tmp_path / "c10"))
    with pytest.raises(FileNotFoundError,
                       match="materialize_cifar10_fixture"):
        datasets.load_datasets(cifar)
    from distributedmnist_tpu_torch.data.fixtures import (
        materialize_cifar10_fixture)
    materialize_cifar10_fixture(tmp_path / "c10", num_train=100,
                                num_test=20)
    ds = datasets.load_datasets(cifar)
    assert ds.train.images.shape == (90, 32, 32, 3)
    assert ds.validation.num_examples == 10 and ds.test.num_examples == 20
    with pytest.raises(FileNotFoundError, match="materialize_idx_fixture"):
        datasets.load_datasets(DataConfig(dataset="mnist",
                                          data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="smaller than"):
        pipeline.BatchIterator(_lm()[0].test, 64, seed=0)
