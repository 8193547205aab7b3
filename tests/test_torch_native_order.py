"""C15: the port's train stream in the reference's native batch order
(``distributedmnist_tpu_torch/data/pipeline.py NativeOrderIterator``
against ``distributedmnist_tpu/data/native_loader.py NativePrefetcher``,
whose C++ library builds here with g++ and zlib).

The fixture has 103 rows over two hosts (52 and 51), batch 10 a host:
each epoch drops a ragged tail, so three epochs cross two reshuffles.
Parity is bitwise: the same rows in the same order, and the same
``{"impl": "native", "epoch", "pos"}`` cursor after every batch.
"""

import numpy as np
import pytest

from distributedmnist_tpu.data.datasets import ArrayDataset as RefArrays
from distributedmnist_tpu.data.pipeline import BatchIterator as RefBatches
from distributedmnist_tpu_torch.core.config import DataConfig
from distributedmnist_tpu_torch.data import pipeline
from distributedmnist_tpu_torch.data.datasets import ArrayDataset
from distributedmnist_tpu_torch.data.pipeline import (BatchIterator,
                                                      NativeOrderIterator,
                                                      make_train_iterator)

native_loader = pytest.importorskip(
    "distributedmnist_tpu.data.native_loader",
    reason="the reference's native library did not build")

ROWS, BATCH, HOSTS, SEED = 103, 20, 2, 7


def _arrays():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, 6)).astype(np.float32)
    y = np.arange(ROWS, dtype=np.int32)
    return x, y


def _pair(host_id: int, seed: int = SEED):
    x, y = _arrays()
    ref = native_loader.NativePrefetcher(
        RefBatches(RefArrays(x, y), BATCH, seed=seed, host_id=host_id,
                   num_hosts=HOSTS))
    port = NativeOrderIterator(ArrayDataset(x, y), BATCH, seed=seed,
                               host_id=host_id, num_hosts=HOSTS)
    return ref, port


@pytest.mark.parametrize("host_id", range(HOSTS))
def test_three_epochs_bitwise_the_native_loader(host_id):
    ref, port = _pair(host_id)
    try:
        per_epoch = port.batches_per_epoch
        assert port.data.num_examples % (BATCH // HOSTS) != 0  # ragged
        for _ in range(3 * per_epoch):
            a, b = next(ref), next(port)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert ref.state() == port.state()
        assert port.epoch == 2
    finally:
        ref.close()


def test_resume_mid_epoch_reproduces_the_rest():
    ref, port = _pair(0, seed=11)
    try:
        for _ in range(7):  # into the second epoch
            next(port)
        saved = port.state()
        want = [next(port)["label"] for _ in range(8)]
        again = NativeOrderIterator(ArrayDataset(*_arrays()), BATCH,
                                    seed=11, host_id=0, num_hosts=HOSTS)
        again.restore(saved)
        got = [next(again)["label"] for _ in range(8)]
        ref.restore(saved)  # the reference resumes from the port's cursor
        from_ref = [next(ref)["label"] for _ in range(8)]
        for w, g, r in zip(want, got, from_ref):
            np.testing.assert_array_equal(w, g)
            np.testing.assert_array_equal(w, r)
    finally:
        ref.close()


def test_cross_implementation_restore_is_refused():
    x, y = _arrays()
    port = NativeOrderIterator(ArrayDataset(x, y), BATCH, seed=SEED)
    numpy_it = BatchIterator(ArrayDataset(x, y), BATCH, seed=SEED)
    with pytest.raises(ValueError, match="'numpy' pipeline"):
        port.restore(numpy_it.state())
    with pytest.raises(ValueError, match="'native' pipeline"):
        numpy_it.restore(port.state())


@pytest.mark.parametrize("cores,native,cls", [
    (8, True, NativeOrderIterator), (1, True, BatchIterator),
    (8, False, BatchIterator)])
def test_the_reference_gate_picks_the_order(monkeypatch, cores, native,
                                            cls):
    """A spare core and the knob on: the native order; one core (the
    reference's gate, ``host_can_spare_producer_thread``) or the knob
    off: the numpy order."""
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: cores)
    it = make_train_iterator(ArrayDataset(*_arrays()),
                             DataConfig(batch_size=BATCH,
                                        use_native_pipeline=native),
                             seed=SEED)
    assert type(it) is cls
