"""The port's dataset fixtures and CIFAR-10 loader
(``distributedmnist_tpu_torch/data/fixtures.py``, ``data/datasets.py
load_cifar10``) against the reference's.

The fixture files are byte for byte the reference's for the same sizes
(the pickle batches at 500 / 100 images; the idx files at 300 / 50);
the loaded arrays are bitwise the reference's; a missing archive raises
``FileNotFoundError`` naming the fixture writer (the port has no
synthetic fallback and no download).
"""

import numpy as np
import pytest

from distributedmnist_tpu.data import datasets as ref_ds
from distributedmnist_tpu.data import fixtures as ref_fx
from distributedmnist_tpu_torch.core.config import DataConfig
from distributedmnist_tpu_torch.data import datasets, fixtures

CIFAR_FILES = [f"cifar-10-batches-py/data_batch_{i}" for i in range(1, 6)] \
    + ["cifar-10-batches-py/test_batch"]


@pytest.fixture(scope="module")
def cifar_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    fixtures.materialize_cifar10_fixture(root / "port", 500, 100)
    ref_fx.materialize_cifar10_fixture(root / "ref", 500, 100)
    return root / "port", root / "ref"


@pytest.mark.parametrize("name", CIFAR_FILES)
def test_cifar10_fixture_bytes_equal_reference(cifar_dirs, name):
    port, ref = cifar_dirs
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_cifar10_fixture_is_idempotent(cifar_dirs):
    port, _ = cifar_dirs
    stamp = [(port / f).stat().st_mtime_ns for f in CIFAR_FILES]
    fixtures.materialize_cifar10_fixture(port, 500, 100)
    assert [(port / f).stat().st_mtime_ns for f in CIFAR_FILES] == stamp
    assert "NOT the real" in (port / "PROVENANCE.md").read_text()


def test_load_cifar10_equals_reference(cifar_dirs):
    port, _ = cifar_dirs
    got, want = datasets.load_cifar10(port), ref_ds.load_cifar10(port)
    for split in ("train", "validation", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert a.images.dtype == np.float32 and a.labels.dtype == np.int32
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert got.train.images.shape == (450, 32, 32, 3)
    assert got.validation.num_examples == 50
    # the data_dir branch of load_datasets reads the same files
    via_cfg = datasets.load_datasets(DataConfig(dataset="cifar10",
                                                data_dir=str(port)))
    np.testing.assert_array_equal(via_cfg.test.images, got.test.images)


def test_missing_cifar10_archive_raises(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="materialize_cifar10_fixture"):
        datasets.load_cifar10(tmp_path)
    (tmp_path / "cifar-10-batches-py").mkdir()
    fixtures.materialize_cifar10_fixture(tmp_path / "other", 10, 5)
    (tmp_path / "cifar-10-batches-py" / "data_batch_1").write_bytes(
        (tmp_path / "other/cifar-10-batches-py/data_batch_1").read_bytes())
    with pytest.raises(FileNotFoundError):  # no test_batch
        datasets.load_cifar10(tmp_path)


@pytest.mark.parametrize("dataset", ["mnist", "fashion_mnist"])
def test_idx_fixture_bytes_equal_reference(tmp_path, dataset):
    port = fixtures.materialize_idx_fixture(tmp_path / "p", dataset, 300, 50)
    ref = ref_fx.materialize_idx_fixture(tmp_path / "r", dataset, 300, 50)
    names = sorted(f.name for f in ref.glob("*.gz"))
    assert len(names) == 4
    for name in names:
        # gzip stamps the mtime: compare the payloads
        import gzip
        assert (gzip.decompress((port / name).read_bytes())
                == gzip.decompress((ref / name).read_bytes())), name
    got = datasets.load_idx_dataset(port)
    want = ref_ds.load_idx_dataset(ref)
    np.testing.assert_array_equal(got.train.images, want.train.images)
    np.testing.assert_array_equal(got.test.labels, want.test.labels)
