"""Dataset fixtures on disk (≙ ``distributedmnist_tpu/data/fixtures.py``):
the deterministic synthetic images written in the file formats the real
archives use, so the loaders' parse paths run end to end without the
archives.

* :func:`materialize_idx_fixture` — the four MNIST idx(.gz) files;
* :func:`materialize_cifar10_fixture` — the CIFAR-10 python-pickle
  batches (``cifar-10-batches-py/data_batch_1..5`` and ``test_batch``,
  each ``{b"data": [N, 3072] uint8 channel-major rows, b"labels",
  b"batch_label"}``).

Both draw :func:`..data.datasets.make_synthetic` with the reference's
per-dataset seeds and write the same bytes as the reference's fixtures
for the same arguments. Each writes a ``PROVENANCE.md`` beside the
files: the data is NOT the real archive's pixels, only its format,
shapes, dtype and split sizes. Both are idempotent.
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path

import numpy as np

from .datasets import _IDX_FILES, _open_maybe_gz, make_synthetic, write_idx_ubyte

# per-dataset generation seeds (the reference's)
_FIXTURE_SEEDS = {"mnist": 12345, "fashion_mnist": 54321, "cifar10": 67890}


def _idx_dims(path: Path) -> tuple[int, ...]:
    """An idx file's dims from its header alone (``()`` when it is not
    an idx ubyte file)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">HBB", f.read(4))
        if magic[0] != 0 or magic[1] != 0x08:
            return ()
        return struct.unpack(f">{magic[2]}I", f.read(4 * magic[2]))


def _provenance(root: Path, dataset: str, fmt: str, seed: int,
                num_train: int, num_test: int) -> None:
    (root / "PROVENANCE.md").write_text(
        f"# Fixture dataset ({dataset})\n\n"
        f"Deterministic synthetic data materialized in {fmt} "
        "(distributedmnist_tpu_torch.data.fixtures). "
        f"seed={seed}, {num_train} train / {num_test} test. NOT the real "
        "archive — same format, shapes, dtype and split sizes.\n")


def materialize_idx_fixture(data_dir: str | Path, dataset: str = "mnist",
                            num_train: int = 60000, num_test: int = 10000,
                            image_size: int = 28, noise: float = 0.08,
                            gzip_files: bool = True) -> Path:
    """Write the four idx files of ``dataset`` under ``data_dir``
    (returns at once when all four exist with the requested shapes)."""
    root = Path(data_dir)
    suffix = ".gz" if gzip_files else ""
    paths = {k: root / (names[0] + suffix) for k, names in _IDX_FILES.items()}
    want = {"train_images": (num_train, image_size, image_size),
            "train_labels": (num_train,),
            "test_images": (num_test, image_size, image_size),
            "test_labels": (num_test,)}
    if all(p.exists() for p in paths.values()) and all(
            _idx_dims(paths[k]) == want[k] for k in paths):
        return root
    seed = _FIXTURE_SEEDS.get(dataset, 12345)
    ds = make_synthetic(num_train, num_test, image_size=image_size,
                        num_channels=1, seed=seed, noise=noise)

    def to_u8(images: np.ndarray) -> np.ndarray:
        # the inverse of the loader's (u8 - 127.5)/255
        return np.clip(np.round((images[..., 0] + 0.5) * 255.0),
                       0, 255).astype(np.uint8)

    write_idx_ubyte(paths["train_images"], to_u8(ds.train.images))
    write_idx_ubyte(paths["train_labels"], ds.train.labels.astype(np.uint8))
    write_idx_ubyte(paths["test_images"], to_u8(ds.test.images))
    write_idx_ubyte(paths["test_labels"], ds.test.labels.astype(np.uint8))
    _provenance(root, dataset, "idx ubyte format", seed, num_train, num_test)
    return root


def materialize_cifar10_fixture(data_dir: str | Path,
                                num_train: int = 50000,
                                num_test: int = 10000) -> Path:
    """Write the CIFAR-10 pickle batches under
    ``data_dir/cifar-10-batches-py`` (returns at once when all six
    exist): five train batches of ``num_train / 5`` rows and the test
    batch."""
    root = Path(data_dir)
    batch_dir = root / "cifar-10-batches-py"
    n_batches = 5
    per = num_train // n_batches
    files = [batch_dir / f"data_batch_{i + 1}" for i in range(n_batches)]
    files.append(batch_dir / "test_batch")
    if all(p.exists() for p in files):
        return root
    batch_dir.mkdir(parents=True, exist_ok=True)
    seed = _FIXTURE_SEEDS["cifar10"]
    ds = make_synthetic(num_train, num_test, image_size=32, num_channels=3,
                        seed=seed)

    def to_rows(images: np.ndarray) -> np.ndarray:
        # the inverse of load_cifar10's (u8 - 127.5)/255: NHWC → [N, 3072]
        # channel-major rows, as the archive stores them
        u8 = np.clip(np.round(images * 255.0 + 127.5), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(
            u8.transpose(0, 3, 1, 2).reshape(len(u8), -1))

    # one 10k batch at a time caps the copies at a batch on top of the
    # float images
    for i, path in enumerate(files[:n_batches]):
        sl = slice(i * per, (i + 1) * per)
        with open(path, "wb") as f:
            pickle.dump({b"data": to_rows(ds.train.images[sl]),
                         b"labels": ds.train.labels[sl].tolist(),
                         b"batch_label": f"fixture batch {i + 1}".encode()}, f)
    with open(files[-1], "wb") as f:
        pickle.dump({b"data": to_rows(ds.test.images),
                     b"labels": ds.test.labels.tolist(),
                     b"batch_label": b"fixture test batch"}, f)
    _provenance(root, "cifar10", "the CIFAR-10 python pickle batch format",
                seed, num_train, num_test)
    return root
