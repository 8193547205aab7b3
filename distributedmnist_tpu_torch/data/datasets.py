"""In-memory datasets (≙ ``distributedmnist_tpu/data/datasets.py``): the
split containers, the MNIST-format idx reader and writer, and the
deterministic synthetic images and token sequences.

``make_synthetic`` and ``make_synthetic_lm`` are the reference's numpy
code, so the same seed gives bitwise the same arrays; the idx reader
decodes and normalizes exactly as the reference's does, and so does
the CIFAR-10 pickle-batch reader (:func:`load_cifar10`). Not ported:
``maybe_download`` (neither machine has a network — a missing
``data_dir`` raises; :mod:`.fixtures` writes a deterministic set in
either format).
"""

from __future__ import annotations

import dataclasses
import gzip
import pickle
import struct
from pathlib import Path

import numpy as np

from ..core.config import DataConfig

PIXEL_DEPTH = 255


@dataclasses.dataclass(frozen=True)
class ArrayDataset:
    """An in-memory split. For LM tasks: images [N, S] int32 token
    sequences, labels [N, S] (the same tokens — the loss shifts
    internally for next-token prediction). Image tasks keep images
    [N, H, W, C] float32 and labels [N] int32."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        if self.images.ndim not in (2, 4) or self.labels.ndim not in (1, 2):
            raise ValueError(f"unexpected split shapes {self.images.shape}, "
                             f"{self.labels.shape}")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} inputs but "
                             f"{len(self.labels)} labels")

    @property
    def num_examples(self) -> int:
        return len(self.labels)

    def take(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.images[idx], self.labels[idx])

    def shard(self, shard_id: int, num_shards: int) -> "ArrayDataset":
        """Deterministic contiguous-strided shard."""
        return self.take(np.arange(shard_id, self.num_examples, num_shards))


@dataclasses.dataclass(frozen=True)
class Datasets:
    train: ArrayDataset
    validation: ArrayDataset
    test: ArrayDataset


# -- idx format (MNIST / Fashion-MNIST) ----------------------------------

def _open_maybe_gz(path: Path):
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def _read_idx_ubyte(path: Path, expect_ndim: int) -> np.ndarray:
    """Raw idx(.gz) ubyte payload."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">HBB", f.read(4))
        if magic[0] != 0 or magic[1] != 0x08:
            raise ValueError(f"{path}: bad idx magic {magic}")
        dims = struct.unpack(f">{magic[2]}I", f.read(4 * magic[2]))
        buf = f.read(int(np.prod(dims)))
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(dims)
    if arr.ndim != expect_ndim:
        raise ValueError(f"{path}: expected {expect_ndim}-d idx, got "
                         f"{arr.ndim}-d")
    return arr


def read_idx_images(path: Path) -> np.ndarray:
    """An idx3-ubyte image file → float32 [N, H, W, 1] in [-0.5, 0.5]."""
    data = _read_idx_ubyte(Path(path), 3).astype(np.float32)
    data = (data - PIXEL_DEPTH / 2.0) / PIXEL_DEPTH
    return data[..., np.newaxis]


def read_idx_labels(path: Path) -> np.ndarray:
    """An idx1-ubyte label file → int32 [N]."""
    return _read_idx_ubyte(Path(path), 1).astype(np.int32)


def write_idx_ubyte(path: Path, arr: np.ndarray) -> Path:
    """Write a uint8 array as an idx(.gz) file, the inverse of the
    reader (gzip when the suffix is ``.gz``)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = struct.pack(">HBB", 0, 0x08, arr.ndim)
    header += struct.pack(f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(header)
        f.write(arr.tobytes())
    return path


_IDX_FILES = {
    "train_images": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
}


def _find_idx(root: Path, names: list[str]) -> Path | None:
    for name in names:
        for cand in (root / name, root / (name + ".gz")):
            if cand.exists():
                return cand
    return None


def load_idx_dataset(data_dir: str | Path,
                     validation_size: int = 5000) -> Datasets:
    """MNIST-format idx files from ``data_dir`` (MNIST and Fashion-MNIST
    share the format); validation is the first rows of train."""
    root = Path(data_dir)
    paths = {k: _find_idx(root, v) for k, v in _IDX_FILES.items()}
    missing = [k for k, v in paths.items() if v is None]
    if missing:
        raise FileNotFoundError(
            f"idx files missing under {root}: {missing}. The port does not "
            "download: place the files there (data/fixtures.py "
            "materialize_idx_fixture writes a deterministic set), or use "
            "data.dataset=synthetic")
    train_x = read_idx_images(paths["train_images"])
    train_y = read_idx_labels(paths["train_labels"])
    test_x = read_idx_images(paths["test_images"])
    test_y = read_idx_labels(paths["test_labels"])
    v = min(validation_size, len(train_y) // 10)
    return Datasets(train=ArrayDataset(train_x[v:], train_y[v:]),
                    validation=ArrayDataset(train_x[:v], train_y[:v]),
                    test=ArrayDataset(test_x, test_y))


# -- CIFAR-10 (python pickle batches) -------------------------------------

def load_cifar10(data_dir: str | Path, validation_size: int = 5000) -> Datasets:
    """The CIFAR-10 pickle batches under ``data_dir/cifar-10-batches-py``
    (or ``data_dir`` itself): ``[N, 3072]`` uint8 channel-major rows →
    NHWC float32 ``(u8 - 127.5) / 255``; validation is the first
    ``min(validation_size, N // 10)`` train rows."""
    root = Path(data_dir)
    batch_dir = root / "cifar-10-batches-py"
    if not batch_dir.exists():
        batch_dir = root
    train_files = sorted(batch_dir.glob("data_batch_*"))
    test_file = batch_dir / "test_batch"
    if not train_files or not test_file.exists():
        raise FileNotFoundError(
            f"CIFAR-10 pickle batches not found under {root}. The port does "
            "not download: place cifar-10-batches-py there "
            "(data/fixtures.py materialize_cifar10_fixture writes a "
            "deterministic set)")

    def load_batch(path: Path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(
            np.float32)
        x = (x - PIXEL_DEPTH / 2.0) / PIXEL_DEPTH
        return x, np.asarray(d[b"labels"], dtype=np.int32)

    xs, ys = zip(*(load_batch(p) for p in train_files))
    train_x, train_y = np.concatenate(xs), np.concatenate(ys)
    test_x, test_y = load_batch(test_file)
    v = min(validation_size, len(train_y) // 10)
    return Datasets(train=ArrayDataset(train_x[v:], train_y[v:]),
                    validation=ArrayDataset(train_x[:v], train_y[:v]),
                    test=ArrayDataset(test_x, test_y))


# -- deterministic synthetic data ----------------------------------------

def make_synthetic(num_train: int, num_test: int, image_size: int = 28,
                   num_channels: int = 1, num_classes: int = 10,
                   seed: int = 12345, noise: float = 0.08) -> Datasets:
    """Class-conditional smooth templates plus Gaussian noise: separable
    (a CNN reaches ≈100%) and fully determined by ``seed``."""
    rng = np.random.default_rng(seed)
    low = max(4, image_size // 4)
    templates = rng.standard_normal(
        (num_classes, low, low, num_channels)).astype(np.float32)
    # bilinear-upsample templates to full resolution → smooth shapes
    up = np.empty((num_classes, image_size, image_size, num_channels),
                  np.float32)
    xs = np.linspace(0, low - 1, image_size)
    x0 = np.clip(np.floor(xs).astype(int), 0, low - 2)
    fx = (xs - x0).astype(np.float32)
    for c in range(num_classes):
        t = templates[c]
        rows = (t[x0] * (1 - fx)[:, None, None]
                + t[x0 + 1] * fx[:, None, None])
        up[c] = (rows[:, x0] * (1 - fx)[None, :, None]
                 + rows[:, x0 + 1] * fx[None, :, None])
    up = up / (np.abs(up).max() + 1e-6) * 0.45  # keep within [-0.5, 0.5]

    def sample(n: int) -> ArrayDataset:
        labels = rng.integers(0, num_classes, size=n).astype(np.int32)
        images = up[labels] + rng.standard_normal(
            (n, image_size, image_size, num_channels)).astype(
                np.float32) * noise
        return ArrayDataset(np.clip(images, -0.5, 0.5), labels)

    return Datasets(train=sample(num_train),
                    validation=sample(max(num_test // 2, 256)),
                    test=sample(num_test))


def make_synthetic_lm(num_train: int, num_test: int, seq_len: int = 128,
                      vocab_size: int = 256, seed: int = 12345,
                      peak: float = 3.0) -> Datasets:
    """Deterministic learnable token sequences: a fixed random
    first-order Markov chain with peaked transitions. A causal LM that
    learns the transition table drives next-token loss well below the
    unigram entropy — the convergence oracle for the sequence path."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((vocab_size, vocab_size)) * peak
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    cdf = np.cumsum(probs, axis=1)

    def sample(n: int) -> ArrayDataset:
        seqs = np.empty((n, seq_len), np.int32)
        seqs[:, 0] = rng.integers(0, vocab_size, n)
        for t in range(1, seq_len):
            u = rng.random(n)[:, None]
            seqs[:, t] = (cdf[seqs[:, t - 1]] < u).sum(axis=1)
        return ArrayDataset(seqs, seqs.copy())

    return Datasets(train=sample(num_train),
                    validation=sample(max(num_test // 2, 64)),
                    test=sample(num_test))


def load_datasets(cfg: DataConfig, image_size: int = 28, num_channels: int = 1,
                  num_classes: int = 10, seq_len: int = 128,
                  vocab_size: int = 256) -> Datasets:
    """The configured dataset: ``mnist`` / ``fashion_mnist`` (idx files
    under ``data_dir`` or its per-dataset subdirectory), ``cifar10``
    (pickle batches under ``data_dir``), ``synthetic`` or
    ``synthetic_lm``. Where the reference falls back to synthetic
    data when idx files are missing, the port raises: a run never
    trains on other data than it names."""
    name = cfg.dataset
    if name in ("mnist", "fashion_mnist"):
        sub = Path(cfg.data_dir) / name
        return load_idx_dataset(sub if sub.exists() else Path(cfg.data_dir))
    if name == "synthetic":
        return make_synthetic(cfg.synthetic_train_size,
                              cfg.synthetic_test_size, image_size,
                              num_channels, num_classes)
    if name == "synthetic_lm":
        return make_synthetic_lm(cfg.synthetic_train_size,
                                 cfg.synthetic_test_size, seq_len,
                                 vocab_size)
    if name == "cifar10":
        return load_cifar10(cfg.data_dir)
    raise ValueError(f"unknown dataset {name!r}")
