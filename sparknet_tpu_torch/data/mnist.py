"""MNIST idx-format loader and siamese pair builder.

The port's own copy of ``sparknet_tpu/data/mnist.py``.

Reference surface: ``caffe/examples/mnist/convert_mnist_data.cpp`` (idx
-> Datum DB conversion; the idx big-endian header parse is
``:60-78``), ``caffe/examples/siamese/convert_mnist_siamese_data.cpp``
(random image pairs packed as one 2-channel datum, label = same-class)
and the LeNet configs (``lenet_train_test.prototxt``).  The idx files
themselves are Yann LeCun's public format: u32-BE magic (0x803 images /
0x801 labels), u32-BE counts/dims, then raw uint8 payload; ``.gz``
copies are read transparently (the reference's ``get_mnist.sh``
downloads gzipped files).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

IMAGE_MAGIC = 0x00000803
LABEL_MAGIC = 0x00000801

TRAIN_IMAGES = "train-images-idx3-ubyte"
TRAIN_LABELS = "train-labels-idx1-ubyte"
TEST_IMAGES = "t10k-images-idx3-ubyte"
TEST_LABELS = "t10k-labels-idx1-ubyte"


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _resolve(data_dir: str, name: str) -> str:
    for cand in (name, name + ".gz"):
        p = os.path.join(data_dir, cand)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(
        f"{data_dir} has neither {name} nor {name}.gz"
    )


def read_idx_images(path: str) -> np.ndarray:
    """idx3 file -> uint8 (N, 1, H, W) (NCHW like every loader here)."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != IMAGE_MAGIC:
            raise IOError(f"{path}: bad idx image magic {magic:#x}")
        data = f.read(n * rows * cols)
    if len(data) != n * rows * cols:
        raise IOError(f"{path}: truncated image payload")
    return np.frombuffer(data, np.uint8).reshape(n, 1, rows, cols).copy()


def read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != LABEL_MAGIC:
            raise IOError(f"{path}: bad idx label magic {magic:#x}")
        data = f.read(n)
    if len(data) != n:
        raise IOError(f"{path}: truncated label payload")
    return np.frombuffer(data, np.uint8).astype(np.int64).copy()


def write_idx_images(path: str, images: np.ndarray) -> None:
    """(N, 1, H, W) or (N, H, W) uint8 -> idx3 file (fixtures/export)."""
    arr = np.asarray(images, np.uint8)
    if arr.ndim == 4:
        if arr.shape[1] != 1:
            raise ValueError("idx images are single-channel")
        arr = arr[:, 0]
    n, rows, cols = arr.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", IMAGE_MAGIC, n, rows, cols))
        f.write(np.ascontiguousarray(arr).tobytes())


def write_idx_labels(path: str, labels) -> None:
    arr = np.asarray(labels)
    if arr.min() < 0 or arr.max() > 255:
        raise ValueError("idx labels are single bytes")
    with open(path, "wb") as f:
        f.write(struct.pack(">II", LABEL_MAGIC, len(arr)))
        f.write(arr.astype(np.uint8).tobytes())


def load_mnist(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N,1,28,28), labels int64 (N,)) from the standard
    four-file layout (plain or .gz)."""
    images = read_idx_images(
        _resolve(data_dir, TRAIN_IMAGES if train else TEST_IMAGES)
    )
    labels = read_idx_labels(
        _resolve(data_dir, TRAIN_LABELS if train else TEST_LABELS)
    )
    if len(images) != len(labels):
        raise IOError(
            f"{data_dir}: {len(images)} images vs {len(labels)} labels"
        )
    return images, labels


def write_synthetic(data_dir: str, n_train: int = 512, n_test: int = 128,
                    seed: int = 0, side: int = 28) -> None:
    """Class-separable synthetic digits in the real file layout — the
    fixture role ``get_mnist.sh`` fills for the reference examples."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)

    def make(n):
        labels = rng.randint(0, 10, n)
        images = rng.randint(0, 60, (n, 1, side, side)).astype(np.uint8)
        # a bright class-dependent stripe makes the classes learnable
        for i, lab in enumerate(labels):
            row = 2 + int(lab) * (side - 4) // 10
            images[i, 0, row:row + 2, :] = 255 - 8 * int(lab)
        return images, labels

    tr_img, tr_lab = make(n_train)
    te_img, te_lab = make(n_test)
    write_idx_images(os.path.join(data_dir, TRAIN_IMAGES), tr_img)
    write_idx_labels(os.path.join(data_dir, TRAIN_LABELS), tr_lab)
    write_idx_images(os.path.join(data_dir, TEST_IMAGES), te_img)
    write_idx_labels(os.path.join(data_dir, TEST_LABELS), te_lab)


def make_pairs(images: np.ndarray, labels: np.ndarray, num_pairs: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random image pairs as 2-channel images + same-class labels —
    ``convert_mnist_siamese_data.cpp`` semantics (two uniformly-random
    picks per pair; label 1 iff classes match)."""
    rng = np.random.RandomState(seed)
    n = len(images)
    i = rng.randint(0, n, num_pairs)
    j = rng.randint(0, n, num_pairs)
    pairs = np.concatenate([images[i], images[j]], axis=1)  # (P,2,H,W)
    same = (np.asarray(labels)[i] == np.asarray(labels)[j]).astype(np.int64)
    return pairs, same
