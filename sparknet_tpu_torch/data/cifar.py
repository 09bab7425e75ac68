"""CIFAR-10 binary reader (reference: ``src/main/scala/loaders/CifarLoader
.scala``) — the port's own copy of ``sparknet_tpu/data/cifar.py``.

File format: each record is 1 label byte + 3072 image bytes (3 planes of
32x32, R then G then B).  Train files ``data_batch_{1..5}.bin`` (10k records
each), test file ``test_batch.bin``.  Like the reference, loading shuffles
the train set with a fixed permutation and computes the mean image.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

RECORD_BYTES = 1 + 3 * 32 * 32


def _read_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % RECORD_BYTES:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {RECORD_BYTES}")
    raw = raw.reshape(-1, RECORD_BYTES)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 3, 32, 32)  # planar RGB, NCHW
    return images, labels


class CifarLoader:
    """Loads train+test splits, shuffles train, computes the train mean
    image (CifarLoader.scala:52-63)."""

    def __init__(self, data_dir: str, seed: int = 0, num_train_files: int = 5):
        train_images: List[np.ndarray] = []
        train_labels: List[np.ndarray] = []
        for i in range(1, num_train_files + 1):
            path = os.path.join(data_dir, f"data_batch_{i}.bin")
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            im, lb = _read_file(path)
            train_images.append(im)
            train_labels.append(lb)
        self.train_images = np.concatenate(train_images)
        self.train_labels = np.concatenate(train_labels)
        perm = np.random.RandomState(seed).permutation(len(self.train_labels))
        self.train_images = self.train_images[perm]
        self.train_labels = self.train_labels[perm]
        test_path = os.path.join(data_dir, "test_batch.bin")
        if os.path.exists(test_path):
            self.test_images, self.test_labels = _read_file(test_path)
        else:
            self.test_images = np.zeros((0, 3, 32, 32), np.uint8)
            self.test_labels = np.zeros((0,), np.int32)
        # float mean image over the train split
        self.mean_image = self.train_images.astype(np.float64).mean(axis=0).astype(
            np.float32
        )

    @staticmethod
    def write_synthetic(
        data_dir: str,
        num_train: int = 1000,
        num_test: int = 200,
        seed: int = 0,
        separable: bool = True,
    ) -> None:
        """Write synthetic CIFAR-format files (for tests/benchmarks without
        the dataset; the class-dependent mean shift makes the task learnable
        when ``separable``)."""
        os.makedirs(data_dir, exist_ok=True)
        rng = np.random.RandomState(seed)

        def make(n):
            labels = rng.randint(0, 10, n).astype(np.uint8)
            images = rng.randint(0, 120, (n, 3, 32, 32)).astype(np.uint8)
            if separable:
                for c in range(10):
                    mask = labels == c
                    images[mask, c % 3] = np.minimum(
                        images[mask, c % 3] + 40 + 8 * c, 255
                    )
            return images, labels

        per_file = max(1, num_train // 5)
        for i in range(1, 6):
            images, labels = make(per_file)
            rec = np.concatenate(
                [labels[:, None], images.reshape(per_file, -1)], axis=1
            ).astype(np.uint8)
            rec.tofile(os.path.join(data_dir, f"data_batch_{i}.bin"))
        images, labels = make(num_test)
        rec = np.concatenate(
            [labels[:, None], images.reshape(num_test, -1)], axis=1
        ).astype(np.uint8)
        rec.tofile(os.path.join(data_dir, "test_batch.bin"))

    def minibatches(
        self,
        batch_size: int,
        train: bool = True,
        mean_subtract: bool = True,
        scale: float = 1.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack the split into fixed-size minibatch arrays, dropping the
        ragged tail (ScaleAndConvert.scala:45-70 semantics).  Returns
        (num_batches, B, 3, 32, 32) float32 and (num_batches, B) labels."""
        images = self.train_images if train else self.test_images
        labels = self.train_labels if train else self.test_labels
        n = (len(labels) // batch_size) * batch_size
        x = images[:n].astype(np.float32)
        if mean_subtract:
            x = x - self.mean_image[None]
        if scale != 1.0:
            x = x * scale
        x = x.reshape(-1, batch_size, 3, 32, 32)
        y = labels[:n].astype(np.float32).reshape(-1, batch_size)
        return x, y
