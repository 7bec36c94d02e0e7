"""Datasets (counterpart of ``paddle_tpu.data.datasets``; so far MNIST,
copied so that it yields the same arrays bit for bit).

Each dataset loads from a local path when its files are there (the
standard file formats, under ``PDTPU_DATA_HOME``) and otherwise falls
back to a **deterministic synthetic generator** with the real shapes, so
every example and test runs with no download. The reader says which
through ``reader.synthetic``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Iterator, Tuple

import numpy as np

DATA_HOME = os.environ.get("PDTPU_DATA_HOME", os.path.expanduser("~/.cache/paddle_tpu/dataset"))


# ---------------------------------------------------------------------------
# mnist (dataset/mnist.py analog)
# ---------------------------------------------------------------------------


def _mnist_files(split: str):
    base = os.path.join(DATA_HOME, "mnist")
    if split == "train":
        return (os.path.join(base, "train-images-idx3-ubyte.gz"),
                os.path.join(base, "train-labels-idx1-ubyte.gz"))
    return (os.path.join(base, "t10k-images-idx3-ubyte.gz"),
            os.path.join(base, "t10k-labels-idx1-ubyte.gz"))


def _read_idx_images(path):
    with gzip.open(path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    return data.astype(np.float32) / 127.5 - 1.0  # reference normalization


def _read_idx_labels(path):
    with gzip.open(path, "rb") as f:
        _, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)


def _synthetic_classification(n: int, feat_shape: Tuple[int, ...], num_classes: int,
                              centers_seed: int, noise_seed: int,
                              ) -> Iterator[Tuple[np.ndarray, np.int64]]:
    """Separable synthetic data: class-dependent means so models actually
    learn — lets e2e/convergence tests be meaningful without downloads.
    ``centers_seed`` is shared between train/test splits (same underlying
    distribution); ``noise_seed`` differs per split."""
    centers = np.random.RandomState(centers_seed).randn(num_classes, *feat_shape).astype(np.float32)
    rng = np.random.RandomState(noise_seed)
    for i in range(n):
        y = i % num_classes
        x = centers[y] + 0.5 * rng.randn(*feat_shape).astype(np.float32)
        yield x, np.int64(y)


def mnist(split: str = "train", synthetic_size: int = 2048) -> Callable:
    """Reader creator for MNIST: yields (image[784] in [-1,1], label)."""
    imgs_p, lbls_p = _mnist_files(split)
    if os.path.exists(imgs_p) and os.path.exists(lbls_p):
        def reader():
            imgs = _read_idx_images(imgs_p)
            lbls = _read_idx_labels(lbls_p)
            for x, y in zip(imgs, lbls):
                yield x, y
        reader.synthetic = False
        return reader

    def reader():
        yield from _synthetic_classification(synthetic_size, (784,), 10, centers_seed=0,
                                             noise_seed=0 if split == "train" else 1)
    reader.synthetic = True
    return reader


def mnist_train():
    return mnist("train")


def mnist_test():
    return mnist("test")
