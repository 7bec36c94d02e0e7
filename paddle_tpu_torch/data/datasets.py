"""Datasets (counterpart of ``paddle_tpu.data.datasets``; so far MNIST,
the Criteo-style CTR data and MovieLens, copied so that each yields the
same arrays bit for bit).

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


# ---------------------------------------------------------------------------
# ctr (dist_ctr.py analog) and movielens (dataset/movielens.py analog):
# synthetic only, as in the JAX package
# ---------------------------------------------------------------------------


def ctr(split: str = "train", num_sparse_fields: int = 26, sparse_dim: int = 1000,
        num_dense: int = 13, synthetic_size: int = 4096) -> Callable:
    """Criteo-style CTR data for DeepFM (datasets.py:205): (dense[13],
    sparse_ids[26] in [0, sparse_dim) per field, label 0/1)."""

    def reader():
        # the labelling weights are split-independent (a fixed seed), so
        # train and test follow one rule; only the samples differ
        wrng = np.random.RandomState(42)
        w_d = wrng.randn(num_dense).astype(np.float32)
        w_s = wrng.randn(num_sparse_fields, sparse_dim).astype(np.float32) * 0.5
        rng = np.random.RandomState(10 if split == "train" else 11)
        for _ in range(synthetic_size):
            dense = rng.randn(num_dense).astype(np.float32)
            sparse = rng.randint(0, sparse_dim, num_sparse_fields).astype(np.int64)
            score = dense @ w_d + sum(w_s[f, sparse[f]] for f in range(num_sparse_fields))
            y = np.int64(score + 0.5 * rng.randn() > 0)
            yield dense, sparse, y
    reader.synthetic = True
    return reader


def movielens(split: str = "train", num_users: int = 944, num_movies: int = 1683,
              num_categories: int = 18, title_vocab: int = 1000,
              max_categories: int = 4, title_len: int = 6,
              synthetic_size: int = 1024) -> Callable:
    """MovieLens-style data (datasets.py:252): (user_id[1], gender_id[1],
    age_id[1], job_id[1], movie_id[1], category_ids[max_categories],
    title_ids[title_len], score[1]); categories and titles 0-padded.
    Ratings follow latent user and movie factors, so a model can learn."""

    def reader():
        rng = np.random.RandomState(14 if split == "train" else 15)
        uf = rng.randn(num_users, 4).astype(np.float32)
        mf = rng.randn(num_movies, 4).astype(np.float32)
        for _ in range(synthetic_size):
            u = rng.randint(0, num_users)
            m = rng.randint(0, num_movies)
            ncat = rng.randint(1, max_categories + 1)
            cats = np.zeros(max_categories, np.int64)
            cats[:ncat] = rng.randint(1, num_categories, ncat)
            title = np.zeros(title_len, np.int64)
            nt = rng.randint(1, title_len + 1)
            title[:nt] = rng.randint(1, title_vocab, nt)
            raw = float(uf[u] @ mf[m])
            score = np.clip(2.5 + raw, 1.0, 5.0).astype(np.float32)
            yield (np.array([u], np.int64), np.array([rng.randint(0, 2)], np.int64),
                   np.array([rng.randint(0, 7)], np.int64),
                   np.array([rng.randint(0, 21)], np.int64),
                   np.array([m], np.int64), cats, title,
                   np.array([score], np.float32))
    reader.synthetic = True
    return reader
