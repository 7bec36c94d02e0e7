"""Datasets (counterpart of ``paddle_tpu.data.datasets``; so far MNIST,
the Criteo-style CTR data, MovieLens and the text and regression sets of
the recurrent family (uci_housing, imdb, wmt16, wmt14, conll05,
imikolov, sentiment), copied so that each yields the same arrays bit for
bit).

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
from typing import Callable, Iterator, Optional, Tuple

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


# ---------------------------------------------------------------------------
# uci_housing (dataset/uci_housing.py analog)
# ---------------------------------------------------------------------------


def uci_housing(split: str = "train", synthetic_size: int = 404) -> Callable:
    """Yields (features[13], price[1]), the fit_a_line dataset
    (datasets.py:127); ``housing.data`` under the data home when present."""
    path = os.path.join(DATA_HOME, "housing.data")
    if os.path.exists(path):
        data = np.loadtxt(path).astype(np.float32)
        feats = (data[:, :-1] - data[:, :-1].mean(0)) / (data[:, :-1].std(0) + 1e-8)
        n = int(len(data) * 0.8)
        rows = list(range(n)) if split == "train" else list(range(n, len(data)))

        def reader():
            for i in rows:
                yield feats[i], data[i, -1:].astype(np.float32)
        reader.synthetic = False
        return reader

    def reader():
        rng = np.random.RandomState(4 if split == "train" else 5)
        w = rng.randn(13).astype(np.float32)
        for _ in range(synthetic_size):
            x = rng.randn(13).astype(np.float32)
            y = np.array([x @ w + 0.1 * rng.randn()], dtype=np.float32)
            yield x, y
    reader.synthetic = True
    return reader


# ---------------------------------------------------------------------------
# text: imdb, wmt16/wmt14, conll05, imikolov, sentiment (synthetic only, as
# in the JAX package)
# ---------------------------------------------------------------------------


def imdb(split: str = "train", vocab_size: int = 5000, seq_len: int = 128,
         synthetic_size: int = 1024) -> Callable:
    """Yields (word_ids[seq_len] int64 0-padded, label) with class-correlated
    token distributions (datasets.py:158)."""

    def reader():
        rng = np.random.RandomState(6 if split == "train" else 7)
        logits = rng.randn(2, vocab_size)
        probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        for i in range(synthetic_size):
            y = i % 2
            length = rng.randint(seq_len // 2, seq_len + 1)
            ids = rng.choice(vocab_size, size=length, p=probs[y])
            padded = np.zeros(seq_len, dtype=np.int64)
            padded[:length] = ids
            yield padded, np.int64(y)
    reader.synthetic = True
    return reader


def wmt16(split: str = "train", src_vocab: int = 10000, trg_vocab: int = 10000,
          seq_len: int = 64, synthetic_size: int = 512) -> Callable:
    """Yields (src_ids, trg_ids, trg_next_ids) padded to seq_len: <s> = 1,
    </s> = 2, a learnable source-to-target mapping (datasets.py:184)."""

    def reader():
        rng = np.random.RandomState(8 if split == "train" else 9)
        for _ in range(synthetic_size):
            n = rng.randint(seq_len // 2, seq_len)
            src = np.zeros(seq_len, np.int64)
            src[:n] = rng.randint(3, src_vocab, n)
            trg = np.zeros(seq_len, np.int64)
            trg[0] = 1
            trg[1:n] = (src[:n - 1] % (trg_vocab - 3)) + 3
            nxt = np.zeros(seq_len, np.int64)
            nxt[:n - 1] = trg[1:n]
            nxt[n - 1] = 2
            yield src, trg, nxt
    reader.synthetic = True
    return reader


def conll05(split: str = "train", vocab_size: int = 5000, num_labels: int = 20,
            seq_len: int = 32, synthetic_size: int = 512) -> Callable:
    """CoNLL-2005 SRL-style data (datasets.py:228): (word_ids[t],
    mark_ids[t], label[t], length); the labels follow a word-to-tag map
    shifted on the predicate span, so the mark feature carries signal."""

    def reader():
        rng = np.random.RandomState(12 if split == "train" else 13)
        tag_of = rng.randint(0, num_labels, vocab_size)
        for _ in range(synthetic_size):
            n = rng.randint(seq_len // 2, seq_len)
            words = np.zeros(seq_len, np.int64)
            words[:n] = rng.randint(1, vocab_size, n)
            marks = np.zeros(seq_len, np.int64)
            p0 = rng.randint(0, n)
            marks[p0:min(n, p0 + 3)] = 1
            labels = np.zeros(seq_len, np.int64)
            labels[:n] = (tag_of[words[:n]] + marks[:n]) % num_labels
            yield words, marks, labels, np.int64(n)
    reader.synthetic = True
    return reader


class _DataType:
    NGRAM = 1
    SEQ = 2


DataType = _DataType


def imikolov_build_dict(min_word_freq: int = 50, vocab_size: int = 2073) -> dict:
    """imikolov.py build_dict analog: the id map of the synthetic
    vocabulary ("w0".."wN", <s>, <unk>)."""
    words = {f"w{i}": i for i in range(vocab_size - 2)}
    words["<s>"] = vocab_size - 2
    words["<unk>"] = vocab_size - 1
    return words


def imikolov(split: str = "train", word_idx: Optional[dict] = None, n: int = 5,
             data_type: int = DataType.NGRAM, synthetic_size: int = 4096) -> Callable:
    """imikolov.py train/test analog (the PTB language model,
    datasets.py:350-392): NGRAM mode yields n-tuples of word ids, SEQ mode
    (src_seq, trg_seq) shifted pairs; the text follows a fixed first-order
    Markov chain."""
    vocab = len(word_idx) if word_idx else 2073

    def reader():
        rng = np.random.RandomState(50 if split == "train" else 51)
        succ = np.random.RandomState(52).randint(0, vocab, (vocab, 8))
        for _ in range(synthetic_size):
            length = rng.randint(n, 24)
            sent = [rng.randint(0, vocab)]
            for _ in range(length - 1):
                sent.append(int(succ[sent[-1], rng.randint(0, 8)])
                            if rng.rand() < 0.9 else rng.randint(0, vocab))
            if data_type == DataType.NGRAM:
                if len(sent) >= n:
                    for i in range(n - 1, len(sent)):
                        yield tuple(sent[i - n + 1:i + 1])
            else:
                yield sent[:-1], sent[1:]
    reader.synthetic = True
    return reader


def imikolov_train(word_idx=None, n: int = 5, data_type: int = DataType.NGRAM):
    return imikolov("train", word_idx, n, data_type)


def imikolov_test(word_idx=None, n: int = 5, data_type: int = DataType.NGRAM):
    return imikolov("test", word_idx, n, data_type)


def sentiment(split: str = "train", vocab_size: int = 5147, seq_len: int = 100,
              synthetic_size: int = 1024) -> Callable:
    """dataset/sentiment.py analog (datasets.py:396): (word-id list, label
    in {0, 1}) with polarity-correlated tokens and 20% noise."""

    def reader():
        rng = np.random.RandomState(60 if split == "train" else 61)
        pos_words = np.arange(0, vocab_size // 2)
        neg_words = np.arange(vocab_size // 2, vocab_size)
        for i in range(synthetic_size):
            y = i % 2
            base = pos_words if y == 1 else neg_words
            length = rng.randint(10, seq_len)
            ids = rng.choice(base, size=length).tolist()
            for _ in range(length // 5):
                ids[rng.randint(0, length)] = int(rng.randint(0, vocab_size))
            yield ids, np.int64(y)
    reader.synthetic = True
    return reader


def wmt14(split: str = "train", dict_size: int = 30000, seq_len: int = 24,
          synthetic_size: int = 2048) -> Callable:
    """dataset/wmt14.py analog (datasets.py:418): wmt16's contract at the
    30K dict size."""
    return wmt16(split, src_vocab=dict_size, trg_vocab=dict_size, seq_len=seq_len,
                 synthetic_size=synthetic_size)
