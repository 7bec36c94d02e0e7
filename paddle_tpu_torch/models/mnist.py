"""MNIST models (counterpart of ``paddle_tpu.models.mnist``): the book's
recognize_digits MLP, written with the port's layers, so that
``build(mlp)`` has the JAX package's parameter names (``fc_0/w`` ...
``fc_2/b``) and shapes. ``conv_net`` comes with the ResNet slice (conv,
pool and batch norm)."""

from __future__ import annotations

from .. import layers as L
from ..metrics import accuracy


def mlp(image, label):
    """softmax_regression/mlp from the book test: 784 → 200 → 200 → 10."""
    h = L.fc(image, 200, act="tanh")
    h = L.fc(h, 200, act="tanh")
    logits = L.fc(h, 10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}
