"""MNIST models (counterpart of ``paddle_tpu.models.mnist``): the book's
recognize_digits MLP and conv net, written with the port's layers, so
that ``build(mlp)`` and ``build(conv_net)`` have the JAX package's
parameter names (``fc_0/w`` ... ``fc_2/b``; ``conv2d_0/w``,
``batch_norm_0/scale`` ...) and shapes."""

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


def conv_net(image, label):
    """conv_pool x2 + fc (the book's convolutional_neural_network +
    nets.simple_img_conv_pool analog)."""
    x = L.reshape(image, [-1, 1, 28, 28])
    x = L.conv2d(x, num_filters=20, filter_size=5, act="relu")
    x = L.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    x = L.batch_norm(x)
    x = L.conv2d(x, num_filters=50, filter_size=5, act="relu")
    x = L.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    logits = L.fc(x, 10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}
