"""VGG-16/19 (counterpart of ``paddle_tpu.models.vgg``; the
benchmark/fluid/models/vgg.py analog): conv blocks of 3x3 convs with
batch norm, and a dropout fc head whose first fc is batch-normalised too
(a 2-D batch norm over the fc's features).

Names, scopes (``block{i}``) and parameter shapes are the JAX package's,
so ``params_from_jax`` carries a VGG across unchanged. The layout is the
program's (``framework.layout_mode``); ``to_chw_order`` before the
flatten keeps the first fc's weight the same in NHWC and NCHW.
"""

from __future__ import annotations

from .. import layers as L
from ..framework import name_scope
from ..metrics import accuracy

CFG = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def conv_block(x, num_filter, groups):
    for _ in range(groups):
        x = L.conv2d(x, num_filter, 3, padding=1, act=None, bias_attr=False)
        x = L.batch_norm(x, act="relu")
    return L.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")


def make_model(depth=16, class_num=10, fc_dim=512):
    """The program function ``vgg(image, label)`` -> loss, acc, logits. It
    carries ``factory_spec``, by which an inference artifact rebuilds it."""
    groups = CFG[depth]

    def vgg(image, label):
        x = image
        for i, (nf, g) in enumerate(zip((64, 128, 256, 512, 512), groups)):
            with name_scope(f"block{i}"):
                x = conv_block(x, nf, g)
        x = L.flatten(L.to_chw_order(x), axis=1)
        x = L.dropout(x, 0.5)
        x = L.fc(x, fc_dim, act=None)
        x = L.batch_norm(x, act="relu")
        x = L.dropout(x, 0.5)
        x = L.fc(x, fc_dim, act="relu")
        logits = L.fc(x, class_num)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}

    vgg.factory_spec = {"factory": f"{__name__}:make_model",
                        "kwargs": {"depth": depth, "class_num": class_num,
                                   "fc_dim": fc_dim}}
    return vgg


__all__ = ["CFG", "conv_block", "make_model"]
