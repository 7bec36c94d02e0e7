"""AlexNet, GoogLeNet (v1) and SE-ResNeXt (counterpart of
``paddle_tpu.models.convnets``; the benchmark/README.md rows and
benchmark/fluid/models/se_resnext.py): the rest of the image zoo that
bench.py trains (``bench_alexnet``, ``bench_googlenet``,
``bench_se_resnext``).

Names, scopes and parameter shapes are the JAX package's, so
``params_from_jax`` carries each net across unchanged. Each follows the
program's layout (``framework.layout_mode``): AlexNet flattens through
``to_chw_order`` (its fc weight is the same in NHWC and NCHW), an
inception block concatenates on the layout's channel axis, and the
squeeze-excite scale broadcasts over it. Every net returns ``loss``,
``acc`` and ``logits``; its dropout draws from the program's rng.
"""

from __future__ import annotations

from .. import layers as L
from ..framework import current_layout, name_scope
from ..metrics import accuracy
from .resnet import conv_bn_layer


def _head(logits, label):
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}


def _spec(fn, factory, **kwargs):
    fn.factory_spec = {"factory": f"{__name__}:{factory}", "kwargs": kwargs}
    return fn


def make_alexnet(class_num=1000):
    """AlexNet (benchmark/README.md AlexNet rows)."""

    def alexnet(image, label):
        x = L.conv2d(image, 64, 11, stride=4, padding=2, act="relu")
        x = L.pool2d(x, 3, "max", 2)
        x = L.conv2d(x, 192, 5, padding=2, act="relu")
        x = L.pool2d(x, 3, "max", 2)
        x = L.conv2d(x, 384, 3, padding=1, act="relu")
        x = L.conv2d(x, 256, 3, padding=1, act="relu")
        x = L.conv2d(x, 256, 3, padding=1, act="relu")
        x = L.pool2d(x, 3, "max", 2)
        x = L.flatten(L.to_chw_order(x), axis=1)
        x = L.dropout(x, 0.5)
        x = L.fc(x, 4096, act="relu")
        x = L.dropout(x, 0.5)
        x = L.fc(x, 4096, act="relu")
        return _head(L.fc(x, class_num), label)

    return _spec(alexnet, "make_alexnet", class_num=class_num)


def _channel_axis():
    return 1 if current_layout() == "NCHW" else 3


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    b1 = L.conv2d(x, c1, 1, act="relu")
    b2 = L.conv2d(L.conv2d(x, c3r, 1, act="relu"), c3, 3, padding=1, act="relu")
    b3 = L.conv2d(L.conv2d(x, c5r, 1, act="relu"), c5, 5, padding=2, act="relu")
    b4 = L.conv2d(L.pool2d(x, 3, "max", 1, 1), proj, 1, act="relu")
    return L.concat([b1, b2, b3, b4], axis=_channel_axis())


def make_googlenet(class_num=1000):
    """GoogLeNet v1 (benchmark/README.md GoogleNet rows)."""

    def googlenet(image, label):
        x = L.conv2d(image, 64, 7, stride=2, padding=3, act="relu")
        x = L.pool2d(x, 3, "max", 2, 1)
        x = L.conv2d(x, 64, 1, act="relu")
        x = L.conv2d(x, 192, 3, padding=1, act="relu")
        x = L.pool2d(x, 3, "max", 2, 1)
        x = _inception(x, 64, 96, 128, 16, 32, 32)
        x = _inception(x, 128, 128, 192, 32, 96, 64)
        x = L.pool2d(x, 3, "max", 2, 1)
        x = _inception(x, 192, 96, 208, 16, 48, 64)
        x = _inception(x, 160, 112, 224, 24, 64, 64)
        x = _inception(x, 128, 128, 256, 24, 64, 64)
        x = _inception(x, 112, 144, 288, 32, 64, 64)
        x = _inception(x, 256, 160, 320, 32, 128, 128)
        x = L.pool2d(x, 3, "max", 2, 1)
        x = _inception(x, 256, 160, 320, 32, 128, 128)
        x = _inception(x, 384, 192, 384, 48, 128, 128)
        x = L.pool2d(x, pool_type="avg", global_pooling=True)
        x = L.dropout(x, 0.4)
        return _head(L.fc(L.flatten(x, axis=1), class_num), label)

    return _spec(googlenet, "make_googlenet", class_num=class_num)


def _squeeze_excite(x, reduction=16):
    c_axis = _channel_axis()
    c = x.shape[c_axis]
    s = L.pool2d(x, pool_type="avg", global_pooling=True)
    s = L.fc(L.flatten(s, axis=1), max(c // reduction, 4), act="relu")
    s = L.fc(s, c, act="sigmoid")
    return x * (s[:, :, None, None] if c_axis == 1 else s[:, None, None, :])


def make_se_resnext(depth=50, class_num=1000, cardinality=32, reduction=16):
    """SE-ResNeXt-50/101 (benchmark/fluid/models/se_resnext.py analog)."""
    stages = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]

    def block(x, filters, stride):
        h = conv_bn_layer(x, filters, 1, act="relu")
        h = conv_bn_layer(h, filters, 3, stride=stride, act="relu", groups=cardinality)
        h = conv_bn_layer(h, filters * 2, 1)
        h = _squeeze_excite(h, reduction)
        if x.shape[_channel_axis()] != filters * 2 or stride != 1:
            x = conv_bn_layer(x, filters * 2, 1, stride=stride)
        return L.relu(h + x)

    def se_resnext(image, label):
        x = conv_bn_layer(image, 64, 7, stride=2, act="relu")
        x = L.pool2d(x, 3, "max", 2, 1)
        for s, blocks in enumerate(stages):
            filters = 128 * (2 ** s)
            with name_scope(f"stage{s}"):
                for i in range(blocks):
                    x = block(x, filters, stride=2 if s > 0 and i == 0 else 1)
        x = L.pool2d(x, pool_type="avg", global_pooling=True)
        x = L.dropout(L.flatten(x, axis=1), 0.2)
        return _head(L.fc(x, class_num), label)

    return _spec(se_resnext, "make_se_resnext", depth=depth, class_num=class_num,
                 cardinality=cardinality, reduction=reduction)


__all__ = ["make_alexnet", "make_googlenet", "make_se_resnext"]
