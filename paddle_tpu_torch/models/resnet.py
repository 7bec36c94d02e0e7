"""ResNet-50/101/152 (counterpart of ``paddle_tpu.models.resnet``; the
benchmark/fluid/models/resnet.py analog), trained with Momentum and batch
norm as bench.py ``bench_resnet50`` does.

Names, scopes (``stage{s}``) and parameter shapes are the JAX package's,
so ``params_from_jax`` carries a ResNet across unchanged. ``data_format``
is "NCHW" or "NHWC" (None: the program's layout, see
``framework.layout_mode``); either way the weights are the same.
"""

from __future__ import annotations

from .. import layers as L
from ..framework import current_layout, name_scope
from ..metrics import accuracy

DEPTH_CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv_bn_layer(x, num_filters, filter_size, stride=1, act=None, groups=1,
                  data_format=None):
    x = L.conv2d(x, num_filters, filter_size, stride=stride,
                 padding=(filter_size - 1) // 2, groups=groups, bias_attr=False,
                 data_format=data_format)
    return L.batch_norm(x, act=act, data_layout=data_format)


def bottleneck_block(x, num_filters, stride, data_format=None):
    c_axis = 1 if current_layout(data_format) == "NCHW" else 3
    h = conv_bn_layer(x, num_filters, 1, act="relu", data_format=data_format)
    h = conv_bn_layer(h, num_filters, 3, stride=stride, act="relu",
                      data_format=data_format)
    h = conv_bn_layer(h, num_filters * 4, 1, data_format=data_format)
    if x.shape[c_axis] != num_filters * 4 or stride != 1:
        x = conv_bn_layer(x, num_filters * 4, 1, stride=stride,
                          data_format=data_format)
    return L.relu(h + x)


def backbone(image, depth=50, data_format=None):
    """image: [b, 3, H, W] (NCHW) or [b, H, W, 3] (NHWC) -> pooled
    features [b, 2048]."""
    stages = DEPTH_CFG[depth]
    x = conv_bn_layer(image, 64, 7, stride=2, act="relu", data_format=data_format)
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max",
                 data_format=data_format)
    for s, blocks in enumerate(stages):
        filters = 64 * (2 ** s)
        with name_scope(f"stage{s}"):
            for b in range(blocks):
                x = bottleneck_block(x, filters, stride=2 if s > 0 and b == 0 else 1,
                                     data_format=data_format)
    x = L.pool2d(x, pool_type="avg", global_pooling=True, data_format=data_format)
    return L.flatten(x, axis=1)


def make_model(depth=50, class_num=1000, image_size=224, data_format=None):
    """The program function ``resnet(image, label)`` -> loss, acc, logits.
    It carries ``factory_spec``, by which an inference artifact rebuilds
    it (``io.save_inference_model``)."""
    def resnet(image, label):
        feats = backbone(image, depth, data_format=data_format)
        logits = L.fc(feats, class_num)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}

    resnet.factory_spec = {
        "factory": f"{__name__}:make_model",
        "kwargs": {"depth": depth, "class_num": class_num, "image_size": image_size,
                   "data_format": data_format}}
    return resnet


__all__ = ["DEPTH_CFG", "backbone", "bottleneck_block", "conv_bn_layer", "make_model"]
