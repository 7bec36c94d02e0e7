"""Composite nets (counterpart of ``paddle_tpu.nets``; fluid nets.py):
``simple_img_conv_pool``, ``img_conv_group``, ``sequence_conv_pool``,
``glu`` and ``scaled_dot_product_attention``, with their dropout:
``img_conv_group``'s after each batch norm (``downgrade_in_infer``, so
inference scales by ``1 − p``) and the attention probabilities'
(``upscale_in_train``).
"""

from __future__ import annotations

import torch

from . import layers as L
from .layers import attention as A


def simple_img_conv_pool(input, num_filters, filter_size, pool_size, pool_stride,
                         pool_padding=0, pool_type="max", act=None,
                         conv_stride=1, conv_padding=0, conv_dilation=1,
                         conv_groups=1, param_attr=None, bias_attr=None):
    conv = L.conv2d(input, num_filters, filter_size, stride=conv_stride,
                    padding=conv_padding, dilation=conv_dilation,
                    groups=conv_groups, param_attr=param_attr,
                    bias_attr=bias_attr, act=act)
    return L.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                    pool_stride=pool_stride, pool_padding=pool_padding)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act="relu", conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_stride=1, pool_type="max"):
    tmp = input
    for nf in conv_num_filter:
        tmp = L.conv2d(tmp, nf, conv_filter_size, padding=conv_padding,
                       act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = L.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate:
                tmp = L.dropout(tmp, conv_batchnorm_drop_rate)
    return L.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                    pool_stride=pool_stride)


def sequence_conv_pool(input, lengths, num_filters, filter_size, act="tanh",
                       pool_type="max"):
    """Conv over time on a padded batch [b, t, d] and a pool over each
    row's first ``lengths`` steps (sequence_conv_pool analog for the
    padded representation); the conv runs NCHW over [b, d, 1, t]."""
    b, t, d = input.shape
    x = input.permute(0, 2, 1)[:, :, None, :]
    conv = L.conv2d(x, num_filters, (1, filter_size),
                    padding=(0, (filter_size - 1) // 2), act=act, data_format="NCHW")
    conv = conv[:, :, 0, :].permute(0, 2, 1)
    mask = (torch.arange(t, device=input.device)[None, :]
            < lengths.to(input.device)[:, None])
    if pool_type == "max":
        return torch.where(mask[..., None], conv, float("-inf")).amax(dim=1)
    conv = torch.where(mask[..., None], conv, 0.0)
    return conv.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp_min(1).to(conv.dtype)


def glu(input, dim=-1):
    a, b = L.split(input, 2, dim=dim)
    return a * L.sigmoid(b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """nets.scaled_dot_product_attention analog over [b, s, d] inputs."""
    b, sq, d = queries.shape
    hd = d // num_heads

    def split_heads(x):
        return x.reshape(x.shape[0], x.shape[1], num_heads, hd).permute(0, 2, 1, 3)

    out = A.scaled_dot_product_attention(split_heads(queries), split_heads(keys),
                                         split_heads(values), dropout_rate=dropout_rate)
    return out.permute(0, 2, 1, 3).reshape(b, sq, d)


__all__ = ["glu", "img_conv_group", "scaled_dot_product_attention",
           "sequence_conv_pool", "simple_img_conv_pool"]
