"""Model zoo of the port: GPT (serving and training), the MNIST MLP and
conv net, ResNet-50/101/152, VGG-16/19, AlexNet, GoogLeNet v1,
SE-ResNeXt-50/101, Transformer-base, BERT-base, DeepFM and the book
recommender."""

from . import (bert, convnets, deepfm, gpt, lm_head, mnist, recommender, resnet,
               transformer, vgg)

__all__ = ["bert", "convnets", "deepfm", "gpt", "lm_head", "mnist", "recommender",
           "resnet", "transformer", "vgg"]
