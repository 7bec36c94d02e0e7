"""Model zoo of the port: GPT (serving and training), the MNIST MLP and
conv net, ResNet-50/101/152, VGG-16/19, AlexNet, GoogLeNet v1,
SE-ResNeXt-50/101, Transformer-base, BERT-base, DeepFM, the book
recommender, and the recurrent family: the stacked LSTM, the GRU
seq2seq, SRL, word2vec and fit_a_line."""

from . import (bert, convnets, deepfm, fit_a_line, gpt, lm_head, lstm, mnist, recommender,
               resnet, seq2seq, srl, transformer, vgg, word2vec)

__all__ = ["bert", "convnets", "deepfm", "fit_a_line", "gpt", "lm_head", "lstm", "mnist",
           "recommender", "resnet", "seq2seq", "srl", "transformer", "vgg", "word2vec"]
