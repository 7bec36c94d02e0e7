"""Model zoo of the port: GPT (serving and training), the MNIST MLP and
conv net, ResNet-50/101/152, VGG-16/19, AlexNet, GoogLeNet v1,
SE-ResNeXt-50/101, Transformer-base, BERT-base, DeepFM, the book
recommender, the recurrent family (the stacked LSTM, the GRU seq2seq,
SRL, word2vec and fit_a_line) and the MoE transformer LM."""

from . import (bert, convnets, deepfm, fit_a_line, gpt, lm_head, lstm, mnist,
               moe_transformer, recommender, resnet, seq2seq, srl, transformer, vgg,
               word2vec)

__all__ = ["bert", "convnets", "deepfm", "fit_a_line", "gpt", "lm_head", "lstm", "mnist",
           "moe_transformer", "recommender", "resnet", "seq2seq", "srl", "transformer", "vgg", "word2vec"]
