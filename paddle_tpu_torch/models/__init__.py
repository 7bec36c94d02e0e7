"""Model zoo of the port: GPT (serving and training), the MNIST MLP and
conv net, ResNet-50/101/152, Transformer-base, BERT-base, DeepFM and the
book recommender."""
