"""Model zoo of the port: GPT (serving and training), the MNIST MLP and
conv net, and ResNet-50/101/152."""
