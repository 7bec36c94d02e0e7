"""Model zoo of the port: GPT (serving and training) and the MNIST MLP."""
