"""Model zoo of the port (GPT decode so far)."""
