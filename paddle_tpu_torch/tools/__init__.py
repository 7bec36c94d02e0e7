"""Diagnostics run as scripts (``python3 -m paddle_tpu_torch.tools.<name>``);
importing one runs nothing."""
